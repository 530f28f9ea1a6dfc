"""The training window: BPR steps through the port's ``Trainer``, one
closed loop of whole epochs (``Trainer.run_epoch``), the next starting
when the last one's losses are read back.

Set-up builds the graph, ``compose.build_pipeline``, the leaves drawn from
the seed and the ``Trainer`` (its generator seeded from the seed), then
drives that same Trainer through its first ``check_steps`` steps, each by
the window's own call cut to one step: eager warm-up steps, then the
capture and a replay.  Those steps are what the reference follows: their
loss, the first gradient as Adam holds it (its first moment over 1 - 0.9)
and each leaf's change after the last.  A step's batch is recorded into a
device buffer by a wrapper around the phase's ``make_batch`` (one copy of
[B, 3] ids a step, inside the captured step), so the window's batches are
checked too, the check steps' and the window's last epoch's: every
(user, positive) a train pair, every negative none of the user's train
items, and within an epoch no train pair twice (epoch shuffles) or no
user twice in a batch (resampling).

The window runs whole epochs until the first epoch boundary past
``--seconds``: BPR pairs trained over its wall time, read-backs and epoch
resets included.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench import common, graphs
from portbench.reference._common import Precision


def _call(trainer, max_steps=None):
    """The window's call, one epoch -> {phase: losses [steps, terms]}."""
    with record_function("run_epoch"):
        return trainer.run_epoch(max_steps)


def _record_batches(phase, device):
    """Wrap ``phase.make_batch`` so that step i's [B, 3] BPR rows land in
    row i of the returned buffer."""
    inner = phase.make_batch
    buf = {}

    def make_batch(gen, i, state, data):
        batch = inner(gen, i, state, data)
        rows = batch["bpr"] if isinstance(batch, dict) else batch
        if "rows" not in buf:
            buf["rows"] = torch.zeros((phase.steps_per_epoch,) + rows.shape,
                                      dtype=rows.dtype, device=device)
        buf["rows"].index_copy_(0, i, rows[None])
        return batch

    phase.make_batch = make_batch
    return buf


def build(ctx) -> dict:
    """Set-up through the check steps -> the state the window runs on."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig
    from tagrec_tpu_torch.training.train import Trainer

    cfg, mix, dev = ctx.config, ctx.mix, torch.device(ctx.device)
    t_graph = time.perf_counter()
    raw = graphs.make(**mix["graph"])
    tcfg = TrainConfig(train_batch=mix["train_batch"], lr=cfg["lr"])
    common.sync(dev)
    t0 = time.perf_counter()
    pipe = build_pipeline(graphs.to_hetero(raw), common.model_config(cfg),
                          tcfg, generator=torch.Generator().manual_seed(
                              ctx.seed), device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    stages = {"to_graph_s": t_graph - ctx.t_start, "graph_s": t0 - t_graph,
              "build_s": build_s}
    if len(pipe.phases) != 1:
        raise ValueError("the train driver runs one-phase models")
    ref = ctx.reference()
    specs = ref.leaves(raw, cfg)
    w0 = common.draw_leaves(specs, ctx.seed, dev)
    common.load_leaves(pipe.model, specs, w0)
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device=dev).manual_seed(
                          ctx.seed + 1))
    phase = pipe.phases[0]
    buf = _record_batches(phase, dev)
    params = dict(pipe.model.named_parameters())
    leaves = [params[name] for name, _ in specs]
    losses, batches, check_rows, grad1 = [], [], [], None
    t_check = time.perf_counter()
    stages["leaves_trainer_s"] = t_check - t0 - build_s
    for _ in range(mix["check_steps"]):
        out = _call(trainer, max_steps=1)
        losses.append(float(out[phase.name][0].sum()))
        batches.append({"bpr": buf["rows"][0].to("cpu", copy=True)})
        check_rows.append(buf["rows"][:1].clone())
        if grad1 is None:
            grad1 = [float(torch.linalg.vector_norm(
                trainer.opt.state[p]["exp_avg"].double() / (1 - 0.9)))
                if p in trainer.opt.state else 0.0 for p in leaves]
    change = [float(torch.linalg.vector_norm((p.detach() - w).double()))
              for p, w in zip(leaves, w0)]
    del w0
    stages["check_steps_s"] = time.perf_counter() - t_check
    return {"raw": raw, "pipe": pipe, "trainer": trainer, "phase": phase,
            "buf": buf, "build_s": build_s, "specs": specs, "stages": stages,
            "check": {"losses": losses, "grad1": grad1, "change": change,
                      "batches": batches}, "check_rows": check_rows}


def window(state: dict, mix: dict, seconds: float) -> dict:
    """Whole epochs until the first epoch boundary past ``seconds``."""
    trainer = state["trainer"]
    steps = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        out = _call(trainer)
        last = sum(len(v) for v in out.values())
        steps += last
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    return {"seconds": ends[-1], "steps": steps, "epoch_ends_s": ends,
            "last_steps": last, "pairs": steps * mix["train_batch"]}


def _member(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    i = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    return keys[i] == q


def batch_faults(raw, cfg: dict, rows: torch.Tensor) -> int:
    """Rows of one epoch's batches [steps, B, 3] that break the sampler's
    promise."""
    dev = rows.device
    n_item = raw.n_item
    keys = torch.as_tensor(raw.train[:, 0] * n_item + raw.train[:, 1],
                           device=dev)
    u, p, n = rows[..., 0], rows[..., 1], rows[..., 2]
    bad = ((u < 0) | (u >= raw.n_user) | (p < 0) | (p >= n_item)
           | (n < 0) | (n >= n_item))
    u, p, n = u.clamp(0, raw.n_user - 1), p.clamp(0, n_item - 1), \
        n.clamp(0, n_item - 1)
    bad |= ~_member(keys, u * n_item + p) | _member(keys, u * n_item + n)
    faults = int(bad.sum())
    if cfg["sampler"] == "epoch_shuffle":
        pairs = (u * n_item + p).reshape(-1)
        faults += int(pairs.numel() - torch.unique(pairs).numel())
    elif cfg["sampler"] == "resample":
        # without replacement only past a batch of users, as the Trainer
        if len(np.unique(raw.train[:, 0])) > rows.shape[1]:
            su = torch.sort(u, dim=1).values
            faults += int((su[:, 1:] == su[:, :-1]).sum())
    else:
        raise ValueError(f"sampler {cfg['sampler']!r}: epoch_shuffle or "
                         "resample")
    return faults


def trace(ctx, state: dict, win: dict) -> dict:
    """The per-layer readings of a traced run, after the window."""
    from tagrec_tpu_torch.training.train import COUNTED

    mix, trainer, phase = ctx.mix, state["trainer"], state["phase"]
    run = trainer.runs[phase.name]
    out = {"driver": "train", "build_s": state["build_s"],
           "capture_s": sum(r.capture_s for r in trainer.runs.values()),
           "window": win, "step_flops": ctx.counts().step_flops(
               state["raw"], ctx.config, mix["train_batch"])}
    n = min(mix["trace_steps"], phase.steps_per_epoch)
    run.counter.zero_()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run.graph.replay()
    b.record()
    torch.cuda.synchronize()
    out["replay_ms"] = a.elapsed_time(b) / n
    _, out["profile"] = common.profiled(
        lambda: _call(trainer, max_steps=n), "run_epoch")
    out["launches"] = {f.__name__: k for f, k in zip(COUNTED, run.launches)}
    out["kernels"] = {}
    readers = ctx.kernel_readers()
    if readers:
        specs = [s for r in readers.values() for s in r.RECORD]
        gen = trainer.generator
        with common.recorded(specs) as calls:
            batch = phase.make_batch(gen, run.counter.new_zeros(1),
                                     run.state, phase.data)
            sum(phase.loss_fn(batch, gen)).backward()
        trainer.opt.zero_grad(set_to_none=True)
        for name, r in readers.items():
            mine = [c for c in calls if c[0] in {s[1] for s in r.RECORD}]
            out["kernels"][name] = {
                "calls": len(mine), "bound_ms": r.bound_ms(mine),
                "device_ms": common.calls_device_ms(mine) if mine else None}
        del calls
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``: each step's loss, each leaf's
    first-gradient norm and each leaf's change norm, the program's
    against the reference's, by the worst step or leaf; a leaf's gap over
    its own norm or the median leaf's, whichever is larger; leaves whose
    reference gradient is under a thousandth of the median leaf's left out
    of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))

    def worst(p, r, keep):
        med = statistics.median(r)
        return max(abs(p[i] - r[i]) / max(r[i], med) for i in keep)

    g_med = statistics.median(ref["grad1"])
    moved = [i for i, g in enumerate(ref["grad1"]) if g >= 1e-3 * g_med]
    return {"loss_gap": loss_gap,
            "grad1_gap": worst(prog["grad1"], ref["grad1"],
                               range(len(ref["grad1"]))),
            "change_gap": worst(prog["change"], ref["change"], moved)}


def reference_run(ctx, raw, batches, mode: str) -> dict:
    """The reference's check steps on the leaves the seed draws."""
    ref = ctx.reference()
    specs = ref.leaves(raw, ctx.config)
    w0 = common.draw_leaves(specs, ctx.seed, ctx.device)
    return ref.train_steps(raw, ctx.config, w0, batches, Precision(mode),
                           ctx.device)


def run(ctx) -> dict:
    state = build(ctx)
    stages = state["stages"]
    t_window = time.perf_counter()
    host = {"before": common.host_state(), "cpu_s": time.process_time()}
    win = window(state, ctx.mix, ctx.seconds)
    card = common.card_state()  # just after the window
    host.update(cpu_s=time.process_time() - host["cpu_s"],
                after=common.host_state())
    on_card = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the window's last epoch and each check step (an epoch of one step),
    # before the trace, whose steps write over the batch buffer's rows
    faults = sum(batch_faults(state["raw"], ctx.config, rows) for rows in
                 [state["buf"]["rows"][:win["last_steps"]]]
                 + state["check_rows"])
    tr = trace(ctx, state, win) if ctx.trace else None
    raw, check = state["raw"], state["check"]
    del state
    if on_card:
        torch.cuda.empty_cache()
    numbers = compare(check, reference_run(ctx, raw, check["batches"], "ref"))
    numbers["batch_faults"] = faults
    notes = {"set-up": stages, "window epoch ends s": win["epoch_ends_s"],
             "card": card, "host": host}
    return {"attempted": win["steps"], "failed": 0, "notes": notes,
            "e2e": {"setup_s": t_window - ctx.t_start,
                    "train_pairs_per_s": win["pairs"] / win["seconds"]},
            "trace": tr, "checks": numbers, "memory_peak_bytes": peak}
