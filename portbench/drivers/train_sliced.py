"""The training window in epoch slices: every phase of the port's
``Trainer`` in its order, each for ``ceil(steps_per_epoch / slices)`` steps
from its epoch reset (``Trainer.run_phase(phase, max_steps)``), one closed
loop of such slices, the next starting when the last one's losses are
read back.  For models whose epoch outlasts the window (TGCN's BPR and
TransTag phases; DGCF on the 10x graph): a slice keeps an epoch's ratio of
steps between the phases, and an epoch reset costs under a millisecond
against a slice of seconds.

Set-up is ``drivers/train.py``'s (the graph, ``compose.build_pipeline``,
the leaves drawn from the seed, the Trainer seeded from it), then
``check_steps`` calls, each running every phase for one step: eager
warm-up steps, then each phase's capture and a replay.  Those steps are
what the reference follows, in the Trainer's order: each step's loss, each
phase's first gradient of the leaves it reaches (read from the leaves'
``grad`` after that eager step) and each leaf's change after the last.
Where the model draws neighbour tables (TGCN), the reference takes them as
data and judges them (``table_faults``).  Each phase's batches are recorded
into a device buffer (``drivers/train.py``'s wrapper of ``make_batch``)
and judged, the check steps' and the window's last slice's: BPR as
``drivers/train.py`` judges them; TransTag's (user, tag, item+, item-)
rows each an assignment, a negative none, no assignment twice
(``reference/tgcn.py::transtag_faults``).

The window runs slices until the first slice boundary past ``--seconds``:
BPR pairs (the first phase's) over its wall time, the other phases' steps,
read-backs and epoch resets included.  A traced run turns the program's
recorder on (``utils.profiling``) from set-up on and hands its snapshot to
the readers (``program``); a kernel reader with ``device_ms`` times its
recorded calls itself.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch
from torch.autograd.profiler import record_function

from portbench import common, graphs, harness
from portbench.reference._common import Precision

_train = harness.load("drivers/train.py")


def _say(ctx, stage: str) -> None:
    """A stage reached, on standard error, with the seconds since start."""
    print(f"portbench: {stage} at {time.perf_counter() - ctx.t_start:.1f} s",
          file=sys.stderr, flush=True)


def _phase(trainer, phase, steps):
    """One phase's part of a slice -> its losses [steps, terms]."""
    with record_function("run_phase"):
        return trainer.run_phase(phase, steps)


def _slice(trainer, phases, steps):
    """Every phase in order, ``steps[name]`` steps each."""
    with record_function("run_epoch"):
        return {ph.name: _phase(trainer, ph, steps[ph.name]) for ph in phases}


def slice_steps(phases, slices: int, first: int = 0) -> dict:
    """{phase: steps a slice}: ``ceil(steps_per_epoch / slices)``; with
    ``first``, the first phase's cut to that and the others' in the same
    ratio to it (rounded up)."""
    per = {ph.name: math.ceil(ph.steps_per_epoch / slices) for ph in phases}
    if first:
        lead = per[phases[0].name]
        per = {k: min(v, math.ceil(first * v / lead)) for k, v in per.items()}
    return per


def build(ctx) -> dict:
    """Set-up through the check steps -> the state the window runs on."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig
    from tagrec_tpu_torch.training.train import Trainer
    from tagrec_tpu_torch.utils import profiling

    cfg, mix, dev = ctx.config, ctx.mix, torch.device(ctx.device)
    if ctx.trace:
        profiling.reset()
        profiling.enable()
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
    _say(ctx, "built")
    stages = {"to_graph_s": t_graph - ctx.t_start, "graph_s": t0 - t_graph,
              "build_s": build_s}
    ref = ctx.reference()
    specs = ref.leaves(raw, cfg)
    draw = getattr(ref, "draw_leaves", common.draw_leaves)
    w0 = draw(specs, ctx.seed, dev)
    common.load_leaves(pipe.model, specs, w0)
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device=dev).manual_seed(
                          ctx.seed + 1))
    bufs = {ph.name: _train._record_batches(ph, dev) for ph in pipe.phases}
    params = dict(pipe.model.named_parameters())
    names = [name for name, _ in specs]
    leaves = [params[name] for name in names]
    losses, steps, check_rows, grad1 = [], [], [], {}
    t_check = time.perf_counter()
    stages["leaves_trainer_s"] = t_check - t0 - build_s
    for _ in range(mix["check_steps"]):
        for ph in pipe.phases:
            parts = _phase(trainer, ph, 1)
            losses.append(float(parts[0].sum()))
            rows = bufs[ph.name]["rows"][:1]
            steps.append({ph.name: rows[0].to("cpu", copy=True)})
            check_rows.append((ph.name, rows.clone()))
            if ph.name not in grad1:  # the phase's first step was eager
                grad1[ph.name] = {
                    name: float(torch.linalg.vector_norm(p.grad.double()))
                    for name, p in zip(names, leaves) if p.grad is not None}
    change = [float(torch.linalg.vector_norm((p.detach() - w).double()))
              for p, w in zip(leaves, w0)]
    del w0
    stages["check_steps_s"] = time.perf_counter() - t_check
    _say(ctx, "check steps run")
    tables = getattr(pipe.model, "tables_host", None)
    return {"raw": raw, "pipe": pipe, "trainer": trainer, "bufs": bufs,
            "build_s": build_s, "stages": stages,
            "check": {"losses": losses, "grad1": grad1, "change": change,
                      "batches": {"steps": steps, "tables": tables}},
            "check_rows": check_rows}


def window(state: dict, mix: dict, seconds: float) -> dict:
    """Slices until the first slice boundary past ``seconds``."""
    trainer, phases = state["trainer"], state["pipe"].phases
    per = slice_steps(phases, mix["slices"])
    done = dict.fromkeys(per, 0)
    ends = []
    t0 = time.perf_counter()
    while True:
        out = _slice(trainer, phases, per)
        for name, parts in out.items():
            done[name] += len(parts)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    lead = phases[0].name
    return {"seconds": ends[-1], "steps": done[lead], "phase_steps": done,
            "slice_ends_s": ends,
            "last_steps": {name: len(parts) for name, parts in out.items()},
            "pairs": done[lead] * mix["train_batch"]}


def batch_faults(ctx, raw, name: str, rows: torch.Tensor) -> int:
    """Rows of one phase's batches [steps, B, width] from one epoch reset
    that break its sampler's promise."""
    if name == "bpr":
        return _train.batch_faults(raw, ctx.config, rows)
    if name == "transtag":
        return ctx.reference().transtag_faults(raw, rows)
    raise ValueError(f"no batch check for phase {name!r}")


def read_events(prof, outer: str, top: int = 10) -> dict:
    """``common.read_profile``'s readings (busy and span seconds, the top
    device operations, the idle time by benchmark span / host operation)
    from the profiler's raw events: torch's ``events()`` builds a Python
    object a kernel and takes minutes over a stretch of TGCN's replays,
    whose graphs hold thousands of kernels each."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    marks = [(e.start_ns(), e.end_ns()) for e in evs if e.name() == outer
             and e.device_type() == DeviceType.CPU]
    if not marks:
        return {}
    s0, s1 = min(m[0] for m in marks), max(m[1] for m in marks)
    dev, host, bench = [], [], []
    for e in evs:
        iv = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(iv)
        elif e.name() in common.SPANS:
            bench.append(iv)
        else:
            host.append(iv)
    busy = common._merged((max(a, s0), min(b, s1)) for _, a, b in dev
                          if b > s0 and a < s1)
    by_op = {}
    for name, a, b in dev:
        by_op[name] = by_op.get(name, 0) + (b - a)
    holes, last = [], s0
    for a, b in busy:
        if a > last:
            holes.append((last, a))
        last = max(last, b)
    if s1 > last:
        holes.append((last, s1))

    def inner(ivs, t):
        live = [iv for iv in ivs if iv[1] <= t < iv[2]]
        return min(live, key=lambda iv: iv[2] - iv[1])[0] if live else "-"

    by_host = {}
    for g0, g1 in sorted(holes, key=lambda g: g[0] - g[1])[:200]:
        name = f"{inner(bench, g0)} / {inner(host, g0)}"[:160]
        by_host[name] = by_host.get(name, 0) + (g1 - g0)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "span_s": (s1 - s0) / 1e9,
            "device_ops": [[n[:160], ns / 1e9] for n, ns in rank(by_op)],
            "idle_gaps": [[n, ns / 1e9] for n, ns in rank(by_host)],
            "device_events": len(dev)}


def profiled(fn, outer: str):
    """``fn()`` under torch.profiler (CPU and CUDA) inside the benchmark
    span ``outer`` -> (its result, ``read_events``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(outer):
            out = fn()
        torch.cuda.synchronize()
    return out, read_events(prof, outer)


def trace(ctx, state: dict, win: dict) -> dict:
    """The per-layer readings of a traced run, after the window."""
    from tagrec_tpu_torch.training.train import COUNTED
    from tagrec_tpu_torch.utils import profiling

    mix, trainer = ctx.mix, state["trainer"]
    phases = state["pipe"].phases
    lead = phases[0]
    run = trainer.runs[lead.name]
    out = {"driver": "train", "build_s": state["build_s"],
           "capture_s": sum(r.capture_s for r in trainer.runs.values()),
           "window": win, "step_flops": ctx.counts().step_flops(
               state["raw"], ctx.config, mix["train_batch"])}
    n = min(mix["trace_steps"], lead.steps_per_epoch)
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
    _say(ctx, "replays timed")
    per = slice_steps(phases, mix["slices"], first=n)
    _, out["profile"] = profiled(
        lambda: _slice(trainer, phases, per), "run_epoch")
    _say(ctx, "profiled")
    out["launches"] = {f.__name__: k for f, k in zip(COUNTED, run.launches)}
    out["kernels"] = {}
    readers = ctx.kernel_readers()
    if readers:
        specs = [s for r in readers.values() for s in r.RECORD]
        gen = trainer.generator
        with common.recorded(specs) as calls:
            batch = lead.make_batch(gen, run.counter.new_zeros(1),
                                    run.state, lead.data)
            sum(lead.loss_fn(batch, gen)).backward()
        trainer.opt.zero_grad(set_to_none=True)
        for name, r in readers.items():
            mine = [c for c in calls if c[0] in {s[1] for s in r.RECORD}]
            timer = getattr(r, "device_ms", common.calls_device_ms)
            out["kernels"][name] = {
                "calls": len(mine), "bound_ms": r.bound_ms(mine),
                "device_ms": timer(mine) if mine else None}
        del calls
        _say(ctx, "kernels timed")
    out["program"] = profiling.snapshot()
    profiling.disable()
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """Each number ``compare`` takes the worst of: each step's loss gap;
    {phase/leaf: first-gradient gap} for every leaf the reference's phase
    reaches, a leaf's norm against the reference's over the larger of its
    and the phase's median leaf's; {leaf: change gap} the same way, but for
    the leaves whose first reference gradient (the first phase's) is under
    a thousandth of the median leaf's."""
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    grad1 = {}
    for phase, r in ref["grad1"].items():
        p, med = prog["grad1"].get(phase, {}), statistics.median(r.values())
        grad1.update({f"{phase}/{k}": abs(p.get(k, 0.0) - g) / max(g, med)
                      for k, g in r.items()})
    first = ref["grad1"][ref["lead"]]
    g_med = statistics.median(first.values())
    c_med = statistics.median(ref["change"])
    change = {name: abs(a - b) / max(b, c_med) for name, a, b in
              zip(ref["names"], prog["change"], ref["change"])
              if first.get(name, 0.0) >= 1e-3 * g_med}
    return {"loss": loss, "grad1": grad1, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct``, as ``drivers/train.py``
    compares them, by the worst step or leaf (``gaps``), and
    ``table_faults`` where the reference judged tables."""
    g = gaps(prog, ref)
    out = {"loss_gap": max(g["loss"]), "grad1_gap": max(g["grad1"].values()),
           "change_gap": max(g["change"].values())}
    if "table_faults" in ref:
        out["table_faults"] = ref["table_faults"]
    return out


def reference_run(ctx, raw, batches, mode: str) -> dict:
    """The reference's check steps on the leaves the seed draws, over the
    program's tables where it has them, with the leaves' names and the
    first phase's; a reference that gives the first gradient as a list
    (one phase) gets it keyed by phase and leaf."""
    ref = ctx.reference()
    specs = ref.leaves(raw, ctx.config)
    w0 = getattr(ref, "draw_leaves", common.draw_leaves)(
        specs, ctx.seed, ctx.device)
    kw = {} if batches["tables"] is None else {"tables": batches["tables"]}
    out = ref.train_steps(raw, ctx.config, w0, batches["steps"],
                          Precision(mode), ctx.device, **kw)
    out["names"] = [name for name, _ in specs]
    out["lead"] = next(iter(batches["steps"][0]))
    if isinstance(out["grad1"], list):
        out["grad1"] = {out["lead"]: dict(zip(out["names"], out["grad1"]))}
    return out


def run(ctx) -> dict:
    state = build(ctx)
    stages = state["stages"]
    t_window = time.perf_counter()
    host = {"before": common.host_state(), "cpu_s": time.process_time()}
    win = window(state, ctx.mix, ctx.seconds)
    _say(ctx, "window run")
    card = common.card_state()  # just after the window
    host.update(cpu_s=time.process_time() - host["cpu_s"],
                after=common.host_state())
    on_card = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    raw = state["raw"]
    # the window's last slice and each check step (one step from its epoch
    # reset), before the trace, whose steps write over the buffers' rows
    faults = sum(batch_faults(ctx, raw, name, state["bufs"][name]["rows"][:n])
                 for name, n in win["last_steps"].items())
    faults += sum(batch_faults(ctx, raw, name, rows)
                  for name, rows in state["check_rows"])
    tr = trace(ctx, state, win) if ctx.trace else None
    check = state["check"]
    del state
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    numbers = compare(check, reference_run(ctx, raw, check["batches"], "ref"))
    _say(ctx, "reference run")
    numbers["batch_faults"] = faults
    notes = {"set-up": stages, "window slice ends s": win["slice_ends_s"],
             "phase steps": win["phase_steps"], "card": card, "host": host,
             "reference peak bytes": (torch.cuda.max_memory_allocated()
                                      if on_card else 0)}
    return {"attempted": win["steps"], "failed": 0, "notes": notes,
            "e2e": {"setup_s": t_window - ctx.t_start,
                    "train_pairs_per_s": win["pairs"] / win["seconds"]},
            "trace": tr, "checks": numbers, "memory_peak_bytes": peak}
