"""Multi-phase training loop (tagrec_tpu/training/train.py).

An epoch runs the model's phases in order (BPR for LightGCN; BPR, then
TransE for KGAT; DGCF and DisenGCN's resampling BPR), all stepping ONE
shared Adam.  Batches have fixed shapes: steps = E // batch and the
remainder is dropped (the resampling phase takes its step count from the
caller).  Sampling (shuffles, negatives) runs on the tables' device from
one ``torch.Generator``.

A step is graph-safe: its batch comes from a step counter that lives on
the device (index arithmetic, not a slice by a Python int), its loss
terms go into row ``counter`` of a static [steps, n_terms] buffer, and
nothing in it reads a value back to the host.  On the card the Trainer
runs each phase as JAX runs an epoch under one jit'd ``lax.scan``: a few
eager warm-up steps, then ONE ``torch.cuda.CUDAGraph`` of the step
(batch, loss, backward, Adam, loss row, counter), captured once per
phase and replayed for every later step of every epoch.  On the CPU the
same step body runs eagerly.  The losses come back to the host once per
phase.  ``Trainer.run`` adds the periodic evaluation, the early stop,
the metrics stream and the train-state file that a run resumes from.

Under a (data, model) mesh (``parallel``) a step computes what it
computes on one device.  Every rank draws the whole global batch from
the same generator, so every random stream (shuffles, negatives, the
correlation ids, dropout) is the single-device run's, and steps on its
``data`` slice; the loss terms, means over batch rows, are averaged over
``data``, and so are the gradients, which counts a term computed whole
on every rank (DGCF's distance correlation) once.  Embedding tables are
row-sharded over ``model`` and all-gathered once a step.  LightGCN's and
NGCF's graph tables are row-sharded too, and each SpMM computes the
rank's rows and all-gathers them; so is every model's EdgeMap, whose
primitives do the same, and TGCN's neighbour tables and dedup buckets,
whose attention does the same; the other tiers' propagation runs whole
on every rank.  On the card the collectives are
inside the captured step, which needs an NCCL group.  Every rank takes
the same decisions (the loss check, the early stop, the resume epoch)
from the same averaged losses and metrics.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tagrec_tpu_torch.config import TrainConfig
from tagrec_tpu_torch.ops import dma_gather, flash_attention, flash_routing
from tagrec_tpu_torch.ops import sampling
from tagrec_tpu_torch.parallel import sharding
from tagrec_tpu_torch.training import checkpoint, optim
from tagrec_tpu_torch.utils import profiling

# every kernel wrapper's launch counter; a replay runs no Python, so the
# Trainer adds each graph's launches to them itself, once an epoch
COUNTED = (flash_routing.routed_rowsum, flash_routing.routed_mm,
           flash_routing.routed_mm_bwd, flash_attention.dot_flash_stats,
           flash_attention.dot_flash_apply, flash_attention.dot_bwd_row,
           flash_attention.dot_bwd_col, dma_gather.gather_reduce,
           dma_gather.gather_rows)
# eager steps a phase runs on the card before its capture: they initialise
# cuBLAS, autograd and Adam's state, and are the epoch's first real steps
WARMUP_STEPS = 2


@dataclass
class PhaseSpec:
    """One training phase.

    epoch_reset(gen, data)           -> epoch state (None, a tensor or a
                                        tuple of tensors, e.g. shuffled edges)
    make_batch(gen, i, state, data)  -> the batch of step i; ``i`` is an int
                                        or the [1] int64 step counter on the
                                        device, read by index arithmetic only
    loss_fn(batch, gen)              -> tuple of scalar loss terms, summed for
                                        the gradient and logged apart
    """

    name: str
    steps_per_epoch: int
    epoch_reset: Callable
    make_batch: Callable
    loss_fn: Callable
    data: object = None


def bpr_phase(name: str, edges: np.ndarray, pos_table: sampling.PosTable,
              batch: int, loss_fn, neg_rounds: int = 16) -> PhaseSpec:
    """BPR over all train interactions: each epoch shuffles every (u, i+)
    pair and pairs each with one uniform negative outside the user's
    positives."""
    batch = min(batch, len(edges))  # tiny datasets: one full batch
    steps = max(len(edges) // batch, 1)
    device = pos_table.table.device
    data = {"edges": torch.as_tensor(np.asarray(edges, dtype=np.int64),
                                     device=device),
            "pt": pos_table, "offsets": torch.arange(batch, device=device)}

    def epoch_reset(gen, data):
        e = data["edges"]
        return e[torch.randperm(e.shape[0], generator=gen, device=e.device)]

    def make_batch(gen, i, shuffled, data):
        sl = shuffled.index_select(0, i * batch + data["offsets"])
        users, pos = sl[:, 0], sl[:, 1]
        neg = sampling.sample_negatives(gen, data["pt"], users,
                                        rounds=neg_rounds)
        return torch.stack([users, pos, neg], dim=1)

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


def resampling_phase(name: str, user_ids: np.ndarray,
                     pos_table: sampling.PosTable, batch: int, steps: int,
                     loss_fn, cor_sizes: Optional[Dict[str, tuple]] = None,
                     neg_rounds: int = 16) -> PhaseSpec:
    """The DGCF family's phase: every step draws ``batch`` users of
    ``user_ids``, one positive and one negative each -> {"bpr": [B, 3]},
    and, per entry ``name: (n, hi)`` of ``cor_sizes``, n ids below hi for
    the distance-correlation term -> {"cor": {name: [n]}}.

    Users are drawn without replacement within a batch only when
    ``len(user_ids) > batch``, a strict inequality (at equality the
    reference draws with replacement, a quirk kept on purpose), with
    replacement otherwise."""
    cor_sizes = cor_sizes or {}
    n_users = len(user_ids)
    without_replacement = n_users > batch
    device = pos_table.table.device
    data = {"users": torch.as_tensor(np.asarray(user_ids, dtype=np.int64),
                                     device=device),
            "pt": pos_table}

    def epoch_reset(gen, data):
        return None  # stateless

    def make_batch(gen, i, _, data):
        if without_replacement:
            sel = torch.randperm(n_users, generator=gen,
                                 device=device)[:batch]
        else:
            sel = torch.randint(0, n_users, (batch,), generator=gen,
                                device=device)
        users = data["users"][sel]
        pos = sampling.sample_positive(gen, data["pt"], users)
        neg = sampling.sample_negatives(gen, data["pt"], users,
                                        rounds=neg_rounds)
        out = {"bpr": torch.stack([users, pos, neg], dim=1)}
        if cor_sizes:
            out["cor"] = {key: torch.randint(0, hi, (nb,), generator=gen,
                                             device=device)
                          for key, (nb, hi) in cor_sizes.items()}
        return out

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


def triple_phase(name: str, triples: np.ndarray, n_rel: int, n_ids: int,
                 batch: int, loss_fn, neg_rounds: int = 16,
                 window: bool = False, device="cuda") -> PhaseSpec:
    """TransE phase over (h, r, t) triples; each batch draws a corrupted tail
    outside the observed (h, r, *) set.

    ``window=False``: each epoch shuffles all triples and takes disjoint
    batches.  ``window=True`` reproduces the reference KGAT sampler (quirk
    #5): the triples are never shuffled, and step i trains on
    ``triples[i : i + batch]``, i stepping by one, for ``len // batch``
    steps."""
    ts, keys = sampling.build_triple_set(triples, n_rel, n_ids, device=device)
    batch = min(batch, len(triples))  # tiny datasets: one full batch
    steps = max(len(triples) // batch, 1)
    data = {"trips": torch.as_tensor(np.asarray(triples, dtype=np.int64),
                                     device=device),
            "keys": keys, "ts": ts,
            "offsets": torch.arange(batch, device=device)}

    def epoch_reset(gen, data):
        if window:  # quirk #5: no shuffle, ever
            return data["trips"], data["keys"]
        perm = torch.randperm(data["trips"].shape[0], generator=gen,
                              device=data["trips"].device)
        return data["trips"][perm], data["keys"][perm]

    def make_batch(gen, i, state, data):
        trips, tkeys = state
        rows = (i if window else i * batch) + data["offsets"]
        neg = sampling.sample_negatives_from_set(
            gen, data["ts"], tkeys.index_select(0, rows), rounds=neg_rounds)
        return torch.cat([trips.index_select(0, rows), neg[:, None]], dim=1)

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


@dataclass
class PhaseRun:
    """One phase's static buffers, at the fixed addresses its CUDA graph
    reads and writes, and the graph once captured.

    counter:  [1] int64, the step index on the device
    state:    the epoch state's static copy (``epoch_reset`` copied in)
    losses:   [steps_per_epoch, n_terms], row i the loss terms of step i
    warm:     eager steps run so far
    graph:    the captured step, or None
    launches: each ``COUNTED`` wrapper's launches in one replay
    capture_s: the capture's host seconds (the ``trainer.capture`` span)
    """

    counter: torch.Tensor
    state: object = None
    losses: Optional[torch.Tensor] = None
    warm: int = 0
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Tuple[int, ...] = ()
    capture_s: float = 0.0


def _into(static, new):
    """``new`` (None, a tensor or a tuple of tensors) copied into
    ``static`` of the same structure, which is made on the first call;
    the addresses never change after that."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        if static is None:
            return new.clone()
        return static.copy_(new)
    if static is None:
        static = (None,) * len(new)
    return tuple(_into(a, b) for a, b in zip(static, new))


def _where(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback or its
    context: the operation the capture stopped at."""
    frames = []
    while exc is not None:
        frames += [f for f in traceback.extract_tb(exc.__traceback__)
                   if f"{os.sep}tagrec_tpu_torch{os.sep}" in f.filename]
        exc = exc.__cause__ or exc.__context__
    if not frames:
        return "(no frame of tagrec_tpu_torch)"
    f = frames[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} {f.name}: {f.line}"


class Trainer:
    """Steps ``phases`` in order over one Adam on ``model``'s parameters,
    drawing every sample from ``generator``.

    On the card each phase's step is captured in a CUDA graph after
    ``WARMUP_STEPS`` eager steps and replayed from then on (``capture``);
    ``capture=False`` runs every step eagerly, the same body, for a hold
    of the captured run against the eager one.  A capture that fails
    raises, naming the phase and the operation; no phase falls back to
    eager.  The generator is registered with every graph.

    ``mesh``: an optional ``parallel.Mesh`` with its process groups; the
    Trainer row-shards the model's tables, and its graph tables (JAX's
    ``gdev_sharding`` rule, ``parallel.sharding.shard_graph``), over it
    (``placement``:
    ``params`` and ``graph``) and every rank of it runs the same calls.  A capture on the card needs
    the mesh's group to be NCCL: a gloo group raises here, and a caller
    that means to run eagerly passes ``capture=False``."""

    def __init__(self, model: torch.nn.Module, phases: List[PhaseSpec],
                 cfg: TrainConfig, *, generator: torch.Generator, mesh=None,
                 capture: bool = True):
        self.model = model
        self.phases = phases
        self.cfg = cfg
        self.generator = generator
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.capture = capture and self.device.type == "cuda"
        self.placement = None
        if mesh is not None:
            if mesh.groups is None:
                raise ValueError(f"{mesh} has no process groups: make it "
                                 "after torch.distributed is initialised")
            if self.capture and mesh.backend != "nccl":
                raise ValueError(
                    f"a CUDA graph cannot capture the collectives of a "
                    f"{mesh.backend!r} process group (only NCCL's run on a "
                    "CUDA stream); pass capture=False to step eagerly")
        with profiling.span("trainer.init"):
            if mesh is not None:
                self.placement = {
                    "params": sharding.shard_params(model, mesh),
                    "graph": sharding.shard_graph(model, mesh)}
            # the replicated parameters, whose gradients are averaged over
            # ``model`` where it has more than one rank (``step``)
            self.replicated = [] if mesh is None or mesh.shape["model"] == 1 \
                else [p for n, p in model.named_parameters()
                      if not self.placement["params"][sharding.jax_name(n)]]
            self.opt = optim.make_optimizer(model.parameters(), cfg)
        self.runs: Dict[str, PhaseRun] = {}
        self._side = None

    def step(self, phase: PhaseSpec, batch) -> torch.Tensor:
        """One optimizer step on ``batch`` -> the loss terms [n_terms].
        Clearing the grads to None makes a captured backward allocate its
        own: a second phase's graph never adds into the first one's.  Under
        a mesh ``batch`` is this rank's slice, and the gradients and loss
        terms are averaged over ``data`` before Adam's step; the replicated
        parameters' gradients also over ``model``: each ``model`` rank
        computes them whole, but a backward over the rank's rows may sum
        them in another order, and the rank's own copy must take the same
        step as the others' (with equal gradients the mean is the
        gradient, bit for bit)."""
        self.opt.zero_grad(set_to_none=True)
        with sharding.gathered():
            parts = phase.loss_fn(batch, self.generator)
        sum(parts).backward()
        parts = torch.stack([p.detach() for p in parts])
        if self.mesh is not None:
            sharding.data_mean_([p.grad for g in self.opt.param_groups
                                 for p in g["params"]
                                 if p.grad is not None], self.mesh)
            sharding.data_mean_([parts], self.mesh)
            rep = [p.grad for p in self.replicated if p.grad is not None]
            if rep:
                sharding.data_mean_(rep, self.mesh, "model")
        if self.cfg.adam_impl == "global":
            optim.fill_missing_grads(self.opt)
        self.opt.step()
        return parts

    def _body(self, phase: PhaseSpec, run: PhaseRun) -> None:
        """The graph-safe step: the batch at the device counter, one
        optimizer step, its loss terms into the counter's row, the counter
        advanced."""
        batch = phase.make_batch(self.generator, run.counter, run.state,
                                 phase.data)
        if self.mesh is not None:
            batch = sharding.constrain_batch(batch, self.mesh)
        parts = self.step(phase, batch)
        if run.losses is None:  # the first (eager) step sizes it
            run.losses = parts.new_zeros((phase.steps_per_epoch,
                                          parts.shape[0]))
        run.losses.index_copy_(0, run.counter, parts[None])
        run.counter.add_(1)

    def _eager(self, phase: PhaseSpec, run: PhaseRun) -> None:
        """One eager step; before a capture, on a side stream, as CUDA
        graphs want their warm-up."""
        run.warm += 1
        profiling.count("trainer.eager_steps")
        with profiling.span("trainer.eager"):
            if not self.capture:
                return self._body(phase, run)
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                self._body(phase, run)
            main.wait_stream(self._side)

    def _capture(self, phase: PhaseSpec, run: PhaseRun) -> None:
        """Capture ``phase``'s step into ``run.graph``; nothing runs.  The
        launch counters move only at replay."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = [f.launches for f in COUNTED]
        profiling.count("trainer.captures")
        try:
            with profiling.timed("trainer.capture", phase=phase.name) as sp, \
                    torch.cuda.graph(graph):
                self._body(phase, run)
        except Exception as e:  # any op that cannot be captured
            raise RuntimeError(
                f"CUDA graph capture of phase {phase.name!r} failed at "
                f"{_where(e)}: {type(e).__name__}: {e}") from e
        finally:
            after = [f.launches for f in COUNTED]
            for f, n in zip(COUNTED, before):
                f.launches = n
        run.capture_s = sp.seconds
        run.launches = tuple(a - b for a, b in zip(after, before))
        run.graph = graph

    def run_phase(self, phase: PhaseSpec, max_steps: Optional[int] = None,
                  on_step: Optional[Callable] = None) -> np.ndarray:
        """One epoch of ``phase``, cut to ``max_steps`` steps when given ->
        the loss terms [steps, n_terms]; raises on a non-finite loss.
        ``on_step(i, parts)``, when given, runs after each step.  A replay
        runs no Python: the launch counters take an epoch's replays once
        its steps are queued."""
        steps = phase.steps_per_epoch
        if max_steps is not None:
            steps = min(steps, max_steps)
        profiling.count("trainer.epochs")
        with profiling.span("trainer.epoch", phase=phase.name,
                            steps=steps):
            run = self.runs.get(phase.name)
            if run is None:
                run = self.runs[phase.name] = PhaseRun(counter=torch.zeros(
                    1, dtype=torch.int64, device=self.device))
            with profiling.span("trainer.epoch_reset"):
                run.state = _into(run.state, phase.epoch_reset(
                    self.generator, phase.data))
                run.counter.zero_()
            i = 0
            while i < steps and run.graph is None:
                if self.capture and run.warm >= WARMUP_STEPS:
                    self._capture(phase, run)
                    break
                self._eager(phase, run)
                if on_step is not None:
                    on_step(i, run.losses[i])
                i += 1
            replays = steps - i
            if replays:
                with profiling.span("trainer.replays", n=replays):
                    for i in range(i, steps):
                        run.graph.replay()
                        if on_step is not None:
                            on_step(i, run.losses[i])
                for f, n in zip(COUNTED, run.launches):
                    f.launches += n * replays
                profiling.count("trainer.replays", replays)
            with profiling.span("trainer.readback"):
                parts = run.losses[:steps].cpu().numpy()
                finite = np.isfinite(parts).all()
        if not finite:
            raise FloatingPointError(f"non-finite loss in phase {phase.name}")
        return parts

    def run_epoch(self, max_steps: Optional[int] = None):
        """Every phase in order -> {phase name: loss terms [steps, n]}."""
        return {ph.name: self.run_phase(ph, max_steps) for ph in self.phases}

    def run(self, evaluator, early_stop, *, log=print, metrics=None,
            state_path: Optional[str] = None) -> Dict:
        """``cfg.epochs`` epochs of every phase, an evaluation after every
        ``cfg.test_interval``-th epoch (epoch 0 first) fed to ``early_stop``,
        which may end the run.  -> {"best_epoch", "best_result"}; the model
        keeps the last epoch's parameters, ``early_stop.best_params`` the
        best ones.

        ``metrics``: an optional ``utils.MetricsWriter``, given each phase's
        mean loss and time and each evaluation's results.  ``state_path``: a
        train-state file, written at every evaluation (the epoch to resume
        at, the parameters and Adam's state) and restored first when it
        exists.  Under a mesh ``state_path`` is a directory of step
        directories, each rank writing its own shards (``save_sharded``,
        the newest 3 kept) and restoring from the newest.  A non-finite loss
        raises FloatingPointError naming the epoch, the phase and the last
        saved state."""
        cfg = self.cfg
        start_ep = 0
        if self.mesh is not None:
            last = (checkpoint.latest_step_dir(state_path) if state_path
                    else None)
            if last:
                start_ep = checkpoint.load_sharded(last, self.model, self.opt,
                                                   cfg.adam_impl)
                log(f"resumed sharded state from {last} at epoch {start_ep}")
        elif state_path and os.path.exists(state_path):
            start_ep = checkpoint.restore_train_state(
                state_path, self.model, self.opt, cfg.adam_impl)
            log(f"resumed from {state_path} at epoch {start_ep}")
        for ep in range(start_ep, cfg.epochs):
            for pi, phase in enumerate(self.phases):
                t0 = time.time()
                try:
                    parts = self.run_phase(phase)
                except FloatingPointError:
                    # the epoch has already corrupted the parameters: stop;
                    # the last eval-time state is the recovery point
                    msg = (f"non-finite loss in epoch {ep} phase "
                           f"{phase.name}; last saved state: "
                           f"{state_path or '(none)'}")
                    log(f"FATAL: {msg}")
                    raise FloatingPointError(msg) from None
                dt = time.time() - t0
                log(f"[Epoch:{ep}][{phase.name}][{dt:.2f}s] "
                    f"avg_loss: {parts.sum(axis=1).mean():.5f} "
                    f"parts_sum: {[float(v) for v in parts.sum(axis=0)]}")
                if metrics is not None:
                    metrics.scalars(ep, {
                        f"train/loss_{pi}": float(parts.sum(axis=1).mean()),
                        f"train/epoch_time_{pi}": dt})
            if ep % cfg.test_interval == 0:
                t0 = time.time()
                results = evaluator.run(self.model)
                log(f"[Epoch {ep}][eval {time.time() - t0:.2f}s] {results}")
                if metrics is not None:
                    metrics.results(ep, results, cfg.topks)
                if state_path and self.mesh is not None:
                    checkpoint.save_sharded(state_path, self.model, self.opt,
                                            ep + 1, adam_impl=cfg.adam_impl,
                                            rotate=3)
                elif state_path:
                    checkpoint.save_train_state(state_path, self.model,
                                                self.opt, ep + 1,
                                                cfg.adam_impl)
                if early_stop(self.model, results, ep):
                    log(f"early stop trigger at epoch {ep}")
                    break
        log(f"best result [{early_stop.best_epoch}:{early_stop.best_result}]")
        return {"best_epoch": early_stop.best_epoch,
                "best_result": early_stop.best_result}
