#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tagrec_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases:
1. environment: the card's name and power limit; the eight CUDA kernels
   are built from ``tagrec_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel);
2. DGCF and DisenGCN: each routing kernel, and ``routed_mm``'s backward
   (the ``routed_mm`` kernel over the mask's transpose), against its plain
   PyTorch version on the card (the backward against the plain version's
   autograd, all in float64), at the path's own shapes (the hetrec-scale
   joint graph, F=4, N=M=15000, dx=16, base=1.0) at every rank of a DGCF
   forward (r=8 all-zero, then 16, 32, 48, 64, 80), with its time, its
   least possible time (bound) and the plain version's time, summed over
   the forward (the backward over a BPR step's three launches) and at
   r=80; at DisenGCN's r=16, base 0; on a non-symmetric mask with its own
   transpose; then DGCF at the preset's full width -> ``export_tables`` ->
   ``save_export`` -> ``Retriever.from_export`` -> 3 top-k requests of 256
   users, the launches counted around the export, one forward profiled;
   the forward against the CPU path on a small graph; DGCF training
   (``build_pipeline`` -> 5 BPR steps through the Trainer, the launches
   checked per step, one step profiled; gradients against the CPU path on
   a small graph); DisenGCN the same, then export -> artifact -> 3 top-k
   requests and one evaluation of every test user;
3. KGAT ``bi_inter``: each flash-attention kernel against its plain version
   at the path's shapes (three row types, dq 64, dx 64 and 32; stats also
   at a split off every 64-column tile), with its time, bound, plain time
   and, for apply, one ``scaled_dot_product_attention`` call as a yardstick
   (``dot_bwd_row`` and ``dot_bwd_col``, which sweeps the model's transposed
   masks, against their plain versions evaluated in float64); serving
   (forward -> export -> artifact -> 3 top-k requests, one forward
   profiled), then training (5 BPR steps and 3 TransE steps through the
   Trainer's one Adam), the launches counted per forward and per step, one
   BPR step profiled; forward and BPR gradients
   against the CPU path on a small graph;
   then the kernel tiers of DGCF, DisenGCN and KGAT ``bi_inter`` at the
   preset's full width on the hetrec graph, held against the chunked dense
   tier (``adj_mode="dense_xla"``) evaluated in float64 on the card from
   the same weights: the forward tables (rtol 1e-4, atol 1e-5) and one BPR
   loss's gradients, each on its own scale (entries within 5e-4 |g| +
   1e-4 max|g|, norm within 5e-4 |g|), each tier's forward time and peak
   memory; NGCF at full width on the dense sector tier, float32 and bf16
   from the same weights (the bf16 block products against float32
   products of the rounded operands; the forwards' difference under
   5e-3; 5 BPR steps each, one
   profiled), export -> artifact -> 3 top-k requests and one evaluation;
   DisenHAN at full width in dense mode (5 BPR steps, one profiled, the
   peak memory, export -> artifact -> 3 top-k requests, one evaluation,
   forward and gradients against the CPU path on a small graph);
4. LightGCN on the 10x graph (150,000 joint nodes, so the hybrid tier:
   hub block + degree-bucketed ELL): the tier and bucket shapes; each
   gather kernel against its plain version at every bucket's shape (with
   the bucket's degrees, as the path runs it) and at the two row gathers of
   an SpMM, with its time, bound, plain time and one PyTorch call
   (``embedding_bag``, ``index_select``) as a yardstick, the kernel and the
   call timed both by CUDA events and by their device time (``device_ms``:
   10 calls captured in a CUDA graph, its replays timed by events);
   serving (export -> artifact -> 3 top-k requests), 5 BPR steps through
   the Trainer with the launches checked per step, one BPR step profiled,
   the peak device memory, one evaluation over every test user and one
   4-group breakdown, one BPR step with ``node_drop`` (edge dropout: the
   forward on the kernels, the backward a scatter-add); forward and BPR
   gradients against the CPU path on a small graph with hub columns; NGCF
   on the same graph (D^-1 A is not symmetric: the transpose tables are
   their own): both tables' tiers and buckets, each gather kernel against
   its plain version at every bucket of both tables at D = 64 and 32, with
   its time and bound, 5 BPR steps with the launches checked per step, the
   peak memory, one step profiled, edge dropout on the pair (the dropped
   share, and the adjoint identity through the dropped adjacency), one
   evaluation, the small-graph check; then LightGCN at hetrec scale on the
   dense sector tier (no kernel), a few BPR steps;
5. KGAT ``bi_inter`` over ``KnowledgeGraph.synthetic`` on the hetrec
   graph (15,000 entities, 500,000 triples under 6 relations: 17,000
   nodes, 14 relations; the relation-dense tier, no kernel of the port):
   float32 held against an independent per-edge computation in float64 at
   full size (forward, BPR gradients and the forward's VJP, as the
   ``dense_xla`` holds), then per dtype (float32, bf16 score planes) 3 BPR
   and 3 TransE steps on one Adam, one BPR step profiled, the peak memory;
   float32's export -> artifact -> 3 top-k requests and one evaluation;
   bf16's forward against float32's within 5e-3; the small-graph check.
   TGCN at the preset's full width on the hetrec graph (no kernel of the
   port): the ``auto`` tier (dedup buckets) in float32 held against
   ``dense_xla`` (plain takes) in float64, and the two in float64 against
   each other; 3 BPR and 3 TransTag steps, one BPR step profiled (its
   device operations counted), the peak memory, export -> artifact -> 3
   top-k requests, one evaluation; ``gather_rows`` against
   ``index_select`` on the layer-0 dedup ids at D = 64 and 32 (not on the
   model's path); the small-graph check; then ``python -m
   tagrec_tpu_torch.cli --model tgcn --dataset synthetic`` for one epoch
   in its own process;
6. the training CLI (``tagrec_tpu_torch.cli.main``) in process, as a user
   runs it: DGCF at the preset's full width on ``--dataset
   synthetic_large`` for one epoch with ``--resume`` and ``--export``
   (run A; the artifact then queried through ``serving.main``), resumed
   from its train state to ``--epochs 2`` (run B: epoch 1 only), and DGCF
   on the small graph with ``--profile`` (run C: a trace file holding every
   routing launch of the training), then NGCF on ``synthetic_large`` for
   one epoch with ``--export`` (run D); each DGCF run's routing launches
   checked against its steps and forwards, each run's ``results.json``
   checked, and its host-clock seconds a stage printed beside the card;
7. phase E, the EdgeMap tier (``ops.edgemap``; ``adj_mode="ell"``, and
   ``auto`` past the dense budget): inside phase 3 the ``ell`` tiers of
   DGCF, DisenGCN and KGAT ``bi_inter`` in float32 held against
   ``dense_xla`` in float64 beside the kernel tiers, and DisenHAN's
   against its dense tier in float64; after phase 4 the primitives at
   DGCF's hetrec shapes (the joint graph's EdgeMap, F = 4, dk = 16):
   ``edge_reduce`` (the ``gather_reduce`` kernel, one launch a factor
   and non-empty bucket) against ``gather_reduce_plain`` in float64, the
   gathers against the CPU, each Function's backward against autograd of
   its raw form in float64, ``edge_reduce`` timed beside its plain
   version and ``torch.sparse.mm`` with its bound; DGCF on the 10x graph
   (``auto`` takes the EdgeMap tier): the host build, 5 BPR steps with
   the launches checked per step, the peak memory, one step profiled,
   one evaluation of every test user, export and 3 top-k requests, then
   ``edge_reduce`` at its buckets (the hub's split over many blocks a
   row) against ``gather_reduce_plain`` in float64, its backward and one
   row-chunked ``edge_dot`` against float64 references, and timed;
   in phase 5 KGAT over the phase-K KG with 3,000 parallel triples
   (which the relation-dense tier refuses) held against the per-edge
   float64 computation, 3 BPR and 3 TransE steps, one profiled; TGCN's
   ``ell`` tier in float64 against ``auto`` within 1e-9 of scale, its
   float32 forward held, and its BPR step profiled beside ``auto``'s;
8. the capture phase (``capture_hold``), at the end of every training
   path above, on its pipeline: DGCF and DisenGCN at hetrec, KGAT
   ``bi_inter`` (BPR and TransE), LightGCN at hetrec (dense sectors) and
   at 10x (hybrid, and with ``node_drop``), NGCF at hetrec, DisenHAN,
   TGCN ``auto`` and ``ell`` (BPR and TransTag), DGCF 10x (EdgeMap) and
   KGAT over the KG: from one snapshot of the parameters and the
   generator, two eager runs and one captured run (the Trainer's CUDA
   graph after its warm-up) of a few steps a phase; the captured
   batches equal the eager ones bit for bit, its losses and parameters
   too wherever the two eager runs agree, else within 4x
   (``GRAD_FLOOR``) their difference, and the launch counts are equal;
   then per phase ms a step eager against replayed (host clock,
   synchronised), a phase's wall time with one sync at the end,
   a replay's device busy, idle share and operations (profiler), the
   capture's time and the peak memory; ``edge_reduce`` is also timed
   replayed in a graph in phase E; every training run above goes
   through the captured Trainer too (the CLI's as well);
9. phase P, the parallel layer (``tagrec_tpu_torch.parallel``): P1, a
   one-rank NCCL mesh in this process (a ``HashStore`` group): DGCF
   (``cor_reg`` 0.1) at the preset's width on the hetrec graph through
   ``build_pipeline(mesh=)`` and ``Trainer(mesh=)``, captured, with its
   all-gathers and gradient all-reduce inside the graph, held bit for bit
   (losses and parameters) against the same captured run without a mesh,
   its routing launches checked each step; ``Evaluator(mesh=)``'s ranking
   metrics equal the unmeshed ones (AUC by counting, within rtol 5e-3),
   ``Retriever(mesh=)`` answers 3 requests with the same ids, and
   ``save_sharded`` -> ``load_sharded`` restores every table and its Adam
   state; the captured step's ms with and without the mesh (plain, mesh,
   mesh, plain) and the NCCL kernels' share of a replay (profiler).  P2,
   two ranks on this one card, data = 2 and model = 2 (four processes of
   ``chip_smoke.py mesh-rank``, gloo over CUDA tensors, eager: NCCL
   refuses two ranks on one device): the same DGCF steps, an evaluation
   and the requests, held against the one-device eager run, model alone
   bit for bit, data within 1e-6 (losses) and a hundredth of lr a step
   (parameters: 5e-4 after 5 steps); each sub-phase's seconds; then
   phase R, the graph tables row-sharded over ``model``: R1 LightGCN 10x
   captured on a one-rank NCCL mesh, bit for bit against the unmeshed
   captured run; R2 two ``chip_smoke.py row-rank`` processes (model = 2,
   gloo, eager: LightGCN 10x, NGCF 10x, LightGCN hetrec) against the
   one-device run; R3 the EdgeMap tier: R3a DGCF 10x captured on a
   one-rank NCCL mesh, bit for bit, 252 ``gather_reduce`` launches a
   step, ms a step with and without the mesh and the mesh's own
   operations a replay; R3b two ``chip_smoke.py em-rank`` processes
   (DGCF and DisenGCN hetrec ``ell``, DGCF 10x) against the one-device
   run: forward within RTOL/ATOL, each bucket's ``gather_reduce`` rows
   over the rank's rows bit for bit, losses and parameters within R2's
   bounds, the ranks bit for bit, each rank's map bytes and peak memory;
   R4 the other families' EdgeMaps (R4a KGAT 10x captured on a one-rank
   NCCL mesh; R4b ``em4-rank`` processes: DisenHAN, KGAT, TGCN ``ell``,
   KGAT over a KG, KGAT 10x); R5 TGCN's neighbour tables and dedup
   buckets (R5a TGCN ``auto`` hetrec captured on a one-rank NCCL mesh,
   bit for bit; R5b ``tgcn-rank`` processes: TGCN ``auto``,
   ``dense_xla`` and ``ell`` at hetrec, each rank's table bytes, peak and
   attention rows, the forward, evaluation, export and losses against
   one device, the first step's well-conditioned parameters, at most 8
   entries of the trajectory past its bound, and one float64 step's
   gradients and parameters within 1e-9 of scale, each gradient within
   1e-6 of its own scale plus 1e-12 of the largest gradient's);
   R6 the kernel tiers' masks (each sweep over a block of rows past row
   0 against its plain version, the column backward's block across the
   split, and bit for bit with the whole launch's rows; R6a DGCF hetrec
   captured on a one-rank NCCL mesh, bit for bit, DGCF_STEP routing
   launches a step; R6b ``mask-rank`` processes: DGCF, DisenGCN and KGAT
   ``bi_inter`` at hetrec, each rank's mask bytes its rows', its peak
   below one device's, each sweep's rows, the forward, evaluation,
   export, losses and parameters bit for bit with one device, the
   launches one device's over half its mask rows); R7 the chunked dense
   tiers' tables (R7a KGAT over phase K's KG, relation-dense, captured on
   a one-rank NCCL mesh, bit for bit; R7b ``dense-rank`` processes:
   DisenHAN and the KG at hetrec under ``auto``, DGCF, DisenGCN and KGAT
   under ``dense_xla``, each rank's table bytes and rows of P as
   predicted, its peak below one device's, the forward, evaluation and
   export bit for bit, losses and parameters within R5b's bounds, one
   float64 step within 1e-9 of scale; KGAT ``dense_xla``'s forward on a
   rank against its kernel tier's, which launches the flash kernels on
   the rank's rows);
   TGCN's tables (phase 5) must come from the native sampler;
10. the ``kernels`` JSON line (launches summed over every path above,
   replays counted; ``gather_reduce`` with its ``edgemap`` record), then
   ``{"ok": true, "device": {...}}`` last.

Any failed check or exception exits non-zero before the last line.  With no
CUDA device, or outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and
# float32 operations/s on the CUDA cores (outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain float32: sums in another order
BWD_RTOL = 5e-4          # the flash backward's sums are longer
BF16_FWD_ATOL = 5e-3     # NGCF's bf16 forward against float32 (1.5e-3 read)
GRAD_FLOOR = 4.0         # a gradient's error against plain float32's

N_USER, N_ITEM, N_TAG, N_EDGES, TAG_PER_INTER = 2000, 10000, 3000, 400_000, 0.3
N_REQUESTS, REQUEST_USERS, TOP_K = 3, 256, 20
KGAT_BPR_STEPS, KGAT_TRANSE_STEPS = 5, 3
ROUTED_BPR_STEPS = 5  # DGCF and DisenGCN
ROUTING = ("routed_rowsum", "routed_mm", "routed_mm_bwd")
FLASH = ("dot_flash_stats", "dot_flash_apply", "dot_bwd_row", "dot_bwd_col")
GATHER = ("gather_reduce", "gather_rows")
# LightGCN's hybrid tier: the "10x" graph of DESIGN.md section 7 (150,000
# joint nodes, past the 2 GiB dense budget), n_user, n_item, n_tag, n_edges
LGCN_10X = (20000, 100000, 30000, 4_000_000)
LGCN_BPR_STEPS, HETREC_BPR_STEPS = 5, 5
# KGAT's propagation inputs per forward: dx 64 at layers 0 and 1, 32 at 2
KGAT_DX = ((64, 2), (32, 1))
# stats is also held at the row type's split plus this, off every 64-column
# tile (the edge sweeps choose the plane per edge)
STATS_SPLIT_SHIFT = 37


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, runs: int):
    """Median device time of ``fn()`` over ``runs`` back-to-back launches,
    each between two CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def device_ms(torch, fn, calls: int = 10, runs: int = 5):
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, the median of ``runs`` replays (``graph_ms``) over ``calls``,
    which launches every kernel of the calls without the host's cost of
    launching them one by one.  torch.profiler's trace is no such source:
    on the card it missed some launches of the hand-written kernels, down
    to all of a call's."""
    return graph_ms(torch, fn, runs, calls) / calls


def on_device(event) -> bool:
    """A kernel, copy or set of the device's trace; not a user annotation
    (such as ``Optimizer.step#Adam.step``), whose device range spans the
    kernels under it and the gaps between them."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def counts(mod, names):
    """The launch counters of ``mod``'s kernel wrappers ``names``."""
    return {name: getattr(mod, name).launches for name in names}


def reset_counts(mod, names):
    for name in names:
        getattr(mod, name).launches = 0


def launch_checker(mod, names, want, label):
    """A callback for ``training_steps``: the launches of ``mod``'s kernels
    over ``steps`` steps, checked against ``want`` a step, and, where the
    phase's ``run`` (its ``PhaseRun``) holds a captured step, that step's
    own launches against ``want``; the counters reset.  The Trainer adds an
    epoch's replays to the counters once its steps are queued, so they are
    read when ``run_phase`` returns."""
    from tagrec_tpu_torch.training.train import COUNTED

    def on_launches(steps, run):
        got = counts(mod, names)
        reset_counts(mod, names)
        each = {k: v * steps for k, v in want.items()}
        check(got == each, f"{label}: launches {got} over {steps} steps, "
                           f"expected {want} a step")
        if run.graph is not None:
            one = {n: run.launches[COUNTED.index(getattr(mod, n))]
                   for n in names}
            check(one == want, f"{label}: the captured step launches {one},"
                               f" expected {want}")
        return got
    return on_launches


def training_steps(torch, trainer, phase, steps, label, on_launches=None):
    """``steps`` steps of ``phase`` through the Trainer, each synchronised,
    timed and checked finite (losses and every parameter);
    ``on_launches(steps, run)`` after them checks and returns their launch
    counts (``run``: the phase's ``PhaseRun``).  Returns the launches summed over the steps."""
    params = list(trainer.model.parameters())
    times, last = [], [0.0]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        check(bool(torch.isfinite(parts).all()),
              f"{label} step {i}: loss {parts.tolist()}")
        check(all(bool(torch.isfinite(p).all()) for p in params),
              f"{label} step {i}: a parameter is not finite")
        last[0] = time.perf_counter()

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    losses = trainer.run_phase(phase, max_steps=steps, on_step=on_step)
    total = on_launches(steps, trainer.runs[phase.name]) \
        if on_launches else {}
    check(len(times) == steps, f"{label}: {len(times)} steps run")
    print(f"{label}: {steps} steps, ms per step (host clock, synchronised): "
          f"{', '.join(f'{t:.3f}' for t in times)}; median "
          f"{sorted(times)[steps // 2]:.3f}; losses "
          f"{[round(float(v), 6) for v in losses.sum(axis=1)]}")
    return total


# ------------------------------------------------------ the capture phase

# steps of each run from one snapshot: WARMUP_STEPS eager, then the
# capture and replays
CAPTURE_STEPS = 5
PHASE_BUDGET_S = 1.5   # a timed phase: the steps that fit, at least 4
PROFILED_REPLAYS = 3
CAPTURED = []          # one summary per path and phase, printed at the end


def batch_leaves(b):
    """A batch's tensors (a tensor, or dicts of them), in a fixed order."""
    if isinstance(b, dict):
        return [t for key in sorted(b) for t in batch_leaves(b[key])]
    return [b]


def recording(phase):
    """-> (``phase`` whose make_batch also copies each batch into row i of
    static [steps_per_epoch, ...] buffers, those buffers): a captured
    run's batches, read back.  The buffers are made at the first call,
    an eager one."""
    import dataclasses

    bufs = []

    def make_batch(gen, i, state, data):
        b = phase.make_batch(gen, i, state, data)
        leaves = batch_leaves(b)
        if not bufs:
            bufs.extend(t.new_zeros((phase.steps_per_epoch,) + tuple(t.shape))
                        for t in leaves)
        for buf, t in zip(bufs, leaves):
            buf.index_copy_(0, i, t[None])
        return b

    return dataclasses.replace(phase, make_batch=make_batch), bufs


def capture_run(torch, model, phases, tcfg, snap, gen, gstate, capture):
    """CAPTURE_STEPS steps of each of ``phases`` through a new Trainer
    (its own Adam, fresh as in the snapshot), from the snapshot's
    parameters and generator state, each step synchronised and timed."""
    from tagrec_tpu_torch.training.train import COUNTED, Trainer

    with torch.no_grad():
        for p, s in zip(model.parameters(), snap):
            p.copy_(s)
    gen.set_state(gstate)
    recs = [recording(ph) for ph in phases]
    trainer = Trainer(model, [ph for ph, _ in recs], tcfg, generator=gen,
                      capture=capture)
    before = [f.launches for f in COUNTED]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = {}, {}
    for ph, _ in recs:
        times, last = [], [0.0]

        def on_step(i, parts):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append((now - last[0]) * 1e3)
            last[0] = now

        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        losses[ph.name] = torch.from_numpy(trainer.run_phase(
            ph, max_steps=CAPTURE_STEPS, on_step=on_step))
        ms[ph.name] = times
    return {"trainer": trainer, "phases": [ph for ph, _ in recs],
            "losses": losses, "ms": ms,
            "launches": {f.__name__: f.launches - b
                         for f, b in zip(COUNTED, before)},
            "params": [p.detach().clone() for p in model.parameters()],
            "batches": {ph.name: [t.clone() for t in bufs]
                        for ph, bufs in recs},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def capture_rule(torch, got, a, b):
    """The hold of a captured tensor ``got`` against the eager run ``a``:
    bit for bit where ``a`` equals the second eager run ``b``, else within
    GRAD_FLOOR times their difference -> (ok, |got - a|, |b - a|)."""
    got_err = float((got - a).abs().max()) if got.numel() else 0.0
    if torch.equal(a, b):
        return torch.equal(got, a), got_err, 0.0
    spread = float((b - a).abs().max())
    return got_err <= GRAD_FLOOR * spread, got_err, spread


def replay_profile(torch, graph, reps):
    """(device busy ms, idle share, device operations) per replay of
    ``graph``, from torch.profiler over ``reps`` replays."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if on_device(e)]
    if not dev:
        return None, None, 0
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return busy_us / reps / 1e3, 1 - busy_us / span_us, len(dev) / reps


def phase_wall_ms(torch, trainer, phase, steps):
    """Host ms of ``steps`` steps of ``phase`` with one synchronisation,
    at the end (``run_phase`` reads the losses back once)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_phase(phase, max_steps=steps)
    return (time.perf_counter() - t0) * 1e3


def capture_hold(torch, label, model, phases, tcfg):
    """The capture phase on one path: from one snapshot of the parameters
    (Adam fresh) and of the generator, two eager runs and one captured run
    of CAPTURE_STEPS steps of each phase.  The captured batches must equal
    the first eager run's bit for bit; its losses and parameters must equal
    them bit for bit wherever the two eager runs agree, else lie within
    GRAD_FLOOR times their difference; the launch counts must be equal.
    Then per phase: ms a step (host clock, synchronised), eager against
    the replays; a phase's wall time with one sync at the end (as many
    steps as fit PHASE_BUDGET_S, or all of them); device busy, idle share
    and operations a replay (profiler); capture time; peak memory."""
    import statistics

    from tagrec_tpu_torch.training.train import WARMUP_STEPS

    done = phase_timer(f"capture {label}")
    snap = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(11)
    gstate = gen.get_state()
    a, b, c = (capture_run(torch, model, phases, tcfg, snap, gen, gstate,
                           capture) for capture in (False, False, True))
    ok = a["launches"] == c["launches"] == b["launches"]
    print(f"capture {label}: launches eager {a['launches']}, captured "
          f"{c['launches']} {'equal' if ok else 'DIFFER'}")
    for name in a["batches"]:
        same = all(torch.equal(x, y) for x, y in zip(a["batches"][name],
                                                     c["batches"][name]))
        ok &= same
        print(f"capture {label} {name}: {CAPTURE_STEPS} batches bit for bit "
              f"{'equal' if same else 'DIFFER'}")
    worst = {"bitwise": 0, "spread": 0, "fail": []}
    pairs = [(f"loss {k}", c["losses"][k], a["losses"][k], b["losses"][k])
             for k in a["losses"]]
    pairs += [(f"param {n}", pc, pa, pb) for n, pc, pa, pb in zip(
        [n for n, _ in model.named_parameters()], c["params"], a["params"],
        b["params"])]
    for what, got, ea, eb in pairs:
        held, err, spread = capture_rule(torch, got, ea, eb)
        worst["bitwise" if spread == 0 else "spread"] += 1
        if not held:
            worst["fail"].append(f"{what}: |captured - eager| {err:.3e}, "
                                 f"eager spread {spread:.3e}")
    ok &= not worst["fail"]
    print(f"capture {label}: {worst['bitwise']} of {len(pairs)} losses and "
          f"parameters bit for bit (the eager runs agree), "
          f"{worst['spread']} within {GRAD_FLOOR}x the eager spread; "
          f"failures {worst['fail'][:6]}")
    check(ok, f"capture {label}: the captured run disagrees with the eager")
    del b
    for ea, ca in zip(a["phases"], c["phases"]):
        name = ea.name
        run = c["trainer"].runs[name]
        eager_ms = statistics.median(a["ms"][name][1:])
        graph_ms = statistics.median(c["ms"][name][WARMUP_STEPS + 1:])
        total = ea.steps_per_epoch
        k_graph = min(total, max(4, int(PHASE_BUDGET_S * 1e3 / graph_ms)))
        k_eager = min(k_graph, max(4, int(PHASE_BUDGET_S * 1e3 / eager_ms)))
        wall_graph = phase_wall_ms(torch, c["trainer"], ca, k_graph)
        wall_eager = phase_wall_ms(torch, a["trainer"], ea, k_eager)
        run.counter.zero_()  # rows 0.. of the loss buffer: in range
        busy, idle, ops = replay_profile(torch, run.graph,
                                         min(PROFILED_REPLAYS, total))
        row = {"path": label, "phase": name, "steps_per_epoch": total,
               "eager_ms": eager_ms, "captured_ms": graph_ms,
               "eager_phase_ms": wall_eager, "eager_phase_steps": k_eager,
               "captured_phase_ms": wall_graph,
               "captured_phase_steps": k_graph,
               "busy_ms": busy, "idle": idle, "graph_ops": ops,
               "capture_s": run.capture_s, "peak_gib": c["peak_gib"]}
        CAPTURED.append(row)
        print(f"capture {label} {name}: ms a step (host clock, synchronised) "
              f"eager {eager_ms:.3f}, captured {graph_ms:.3f} "
              f"({eager_ms / graph_ms:.2f}x); {k_graph} of {total} steps with "
              f"one sync: captured {wall_graph:.1f} ms "
              f"({wall_graph / k_graph:.3f} a step), eager {k_eager} steps "
              f"{wall_eager:.1f} ms ({wall_eager / k_eager:.3f} a step); a "
              f"replay: device busy {busy:.3f} ms, idle share {idle:.4f}, "
              f"{ops:.0f} device operations (profiler on); capture "
              f"{run.capture_s:.3f} s; peak device memory "
              f"{c['peak_gib']:.3f} GiB")
    del a, c
    gc_cuda(torch)
    done()


def graph_ms(torch, fn, runs: int = 15, calls: int = 1):
    """Median device time of one replay of ``calls`` calls of ``fn``
    captured in one CUDA graph (CUDA events, as ``time_ms``): their
    launches without the host's cost.  The launch counts of the warm-up
    call and the capture are taken back."""
    from tagrec_tpu_torch.training.train import COUNTED

    before = [f.launches for f in COUNTED]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for f, n in zip(COUNTED, before):
        f.launches = n
    ms = time_ms(torch, graph.replay, runs)
    del graph
    return ms


def small_graph_grad_check(torch, label, make_model, cor=False):
    """The forward and the gradients of one BPR loss of
    ``make_model(graph, device)`` on a small graph: CUDA kernels against the
    CPU plain path, with the same seeded weights; ``cor``: the loss takes
    distance-correlation ids too."""
    import numpy as np

    from tagrec_tpu_torch.data.synthetic import synthetic_graph

    g = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, g.n_user, 64),
                      rng.integers(0, g.n_item, 64),
                      rng.integers(0, g.n_item, 64)], axis=1)
    cor_ids = {"user": rng.integers(0, g.n_user, 50),
               "item": rng.integers(0, g.n_item, 50),
               "tag": rng.integers(0, g.n_tag, 50)}
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        model = make_model(g, dev)
        with torch.no_grad():
            outs.append([t.cpu() for t in model.forward()])
        kw = ({"cor": {k: torch.as_tensor(v, device=dev)
                       for k, v in cor_ids.items()}} if cor else {})
        sum(model.bpr_loss(torch.as_tensor(batch, device=dev),
                           **kw)).backward()
        grads.append([p.grad.cpu() for p in model.parameters()])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    ok = all(torch.allclose(a, b, rtol=RTOL, atol=ATOL) for a, b in zip(*outs))
    g_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    g_ok = all(torch.allclose(a, b, rtol=BWD_RTOL, atol=ATOL)
               for a, b in zip(*grads))
    print(f"{label} small-graph forward, cuda vs cpu: max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}; BPR gradients: max_abs_err {g_err:.3e} "
          f"(rtol {BWD_RTOL}) {'ok' if g_ok else 'FAIL'}")
    check(ok and g_ok, f"the CUDA {label} disagrees with the CPU {label}")


def kernel_inputs(torch, f, n, r, dx, seed):
    """The path's q/k/x at rank r: r=8 is DGCF's all-zero first iteration;
    otherwise blocks of 16 like the update factors (unit rows for q, tanh of
    unit rows for k)."""
    from tagrec_tpu_torch.ops.propagate import l2_normalize

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((f, n, dx), generator=g, device="cuda")
    if r == 8:
        q = torch.zeros((f, n, r), device="cuda")
        return q, torch.zeros_like(q), x
    blocks = [torch.randn((2, f, n, 16), generator=g, device="cuda")
              for _ in range(r // 16)]
    q = torch.cat([l2_normalize(b[0], dim=2) for b in blocks], dim=2)
    k = torch.cat([torch.tanh(l2_normalize(b[1], dim=2)) for b in blocks], dim=2)
    return q.contiguous(), k.contiguous(), x


# the ranks of DGCF's routing iterations in one forward (3 layers x 2
# iterations): an all-zero rank-8 start, then 16 more per iteration
DGCF_RANKS = (8, 16, 32, 48, 64, 80)
# the ranks of the backward sweeps of one BPR step: each layer's last
# routing iteration, the only routed_mm whose output reaches the loss other
# than through q and k (which get no gradient)
DGCF_BWD_RANKS = (16, 48, 80)


def plain_bwd64(torch, fr, q, k, mask, g, base):
    """routed_mm's gradient in x by the plain version's autograd, in
    float64: the reference of the backward kernel, independent of its
    formulation as the forward over the mask's transpose."""
    f, m, dx = k.shape[0], k.shape[1], g.shape[2]
    x = torch.zeros((f, m, dx), dtype=torch.float64, device=q.device,
                    requires_grad=True)
    out = fr.routed_mm_plain(q.double(), k.double(), mask, x, base)
    (dx64,) = torch.autograd.grad(out, x, g.double())
    return dx64


def routing_cases(torch, fr, q, k, mask, mask_t, x, g, base, e, et):
    """{kernel: (kernel call, float32 plain call, float64 reference)} of the
    routing kernels on one set of inputs, the kernels over the edge lists
    ``e`` of mask and ``et`` of mask_t (the backward's plain call is what
    the CPU path runs: the forward's plain version over mask^T)."""
    q64, k64, x64 = q.double(), k.double(), x.double()
    return {
        "routed_rowsum": (lambda: fr.routed_rowsum(q, k, mask, base, edges=e),
                          lambda: fr.routed_rowsum_plain(q, k, mask, base),
                          lambda: fr.routed_rowsum_plain(q64, k64, mask, base)),
        "routed_mm": (lambda: fr.routed_mm(q, k, mask, x, base, edges=e),
                      lambda: fr.routed_mm_plain(q, k, mask, x, base),
                      lambda: fr.routed_mm_plain(q64, k64, mask, x64, base)),
        "routed_mm_bwd": (
            lambda: fr.routed_mm_bwd(q, k, mask_t, g, base, edges=et),
            lambda: fr.routed_mm_plain(k, q, mask_t, g, base),
            lambda: plain_bwd64(torch, fr, q, k, mask, g, base)),
    }


def check_routing(torch, name, label, kern, plain, plain64):
    """One routing kernel against its plain version evaluated in float64 on
    the same inputs: the heaviest rows sum up to 5,691 terms, and the
    float32 plain version's own rounding on such a sum exceeds atol where
    it cancels to near zero (its distance is printed too).  -> (the
    kernel's output, max abs error)."""
    got = kern()
    torch.cuda.synchronize()
    want = plain64()
    err = (got.double() - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(got.double(), want, rtol=RTOL, atol=ATOL))
    plain_err = float((plain().double() - want).abs().max())
    print(f"{name} {label}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max_rel:.3e} against the float64 plain version "
          f"(tolerance rtol {RTOL}, atol {ATOL}) "
          f"{'ok' if ok else 'FAIL'}; the float32 plain version's "
          f"max_abs_err {plain_err:.3e}")
    check(ok, f"{name} {label} disagrees with its plain version")
    check(bool(torch.isfinite(got).all()), f"{name} {label} not finite")
    return got, max_abs


def routing_bound(name, q, k, mask, x, nnz):
    """(bytes time, operations time) in ms of one launch: each input read
    and output written once, the dense mask among them (the kernels read
    its edge list instead, which ``routing_roofline`` counts), and the
    operations of the mask's edges only (the backward is the forward's
    launch over mask^T, with g for x)."""
    f, r, dx = q.shape[0], q.shape[2], x.shape[2]
    io_bytes = (q.numel() + k.numel()) * 4 + mask.numel()
    ops_per_edge = f * (2 * r + 4)  # scores, exp, sum over F, scale, row sum
    if name == "routed_rowsum":
        io_bytes += q.shape[0] * q.shape[1] * 4
    else:  # x (or g) read, out written: [F, M, dx] and [F, N, dx]
        io_bytes += (k.shape[1] + q.shape[1]) * f * dx * 4
        ops_per_edge = f * (2 * r + 3 + 2 * dx)
    return (io_bytes / PEAK_BYTES_PER_S * 1e3,
            nnz * ops_per_edge / PEAK_F32_OPS_PER_S * 1e3)


def kernel_phase(torch, fr, mask, mask_t, e, et):
    """Each routing kernel (the backward over ``mask_t``; the kernels over
    their edge lists ``e`` and ``et``) against its plain version at every
    rank of one DGCF forward; returns the per-kernel
    records, ms, plain_ms and bound_ms summed over one forward's six
    launches (one per rank) or, for the backward, one BPR step's three
    (DGCF_BWD_RANKS), with the r=80 launch's own numbers under "r80"."""
    f, dx, base = 4, 16, 1.0
    n, m = mask.shape
    nnz = int(mask.sum().item())
    tiles = torch.nn.functional.pad(mask, (0, -m % 32, 0, -n % 32))
    tiles = tiles.reshape(-(-n // 32), 32, -(-m // 32), 32).any(3).any(1)
    print(f"mask: {n}x{m}, {nnz} edges ({100.0 * nnz / (n * m):.3f}% dense); "
          f"{int(tiles.sum())} of {tiles.numel()} 32x32 tiles hold an edge "
          f"({100.0 * float(tiles.float().mean()):.2f}%)")
    deg = e.indptr.diff()
    print(f"edge list: {e.nnz} entries, {e.segs.shape[0]} segments of at "
          f"most {e.seg_len} edges, {e.splits.shape[0]} rows split over "
          f"{e.slots} of them (heaviest row {int(deg.max())} edges, "
          f"{int((deg > e.seg_len).sum())} rows past {e.seg_len})")
    check(e.nnz == nnz, f"the edge list holds {e.nnz} edges, the mask {nnz}")
    records = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
                      "library_ms": None} for name in ROUTING}
    for r in DGCF_RANKS:
        q, k, x = kernel_inputs(torch, f, n, r, dx, seed=r)
        g = torch.randn((f, n, dx), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(r))
        cases = routing_cases(torch, fr, q, k, mask, mask_t, x, g, base, e,
                              et)
        for name, (kern, plain, plain64) in cases.items():
            got, max_abs = check_routing(torch, name, f"r={r}", kern, plain,
                                         plain64)
            check(torch.equal(got, kern()),
                  f"{name} r={r}: two launches differ")
            records[name]["max_abs_err"] = max(
                records[name]["max_abs_err"], max_abs)
            if name == "routed_mm_bwd" and r not in DGCF_BWD_RANKS:
                continue  # checked; a BPR step does not run it
            ms = time_ms(torch, kern, runs=15)
            plain_ms = time_ms(torch, plain, runs=5)
            t_bytes, t_ops = routing_bound(name, q, k, mask, x, nnz)
            rec = records[name]
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", max(t_bytes, t_ops)),
                           ("t_bytes", t_bytes), ("t_ops", t_ops)):
                rec[key] += v
            if r == DGCF_RANKS[-1]:
                rec["r80"] = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": max(t_bytes, t_ops)}
            print(f"{name} r={r}: kernel {ms:.4f} ms (median of 15), plain "
                  f"{plain_ms:.3f} ms (median of 5), bound "
                  f"{max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    for name, rec in records.items():
        t_bytes, t_ops = rec.pop("t_bytes"), rec.pop("t_ops")
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        bwd = name == "routed_mm_bwd"
        per = "BPR step" if bwd else "forward"
        ranks = DGCF_BWD_RANKS if bwd else DGCF_RANKS
        rec["shape"] = (f"F={f} N={n} M={m} r={'/'.join(map(str, ranks))}"
                        + ("" if name == "routed_rowsum" else f" dx={dx}")
                        + f"; per DGCF {per}: one launch per rank")
        print(f"{name}: {rec['ms']:.4f} ms per DGCF {per} (plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})); at r=80 {rec['r80']['ms']:.4f} ms a "
              f"launch (bound {rec['r80']['bound_ms']:.4f} ms)")
    return records


def disengcn_kernel_phase(torch, fr, mask, mask_t, e, et, records):
    """routed_mm and its backward at DisenGCN's shapes (F=4, r = dx = 16,
    base 0; q, k and x unit rows, as new_fac and fac are) against their
    plain versions; their ms, plain_ms and bound_ms per DisenGCN BPR step
    (six forward launches, three backward) go under "disengcn" in
    ``records``."""
    from tagrec_tpu_torch.ops.propagate import l2_normalize

    f, dk = 4, 16
    n = mask.shape[0]
    nnz = int(mask.sum().item())
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k = (l2_normalize(torch.randn((f, n, dk), generator=gen,
                                     device="cuda"), dim=2).contiguous()
            for _ in range(2))
    g = torch.randn((f, n, dk), generator=gen, device="cuda")
    cases = routing_cases(torch, fr, q, k, mask, mask_t, k, g, 0.0, e, et)
    # per BPR step: 3 layers x 2 routing rounds forward; backward, the
    # last round of each layer (the first feeds only the next round's q)
    per_step = {"routed_mm": 6, "routed_mm_bwd": 3}
    for name, steps in per_step.items():
        kern, plain, plain64 = cases[name]
        _, max_abs = check_routing(torch, name, "DisenGCN r=16", kern, plain,
                                   plain64)
        ms = time_ms(torch, kern, runs=15)
        plain_ms = time_ms(torch, plain, runs=5)
        t_bytes, t_ops = routing_bound(name, q, k, mask, k, nnz)
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
        rec["disengcn"] = {"ms": steps * ms, "plain_ms": steps * plain_ms,
                           "bound_ms": steps * max(t_bytes, t_ops),
                           "bound_by": ("bytes" if t_bytes >= t_ops
                                        else "operations")}
        print(f"{name} DisenGCN r=16: kernel {ms:.4f} ms a launch (median "
              f"of 15), plain {plain_ms:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms; x{steps} per BPR step: "
              f"{steps * ms:.4f} ms")


def asymmetric_mask_check(torch, fr, records):
    """The routing kernels on a non-symmetric mask whose rows, and its
    transpose's, are off the 16-byte words (4001 x 2999, 1% dense, with
    an empty row and column, a full row and column), given its own
    contiguous transpose: a swapped q and k, or mask for mask_t, cannot
    pass here."""
    f, dx = 4, 16
    n, m = 4001, 2999
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.rand((n, m), generator=gen, device="cuda") < 0.01
    mask[7], mask[:, 11] = False, False
    mask[9], mask[:, 13] = True, True
    mask_t = mask.t().contiguous()
    e, et = fr.mask_edges(mask), fr.mask_edges(mask_t)
    for r, base in ((16, 0.0), (80, 1.0)):
        q = torch.randn((f, n, r), generator=gen, device="cuda") / r ** 0.5
        k = torch.randn((f, m, r), generator=gen, device="cuda") / r ** 0.5
        x = torch.randn((f, m, dx), generator=gen, device="cuda")
        g = torch.randn((f, n, dx), generator=gen, device="cuda")
        cases = routing_cases(torch, fr, q, k, mask, mask_t, x, g, base, e,
                              et)
        for name, (kern, plain, plain64) in cases.items():
            _, max_abs = check_routing(
                torch, name, f"non-symmetric {n}x{m} r={r} base={base}",
                kern, plain, plain64)
            records[name]["max_abs_err"] = max(
                records[name]["max_abs_err"], max_abs)


def profile_device(torch, fn, label: str, names):
    """Where ``fn()``'s device time goes: torch.profiler's CUDA kernel events,
    summed by kernel (``names`` maps a fragment of the kernel's name to a
    label; the rest is "other"), against the profiled span (the device's
    idle share is what the kernels leave of it); returns the busy ms, or
    None without device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if on_device(e)]
    if not dev:
        print(f"{label} profile: no device events (device time not measured)")
        return
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    by_kernel, other = {}, {}
    for e in dev:
        key = next((v for k, v in names.items() if k in e.name), "other")
        ms = e.time_range.elapsed_us() / 1e3
        by_kernel.setdefault(key, []).append(ms)
        if key == "other":
            other.setdefault(e.name[:80], []).append(ms)
    busy_ms = sum(sum(v) for v in by_kernel.values())
    for key, ms in sorted(by_kernel.items()):
        print(f"{label} profile: {key}: {len(ms)} device ops, {sum(ms):.3f} ms "
              f"[{', '.join(f'{t:.3f}' for t in ms[:12])}"
              f"{', ...' if len(ms) > 12 else ''}]")
    for name, ms in sorted(other.items(), key=lambda kv: -sum(kv[1]))[:4]:
        print(f"{label} profile: other, largest: {len(ms)} x {name}: "
              f"{sum(ms):.3f} ms")
    print(f"{label} profile: device busy {busy_ms:.3f} ms in {len(dev)} "
          f"device ops of a "
          f"{span_us / 1e3:.3f} ms span (idle share "
          f"{1 - busy_ms * 1e3 / span_us:.4f}, profiler on)")
    return busy_ms


def steady_forward(torch, model, label: str):
    """Median host-clock time of 3 synchronised forwards, and the peak
    device memory over them."""
    torch.cuda.reset_peak_memory_stats()
    fwd = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.forward()
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t0) * 1e3)
    print(f"{label} forward steady state: {sorted(fwd)[1]:.3f} ms (median of "
          f"3, host clock); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def serve_requests(torch, graph, u_t, i_t, tmp, name: str):
    """Artifact -> Retriever -> 3 top-k requests, each checked against a host
    reference of the same request."""
    import numpy as np

    from tagrec_tpu_torch import serving

    path = os.path.join(tmp, f"{name}_export.npz")
    train = graph.user_items["train"]
    serving.save_export(path, u_t, i_t, model_name=name, train_pos=train)
    retriever = serving.Retriever.from_export(path, device="cuda")
    rng = np.random.default_rng(0)
    req_ms = []
    for q in range(N_REQUESTS):
        users = rng.choice(graph.n_user, REQUEST_USERS, replace=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, scores = retriever.topk(users, TOP_K)
        req_ms.append((time.perf_counter() - t0) * 1e3)
        check(ids.shape == (REQUEST_USERS, TOP_K) and np.isfinite(scores).all(),
              f"{name} request {q}: ids {ids.shape}, finite "
              f"{np.isfinite(scores).all()}")
        for b, u in enumerate(users):
            check(not set(ids[b].tolist()) & set(train.get(int(u), [])),
                  f"{name} request {q}: user {u} served a train positive")
        # host reference of the same request: masked sigmoid scores, top-k
        ref = 1.0 / (1.0 + np.exp(-(u_t[users].astype(np.float64)
                                    @ i_t.T.astype(np.float64))))
        for b, u in enumerate(users):
            ref[b, train.get(int(u), [])] = serving.MASK_SCORE
        ref_top = -np.sort(-ref, axis=1)[:, :TOP_K]
        check(np.allclose(scores, ref_top, rtol=0, atol=1e-5),
              f"{name} request {q}: top-k scores differ from the host "
              f"reference by {np.abs(scores - ref_top).max():.3e}")
    print(f"{name} top-k: {N_REQUESTS} requests of {REQUEST_USERS} users, "
          f"k={TOP_K}: {', '.join(f'{t:.3f}' for t in req_ms)} ms per request "
          "(host clock)")


# fragments of the routing kernels' demangled names
ROUTING_KERNEL_NAMES = {"routed_mm::mm_kernel": "routed_mm",
                        "routed_rowsum::rowsum_kernel": "routed_rowsum"}


def serving_phase(torch, fr, graph, model, tmp):
    """DGCF: drive export -> artifact -> retriever; returns the kernel
    launches counted in the export's forward."""
    import numpy as np

    from tagrec_tpu_torch import serving

    reset_counts(fr, ROUTING)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    forward_ms = (time.perf_counter() - t0) * 1e3
    launches = counts(fr, ROUTING)
    n_iter = model.cfg.num_layer * model.cfg.iterate_k
    print(f"export_tables: forward {forward_ms:.3f} ms (first call, host "
          f"clock), launches {launches}")
    check(launches == {"routed_rowsum": n_iter, "routed_mm": n_iter,
                       "routed_mm_bwd": 0},
          f"expected {n_iter} launches of each forward kernel, got {launches}")
    check(u_t.shape == (graph.n_user, 64) and i_t.shape == (graph.n_item, 64),
          f"table shapes {u_t.shape} {i_t.shape}")
    check(np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          "exported tables are not finite")
    steady_forward(torch, model, "DGCF")

    def forward():
        with torch.no_grad():
            model.forward()

    profile_device(torch, forward, "DGCF forward", ROUTING_KERNEL_NAMES)
    serve_requests(torch, graph, u_t, i_t, tmp, "dgcf")
    return launches


def small_graph_check(torch):
    """The whole forward on a small graph: CUDA kernels against the CPU plain
    path, with the same seeded weights."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.models import model_class

    g = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
    outs = []
    for dev in ("cuda", "cpu"):
        model = model_class("dgcf")(g, model_preset("dgcf"), device=dev,
                                    generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append([t.cpu() for t in model.forward()])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    ok = all(torch.allclose(a, b, rtol=RTOL, atol=ATOL) for a, b in zip(*outs))
    print(f"small-graph forward, cuda vs cpu: max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the CUDA forward disagrees with the CPU forward")


def routed_training_phase(torch, fr, graph, name, want):
    """``build_pipeline`` -> ``Trainer.run_phase``: ROUTED_BPR_STEPS BPR
    steps of ``name`` (DGCF or DisenGCN) at the preset's width on
    ``graph``, the launches of each step checked against ``want``; then one
    step profiled.  Returns (pipeline, launches summed over the steps)."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(name), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    (bpr,) = pipe.phases
    # the joint 'plain' mask is symmetric: the backward sweeps the mask
    # itself, with no second 225 MB buffer
    check(pipe.model.maskT is None and pipe.model.mask_t is pipe.model.mask,
          f"{name}: the hetrec mask should be its own transpose")
    print(f"{name} pipeline built in {time.perf_counter() - t0:.1f} s; "
          f"{bpr.steps_per_epoch} steps an epoch; the mask is its own "
          "transpose")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    label = f"{name} BPR"
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fr, ROUTING)
    total = training_steps(torch, trainer, bpr, ROUTED_BPR_STEPS, label,
                           launch_checker(fr, ROUTING, want, label))
    print(f"{label}: launches per step {want}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0, None, bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch), f"{label} step",
                   {"routed_mm::mm_kernel": "routed_mm (forward, then "
                                            "routed_mm_bwd)",
                    "routed_rowsum::rowsum_kernel": "routed_rowsum",
                    "routed::combine_kernel": "routing split rows' sums",
                    "multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    return pipe, total


def dgcf_training_phase(torch, fr, graph):
    """DGCF training on the hetrec graph, after the small-graph gradient
    check (with the distance-correlation term); returns its launches."""
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.models import model_class

    cfg = model_preset("dgcf", reg=1e-3, cor_reg=0.1)
    small_graph_grad_check(torch, "DGCF", lambda g, dev: model_class("dgcf")(
        g, cfg, device=dev, generator=torch.Generator().manual_seed(3)),
        cor=True)
    pipe, total = routed_training_phase(
        torch, fr, graph, "dgcf",
        {"routed_rowsum": 6, "routed_mm": 6, "routed_mm_bwd": 3})
    capture_hold(torch, "DGCF hetrec", pipe.model, pipe.phases, TrainConfig())
    del pipe
    torch.cuda.empty_cache()
    return total


def disengcn_phase(torch, fr, graph, tmp):
    """DisenGCN: the small-graph gradient check; training on the hetrec
    graph; export -> artifact -> 3 top-k requests; one evaluation of every
    test user.  Returns the launches of the steps, the export and the
    evaluation."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.models import model_class

    cfg = model_preset("disengcn", reg=1e-3)
    small_graph_grad_check(torch, "DisenGCN", lambda g, dev: model_class(
        "disengcn")(g, cfg, device=dev,
                    generator=torch.Generator().manual_seed(3)))
    fwd = {"routed_rowsum": 0, "routed_mm": 6, "routed_mm_bwd": 0}
    pipe, total = routed_training_phase(
        torch, fr, graph, "disengcn", {**fwd, "routed_mm_bwd": 3})
    model = pipe.model

    reset_counts(fr, ROUTING)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    forward_ms = (time.perf_counter() - t0) * 1e3
    exported = counts(fr, ROUTING)
    print(f"DisenGCN export_tables: forward {forward_ms:.3f} ms (first call, "
          f"host clock), launches {exported}")
    check(exported == fwd, f"expected {fwd} in a forward, got {exported}")
    check(u_t.shape == (graph.n_user, 64) and i_t.shape == (graph.n_item, 64)
          and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          f"DisenGCN tables {u_t.shape} {i_t.shape}, or not finite")
    steady_forward(torch, model, "DisenGCN")
    serve_requests(torch, graph, u_t, i_t, tmp, "disengcn")

    reset_counts(fr, ROUTING)
    t0 = time.perf_counter()
    res = pipe.evaluator.run(model)
    evaluated = counts(fr, ROUTING)
    print(f"DisenGCN evaluation of {len(graph.user_items['test'])} test "
          f"users: {time.perf_counter() - t0:.3f} s (host clock), launches "
          f"{evaluated} {json.dumps(res)}")
    check(evaluated == fwd, f"expected {fwd} in the evaluation, got "
                            f"{evaluated}")
    check(all(len(res[k]) == 2 for k in ("recall", "precision", "hr", "ndcg"))
          and all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"evaluation results {res}")
    capture_hold(torch, "DisenGCN hetrec", model, pipe.phases, TrainConfig())
    del pipe, model
    torch.cuda.empty_cache()
    return {k: total[k] + exported[k] + evaluated[k] for k in ROUTING}


# ------------------------------------------------------------------- KGAT

def compare(torch, got, want, rtol: float):
    """(allclose at rtol/ATOL, max abs error, max rel error where |want| >
    ATOL)."""
    err = (got - want).abs()
    big = want.abs() > ATOL
    max_rel = float((err[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    return (bool(torch.allclose(got, want, rtol=rtol, atol=ATOL)),
            float(err.max()), max_rel)


def flash_inputs(torch, ns: int, nd: int, dx: int, seed: int):
    """One row type's kernel inputs in the ranges the path produces: q =
    tanh of unit-scale values; k = e @ W_r with xavier e (an entity table
    [13000, 64]) and xavier W_r (transE [6, 64, 64]); x and g at unit
    scale, larger than the path's, so that the tolerance bites harder."""
    import math

    g = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(shape, a):
        return (torch.rand(shape, generator=g, device="cuda") * 2 - 1) * a

    q2 = torch.tanh(torch.randn((2, ns, 64), generator=g, device="cuda"))
    e = uniform((nd, 64), math.sqrt(6.0 / (13000 + 64)))
    w = uniform((64, 64), math.sqrt(6.0 / (64 * 64 + 6 * 64)))
    x = torch.randn((nd, dx), generator=g, device="cuda")
    grad = torch.randn((ns, dx), generator=g, device="cuda")
    return q2, (e @ w).contiguous(), x, grad


def check_flash_kernels(torch, fa, q2, k, mask, mask_t, split, x, g, label,
                        recs):
    """The four kernels against their plain versions on one set of inputs
    (``mask_t``: the mask's transpose, which dot_bwd_col sweeps); keeps the
    largest abs error of each kernel in ``recs``."""
    m, z = fa.dot_flash_stats(q2, k, mask, split)
    out = fa.dot_flash_apply(q2, k, mask, m, z, x, split)
    delta = torch.sum(g * out, dim=1)
    dq2 = fa.dot_bwd_row(q2, k, mask, m, z, x, g, delta, split)
    dk, dxo = fa.dot_bwd_col(q2, k, mask_t, m, z, x, g, delta, split)
    torch.cuda.synchronize()
    want_m, want_z = fa.dot_flash_stats_plain(q2, k, mask, split)
    # the backward sweeps are held against their plain versions evaluated in
    # float64 on the same inputs, as the routing kernels are: their heaviest
    # rows and columns sum thousands of terms of dS k and dS q that cancel
    # (the float32 plain versions' own distance is printed too)
    args32 = (q2, k, mask, m, z, x, g, delta, split)
    args64 = [t.double() for t in (q2, k)] + [mask] + [
        t.double() for t in (m, z, x, g, delta)] + [split]
    want_dq2 = fa.dot_bwd_row_plain(*args64)
    want_dk, want_dx = fa.dot_bwd_col_plain(*args64)
    err32 = {
        "dot_bwd_row": float((fa.dot_bwd_row_plain(*args32).double()
                              - want_dq2).abs().max()),
        "dot_bwd_col": max(float((a.double() - b).abs().max()) for a, b in
                           zip(fa.dot_bwd_col_plain(*args32),
                               (want_dk, want_dx)))}
    cases = {
        "dot_flash_stats": ([(m, want_m), (z, want_z)], RTOL),
        "dot_flash_apply": ([(out, fa.dot_flash_apply_plain(
            q2, k, mask, m, z, x, split))], RTOL),
        "dot_bwd_row": ([(dq2.double(), want_dq2)], BWD_RTOL),
        "dot_bwd_col": ([(dk.double(), want_dk), (dxo.double(), want_dx)],
                        BWD_RTOL),
    }
    for name, (pairs, rtol) in cases.items():
        against = ("against the float64 plain version; the float32 plain "
                   f"version's max_abs_err {err32[name]:.3e} "
                   if name in err32 else "")
        hold_flash(torch, name, label, pairs, rtol, against, recs)


def hold_flash(torch, name, label, pairs, rtol, against, recs):
    """Each (kernel output, plain output) pair allclose at rtol/ATOL and
    finite; keeps the largest abs error in ``recs[name]``."""
    res = [compare(torch, got, want, rtol) for got, want in pairs]
    ok = all(r[0] for r in res)
    max_abs = max(r[1] for r in res)
    print(f"{name} {label}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max(r[2] for r in res):.3e} {against}(rtol {rtol}, atol "
          f"{ATOL}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    check(all(bool(torch.isfinite(got).all()) for got, _ in pairs),
          f"{name} {label} not finite")
    recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], max_abs)


def time_flash_kernels(torch, fa, q2, k, mask, mask_t, split, x, g, nnz,
                       n_launch, label, recs):
    """Each kernel's and plain version's time on one set of inputs, and the
    bound of the launch, added ``n_launch[name]`` times into ``recs``."""
    m, z = fa.dot_flash_stats(q2, k, mask, split)
    out = fa.dot_flash_apply(q2, k, mask, m, z, x, split)
    delta = torch.sum(g * out, dim=1)
    timed = {
        "dot_flash_stats": (
            lambda: fa.dot_flash_stats(q2, k, mask, split),
            lambda: fa.dot_flash_stats_plain(q2, k, mask, split)),
        "dot_flash_apply": (
            lambda: fa.dot_flash_apply(q2, k, mask, m, z, x, split),
            lambda: fa.dot_flash_apply_plain(q2, k, mask, m, z, x, split)),
        "dot_bwd_row": (
            lambda: fa.dot_bwd_row(q2, k, mask, m, z, x, g, delta, split),
            lambda: fa.dot_bwd_row_plain(q2, k, mask, m, z, x, g, delta,
                                         split)),
        "dot_bwd_col": (
            lambda: fa.dot_bwd_col(q2, k, mask_t, m, z, x, g, delta, split),
            lambda: fa.dot_bwd_col_plain(q2, k, mask, m, z, x, g, delta,
                                         split)),
    }
    # least time of one launch: each input read and output written once
    # (4-byte floats, 1-byte mask or its transpose), and the float32
    # operations of the mask's edges only (per edge: the score 2dq, the
    # softmax term 3-4, dP 2dx, dS 2, each product 2dq or 2dx)
    (ns, nd), dq, dx = mask.shape, q2.shape[2], x.shape[1]
    vec = ns * 4
    base = 2 * ns * dq * 4 + nd * dq * 4 + ns * nd
    xg = nd * dx * 4 + ns * dx * 4
    io = {"dot_flash_stats": base + 2 * vec,
          "dot_flash_apply": base + 2 * vec + xg,
          "dot_bwd_row": base + 3 * vec + xg + 2 * ns * dq * 4,
          "dot_bwd_col": base + 3 * vec + xg + nd * (dq + dx) * 4}
    per_edge = {"dot_flash_stats": 2 * dq + 4,
                "dot_flash_apply": 2 * dq + 3 + 2 * dx,
                "dot_bwd_row": 4 * dq + 2 * dx + 5,
                "dot_bwd_col": 4 * dq + 4 * dx + 5}
    for name, (kern, plain) in timed.items():
        if not n_launch[name]:
            continue
        ms = time_ms(torch, kern, runs=15)
        plain_ms = time_ms(torch, plain, runs=5)
        t_bytes = io[name] / PEAK_BYTES_PER_S * 1e3
        t_ops = nnz * per_edge[name] / PEAK_F32_OPS_PER_S * 1e3
        rec, n = recs[name], n_launch[name]
        rec["ms"] += n * ms
        rec["plain_ms"] += n * plain_ms
        rec["bound_ms"] += n * max(t_bytes, t_ops)
        rec["t_bytes"] += n * t_bytes
        rec["t_ops"] += n * t_ops
        print(f"{name} {label}: kernel {ms:.3f} ms (median of 15), plain "
              f"{plain_ms:.3f} ms (median of 5), bound "
              f"{max(t_bytes, t_ops):.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}); x{n} per "
              "pass")
    return out


def time_sdpa(torch, q2, k, mask_b, split, x, out, label):
    """The yardstick of dot_flash_apply: one scaled_dot_product_attention
    call computing the same P @ x (q' = [q0 | q1], k' = k in plane 0's half
    left of the split and plane 1's half right of it, so q' k'^T = S).
    Returns its median time."""
    dq = q2.shape[2]
    qc = torch.cat([q2[0], q2[1]], dim=1)[None, None]
    kc = torch.zeros((k.shape[0], 2 * dq), device="cuda")
    kc[:split, :dq] = k[:split]
    kc[split:, dq:] = k[split:]
    kc = kc[None, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qc, kc, x[None, None], attn_mask=mask_b[None, None], scale=1.0)

    has = mask_b.any(dim=1)  # rows with no edge come out NaN there
    err = float((sdpa()[0, 0][has] - out[has]).abs().max())
    ms = time_ms(torch, sdpa, runs=5)
    print(f"dot_flash_apply {label}: scaled_dot_product_attention {ms:.3f} ms "
          f"(median of 5), max abs diff to the kernel on rows with an edge "
          f"{err:.3e}")
    return ms


def flash_kernel_phase(torch, fa, model):
    """Each flash-attention kernel against its plain version at the path's
    shapes: the three row types' masks, dq 64, dx 64 and 32.  Returns the
    per-kernel records; ms, plain_ms, bound_ms and library_ms are summed over
    one forward's launches (stats, apply) or one BPR step's (bwd_row,
    bwd_col): one stats launch per row type, and dx 64 twice and 32 once
    per row type for the others."""
    recs = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
                "library_ms": None} for n in FLASH}
    recs["dot_flash_apply"]["library_ms"] = 0.0
    shapes = []
    for a, (mask, mask_t, split) in enumerate(zip(
            model.flash_masks(), model.flash_masks_t(), model.flash_splits())):
        ns, nd = mask.shape
        nnz = int(mask.sum(dtype=torch.int64))
        print(f"row type {a}: mask {ns}x{nd}, split {split}, {nnz} edges "
              f"({100.0 * nnz / (ns * nd):.3f}% dense)")
        shapes.append(f"{ns}x{nd}/{split}")
        for dx, per_pass in KGAT_DX:
            label = f"type {a} dx={dx}"
            q2, k, x, g = flash_inputs(torch, ns, nd, dx, seed=100 * a + dx)
            # correctness at the path's scale, then with k at unit scale
            check_flash_kernels(torch, fa, q2, k, mask, mask_t, split, x, g,
                                f"{label} k path", recs)
            check_flash_kernels(torch, fa, q2, k * (0.3 / float(k.std())),
                                mask, mask_t, split, x, g, f"{label} k unit",
                                recs)
            if dx == KGAT_DX[0][0]:  # stats at a split off every tile
                off = split + STATS_SPLIT_SHIFT
                check(off <= nd, f"split {off} past the {nd} columns")
                m, z = fa.dot_flash_stats(q2, k, mask, off)
                want_m, want_z = fa.dot_flash_stats_plain(q2, k, mask, off)
                hold_flash(torch, "dot_flash_stats", f"type {a} split {off}",
                           [(m, want_m), (z, want_z)], RTOL, "", recs)
            # one stats sweep per row type, whatever dx
            n_launch = {name: per_pass for name in FLASH}
            n_launch["dot_flash_stats"] = int(dx == KGAT_DX[0][0])
            out = time_flash_kernels(torch, fa, q2, k, mask, mask_t, split, x,
                                     g, nnz, n_launch, label, recs)
            recs["dot_flash_apply"]["library_ms"] += per_pass * time_sdpa(
                torch, q2, k, mask.bool(), split, x, out, label)
    for name, rec in recs.items():
        t_bytes, t_ops = rec.pop("t_bytes"), rec.pop("t_ops")
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        per = "BPR step" if name.startswith("dot_bwd") else "forward"
        rec["shape"] = (f"Ns x Nd / split {', '.join(shapes)}; dq=64; per "
                        f"{per}: " + ("one launch per row type"
                                      if name == "dot_flash_stats" else
                                      "dx=64, 64, 32 per row type"))
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.3f} ms")
        print(f"{name}: {rec['ms']:.3f} ms per {per} (plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), library {lib})")
    return recs


def kgat_serving_phase(torch, fa, graph, model, tmp):
    """KGAT: export -> artifact -> retriever; returns the launches counted in
    the export's forward."""
    import numpy as np

    from tagrec_tpu_torch import serving

    reset_counts(fa, FLASH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    forward_ms = (time.perf_counter() - t0) * 1e3
    launches = counts(fa, FLASH)
    print(f"KGAT export_tables: forward {forward_ms:.3f} ms (first call, host "
          f"clock), launches {launches}")
    want = {"dot_flash_stats": 3, "dot_flash_apply": 9, "dot_bwd_row": 0,
            "dot_bwd_col": 0}
    check(launches == want, f"expected {want} in a forward, got {launches}")
    width = model.cfg.dim_latent + sum(model.cfg.dim_layer_list)
    check(u_t.shape == (graph.n_user, width)
          and i_t.shape == (graph.n_item, width),
          f"KGAT table shapes {u_t.shape} {i_t.shape}")
    check(np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          "KGAT exported tables are not finite")
    print(f"KGAT tables: user {u_t.shape}, item {i_t.shape}, finite")
    steady_forward(torch, model, "KGAT")

    def forward():
        with torch.no_grad():
            model.forward()

    profile_device(torch, forward, "KGAT forward", FLASH_KERNEL_NAMES)
    serve_requests(torch, graph, u_t, i_t, tmp, "kgat")
    return launches


# fragments of the kernels' demangled names (Adam's foreach kernels are
# named multi_tensor_apply_kernel, hence the namespace)
FLASH_KERNEL_NAMES = {"dot_flash::stats_kernel": "dot_flash_stats",
                      "dot_flash::apply_kernel": "dot_flash_apply",
                      "dot_flash::bwd_row_kernel": "dot_bwd_row",
                      "dot_flash::bwd_col_kernel": "dot_bwd_col"}


def kgat_training_phase(torch, fa, pipe, trainer):
    """5 BPR steps then 3 TransE steps through the Trainer's one Adam, the
    launches counted, the losses and every parameter checked finite, after
    each step; then one BPR step profiled.  Returns the launches summed over
    the steps."""
    bpr, transe = pipe.phases
    per_bpr = {"dot_flash_stats": 3, "dot_flash_apply": 9, "dot_bwd_row": 9,
               "dot_bwd_col": 9}
    total = dict.fromkeys(FLASH, 0)
    for phase, steps, want in ((bpr, KGAT_BPR_STEPS, per_bpr),
                               (transe, KGAT_TRANSE_STEPS,
                                dict.fromkeys(FLASH, 0))):
        label = f"KGAT {phase.name}"
        reset_counts(fa, FLASH)
        got = training_steps(torch, trainer, phase, steps, label,
                             launch_checker(fa, FLASH, want, label))
        print(f"{label}: launches per step {want}")
        for name in FLASH:
            total[name] += got[name]
    state = bpr.epoch_reset(trainer.generator, bpr.data)
    batch = bpr.make_batch(trainer.generator, 0, state, bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch), "KGAT BPR step",
                   {**FLASH_KERNEL_NAMES, "multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    return total


def kgat_small_graph_check(torch):
    """KGAT bi_inter on a small graph, cuda against cpu."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class

    cfg = model_preset("kgat", agg_type="bi_inter", reg=1e-4)
    small_graph_grad_check(torch, "KGAT", lambda g, dev: model_class("kgat")(
        g, cfg, device=dev, generator=torch.Generator().manual_seed(3)))


# --------------------------------------------------------------- LightGCN

# fragments of the gather kernels' demangled names
GATHER_KERNEL_NAMES = {"gather::reduce": "gather_reduce",
                       "gather::rows": "gather_rows"}


def lightgcn_tier(torch, model):
    """Print the adjacency the model built (``describe_hybrid``); returns
    the per-SpMM launches {gather_reduce: buckets, gather_rows: 2}."""
    adj = model.adj
    check(adj.bwd is adj.fwd, "bi_norm's pair should share one structure")
    h = adj.fwd
    check(type(h).__name__ == "Hybrid" and h.dense_cols is not None,
          f"expected the hybrid tier with hub columns, got {type(h).__name__}")
    return describe_hybrid("LightGCN", h)


def gather_kernel_phase(torch, dg, model):
    """Each gather kernel against its plain version at the path's shapes:
    gather_reduce over every bucket of the forward structure with the
    bucket's degrees (as ``ell_mm`` runs it), gather_rows over ``inv_perm``
    and ``dense_cols``.  ms, plain_ms and library_ms (CUDA events) and
    device_ms and library_device_ms (``device_ms``: the device time of the
    kernel and of the library call) are summed over one SpMM's launches;
    bound_ms is that of the SpMM's bytes and operations together, with x
    counted once for gather_reduce (its launches, one per bucket, run back
    to back and x fits the L2), and gather_reduce's bytes those of the real
    edges: 8 a slot below deg[n], 4 of deg a row (the every-slot bound, 8
    bytes a slot as a kernel without deg reads them, is printed beside
    it)."""
    F = torch.nn.functional
    h = model.adj.fwd
    n, d = h.dense_block.shape[0], model.cfg.dim_latent
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((n, d), generator=g, device="cuda")
    recs = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "device_ms": 0.0,
                   "library_device_ms": 0.0, "io_bytes": 0, "ops": 0}
            for name in GATHER}
    recs["gather_reduce"]["io_bytes"] = x.numel() * 4

    def record(name, label, kern, plain, lib, io_bytes, ops, exact):
        """``io_bytes``: what this launch alone moves (for gather_reduce,
        without x)."""
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        if exact:
            ok = bool(torch.equal(got, want))
        else:
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        err = float((got - want).abs().max())
        lib_err = float((lib() - got).abs().max())
        print(f"{name} {label}: max_abs_err {err:.3e} "
              f"({'bit for bit' if exact else f'rtol {RTOL}, atol {ATOL}'}) "
              f"{'ok' if ok else 'FAIL'}; library call differs by {lib_err:.3e}")
        check(ok, f"{name} {label} disagrees with its plain version")
        check(bool(torch.isfinite(got).all()), f"{name} {label} not finite")
        ms = time_ms(torch, kern, runs=15)
        plain_ms = time_ms(torch, plain, runs=5)
        lib_ms = time_ms(torch, lib, runs=15)
        dev_ms, lib_dev_ms = device_ms(torch, kern), device_ms(torch, lib)
        rec = recs[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("device_ms", dev_ms), ("library_device_ms", lib_dev_ms),
                       ("io_bytes", io_bytes), ("ops", ops)):
            rec[key] += v
        print(f"{name} {label}: kernel {ms:.4f} ms (median of 15), plain "
              f"{plain_ms:.4f} ms (median of 5), library {lib_ms:.4f} ms "
              f"(median of 15); device time (10 calls a CUDA graph, median "
              f"of 5 replays): kernel {dev_ms:.4f} ms, library "
              f"{lib_dev_ms:.4f} ms; {io_bytes} bytes, {ops} operations")
        return dev_ms

    shapes = []
    slot_bytes = x.numel() * 4  # every slot read, as without deg
    gathered = gathered_ms = 0
    for b, p in enumerate(h.ell.parts):
        rows, k = p.idx.shape
        edges = int(p.deg.sum())
        shapes.append(f"{rows}x{k}")
        dev_ms = record(
            "gather_reduce", f"bucket {b + 1} ({rows} x {k})",
            lambda: dg.gather_reduce(x, p.idx, p.val, p.deg),
            lambda: dg.gather_reduce_plain(x, p.idx, p.val, p.deg),
            lambda: F.embedding_bag(p.idx, x, per_sample_weights=p.val,
                                    mode="sum"),
            edges * 8 + rows * 4 + rows * d * 4, 2 * edges * d, exact=False)
        slot_bytes += rows * k * 8 + rows * d * 4
        gathered += edges * d * 4
        gathered_ms += dev_ms
        print(f"gather_reduce bucket {b + 1}: gathered rows of x {edges * d * 4}"
              f" bytes (edges x D x 4, mostly from the L2), at "
              f"{edges * d * 4 / dev_ms / 1e9:.3f} TB/s of the kernel's device "
              "time")
    for label, idx in (("inv_perm", h.ell.inv_perm), ("dense_cols", h.dense_cols)):
        r = idx.shape[0]
        record("gather_rows", f"{label} (R={r} of {n} x {d})",
               lambda: dg.gather_rows(x, idx),
               lambda: dg.gather_rows_plain(x, idx),
               lambda: torch.index_select(x, 0, idx),
               r * 4 + 2 * r * d * 4, 0, exact=True)
    print(f"gather_reduce per SpMM: gathered rows of x {gathered} bytes, at "
          f"{gathered / gathered_ms / 1e9:.3f} TB/s of the kernels' device "
          f"time; every-slot bound (8 bytes a slot, as without deg) "
          f"{slot_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    for name, rec in recs.items():
        t_bytes = rec.pop("io_bytes") / PEAK_BYTES_PER_S * 1e3
        t_ops = rec.pop("ops") / PEAK_F32_OPS_PER_S * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["shape"] = (f"per SpMM, x {n}x{d}: " + (
            f"buckets {', '.join(shapes)}" if name == "gather_reduce"
            else f"R={n} (inv_perm) and R={h.dense_cols.shape[0]} (dense_cols)"))
        print(f"{name}: {rec['ms']:.4f} ms per SpMM (plain {rec['plain_ms']:.4f}"
              f" ms, library {rec['library_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})); device time "
              f"{rec['device_ms']:.4f} ms, library's "
              f"{rec['library_device_ms']:.4f} ms")
    return recs


def lightgcn_serving_phase(torch, dg, graph, model, per_spmm, tmp):
    """Export -> artifact -> retriever; returns the export's launches."""
    import numpy as np

    from tagrec_tpu_torch import serving

    reset_counts(dg, GATHER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    forward_ms = (time.perf_counter() - t0) * 1e3
    launches = counts(dg, GATHER)
    n_layer = model.cfg.num_layer
    want = {k: n_layer * v for k, v in per_spmm.items()}
    print(f"LightGCN export_tables: forward {forward_ms:.3f} ms (first call, "
          f"host clock), launches {launches}")
    check(launches == want, f"expected {want} in a forward, got {launches}")
    check(u_t.shape == (graph.n_user, 64) and i_t.shape == (graph.n_item, 64),
          f"LightGCN table shapes {u_t.shape} {i_t.shape}")
    check(np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          "LightGCN exported tables are not finite")
    steady_forward(torch, model, "LightGCN")
    reset_counts(dg, GATHER)
    serve_requests(torch, graph, u_t, i_t, tmp, "lightgcn")
    return launches


def lightgcn_training_phase(torch, dg, pipe, trainer, per_spmm):
    """5 BPR steps with the launches of each step checked, the peak device
    memory, one BPR step profiled, then one step with ``node_drop`` (its
    launches: the forward's only).  Returns the launches summed over the
    steps."""
    (bpr,) = pipe.phases
    n_layer = pipe.model.cfg.num_layer
    per_step = {k: 2 * n_layer * v for k, v in per_spmm.items()}
    print(f"LightGCN launches per BPR step expected: {per_step} ({n_layer} "
          f"layers, forward and backward, {per_spmm['gather_reduce']} buckets)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dg, GATHER)
    total = training_steps(torch, trainer, bpr, LGCN_BPR_STEPS,
                           "LightGCN 10x BPR",
                           launch_checker(dg, GATHER, per_step, "BPR"))
    print(f"LightGCN 10x BPR: launches per step {per_step}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    state = bpr.epoch_reset(trainer.generator, bpr.data)
    batch = bpr.make_batch(trainer.generator, 0, state, bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch), "LightGCN BPR step",
                   {**GATHER_KERNEL_NAMES, "multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    # one step with edge dropout: the forward over the dropped adjacency's
    # gather kernels, its backward the scatter-add (no kernel); a Trainer
    # of its own, since a captured step keeps the config it was captured
    # with
    from tagrec_tpu_torch.training.train import Trainer

    cfg = pipe.model.cfg
    pipe.model.cfg = cfg.replace(node_drop=NODE_DROP)
    reset_counts(dg, GATHER)
    dropped = training_steps(
        torch, Trainer(pipe.model, pipe.phases, trainer.cfg,
                       generator=trainer.generator),
        bpr, 1, f"LightGCN 10x BPR, node_drop {NODE_DROP}",
        launch_checker(dg, GATHER, {k: n_layer * v for k, v in
                                    per_spmm.items()}, "node_drop BPR"))
    pipe.model.cfg = cfg
    return {k: total[k] + dropped[k] for k in GATHER}


def lightgcn_eval_phase(torch, dg, pipe):
    """One evaluation over every test user and one 4-group breakdown, timed
    and checked; returns the launches of their two forwards."""
    import math

    n_test = len(pipe.graph.user_items["test"])
    reset_counts(dg, GATHER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.evaluator.run(pipe.model)
    full_s = time.perf_counter() - t0
    print(f"LightGCN evaluation of {n_test} test users: {full_s:.3f} s (host "
          f"clock) {json.dumps(res)}")
    check(all(len(res[k]) == 2 for k in ("recall", "precision", "hr", "ndcg"))
          and all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"evaluation results {res}")
    t0 = time.perf_counter()
    groups = pipe.evaluator.run(pipe.model, group_k=4)
    group_s = time.perf_counter() - t0
    print(f"LightGCN 4-group evaluation: {group_s:.3f} s (host clock)")
    for key, r in groups.items():
        print(f"  {key}: {json.dumps(r)}")
    check(len(groups) >= 2 and sum(int(k.split("-")[-1]) for k in groups)
          == n_test, f"groups {list(groups)} do not cover {n_test} users")
    return counts(dg, GATHER)


def lightgcn_small_graph_check(torch):
    """LightGCN on a small graph's hybrid tier, hub columns forced
    (``hub_min_degree`` 12), cuda against cpu."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import ell

    cfg = model_preset("lightgcn", adj_mode="hybrid", reg=1e-4)

    def make(g, dev):
        model = model_class("lightgcn")(
            g, cfg, device=dev, generator=torch.Generator().manual_seed(3))
        model.adj = ell.to_device(ell.build_adj_pair(
            g.joint_norm_adj("bi_norm", True), symmetric=True, mode="hybrid",
            hub_min_degree=12), dev)
        check(model.adj.fwd.dense_cols is not None
              and len(model.adj.fwd.ell.parts) > 1, "no hub columns")
        return model

    small_graph_grad_check(torch, "LightGCN hybrid", make)


def lightgcn_hetrec_dense(torch, dg, graph):
    """bench.py's configuration: LightGCN at hetrec scale on the dense
    sector tier (torch.matmul, no kernel of the port), a few BPR steps,
    then one profiled."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    check(type(pipe.model.adj.fwd).__name__ == "DenseSectors",
          f"hetrec LightGCN tier {type(pipe.model.adj.fwd).__name__}")
    print(f"LightGCN hetrec: dense sectors {pipe.model.adj.fwd.coords}")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    reset_counts(dg, GATHER)
    training_steps(torch, trainer, pipe.phases[0], HETREC_BPR_STEPS,
                   "LightGCN hetrec dense-sector BPR")
    check(counts(dg, GATHER) == dict.fromkeys(GATHER, 0),
          "the dense sector tier launched a gather kernel")
    bpr = pipe.phases[0]
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch),
                   "LightGCN hetrec BPR step",
                   {"multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    del trainer
    capture_hold(torch, "LightGCN hetrec dense", pipe.model, pipe.phases,
                 tcfg)


def lightgcn_paths(torch, dg, hetrec_graph):
    """LightGCN at 10x on the hybrid tier (kernels, serving, training,
    evaluation), the small-graph check, NGCF on the same graph, then
    LightGCN on hetrec's dense tier.  Returns (kernel records, launches over
    the 10x paths, the 10x graph)."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.training.train import Trainer

    t0 = time.perf_counter()
    graph = synthetic_graph_large(*LGCN_10X, TAG_PER_INTER, seed=0)
    n_train = len(graph.edge_index["train"])
    print(f"10x graph {graph.num}, {n_train} train interactions, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    print(f"LightGCN 10x pipeline (adjacency, samplers, evaluator) built in "
          f"{time.perf_counter() - t0:.1f} s (host and transfer)")
    per_spmm = lightgcn_tier(torch, pipe.model)
    records = gather_kernel_phase(torch, dg, pipe.model)
    with tempfile.TemporaryDirectory() as tmp:
        served = lightgcn_serving_phase(torch, dg, graph, pipe.model, per_spmm,
                                        tmp)
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    trained = lightgcn_training_phase(torch, dg, pipe, trainer, per_spmm)
    evaluated = lightgcn_eval_phase(torch, dg, pipe)
    launches = {k: served[k] + trained[k] + evaluated[k] for k in GATHER}
    print(f"LightGCN 10x launches over the export, {LGCN_BPR_STEPS} BPR steps "
          f"and 2 evaluations: {launches}")
    del trainer
    capture_hold(torch, "LightGCN 10x hybrid", pipe.model, pipe.phases, tcfg)
    cfg = pipe.model.cfg
    pipe.model.cfg = cfg.replace(node_drop=NODE_DROP)
    capture_hold(torch, f"LightGCN 10x hybrid node_drop {NODE_DROP}",
                 pipe.model, pipe.phases, tcfg)
    pipe.model.cfg = cfg
    del pipe
    gc_cuda(torch)
    lightgcn_small_graph_check(torch)
    ngcf = ngcf_10x_phase(torch, dg, graph, records)
    launches = {k: launches[k] + ngcf[k] for k in GATHER}
    print(f"gather launches over LightGCN's and NGCF's 10x paths: {launches}")
    gc_cuda(torch)
    lightgcn_hetrec_dense(torch, dg, hetrec_graph)
    return records, launches, graph


# ------------------------------------------ NGCF, the chunked dense tier
# and DisenHAN

NGCF_WIDTHS = (64, 32)  # NGCF's SpMM widths: 64, 64 and 32 a forward
NODE_DROP = 0.1
DENSE_XLA_MODELS = (("dgcf", {}), ("disengcn", {}),
                    ("kgat", {"agg_type": "bi_inter"}))


def phase_timer(label):
    """Print the host seconds of the phase ``label`` when called again."""
    t0 = time.perf_counter()

    def done():
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s (host clock)")
    return done


def describe_hybrid(label, h):
    """Print one hybrid side's hub block and degree buckets (rows x width,
    edges, slots); returns the launches of one SpMM over it."""
    n = h.dense_block.shape[0]
    hub_edges = int((h.dense_block != 0).sum())
    print(f"{label} tier: hybrid; hub block {n} x {h.dense_block.shape[1]} "
          f"({h.dense_block.numel() * 4 / 1e9:.3f} GB float32), {hub_edges} "
          "edges")
    slots = edges = 0
    for b, p in enumerate(h.ell.parts):
        rows, k = p.idx.shape
        e = int(p.deg.sum())
        slots, edges = slots + rows * k, edges + e
        print(f"{label} bucket {b + 1}: {rows} x {k}, {e} edges, "
              f"{rows * k} slots ({100.0 * e / (rows * k):.1f}% filled)")
    print(f"{label} buckets: {len(h.ell.parts)}, {slots} slots, {edges} tail "
          f"edges; {hub_edges + edges} edges in all")
    return {"gather_reduce": len(h.ell.parts), "gather_rows": 2}


def ngcf_gather_phase(torch, dg, pair):
    """gather_reduce against its plain version on every bucket of NGCF's
    forward and transpose tables with the bucket's degrees, and gather_rows
    (bit for bit) on each side's inv_perm and dense_cols, at D = 64 and 32.
    The plain gather_reduce runs in float64 on buckets wider than WIDE_K
    (long float32 sums drift by themselves).  Per side and width, summed
    over one SpMM: ms (CUDA events, median of 15), device_ms
    (``device_ms``), plain_ms (median of 3), bound_ms (x once, the real
    edges' bytes; or the row gathers' bytes)."""
    h0 = pair.fwd
    n = h0.dense_block.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {name: {} for name in GATHER}
    for d in NGCF_WIDTHS:
        x = torch.randn((n, d), generator=gen, device="cuda")
        for side, h in (("forward", pair.fwd), ("transpose", pair.bwd)):
            recs = {name: {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0,
                           "plain_ms": 0.0, "bytes": 0, "ops": 0}
                    for name in GATHER}
            recs["gather_reduce"]["bytes"] = x.numel() * 4
            cases = []
            for b, p in enumerate(h.ell.parts):
                rows, k = p.idx.shape
                edges = int(p.deg.sum())
                wide = k > dg.WIDE_K
                cases.append((
                    "gather_reduce", f"bucket {b + 1} ({rows} x {k})",
                    lambda p=p: dg.gather_reduce(x, p.idx, p.val, p.deg),
                    lambda p=p: dg.gather_reduce_plain(x, p.idx, p.val, p.deg),
                    (lambda p=p: dg.gather_reduce_plain(
                        x.double(), p.idx, p.val.double(), p.deg)) if wide
                    else None,
                    edges * 8 + rows * 4 + rows * d * 4, 2 * edges * d))
            for label, idx in (("inv_perm", h.ell.inv_perm),
                               ("dense_cols", h.dense_cols)):
                r = idx.shape[0]
                cases.append(("gather_rows", f"{label} (R={r})",
                              lambda idx=idx: dg.gather_rows(x, idx),
                              lambda idx=idx: dg.gather_rows_plain(x, idx),
                              None, r * 4 + 2 * r * d * 4, 0))
            for name, label, kern, plain, plain64, nbytes, ops in cases:
                got = kern()
                want = (plain64 or plain)()
                if name == "gather_rows":
                    ok = bool(torch.equal(got, want))
                else:
                    ok = bool(torch.allclose(got.to(want.dtype), want,
                                             rtol=RTOL, atol=ATOL))
                err = float((got.double() - want.double()).abs().max())
                check(ok and bool(torch.isfinite(got).all()),
                      f"NGCF {name} D={d} {side} {label} disagrees with its "
                      f"plain version (max abs {err:.3e})")
                ms = time_ms(torch, kern, runs=15)
                dev = device_ms(torch, kern)
                plain_ms = time_ms(torch, plain, runs=3)
                rec = recs[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                for key, v in (("ms", ms), ("device_ms", dev),
                               ("plain_ms", plain_ms), ("bytes", nbytes),
                               ("ops", ops)):
                    rec[key] += v
                print(f"NGCF {name} D={d} {side} {label}: max_abs_err "
                      f"{err:.3e} ({'bit for bit' if name == 'gather_rows' else 'against float64' if plain64 else f'rtol {RTOL}, atol {ATOL}'}) ok; "
                      f"kernel {ms:.4f} ms, device {dev:.4f} ms, plain "
                      f"{plain_ms:.4f} ms")
            for name, rec in recs.items():
                t_bytes = rec.pop("bytes") / PEAK_BYTES_PER_S * 1e3
                t_ops = rec.pop("ops") / PEAK_F32_OPS_PER_S * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                out[name].setdefault(f"d{d}", {})[side] = rec
                print(f"NGCF {name} D={d} {side} table, per SpMM: "
                      f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms, "
                      f"plain {rec['plain_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return out


def edge_dropout_check(torch, dg, adj, per_spmm, label):
    """``edge_dropout`` at rate NODE_DROP on one adjacency (an AdjPair:
    its forward form): the dropped share of the stored edges, the
    survivors scaled by 1 / keep, then one forward and backward through
    the dropped adjacency (forward on the gather kernels, backward by the
    scatter-add), held by the adjoint identity <A x2, g> = <x2, A^T g>."""
    from tagrec_tpu_torch.ops import propagate

    gen = torch.Generator(device="cuda").manual_seed(11)
    t0 = time.perf_counter()
    dropped = propagate.edge_dropout(adj, NODE_DROP, gen, True)
    torch.cuda.synchronize()
    drop_ms = (time.perf_counter() - t0) * 1e3
    keep = 1.0 - NODE_DROP
    pairs = [(p.val[p.val != 0], q.val[p.val != 0])
             for p, q in zip(adj.fwd.ell.parts, dropped.ell.parts)]
    pairs.append((adj.fwd.dense_block[adj.fwd.dense_block != 0],
                  dropped.dense_block[adj.fwd.dense_block != 0]))
    edges = sum(a.numel() for a, _ in pairs)
    kept = sum(int((b != 0).sum()) for _, b in pairs)
    scaled = all(bool(torch.allclose(b[b != 0], a[b != 0] / keep, rtol=1e-6,
                                     atol=0)) for a, b in pairs)
    share = 1.0 - kept / edges
    sigma = (NODE_DROP * keep / edges) ** 0.5
    print(f"{label} edge dropout at {NODE_DROP}: {edges - kept} of {edges} "
          f"stored edges dropped (share {share:.6f}, 5 sigma "
          f"{5 * sigma:.6f}); survivors scaled by 1/keep: {scaled}; drawn in "
          f"{drop_ms:.3f} ms (host clock)")
    check(abs(share - NODE_DROP) < 5 * sigma and scaled,
          f"{label}: dropped share {share}, scaled {scaled}")
    n = adj.fwd.dense_block.shape[0]
    x = torch.randn((n, 64), generator=gen, device="cuda", requires_grad=True)
    x2 = torch.randn((n, 64), generator=gen, device="cuda")
    g = torch.randn((n, 64), generator=gen, device="cuda")
    reset_counts(dg, GATHER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    propagate.adj_mm(dropped, x).backward(g)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        y2 = propagate.adj_mm(dropped, x2)
    launches = counts(dg, GATHER)
    lhs = float((y2.double() * g.double()).sum())
    rhs = float((x.grad.double() * x2.double()).sum())
    scale = float((y2.double().abs() * g.double().abs()).sum())
    print(f"{label} dropped SpMM forward and backward: {step_ms:.3f} ms (host "
          f"clock); <A x2, g> {lhs:.6f}, <x2, A^T g> {rhs:.6f} (difference "
          f"{abs(lhs - rhs) / scale:.3e} of sum |A x2| |g|); launches "
          f"{launches} over two forwards (the backward is a scatter-add)")
    check(abs(lhs - rhs) <= 1e-5 * scale, f"{label}: the dropped adjacency's "
          "backward is not its transpose")
    check(launches == {k: 2 * v for k, v in per_spmm.items()},
          f"{label}: dropped SpMM launches {launches}")
    return launches


def ngcf_small_graph_check(torch):
    """NGCF on a small graph's hybrid tier, hub columns forced
    (``hub_min_degree`` 12) on both tables of D^-1 A, cuda against cpu."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import ell

    cfg = model_preset("ngcf", adj_mode="hybrid", reg=1e-4)

    def make(g, dev):
        model = model_class("ngcf")(
            g, cfg, device=dev, generator=torch.Generator().manual_seed(3))
        model.adj = ell.to_device(ell.build_adj_pair(
            g.joint_norm_adj("si_norm", True), symmetric=False, mode="hybrid",
            hub_min_degree=12), dev)
        check(model.adj.bwd is not model.adj.fwd
              and model.adj.bwd.dense_cols is not None
              and len(model.adj.bwd.ell.parts) > 1, "no hub columns")
        return model

    small_graph_grad_check(torch, "NGCF hybrid", make)


def ngcf_10x_phase(torch, dg, graph, records):
    """NGCF at the preset's full width on the 10x graph's hybrid tier: the
    tiers and buckets of D^-1 A and of its transpose, the gather kernels on
    both at D = 64 and 32, 5 BPR steps with the launches checked per step,
    the peak memory, one step profiled, edge dropout on the pair, one
    evaluation, the small-graph check.  Returns the launches."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("NGCF 10x")
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("ngcf"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    print(f"NGCF 10x pipeline (D^-1 A and its transpose, samplers, evaluator)"
          f" built in {time.perf_counter() - t0:.1f} s (host and transfer)")
    pair = pipe.model.adj
    check(pair.bwd is not pair.fwd and type(pair.fwd).__name__ == "Hybrid"
          and pair.fwd.dense_cols is not None
          and pair.bwd.dense_cols is not None,
          "NGCF 10x: expected an asymmetric hybrid pair with hub columns")
    per_fwd = describe_hybrid("NGCF forward (D^-1 A)", pair.fwd)
    per_bwd = describe_hybrid("NGCF transpose (A^T D^-1)", pair.bwd)
    ngcf = ngcf_gather_phase(torch, dg, pair)
    for name in GATHER:
        records[name]["ngcf"] = ngcf[name]

    n_layer = pipe.model.cfg.num_layer
    per_step = {k: n_layer * (per_fwd[k] + per_bwd[k]) for k in GATHER}
    per_forward = {k: n_layer * per_fwd[k] for k in GATHER}
    (bpr,) = pipe.phases
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    print(f"NGCF 10x launches per BPR step expected: {per_step} ({n_layer} "
          f"layers; forward buckets {per_fwd['gather_reduce']}, transpose "
          f"buckets {per_bwd['gather_reduce']})")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dg, GATHER)
    trained = training_steps(torch, trainer, bpr, LGCN_BPR_STEPS,
                             "NGCF 10x BPR",
                             launch_checker(dg, GATHER, per_step, "NGCF BPR"))
    print(f"NGCF 10x BPR: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch), "NGCF 10x BPR step",
                   {**GATHER_KERNEL_NAMES, "multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    dropped = edge_dropout_check(torch, dg, pair, per_fwd, "NGCF 10x")

    reset_counts(dg, GATHER)
    t0 = time.perf_counter()
    res = pipe.evaluator.run(pipe.model)
    evaluated = counts(dg, GATHER)
    print(f"NGCF 10x evaluation of {len(graph.user_items['test'])} test users: "
          f"{time.perf_counter() - t0:.3f} s (host clock), launches "
          f"{evaluated} {json.dumps(res)}")
    check(evaluated == per_forward and 0.0 < res["auc"][0] < 1.0,
          f"NGCF 10x evaluation: launches {evaluated}, results {res}")
    del pipe, trainer
    gc_cuda(torch)
    ngcf_small_graph_check(torch)
    done()
    return {k: trained[k] + dropped[k] + evaluated[k] for k in GATHER}


def bf16_product_check(torch, model):
    """Each bf16 sector block of ``model``'s forward adjacency times its
    slice of the ego rows, as the first layer runs it (``block_mm``),
    against the plain float32 product of the bf16-rounded operands at
    rtol/ATOL; a product rounded to bf16 fails both that and the check that
    the float32 result is not bf16 everywhere."""
    from tagrec_tpu_torch.ops.propagate import block_mm

    ds = model.adj.fwd
    xs = torch.split(torch.cat(list(model.embed)).detach(), list(ds.sizes))
    err, wide = 0.0, False
    with torch.no_grad():
        for b, (_, ci) in zip(ds.blocks, ds.coords):
            got = block_mm(b, xs[ci])
            want = b.float() @ xs[ci].to(torch.bfloat16).float()
            check(got.dtype == torch.float32
                  and torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"bf16 block {tuple(b.shape)} x {tuple(xs[ci].shape)} "
                  "differs from the float32 product of its rounded operands")
            err = max(err, float((got - want).abs().max()))
            wide = wide or not torch.equal(got, got.to(torch.bfloat16).float())
    print(f"NGCF hetrec bf16 block products ({len(ds.blocks)} blocks, "
          f"{[tuple(b.shape) for b in ds.blocks]}, x of {xs[0].shape[1]} "
          f"columns) against float32 products of the bf16-rounded operands: "
          f"max abs {err:.3e} (rtol {RTOL}, atol {ATOL}); results float32, "
          f"not rounded to bf16: {wide}")
    check(wide, "the bf16 block products are rounded to bf16")


def ngcf_hetrec_phase(torch, dg, graph, tmp):
    """NGCF at the preset's full width on the hetrec graph's dense sector
    tier (no kernel of the port), float32 and bf16 from the same weights:
    the forwards' difference; per dtype 5 BPR steps and one profiled;
    float32's export -> artifact -> 3 top-k requests and one evaluation."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("NGCF hetrec")
    tcfg = TrainConfig()
    pipes, fwd = {}, {}
    for dtype in ("f32", "bf16"):
        pipe = build_pipeline(graph, model_preset("ngcf", adj_dtype=dtype),
                              tcfg, generator=torch.Generator().manual_seed(0),
                              device="cuda")
        adj = pipe.model.adj
        want = torch.float32 if dtype == "f32" else torch.bfloat16
        check(type(adj.fwd).__name__ == "DenseSectors"
              and adj.bwd is not adj.fwd
              and all(b.dtype == want for b in adj.fwd.blocks + adj.bwd.blocks),
              f"NGCF hetrec {dtype}: expected {want} sector pairs")
        with torch.no_grad():
            fwd[dtype] = torch.cat(pipe.model.forward())
        pipes[dtype] = pipe
    bf16_product_check(torch, pipes["bf16"].model)
    err = float((fwd["f32"] - fwd["bf16"]).abs().max())
    print(f"NGCF hetrec: dense sectors {pipes['f32'].model.adj.fwd.coords} and "
          f"their transposes; bf16 forward against float32 from the same "
          f"weights: max abs difference {err:.3e} (limit {BF16_FWD_ATOL}; "
          f"tables of {fwd['f32'].shape[1]} columns, max |value| "
          f"{float(fwd['f32'].abs().max()):.3f})")
    check(fwd["f32"].shape[1] == 176 and math.isfinite(err)
          and err < BF16_FWD_ATOL,
          f"NGCF hetrec bf16 forward differs from float32 by {err}")
    busy = {}
    for dtype, pipe in pipes.items():
        (bpr,) = pipe.phases
        trainer = Trainer(pipe.model, pipe.phases, tcfg,
                          generator=torch.Generator(device="cuda").manual_seed(0))
        reset_counts(dg, GATHER)
        training_steps(torch, trainer, bpr, HETREC_BPR_STEPS,
                       f"NGCF hetrec {dtype} BPR")
        check(counts(dg, GATHER) == dict.fromkeys(GATHER, 0),
              "the dense sector tier launched a gather kernel")
        batch = bpr.make_batch(trainer.generator, 0,
                               bpr.epoch_reset(trainer.generator, bpr.data),
                               bpr.data)
        busy[dtype] = profile_device(
            torch, lambda: trainer.step(bpr, batch),
            f"NGCF hetrec {dtype} BPR step",
            {"multi_tensor_apply": "adam (foreach)", "gemm": "matmul (cuBLAS)",
             "nvjet": "matmul (cuBLAS)"})
    print(f"NGCF hetrec BPR step device busy (ms): {busy}")
    del pipes["bf16"]
    pipe = pipes["f32"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    print(f"NGCF export_tables: forward {(time.perf_counter() - t0) * 1e3:.3f}"
          " ms (first call after training, host clock)")
    check(u_t.shape == (graph.n_user, 176) and i_t.shape == (graph.n_item, 176)
          and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          f"NGCF tables {u_t.shape} {i_t.shape}, or not finite")
    steady_forward(torch, pipe.model, "NGCF hetrec")
    serve_requests(torch, graph, u_t, i_t, tmp, "ngcf")
    t0 = time.perf_counter()
    res = pipe.evaluator.run(pipe.model)
    print(f"NGCF hetrec evaluation of {len(graph.user_items['test'])} test "
          f"users: {time.perf_counter() - t0:.3f} s (host clock) "
          f"{json.dumps(res)}")
    check(all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"NGCF evaluation results {res}")
    del trainer
    capture_hold(torch, "NGCF hetrec", pipe.model, pipe.phases, tcfg)
    del pipes, pipe
    gc_cuda(torch)
    done()


def synced_ms(torch, fn):
    """(host-clock ms of one synchronised call of ``fn``, its result, the
    peak device memory in GiB over it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3, out,
            torch.cuda.max_memory_allocated() / 2**30)


def dense_xla_batch(torch, graph):
    """The 512 (user, item+, item-) triples of the holds' BPR loss."""
    import numpy as np

    rng = np.random.default_rng(5)
    return torch.as_tensor(np.stack([rng.integers(0, graph.n_user, 512),
                                     rng.integers(0, graph.n_item, 512),
                                     rng.integers(0, graph.n_item, 512)],
                                    axis=1), device="cuda")


# the adj_mode that builds each tier (``model.tier``) at hetrec
ADJ_MODE = {"kernels": "auto", "dense": "auto", "dense_xla": "dense_xla",
            "ell": "ell"}


def tier_run(torch, graph, name, cfg, tier, dtype, batch, fr, fa, dg):
    """Model ``name`` at the preset's full width on ``tier`` in ``dtype``,
    drawn from seed 0: two forwards, one BPR loss's backward and
    the backward of the forward tables against fixed random cotangents (the
    forward's vector-Jacobian product), their host times and peak memory
    printed.  -> {"fwd", "bpr", "vjp", "params"} in float64 and the
    launches (the routing, flash and ``gather_reduce`` kernels)."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class

    mods = ((fr, ROUTING), (fa, FLASH), (dg, ("gather_reduce",)))
    model = model_class(name)(
        graph, model_preset(name, adj_mode=ADJ_MODE[tier], **cfg),
        device="cuda", generator=torch.Generator().manual_seed(0)).to(dtype)
    check(model.tier == tier, f"{name}: tier {model.tier}, not {tier}")
    for mod, names in mods:
        reset_counts(mod, names)
    with torch.no_grad():
        first_ms, fwd, fwd_gib = synced_ms(torch, model.forward)
        fwd_ms, fwd, _ = synced_ms(torch, model.forward)
    bwd_ms, _, bwd_gib = synced_ms(
        torch, lambda: sum(model.bpr_loss(batch)).backward())

    def grads():
        out = {n: p.grad.double() for n, p in model.named_parameters()
               if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    bpr = grads()
    gen = torch.Generator().manual_seed(7)
    cots = [torch.randn(t.shape, generator=gen, dtype=torch.float64).to(
        t.device, dtype) for t in fwd]
    sum((t * c).sum() for t, c in zip(model.forward(), cots)).backward()
    got = {k: v for mod, names in mods for k, v in counts(mod, names).items()}
    print(f"{name} {tier} tier ({dtype}): "
          f"forward {first_ms:.3f} ms first, {fwd_ms:.3f} ms second, "
          f"peak device memory {fwd_gib:.3f} GiB; BPR loss and "
          f"backward {bwd_ms:.3f} ms, peak {bwd_gib:.3f} GiB (host "
          f"clock); launches over three forwards and two backwards {got}")
    out = {"fwd": [t.double() for t in fwd], "bpr": bpr, "vjp": grads(),
           "params": {n: p.detach().double()
                      for n, p in model.named_parameters()},
           "launches": got}
    del model
    gc_cuda(torch)
    return out


def grad_errors(got, want):
    """(max |got - want| / max|want|, ||got - want|| / ||want||): a
    gradient's error on its own scale (a BPR loss averaged over 512
    triples leaves most entries far below ATOL)."""
    err = got - want
    scale, norm = float(want.abs().max()), float(want.norm())
    return (float(err.abs().max()) / scale if scale else float(
        err.abs().max()), float(err.norm()) / norm if norm else float(
        err.norm()))


def grad_hold(torch, got, plain, want):
    """One float32 gradient against its float64 reference ``want``: every
    entry within BWD_RTOL |want| + RTOL max|want| and the whole within
    BWD_RTOL ||want||; or, where plain float32 PyTorch (``plain``) cannot
    resolve it either, both errors within GRAD_FLOOR times plain's.  ->
    (ok, the kernel tier's errors, plain's errors)."""
    mine, base = grad_errors(got, want), grad_errors(plain, want)
    own = (bool(torch.allclose(got, want, rtol=BWD_RTOL,
                               atol=RTOL * float(want.abs().max())))
           and mine[1] <= BWD_RTOL)
    floor = all(m <= GRAD_FLOOR * b for m, b in zip(mine, base))
    return own or floor, mine, base


def hold_tiers(torch, name, kern, plain, ref,
               what="kernel tier against dense_xla") -> bool:
    """The kernel tier's forward tables (rtol RTOL, atol ATOL), BPR
    gradients and forward VJP (``grad_hold``, each printed with its norm
    and plain float32's errors) against the float64 chunked tier's (or
    another float64 reference, ``what``), from the same weights -> whether
    all hold."""
    check(all(t["params"].keys() == ref["params"].keys() and all(
        torch.equal(t["params"][k], v) for k, v in ref["params"].items())
        for t in (kern, plain)), f"{name}: the tiers drew different weights")
    f_ok, f_err, f_rel = True, 0.0, 0.0
    for a, b in zip(kern["fwd"], ref["fwd"]):
        ok, err, rel = compare(torch, a, b, RTOL)
        f_ok, f_err, f_rel = f_ok and ok, max(f_err, err), max(f_rel, rel)
    print(f"{name} {what} in float64, hetrec, full "
          f"width: forward max abs {f_err:.3e}, max rel {f_rel:.3e} (rtol "
          f"{RTOL}, atol {ATOL}) {'ok' if f_ok else 'FAIL'}; gradients as "
          f"max err / max|g| and |err| / |g|, kernels then plain float32 "
          f"(entries within {BWD_RTOL} |g| + {RTOL} max|g| and norm within "
          f"{BWD_RTOL} |g|, or both within {GRAD_FLOOR}x plain float32's):")
    g_ok = True
    for part in ("bpr", "vjp"):
        check(kern[part].keys() == ref[part].keys() == plain[part].keys(),
              f"{name} {part}: gradients of {sorted(kern[part])} against "
              f"{sorted(ref[part])}")
        for key, want in ref[part].items():
            ok, mine, base = grad_hold(torch, kern[part][key],
                                       plain[part][key], want)
            g_ok = g_ok and ok
            print(f"  {name} {part} {key} |g| {float(want.norm()):.3e}: "
                  f"{mine[0]:.3e} {mine[1]:.3e}, plain {base[0]:.3e} "
                  f"{base[1]:.3e} {'ok' if ok else 'FAIL'}")
    return f_ok and g_ok


def dense_xla_phase(torch, graph, fr, fa, dg):
    """DGCF, DisenGCN and KGAT ``bi_inter`` at the preset's full width on
    the hetrec graph: the kernel tier and the EdgeMap tier (``adj_mode=
    "ell"``: ``gather_reduce`` under ``edge_reduce``), each in float32,
    against the chunked dense tier (``adj_mode="dense_xla"``) evaluated in
    float64 on the card from one set of weights, beside the chunked tier
    in float32, held by ``hold_tiers``.  Returns the two tiers'
    launches."""
    done = phase_timer("dense_xla against the kernels and the EdgeMap tier")
    batch = dense_xla_batch(torch, graph)
    total = {name: 0 for name in ROUTING + FLASH + ("gather_reduce",)}
    for name, cfg in DENSE_XLA_MODELS:
        ref, plain = (tier_run(torch, graph, name, cfg, "dense_xla", dtype,
                               batch, fr, fa, dg)
                      for dtype in (torch.float64, torch.float32))
        check(not any(ref["launches"].values())
              and not any(plain["launches"].values()),
              f"{name} dense_xla launched a kernel")
        for tier in ("kernels", "ell"):
            kern = tier_run(torch, graph, name, cfg, tier, torch.float32,
                            batch, fr, fa, dg)
            got = kern["launches"]
            check((got["gather_reduce"] > 0) == (tier == "ell")
                  and any(got.values()), f"{name} {tier}: launches {got}")
            total = {k: total[k] + got[k] for k in total}
            check(hold_tiers(torch, name, kern, plain, ref,
                             f"{tier} tier against dense_xla"),
                  f"{name}: the {tier} tier disagrees with the "
                  "chunked dense tier")
            del kern
            gc_cuda(torch)
        del ref, plain
        gc_cuda(torch)
    done()
    return total


def disenhan_phase(torch, graph, tmp):
    """DisenHAN at the preset's full width on the hetrec graph: the
    EdgeMap tier (``adj_mode="ell"``, float32) held against the dense tier
    in float64 (``hold_tiers``); then dense mode (six relation masks; no
    kernel of the port): 5 BPR steps through the resampling phase, the
    peak memory, one step profiled, export -> artifact -> 3 top-k
    requests, one evaluation; the small-graph check.  Returns the EdgeMap
    tier's ``gather_reduce`` launches."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import dma_gather as dg
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("DisenHAN hetrec")
    cfg = model_preset("disenhan", reg=1e-3)
    small_graph_grad_check(torch, "DisenHAN", lambda g, dev: model_class(
        "disenhan")(g, cfg, device=dev,
                    generator=torch.Generator().manual_seed(3)))
    batch = dense_xla_batch(torch, graph)
    ref, plain = (tier_run(torch, graph, "disenhan", {}, "dense", dtype,
                           batch, fr, fa, dg)
                  for dtype in (torch.float64, torch.float32))
    ell = tier_run(torch, graph, "disenhan", {}, "ell", torch.float32, batch,
                   fr, fa, dg)
    em_launches = ell["launches"]["gather_reduce"]
    check(em_launches > 0 and not any(plain["launches"].values()),
          f"DisenHAN launches: dense {plain['launches']}, EdgeMap "
          f"{ell['launches']}")
    check(hold_tiers(torch, "DisenHAN", ell, plain, ref,
                     "EdgeMap tier against the dense tier"),
          "DisenHAN: the EdgeMap tier disagrees with the dense tier")
    del ref, plain, ell
    gc_cuda(torch)
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("disenhan"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    masks = pipe.model.masks()
    mbytes = sum(m.numel() for m in masks)
    print(f"DisenHAN pipeline built in {time.perf_counter() - t0:.1f} s; six "
          f"relation masks {[tuple(m.shape) for m in masks]}, {mbytes} bytes")
    (bpr,) = pipe.phases
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    training_steps(torch, trainer, bpr, ROUTED_BPR_STEPS, "DisenHAN BPR")
    print(f"DisenHAN BPR: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0, None, bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch), "DisenHAN BPR step",
                   {"multi_tensor_apply": "adam (foreach)",
                    "gemm": "matmul (cuBLAS)"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    print(f"DisenHAN export_tables: forward "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
    check(u_t.shape == (graph.n_user, 64) and i_t.shape == (graph.n_item, 64)
          and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          f"DisenHAN tables {u_t.shape} {i_t.shape}, or not finite")
    steady_forward(torch, pipe.model, "DisenHAN")
    serve_requests(torch, graph, u_t, i_t, tmp, "disenhan")
    t0 = time.perf_counter()
    res = pipe.evaluator.run(pipe.model)
    print(f"DisenHAN evaluation of {len(graph.user_items['test'])} test users: "
          f"{time.perf_counter() - t0:.3f} s (host clock) {json.dumps(res)}")
    check(all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"DisenHAN evaluation results {res}")
    del trainer
    capture_hold(torch, "DisenHAN", pipe.model, pipe.phases, tcfg)
    del pipe
    gc_cuda(torch)
    done()
    return em_launches


# -------------------------------------- KGAT over a knowledge graph, TGCN

# KnowledgeGraph.synthetic at hetrec: 15,000 entities (the 10,000 items
# first), 500,000 KG triples under 6 relations -> 14 relations with the
# interaction relation and the reverses, 17,000 nodes
KG_SIZE = dict(n_entity=15_000, n_triples=500_000, n_rela=6)
KG_BPR_STEPS, KG_TRANSE_STEPS = 3, 3
TGCN_BPR_STEPS, TGCN_TRANSTAG_STEPS = 3, 3
MATMUL_NAMES = {"multi_tensor_apply": "adam (foreach)",
                "gemm": "matmul (cuBLAS)", "nvjet": "matmul (cuBLAS)"}
# the EdgeMap tier's device operations by kernel-name fragment: the
# gather_reduce kernel, the indexing gathers (edge_dot's [F, rows, K, D]
# takes, the slot and row gathers), softmaxes, sums, products
EDGEMAP_NAMES = {"gather::reduce": "gather_reduce",
                 "index_elementwise": "indexing gathers",
                 "vectorized_gather": "indexing gathers",
                 "indexSelect": "indexing gathers",
                 "softmax": "softmax", "reduce_kernel": "sums (reduce)",
                 **MATMUL_NAMES}


def kg_edge_forward(torch, p, n_user, rows, cols, rels, n_layer):
    """KGAT's forward over the KG from the parameters ``p`` (a dict of the
    model's names), computed per edge and independently of the model:
    score pi = proj[r, t] . tanh(proj[r, h] + e_r) gathered per edge, the
    softmax over each head's out-edges by ``scatter_reduce`` (amax) and
    ``index_add``, P @ x by ``index_add``; the bi-interaction layers.
    -> (user table, entity table)."""
    F = torch.nn.functional
    x = torch.cat([p["user"], p["entity"]])
    n = x.shape[0]
    proj = torch.einsum("nd,rde->rne", x, p["transE"])
    q = torch.tanh(proj + p["relation"][:, None, :])
    s = (q[rels, rows] * proj[rels, cols]).sum(1)
    mx = torch.full((n,), -torch.inf, dtype=s.dtype, device=s.device
                    ).scatter_reduce(0, rows, s.detach(), "amax")
    e = torch.exp(s - mx[rows])
    a = e / torch.zeros(n, dtype=s.dtype, device=s.device).index_add(
        0, rows, e)[rows]
    outs = [x]
    for k in range(n_layer):
        nei = torch.zeros_like(x).index_add(0, rows, a[:, None] * x[cols])
        x = (F.leaky_relu((nei + x) @ (p[f"mat.W1_{k}"] + p[f"mat.b1_{k}"]),
                          0.2)
             + F.leaky_relu((nei * x) @ (p[f"mat.W2_{k}"] + p[f"mat.b2_{k}"]),
                            0.2))
        outs.append(x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-12))
    out = torch.cat(outs, dim=1)
    return out[:n_user], out[n_user:]


def vjp_cotangents(torch, tables):
    gen = torch.Generator().manual_seed(7)
    return [torch.randn(t.shape, generator=gen, dtype=torch.float64).to(
        t.device, t.dtype) for t in tables]


def kg_runs(torch, graph, kg, model, batch):
    """The hold's three runs from ``model``'s weights: the model (float32,
    its tier: relation-dense, or EdgeMap) and the per-edge computation in
    float64 and float32, each the forward tables, one BPR loss's gradients
    and the forward's VJP against fixed random cotangents."""
    from tagrec_tpu_torch.models import base

    trips = torch.as_tensor(kg.all_triplet, device="cuda")
    rows, rels, cols = trips[:, 0], trips[:, 1], trips[:, 2]
    cfg = model.cfg

    def run(forward, params):
        def loss():
            u, e = forward()
            return sum(base.bpr_with_reg(u, e, u, e, batch,
                                         cfg.mul_loss_func, cfg.reg))

        def grads():
            out = {n: p.grad.double() for n, p in params.items()
                   if p.grad is not None}
            for p in params.values():
                p.grad = None
            return out

        with torch.no_grad():
            ms, fwd, gib = synced_ms(torch, forward)
        bwd_ms, _, bwd_gib = synced_ms(torch, lambda: loss().backward())
        bpr = grads()
        sum((t * c).sum() for t, c in zip(forward(), vjp_cotangents(
            torch, fwd))).backward()
        return {"fwd": [t.double() for t in fwd], "bpr": bpr, "vjp": grads(),
                "ms": (ms, bwd_ms), "gib": max(gib, bwd_gib)}

    named = dict(model.named_parameters())
    out = {"kern": run(model.forward, named)}
    for label, dtype in (("ref", torch.float64), ("plain", torch.float32)):
        params = {n: p.detach().to(dtype).requires_grad_()
                  for n, p in named.items()}
        out[label] = run(lambda: kg_edge_forward(
            torch, params, graph.n_user, rows, cols, rels, cfg.num_layer),
            params)
    params64 = {n: p.detach().double() for n, p in named.items()}
    for r in out.values():
        r["params"] = params64
    for label, r in out.items():
        print(f"KGAT KG {model.tier} {label}: forward {r['ms'][0]:.3f} ms, BPR loss and "
              f"backward {r['ms'][1]:.3f} ms (host clock), peak device "
              f"memory {r['gib']:.3f} GiB")
    return out


def kg_phase(torch, graph, tmp):
    """KGAT ``bi_inter`` over ``KnowledgeGraph.synthetic`` at hetrec
    (relation-dense tier, no kernel of the port): float32 held against the
    per-edge computation in float64 (``hold_tiers``); per dtype (float32,
    bf16 score planes) a few BPR and TransE steps on one Adam, one BPR step
    profiled, the peak memory; float32's evaluation, export -> artifact ->
    3 top-k requests; bf16's forward against float32's."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.data.kg import KnowledgeGraph
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("KGAT KG")
    small_graph_grad_check(torch, "KGAT KG", lambda g, dev: model_class(
        "kgat")(g, model_preset("kgat", agg_type="bi_inter", reg=1e-4),
                kg=KnowledgeGraph.synthetic(g, n_entity=120, n_triples=400,
                                            n_rela=3),
                device=dev, generator=torch.Generator().manual_seed(3)))
    t0 = time.perf_counter()
    kg = KnowledgeGraph.synthetic(graph, **KG_SIZE)
    print(f"KG: {kg.num_entity} entities, {kg.num_relation} relations, "
          f"{len(kg.all_triplet)} triples, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    tcfg = TrainConfig()
    fwd = {}
    for dtype in ("f32", "bf16"):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        pipe = build_pipeline(graph, model_preset(
            "kgat", agg_type="bi_inter", adj_dtype=dtype), tcfg, kg=kg,
            generator=torch.Generator().manual_seed(0), device="cuda")
        model = pipe.model
        n = model.n
        check(model.tier == "kg_rel_dense" and model.rel_id.shape == (n, n)
              and n == graph.n_user + kg.num_entity,
              f"KGAT KG {dtype}: not the relation-dense tier")
        print(f"KGAT KG {dtype} pipeline built in "
              f"{time.perf_counter() - t0:.1f} s: N = {n}, rel_id "
              f"{model.rel_id.numel()} bytes, row segments "
              f"{[(s, l, len(r)) for s, l, r in model._kg_row_segments]}")
        if dtype == "f32":
            runs = kg_runs(torch, graph, kg, model,
                           dense_xla_batch(torch, graph))
            check(hold_tiers(torch, "KGAT KG", runs["kern"], runs["plain"],
                             runs["ref"], "relation-dense tier against the "
                             "per-edge computation"),
                  "KGAT KG: the relation-dense tier disagrees with the "
                  "per-edge computation")
            del runs
            gc_cuda(torch)
        with torch.no_grad():
            fwd[dtype] = torch.cat(model.forward())
        bpr, transe = pipe.phases
        trainer = Trainer(model, pipe.phases, tcfg,
                          generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.reset_peak_memory_stats()
        training_steps(torch, trainer, bpr, KG_BPR_STEPS, f"KGAT KG {dtype} BPR")
        training_steps(torch, trainer, transe, KG_TRANSE_STEPS,
                       f"KGAT KG {dtype} TransE")
        print(f"KGAT KG {dtype} training: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        batch = bpr.make_batch(trainer.generator, 0,
                               bpr.epoch_reset(trainer.generator, bpr.data),
                               bpr.data)
        profile_device(torch, lambda: trainer.step(bpr, batch),
                       f"KGAT KG {dtype} BPR step", MATMUL_NAMES)
        if dtype == "f32":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
            print(f"KGAT KG export_tables: forward "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
            check(u_t.shape == (graph.n_user, 176)
                  and i_t.shape == (graph.n_item, 176)
                  and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
                  f"KGAT KG tables {u_t.shape} {i_t.shape}, or not finite")
            steady_forward(torch, model, "KGAT KG")
            serve_requests(torch, graph, u_t, i_t, tmp, "kgat_kg")
            t0 = time.perf_counter()
            res = pipe.evaluator.run(model)
            print(f"KGAT KG evaluation of {len(graph.user_items['test'])} test"
                  f" users: {time.perf_counter() - t0:.3f} s (host clock) "
                  f"{json.dumps(res)}")
            check(all(math.isfinite(v) for vs in res.values() for v in vs)
                  and 0.0 < res["auc"][0] < 1.0,
                  f"KGAT KG evaluation results {res}")
        del trainer
        if dtype == "f32":
            capture_hold(torch, "KGAT KG", model, pipe.phases, tcfg)
        del pipe, model
        gc_cuda(torch)
    err = float((fwd["f32"] - fwd["bf16"]).abs().max())
    print(f"KGAT KG bf16 score planes against float32, same weights: max abs "
          f"difference {err:.3e} (limit {BF16_FWD_ATOL})")
    check(math.isfinite(err) and err < BF16_FWD_ATOL,
          f"KGAT KG bf16 forward differs from float32 by {err}")
    del fwd
    gc_cuda(torch)
    done()


def tgcn_run(torch, graph, mode, dtype, batch):
    """TGCN at the preset's full width on ``mode``'s tier in ``dtype``, from
    seed 0: the forward tables, one BPR loss's gradients and the forward's
    VJP against fixed random cotangents."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class

    model = model_class("tgcn")(
        graph, model_preset("tgcn", adj_mode=mode), device="cuda",
        generator=torch.Generator().manual_seed(0)).to(dtype)
    want = {"auto": "dedup", "ell": "ell"}.get(mode, "takes")
    check(model.tier == want, f"TGCN {mode}: tier {model.tier}, not {want}")
    check(model.sampler == "native",
          f"TGCN {mode}: tables drawn by the {model.sampler} sampler, not "
          f"the native one JAX draws with by default")
    with torch.no_grad():
        first_ms, fwd, _ = synced_ms(torch, model.forward)
        fwd_ms, fwd, gib = synced_ms(torch, model.forward)
    bwd_ms, _, bwd_gib = synced_ms(
        torch, lambda: sum(model.bpr_loss(batch)).backward())

    def grads():
        out = {n: p.grad.double() for n, p in model.named_parameters()
               if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    bpr = grads()
    sum((t * c).sum() for t, c in zip(model.forward(), vjp_cotangents(
        torch, fwd))).backward()
    print(f"TGCN {mode} ({dtype}): forward {first_ms:.3f} ms first, "
          f"{fwd_ms:.3f} ms second, peak {gib:.3f} GiB; BPR loss and backward"
          f" {bwd_ms:.3f} ms, peak {bwd_gib:.3f} GiB (host clock)")
    out = {"fwd": [t.double() for t in fwd], "bpr": bpr, "vjp": grads(),
           "params": {n: p.detach().double()
                      for n, p in model.named_parameters()}}
    if mode == "auto":
        out["buckets"] = {name: [tuple(b[1].shape) for b in
                                 model.buckets(name)[0]]
                          for name in model.REL_ORDER}
    del model
    gc_cuda(torch)
    return out


def tgcn_gather_timing(torch, dg, model, records):
    """``gather_rows`` against ``index_select`` (forward only) on the
    layer-0 dedup bucket ids of the six tables, over tables of D = 64 and
    D = 32 (the weight table, D = 10, is no multiple of 4 floats): each
    launch held bit for bit against the plain version; times summed over
    the 6 x buckets launches of one layer's gathers.  The bound reads each
    table once (a table of D = 64 is 2.6 MB at most, and the rows repeat)
    and writes every gathered row."""
    nodes = {"u": model.num_list[0], "i": model.num_list[1],
             "t": model.num_list[2]}
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for d in (64, 32):
        xs = {k: torch.randn((n + 1, d), generator=gen, device="cuda")
              for k, n in nodes.items()}
        rec = dict.fromkeys(("ms", "library_ms", "device_ms",
                             "library_device_ms"), 0.0)
        rows = launches = io_bytes = 0
        for name in model.REL_ORDER:
            x = xs[name[2]]  # the neighbour type's table
            for _, ids, _, _ in model.buckets(name)[0]:
                idx = ids.reshape(-1).to(torch.int32).contiguous()
                check(torch.equal(dg.gather_rows(x, idx),
                                  dg.gather_rows_plain(x, idx)),
                      f"gather_rows at TGCN's {name} bucket {tuple(ids.shape)}"
                      f" D={d} differs from its plain version")
                rec["ms"] += time_ms(torch, lambda: dg.gather_rows(x, idx), 15)
                rec["library_ms"] += time_ms(
                    torch, lambda: torch.index_select(x, 0, idx), 15)
                rec["device_ms"] += device_ms(torch,
                                              lambda: dg.gather_rows(x, idx))
                rec["library_device_ms"] += device_ms(
                    torch, lambda: torch.index_select(x, 0, idx))
                rows += idx.numel()
                launches += 1
                # x read once, the ids, the rows written
                io_bytes += x.numel() * 4 + idx.numel() * (4 + d * 4)
        rec.update(rows=rows, launches=launches,
                   bound_ms=io_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        print(f"gather_rows at TGCN's layer-0 dedup ids, D={d}: {launches} "
              f"launches, {rows} rows; kernel {rec['ms']:.4f} ms, "
              f"index_select {rec['library_ms']:.4f} ms (CUDA events, medians"
              f" of 15, summed); device time {rec['device_ms']:.4f} ms, "
              f"index_select's {rec['library_device_ms']:.4f} ms; bound "
              f"{rec['bound_ms']:.4f} ms (bytes)")
        out[f"D{d}"] = rec
    records["gather_rows"]["tgcn"] = out


def tgcn_phase(torch, dg, graph, tmp, records):
    """TGCN at the preset's full width on the hetrec graph (no kernel of
    the port): the ``auto`` (dedup) tier in float32 held against
    ``dense_xla`` (plain takes) in float64 (``hold_tiers``), and ``auto``
    and the EdgeMap tier (``ell``) in float64 against ``dense_xla``
    within 1e-9 of scale, their float32 forwards at rtol 1e-4; a few BPR
    and TransTag steps on one Adam, one BPR step profiled, the peak
    memory, export -> artifact -> 3 top-k requests, one evaluation; the
    ``ell`` tier's BPR steps and one profiled beside ``auto``'s;
    ``gather_rows`` timed at TGCN's shapes; the small-graph check."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("TGCN hetrec")
    small_graph_grad_check(torch, "TGCN", lambda g, dev: model_class("tgcn")(
        g, model_preset("tgcn", reg=1e-4), device=dev,
        generator=torch.Generator().manual_seed(3)))
    batch = dense_xla_batch(torch, graph)
    runs = {(mode, dt): tgcn_run(torch, graph, mode, dtype, batch)
            for mode, dt, dtype in (("dense_xla", 64, torch.float64),
                                    ("dense_xla", 32, torch.float32),
                                    ("auto", 32, torch.float32),
                                    ("auto", 64, torch.float64),
                                    ("ell", 32, torch.float32),
                                    ("ell", 64, torch.float64))}
    from tagrec_tpu_torch import runtime

    print(f"TGCN neighbour tables drawn by the {runtime.sampler()} sampler "
          f"({runtime.LIB}), as JAX's default draws them")
    print(f"TGCN dedup buckets (rows x width) per table: "
          f"{runs['auto', 32]['buckets']}")
    ref, a64 = runs["dense_xla", 64], runs["auto", 64]
    check(hold_tiers(torch, "TGCN", a64, runs["dense_xla", 32], ref,
                     "auto (dedup) tier in float64 against dense_xla (plain "
                     "takes)"),
          "TGCN: the dedup tier disagrees with the plain takes")
    # the same sums grouped two ways: in float64 they agree to rounding, on
    # the scale of each table and of each loss's largest gradient (some
    # gradients are zero in exact arithmetic, atten2's q among them)
    for label, got, want in (("auto against dense_xla", a64, ref),
                             ("ell against auto", runs["ell", 64], a64)):
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got["fwd"], want["fwd"]))
        for part in ("bpr", "vjp"):
            check(got[part].keys() == want[part].keys(),
                  f"TGCN {label}: {part} gradients of other parameters")
            scale = max(float(g.abs().max()) for g in want[part].values())
            worst = max(worst, max(float((got[part][k] - g).abs().max())
                                   / scale for k, g in want[part].items()))
        print(f"TGCN {label}, both float64: largest error on the scale of "
              f"its table or its loss's gradients {worst:.3e} (limit 1e-9)")
        check(worst < 1e-9, f"TGCN float64 tiers ({label}) differ by "
                            f"{worst}")
    # float32, as users run it: the forward held; the attention gradients
    # of layers 1 and 2 (norms down to 1e-23 at these weights) lie below
    # float32's resolution in either grouping, so their errors are printed
    for mode in ("auto", "dense_xla", "ell"):
        run32 = runs[mode, 32]
        f_ok = all(compare(torch, a, b, RTOL)[0]
                   for a, b in zip(run32["fwd"], ref["fwd"]))
        errs = {part: max(grad_errors(run32[part][k], g)[1]
                          for k, g in ref[part].items())
                for part in ("bpr", "vjp")}
        print(f"TGCN {mode} float32 against dense_xla float64: forward "
              f"(rtol {RTOL}, atol {ATOL}) {'ok' if f_ok else 'FAIL'}; "
              f"largest |err| / |g| of a gradient: BPR {errs['bpr']:.3e}, "
              f"VJP {errs['vjp']:.3e} (float32's resolution, printed)")
        check(f_ok, f"TGCN {mode} float32 forward disagrees with float64")
    del runs, ref, a64
    gc_cuda(torch)

    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    print(f"TGCN pipeline (tables, buckets, samplers) built in "
          f"{time.perf_counter() - t0:.1f} s")
    bpr, transtag = pipe.phases
    check(pipe.model.dedup and transtag.name == "transtag",
          f"TGCN pipeline: {[ph.name for ph in pipe.phases]}")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    training_steps(torch, trainer, bpr, TGCN_BPR_STEPS, "TGCN BPR")
    training_steps(torch, trainer, transtag, TGCN_TRANSTAG_STEPS,
                   "TGCN TransTag")
    print(f"TGCN training: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    auto_busy = profile_device(torch, lambda: trainer.step(bpr, batch),
                               "TGCN BPR step", MATMUL_NAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    print(f"TGCN export_tables: forward {(time.perf_counter() - t0) * 1e3:.3f}"
          " ms (host clock)")
    check(u_t.shape == (graph.n_user, 176) and i_t.shape == (graph.n_item, 176)
          and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          f"TGCN tables {u_t.shape} {i_t.shape}, or not finite")
    steady_forward(torch, pipe.model, "TGCN")
    serve_requests(torch, graph, u_t, i_t, tmp, "tgcn")
    t0 = time.perf_counter()
    res = pipe.evaluator.run(pipe.model)
    print(f"TGCN evaluation of {len(graph.user_items['test'])} test users: "
          f"{time.perf_counter() - t0:.3f} s (host clock) {json.dumps(res)}")
    check(all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"TGCN evaluation results {res}")
    tgcn_gather_timing(torch, dg, pipe.model, records)
    del trainer
    capture_hold(torch, "TGCN auto", pipe.model, pipe.phases, tcfg)
    del pipe
    gc_cuda(torch)
    tgcn_ell_steps(torch, graph, auto_busy)
    done()


def tgcn_ell_steps(torch, graph, auto_busy):
    """TGCN's EdgeMap tier (``adj_mode="ell"``) through the pipeline at
    hetrec: 3 BPR steps, the peak memory and one step profiled, beside the
    ``auto`` step's device time (``auto_busy``).  Its table reads are
    ``edge_vgather``/``rows_gather``, whose backwards are gathers over the
    transpose tables, where ``auto``'s is torch's scatter-add of ``x[ids]``."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", adj_mode="ell"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    check(pipe.model.ell, "TGCN ell pipeline: not the EdgeMap tier")
    print(f"TGCN ell pipeline (tables and 12 EdgeMaps) built in "
          f"{time.perf_counter() - t0:.1f} s")
    bpr = pipe.phases[0]
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    training_steps(torch, trainer, bpr, TGCN_BPR_STEPS, "TGCN ell BPR")
    print(f"TGCN ell training: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    busy = profile_device(torch, lambda: trainer.step(bpr, batch),
                          "TGCN ell BPR step", EDGEMAP_NAMES)
    if busy and auto_busy:
        print(f"TGCN BPR step device busy: ell {busy:.3f} ms, auto "
              f"{auto_busy:.3f} ms ({auto_busy / busy:.2f}x); the default "
              "stays auto, as in JAX")
    del trainer
    capture_hold(torch, "TGCN ell", pipe.model, pipe.phases, tcfg)
    del pipe
    gc_cuda(torch)


def tgcn_cli_run(torch, card):
    """``python -m tagrec_tpu_torch.cli --model tgcn --dataset synthetic``
    for one epoch on the card, in its own process, with an export."""
    import glob

    done = phase_timer("CLI TGCN")
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "tagrec_tpu_torch.cli", "--model",
                "tgcn", "--dataset", "synthetic", "--epochs", "1",
                "--out_dir", os.path.join(tmp, "run"), "--export",
                os.path.join(tmp, "art")]
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=600, cwd=os.path.dirname(
                                  os.path.abspath(__file__)))
        for line in proc.stdout.splitlines():
            print(f"  TGCN CLI | {line[:160]}")
        check(proc.returncode == 0,
              f"the TGCN CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        (results,) = glob.glob(os.path.join(tmp, "run", "**",
                                            "results.json"), recursive=True)
        res = check_cli_results(os.path.dirname(results), "TGCN")
        check("[Epoch:0][transtag]" in proc.stdout
              and "serving artifact:" in proc.stdout and "'dim': 176"
              in proc.stdout, "the TGCN CLI run: no TransTag phase or export")
        cli_seconds(proc.stdout, os.path.dirname(results), "TGCN", card)
        print(f"TGCN CLI test result: {res['test']}")
    done()


# ----------------------------------------------------------------- the CLI

CLI_DGCF = ("--model", "dgcf", "--dataset", "synthetic_large",
            "--test_interval", "1", "--patient_epoch", "1", "--group_k", "4")
CLI_SEED = 2020  # the CLI's default --seed
# the routing kernels' launches a DGCF BPR step and a forward
# (num_layer 3 x iterate_k 2 sweeps of each; 3 backward sweeps a step)
DGCF_STEP = {"routed_rowsum": 6, "routed_mm": 6, "routed_mm_bwd": 3}
DGCF_FORWARD = {"routed_rowsum": 6, "routed_mm": 6, "routed_mm_bwd": 0}
ANSI = ("\033[0;33;40m", "\033[0m")


def cli_run(torch, fr, argv, label):
    """``cli.main(argv)`` in process on the card, its output captured and
    echoed line by line (cut to 160 characters), the routing launches
    counted around it.  -> (output, launches, the run's directory)."""
    import contextlib
    import glob
    import io

    from tagrec_tpu_torch import cli

    out = io.StringIO()
    reset_counts(fr, ROUTING)
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    launches = counts(fr, ROUTING)
    text = out.getvalue()
    for a in ANSI:
        text = text.replace(a, "")
    for line in text.splitlines():
        print(f"  {label} | {line[:160]}")
    out_dir = argv[list(argv).index("--out_dir") + 1]
    (results,) = glob.glob(os.path.join(out_dir, "**", "results.json"),
                           recursive=True)
    gc_cuda(torch)
    return text, launches, os.path.dirname(results)


def gc_cuda(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def cli_seconds(text, run_dir, label, card):
    """The run's host-clock seconds a stage, from its output and its
    metrics stream, printed beside the card."""
    stages = json.loads(text.split("stage seconds (host clock): ")[1]
                        .splitlines()[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r["train/epoch_time_0"] for r in recs
              if "train/epoch_time_0" in r]
    evals = [float(line.split("[eval ")[1].split("s]")[0])
             for line in text.splitlines() if "][eval " in line]
    print(f"CLI {label} seconds (host clock, synchronised; {card}): "
          f"pipeline build {stages['build']:.3f}, epoch "
          f"{', '.join(f'{e:.3f}' for e in epochs)}, evaluation "
          f"{', '.join(f'{e:.2f}' for e in evals)}, final test "
          f"{stages['test']:.3f}, group pass {stages['group']:.3f}, export "
          f"{stages.get('export', 0.0):.3f}; train (epochs and evaluations) "
          f"{stages['train']:.3f}")
    return epochs


def check_cli_launches(got, steps, forwards, label):
    want = {k: steps * DGCF_STEP[k] + forwards * DGCF_FORWARD[k]
            for k in ROUTING}
    print(f"CLI {label}: routing launches {got} = {steps} steps x "
          f"{DGCF_STEP} + {forwards} forwards x {DGCF_FORWARD}")
    check(got == want, f"CLI {label}: launches {got}, expected {want}")


def check_cli_results(run_dir, label):
    import math

    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    check(sorted(res) == ["best_epoch", "group", "test"]
          and len(res["group"]) == 4
          and all(k.startswith("inter<") for k in res["group"]),
          f"CLI {label}: results.json {sorted(res)} {list(res['group'])}")
    blocks = [res["test"], *res["group"].values()]
    check(all(math.isfinite(v) for b in blocks for vs in b.values()
              for v in vs) and 0.0 < res["test"]["auc"][0] < 1.0,
          f"CLI {label}: results {res}")
    return res


def cli_phase(torch, fr, card):
    """The training CLI on the card, as a user runs it: DGCF at the preset's
    full width on ``synthetic_large`` (the hetrec graph from the CLI's seed)
    for one epoch with a train state and an export (run A), the artifact
    queried through ``serving.main``; resumed from that state to
    ``--epochs 2`` (run B: epoch 1 only, on the restored Adam state);
    DGCF on the small graph with ``--profile`` (run C); NGCF on
    ``synthetic_large`` for one epoch with an export (run D).
    Each DGCF run's routing launches are checked against its steps and
    forwards.  Returns the launches summed over the runs."""
    import contextlib
    import glob
    import io

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.data.synthetic import (synthetic_graph,
                                                 synthetic_graph_large)

    def steps_of(graph):  # the resampling phase's steps an epoch
        return len(graph.edge_index["train"]) // 512 + 1

    steps = steps_of(synthetic_graph_large(N_USER, N_ITEM, N_TAG, N_EDGES,
                                           TAG_PER_INTER, seed=CLI_SEED))
    total = dict.fromkeys(ROUTING, 0)
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.npz")
        art = os.path.join(tmp, "dgcf")
        common = CLI_DGCF + ("--resume", state, "--export", art)
        # run A: epoch 0, its evaluation, the final test, the group pass
        # and the export: 4 forwards
        text, got, run_dir = cli_run(
            torch, fr, common + ("--epochs", "1", "--out_dir",
                                 os.path.join(tmp, "a")), "A")
        check_cli_launches(got, steps, 4, "run A")
        check("resumed" not in text, "CLI run A resumed from nothing")
        res = check_cli_results(run_dir, "run A")
        check(res["best_epoch"] == 0, f"CLI run A best epoch {res}")
        cli_seconds(text, run_dir, "run A", card)
        total = {k: total[k] + got[k] for k in ROUTING}

        users = [0, 1, 2, N_USER - 1]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serving.main(["--artifact", art, "--users",
                          *map(str, users), "--k", str(TOP_K)])
        rows = [json.loads(line) for line in out.getvalue().splitlines()]
        check([r["user"] for r in rows] == users
              and all(len(r["items"]) == TOP_K and all(
                  0.0 <= v <= 1.0 for v in r["scores"]) for r in rows),
              f"serving.main on the CLI's artifact: {rows}")
        print(f"serving.main on run A's artifact: {len(rows)} users, "
              f"user 0's top 3 {rows[0]['items'][:3]}")

        # run B: resumes at epoch 1 and trains that epoch only
        text, got, run_dir = cli_run(
            torch, fr, common + ("--epochs", "2", "--out_dir",
                                 os.path.join(tmp, "b")), "B")
        check(f"resumed from {state} at epoch 1" in text,
              "CLI run B did not resume at epoch 1")
        check([line.split("]")[0] for line in text.splitlines()
               if line.startswith("[Epoch")] == ["[Epoch:1", "[Epoch 1"],
              "CLI run B ran another epoch than epoch 1")
        check_cli_launches(got, steps, 4, "run B")
        check(check_cli_results(run_dir, "run B")["best_epoch"] == 1,
              "CLI run B: best epoch not 1")
        cli_seconds(text, run_dir, "run B", card)
        total = {k: total[k] + got[k] for k in ROUTING}

        # run C: the small graph, profiled; epoch 0 is evaluated
        trace = os.path.join(tmp, "trace")
        text, got, run_dir = cli_run(
            torch, fr, ("--model", "dgcf", "--dataset", "synthetic",
                        "--epochs", "1", "--profile", trace,
                        "--out_dir", os.path.join(tmp, "c")), "C")
        small_steps = steps_of(synthetic_graph(seed=CLI_SEED))
        check_cli_launches(got, small_steps, 3, "run C")
        check_cli_results(run_dir, "run C")
        files = glob.glob(os.path.join(trace, "*.pt.trace.json"))
        check(len(files) == 1, f"CLI run C: trace files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        # the trace spans the training: the steps and epoch 0's evaluation
        n_kern = sum(e.get("cat") == "kernel" and any(
            k in e.get("name", "") for k in ROUTING_KERNEL_NAMES)
            for e in events)
        want = (small_steps * sum(DGCF_STEP.values())
                + sum(DGCF_FORWARD.values()))
        print(f"CLI run C: trace {os.path.basename(files[0])}, "
              f"{os.path.getsize(files[0])} bytes, {len(events)} events, "
              f"{n_kern} routing kernels on the card (expected {want})")
        check(n_kern == want, f"CLI run C: {n_kern} routing kernels in the "
                              f"trace, expected {want}")
        total = {k: total[k] + got[k] for k in ROUTING}

        # run D: NGCF on synthetic_large, one epoch on the dense sector
        # tier (no kernel of the port), its export
        text, got, run_dir = cli_run(
            torch, fr, ("--model", "ngcf") + CLI_DGCF[2:] + (
                "--epochs", "1", "--export", os.path.join(tmp, "ngcf"),
                "--out_dir", os.path.join(tmp, "d")), "D")
        check(not any(got.values()), f"CLI run D: routing launches {got}")
        check_cli_results(run_dir, "run D")
        cli_seconds(text, run_dir, "run D", card)
        check("serving artifact:" in text and "'dim': 176" in text,
              "CLI run D: no NGCF artifact of 176 columns")
    return total


# ------------------------------------------------------ the mesh phase (P)

MESH_WALL_STEPS = 40   # captured steps a timed run, with and without the mesh
MESH_RANK_TIMEOUT_S = 240
# the two-rank data-parallel run against the one-device eager run: each
# rank steps on half the batch, so the means and the gradients' sums run
# in another order (tests/test_torch_parallel_dist.py holds the same)
# parameters: a hundredth of the most Adam moves one in those steps (lr a
# step), since it divides each gradient by its running scale
MESH_LOSS_ATOL = 1e-6
MESH_PARAM_ATOL = 0.01 * 0.01 * HETREC_BPR_STEPS  # TrainConfig's lr 0.01
# the two-rank meshes on one card: NCCL refuses two ranks on one device
# (ncclInvalidUsage), so they run on gloo over CUDA tensors, eagerly
TWO_RANK = {"data2": (2, 1), "model2": (1, 2)}


def mesh_graph():
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large

    return synthetic_graph_large(N_USER, N_ITEM, N_TAG, N_EDGES,
                                 TAG_PER_INTER, seed=0)


def mesh_run(torch, graph, mesh, capture, on_launches=None,
             family=("dgcf", {"cor_reg": 0.1}), kg=None):
    """``family`` (name, preset overrides; DGCF with cor_reg 0.1) at the
    preset's width on ``graph`` (KGAT over ``kg`` when given) through
    ``build_pipeline(mesh=)`` and
    ``Trainer(mesh=)``: HETREC_BPR_STEPS steps, each synchronised and
    timed, ``on_launches(steps, run)`` after them -> {"pipe", "trainer",
    "losses", "params" (gathered, by JAX name, on the host), "ms"}."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(family[0], **family[1]), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda", mesh=mesh, kg=kg)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, mesh=mesh,
                      capture=capture,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [0.0]

    def on_step(i, parts):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append((now - last[0]) * 1e3)
        last[0] = time.perf_counter()

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    losses = trainer.run_phase(pipe.phases[0], max_steps=HETREC_BPR_STEPS,
                               on_step=on_step)
    if on_launches is not None:
        on_launches(HETREC_BPR_STEPS, trainer.runs[pipe.phases[0].name])
    with torch.no_grad(), sharding.gathered():
        params = {n: sharding.value(pipe.model, n).detach().cpu()
                  for n in checkpoint.jax_leaf_order(pipe.model)}
    return {"pipe": pipe, "trainer": trainer, "losses": losses,
            "params": params, "ms": times}


def mesh_answers(torch, run, mesh):
    """One evaluation of every test user and N_REQUESTS top-k requests of
    REQUEST_USERS users (export -> Retriever), on ``mesh`` or none."""
    import numpy as np

    from tagrec_tpu_torch import serving

    pipe, graph = run["pipe"], run["pipe"].graph
    results = pipe.evaluator.run(pipe.model)
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    pad, _ = serving.metrics.pad_lists(graph.user_items["train"],
                                       graph.n_user, serving.PAD_ID)
    r = serving.Retriever(u_t, i_t, train_pad=pad, mesh=mesh, device="cuda")
    rng = np.random.default_rng(0)
    ids, scores = zip(*(r.topk(rng.choice(graph.n_user, REQUEST_USERS,
                                          replace=False), TOP_K)
                        for _ in range(N_REQUESTS)))
    return results, np.stack(ids), np.stack(scores)


def held_equal(torch, a, b):
    """Names of the tensors of {name: tensor} ``a`` that differ from
    ``b``'s."""
    return [n for n in a if not torch.equal(a[n], b[n])]


def check_metrics(got, want, exact, label):
    """The evaluation's ranking metrics equal (``exact``) or within JAX's
    mesh tolerances (rtol 2e-3, atol 1e-5), AUC within rtol 5e-3."""
    import numpy as np

    for m in ("recall", "precision", "hr", "ndcg"):
        ok = (got[m] == want[m] if exact else
              np.allclose(got[m], want[m], rtol=2e-3, atol=1e-5))
        check(ok, f"{label}: {m} {got[m]} against {want[m]}")
    check(np.allclose(got["auc"], want["auc"], rtol=5e-3),
          f"{label}: auc {got['auc']} against {want['auc']}")


def replay_ops(torch, graph_, reps=PROFILED_REPLAYS):
    """{device operation's name: (count, ms)} a replay of ``graph_``, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph_.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if on_device(e):
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / reps, us / reps / 1e3) for k, (n, us) in out.items()}


def mesh_ops(mesh_ops_, plain_ops):
    """The operations a replay with the mesh runs beyond one without it:
    ({name: (count, ms)}, their ms, the mesh replay's busy ms)."""
    extra = {}
    for k, (n, ms) in mesh_ops_.items():
        n0, ms0 = plain_ops.get(k, (0, 0.0))
        if n > n0:
            extra[k] = (n - n0, ms - ms0)
    busy = sum(ms for _, ms in mesh_ops_.values())
    return extra, sum(ms for _, ms in extra.values()), busy


def one_rank_mesh(torch, fr, graph, card):
    """P1: a one-rank NCCL mesh in this process.  DGCF captured with and
    without it, bit for bit (every collective a copy, every scale 1), the
    routing launches checked each step; its evaluation, retrieval and a
    sharded checkpoint round trip; step time with and without the mesh and
    the collectives' share of a replay.  -> the mesh run's launches."""
    import torch.distributed as dist

    from tagrec_tpu_torch.parallel.mesh import make_mesh
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import COUNTED

    want = {"routed_rowsum": 6, "routed_mm": 6, "routed_mm_bwd": 3}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        plain = mesh_run(torch, graph, None, capture=True)
        reset_counts(fr, ROUTING)
        total = {k: 0 for k in ROUTING}
        checker = launch_checker(fr, ROUTING, want, "P1 mesh step")

        def on_launches(steps, run):
            for k, v in checker(steps, run).items():
                total[k] += v

        meshed = mesh_run(torch, graph, mesh, capture=True,
                          on_launches=on_launches)
        run = meshed["trainer"].runs["bpr"]
        check(run.graph is not None, "P1: the mesh step was not captured")
        print(f"P1 one-rank NCCL mesh {mesh}: placement "
              f"{meshed['trainer'].placement['params']}; the step captured "
              f"with its collectives; launches a replay "
              f"{dict(zip([f.__name__ for f in COUNTED], run.launches))}")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        print(f"P1 DGCF hetrec captured, {HETREC_BPR_STEPS} steps: losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "P1: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")

        results, ids, scores = mesh_answers(torch, meshed, mesh)
        want_res, want_ids, want_scores = mesh_answers(torch, plain, None)
        check_metrics(results, want_res, True, "P1 evaluation")
        check((ids == want_ids).all() and (scores == want_scores).all(),
              "P1: the mesh retriever's answers differ")
        print(f"P1 Evaluator(mesh=): {results} (unmeshed {want_res}); "
              f"Retriever(mesh=): {N_REQUESTS} requests of {REQUEST_USERS} "
              f"users, ids and scores equal")

        with tempfile.TemporaryDirectory() as tmp:
            step_dir = checkpoint.save_sharded(tmp, meshed["pipe"].model,
                                               meshed["trainer"].opt, 1)
            back = mesh_run(torch, graph, mesh, capture=True)
            step = checkpoint.load_sharded(step_dir, back["pipe"].model,
                                           back["trainer"].opt)
        pa = checkpoint.named_params(meshed["pipe"].model)
        pb = checkpoint.named_params(back["pipe"].model)
        bad = held_equal(torch, pb, pa)
        for n in pa:
            sa = meshed["trainer"].opt.state[pa[n]]
            sb = back["trainer"].opt.state[pb[n]]
            bad += [f"{n}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
        print(f"P1 save_sharded -> load_sharded: step {step}, "
              f"{len(pa)} tables and their Adam state "
              f"{'equal' if not bad else 'DIFFER: ' + str(bad)}")
        check(step == 1 and not bad, "P1: the sharded checkpoint round trip "
                                     "did not restore every tensor")
        del back

        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            MESH_WALL_STEPS)
                              / MESH_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"P1 captured DGCF hetrec step ({card}): ms a step over "
              f"{MESH_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations (its all-gathers, gradient and loss all-reduce "
              f"and their copies) {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time), NCCL kernels among them "
              f"{sum(n for k, (n, _) in extra.items() if 'nccl' in k.lower()):.0f}; "
              f"largest {[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        return total
    finally:
        dist.destroy_process_group()


def mesh_rank_main(argv):
    """One rank of a two-rank mesh on this card (``chip_smoke.py
    mesh-rank DP MP OUT`` under RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT): gloo over CUDA tensors, eager; its DGCF run, evaluation
    and requests pickled to OUT/rank{r}.pkl."""
    import pickle
    from datetime import timedelta

    import torch

    from tagrec_tpu_torch.parallel import launch

    dp, mp, out = int(argv[0]), int(argv[1]), argv[2]
    launch.initialize("gloo", device="cuda",
                      timeout=timedelta(seconds=MESH_RANK_TIMEOUT_S // 2))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = launch.global_mesh(dp, mp)
        t0 = time.perf_counter()
        run = mesh_run(torch, mesh_graph(), mesh, capture=False)
        results, ids, scores = mesh_answers(torch, run, mesh)
        with open(os.path.join(out, f"rank{launch.rank()}.pkl"), "wb") as f:
            pickle.dump({"losses": run["losses"],
                         "params": {k: v.numpy() for k, v in
                                    run["params"].items()},
                         "ms": run["ms"], "results": results, "ids": ids,
                         "scores": scores, "placement":
                         run["trainer"].placement["params"],
                         "seconds": time.perf_counter() - t0}, f)
    finally:
        launch.shutdown()
    return 0


def start_mesh_ranks(dp, mp, out):
    """The ranks of a dp x mp mesh on this card, each ``chip_smoke.py
    mesh-rank`` in its own process."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(out, exist_ok=True)
    procs = []
    for rank in range(dp * mp):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(dp * mp),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(os.path.join(out, f"rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "mesh-rank", str(dp),
             str(mp), out], env=env, stdout=log, stderr=subprocess.STDOUT),
            log))
    return procs


def wait_mesh_ranks(procs):
    """Wait for every rank up to MESH_RANK_TIMEOUT_S; on a failure or the
    deadline kill them all and fail with their output."""
    end = time.monotonic() + MESH_RANK_TIMEOUT_S
    while any(p.poll() is None for p, _ in procs):
        if (any(p.poll() not in (None, 0) for p, _ in procs)
                or time.monotonic() > end):
            break
        time.sleep(0.1)
    failed = any(p.poll() != 0 for p, _ in procs)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if failed:
            print(text[-3000:])
    check(not failed, "P2: a rank of a two-rank mesh failed or timed out")


def two_rank_meshes(torch, graph, card):
    """P2: data = 2 and model = 2 on this one card (4 processes, gloo over
    CUDA tensors, eager), against the one-device eager run: model alone
    bit for bit, data within MESH_LOSS_ATOL / MESH_PARAM_ATOL; the
    evaluations and the requests too."""
    import pickle

    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        outs = {k: os.path.join(tmp, k) for k in TWO_RANK}
        procs = {k: start_mesh_ranks(*TWO_RANK[k], outs[k])
                 for k in TWO_RANK}
        eager = mesh_run(torch, graph, None, capture=False)
        want_res, want_ids, want_scores = mesh_answers(torch, eager, None)
        eager_params = {k: v.numpy() for k, v in eager["params"].items()}
        for k in TWO_RANK:
            wait_mesh_ranks(procs[k])
        got = {}
        for k in TWO_RANK:
            ranks = []
            for r in range(TWO_RANK[k][0] * TWO_RANK[k][1]):
                with open(os.path.join(outs[k], f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            got[k] = ranks
    print(f"P2 the one-device eager run: ms a step {eager['ms']}")
    for k, ranks in got.items():
        g = ranks[0]
        agree = all((r["losses"] == g["losses"]).all() and all(
            (r["params"][n] == g["params"][n]).all() for n in g["params"])
            for r in ranks[1:])
        check(agree, f"P2 {k}: the ranks disagree")
        loss_err = float(np.abs(g["losses"] - eager["losses"]).max())
        param_err = max(float(np.abs(g["params"][n] - eager_params[n]).max())
                        for n in eager_params)
        if k == "model2":
            ok = loss_err == 0 and param_err == 0
            check_metrics(g["results"], want_res, True, f"P2 {k} evaluation")
            ok &= bool((g["ids"] == want_ids).all())
        else:
            ok = loss_err <= MESH_LOSS_ATOL and param_err <= MESH_PARAM_ATOL
            check_metrics(g["results"], want_res, False,
                          f"P2 {k} evaluation")
            ok &= bool(np.allclose(g["scores"], want_scores, rtol=0,
                                   atol=1e-4))
        print(f"P2 {k} (data x model = {TWO_RANK[k]}, two ranks on one card, "
              f"gloo over CUDA tensors, eager; no collective staged through "
              f"host memory by the port) ({card}): placement "
              f"{g['placement']}; ms a step (rank 0, host clock, "
              f"synchronised) {g['ms']}; |losses - one device| {loss_err:.3e}, "
              f"|parameters - one device| {param_err:.3e} "
              f"({'bit for bit required' if k == 'model2' else f'bound {MESH_LOSS_ATOL}, {MESH_PARAM_ATOL}'}); "
              f"evaluation {g['results']}; rank's seconds "
              f"{[round(r['seconds'], 1) for r in ranks]}")
        check(ok, f"P2 {k}: the mesh run is outside its hold against the "
                  "one-device eager run")


def mesh_phase(torch, fr, graph, card):
    """Phase P: the parallel layer on this card.  -> the routing launches
    of its captured mesh steps."""
    done = phase_timer("P1 one-rank NCCL mesh")
    launches = one_rank_mesh(torch, fr, graph, card)
    done()
    gc_cuda(torch)
    done = phase_timer("P2 two ranks on one card")
    two_rank_meshes(torch, graph, card)
    done()
    gc_cuda(torch)
    return launches


# ------------------------------- phase R: the graph tables over ``model``

# a LightGCN or NGCF BPR step on the 10x hybrid tier: 3 layers x (7 buckets;
# inv_perm and the hub columns), forward and backward over the pair
ROW_STEP = {"gather_reduce": 42, "gather_rows": 12}
ROW_RANKS = 2          # model = 2, two ranks on the one card
ROW_TIMEOUT_S = 300
# each path of R2: (label, family, graph, BPR steps, node_drop and serving)
ROW_PATHS = (("LightGCN 10x", "lightgcn", "10x", 5, True),
             ("NGCF 10x", "ngcf", "10x", 3, False),
             ("LightGCN hetrec", "lightgcn", "hetrec", 3, False))


def row_bucket_rows(torch, dg, adj, x):
    """[(block, rows)]: each forward bucket's ``gather_reduce`` rows from
    ``x`` over the rows the rank holds (its block, or (0, n) whole);
    empty on a dense form."""
    from tagrec_tpu_torch.ops import ell

    fwd = adj.fwd
    blocks = fwd.blocks if isinstance(fwd, ell.RowShard) else None
    form = fwd.form if blocks is not None else fwd
    if not isinstance(form, ell.Hybrid):
        return []
    out = []
    for j, p in enumerate(form.ell.parts):
        n = p.idx.shape[0]
        blk = (blocks[j] if blocks is not None else None) or (0, n)
        rows = dg.gather_reduce(x, p.idx, p.val, p.deg) if n else x[:0]
        out.append((blk, rows.cpu().numpy()))
    return out


def row_path(torch, dg, graph, name, steps, extras, mesh):
    """One path of phase R2 through ``build_pipeline(mesh=)`` and an eager
    ``Trainer(mesh=)`` (``mesh`` None: the one-device run): the graph
    tables' bytes; the forward and each bucket's ``gather_reduce`` rows
    from the initial tables; ``steps`` BPR steps, each timed but the
    last, which is profiled; with ``extras`` one ``node_drop`` step (a
    Trainer of its own), an evaluation, the export and N_REQUESTS top-k
    requests.
    -> the results on the host, with the main path's gather launches,
    the peak memory above the path's start and the seconds."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    secs, t0 = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # the peak above what the process already holds (the one-device run
    # shares its process with the earlier phases' tensors)
    base = torch.cuda.memory_allocated()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(name), tcfg, device="cuda",
                          generator=torch.Generator().manual_seed(0),
                          mesh=mesh)
    model = pipe.model
    out = {"bytes": ell.graph_bytes(model.adj),
           "sharded": isinstance(model.adj.fwd, ell.RowShard)}
    secs["build"] = time.perf_counter() - t0
    with torch.no_grad(), sharding.gathered():
        x = torch.cat(list(model.embed))
        out["buckets"] = row_bucket_rows(torch, dg, model.adj, x)
        out["forward"] = [t.cpu().numpy() for t in model.forward()]
    del x
    reset_counts(dg, GATHER)
    t0 = time.perf_counter()
    trainer = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [time.perf_counter()]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        last[0] = time.perf_counter()

    out["losses"] = trainer.run_phase(pipe.phases[0], max_steps=steps - 1,
                                      on_step=on_step)
    out["step_ms"] = times
    out["step_launches"] = counts(dg, GATHER)
    secs["steps"] = time.perf_counter() - t0
    # the last step (a new epoch's first) under the profiler: its device
    # busy ms, operations, and the host-device copies gloo stages through
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out["losses_profiled"] = trainer.run_phase(pipe.phases[0],
                                                   max_steps=1)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if on_device(e)]
    copies = [e for e in dev if "DtoH" in e.name or "HtoD" in e.name]
    out["profiled"] = {
        "busy_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
        "ops": len(dev), "host_copies": len(copies),
        "host_copies_ms": sum(e.time_range.elapsed_us()
                              for e in copies) / 1e3,
        "nccl_or_gloo": len([e for e in dev if "nccl" in e.name.lower()])}
    if extras:
        t0 = time.perf_counter()
        cfg = model.cfg
        model.cfg = cfg.replace(node_drop=NODE_DROP)
        drop = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                       generator=torch.Generator(device="cuda").manual_seed(1))
        out["drop_losses"] = drop.run_phase(pipe.phases[0], max_steps=1)
        model.cfg = cfg
        secs["node_drop step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["eval"] = pipe.evaluator.run(model)
        secs["evaluation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
        pad, _ = serving.metrics.pad_lists(graph.user_items["train"],
                                           graph.n_user, serving.PAD_ID)
        r = serving.Retriever(u_t, i_t, train_pad=pad, mesh=mesh,
                              device="cuda")
        rng = np.random.default_rng(0)
        out["ids"], out["scores"] = map(np.stack, zip(*(
            r.topk(rng.choice(graph.n_user, REQUEST_USERS, replace=False),
                   TOP_K) for _ in range(N_REQUESTS))))
        secs["export and requests"] = time.perf_counter() - t0
    out["launches"] = counts(dg, GATHER)
    with torch.no_grad(), sharding.gathered():
        out["params"] = {n: sharding.value(model, n).detach().cpu().numpy()
                         for n in checkpoint.jax_leaf_order(model)}
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["seconds"] = secs
    del trainer, pipe, model
    gc_cuda(torch)
    return out


def row_paths(torch, graphs, mesh):
    """Every path of ROW_PATHS -> {label: ``row_path``'s results}."""
    from tagrec_tpu_torch.ops import dma_gather as dg

    return {label: row_path(torch, dg, graphs[g], name, steps, extras, mesh)
            for label, name, g, steps, extras in ROW_PATHS}


def row_rank_main(argv, paths):
    """One rank of phase R2, R3b, R4b, R5b, R6b or R7b (``chip_smoke.py
    row-rank GRAPHS OUT``, ``em-rank``, ``em4-rank``, ``tgcn-rank``,
    ``mask-rank`` or ``dense-rank``, under RANK, WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT): gloo over CUDA tensors, eager, model = 2; ``paths``
    (``row_paths``, ``em_paths``, ``em4_paths``, ``tgcn_paths``,
    ``mask_paths`` or ``dense_paths``) over the pickled graphs, pickled
    to OUT/rank{r}.pkl."""
    import pickle
    from datetime import timedelta

    import torch

    from tagrec_tpu_torch.parallel import launch

    graphs_path, out = argv[0], argv[1]
    launch.initialize("gloo", device="cuda",
                      timeout=timedelta(seconds=ROW_TIMEOUT_S // 2))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(graphs_path, "rb") as f:
            graphs = pickle.load(f)
        mesh = launch.global_mesh(1, ROW_RANKS)
        res = paths(torch, graphs, mesh)
        with open(os.path.join(out, f"rank{launch.rank()}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        launch.shutdown()
    return 0


def one_device_main(argv, paths):
    """The one-device run of phase R7b in a process of its own
    (``chip_smoke.py dense-one GRAPHS OUT``): ``paths`` without a mesh
    over the pickled graphs, pickled to OUT/one.pkl."""
    import pickle

    import torch

    graphs_path, out = argv[0], argv[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(graphs_path, "rb") as f:
        graphs = pickle.load(f)
    res = paths(torch, graphs, None)
    with open(os.path.join(out, "one.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


def start_row_ranks(graphs_path, out, cmd):
    """The ROW_RANKS ranks of phase R2 (``cmd`` "row-rank"), R3b
    ("em-rank"), R4b ("em4-rank"), R5b ("tgcn-rank"), R6b ("mask-rank")
    or R7b ("dense-rank") on this card, each ``chip_smoke.py cmd`` in its
    own process."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(ROW_RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ROW_RANKS),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(os.path.join(out, f"rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), cmd,
             graphs_path, out], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def two_rank_results(torch, graphs, cmd, paths, label, one_cmd=None):
    """ROW_RANKS ranks of ``cmd`` on this card and, meanwhile, ``paths``
    without a mesh in this process, or with ``one_cmd`` in a process of
    its own (``one_device_main``: its peak memory then counts from a
    fresh process's, as the ranks' do, not from this one's, which earlier
    phases warmed) -> (the one-device results, each rank's); a process
    that fails or outlives ROW_TIMEOUT_S fails the phase."""
    import pickle

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graphs.pkl")
        with open(path, "wb") as f:
            pickle.dump(graphs, f)
        procs = start_row_ranks(path, tmp, cmd)
        if one_cmd is None:
            want = paths(torch, graphs, None)
        else:
            log = open(os.path.join(tmp, "one.log"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), one_cmd, path,
                 tmp], stdout=log, stderr=subprocess.STDOUT), log))
        end = time.monotonic() + ROW_TIMEOUT_S
        while any(p.poll() is None for p, _ in procs):
            if (any(p.poll() not in (None, 0) for p, _ in procs)
                    or time.monotonic() > end):
                break
            time.sleep(0.1)
        failed = any(p.poll() != 0 for p, _ in procs)
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            text = log.read()
            log.close()
            if failed:
                print(text[-3000:])
        check(not failed, f"{label}: a rank failed or timed out")
        ranks = []
        for r in range(ROW_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        if one_cmd is not None:
            with open(os.path.join(tmp, "one.pkl"), "rb") as f:
                want = pickle.load(f)
    return want, ranks


def row_one_rank(torch, dg, graph, card):
    """R1: LightGCN at full width on the 10x graph (hybrid tier) on a
    one-rank NCCL mesh, its graph tables one row block, captured: bit for
    bit (losses and parameters) against the same captured run without a
    mesh, ROW_STEP gather launches each step; ms a step with and without
    the mesh, and the mesh's own operations' share of a replay.  -> the
    mesh run's launches."""
    import torch.distributed as dist

    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    family = ("lightgcn", {})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        plain = mesh_run(torch, graph, None, capture=True, family=family)
        reset_counts(dg, GATHER)
        total = {k: 0 for k in GATHER}
        checker = launch_checker(dg, GATHER, ROW_STEP, "R1 mesh step")

        def on_launches(steps, run):
            for k, v in checker(steps, run).items():
                total[k] += v

        meshed = mesh_run(torch, graph, mesh, capture=True,
                          on_launches=on_launches, family=family)
        run = meshed["trainer"].runs["bpr"]
        adj = meshed["pipe"].model.adj
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R1: the mesh step was not captured")
        check(isinstance(adj.fwd, ell.RowShard) and "model" in placed.values(),
              "R1: the graph tables were not placed on the mesh")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        on_model = sum(v == "model" for v in placed.values())
        print(f"R1 LightGCN 10x captured on a one-rank NCCL mesh {mesh}, "
              f"{HETREC_BPR_STEPS} steps: {on_model} of {len(placed)} graph "
              f"leaves on 'model' (one block), "
              f"{ell.graph_bytes(adj)} bytes; launches {total}; losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R1: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            MESH_WALL_STEPS)
                              / MESH_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"R1 captured LightGCN 10x step ({card}): ms a step over "
              f"{MESH_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        return total
    finally:
        dist.destroy_process_group()


def rounded(secs):
    return {k: round(v, 2) for k, v in secs.items()}


def row_hold(label, got, want, ranks, steps, card):
    """A rank's R2 path against the one-device run; prints and checks."""
    import numpy as np

    fwd_ok = all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                 for a, b in zip(got["forward"], want["forward"]))
    fwd_err = max(float(np.abs(a - b).max())
                  for a, b in zip(got["forward"], want["forward"]))
    buckets_ok = len(got["buckets"]) == len(want["buckets"]) and all(
        np.array_equal(rows, w[s:e]) for ((s, e), rows), (_, w) in
        zip(got["buckets"], want["buckets"]))
    keys = [k for k in ("losses", "losses_profiled", "drop_losses")
            if k in want]
    losses, wlosses = [got[k] for k in keys], [want[k] for k in keys]
    loss_err = max(float(np.abs(a - b).max()) for a, b in zip(losses,
                                                              wlosses))
    param_err = max(float(np.abs(got["params"][n] - want["params"][n]).max())
                    for n in want["params"])
    bound = 0.01 * 0.01 * steps  # a hundredth of TrainConfig's lr a step
    agree = all(all(np.array_equal(r["params"][n], got["params"][n])
                    for n in got["params"]) for r in ranks)
    same_launches = all(r["launches"] == want["launches"] for r in ranks)
    print(f"R2 {label} (model = {ROW_RANKS}, gloo over CUDA tensors, eager; "
          f"{card}): graph tables per rank {[r['bytes'] for r in ranks]} "
          f"bytes against {want['bytes']} on one device; peak memory "
          f"above the path's start per rank "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB against "
          f"{want['peak'] / 2**30:.3f}; forward max abs err "
          f"{fwd_err:.3e} (rtol {RTOL}, atol {ATOL}) "
          f"{'ok' if fwd_ok else 'FAIL'}; {len(got['buckets'])} buckets' "
          f"gather_reduce rows {'bit for bit' if buckets_ok else 'DIFFER'}; "
          f"|losses - one device| {loss_err:.3e} (bound {MESH_LOSS_ATOL}); "
          f"|parameters - one device| {param_err:.3e} (bound {bound:.1e}); "
          f"ranks' parameters {'bit for bit' if agree else 'DIFFER'}; "
          f"launches per rank {[r['launches'] for r in ranks]} (one device "
          f"{want['launches']}, BPR steps {want['step_launches']}); ms a "
          f"step (host clock, synchronised) rank 0 "
          f"{[round(t, 3) for t in got['step_ms']]}, one device "
          f"{[round(t, 3) for t in want['step_ms']]}; a profiled step: rank "
          f"0 {got['profiled']}, one device {want['profiled']}; seconds "
          f"per rank {[rounded(r['seconds']) for r in ranks]}, one device "
          f"{rounded(want['seconds'])}")
    check(all(r["sharded"] for r in ranks) and not want["sharded"],
          f"R2 {label}: the ranks' graph tables are not row shards")
    check(fwd_ok and buckets_ok and loss_err <= MESH_LOSS_ATOL
          and param_err <= bound and agree and same_launches,
          f"R2 {label}: a rank is outside its hold against one device")
    # the hybrid tier runs the gather kernels; the dense sectors none
    check(not want["buckets"] or all(
        r["launches"]["gather_reduce"] > 0 and r["launches"]["gather_rows"]
        > 0 for r in ranks), f"R2 {label}: a rank launched no gather kernel")
    if "eval" in want:
        check_metrics(got["eval"], want["eval"], False, f"R2 {label}")
        check(bool(np.allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-4)),
              f"R2 {label}: the requests' scores differ")
        print(f"R2 {label}: evaluation {got['eval']} (one device "
              f"{want['eval']}); {N_REQUESTS} requests' scores within 1e-4")


def row_two_ranks(torch, graphs, card):
    """R2: ``row_paths`` on ROW_RANKS ranks (model = 2) on this card
    against the one-device eager run -> every rank's gather launches."""
    want, ranks = two_rank_results(torch, graphs, "row-rank", row_paths,
                                   "R2")
    launches = {k: 0 for k in GATHER}
    for label, _, _, steps, extras in ROW_PATHS:
        rs = [r[label] for r in ranks]
        row_hold(label, rs[0], want[label], rs, steps + extras, card)
        for r in rs:
            for k in GATHER:
                launches[k] += r["launches"][k]
    return launches


def row_phase(torch, dg, graphs, card):
    """Phase R: LightGCN's and NGCF's graph tables row-sharded over
    ``model``.  -> the gather launches of its main paths (R1's captured
    mesh steps, R2's ranks)."""
    done = phase_timer("R1 one-rank NCCL mesh, LightGCN 10x")
    launches = row_one_rank(torch, dg, graphs["10x"], card)
    done()
    gc_cuda(torch)
    done = phase_timer("R2 model = 2 on one card")
    two = row_two_ranks(torch, graphs, card)
    done()
    gc_cuda(torch)
    return {k: launches[k] + two[k] for k in GATHER}


# --------------------- phase R3: the EdgeMap tier's rows over ``model``

# a DGCF BPR step on the 10x EdgeMap: 3 layers x 2 iterations x 4 factors x
# 7 non-empty buckets forward, 3 x 4 x 7 over the transpose backward
EM_STEP = {"gather_reduce": 252}
EM_WALL_STEPS = 10     # captured steps a timed run, with and without the mesh
# each path of R3b and R4b: (label, family, preset overrides (adj_mode
# "ell" unless they say otherwise), graph ("kg": the hetrec graph and
# parallel_kg's KG), BPR steps, the map whose buckets' rows are held)
EM_PATHS = (("DGCF hetrec", "dgcf", {}, "hetrec", 3, "em"),
            ("DisenGCN hetrec", "disengcn", {}, "hetrec", 3, "em"),
            ("DGCF 10x", "dgcf", {}, "10x", 2, "em"))
BUCKET_D = 64          # the width of the bucket rows' seeded x


def em_bucket_rows(torch, dg, em):
    """[(block, rows)]: each forward bucket's ``gather_reduce`` rows of
    the map's static payload times a seeded x [n_cols, BUCKET_D], over
    the rows the rank holds (its block, or (0, n) for a bucket whole on
    every rank)."""
    from tagrec_tpu_torch.ops import edgemap

    shard = isinstance(em, edgemap.EdgeMapShard)
    local = em.local if shard else em
    x = torch.randn((int(local.b_inv.shape[0]), BUCKET_D), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    out = []
    for j, (idx, val, deg) in enumerate(zip(local.f_idx, local.f_val,
                                            local.f_deg)):
        n, k = idx.shape
        blk = (em.f_blocks[j] if shard else None) or (0, n)
        rows = (dg.gather_reduce(x, idx, val, deg) if n and k
                else x.new_zeros((n, x.shape[1])))
        out.append((blk, rows.cpu().numpy()))
    return out


def em_path(torch, dg, graphs, path, mesh):
    """One path of phase R3b or R4b (an entry of EM_PATHS or EM4_PATHS)
    through ``build_pipeline(mesh=)`` and an eager ``Trainer(mesh=)`` on
    the EdgeMap tier (``mesh`` None: the one-device run): the maps' bytes
    on the card; the forward and the held map's buckets' ``gather_reduce``
    rows from the initial tables; ``steps`` BPR steps, each timed.  -> the
    results on the host, with the steps' ``gather_reduce`` launches, the
    peak memory above the path's start and the seconds."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    _, name, over, g, steps, key = path
    secs, t0 = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tcfg = TrainConfig()
    pipe = build_pipeline(graphs["hetrec" if g == "kg" else g],
                          model_preset(name, **{"adj_mode": "ell", **over}),
                          tcfg, device="cuda", mesh=mesh,
                          kg=graphs["kg"] if g == "kg" else None,
                          generator=torch.Generator().manual_seed(0))
    model = pipe.model
    em = model.edges[key]
    out = {"bytes": model.edges.nbytes(), "tier": model.tier,
           "sharded": isinstance(em, edgemap.EdgeMapShard) and em.model > 1
           and all(isinstance(model.edges[k], (edgemap.EdgeMapShard,
                                               edgemap.SlotMapShard))
                   for k in model.em_hosts)}
    secs["build"] = time.perf_counter() - t0
    out["buckets"] = em_bucket_rows(torch, dg, em)
    with torch.no_grad(), sharding.gathered():
        out["forward"] = [t.cpu().numpy() for t in model.forward()]
    del em
    reset_counts(dg, ("gather_reduce",))
    t0 = time.perf_counter()
    trainer = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [time.perf_counter()]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        last[0] = time.perf_counter()

    out["losses"] = trainer.run_phase(pipe.phases[0], max_steps=steps,
                                      on_step=on_step)
    out["step_ms"] = times
    out["launches"] = counts(dg, ("gather_reduce",))
    secs["steps"] = time.perf_counter() - t0
    with torch.no_grad(), sharding.gathered():
        out["params"] = {n: sharding.value(model, n).detach().cpu().numpy()
                         for n in checkpoint.jax_leaf_order(model)}
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["seconds"] = secs
    del trainer, pipe, model
    gc_cuda(torch)
    return out


def em_paths(torch, graphs, mesh, paths=EM_PATHS):
    """Every path of ``paths`` -> {label: ``em_path``'s results}."""
    from tagrec_tpu_torch.ops import dma_gather as dg

    return {path[0]: em_path(torch, dg, graphs, path, mesh)
            for path in paths}


def em_hold(label, got, want, ranks, steps, card, phase="R3b"):
    """A rank's R3b or R4b path against the one-device run; prints and
    checks: the forward within RTOL/ATOL (and whether bit for bit), each
    bucket's rows bit for bit, losses within MESH_LOSS_ATOL, parameters
    within a hundredth of lr a step, the ranks bit for bit, their
    launches one device's, each rank's map bytes below one device's."""
    import numpy as np

    fwd_ok = all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                 for a, b in zip(got["forward"], want["forward"]))
    fwd_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["forward"], want["forward"]))
    fwd_err = max(float(np.abs(a - b).max())
                  for a, b in zip(got["forward"], want["forward"]))
    buckets_ok = len(got["buckets"]) == len(want["buckets"]) and all(
        np.array_equal(rows, w[s:e]) for ((s, e), rows), (_, w) in
        zip(got["buckets"], want["buckets"]))
    cut = sum(1 for ((s, e), _), (_, w) in zip(got["buckets"],
                                              want["buckets"])
              if e - s < len(w))
    loss_err = float(np.abs(got["losses"] - want["losses"]).max())
    param_err, worst = max(
        (float(np.abs(got["params"][n] - want["params"][n]).max()), n)
        for n in want["params"])
    bound = 0.01 * 0.01 * steps  # a hundredth of TrainConfig's lr a step
    agree = all(np.array_equal(r["losses"], got["losses"]) and all(
        np.array_equal(r["params"][n], got["params"][n])
        for n in got["params"]) for r in ranks)
    same_launches = all(r["launches"] == want["launches"] for r in ranks)
    print(f"{phase} {label} (EdgeMap tier, model = {ROW_RANKS}, gloo over "
          f"CUDA tensors, eager; {card}): map bytes per rank "
          f"{[r['bytes'] for r in ranks]} against {want['bytes']} on one "
          f"device ({[round(r['bytes'] / want['bytes'], 4) for r in ranks]}"
          f"x); peak memory above the path's start per rank "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB against "
          f"{want['peak'] / 2**30:.3f}; forward max abs err {fwd_err:.3e} "
          f"({'bit for bit' if fwd_exact else f'rtol {RTOL}, atol {ATOL}'}) "
          f"{'ok' if fwd_ok else 'FAIL'}; {len(got['buckets'])} buckets' "
          f"gather_reduce rows ({cut} cut to the rank's block) "
          f"{'bit for bit' if buckets_ok else 'DIFFER'}; |losses - one "
          f"device| {loss_err:.3e} (bound {MESH_LOSS_ATOL}); |parameters - "
          f"one device| {param_err:.3e}"
          f"{f' ({worst})' if param_err else ''} (bound {bound:.1e}); ranks "
          f"{'bit for bit' if agree else 'DIFFER'}; gather_reduce launches "
          f"per rank {[r['launches'] for r in ranks]} (one device "
          f"{want['launches']}); ms a step (host clock, synchronised) rank 0 "
          f"{[round(t, 3) for t in got['step_ms']]}, one device "
          f"{[round(t, 3) for t in want['step_ms']]}; seconds per rank "
          f"{[rounded(r['seconds']) for r in ranks]}, one device "
          f"{rounded(want['seconds'])}")
    check(all(r["sharded"] and r["tier"] == "ell"
              and r["bytes"] < want["bytes"] for r in ranks)
          and not want["sharded"] and cut > 0,
          f"{phase} {label}: the ranks' maps are not row shards")
    check(fwd_ok and buckets_ok and loss_err <= MESH_LOSS_ATOL
          and param_err <= bound and agree and same_launches,
          f"{phase} {label}: a rank is outside its hold against one device")


def em_one_rank(torch, dg, graph, card):
    """R3a: DGCF at full width on the 10x graph (the EdgeMap tier) on a
    one-rank NCCL mesh, its map one row block, captured: bit for bit
    (losses and parameters) against the same captured run without a
    mesh, EM_STEP ``gather_reduce`` launches each step; ms a step with and
    without the mesh, and the mesh's own operations in a replay.  -> the
    mesh run's launches."""
    import torch.distributed as dist

    from tagrec_tpu_torch.ops import edgemap, ell
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    family = ("dgcf", {"adj_mode": "ell"})  # auto takes it at 10x too
    names = ("gather_reduce",)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        plain = mesh_run(torch, graph, None, capture=True, family=family)
        reset_counts(dg, names)
        total = {k: 0 for k in names}
        checker = launch_checker(dg, names, EM_STEP, "R3a mesh step")

        def on_launches(steps, run):
            for k, v in checker(steps, run).items():
                total[k] += v

        meshed = mesh_run(torch, graph, mesh, capture=True,
                          on_launches=on_launches, family=family)
        run = meshed["trainer"].runs["bpr"]
        em = meshed["pipe"].model.edges["em"]
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R3a: the mesh step was not captured")
        check(isinstance(em, edgemap.EdgeMapShard)
              and "model" in placed.values(),
              "R3a: the map was not placed on the mesh")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        on_model = sum(v == "model" for v in placed.values())
        print(f"R3a DGCF 10x (EdgeMap) captured on a one-rank NCCL mesh "
              f"{mesh}, {HETREC_BPR_STEPS} steps: {on_model} of "
              f"{len(placed)} map leaves on 'model' (one block), "
              f"{ell.graph_bytes(em)} bytes; launches {total}; losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R3a: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        del em
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            EM_WALL_STEPS) / EM_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"R3a captured DGCF 10x step ({card}): ms a step over "
              f"{EM_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        return total
    finally:
        dist.destroy_process_group()


def em_phase(torch, dg, graphs, card):
    """Phase R3: DGCF's and DisenGCN's EdgeMap row-sharded over
    ``model``.  -> the ``gather_reduce`` launches of its main paths (R3a's
    captured mesh steps, R3b's ranks)."""
    t0 = time.perf_counter()
    done = phase_timer("R3a one-rank NCCL mesh, DGCF 10x (EdgeMap)")
    launches = em_one_rank(torch, dg, graphs["10x"], card)["gather_reduce"]
    done()
    gc_cuda(torch)
    done = phase_timer("R3b model = 2 on one card, the EdgeMap tier")
    want, ranks = two_rank_results(torch, graphs, "em-rank", em_paths,
                                   "R3b")
    for label, _, _, _, steps, _ in EM_PATHS:
        rs = [r[label] for r in ranks]
        em_hold(label, rs[0], want[label], rs, steps, card)
        check(want[label]["launches"]["gather_reduce"] > 0,
              f"R3b {label}: no gather_reduce launch")
        launches += sum(r["launches"]["gather_reduce"] for r in rs)
    done()
    gc_cuda(torch)
    print(f"phase R3: {time.perf_counter() - t0:.1f} s (host clock)")
    return launches


# ------ phase R4: DisenHAN's, KGAT's and TGCN ``ell``'s maps over ``model``

KGAT_10X = ("kgat", {"agg_type": "bi_inter"})  # auto takes the EdgeMap
R4_WALL_STEPS = 5      # captured steps a timed run, with and without the mesh
EM4_PATHS = (("DisenHAN hetrec", "disenhan", {}, "hetrec", 3, "ems.1"),
             ("KGAT hetrec", "kgat", {"agg_type": "bi_inter"}, "hetrec", 3,
              "em"),
             ("KGAT KG fallback", "kgat", {"agg_type": "bi_inter"}, "kg", 3,
              "em"),
             ("TGCN hetrec", "tgcn", {}, "hetrec", 3, "em.i_uw.0"),
             ("KGAT 10x", "kgat", {"agg_type": "bi_inter", "adj_mode": "auto"},
              "10x", 2, "em"))


def em4_paths(torch, graphs, mesh):
    """Every path of EM4_PATHS -> {label: ``em_path``'s results}."""
    return em_paths(torch, graphs, mesh, EM4_PATHS)


def kgat_step_launches(model) -> dict:
    """``gather_reduce`` launches of one KGAT BPR step on the EdgeMap
    tier: each layer's ``edge_reduce`` over ``em``'s non-empty forward
    buckets, and over its transpose's in the backward; ``edge_dot``'s two
    backward reductions over ``emk``'s and its transpose's."""
    def live(em):
        return sum(1 for i in em.f_idx if i.shape[0] and i.shape[1])

    em, emk = model.edges["em"], model.edges["emk"]
    return {"gather_reduce": model.cfg.num_layer * (live(em)
                                                    + live(em.transpose()))
            + live(emk) + live(emk.transpose())}


def kgat_10x_one_rank(torch, dg, graph, card):
    """R4a: KGAT ``bi_inter`` at the preset's width on the 10x graph (the
    EdgeMap tier) on a one-rank NCCL mesh, its maps and slot maps one row
    block, captured: bit for bit (losses and parameters) against the same
    captured run without a mesh, ``kgat_step_launches`` each step; ms a
    step with and without the mesh, the mesh's own operations in a
    replay, the maps' bytes, and without the mesh a replay's busy, idle
    and operations and the run's peak.  -> the mesh run's launches."""
    import torch.distributed as dist

    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    names = ("gather_reduce",)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = mesh_run(torch, graph, None, capture=True, family=KGAT_10X)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        model = plain["pipe"].model
        check(model.tier == "ell", f"R4a: KGAT 10x took {model.tier}")
        want = kgat_step_launches(model)
        plain_bytes = model.edges.nbytes()
        del model
        reset_counts(dg, names)
        total = {k: 0 for k in names}
        checker = launch_checker(dg, names, want, "R4a mesh step")

        def on_launches(steps, run):
            for k, v in checker(steps, run).items():
                total[k] += v

        meshed = mesh_run(torch, graph, mesh, capture=True,
                          on_launches=on_launches, family=KGAT_10X)
        run = meshed["trainer"].runs["bpr"]
        edges = meshed["pipe"].model.edges
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R4a: the mesh step was not captured")
        check(all(isinstance(edges[k], (edgemap.EdgeMapShard,
                                        edgemap.SlotMapShard))
                  for k in meshed["pipe"].model.em_hosts)
              and "model" in placed.values(),
              "R4a: the maps were not placed on the mesh")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        on_model = sum(v == "model" for v in placed.values())
        print(f"R4a KGAT bi_inter 10x (EdgeMap) captured on a one-rank NCCL "
              f"mesh {mesh}, {HETREC_BPR_STEPS} steps: {on_model} of "
              f"{len(placed)} map and slot-map leaves on 'model' (one "
              f"block), {edges.nbytes()} bytes ({plain_bytes} without the "
              f"mesh); launches {total} ({want} a step); losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R4a: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        del edges
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            R4_WALL_STEPS) / R4_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        p_busy, p_idle, p_n = replay_profile(torch, plain_run.graph,
                                             PROFILED_REPLAYS)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        by_op = sorted(p_ops.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"R4a captured KGAT 10x step ({card}): ms a step over "
              f"{R4_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        print(f"R4a KGAT 10x without the mesh, one device ({card}): a "
              f"replay busy {p_busy:.4f} ms, idle share {p_idle:.4f}, "
              f"{p_n:.0f} device operations; peak memory above the start "
              f"{peak / 2**30:.3f} GiB; map bytes {plain_bytes}; largest "
              f"operations "
              f"{[(k[:50], n, round(ms, 3)) for k, (n, ms) in by_op]}")
        return total
    finally:
        dist.destroy_process_group()


def parallel_kg(graph):
    """Phase K's KG with ``KG_PARALLEL`` triples repeated under another
    relation, which ``rel_id_host`` refuses: KGAT takes the EdgeMap."""
    import numpy as np

    from tagrec_tpu_torch.data.kg import KnowledgeGraph

    kg = KnowledgeGraph.synthetic(graph, **KG_SIZE)
    rng = np.random.default_rng(1)
    extra = kg.kg_data[rng.choice(len(kg.kg_data), KG_PARALLEL,
                                  replace=False)].copy()
    extra[:, 1] = (extra[:, 1] + 1) % kg.num_rela
    kg.kg_data = np.concatenate([kg.kg_data, extra])
    kg._finish_init()
    return kg


def em4_phase(torch, dg, graphs, card):
    """Phase R4: DisenHAN's, KGAT's and TGCN ``ell``'s maps row-sharded
    over ``model``.  -> the ``gather_reduce`` launches of its main paths
    (R4a's captured mesh steps, R4b's ranks)."""
    t0 = time.perf_counter()
    done = phase_timer("R4a one-rank NCCL mesh, KGAT 10x (EdgeMap)")
    launches = kgat_10x_one_rank(torch, dg, graphs["10x"],
                                 card)["gather_reduce"]
    done()
    gc_cuda(torch)
    done = phase_timer("R4b model = 2 on one card, DisenHAN, KGAT, TGCN")
    graphs = dict(graphs, kg=parallel_kg(graphs["hetrec"]))
    want, ranks = two_rank_results(torch, graphs, "em4-rank", em4_paths,
                                   "R4b")
    for label, name, _, _, steps, _ in EM4_PATHS:
        rs = [r[label] for r in ranks]
        em_hold(label, rs[0], want[label], rs, steps, card, phase="R4b")
        check((want[label]["launches"]["gather_reduce"] > 0)
              == (name != "tgcn"),
              f"R4b {label}: gather_reduce launches "
              f"{want[label]['launches']}")
        launches += sum(r["launches"]["gather_reduce"] for r in rs)
    done()
    gc_cuda(torch)
    print(f"phase R4: {time.perf_counter() - t0:.1f} s (host clock)")
    return launches


# ------ phase R5: TGCN's neighbour tables and dedup buckets over ``model``

TGCN_FAMILY = ("tgcn", {})  # auto: the dedup tier
R5_WALL_STEPS = 5      # captured steps a timed run, with and without the mesh
R5_TRANSTAG_STEPS = 2
# each path of R5b: (label, adj_mode, BPR steps, evaluation and export,
# the float64 step)
TGCN_PATHS = (("TGCN auto hetrec", "auto", 3, True, True),
              ("TGCN dense_xla hetrec", "dense_xla", 2, False, True),
              ("TGCN ell hetrec", "ell", 2, False, False))
# a float64 step's gradients and parameters on the scale of the largest
# gradient: the same sums grouped two ways agree to rounding
R5_F64_BOUND = 1e-9
# each float64 gradient within R5_F64_LEAF_BOUND of its own scale plus
# R5_F64_FLOOR of the largest gradient's (the parallel tests' rule,
# 5e-4 |g| + 1e-4 max|g|, in float64): a missing sum or a double count
# moves a leaf by a share of its own scale, which this sees on every leaf
# above the floor.  The floor is float64's rounding at the largest
# gradient (2.7e-14 of it at hetrec): the last layer's user and item
# attention W1 and b have gradients zero in exact arithmetic (1e-19 of
# the largest in float64: experiments/torch_tgcn_grad_scales.py), so
# both runs hold rounding residue there, 1.5x apart on their own scale,
# and no fault can move them
R5_F64_LEAF_BOUND = 1e-6
R5_F64_FLOOR = 1e-12
# the float32 trajectory's entries past its bound: those whose gradient
# sits near Adam's eps on some step, where a last-bit change moves an entry
# by a share of lr (1 of 1,226,366 in TGCN auto's runs)
R5_PAST_MAX = 8


def tgcn_one_rank(torch, graph, card):
    """R5a: TGCN at the preset's width on the hetrec graph (``auto``, the
    dedup tier) on a one-rank NCCL mesh, its tables one row block,
    captured: bit for bit (losses and parameters) against the same
    captured run without a mesh; ms a step with and without the mesh, a
    replay's busy time and operations, the mesh's own operations, the
    tables' bytes and the peak memory."""
    import torch.distributed as dist

    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = mesh_run(torch, graph, None, capture=True,
                         family=TGCN_FAMILY)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        plain_bytes = plain["pipe"].model.table_nbytes()
        check(plain["pipe"].model.tier == "dedup",
              f"R5a: TGCN took {plain['pipe'].model.tier}")
        meshed = mesh_run(torch, graph, mesh, capture=True,
                          family=TGCN_FAMILY)
        model = meshed["pipe"].model
        run = meshed["trainer"].runs["bpr"]
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R5a: the mesh step was not captured")
        check(model.tables_mesh is mesh and "model" in placed.values(),
              "R5a: the tables were not placed on the mesh")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        on_model = sum(v == "model" for v in placed.values())
        print(f"R5a TGCN auto hetrec captured on a one-rank NCCL mesh "
              f"{mesh}, {HETREC_BPR_STEPS} steps: {on_model} of "
              f"{len(placed)} table leaves on 'model' (one block), "
              f"{model.table_nbytes()} bytes ({plain_bytes} without the "
              f"mesh); losses {'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R5a: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        del model
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            R5_WALL_STEPS) / R5_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        p_busy, p_idle, p_n = replay_profile(torch, plain_run.graph,
                                             PROFILED_REPLAYS)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        by_op = sorted(p_ops.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"R5a captured TGCN auto hetrec step ({card}): ms a step over "
              f"{R5_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        print(f"R5a TGCN auto hetrec without the mesh, one device ({card}): "
              f"a replay busy {p_busy:.4f} ms, idle share {p_idle:.4f}, "
              f"{p_n:.0f} device operations; peak memory above the start "
              f"{peak / 2**30:.3f} GiB; table bytes {plain_bytes}; largest "
              f"operations "
              f"{[(k[:50], n, round(ms, 3)) for k, (n, ms) in by_op]}")
    finally:
        dist.destroy_process_group()


def gathered_grads(torch, model):
    """{JAX name: the whole gradient on the host} of ``model``'s
    parameters (a row-sharded one all-gathered over ``model``)."""
    import torch.distributed as dist

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint

    gs, params = sharding.gathers(model), checkpoint.named_params(model)
    out = {}
    for n in checkpoint.jax_leaf_order(model):
        g = params[n].grad
        if n in gs:
            parts = [torch.empty_like(g)
                     for _ in range(gs[n].mesh.shape["model"])]
            dist.all_gather(parts, g, group=gs[n].mesh.group("model"))
            g = torch.cat(parts)
        out[n] = g.cpu().numpy().copy()
    return out


def tgcn_f64_step(torch, graph, mode, mesh):
    """TGCN on ``mode``'s tier in float64: ``f64_step``."""
    return f64_step(torch, graph, ("tgcn", {"adj_mode": mode}), mesh)


def f64_step(torch, graph, family, mesh, kg=None):
    """``family`` (name, preset overrides) in float64 (KGAT over ``kg``
    when given; ``mesh`` None: one device): one BPR step from the initial
    parameters on the phase's first batch -> (its gradients, the
    parameters after it), gathered, on the host."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(family[0], **family[1]), tcfg,
                          device="cuda", mesh=mesh, kg=kg,
                          generator=torch.Generator().manual_seed(0))
    pipe.model.to(torch.float64)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, mesh=mesh,
                      capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    bpr = pipe.phases[0]
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    trainer.step(bpr, batch)
    grads = gathered_grads(torch, pipe.model)
    with torch.no_grad(), sharding.gathered():
        params = {n: sharding.value(pipe.model, n).detach().cpu().numpy()
                  for n in checkpoint.jax_leaf_order(pipe.model)}
    del trainer, pipe
    gc_cuda(torch)
    return grads, params


def tgcn_path(torch, graphs, path, mesh):
    """One path of phase R5b (an entry of TGCN_PATHS) through
    ``build_pipeline(mesh=)`` and an eager ``Trainer(mesh=)`` on the
    hetrec graph (``mesh`` None: the one-device run): the tables' (and
    maps') bytes on the card and the rows each relation fed the
    attention; from the initial tables the forward, and
    with ``answers`` an evaluation and the exported tables; ``steps`` BPR
    steps, each timed (the first step's gradients and parameters kept),
    then R5_TRANSTAG_STEPS TransTag steps; with ``f64`` one BPR step in
    float64 (``tgcn_f64_step``).  -> the results on the host, with the
    peak memory above the path's start and the seconds."""
    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    _, mode, steps, answers, f64 = path
    graph = graphs["hetrec"]
    secs, t0 = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", adj_mode=mode), tcfg,
                          device="cuda", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))
    model = pipe.model
    out = {"tier": model.tier, "bytes": model.table_nbytes(),
           "map_bytes": model.edges.nbytes() if model.ell else 0,
           "sharded": mesh is not None and any(
               b is not None for b in model.blocks.values())}
    secs["build"] = time.perf_counter() - t0
    def params():  # copies: Adam updates the parameters in place
        with torch.no_grad(), sharding.gathered():
            return {n: sharding.value(model, n).detach().cpu().numpy().copy()
                    for n in checkpoint.jax_leaf_order(model)}

    with torch.no_grad(), sharding.gathered():
        out["forward"] = [t.cpu().numpy() for t in model.forward()]
    out["rows"] = dict(model.attention_rows)
    if answers:
        t0 = time.perf_counter()
        out["eval"] = pipe.evaluator.run(model)
        out["export"] = serving.export_tables(model, n_item=graph.n_item)
        secs["eval_export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [time.perf_counter()]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        if i == 0:  # the step from the initial parameters
            out["first"] = (gathered_grads(torch, model), params())
        last[0] = time.perf_counter()

    out["losses"] = trainer.run_phase(pipe.phases[0], max_steps=steps,
                                      on_step=on_step)
    out["step_ms"] = times
    out["transtag"] = trainer.run_phase(pipe.phases[1],
                                        max_steps=R5_TRANSTAG_STEPS)
    secs["steps"] = time.perf_counter() - t0
    out["params"] = params()
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    del trainer, pipe, model
    gc_cuda(torch)
    if f64:
        t0 = time.perf_counter()
        out["f64"] = tgcn_f64_step(torch, graph, mode, mesh)
        secs["f64"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def tgcn_paths(torch, graphs, mesh):
    """Every path of TGCN_PATHS -> {label: ``tgcn_path``'s results}."""
    return {path[0]: tgcn_path(torch, graphs, path, mesh)
            for path in TGCN_PATHS}


def tgcn_hold(torch, label, got, want, ranks, steps, card):
    """A rank's R5b path against the one-device run; prints and checks:
    each rank's table bytes and attention rows below one device's; the
    forward within RTOL/ATOL (and whether bit for bit); the evaluation
    within JAX's mesh tolerances and the exported tables within
    RTOL/ATOL; the BPR and TransTag losses within MESH_LOSS_ATOL; the
    ranks bit for bit; the first step's parameters within 2e-6 wherever
    Adam's first step is well conditioned (one device's |g| >= 100 eps,
    the parallel tests' rule); at most R5_PAST_MAX entries of the
    parameters after every step past a hundredth of lr a step (TGCN's
    float32 gradients reach Adam's eps, where a last-bit change moves an
    entry by a share of lr); the float64 step's gradients and parameters
    within R5_F64_BOUND of scale, and each gradient within
    R5_F64_LEAF_BOUND of its own scale plus R5_F64_FLOOR of the largest.
    Printed: each gradient's float32 error on its own scale."""
    import numpy as np

    fwd_ok = all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                 for a, b in zip(got["forward"], want["forward"]))
    fwd_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["forward"], want["forward"]))
    fwd_err = max(float(np.abs(a - b).max())
                  for a, b in zip(got["forward"], want["forward"]))
    loss_err = max(float(np.abs(got[k] - want[k]).max())
                   for k in ("losses", "transtag"))
    (g1, p1), (w1g, w1p) = got["first"], want["first"]
    first_err = max(float(np.abs(p1[n] - p)[np.abs(w1g[n]) >= 1e-6].max(
        initial=0.0)) for n, p in w1p.items())
    conditioned = sum(int((np.abs(g) >= 1e-6).sum()) for g in w1g.values())
    g32 = sorted(((n, grad_errors(torch.from_numpy(g1[n]),
                                  torch.from_numpy(g))[0])
                  for n, g in w1g.items()), key=lambda kv: -kv[1])[:3]
    # a hundredth of TrainConfig's lr a step, BPR and TransTag
    bound = 0.01 * 0.01 * (steps + R5_TRANSTAG_STEPS)
    param_err, worst = max(
        (float(np.abs(got["params"][n] - want["params"][n]).max()), n)
        for n in want["params"])
    past = sum(int((np.abs(got["params"][n] - want["params"][n])
                    > bound).sum()) for n in want["params"])
    total = sum(a.size for a in want["params"].values())
    agree = all(np.array_equal(r["losses"], got["losses"]) and all(
        np.array_equal(r["params"][n], got["params"][n])
        for n in got["params"]) for r in ranks)
    fewer = all(sum(r["rows"].values()) < sum(want["rows"].values())
                for r in ranks)
    maps = (f"; map bytes per rank {[r['map_bytes'] for r in ranks]} "
            f"against {want['map_bytes']}" if want["map_bytes"] else "")
    print(f"R5b {label} (model = {ROW_RANKS}, gloo over CUDA tensors, "
          f"eager; {card}): tier {got['tier']}; table bytes per rank "
          f"{[r['bytes'] for r in ranks]} against {want['bytes']} on one "
          f"device ({[round(r['bytes'] / want['bytes'], 4) for r in ranks]}"
          f"x){maps}; peak memory above the path's start per rank "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB against "
          f"{want['peak'] / 2**30:.3f}; attention rows a forward per rank "
          f"{[sum(r['rows'].values()) for r in ranks]} against "
          f"{sum(want['rows'].values())}; forward max abs err {fwd_err:.3e} "
          f"({'bit for bit' if fwd_exact else f'rtol {RTOL}, atol {ATOL}'}) "
          f"{'ok' if fwd_ok else 'FAIL'}; |losses - one device| "
          f"{loss_err:.3e} (bound {MESH_LOSS_ATOL}); ranks "
          f"{'bit for bit' if agree else 'DIFFER'}; the first step's "
          f"parameters where |g| >= 1e-6 ({conditioned} entries) max |err| "
          f"{first_err:.3e} (bound 2e-6), its gradients' largest max |err| "
          f"/ max |g| {[(n, f'{e:.2e}') for n, e in g32]}; after every step "
          f"|parameters - one device| {param_err:.3e} ({worst}), {past} of "
          f"{total} entries past {bound:.1e} (at most {R5_PAST_MAX}); ms a BPR step (host clock, "
          f"synchronised) rank 0 {[round(t, 3) for t in got['step_ms']]}, "
          f"one device {[round(t, 3) for t in want['step_ms']]}; seconds "
          f"per rank {[rounded(r['seconds']) for r in ranks]}, one device "
          f"{rounded(want['seconds'])}")
    check(all(r["sharded"] and r["tier"] == want["tier"]
              and r["bytes"] < want["bytes"] for r in ranks)
          and not want["sharded"] and fewer,
          f"R5b {label}: the ranks' tables are not row shards")
    check(fwd_ok and loss_err <= MESH_LOSS_ATOL and agree
          and first_err <= 2e-6 and past <= R5_PAST_MAX,
          f"R5b {label}: a rank is outside its hold against one device")
    if "eval" in want:
        check_metrics(got["eval"], want["eval"], False, f"R5b {label}")
        exp_err = max(float(np.abs(a - b).max())
                      for a, b in zip(got["export"], want["export"]))
        print(f"R5b {label}, the initial parameters: evaluation "
              f"{got['eval']} (one device {want['eval']}); exported tables "
              f"max abs err {exp_err:.3e}")
        check(all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                  for a, b in zip(got["export"], want["export"])),
              f"R5b {label}: the exported tables differ")
    if "f64" in want:
        f64_hold(f"R5b {label}", got["f64"], want["f64"])


def f64_hold(label, got, want):
    """A rank's float64 step (gradients, parameters after it) against one
    device's: every gradient and parameter within R5_F64_BOUND of the
    largest gradient's scale, and each gradient within R5_F64_LEAF_BOUND
    of its own scale plus R5_F64_FLOOR of the largest; printed, checked."""
    import numpy as np

    (gg, gp), (wg, wp) = got, want
    scale = max(float(np.abs(g).max()) for g in wg.values())
    g_err = max(float(np.abs(gg[n] - g).max()) for n, g in wg.items())
    p_err = max(float(np.abs(gp[n] - p).max()) for n, p in wp.items())

    floor = R5_F64_FLOOR * scale
    # each leaf: (max |err| over its bound, max |err| over its max |g|)
    leaves = sorted(((float(np.abs(gg[n] - g).max())
                      / (R5_F64_LEAF_BOUND * float(np.abs(g).max())
                         + floor),
                      float(np.abs(gg[n] - g).max())
                      / max(float(np.abs(g).max()), 1e-300), n)
                     for n, g in wg.items()), reverse=True)
    residue = [n for n, g in wg.items() if np.abs(g).max() < floor]
    print(f"{label} float64, one BPR step from the initial "
          f"parameters: gradients max |err| {g_err:.3e} on the largest "
          f"gradient {scale:.3e} ({g_err / scale:.3e}, limit "
          f"{R5_F64_BOUND}); each gradient against "
          f"{R5_F64_LEAF_BOUND} of its own max |g| + {R5_F64_FLOOR} of "
          f"the largest, the largest shares of the bound (and of the "
          f"leaf's own max |g|) "
          f"{[(n, f'{b:.2e}', f'{e:.2e}') for b, e, n in leaves[:3]]}; "
          f"gradients under the floor (rounding residue) {residue}; "
          f"parameters after it max |err| {p_err:.3e} (limit "
          f"{R5_F64_BOUND})")
    check(g_err <= R5_F64_BOUND * scale and p_err <= R5_F64_BOUND
          and leaves[0][0] <= 1.0,
          f"{label}: the float64 step is outside its hold")


def tgcn_rows_phase(torch, graph, card):
    """Phase R5: TGCN's neighbour tables and dedup buckets row-sharded
    over ``model`` (R5a's captured one-rank mesh, R5b's ranks).  TGCN
    launches no kernel of the port."""
    t0 = time.perf_counter()
    done = phase_timer("R5a one-rank NCCL mesh, TGCN auto hetrec")
    tgcn_one_rank(torch, graph, card)
    done()
    gc_cuda(torch)
    done = phase_timer("R5b model = 2 on one card, TGCN auto, dense_xla, ell")
    want, ranks = two_rank_results(torch, {"hetrec": graph}, "tgcn-rank",
                                   tgcn_paths, "R5b")
    for label, _, steps, _, _ in TGCN_PATHS:
        tgcn_hold(torch, label, ranks[0][label], want[label],
                  [r[label] for r in ranks], steps, card)
    done()
    gc_cuda(torch)
    print(f"phase R5: {time.perf_counter() - t0:.1f} s (host clock)")


# ------ phase R6: the kernel tiers' masks over ``model``

R6_WALL_STEPS = 10     # captured steps a timed run, with and without the mesh
R6_STEPS = 3           # BPR steps of each R6b path
# each path of R6b: (label, family, preset overrides, evaluation), each on
# its kernel tier at the preset's width on the hetrec graph; an untrained
# DisenGCN's tables all but coincide (a user's scores within about 3e-7),
# so its metrics are tie-breaks, which a sharded evaluation breaks in
# another order: its exported tables are held instead
MASK_PATHS = (("DGCF hetrec", "dgcf", {}, True),
              ("DisenGCN hetrec", "disengcn", {}, False),
              ("KGAT bi_inter hetrec", "kgat", {"agg_type": "bi_inter"}, True))
SWEEPS = ROUTING + FLASH
MASK_SEED = 11         # the seeded inputs of each path's sweeps over its rows


def sweep_rows_counts(fr, fa):
    """{kernel: (launches, mask rows swept)} of the seven sweeps."""
    return {n: (getattr(m, n).launches, getattr(m, n).rows)
            for m, names in ((fr, ROUTING), (fa, FLASH)) for n in names}


def reset_sweeps(fr, fa):
    for m, names in ((fr, ROUTING), (fa, FLASH)):
        for n in names:
            getattr(m, n).launches = getattr(m, n).rows = 0


def mask_sweep_rows(torch, fr, fa, model):
    """{kernel: [((start, stop), rows axis, [results on the host])]}: each
    sweep of the model's tier once over the rows it holds of each mask
    (the rank's block, or all of them), from seeded whole inputs at the
    path's widths: on DGCF's and DisenGCN's mask (its own transpose)
    routed_rowsum, routed_mm and routed_mm_bwd at F = 4, dx = 16 and r = 80
    (DGCF's last iteration) or 16 (DisenGCN's); on each of KGAT's row
    types' masks the stats, apply and row-backward sweeps, on its
    transpose the column sweep, at dq = dx = 64.  Every process computes
    the same inputs, so a rank's rows are held against one device's."""
    from tagrec_tpu_torch.ops import dense_adj

    out = {}

    def rows(name, mask, axis, fn):
        local, row0 = dense_adj.sweep_rows(mask)
        res = fn(local, row0)
        res = res if isinstance(res, tuple) else (res,)
        out.setdefault(name, []).append(
            ((row0, row0 + local.shape[0]), axis,
             [t.cpu().numpy() for t in res]))

    def whole(mask):
        return (mask.rows if isinstance(mask, dense_adj.MaskShard)
                else mask.shape[0])

    if model.cfg.name in ("dgcf", "disengcn"):
        mask, mask_t, e, et = model.routing_masks()
        r, base = (80, 1.0) if model.cfg.name == "dgcf" else (16, 0.0)
        q, k, x = kernel_inputs(torch, 4, whole(mask), r, 16, MASK_SEED)
        g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(MASK_SEED + 1))
        rows("routed_rowsum", mask, 1, lambda m, r0: fr.routed_rowsum(
            q, k, m, base, row0=r0, edges=e))
        rows("routed_mm", mask, 1, lambda m, r0: fr.routed_mm_rows(
            q, k, m, x, base, row0=r0, edges=e))
        rows("routed_mm_bwd", mask_t, 1, lambda m, r0: fr.routed_mm_bwd(
            q, k, m, g, base, row0=r0, edges=et))
        return out
    for a, split in enumerate(model.flash_splits()):
        mask = model.sweep_mask(f"fmask_{a}")
        mask_t = model.sweep_mask(f"fmaskT_{a}")
        ns, nd = whole(mask), whole(mask_t)
        q2, k, x, g = flash_inputs(torch, ns, nd, 64, MASK_SEED + a)
        delta = torch.randn(ns, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(MASK_SEED + 10 + a))
        rows("dot_flash_stats", mask, 0, lambda m, r0: fa.dot_flash_stats(
            q2, k, m, split, row0=r0))
        ms, zs = fa.dot_flash_stats(q2, k, mask, split)  # whole (gathered)
        rows("dot_flash_apply", mask, 0, lambda m, r0:
             fa.dot_flash_apply_rows(q2, k, m, ms, zs, x, split, row0=r0))
        rows("dot_bwd_row", mask, 1, lambda m, r0: fa.dot_bwd_row(
            q2, k, m, ms, zs, x, g, delta, split, row0=r0))
        rows("dot_bwd_col", mask_t, 0, lambda m, r0: fa.dot_bwd_col(
            q2, k, m, ms, zs, x, g, delta, split, row0=r0))
    return out


def mask_path(torch, graphs, path, mesh):
    """One path of phase R6b (an entry of MASK_PATHS) through
    ``build_pipeline(mesh=)`` and an eager ``Trainer(mesh=)`` on the
    hetrec graph (``mesh`` None: the one-device run): the masks' bytes on
    the card and their blocks, each sweep over the rows held
    (``mask_sweep_rows``); then the main path, its sweeps' launches and
    mask rows counted: the forward, an evaluation (where the path asks for
    it) and the exported tables from the initial parameters, R6_STEPS BPR
    steps, each timed.
    -> the results on the host, with the peak memory above the path's
    start and the seconds."""
    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    _, name, over, answers = path
    graph = graphs["hetrec"]
    secs, t0 = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(name, **over), tcfg,
                          device="cuda", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))
    model = pipe.model
    out = {"tier": model.tier, "bytes": model.mask_nbytes(),
           "blocks": dict(model.mask_blocks)}
    secs["build"] = time.perf_counter() - t0
    out["sweeps"] = mask_sweep_rows(torch, fr, fa, model)
    reset_sweeps(fr, fa)
    t0 = time.perf_counter()
    with torch.no_grad(), sharding.gathered():
        out["forward"] = [t.cpu().numpy() for t in model.forward()]
    out["forward_sweeps"] = sweep_rows_counts(fr, fa)
    if answers:
        out["eval"] = pipe.evaluator.run(model)
    out["export"] = serving.export_tables(model, n_item=graph.n_item)
    secs["forward_eval_export"] = time.perf_counter() - t0
    reset_sweeps(fr, fa)
    t0 = time.perf_counter()
    trainer = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [time.perf_counter()]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        last[0] = time.perf_counter()

    out["losses"] = trainer.run_phase(pipe.phases[0], max_steps=R6_STEPS,
                                      on_step=on_step)
    out["step_ms"] = times
    out["step_sweeps"] = sweep_rows_counts(fr, fa)
    secs["steps"] = time.perf_counter() - t0
    with torch.no_grad(), sharding.gathered():
        out["params"] = {n: sharding.value(model, n).detach().cpu().numpy()
                         for n in checkpoint.jax_leaf_order(model)}
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    out["seconds"] = secs
    del trainer, pipe, model
    gc_cuda(torch)
    return out


def mask_paths(torch, graphs, mesh):
    """Every path of MASK_PATHS -> {label: ``mask_path``'s results}."""
    return {path[0]: mask_path(torch, graphs, path, mesh)
            for path in MASK_PATHS}


def mask_hold(label, got, want, ranks, card):
    """A rank's R6b path against the one-device run; prints and checks:
    each rank's mask bytes exactly its blocks' (1 / ROW_RANKS of one
    device's) and its peak memory below one device's; each sweep's rows
    over the rank's block bit for bit with one device's rows; the
    forward, the evaluation, the exported tables, the losses and the
    parameters after the steps bit for bit; the ranks bit for bit; the
    launches of the forward and of the steps one device's, each over
    1 / ROW_RANKS of one device's mask rows."""
    import numpy as np

    def cut(a, blk, axis):
        return a[(slice(None),) * axis + (slice(*blk),)]

    sweeps_ok = set(got["sweeps"]) == set(want["sweeps"]) and all(
        all(np.array_equal(a, cut(b, gblk, axis))
            for a, b in zip(gres, wres))
        for k in want["sweeps"]
        for (gblk, axis, gres), (_, _, wres) in zip(got["sweeps"][k],
                                                    want["sweeps"][k]))
    cut_blocks = sum(1 for k in got["sweeps"] for (blk, _, _), (wblk, _, _)
                     in zip(got["sweeps"][k], want["sweeps"][k])
                     if blk[1] - blk[0] < wblk[1] - wblk[0])
    fwd_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["forward"], want["forward"]))
    exp_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["export"], want["export"]))
    loss_exact = np.array_equal(got["losses"], want["losses"])
    diff = [n for n in want["params"]
            if not np.array_equal(got["params"][n], want["params"][n])]
    agree = all(np.array_equal(r["losses"], got["losses"]) and all(
        np.array_equal(r["params"][n], got["params"][n])
        for n in got["params"]) for r in ranks)
    used = [k for k, (n, _) in want["step_sweeps"].items() if n]
    launches_ok = all(
        r[ph][k][0] == want[ph][k][0] and r[ph][k][1] * ROW_RANKS
        == want[ph][k][1] for r in ranks
        for ph in ("forward_sweeps", "step_sweeps") for k in SWEEPS)
    per_launch = {k: (round(got["step_sweeps"][k][1]
                            / got["step_sweeps"][k][0]),
                      round(want["step_sweeps"][k][1]
                            / want["step_sweeps"][k][0])) for k in used}
    print(f"R6b {label} (model = {ROW_RANKS}, gloo over CUDA tensors, "
          f"eager; {card}): tier {got['tier']}; mask bytes per rank "
          f"{[r['bytes'] for r in ranks]} against {want['bytes']} on one "
          f"device ({[round(r['bytes'] / want['bytes'], 4) for r in ranks]}"
          f"x), blocks {[r['blocks'] for r in ranks]}; peak memory above "
          f"the path's start per rank "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB against "
          f"{want['peak'] / 2**30:.3f}; "
          f"{sum(len(v) for v in got['sweeps'].values())} "
          f"sweeps over the rank's rows ({cut_blocks} of them cut) "
          f"{'bit for bit' if sweeps_ok else 'DIFFER'} with one device's "
          f"rows; forward {'bit for bit' if fwd_exact else 'DIFFERS'}, "
          f"evaluation {got.get('eval', 'not run')}, exported tables "
          f"{'bit for bit' if exp_exact else 'DIFFER'}, losses "
          f"{'bit for bit' if loss_exact else 'DIFFER'} "
          f"({got['losses'].sum(axis=1).tolist()}), parameters "
          f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}; ranks "
          f"{'bit for bit' if agree else 'DIFFER'}; launches a forward "
          f"{ {k: v[0] for k, v in got['forward_sweeps'].items() if v[0]} }, "
          f"over {R6_STEPS} steps "
          f"{ {k: v[0] for k, v in got['step_sweeps'].items() if v[0]} } "
          f"(one device's: {'equal' if launches_ok else 'NOT EQUAL'}), mask "
          f"rows a launch (rank, one device) {per_launch}; ms a step (host "
          f"clock, synchronised) rank 0 "
          f"{[round(t, 3) for t in got['step_ms']]}, one device "
          f"{[round(t, 3) for t in want['step_ms']]}; seconds per "
          f"rank {[rounded(r['seconds']) for r in ranks]}, one device "
          f"{rounded(want['seconds'])}")
    check(all(r["tier"] == "kernels" and r["bytes"] * ROW_RANKS
              == want["bytes"] and r["peak"] < want["peak"]
              and all(b is not None for b in r["blocks"].values())
              for r in ranks)
          and all(b is None for b in want["blocks"].values())
          and cut_blocks > 0 and used,
          f"R6b {label}: the ranks' masks are not row shards")
    check(sweeps_ok, f"R6b {label}: a sweep's rows differ from one device's")
    check(fwd_exact and exp_exact and loss_exact and not diff and agree
          and launches_ok,
          f"R6b {label}: a rank is not bit for bit with one device")
    if "eval" in want:
        check_metrics(got["eval"], want["eval"], True, f"R6b {label}")


def mask_block_holds(torch, fr, fa, graph, records):
    """The sweeps on their own over rank 1's block at ``model`` = 2, at
    the hetrec shapes: routed_rowsum, routed_mm and routed_mm_bwd over
    DGCF's mask rows [7500, 15000) at r = 80 against their plain versions
    evaluated in float64 over the same rows (the backward by the plain
    version's autograd over the whole mask, cut); KGAT row type 0's stats,
    apply and row backward over its mask rows [1024, 2048) and the column
    backward over its transpose's rows [6656, 13312), which straddle the
    split at 10240, against their plain versions (the backward in
    float64); each also bit for bit with the whole launch's rows.  Keeps
    each kernel's largest error in ``records``."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import dense_adj

    coo = graph.joint_norm_adj("plain", True)
    mask = torch.from_numpy(dense_adj.dense_mask_host(
        coo.row, coo.col, *coo.shape)).cuda()
    n = mask.shape[0]
    s0, s = n // 2, slice(n // 2, n)
    q, k, x = kernel_inputs(torch, 4, n, 80, 16, MASK_SEED)
    g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(MASK_SEED + 1))
    q64, k64, x64 = q.double(), k.double(), x.double()
    e = fr.mask_edges(mask)
    es = fr.mask_edges(mask[s], s0, e.seg_len)  # rows cut as the whole's
    cases = {
        "routed_rowsum": (
            lambda: fr.routed_rowsum(q, k, mask[s], 1.0, row0=s0, edges=es),
            lambda: fr.routed_rowsum_plain(q, k, mask[s], 1.0, row0=s0),
            lambda: fr.routed_rowsum_plain(q64, k64, mask[s], 1.0, row0=s0),
            lambda: fr.routed_rowsum(q, k, mask, 1.0, edges=e)[:, s]),
        "routed_mm": (
            lambda: fr.routed_mm_rows(q, k, mask[s], x, 1.0, row0=s0,
                                      edges=es),
            lambda: fr.routed_mm_plain(q, k, mask[s], x, 1.0, row0=s0),
            lambda: fr.routed_mm_plain(q64, k64, mask[s], x64, 1.0, row0=s0),
            lambda: fr.routed_mm_rows(q, k, mask, x, 1.0, edges=e)[:, s]),
        "routed_mm_bwd": (  # the joint mask is its own transpose
            lambda: fr.routed_mm_bwd(q, k, mask[s], g, 1.0, row0=s0,
                                     edges=es),
            lambda: fr.routed_mm_plain(k, q, mask[s], g, 1.0, row0=s0),
            lambda: plain_bwd64(torch, fr, q, k, mask, g, 1.0)[:, s],
            lambda: fr.routed_mm_bwd(q, k, mask, g, 1.0, edges=e)[:, s])}
    for name, (kern, plain, plain64, whole) in cases.items():
        got, max_abs = check_routing(torch, name, f"rows [{s0}, {n})", kern,
                                     plain, plain64)
        check(torch.equal(got, whole()),
              f"{name} over rows [{s0}, {n}) differs from the whole launch's")
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           max_abs)
    del mask, q, k, x, g, q64, k64, x64
    kgat = model_class("kgat")(graph, model_preset("kgat",
                                                   agg_type="bi_inter"),
                               device="cuda",
                               generator=torch.Generator().manual_seed(0))
    mask, mask_t = kgat.fmask_0, kgat.fmaskT_0
    split = kgat.flash_splits()[0]
    ns, nd = mask.shape
    r0, c0 = ns // 2, nd // 2
    r, c = slice(r0, ns), slice(c0, nd)
    check(c0 < split < nd, f"fmaskT_0's rows [{c0}, {nd}) miss the split")
    q2, kk, xx, gg = flash_inputs(torch, ns, nd, 64, MASK_SEED)
    m, z = fa.dot_flash_stats(q2, kk, mask, split)
    out = fa.dot_flash_apply_rows(q2, kk, mask, m, z, xx, split)
    delta = torch.sum(gg * out, dim=1)
    args = (m, z, xx, gg, delta, split)
    args64 = [t.double() for t in (m, z, xx, gg, delta)] + [split]
    q64, k64 = q2.double(), kk.double()
    mr, zr = fa.dot_flash_stats(q2, kk, mask[r], split, row0=r0)
    outr = fa.dot_flash_apply_rows(q2, kk, mask[r], m, z, xx, split, row0=r0)
    dq2r = fa.dot_bwd_row(q2, kk, mask[r], *args, row0=r0)
    dkc, dxc = fa.dot_bwd_col(q2, kk, mask_t[c], *args, row0=c0)
    torch.cuda.synchronize()
    want_m, want_z = fa.dot_flash_stats_plain(q2, kk, mask[r], split,
                                              row0=r0)
    want_dk, want_dx = fa.dot_bwd_col_plain(q64, k64, mask_t[c].T, *args64,
                                            row0=c0)
    holds = {
        "dot_flash_stats": ([(mr, want_m), (zr, want_z)], RTOL,
                            f"rows [{r0}, {ns})"),
        "dot_flash_apply": ([(outr, fa.dot_flash_apply_plain(
            q2, kk, mask[r], m, z, xx, split, row0=r0))], RTOL,
            f"rows [{r0}, {ns})"),
        "dot_bwd_row": ([(dq2r.double(), fa.dot_bwd_row_plain(
            q64, k64, mask[r], *args64, row0=r0))], BWD_RTOL,
            f"rows [{r0}, {ns})"),
        "dot_bwd_col": ([(dkc.double(), want_dk), (dxc.double(), want_dx)],
                        BWD_RTOL, f"fmaskT_0 rows [{c0}, {nd}) across the "
                        f"split {split}")}
    for name, (pairs, rtol, label) in holds.items():
        hold_flash(torch, name, f"type 0 {label}", pairs, rtol,
                   "against the plain version over the same rows "
                   + ("in float64 " if rtol == BWD_RTOL else ""), records)
    dk, dx = fa.dot_bwd_col(q2, kk, mask_t, *args)
    exact = {"dot_flash_stats": torch.equal(mr, m[r]) and torch.equal(
                 zr, z[r]),
             "dot_flash_apply": torch.equal(outr, out[r]),
             "dot_bwd_row": torch.equal(dq2r, fa.dot_bwd_row(
                 q2, kk, mask, *args)[:, r]),
             "dot_bwd_col": torch.equal(dkc, dk[c]) and torch.equal(dxc,
                                                                   dx[c])}
    print(f"R6 the flash sweeps over a block's rows against the whole "
          f"launch's rows: {exact}")
    check(all(exact.values()), "a flash sweep over a block of rows differs "
                               "from the whole launch's rows")
    del kgat
    gc_cuda(torch)


def mask_one_rank(torch, fr, graph, card):
    """R6a: DGCF at the preset's width on the hetrec graph (the routing
    kernel tier) on a one-rank NCCL mesh, its mask one row block (each
    sweep's result gathered over the one rank), captured: bit for bit
    (losses and parameters) against the same captured run without a mesh,
    DGCF_STEP routing launches each step; ms a step with and without the
    mesh, a replay's busy time and operations, and the mesh's own
    operations.  -> the mesh run's launches."""
    import torch.distributed as dist

    from tagrec_tpu_torch.ops import dense_adj
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    family = ("dgcf", {})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        plain = mesh_run(torch, graph, None, capture=True, family=family)
        reset_counts(fr, ROUTING)
        total = {k: 0 for k in ROUTING}
        checker = launch_checker(fr, ROUTING, DGCF_STEP, "R6a mesh step")

        def on_launches(steps, run):
            for k, v in checker(steps, run).items():
                total[k] += v

        meshed = mesh_run(torch, graph, mesh, capture=True,
                          on_launches=on_launches, family=family)
        model = meshed["pipe"].model
        run = meshed["trainer"].runs["bpr"]
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R6a: the mesh step was not captured")
        check(isinstance(model.sweep_mask("mask"), dense_adj.MaskShard)
              and placed == {"mask": "model"},
              f"R6a: the mask was not placed on the mesh: {placed}")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        print(f"R6a DGCF hetrec (routing kernel tier) captured on a "
              f"one-rank NCCL mesh {mesh}, {HETREC_BPR_STEPS} steps: "
              f"placement {placed}, mask block {model.mask_blocks}, "
              f"{model.mask_nbytes()} bytes "
              f"({plain['pipe'].model.mask_nbytes()} without the mesh); "
              f"launches {total}; losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R6a: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        del model
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            R6_WALL_STEPS) / R6_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"R6a captured DGCF hetrec step ({card}): ms a step over "
              f"{R6_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}")
        return total
    finally:
        dist.destroy_process_group()


def masks_phase(torch, fr, fa, graph, records, card):
    """Phase R6: the kernel tiers' masks row-sharded over ``model``: the
    sweeps over a block of rows on their own, R6a's captured one-rank
    mesh, R6b's ranks.  -> the sweeps' launches of its main paths (R6a's
    captured mesh steps, R6b's ranks)."""
    t0 = time.perf_counter()
    done = phase_timer("R6 the sweeps over a block of rows")
    mask_block_holds(torch, fr, fa, graph, records)
    done()
    done = phase_timer("R6a one-rank NCCL mesh, DGCF hetrec")
    launches = dict.fromkeys(SWEEPS, 0)
    launches.update(mask_one_rank(torch, fr, graph, card))
    done()
    gc_cuda(torch)
    done = phase_timer("R6b model = 2 on one card, DGCF, DisenGCN, KGAT")
    want, ranks = two_rank_results(torch, {"hetrec": graph}, "mask-rank",
                                   mask_paths, "R6b")
    for label, *_ in MASK_PATHS:
        rs = [r[label] for r in ranks]
        mask_hold(label, rs[0], want[label], rs, card)
        for r in rs:
            for k in SWEEPS:
                launches[k] += (r["forward_sweeps"][k][0]
                                + r["step_sweeps"][k][0])
    done()
    gc_cuda(torch)
    print(f"phase R6: {time.perf_counter() - t0:.1f} s (host clock)")
    return launches


# ------ phase R7: the chunked dense tiers over ``model``

R7_WALL_STEPS = 5  # captured KG steps a timed run, with and without the mesh
R7_STEPS = 3           # BPR steps of each R7b path
# each path of R7b: (label, family, preset overrides, over phase K's KG,
# evaluation and trajectory held), at the preset's width on the hetrec
# graph.  An untrained DisenGCN's tables all but coincide, so its metrics
# are tie-breaks, which a sharded evaluation breaks in another order, and
# its BPR gradients lie at Adam's eps (no entry of the first step's at
# 1e-6 or more), where Adam turns a last-bit change of a gradient into a
# share of lr: its exported tables are held instead of its metrics, and
# its first step's gradients and float64 step instead of its float32
# parameters after the steps
DENSE_PATHS = (
    ("DisenHAN hetrec", "disenhan", {}, False, True),
    ("KGAT over the KG", "kgat", {"agg_type": "bi_inter"}, True, True),
    ("DGCF dense_xla hetrec", "dgcf", {"adj_mode": "dense_xla"}, False, True),
    ("DisenGCN dense_xla hetrec", "disengcn", {"adj_mode": "dense_xla"},
     False, False),
    ("KGAT dense_xla hetrec", "kgat",
     {"agg_type": "bi_inter", "adj_mode": "dense_xla"}, False, True))
# a rank's bytes at model = 2, predicted from the shapes before the run
# (PERF.md section 6): its tables, and its rows of the attention
# matrix P where the path builds one
R7_PREDICTED = {"DisenHAN hetrec": (56_000_000, None),
                "KGAT over the KG": (144_500_000, 578_000_000),
                "DGCF dense_xla hetrec": (112_500_000, None),
                "DisenGCN dense_xla hetrec": (112_500_000, None),
                "KGAT dense_xla hetrec": (112_500_000, 450_000_000)}


def kg_one_rank(torch, graph, kg, card):
    """R7a: KGAT ``bi_inter`` over phase K's KG (the relation-dense tier
    under ``auto``) on a one-rank NCCL mesh, ``rel_id`` one row block,
    captured: bit for bit (losses and parameters) against the same
    captured run without a mesh; ms a step with and without the mesh, a
    replay's busy time and operations, and the mesh's own operations."""
    import torch.distributed as dist

    from tagrec_tpu_torch.ops import dense_adj
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    family = ("kgat", {"agg_type": "bi_inter"})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = make_mesh(1)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = mesh_run(torch, graph, None, capture=True, family=family,
                         kg=kg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check(plain["pipe"].model.tier == "kg_rel_dense",
              f"R7a: KGAT took {plain['pipe'].model.tier}")
        meshed = mesh_run(torch, graph, mesh, capture=True, family=family,
                          kg=kg)
        model = meshed["pipe"].model
        run = meshed["trainer"].runs["bpr"]
        placed = meshed["trainer"].placement["graph"]
        check(run.graph is not None, "R7a: the mesh step was not captured")
        check(isinstance(model.sweep_mask("rel_id"), dense_adj.MaskShard)
              and placed == {"rel_id": "model"},
              f"R7a: rel_id was not placed on the mesh: {placed}")
        diff = held_equal(torch, meshed["params"], plain["params"])
        same_loss = (meshed["losses"] == plain["losses"]).all()
        print(f"R7a KGAT over the KG (relation-dense tier) captured on a "
              f"one-rank NCCL mesh {mesh}, {HETREC_BPR_STEPS} steps: "
              f"placement {placed}, block {model.mask_blocks}, "
              f"{model.mask_nbytes()} table bytes and {model.att_nbytes} "
              f"of P ({plain['pipe'].model.mask_nbytes()} and "
              f"{plain['pipe'].model.att_nbytes} without the mesh); losses "
              f"{'bit for bit' if same_loss else 'DIFFER'} "
              f"({plain['losses'].sum(axis=1).tolist()}), parameters "
              f"{'bit for bit' if not diff else 'DIFFER: ' + str(diff)}")
        check(same_loss and not diff,
              "R7a: the one-rank mesh's captured run is not bit for bit the "
              "plain captured run")
        del model
        walls = {"plain": [], "mesh": []}
        for key in ("plain", "mesh", "mesh", "plain"):
            r = plain if key == "plain" else meshed
            walls[key].append(phase_wall_ms(torch, r["trainer"],
                                            r["pipe"].phases[0],
                                            R7_WALL_STEPS) / R7_WALL_STEPS)
        plain_run = plain["trainer"].runs["bpr"]
        run.counter.zero_()
        plain_run.counter.zero_()
        m_ops = replay_ops(torch, run.graph)
        p_ops = replay_ops(torch, plain_run.graph)
        extra, extra_ms, busy = mesh_ops(m_ops, p_ops)
        top = sorted(extra.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"R7a captured KGAT-over-the-KG step ({card}): ms a step over "
              f"{R7_WALL_STEPS} steps with one sync (plain, mesh, mesh, "
              f"plain): without the mesh {walls['plain']}, with "
              f"{walls['mesh']}; per step (host clock, synchronised) "
              f"without {plain['ms']}, with {meshed['ms']}; a replay "
              f"(profiler): device busy {busy:.4f} ms with the mesh "
              f"({sum(n for n, _ in m_ops.values()):.0f} device operations), "
              f"{sum(ms for _, ms in p_ops.values()):.4f} ms without "
              f"({sum(n for n, _ in p_ops.values()):.0f}); the mesh's own "
              f"operations {sum(n for n, _ in extra.values()):.0f} a "
              f"replay, {extra_ms:.4f} ms ({extra_ms / busy:.4f} of the busy "
              f"time); largest "
              f"{[(k[:60], n, round(ms, 4)) for k, (n, ms) in top]}; peak "
              f"memory of the run without the mesh {peak / 2**30:.3f} GiB")
    finally:
        dist.destroy_process_group()


def kgat_tier_rows(torch, graph, mesh):
    """KGAT ``bi_inter`` at hetrec on its kernel tier and on ``dense_xla``
    from one set of weights, over ``mesh`` (None: one device): each
    tier's forward (gathered) and one BPR loss's gradients on the holds'
    batch -> ({tier: (forward, gradients)} on the host, the flash
    kernels' launches)."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import flash_attention as fa

    batch = dense_xla_batch(torch, graph)
    out = {}
    reset_counts(fa, FLASH)
    for tier in ("kernels", "dense_xla"):
        model = model_class("kgat")(
            graph, model_preset("kgat", agg_type="bi_inter",
                                adj_mode=ADJ_MODE[tier]),
            device="cuda", mesh=mesh,
            generator=torch.Generator().manual_seed(0))
        check(model.tier == tier, f"KGAT: tier {model.tier}, not {tier}")
        with torch.no_grad():
            fwd = [t.cpu().numpy() for t in model.forward()]
        sum(model.bpr_loss(batch)).backward()
        out[tier] = (fwd, {n: p.grad.cpu().numpy()
                           for n, p in model.named_parameters()
                           if p.grad is not None})
        del model
        gc_cuda(torch)
    return out, counts(fa, FLASH)


def dense_path(torch, graphs, path, mesh):
    """One path of phase R7b (an entry of DENSE_PATHS) through
    ``build_pipeline(mesh=)`` and an eager ``Trainer(mesh=)`` on the
    hetrec graph, or over phase K's KG (``mesh`` None: the one-device
    run): the tables' bytes on the card, their blocks and P's bytes; from
    the initial parameters the forward, an evaluation (where the path asks
    for it) and the exported tables; R7_STEPS BPR steps, each timed (the
    first step's gradients and parameters kept); one BPR step in float64
    (``f64_step``); on KGAT ``dense_xla`` both of its tiers'
    forwards and gradients (``kgat_tier_rows``).  -> the results on the
    host, with the peak memory above the path's start and the seconds."""
    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    _, name, over, with_kg, answers = path
    graph, kg = graphs["hetrec"], graphs["kg"] if with_kg else None
    secs, t0 = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(name, **over), tcfg,
                          device="cuda", mesh=mesh, kg=kg,
                          generator=torch.Generator().manual_seed(0))
    model = pipe.model
    out = {"tier": model.tier, "bytes": model.mask_nbytes(),
           "blocks": dict(model.mask_blocks)}
    secs["build"] = time.perf_counter() - t0

    def params():  # copies: Adam updates the parameters in place
        with torch.no_grad(), sharding.gathered():
            return {n: sharding.value(model, n).detach().cpu().numpy().copy()
                    for n in checkpoint.jax_leaf_order(model)}

    t0 = time.perf_counter()
    with torch.no_grad(), sharding.gathered():
        out["forward"] = [t.cpu().numpy() for t in model.forward()]
    out["att_bytes"] = getattr(model, "att_nbytes", None)
    if answers:
        out["eval"] = pipe.evaluator.run(model)
    out["export"] = serving.export_tables(model, n_item=graph.n_item)
    secs["forward_eval_export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = Trainer(model, pipe.phases, tcfg, mesh=mesh, capture=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    times, last = [], [time.perf_counter()]

    def on_step(i, parts):
        torch.cuda.synchronize()
        times.append((time.perf_counter() - last[0]) * 1e3)
        if i == 0:  # the step from the initial parameters
            out["first"] = (gathered_grads(torch, model), params())
        last[0] = time.perf_counter()

    out["losses"] = trainer.run_phase(pipe.phases[0], max_steps=R7_STEPS,
                                      on_step=on_step)
    out["step_ms"] = times
    secs["steps"] = time.perf_counter() - t0
    out["params"] = params()
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated() - base
    del trainer, pipe, model
    gc_cuda(torch)
    t0 = time.perf_counter()
    out["f64"] = f64_step(torch, graph, (name, over), mesh, kg)
    secs["f64"] = time.perf_counter() - t0
    if name == "kgat" and not with_kg:
        t0 = time.perf_counter()
        out["tiers"] = kgat_tier_rows(torch, graph, mesh)
        secs["tiers"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def dense_paths(torch, graphs, mesh):
    """Every path of DENSE_PATHS -> {label: ``dense_path``'s results}."""
    return {path[0]: dense_path(torch, graphs, path, mesh)
            for path in DENSE_PATHS}


def dense_hold(label, got, want, ranks, card):
    """A rank's R7b path against the one-device run; prints and checks:
    each rank's table bytes (and its rows of P) exactly R7_PREDICTED, 1 /
    ROW_RANKS of one device's, and its peak below one device's; the
    forward, the evaluation and the exported tables bit for bit; the
    losses within MESH_LOSS_ATOL, the ranks bit for bit; the first step's
    gradients entry by entry within 5e-4 |g| + 1e-4 max|g| (the parallel
    tests' rule) and its parameters within 2e-6 wherever Adam's first step
    is well conditioned (|g| >= 1e-6); where the path holds its
    trajectory, at most R5_PAST_MAX entries of the parameters after the
    steps past a hundredth of lr a step; the float64 step by ``f64_hold``;
    on KGAT ``dense_xla`` its forward against the kernel tier's on the
    rank (rtol RTOL, atol ATOL).  -> the flash launches of that hold."""
    import numpy as np

    trajectory = next(p[4] for p in DENSE_PATHS if p[0] == label)
    tables, att = R7_PREDICTED[label]
    fwd_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["forward"], want["forward"]))
    exp_exact = all(np.array_equal(a, b)
                    for a, b in zip(got["export"], want["export"]))
    loss_err = float(np.abs(got["losses"] - want["losses"]).max())
    (g1, p1), (w1g, w1p) = got["first"], want["first"]
    first_err = max(float(np.abs(p1[n] - p)[np.abs(w1g[n]) >= 1e-6].max(
        initial=0.0)) for n, p in w1p.items())
    conditioned = sum(int((np.abs(g) >= 1e-6).sum()) for g in w1g.values())
    g32 = sorted(((n, float(np.abs(g1[n] - g).max())
                   / max(float(np.abs(g).max()), 1e-30))
                  for n, g in w1g.items()), key=lambda kv: -kv[1])[:3]
    g_rule = max(float((np.abs(g1[n] - g) / np.maximum(
        5e-4 * np.abs(g) + 1e-4 * np.abs(g).max(), 1e-38)).max())
        for n, g in w1g.items())
    bound = 0.01 * 0.01 * R7_STEPS  # a hundredth of TrainConfig's lr a step
    param_err, worst = max(
        (float(np.abs(got["params"][n] - want["params"][n]).max()), n)
        for n in want["params"])
    past = sum(int((np.abs(got["params"][n] - want["params"][n])
                    > bound).sum()) for n in want["params"])
    total = sum(a.size for a in want["params"].values())
    agree = all(np.array_equal(r["losses"], got["losses"]) and all(
        np.array_equal(r["params"][n], got["params"][n])
        for n in got["params"]) for r in ranks)
    print(f"R7b {label} (model = {ROW_RANKS}, gloo over CUDA tensors, "
          f"eager; {card}): tier {got['tier']}; table bytes per rank "
          f"{[r['bytes'] for r in ranks]} against {want['bytes']} on one "
          f"device ({[round(r['bytes'] / want['bytes'], 4) for r in ranks]}"
          f"x; predicted {tables}), blocks {[r['blocks'] for r in ranks]}; "
          f"P bytes per rank {[r['att_bytes'] for r in ranks]} against "
          f"{want['att_bytes']} (predicted {att}); peak memory above the "
          f"path's start per rank "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB against "
          f"{want['peak'] / 2**30:.3f}; forward "
          f"{'bit for bit' if fwd_exact else 'DIFFERS'}, evaluation "
          f"{got.get('eval', 'not run')}, exported tables "
          f"{'bit for bit' if exp_exact else 'DIFFER'}; |losses - one "
          f"device| {loss_err:.3e} (bound {MESH_LOSS_ATOL}); ranks "
          f"{'bit for bit' if agree else 'DIFFER'}; the first step's "
          f"parameters where |g| >= 1e-6 ({conditioned} entries) max |err| "
          f"{first_err:.3e} (bound 2e-6), its gradients' largest max |err| "
          f"/ max |g| {[(n, f'{e:.2e}') for n, e in g32]}, largest share "
          f"of 5e-4 |g| + 1e-4 max|g| {g_rule:.3e}; after "
          f"{R7_STEPS} steps |parameters - one device| {param_err:.3e} "
          f"({worst}), {past} of {total} entries past {bound:.1e} ("
          f"{f'at most {R5_PAST_MAX}' if trajectory else 'not held'}); ms "
          f"a BPR step (host clock, synchronised) rank 0 "
          f"{[round(t, 3) for t in got['step_ms']]}, one device "
          f"{[round(t, 3) for t in want['step_ms']]}; seconds per rank "
          f"{[rounded(r['seconds']) for r in ranks]}, one device "
          f"{rounded(want['seconds'])}")
    check(all(r["tier"] == want["tier"] and r["bytes"] == tables
              and r["bytes"] * ROW_RANKS == want["bytes"]
              and r["att_bytes"] == att
              and (att is None or r["att_bytes"] * ROW_RANKS
                   == want["att_bytes"])
              and r["peak"] < want["peak"]
              and all(b is not None for b in r["blocks"].values())
              for r in ranks)
          and all(b is None for b in want["blocks"].values()),
          f"R7b {label}: the ranks' tables are not the predicted row shards")
    check(fwd_exact and exp_exact,
          f"R7b {label}: the forward or the export is not one device's")
    check(loss_err <= MESH_LOSS_ATOL and agree and first_err <= 2e-6
          and g_rule <= 1.0 and (past <= R5_PAST_MAX or not trajectory),
          f"R7b {label}: a rank is outside its hold against one device")
    if "eval" in want:
        check_metrics(got["eval"], want["eval"], True, f"R7b {label}")
    f64_hold(f"R7b {label}", got["f64"], want["f64"])
    if "tiers" not in want:
        return {k: 0 for k in FLASH}
    launches = {k: sum(r["tiers"][1][k] for r in ranks) for k in FLASH}
    for who, res in [("one device", want)] + [(f"rank {i}", r) for i, r in
                                              enumerate(ranks)]:
        (kf, kg), (xf, xg) = res["tiers"][0]["kernels"], res["tiers"][0][
            "dense_xla"]
        f_err = max(float(np.abs(a - b).max()) for a, b in zip(kf, xf))
        f_ok = all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                   for a, b in zip(kf, xf))
        g_err = sorted(((n, float(np.abs(kg[n] - g).max())
                         / max(float(np.abs(g).max()), 1e-30))
                        for n, g in xg.items()), key=lambda kv: -kv[1])[:3]
        print(f"R7b {label} on {who}: the kernel tier's forward against "
              f"dense_xla's max abs {f_err:.3e} (rtol {RTOL}, atol {ATOL}) "
              f"{'ok' if f_ok else 'FAIL'}; BPR gradients' largest max "
              f"|err| / max |g| {[(n, f'{e:.2e}') for n, e in g_err]}; "
              f"flash launches {res['tiers'][1]}")
        check(f_ok, f"R7b {label}: the kernel tier's forward on {who} "
                    f"differs from dense_xla's")
    check(all(launches[k] > 0 for k in FLASH),
          f"R7b {label}: the kernel tier launched {launches} on the ranks")
    return launches


def dense_phase(torch, graph, card):
    """Phase R7: the chunked dense tiers' tables row-sharded over
    ``model``: R7a's captured one-rank mesh over the KG, R7b's ranks.
    -> the flash kernels' launches on R7b's ranks (KGAT ``dense_xla``'s
    hold against its kernel tier)."""
    from tagrec_tpu_torch.data.kg import KnowledgeGraph

    t0 = time.perf_counter()
    kg = KnowledgeGraph.synthetic(graph, **KG_SIZE)
    done = phase_timer("R7a one-rank NCCL mesh, KGAT over the KG")
    kg_one_rank(torch, graph, kg, card)
    done()
    gc_cuda(torch)
    done = phase_timer("R7b model = 2 on one card, DisenHAN, the KG, "
                       "dense_xla")
    want, ranks = two_rank_results(torch, {"hetrec": graph, "kg": kg},
                                   "dense-rank", dense_paths, "R7b",
                                   one_cmd="dense-one")
    launches = {k: 0 for k in FLASH}
    for label, *_ in DENSE_PATHS:
        rs = [r[label] for r in ranks]
        got = dense_hold(label, rs[0], want[label], rs, card)
        launches = {k: launches[k] + got[k] for k in FLASH}
    done()
    gc_cuda(torch)
    print(f"phase R7: {time.perf_counter() - t0:.1f} s (host clock)")
    return launches


# ------------------------------------------ phase E: the EdgeMap tier

EM_F, EM_DK = 4, 16  # DGCF's factors and factor width
DGCF_10X_BPR_STEPS = 5
KG_PARALLEL = 3000   # triples repeated under another relation


def edgemap_bound(em, f, d):
    """(bound ms, "bytes" or "operations", gathered-rows ms) of one
    ``edge_reduce`` over ``em`` with a leading axis of ``f`` and rows of
    ``d`` floats: each input read once (vals and ids of the real edges,
    deg, x) and the output written once, against 2·f·E·d operations; and
    the time of the rows it gathers (f·E·(4d + 8) bytes) at the memory
    rate, beside it."""
    n_rows = int(em.f_inv.shape[0])
    n_cols = int(em.b_inv.shape[0])
    edges = sum(int(dg_.sum()) for dg_ in em.f_deg)
    io = f * edges * 4 + edges * 4 + n_rows * 4 + 2 * f * max(
        n_rows, n_cols) * d * 4
    t_bytes = io / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * f * edges * d / PEAK_F32_OPS_PER_S * 1e3
    gathered = f * edges * (4 * d + 8) / PEAK_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", gathered)


def plain_edge_reduce(torch, dg, em, vals, x):
    """``edge_reduce``'s value from ``gather_reduce_plain``, bucket by
    bucket and factor by factor (in the dtype of ``vals`` and ``x``)."""
    outs = []
    for v, idx, deg in zip(vals, em.f_idx, em.f_deg):
        if idx.shape[1] == 0:
            outs.append(x.new_zeros((x.shape[0], idx.shape[0], x.shape[-1])))
            continue
        outs.append(torch.stack([dg.gather_reduce_plain(x[f], idx, v[f], deg)
                                 for f in range(x.shape[0])]))
    return torch.cat(outs, dim=1)[:, em.f_inv]


def block_diagonal_csr(torch, em, vals):
    """The f block-diagonal [f·n, f·m] CSR matrix of ``edge_reduce``'s
    per-factor adjacency (the values of ``vals``): one ``torch.sparse.mm``
    computes the same function."""
    f = vals[0].shape[0]
    n, m = int(em.f_inv.shape[0]), int(em.b_inv.shape[0])
    rows, cols, v = [], [], []
    for val, idx, r, deg in zip(vals, em.f_idx, em.f_rows, em.f_deg):
        keep = (torch.arange(idx.shape[1], device=deg.device)[None, :]
                < deg[:, None])
        rr = r.long()[:, None].expand_as(idx)[keep]
        cc = idx.long()[keep]
        for k in range(f):
            rows.append(rr + k * n)
            cols.append(cc + k * m)
            v.append(val[k][keep])
    a = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(v), (f * n, f * m))
    return a.coalesce().to_sparse_csr()


def raw_hold(torch, label, got, want, rtol=BWD_RTOL):
    """A float32 result against its float64 reference, on the reference's
    scale: every entry within rtol |want| + RTOL max|want|."""
    got, want = got.double(), want.double()
    if not want.numel():  # a zero-width bucket's slots
        return True, 0.0
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=RTOL * scale))
    print(f"  {label}: max abs err {err:.3e}, scale {scale:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    return ok, err


def edgemap_primitives_phase(torch, dg, graph, records):
    """The ``ops.edgemap`` primitives at DGCF's hetrec shapes (the joint
    graph's EdgeMap, F = 4, dk = 16): ``edge_reduce`` on the card (the
    ``gather_reduce`` kernel, one launch a factor and non-empty bucket)
    against ``gather_reduce_plain`` evaluated in float64; ``edge_dot``,
    ``edge_gather``, ``edge_vgather`` and ``rows_gather`` against the same
    function on the CPU; each Function's backward (float32) against the
    plain autograd of its raw form in float64; ``edge_reduce`` timed (CUDA
    events and device time) beside its plain version and one
    ``torch.sparse.mm`` over the block-diagonal matrix, with its bound.
    Adds the ``edgemap`` record to ``gather_reduce``'s."""
    from tagrec_tpu_torch.ops import edgemap

    done = phase_timer("EdgeMap primitives")
    coo = graph.joint_norm_adj("plain", True)
    t0 = time.perf_counter()
    host = edgemap.build_edge_map(coo.row, coo.col, coo.val, *coo.shape)
    build_s = time.perf_counter() - t0
    em, em_cpu = edgemap.to_device(host, "cuda"), edgemap.to_device(host,
                                                                     "cpu")
    n, edges = coo.shape[0], len(coo.row)
    live = sum(1 for i in em.f_idx if i.shape[1])
    shapes = [f"{i.shape[0]}x{i.shape[1]}" for i in em.f_idx]
    print(f"DGCF hetrec EdgeMap: {edges} edges, {n} rows, buckets "
          f"{', '.join(shapes)}; host build {build_s:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    masks = em.masks()
    vals = tuple(torch.softmax(randn(EM_F, *i.shape), dim=0) * m
                 for i, m in zip(em.f_idx, masks))
    x = randn(EM_F, n, EM_DK)
    reset_counts(dg, ("gather_reduce",))
    got = edgemap.edge_reduce(em, vals, x)
    torch.cuda.synchronize()
    check(dg.gather_reduce.launches == EM_F * live,
          f"edge_reduce launched gather_reduce {dg.gather_reduce.launches} "
          f"times, expected {EM_F} x {live}")
    want = plain_edge_reduce(torch, dg, em, [v.double() for v in vals],
                             x.double())
    err = float((got.double() - want).abs().max())
    ok = bool(torch.allclose(got.double(), want, rtol=RTOL, atol=ATOL))
    print(f"edge_reduce (kernel) against gather_reduce_plain in float64: "
          f"max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "edge_reduce disagrees with its plain version")

    # the gathers against the same function on the CPU
    a, b, v1 = randn(EM_F, n, EM_DK), randn(EM_F, n, EM_DK), randn(EM_F, n)
    cases = {"edge_dot": (edgemap.edge_dot, (a, b)),
             "edge_gather": (edgemap.edge_gather, (v1,)),
             "edge_vgather": (edgemap.edge_vgather, (b,)),
             "rows_gather": (edgemap.rows_gather, (a,))}
    for name, (fn, args) in cases.items():
        card = fn(em, *args)
        cpu = fn(em_cpu, *(t.cpu() for t in args))
        errs = [float((c.cpu() - w).abs().max()) if w.numel() else 0.0
                for c, w in zip(card, cpu)]
        same = all(torch.allclose(c.cpu(), w, rtol=RTOL, atol=ATOL)
                   for c, w in zip(card, cpu))
        print(f"{name} on the card against the CPU: max_abs_err "
              f"{max(errs):.3e} {'ok' if same else 'FAIL'}")
        check(same, f"{name} on the card disagrees with the CPU")

    # each Function's backward against the plain autograd of its raw form
    raw = {"edge_reduce": lambda e, vs, xx: edgemap._reduce_raw(e, vs, xx),
           "edge_dot": lambda e, p, q: edgemap._dot_raw(e, p, q),
           "edge_gather": lambda e, p: edgemap._gather_raw(e, p),
           "edge_vgather": lambda e, p: edgemap._vgather_raw(e, p),
           "rows_gather": lambda e, p: edgemap._rows_gather_raw(e, p)}
    cases["edge_reduce"] = (edgemap.edge_reduce, (vals, x))
    print("EdgeMap Functions' backwards (float32, the kernel under "
          "edge_reduce and edge_dot) against autograd of the raw forms in "
          f"float64 (entries within {BWD_RTOL} |g| + {RTOL} max|g|):")
    bwd_ok = True
    for name, (fn, args) in cases.items():
        def leaves(dtype):
            return [tuple(t.detach().to(dtype).requires_grad_() for t in arg)
                    if isinstance(arg, tuple)
                    else arg.detach().to(dtype).requires_grad_()
                    for arg in args]

        outs = {}
        for label, f_, dtype in (("fn", fn, torch.float32),
                                 ("raw", raw[name], torch.float64)):
            ins = leaves(dtype)
            out = f_(em, *ins)
            out = out if isinstance(out, tuple) else (out,)
            cg = torch.Generator(device="cuda").manual_seed(3)
            sum((o * torch.randn(o.shape, generator=cg, device="cuda"
                                 ).to(dtype)).sum() for o in out).backward()
            outs[label] = [g for t in ins for g in (
                [u.grad for u in t] if isinstance(t, tuple) else [t.grad])]
        if name == "edge_reduce":  # d vals lives on the real slots only
            outs["raw"] = [g * m if i < len(masks) else g for i, (g, m) in
                           enumerate(zip(outs["raw"], masks + (None,)))]
        for i, (g, w) in enumerate(zip(outs["fn"], outs["raw"])):
            bwd_ok &= raw_hold(torch, f"{name} d input {i}", g, w)[0]
    check(bwd_ok, "an EdgeMap Function's backward disagrees with autograd")

    # time edge_reduce
    kern = lambda: edgemap.edge_reduce(em, vals, x)  # noqa: E731
    lib_a = block_diagonal_csr(torch, em, vals)
    lib = lambda: torch.sparse.mm(lib_a, x.reshape(-1, EM_DK))  # noqa: E731
    lib_err = float((lib().reshape(EM_F, n, EM_DK) - got).abs().max())
    ms = time_ms(torch, kern, runs=15)
    dev = device_ms(torch, kern)
    in_graph = graph_ms(torch, kern)
    plain_ms = time_ms(torch, lambda: plain_edge_reduce(torch, dg, em, vals,
                                                        x), runs=5)
    lib_ms = time_ms(torch, lib, runs=15)
    lib_dev = device_ms(torch, lib)
    bound, by, gathered = edgemap_bound(em, EM_F, EM_DK)
    print(f"edge_reduce at DGCF hetrec (F={EM_F}, D={EM_DK}, {EM_F * live} "
          f"launches): kernel {ms:.4f} ms (median of 15), device "
          f"{dev:.4f} ms, replayed in a CUDA graph {in_graph:.4f} ms (CUDA "
          f"events); plain {plain_ms:.4f} ms; torch.sparse.mm "
          f"(block-diagonal CSR, differs by {lib_err:.3e}) {lib_ms:.4f} ms, "
          f"device {lib_dev:.4f} ms; bound {bound:.4f} ms ({by}); its "
          f"gathered rows at the memory rate {gathered:.4f} ms")
    records["gather_reduce"]["edgemap"] = {
        "shape": (f"edge_reduce over DGCF's hetrec EdgeMap: F={EM_F}, "
                  f"D={EM_DK}, {edges} edges, buckets {', '.join(shapes)}"),
        "launches_per_call": EM_F * live, "max_abs_err": err, "ms": ms,
        "device_ms": dev, "graph_ms": in_graph, "plain_ms": plain_ms,
        "library_ms": lib_ms,
        "library_device_ms": lib_dev, "bound_ms": bound, "bound_by": by}
    del em, em_cpu, vals, x, lib_a
    gc_cuda(torch)
    done()


def kg_fallback_phase(torch, dg, graph):
    """KGAT ``bi_inter`` over the phase-K KG with ``KG_PARALLEL`` triples
    repeated under another relation, which ``rel_id_host`` refuses, so the
    model takes the EdgeMap tier: held against the per-edge float64
    computation (``kg_runs``, ``hold_tiers``), then 3 BPR and 3 TransE
    steps, one BPR step profiled.  Returns its ``gather_reduce``
    launches."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("KGAT KG EdgeMap fallback")
    kg = parallel_kg(graph)
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("kgat", agg_type="bi_inter"),
                          tcfg, kg=kg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    model = pipe.model
    check(model.tier == "ell",
          f"KGAT KG with parallel edges: tier {model.tier}, not ell")
    emk = model.edges["emk"]
    print(f"KGAT KG + {KG_PARALLEL} parallel triples: "
          f"{len(kg.all_triplet)} triples, N = {model.n}; the EdgeMap tier "
          f"built in {time.perf_counter() - t0:.1f} s; keyed map "
          f"{int(emk.f_inv.shape[0])} rows in buckets "
          f"{[tuple(i.shape) for i in emk.f_idx]}")
    reset_counts(dg, ("gather_reduce",))
    runs = kg_runs(torch, graph, kg, model, dense_xla_batch(torch, graph))
    launches = dg.gather_reduce.launches
    check(launches > 0, "KGAT KG EdgeMap: no gather_reduce launch")
    check(hold_tiers(torch, "KGAT KG EdgeMap", runs["kern"], runs["plain"],
                     runs["ref"], "EdgeMap tier against the per-edge "
                     "computation"),
          "KGAT KG: the EdgeMap tier disagrees with the per-edge "
          "computation")
    del runs
    gc_cuda(torch)
    bpr, transe = pipe.phases
    trainer = Trainer(model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dg, ("gather_reduce",))
    training_steps(torch, trainer, bpr, KG_BPR_STEPS, "KGAT KG EdgeMap BPR")
    training_steps(torch, trainer, transe, KG_TRANSE_STEPS,
                   "KGAT KG EdgeMap TransE")
    launches += dg.gather_reduce.launches
    print(f"KGAT KG EdgeMap training: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"gather_reduce launches over the hold and the steps {launches}")
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch),
                   "KGAT KG EdgeMap BPR step", EDGEMAP_NAMES)
    del pipe, model, trainer
    gc_cuda(torch)
    done()
    return launches


def edge_dot_reference(torch, em, a, b, chunk=1 << 20):
    """``edge_dot``'s value edge by edge over the real slots (0 on the
    pads), in chunks of ``chunk`` edges: a computation of its own, apart
    from ``_dot_bucket``'s row chunks."""
    out = []
    for idx, rows, deg in zip(em.f_idx, em.f_rows, em.f_deg):
        keep = (torch.arange(idx.shape[1], device=idx.device)[None, :]
                < deg[:, None])
        r = rows.long()[:, None].expand_as(idx)[keep]
        c = idx.long()[keep]
        full = a.new_zeros(a.shape[:-2] + tuple(idx.shape))
        if len(r):
            full[..., keep] = torch.cat(
                [(a[..., r[i:i + chunk], :] * b[..., c[i:i + chunk], :]
                  ).sum(-1) for i in range(0, len(r), chunk)], dim=-1)
        out.append(full)
    return out


def edgemap_10x_holds(torch, dg, em, f, d, live):
    """``edge_reduce`` at DGCF's 10x buckets on inputs as the forward gives
    them (routing weights: a softmax over the factors times the masks; x
    scaled by each row's rsqrt degree), held against
    ``gather_reduce_plain`` in float64 at RTOL/ATOL; its backward (dx, the
    kernel over the transpose, and d vals, the row-chunked ``_dot_raw``)
    and one ``edge_dot`` (row-chunked where a bucket's gather is over
    ``EDGEMAP_GATHER_BUDGET_BYTES``) against float64 references; then
    timed, beside one ``torch.sparse.mm`` over the factors' block-diagonal
    CSR.  -> the record's measured fields."""
    from tagrec_tpu_torch.ops import edgemap

    chunks = [edgemap._row_chunk_for(i.shape[0], i.shape[1], d, 4, (f,))
              for i in em.f_idx]
    print(f"DGCF 10x EdgeMap row-chunk size a bucket (0: one piece): "
          f"{chunks}")
    check(any(chunks), "DGCF 10x: no bucket takes the row-chunked path")
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    vals = tuple(torch.softmax(randn(f, *i.shape), dim=0) * m
                 for i, m in zip(em.f_idx, em.masks()))
    deg = torch.cat([v.sum(dim=2) for v in vals], dim=1)[:, em.f_inv]
    x = randn(f, em.f_inv.shape[0], d) * torch.where(
        deg > 0, torch.rsqrt(deg.clamp_min(1e-30)), 0.0)[:, :, None]
    leaves = [t.detach().requires_grad_() for t in (x,) + vals]
    got = edgemap.edge_reduce(em, leaves[1:], leaves[0])
    g = randn(*got.shape)
    got.backward(g)
    want = plain_edge_reduce(torch, dg, em, [v.double() for v in vals],
                             x.double())
    err = float((got.detach().double() - want).abs().max())
    ok = bool(torch.allclose(got.detach().double(), want, rtol=RTOL,
                             atol=ATOL))
    print(f"edge_reduce (kernel) at DGCF 10x against gather_reduce_plain in "
          f"float64: max_abs_err {err:.3e}, scale "
          f"{float(want.abs().max()):.3e} (rtol {RTOL}, atol {ATOL}) "
          f"{'ok' if ok else 'FAIL'}")
    del want
    emt = em.transpose()
    dx = plain_edge_reduce(torch, dg, emt, [t.double() for t in
                                            edgemap.transpose_vals(em, vals)],
                           g.double())
    ok &= raw_hold(torch, "edge_reduce d x (the kernel over the transpose)",
                   leaves[0].grad, dx)[0]
    del dx
    x64, g64 = x.double(), g.double()
    dvals = edge_dot_reference(torch, em, g64, x64)
    for i, (v, w) in enumerate(zip(leaves[1:], dvals)):
        ok &= raw_hold(torch, f"edge_reduce d vals, bucket {i}", v.grad, w)[0]
    with torch.no_grad():
        dots = edgemap.edge_dot(em, g, x)
    dot_err = 0.0
    for i, (s, w) in enumerate(zip(dots, dvals)):
        if w.numel():
            dot_err = max(dot_err, float((s.double() - w).abs().max()))
            ok &= bool(torch.allclose(s.double(), w, rtol=RTOL, atol=ATOL))
    print(f"edge_dot at DGCF 10x against the per-edge float64 computation: "
          f"max_abs_err {dot_err:.3e} (rtol {RTOL}, atol {ATOL})")
    check(ok, "DGCF 10x: edge_reduce or edge_dot disagrees with its "
              "float64 reference")
    del leaves, got, g, dvals, dots, x64, g64, emt
    gc_cuda(torch)
    kern = lambda: edgemap.edge_reduce(em, vals, x)  # noqa: E731
    ms, dev = time_ms(torch, kern, runs=15), device_ms(torch, kern)
    in_graph = graph_ms(torch, kern)
    bound, by, gathered = edgemap_bound(em, f, d)
    # one torch.sparse.mm over the factors' block-diagonal CSR: the same
    # function, timed beside the kernel as at hetrec
    n = em.f_inv.shape[0]
    lib_a = block_diagonal_csr(torch, em, vals)
    lib = lambda: torch.sparse.mm(lib_a, x.reshape(-1, d))  # noqa: E731
    lib_err = float((lib().reshape(f, n, d) - kern()).abs().max())
    lib_ms, lib_dev = time_ms(torch, lib, runs=15), device_ms(torch, lib)
    print(f"edge_reduce at DGCF 10x ({f * live} launches): kernel {ms:.4f} "
          f"ms (median of 15), device {dev:.4f} ms, replayed in a CUDA graph "
          f"{in_graph:.4f} ms (CUDA events); torch.sparse.mm (block-diagonal "
          f"CSR, {lib_a._nnz()} values, differs by {lib_err:.3e}) "
          f"{lib_ms:.4f} ms, device {lib_dev:.4f} ms; bound {bound:.4f} ms "
          f"({by}); its gathered rows at the memory rate {gathered:.4f} ms")
    del lib_a
    return {"max_abs_err": err, "edge_dot_max_abs_err": dot_err, "ms": ms,
            "device_ms": dev, "graph_ms": in_graph, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "library_max_abs_err": lib_err}


def dgcf_10x_phase(torch, dg, graph, records, tmp):
    """DGCF at the preset's full width on the 10x graph (150,000 nodes,
    past the dense budget: ``auto`` takes the EdgeMap tier): the host
    build timed, ``DGCF_10X_BPR_STEPS`` BPR steps through the Trainer with
    each step's ``gather_reduce`` launches checked, the peak memory, one
    step profiled, one evaluation of every test user, ``export_tables``
    and 3 top-k requests against the host reference; then
    ``edgemap_10x_holds`` at these buckets.  Returns the launches."""
    import math

    import numpy as np

    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.training.train import Trainer

    done = phase_timer("DGCF 10x (EdgeMap)")
    gc_cuda(torch)
    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("dgcf"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda")
    model = pipe.model
    build_s = time.perf_counter() - t0
    check(model.tier == "ell" and model.mask is None,
          f"DGCF 10x: auto took the {model.tier} tier, not ell")
    em = model.edges["em"]
    live_f = sum(1 for i in em.f_idx if i.shape[1])
    live_b = sum(1 for i in em.b_idx if i.shape[1])
    slots = sum(i.numel() for i in em.f_idx)
    edges = sum(int(d.sum()) for d in em.f_deg)
    cfg = model.cfg
    # a forward reduces every routing iteration; the backward only the
    # last of each layer (the others feed the detached score update)
    layers = len(cfg.dim_layer_list)
    per_fwd = layers * cfg.iterate_k * cfg.factor_k * live_f
    per_step = per_fwd + layers * cfg.factor_k * live_b
    print(f"DGCF 10x: {model.num_list} nodes, {edges} edges in {slots} "
          f"slots, forward buckets {[tuple(i.shape) for i in em.f_idx]}; "
          f"pipeline (EdgeMap, samplers, evaluator) built in {build_s:.1f} s "
          f"(host and transfer); gather_reduce {per_fwd} launches a forward, "
          f"{per_step} a BPR step")
    (bpr,) = pipe.phases
    trainer = Trainer(model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dg, ("gather_reduce",))
    total = training_steps(
        torch, trainer, bpr, DGCF_10X_BPR_STEPS, "DGCF 10x BPR",
        launch_checker(dg, ("gather_reduce",), {"gather_reduce": per_step},
                       "DGCF 10x"))["gather_reduce"]
    print(f"DGCF 10x BPR: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    batch = bpr.make_batch(trainer.generator, 0, None, bpr.data)
    profile_device(torch, lambda: trainer.step(bpr, batch),
                   "DGCF 10x BPR step", EDGEMAP_NAMES)
    reset_counts(dg, ("gather_reduce",))
    t0 = time.perf_counter()
    res = pipe.evaluator.run(model)
    eval_s = time.perf_counter() - t0
    print(f"DGCF 10x evaluation of {len(graph.user_items['test'])} test users:"
          f" {eval_s:.3f} s (host clock) {json.dumps(res)}")
    check(all(math.isfinite(v) for vs in res.values() for v in vs)
          and 0.0 < res["auc"][0] < 1.0, f"DGCF 10x evaluation results {res}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    print(f"DGCF 10x export_tables: forward "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
    got = dg.gather_reduce.launches
    check(got == 2 * per_fwd, f"DGCF 10x evaluation and export: "
                              f"{got} launches, expected 2 x {per_fwd}")
    total += got
    check(u_t.shape == (graph.n_user, 64) and i_t.shape == (graph.n_item, 64)
          and np.isfinite(u_t).all() and np.isfinite(i_t).all(),
          f"DGCF 10x tables {u_t.shape} {i_t.shape}, or not finite")
    serve_requests(torch, graph, u_t, i_t, tmp, "dgcf_10x")
    f_, d_ = cfg.factor_k, model.dim_k
    del trainer
    capture_hold(torch, "DGCF 10x EdgeMap", model, pipe.phases, tcfg)
    del pipe, model
    gc_cuda(torch)
    records["gather_reduce"]["edgemap"]["dgcf_10x"] = dict(
        edges=edges, slots=slots, launches_per_forward=per_fwd,
        launches_per_bpr_step=per_step,
        **edgemap_10x_holds(torch, dg, em, f_, d_, live_f))
    del em
    gc_cuda(torch)
    done()
    return total


def run(torch):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import _build
    from tagrec_tpu_torch.ops import dma_gather as dg
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr
    from tagrec_tpu_torch.training.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CAPTURED.clear()
    card = gpu_name_and_limit()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = _build.build(["routed_rowsum", "routed_mm", "dot_flash_stats",
                            "dot_flash_apply", "dot_flash_bwd_row",
                            "dot_flash_bwd_col", "gather_reduce",
                            "gather_rows"])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, parallel)")
    for name, out in reports.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:  # a kernel's mangled name
                entry = line.split("'")[1][:40]
            elif "Used" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}")

    t0 = time.perf_counter()
    graph = synthetic_graph_large(N_USER, N_ITEM, N_TAG, N_EDGES, TAG_PER_INTER,
                                  seed=0)
    model = model_class("dgcf")(graph, model_preset("dgcf"), device="cuda",
                                generator=torch.Generator().manual_seed(0))
    print(f"graph {graph.num} and DGCF built in "
          f"{time.perf_counter() - t0:.1f} s")

    mask, mask_t, e, et = model.routing_masks()
    records = kernel_phase(torch, fr, mask, mask_t, e, et)
    disengcn_kernel_phase(torch, fr, mask, mask_t, e, et, records)
    del mask, mask_t, e, et
    asymmetric_mask_check(torch, fr, records)
    with tempfile.TemporaryDirectory() as tmp:
        launches = serving_phase(torch, fr, graph, model, tmp)
    small_graph_check(torch)
    del model
    torch.cuda.empty_cache()
    trained = dgcf_training_phase(torch, fr, graph)
    with tempfile.TemporaryDirectory() as tmp:
        disen = disengcn_phase(torch, fr, graph, tmp)
    launches = {k: launches[k] + trained[k] + disen[k] for k in ROUTING}
    print(f"routing launches over DGCF's export and {ROUTED_BPR_STEPS} steps "
          f"and DisenGCN's {ROUTED_BPR_STEPS} steps, export and evaluation: "
          f"{launches}")

    t0 = time.perf_counter()
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("kgat", agg_type="bi_inter"),
                          tcfg, generator=torch.Generator().manual_seed(0),
                          device="cuda")
    print(f"KGAT bi_inter and its phases built in "
          f"{time.perf_counter() - t0:.1f} s")
    records.update(flash_kernel_phase(torch, fa, pipe.model))
    with tempfile.TemporaryDirectory() as tmp:
        served = kgat_serving_phase(torch, fa, graph, pipe.model, tmp)
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    trained = kgat_training_phase(torch, fa, pipe, trainer)
    launches.update({name: served[name] + trained[name] for name in FLASH})
    print(f"KGAT launches over the export and the {KGAT_BPR_STEPS} + "
          f"{KGAT_TRANSE_STEPS} steps: {launches}")
    kgat_small_graph_check(torch)
    capture_hold(torch, "KGAT bi_inter", pipe.model, pipe.phases, tcfg)
    del pipe, trainer
    gc_cuda(torch)

    held = dense_xla_phase(torch, graph, fr, fa, dg)
    launches = {k: launches[k] + held[k] for k in launches}
    # gather_reduce's launches on the EdgeMap tier (phase E)
    em_launches = held["gather_reduce"]
    print(f"kernel-tier and EdgeMap-tier launches over the dense_xla holds: "
          f"{held}")
    with tempfile.TemporaryDirectory() as tmp:
        ngcf_hetrec_phase(torch, dg, graph, tmp)
        em_launches += disenhan_phase(torch, graph, tmp)

    gather_records, gather_launches, graph_10x = lightgcn_paths(torch, dg,
                                                                graph)
    records.update(gather_records)
    launches.update(gather_launches)
    edgemap_primitives_phase(torch, dg, graph, records)
    with tempfile.TemporaryDirectory() as tmp:
        em_launches += dgcf_10x_phase(torch, dg, graph_10x, records, tmp)
    gc_cuda(torch)
    with tempfile.TemporaryDirectory() as tmp:
        kg_phase(torch, graph, tmp)
        em_launches += kg_fallback_phase(torch, dg, graph)
        tgcn_phase(torch, dg, graph, tmp, records)
    tgcn_cli_run(torch, card)
    launches["gather_reduce"] += em_launches
    print(f"gather_reduce launches on the EdgeMap tier (the ell holds, "
          f"DisenHAN, DGCF 10x, the KG fallback): {em_launches}")

    done = phase_timer("CLI")
    cli = cli_phase(torch, fr, card)
    done()
    launches.update({k: launches[k] + cli[k] for k in ROUTING})
    print(f"routing launches over the CLI's runs A, B and C: {cli}")
    meshed = mesh_phase(torch, fr, graph, card)
    launches.update({k: launches[k] + meshed[k] for k in ROUTING})
    print(f"routing launches over phase P's captured one-rank mesh steps: "
          f"{meshed}; over every path: { {k: launches[k] for k in ROUTING} }")
    rows = row_phase(torch, dg, {"10x": graph_10x, "hetrec": graph}, card)
    launches.update({k: launches[k] + rows[k] for k in GATHER})
    print(f"gather launches over phase R's main paths (R1's captured mesh "
          f"steps, R2's ranks): {rows}; over every path: "
          f"{ {k: launches[k] for k in GATHER} }")
    em_rows = em_phase(torch, dg, {"10x": graph_10x, "hetrec": graph}, card)
    launches["gather_reduce"] += em_rows
    print(f"gather_reduce launches over phase R3's main paths (R3a's "
          f"captured mesh steps, R3b's ranks): {em_rows}; over every path: "
          f"{launches['gather_reduce']}")
    em4_rows = em4_phase(torch, dg, {"10x": graph_10x, "hetrec": graph},
                         card)
    del graph_10x
    launches["gather_reduce"] += em4_rows
    print(f"gather_reduce launches over phase R4's main paths (R4a's "
          f"captured mesh steps, R4b's ranks): {em4_rows}; over every path: "
          f"{launches['gather_reduce']}")
    tgcn_rows_phase(torch, graph, card)
    masked = masks_phase(torch, fr, fa, graph, records, card)
    launches.update({k: launches[k] + masked[k] for k in SWEEPS})
    print(f"sweep launches over phase R6's main paths (R6a's captured mesh "
          f"steps, R6b's ranks): {masked}; over every path: "
          f"{ {k: launches[k] for k in SWEEPS} }")
    dense = dense_phase(torch, graph, card)
    launches.update({k: launches[k] + dense[k] for k in FLASH})
    print(f"flash launches over phase R7b's ranks (KGAT dense_xla's hold "
          f"against its kernel tier): {dense}; over every path: "
          f"{ {k: launches[k] for k in FLASH} }")

    print(f"capture phase, every path ({card}): {json.dumps(CAPTURED)}")
    slower = [f"{r['path']} {r['phase']}" for r in CAPTURED
              if r["captured_ms"] > r["eager_ms"]]
    print(f"captured steps slower than eager: {slower or 'none'}")
    apply = records["dot_flash_apply"]
    print(f"dot_flash_apply per KGAT forward: kernel {apply['ms']:.4f} ms, "
          f"scaled_dot_product_attention {apply['library_ms']:.4f} ms "
          f"({apply['library_ms'] / apply['ms']:.2f}x the kernel's time); "
          f"routed_mm at r=80: {records['routed_mm']['r80']['ms']:.4f} ms a "
          "launch")
    check(all(launches.get(name, 0) > 0 for name in records),
          f"a kernel was never launched on its main path: {launches}")
    kernels = []
    sources = {"routed_rowsum": ("routed_rowsum.cu", "flash_routing.py:112"),
               "routed_mm": ("routed_mm.cu", "flash_routing.py:98"),
               "routed_mm_bwd": ("routed_mm.cu", "flash_routing.py:175"),
               "dot_flash_stats": ("dot_flash_stats.cu",
                                   "flash_attention.py:76"),
               "dot_flash_apply": ("dot_flash_apply.cu",
                                   "flash_attention.py:110"),
               "dot_bwd_row": ("dot_flash_bwd_row.cu",
                               "flash_attention.py:125"),
               "dot_bwd_col": ("dot_flash_bwd_col.cu",
                               "flash_attention.py:145"),
               "gather_reduce": ("gather_reduce.cu", "dma_gather.py:162"),
               "gather_rows": ("gather_rows.cu", "dma_gather.py:63")}
    for name, (src, replaces) in sources.items():
        rec = records[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"tagrec_tpu_torch/csrc/{src}",
                        "replaces": f"tagrec_tpu/ops/{replaces}",
                        "launches": launches[name],
                        **{k: rec[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "device_ms",
                            "library_device_ms", "shape", "r80",
                            "disengcn", "ngcf", "tgcn", "edgemap")
                           if k in rec}})
    print(card)
    print(json.dumps({"kernels": kernels}))


def main() -> int:
    if sys.argv[1:2] == ["mesh-rank"]:  # a rank of phase P2, started by it
        return mesh_rank_main(sys.argv[2:])
    if sys.argv[1:2] == ["row-rank"]:  # a rank of phase R2, started by it
        return row_rank_main(sys.argv[2:], row_paths)
    if sys.argv[1:2] == ["em-rank"]:  # a rank of phase R3b, started by it
        return row_rank_main(sys.argv[2:], em_paths)
    if sys.argv[1:2] == ["em4-rank"]:  # a rank of phase R4b, started by it
        return row_rank_main(sys.argv[2:], em4_paths)
    if sys.argv[1:2] == ["tgcn-rank"]:  # a rank of phase R5b, started by it
        return row_rank_main(sys.argv[2:], tgcn_paths)
    if sys.argv[1:2] == ["mask-rank"]:  # a rank of phase R6b, started by it
        return row_rank_main(sys.argv[2:], mask_paths)
    if sys.argv[1:2] == ["dense-rank"]:  # a rank of phase R7b, started by it
        return row_rank_main(sys.argv[2:], dense_paths)
    if sys.argv[1:2] == ["dense-one"]:  # R7b's one-device run, started by it
        return one_device_main(sys.argv[2:], dense_paths)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        import tagrec_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of the repository (no "
              "tagrec_tpu_torch package here)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        run(torch)
    except Exception:  # every phase's failure ends the run non-zero
        traceback.print_exc()
        return 1
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all (host "
          "clock)", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
