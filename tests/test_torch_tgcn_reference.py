"""The port's TGCN against the benchmark's plain float64 reference
(``portbench/reference/tgcn.py``) on the CPU, and the sliced training
driver (``portbench/drivers/train_sliced.py``) on a tiny graph.

The preset's widths (d = 64, layers [64, 32, 16], k = 25) on a 130-node
``portbench.graphs`` graph; the port in float32, the reference in float64
over the port's own tables.  Tolerances, each from the float32 side's
rounding (the gaps read below a tenth of them):

* forward tables: atol 1e-6 on entries of about 0.5 (gaps 7e-8);
* loss gap 1e-6 relative;
* a leaf's gradient: the norm of its difference over the larger of its
  norm and the phase's median leaf's, 5e-3 (at most 4.6e-4, on the
  fusion biases, whose gradient sums every row of the batch);
* the change of every leaf after three Adam steps (BPR, TransTag, BPR)
  over the larger of its norm and the median leaf's, 2e-3; leaves whose
  reference gradient is under a thousandth of the median's are left out
  as the driver leaves them out: Adam scales float32 noise on a gradient
  that is zero in exact arithmetic up to a whole step.
"""

import math
import statistics

import numpy as np
import pytest
import torch

from portbench import common, graphs, harness
from portbench.reference import _common as C
from portbench.reference import tgcn as R
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig
from tagrec_tpu_torch.training import optim
from tagrec_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

SLICED = harness.load("drivers/train_sliced.py")
RAW = graphs.make(30, 80, 20, 600, tag_per_inter=0.5, seed=5)
MIX = {"graph": {"n_user": 30, "n_item": 80, "n_tag": 20, "n_edges": 600,
                 "tag_per_inter": 0.5, "seed": 5},
       "train_batch": 64, "slices": 4, "check_steps": 3, "trace_steps": 2}


def _config(adj_mode="auto"):
    cfg = dict(harness.read_json("portbench/configs/tgcn.json"))
    cfg.update(adj_mode=adj_mode, transtag_batch=32)
    return cfg


def _pipe(cfg):
    return build_pipeline(graphs.to_hetero(RAW), common.model_config(cfg),
                          TrainConfig(train_batch=64, lr=cfg["lr"]),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    bpr = np.stack([rng.integers(0, RAW.n_user, 64),
                    rng.integers(0, RAW.n_item, 64),
                    rng.integers(0, RAW.n_item, 64)], axis=1)
    tt = RAW.uit[rng.integers(0, len(RAW.uit), 32)][:, [0, 2, 1]]
    tt = np.concatenate([tt, rng.integers(0, RAW.n_item, (32, 1))], axis=1)
    return [{"bpr": torch.as_tensor(bpr)}, {"transtag": torch.as_tensor(tt)},
            {"bpr": torch.as_tensor(bpr[::-1].copy())}]


def _port_steps(model, names, steps, lr):
    """The port's loss functions and its Adam over ``steps``, as the
    Trainer steps them -> the driver's record of them."""
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]
    w0 = [p.detach().clone() for p in leaves]
    opt = optim.make_optimizer(model.parameters(), TrainConfig(lr=lr))
    losses, grad1 = [], {}
    for step in steps:
        (phase, batch), = step.items()
        opt.zero_grad(set_to_none=True)
        loss = sum(model.bpr_loss(batch) if phase == "bpr"
                   else model.transtag_loss(batch))
        loss.backward()
        losses.append(float(loss.detach()))
        if phase not in grad1:
            grad1[phase] = {n: float(torch.linalg.vector_norm(
                p.grad.double())) for n, p in zip(names, leaves)
                if p.grad is not None}
        opt.step()
    change = [float(torch.linalg.vector_norm((p.detach() - w).double()))
              for p, w in zip(leaves, w0)]
    return {"losses": losses, "grad1": grad1, "change": change}


@pytest.mark.parametrize("adj_mode", ["auto", "dense_xla"])
def test_port_matches_the_float64_reference(adj_mode):
    cfg = _config(adj_mode)
    model = _pipe(cfg).model
    assert model.tier == {"auto": "dedup", "dense_xla": "takes"}[adj_mode]
    specs = R.leaves(RAW, cfg)
    names = [n for n, _ in specs]
    w0 = R.draw_leaves(specs, 7, "cpu")
    common.load_leaves(model, specs, w0)
    ref = R.Model(RAW, cfg, model.tables_host, C.Precision("ref"), "cpu")
    with torch.no_grad():
        for a, b in zip(model.forward(), ref.forward(
                [w.double() for w in w0])):
            torch.testing.assert_close(a.double(), b, rtol=0, atol=1e-6)
    steps = _batches()
    # every leaf's gradient of each phase's loss at the drawn leaves,
    # entry by entry
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]
    w64 = [w.double().requires_grad_(True) for w in w0]
    for phase, batch in (("bpr", steps[0]["bpr"]),
                         ("transtag", steps[1]["transtag"])):
        parts = (model.bpr_loss(batch) if phase == "bpr"
                 else model.transtag_loss(batch))
        g_port = torch.autograd.grad(sum(parts), leaves, allow_unused=True)
        g_ref = torch.autograd.grad(ref.loss(phase, w64, batch), w64,
                                    allow_unused=True)
        assert [g is None for g in g_ref] == [g is None for g in g_port]
        med = statistics.median(float(g.norm()) for g in g_ref
                                if g is not None)
        for name, gp, gr in zip(names, g_port, g_ref):
            if gr is not None:
                gap = float((gp.double() - gr).norm()) / max(
                    float(gr.norm()), med)
                assert gap < 5e-3, (phase, name, gap)
    # three Adam steps, BPR, TransTag, BPR, as the driver compares them
    prog = _port_steps(model, names, steps, cfg["lr"])
    out = R.train_steps(RAW, cfg, w0, steps, C.Precision("ref"), "cpu",
                        tables=model.tables_host)
    numbers = SLICED.compare(prog, dict(out, names=names, lead="bpr"))
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad1_gap"] < 5e-3, numbers
    assert numbers["change_gap"] < 2e-3, numbers
    assert numbers["table_faults"] == 0
    assert set(out["grad1"]["transtag"]) == {"embed.0", "embed.1", "embed.2"}


def _plant(tables, fault):
    """A copy of the six tables with one slot broken."""
    tables = [(i.copy(), w.copy()) for i, w in tables]
    rels = R.relations(RAW)
    if fault == "neighbour":       # a user's item slot: an item it lacks
        idx, _ = tables[0]
        have = set(rels[0][3][rels[0][2] == 0].tolist())
        idx[0, 0] = next(i for i in range(RAW.n_item) if i not in have) + 1
    elif fault == "pad":           # a non-zero slot in a degree-0 row
        j, (n_rows, _, row, _, _) = next(
            (j, r) for j, r in enumerate(rels)
            if np.bincount(r[2], minlength=r[0]).min() == 0)
        r = int(np.flatnonzero(np.bincount(row, minlength=n_rows) == 0)[0])
        tables[j][0][r, 3] = 1
    else:                          # a weight id that is not the count
        tables[1][1][0, 0] += 1
    return tables


@pytest.mark.parametrize("fault", ["neighbour", "pad", "weight"])
def test_table_faults_catch_a_planted_fault(fault):
    cfg = _config()
    tables = _pipe(cfg).model.tables_host
    assert R.table_faults(RAW, cfg, tables) == 0
    assert R.table_faults(RAW, cfg, _plant(tables, fault)) == 1


@pytest.mark.parametrize("fault", ["none", "positive", "negative", "twice"])
def test_transtag_batch_check_catches_a_planted_fault(fault):
    rng = np.random.default_rng(3)
    trip = RAW.uit[rng.permutation(len(RAW.uit))[:64]][:, [0, 2, 1]]
    have = {tuple(r) for r in RAW.uit[:, [0, 2, 1]].tolist()}
    neg = [next(i for i in range(RAW.n_item) if (u, t, i) not in have)
           for u, t, _ in trip.tolist()]
    rows = np.concatenate([trip, np.asarray(neg)[:, None]], axis=1)
    if fault == "positive":        # an item the user never tagged so
        rows[5, 2] = rows[5, 3]
    elif fault == "negative":      # a negative that is an assignment
        rows[7, 3] = rows[7, 2]
    elif fault == "twice":         # one assignment in two rows
        rows[9] = rows[10]
    faults = R.transtag_faults(RAW, torch.as_tensor(rows).reshape(2, 32, 4))
    assert faults == (0 if fault == "none" else 1)


def test_tgcn_tables_span_and_counters_equal_the_tables():
    profiling.reset()
    profiling.enable()
    try:
        model = _pipe(_config()).model
    finally:
        profiling.disable()
    snap = profiling.snapshot()
    profiling.reset()
    spans = {s["name"]: s for s in snap["spans"]}
    tables = spans["tgcn.tables"]
    assert tables["parent"] == spans["build.model"]["id"]
    assert tables["attrs"] == {"sampler": model.sampler, "tier": "dedup"}
    buckets = [model.buckets(name)[0] for name in model.REL_ORDER]
    assert snap["counters"] == {
        "tgcn.slots": sum(i.size for i, _ in model.tables_host),
        "tgcn.buckets": sum(len(b) for b in buckets),
        "tgcn.pairs": sum(int((b[3] > 0).sum()) for bs in buckets
                          for b in bs)}
    assert snap["counters"]["tgcn.pairs"] < snap["counters"]["tgcn.slots"]


@pytest.mark.parametrize("workload", ["tgcn.train-hetrec-sliced",
                                      "dgcf.train-10x-sliced"])
def test_sliced_driver_on_a_tiny_graph(workload):
    ctx = harness.cell(workload, 2**31 + 12345, 0.0, False, "cpu", 0.0)
    ctx.mix = dict(ctx.mix, **MIX)
    if ctx.workload["config"] == "tgcn":
        ctx.config = dict(ctx.config, transtag_batch=32)
    state = SLICED.build(ctx)
    phases = state["pipe"].phases
    per = SLICED.slice_steps(phases, MIX["slices"])
    assert per == {ph.name: math.ceil(ph.steps_per_epoch / MIX["slices"])
                   for ph in phases}
    lead = per[phases[0].name]
    assert SLICED.slice_steps(phases, MIX["slices"], first=1) == {
        k: math.ceil(v / lead) for k, v in per.items()}
    win = SLICED.window(state, ctx.mix, 0.0)   # one slice: past 0 s
    assert len(win["slice_ends_s"]) == 1
    assert win["phase_steps"] == per == win["last_steps"]
    assert win["pairs"] == lead * MIX["train_batch"] == win["steps"] * 64
    faults = sum(SLICED.batch_faults(ctx, state["raw"], name,
                                     state["bufs"][name]["rows"][:n])
                 for name, n in win["last_steps"].items())
    faults += sum(SLICED.batch_faults(ctx, state["raw"], name, rows)
                  for name, rows in state["check_rows"])
    assert faults == 0
    check = state["check"]
    assert len(check["losses"]) == MIX["check_steps"] * len(phases)
    numbers = SLICED.compare(check, SLICED.reference_run(
        ctx, state["raw"], check["batches"], "ref"))
    assert numbers["loss_gap"] < 1e-6, numbers
    assert numbers["grad1_gap"] < 5e-3, numbers
    assert numbers["change_gap"] < 2e-3, numbers
    assert numbers.get("table_faults", 0) == 0
    assert ("table_faults" in numbers) == (ctx.workload["config"] == "tgcn")
