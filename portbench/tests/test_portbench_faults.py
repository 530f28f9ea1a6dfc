"""A run of each cell's driver on the CPU at a tiny size, with the look
for a card skipped: sound, it comes out correct; with the timed path
broken underneath, or with the control (the reference in TF32) in the
program's place, it does not."""

import time

import pytest
import torch

from portbench import harness

TINY = {"n_user": 60, "n_item": 300, "n_tag": 40, "n_edges": 3000,
        "tag_per_inter": 0.3, "seed": 0}
TRAIN = ("dgcf.train-hetrec", "lightgcn.train-10x", "lightgcn.train-hetrec")


def tiny_cell(workload: str, seed: int = 1234567891011) -> harness.Cell:
    ctx = harness.cell(workload, seed, 0.05, False, "cpu", time.perf_counter())
    ctx.mix = dict(ctx.mix, graph=TINY)
    if ctx.mix["driver"] == "train":
        ctx.mix.update(train_batch=64)
    else:
        ctx.mix.update(test_batch=16)
    return ctx


def driver(ctx):
    return harness.load(f"drivers/{ctx.mix['driver']}.py")


def verdict(ctx, numbers):
    return harness.judge(ctx.limits, numbers)[0]


@pytest.mark.parametrize("workload", TRAIN + ("lightgcn.eval-10x",))
def test_sound_run_is_correct(workload):
    ctx = tiny_cell(workload)
    res = driver(ctx).run(ctx)
    assert verdict(ctx, res["checks"]), res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged_fails(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    ctx = tiny_cell(workload)
    assert not verdict(ctx, driver(ctx).run(ctx)["checks"])


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch_fails(workload, monkeypatch):
    from tagrec_tpu_torch.models import base

    inner = base.bpr_with_reg

    def half(u_all, i_all, u_src, i_src, batch, kind, reg):
        return inner(u_all, i_all, u_src, i_src, batch[:batch.shape[0] // 2],
                     kind, reg)

    monkeypatch.setattr(base, "bpr_with_reg", half)
    ctx = tiny_cell(workload)
    assert not verdict(ctx, driver(ctx).run(ctx)["checks"])


def test_altered_answer_fails(monkeypatch):
    from tagrec_tpu_torch.ops import metrics

    inner = metrics.mask_train_positives

    def altered(scores, train_pad):
        out = inner(scores, train_pad)
        out[0, 7] += 10.0
        return out

    monkeypatch.setattr(metrics, "mask_train_positives", altered)
    ctx = tiny_cell("lightgcn.eval-10x")
    assert not verdict(ctx, driver(ctx).run(ctx)["checks"])


def _auc_skipped(metrics):
    def auc(masked, test_pad, test_deg, train_deg):
        return torch.zeros((), device=masked.device)
    return "batch_auc_sum", auc


def _recall_misnormalised(metrics):
    inner = metrics.batch_metric_sums

    def sums(label, test_deg, topks):
        out = inner(label, test_deg, topks)
        out["recall"] = out["recall"] * 0.999
        return out
    return "batch_metric_sums", sums


@pytest.mark.parametrize("fault", [_auc_skipped, _recall_misnormalised])
def test_evaluator_arithmetic_fault_fails(fault, monkeypatch):
    """The AUC left out, or one metric off by a thousandth: the lists are
    right, the numbers the evaluator returns are not."""
    from tagrec_tpu_torch.ops import metrics

    monkeypatch.setattr(metrics, *fault(metrics))
    ctx = tiny_cell("lightgcn.eval-10x")
    checks = driver(ctx).run(ctx)["checks"]
    assert checks["topk_diff"] == 0.0
    assert not verdict(ctx, checks), checks


@pytest.mark.parametrize("workload", TRAIN + ("lightgcn.eval-10x",))
def test_control_fails(workload):
    """The reference computed one step below float32, put in the
    program's place."""
    from portbench import graphs

    ctx = tiny_cell(workload)
    d = driver(ctx)
    raw = graphs.make(**ctx.mix["graph"])
    if ctx.mix["driver"] == "eval":
        numbers = d.compare(d.reference_run(ctx, raw, "tf32"),
                            d.reference_run(ctx, raw, "ref"), raw, ctx.mix)
    else:
        state = d.build(ctx)
        batches = state["check"]["batches"]
        numbers = d.compare(d.reference_run(ctx, raw, batches, "tf32"),
                            d.reference_run(ctx, raw, batches, "ref"))
        numbers["batch_faults"] = 0
    assert not verdict(ctx, numbers), numbers
