"""The EdgeMap tier (``adj_mode="ell"``) of DGCF, DisenGCN and KGAT (on
the tag graph, and over a small knowledge graph with parallel (h, t)
edges, which the relation-dense tier refuses) against the JAX package's
EdgeMap tier on the CPU, and against the port's own chunked dense tier in
float64 (``tests/torch_edgemap_parity.py`` has the tolerances); a graph
over the dense budget takes the EdgeMap tier under ``auto`` and trains.
DisenHAN's and TGCN's cases are in test_torch_edgemap_disenhan_tgcn.py.
"""

import numpy as np
import pytest
import torch

from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.ops import dense_adj, dma_gather
from tagrec_tpu_torch.training.train import Trainer
from torch_edgemap_parity import (TINY, check_equals_jax,
                                  check_equals_the_dense_tier, jax_runs)
from torch_threads import one_torch_thread  # noqa: F401

CASES = ["dgcf", "disengcn", "kgat", "kgat_kg"]


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    return jax_runs(tiny_graph)


@pytest.mark.parametrize("case", CASES)
def test_edgemap_tier_equals_jax(jax_run, case):
    check_equals_jax(jax_run, case)


@pytest.mark.parametrize("case", [c for c in CASES if c != "kgat_kg"])
def test_edgemap_tier_equals_the_dense_tier(jax_run, case):
    check_equals_the_dense_tier(jax_run, case)


@pytest.mark.parametrize("name", ["dgcf", "disengcn", "disenhan", "kgat"])
def test_auto_takes_the_edgemap_tier_past_the_budget(monkeypatch, name):
    """Under ``auto`` a graph over the dense budget builds the EdgeMap tier
    and trains through the pipeline; the per-bucket sums run through
    ``gather_reduce``'s wrapper (its plain version here)."""
    monkeypatch.setattr(dense_adj, "DENSE_ADJ_BUDGET_BYTES", 1024)
    cfg = dict(dim_layer_list=(64,), agg_type="bi_inter")
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=64)
    pipe = build_pipeline(graph, model_preset(name, **cfg), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert pipe.model.tier == "ell"
    calls = []
    plain = dma_gather.gather_reduce_plain
    monkeypatch.setattr(dma_gather, "gather_reduce_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    out = trainer.run_epoch(max_steps=2)["bpr"]
    assert out.shape == (2, len(out[0])) and np.isfinite(out).all()
    assert calls
    res = pipe.evaluator.run(pipe.model)
    assert 0.0 < res["auc"][0] < 1.0


@pytest.mark.parametrize("name, mode, cfg, tier", [
    ("dgcf", "auto", {}, "kernels"), ("dgcf", "dense_xla", {}, "dense_xla"),
    ("dgcf", "ell", {}, "ell"), ("disengcn", "auto", {}, "kernels"),
    ("disengcn", "ell", {}, "ell"), ("disenhan", "auto", {}, "dense"),
    ("disenhan", "ell", {}, "ell"),
    ("kgat", "auto", {"agg_type": "bi_inter"}, "kernels"),
    ("kgat", "dense_xla", {"agg_type": "bi_inter"}, "dense_xla"),
    ("kgat", "ell", {"agg_type": "bi_inter"}, "ell"),
    ("kgat", "ell", {"agg_type": "gcn"}, "none"),
    ("tgcn", "auto", {}, "dedup"), ("tgcn", "dense_xla", {}, "takes"),
    ("tgcn", "ell", {}, "ell")])
def test_tier_names_the_tier_built(name, mode, cfg, tier):
    """``model.tier`` says which tier ``adj_mode`` built on a small
    graph."""
    from tagrec_tpu_torch.models import model_class

    model = model_class(name)(
        tsyn.synthetic_graph(**TINY), model_preset(name, adj_mode=mode, **cfg),
        device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert model.tier == tier
    assert hasattr(model, "edges") == (tier == "ell")
