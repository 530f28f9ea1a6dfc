"""The port's DisenHAN (dense mode) against the JAX package on the CPU.

Two layers (``dim_layer_list=(64, 64)``) and reg 1e-3, JAX's params
carried across: the forward at rtol 1e-4, atol 1e-5; the loss parts on
JAX's first resampled batch at rtol 1e-4 and every parameter's gradient at
rtol 5e-4, atol 1e-5; a 3-step Adam trajectory at rtol 5e-3.  Then the
EdgeMap tier's build (A17) and a CPU pipeline that trains and
evaluates.
"""

import numpy as np
import pytest
import torch

from tagrec_tpu.models.disenhan import REL_TYPES as JAX_REL_TYPES
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.models.disenhan import REL_TYPES
from torch_routed_parity import (STEPS, TINY, first_step, jax_trajectory,
                                 port_pipeline, trajectory)

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 5e-4
TRAJ_RTOL = 5e-3
CFG = dict(dim_layer_list=(64, 64), reg=1e-3)


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    return jax_trajectory(tiny_graph, "disenhan", CFG)


def test_relations_and_masks_are_jax_layout(jax_run):
    assert REL_TYPES == JAX_REL_TYPES
    pipe, _ = port_pipeline("disenhan", CFG, jax_run["params"])
    g = pipe.graph
    n = (g.n_user, g.n_item, g.n_tag)
    for (src, dst), m in zip(REL_TYPES, pipe.model.masks()):
        assert m.dtype == torch.bool and tuple(m.shape) == (n[src], n[dst])
    ui = g.ui_adj
    assert int(pipe.model.masks()[0].sum()) == len(np.unique(
        ui.row * g.n_item + ui.col))
    assert torch.equal(pipe.model.masks()[1], pipe.model.masks()[0].T)


def test_forward_equals_jax(jax_run):
    pipe, _ = port_pipeline("disenhan", CFG, jax_run["params"])
    with torch.no_grad():
        got = pipe.model.forward()
    assert [t.shape[1] for t in got] == [64] * 3
    for a, b in zip(got, jax_run["forward"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)


def test_loss_and_gradients_equal_jax(jax_run):
    pipe, _ = port_pipeline("disenhan", CFG, jax_run["params"])
    parts, grads = first_step(pipe.model, jax_run["batches"][0])
    np.testing.assert_allclose(parts, jax_run["parts"], rtol=RTOL, atol=1e-7)
    assert grads.keys() == jax_run["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, jax_run["grads"][name], rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=name)


def test_adam_trajectory_equals_jax(jax_run):
    pipe, trainer = port_pipeline("disenhan", CFG, jax_run["params"])
    assert pipe.phases[0].steps_per_epoch == jax_run["steps"]
    losses, counts = trajectory(pipe, trainer, jax_run["batches"])
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=TRAJ_RTOL,
                               atol=1e-6)
    assert counts == jax_run["counts"] == dict.fromkeys(counts, STEPS)


@pytest.mark.parametrize("cfg", [dict(adj_mode="ell"), None])
def test_the_edgemap_tier_raises(cfg, monkeypatch):
    """``adj_mode="ell"``, and a graph over the dense budget under
    ``auto``, which raised until the EdgeMap tier was ported (A17), build
    it: six relation EdgeMaps and no mask (held against JAX in
    test_torch_edgemap_models.py)."""
    from tagrec_tpu_torch.ops import dense_adj

    if cfg is None:
        monkeypatch.setattr(dense_adj, "DENSE_ADJ_BUDGET_BYTES", 1024)
        cfg = {}
    model = model_class("disenhan")(tsyn.synthetic_graph(**TINY),
                                    model_preset("disenhan", **cfg),
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    assert not model.dense and not list(model.named_buffers(
        recurse=False))
    graph = tsyn.synthetic_graph(**TINY)
    for (src, dst), em in zip(REL_TYPES, model.masks()):
        sizes = (graph.n_user, graph.n_item, graph.n_tag)
        assert em.f_inv.shape == (sizes[src],)
        assert em.b_inv.shape == (sizes[dst],)


def test_pipeline_trains_and_evaluates():
    pipe, trainer = port_pipeline("disenhan", dict(dim_layer_list=(64,)))
    out = trainer.run_epoch(max_steps=3)["bpr"]
    assert out.shape == (3, 2) and np.isfinite(out).all()
    res = pipe.evaluator.run(pipe.model)
    assert 0.0 < res["auc"][0] < 1.0 and len(res["ndcg"]) == 2
    groups = pipe.evaluator.run(pipe.model, group_k=2)
    assert len(groups) == 2
