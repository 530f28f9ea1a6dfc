"""The port's KGAT (dense flash tier) against the JAX package on the CPU.

With JAX's params carried across, the port must give JAX's relation edges
and flash masks array for array, its forward at rtol 1e-4, atol 1e-5, and
the BPR loss and every parameter's gradient on a fixed batch at rtol 5e-4,
atol 1e-5 (float32 on both sides, sums in another order; the gradients run
through the flash backward's longer sums).  JAX's Pallas kernels run in
interpret mode.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.kgat import KGAT as JaxKGAT
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu_torch import serving
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.data.kg import KnowledgeGraph
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import flash_attention
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.checkpoint import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CFG = dict(agg_type="bi_inter", reg=1e-4, cor_reg=1e-4)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    return dict(checkpoint._leaves(_numpy_tree(tree)))


def _batches(graph):
    rng = np.random.default_rng(4)
    bpr = np.stack([rng.integers(0, graph.n_user, 32),
                    rng.integers(0, graph.n_item, 32),
                    rng.integers(0, graph.n_item, 32)], axis=1)
    n_ids = graph.n_user + graph.n_item + graph.n_tag
    transe = np.stack([rng.integers(0, n_ids, 48), rng.integers(0, 6, 48),
                       rng.integers(0, n_ids, 48), rng.integers(0, n_ids, 48)],
                      axis=1)
    return bpr, transe


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    """JAX KGAT bi_inter: params, masks, forward, BPR and TransE losses and
    gradients on fixed batches."""
    model = JaxKGAT(tiny_graph, jax_preset("kgat", **CFG))
    assert model.dense and model.flash
    params = model.init(jax.random.PRNGKey(0))
    gdev = model.device_data()
    u, e = model.forward(params, gdev, training=False)
    bpr, transe = (jnp.asarray(b, jnp.int32) for b in _batches(tiny_graph))

    def bpr_total(p):
        return sum(model.bpr_loss(p, gdev, bpr, training=True))

    def transe_total(p):
        return sum(model.transe_loss(p, gdev, transe))

    bpr_loss, bpr_grads = jax.value_and_grad(bpr_total)(params)
    tr_loss, tr_grads = jax.value_and_grad(transe_total)(params)
    return {"params": _numpy_tree(params),
            "masks": [np.asarray(m) for m in model._flash_masks],
            "forward": (np.asarray(u), np.asarray(e)),
            "bpr": (float(bpr_loss), _named(bpr_grads)),
            "transe": (float(tr_loss), _named(tr_grads))}


def _port(params=None, **cfg):
    model = model_class("kgat")(tsyn.synthetic_graph(**TINY),
                                model_preset("kgat", **{**CFG, **cfg}),
                                device="cpu",
                                generator=torch.Generator().manual_seed(1))
    return model if params is None else params_from_jax(model, params)


def test_relation_edges_and_masks_equal_jax(tiny_graph, jax_run):
    port = tsyn.synthetic_graph(**TINY)
    want, got = tiny_graph.relation_edges(), port.relation_edges()
    assert want.keys() == got.keys()
    for r in want:
        np.testing.assert_array_equal(got[r], want[r])
    masks = _port().flash_masks()
    assert len(masks) == 3
    for m, w in zip(masks, jax_run["masks"]):
        assert m.dtype == torch.int8
        np.testing.assert_array_equal(m.numpy(), w)


def test_transposed_masks_are_buffers_of_the_masks_transposed():
    """fmaskT_a, the column backward's mask, is fmask_a's contiguous int8
    transpose, a buffer (not a parameter, so checkpoints do not change)."""
    model = _port()
    masks_t = model.flash_masks_t()
    assert len(masks_t) == 3
    for a, (m, mt) in enumerate(zip(model.flash_masks(), masks_t)):
        assert mt is getattr(model, f"fmaskT_{a}")
        assert mt.dtype == torch.int8 and mt.is_contiguous()
        torch.testing.assert_close(mt, m.T, rtol=0, atol=0)
    buffers = {n for n, _ in model.named_buffers()}
    assert buffers == {f"fmask{t}_{a}" for t in ("", "T") for a in range(3)}
    assert not any(n.startswith("fmask") for n, _ in model.named_parameters())


def test_forward_matches_jax(jax_run):
    model = _port(jax_run["params"])
    with torch.no_grad():
        u, e = model.forward()
    assert u.shape == (TINY["n_user"], 64 + 64 + 32 + 16)
    for got, want in zip((u, e), jax_run["forward"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("phase", ["bpr", "transe"])
def test_loss_and_gradients_match_jax(tiny_graph, jax_run, phase):
    model = _port(jax_run["params"])
    bpr, transe = (torch.from_numpy(b) for b in _batches(tiny_graph))
    if phase == "bpr":
        loss = sum(model.bpr_loss(bpr))
    else:
        loss = sum(model.transe_loss(transe))
    loss.backward()
    want_loss, want_grads = jax_run[phase]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL, atol=ATOL)
    for name, p in model.named_parameters():
        want = want_grads[name]
        if phase == "transe" and name.startswith("mat."):
            assert p.grad is None and not want.any()  # untouched by TransE
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_jax_checkpoint_round_trip(jax_run, tmp_path):
    path = os.path.join(tmp_path, "kgat.npz")
    jckpt.save(path, jax_run["params"])
    model = checkpoint.load(path, _port())
    assert checkpoint.jax_leaf_order(model)[:3] == ["entity", "mat.W1_0",
                                                    "mat.W1_1"]
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _named(jax_run["params"])[name])
    short = {k: v for k, v in jax_run["params"].items() if k != "relation"}
    jckpt.save(path, short)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(path, _port())


def test_export_tables_trim_to_items(jax_run):
    model = _port(jax_run["params"])
    u_t, i_t = serving.export_tables(model, n_item=TINY["n_item"])
    assert u_t.shape == (TINY["n_user"], 176)
    assert i_t.shape == (TINY["n_item"], 176)
    np.testing.assert_allclose(i_t, jax_run["forward"][1][:TINY["n_item"]],
                               rtol=RTOL, atol=ATOL)


def test_bi_agg_returns_ego_tables_without_masks(jax_run):
    model = _port(jax_run["params"], agg_type="bi_agg")
    assert not [n for n, _ in model.named_buffers()]
    before = flash_attention.dot_flash_stats.launches
    with torch.no_grad():
        u, e = model.forward()
    np.testing.assert_array_equal(u.numpy(), jax_run["params"]["user"])
    np.testing.assert_array_equal(e.numpy(), jax_run["params"]["entity"])
    assert flash_attention.dot_flash_stats.launches == before


def test_unported_tiers_raise():
    """The EdgeMap tier, which raised until it was ported (A17), builds
    under ``adj_mode="ell"``, and over a knowledge graph with parallel
    (h, t) edges, which needs it (held against JAX in
    test_torch_edgemap_models.py); ``dense_xla`` builds the joint [N, N]
    mask instead of the flash masks (held against JAX in
    test_torch_dense_xla.py)."""
    graph = tsyn.synthetic_graph(**TINY)
    gen = torch.Generator().manual_seed(0)
    model = model_class("kgat")(graph, model_preset("kgat", **CFG,
                                                    adj_mode="ell"),
                                device="cpu", generator=gen)
    assert not model.dense and not model.flash
    assert model.edges["emk"].f_idx[0].shape[1] == 0  # the empty keys
    model = model_class("kgat")(graph, model_preset("kgat", **CFG,
                                                    adj_mode="dense_xla"),
                                device="cpu", generator=gen)
    n = graph.n_user + graph.n_item + graph.n_tag
    assert [name for name, _ in model.named_buffers()] == ["mask"]
    assert model.mask.shape == (n, n) and model.mask.dtype == torch.bool
    kg = KnowledgeGraph.synthetic(graph, n_entity=120, n_triples=400,
                                  n_rela=3)
    h, r, t = kg.kg_data[0]
    kg.kg_data = np.concatenate([kg.kg_data, [[h, (r + 1) % 3, t]]])
    kg._finish_init()
    model = model_class("kgat")(graph, model_preset("kgat", **CFG),
                                device="cpu", generator=gen, kg=kg)
    assert not model.kg_rel_dense and not model.dense
    assert model.edges["em"].f_inv.shape == (graph.n_user + 120,)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig

    graph = tsyn.synthetic_graph(**TINY)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_class("kgat")(graph, model_preset("kgat", **CFG), generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline(graph, model_preset("kgat", **CFG), TrainConfig(),
                       generator=gen)
