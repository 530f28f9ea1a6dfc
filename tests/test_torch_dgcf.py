"""The port's DGCF serving slice against the JAX package on the CPU.

Graph data (synthetic generators, the joint adjacency, the dataset loader)
must equal JAX's exactly.  The DGCF forward, with JAX's params carried
across, must match JAX's dense flash forward (Pallas in interpret mode) at
rtol 1e-4, atol 1e-5: float32 on both sides, sums in another order.
"""

import os

import numpy as np
import jax
import pytest
import torch

from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.data import synthetic as jsyn
from tagrec_tpu.data.graph import HeteroGraph as JaxGraph
from tagrec_tpu.models.dgcf import DGCF as JaxDGCF
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import flash_routing
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.checkpoint import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    """JAX DGCF (dense + flash on this graph) params and forward tables."""
    model = JaxDGCF(tiny_graph, jax_preset("dgcf"))
    assert model.dense and model.flash
    params = model.init(jax.random.PRNGKey(0))
    embs = model.forward(params, model.device_data(), training=False)
    return params, [np.asarray(e) for e in embs]


def _port_model(seed=1):
    graph = tsyn.synthetic_graph(**TINY)
    return model_class("dgcf")(graph, model_preset("dgcf"), device="cpu",
                               generator=torch.Generator().manual_seed(seed))


def _assert_tables_close(model, want):
    with torch.no_grad():
        got = model.forward()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def _graph_arrays(g):
    out = {"num": g.num, "user_items": g.user_items, "uit": g.uit_data}
    for name in ("ui_adj", "ut_adj", "it_adj"):
        a = getattr(g, name)
        out[name] = (a.row, a.col, a.val, a.shape)
    coo = g.joint_norm_adj("plain")
    out["joint"] = (coo.row, coo.col, coo.val, coo.shape)
    out["edges"] = g.edge_index
    return out


def _assert_same_graph(a, b):
    ga, gb = _graph_arrays(a), _graph_arrays(b)
    assert ga["num"] == gb["num"] and ga["user_items"] == gb["user_items"]
    np.testing.assert_array_equal(ga["uit"], gb["uit"])
    for key in ("ui_adj", "ut_adj", "it_adj", "joint"):
        for x, y in zip(ga[key], gb[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ga["edges"].keys() == gb["edges"].keys()
    for split in ga["edges"]:
        np.testing.assert_array_equal(ga["edges"][split], gb["edges"][split])


def test_forward_matches_jax(jax_run):
    params, want = jax_run
    model = params_from_jax(_port_model(),
                            {"embed": [np.asarray(p) for p in params["embed"]]})
    _assert_tables_close(model, want)


def test_jax_checkpoint_loads_with_same_forward(jax_run, tmp_path):
    params, want = jax_run
    path = os.path.join(tmp_path, "model.npz")
    jckpt.save(path, params)
    model = checkpoint.load(path, _port_model())
    _assert_tables_close(model, want)
    # a checkpoint of another model's tree is refused, not half-loaded
    jckpt.save(path, {"embed": [np.asarray(p) for p in params["embed"][:2]]})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(path, _port_model())


@pytest.mark.parametrize("gen,kw", [
    ("synthetic_graph", TINY),
    ("synthetic_graph", dict(n_user=30, n_item=60, n_tag=12, avg_deg=5,
                             seed=3)),
    ("synthetic_graph_large", dict(n_user=50, n_item=200, n_tag=30,
                                   n_edges=1500, tag_per_inter=0.3, seed=0)),
])
def test_synthetic_graphs_equal_jax(gen, kw):
    _assert_same_graph(getattr(tsyn, gen)(**kw), getattr(jsyn, gen)(**kw))


def test_load_equals_jax(tmp_path):
    d = os.path.join(tmp_path, "ds")
    os.makedirs(d)
    # duplicate items, a repeated user line and duplicate triples
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write("0 3 1 1 4\n1 0 2\n2 5 6 2\n0 7\n3 1 5\n")
    with open(os.path.join(d, "test.txt"), "w") as f:
        f.write("0 2\n1 8\n2 0\n3 6 3\n")
    with open(os.path.join(d, "user_item_tag.txt"), "w") as f:
        f.write("0 3 0\n0 3 2\n1 2 1\n2 5 0\n2 5 0\n3 1 3\n")
    _assert_same_graph(HeteroGraph.load(str(tmp_path), "ds"),
                       JaxGraph.load(str(tmp_path), "ds"))


def test_forward_launches_no_kernel_on_cpu():
    model = _port_model()
    before = (flash_routing.routed_rowsum.launches,
              flash_routing.routed_mm.launches)
    with torch.no_grad():
        model.forward()
    assert (flash_routing.routed_rowsum.launches,
            flash_routing.routed_mm.launches) == before


def test_unported_modes_and_models_raise():
    """An unknown model raises (every model of the JAX package is
    registered, TGCN since it was ported); ``adj_mode="ell"``, which
    raised until the EdgeMap tier was ported (A17), builds it (held
    against JAX in test_torch_edgemap_models.py), with no mask;
    ``dense_xla`` builds the chunked dense tier (held against JAX in
    test_torch_dense_xla.py)."""
    graph = tsyn.synthetic_graph(**TINY)
    gen = torch.Generator().manual_seed(0)
    model = model_class("dgcf")(graph, model_preset("dgcf", adj_mode="ell"),
                                device="cpu", generator=gen)
    assert not model.dense and model.mask is None
    assert model.edges["em"].n_buckets > 1
    model = model_class("dgcf")(graph, model_preset("dgcf",
                                                    adj_mode="dense_xla"),
                                device="cpu", generator=gen)
    assert not model.flash and model.maskT is None
    with pytest.raises(ValueError, match="dgcf.*tgcn"):
        model_class("nosuch")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_class("dgcf")(tsyn.synthetic_graph(**TINY), model_preset("dgcf"),
                            generator=torch.Generator().manual_seed(0))
