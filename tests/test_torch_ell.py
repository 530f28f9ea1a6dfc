"""The port's ELL builders and propagation against the JAX package's.

* Builders: the same COO gives the same arrays, exactly, in every form
  (single ELL, degree buckets, full dense, type sectors, hybrid hub block +
  buckets, and the forward/transpose pair of each ``build_adj_pair`` mode).
* Propagation: ``coo_spmm``, ``ell_mm``, ``ell_buckets_mm``, ``hybrid_mm``
  and ``pair_spmm`` (forward, and its gradient A^T g) on the same x and g
  equal JAX's within rtol 1e-5, atol 1e-6 (float32 sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.data.graph import COO as JaxCOO
from tagrec_tpu.ops import ell as jell
from tagrec_tpu.ops import propagate as jprop
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.data.graph import COO
from tagrec_tpu_torch.ops import ell
from tagrec_tpu_torch.ops import propagate as prop

RTOL, ATOL = 1e-5, 1e-6
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph

# (norm, mode, symmetric, sectors, hub_min_degree): every form the builders
# make.  si_norm is not symmetric, so its pair carries a transpose.
PAIRS = {
    "dense_sectors": ("bi_norm", "dense", True, True, 96),
    "dense_full": ("bi_norm", "dense", True, False, 96),
    "auto": ("bi_norm", "auto", True, True, 96),
    "hybrid_hubs": ("bi_norm", "hybrid", True, False, 12),
    "hybrid_no_hubs": ("bi_norm", "hybrid", True, False, 96),
    "hybrid_transpose": ("si_norm", "hybrid", False, False, 6),
    "sectors_transpose": ("si_norm", "dense", False, True, 96),
    "ell": ("bi_norm", "ell", True, False, 96),
    "ell_transpose": ("si_norm", "ell", False, False, 96),
}


def _same(got, want, path="host"):
    """Walk two host forms (NamedTuples, lists, arrays, scalars) and require
    equal structure and equal arrays."""
    if want is None or isinstance(want, (int, np.integer)):
        assert got == want, path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")


def _coos(norm):
    g = tsyn.synthetic_graph(**TINY)
    coo = g.joint_norm_adj(norm, True)
    jcoo = JaxCOO(coo.row, coo.col, coo.val, coo.shape)
    return g, coo, jcoo


def _rand_coo():
    """A square 50-node COO with no symmetry and duplicate-summed edges."""
    rng = np.random.default_rng(11)
    r, c = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    v = rng.random(400).astype(np.float32)
    return COO.from_edges(r, c, (50, 50), v), JaxCOO.from_edges(r, c, (50, 50), v)


def _pair_kw(g, name):
    norm, mode, sym, sectors, hub = PAIRS[name]
    return dict(symmetric=sym, mode=mode, hub_min_degree=hub,
                sectors=(g.n_user, g.n_item, g.n_tag) if sectors else None)


def _pairs(name):
    g, coo, jcoo = _coos(PAIRS[name][0])
    kw = _pair_kw(g, name)
    return ell.build_adj_pair(coo, **kw), jell.build_adj_pair(jcoo, **kw)


# ----------------------------------------------------------------- builders

def test_coo_transpose_and_dense_equal_jax():
    coo, jcoo = _rand_coo()
    np.testing.assert_array_equal(coo.to_dense(), jcoo.to_dense())
    t, jt = coo.transpose(), jcoo.transpose()
    assert t.shape == jt.shape
    for a, b in ((t.row, jt.row), (t.col, jt.col), (t.val, jt.val)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad,width", [(8, None), (4, None), (8, 40)])
def test_ell_equals_jax(pad, width):
    coo, jcoo = _rand_coo()
    _same(ell.ell_from_coo(coo, pad, width),
          jell.ell_from_coo(jcoo, pad, width))
    with pytest.raises(ValueError, match="width"):
        ell.ell_from_coo(coo, width=2)


@pytest.mark.parametrize("boundaries", [None, (2, 6), (1, 3, 5, 7, 9)])
def test_buckets_equal_jax(boundaries):
    coo, jcoo = _rand_coo()
    deg = np.bincount(coo.row, minlength=50)
    assert ell.auto_boundaries(deg) == jell.auto_boundaries(deg)
    _same(ell.build_ell_buckets(coo.row, coo.col, coo.val, 50, 50, boundaries),
          jell.build_ell_buckets(jcoo.row, jcoo.col, jcoo.val, 50, 50,
                                 boundaries))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_adj_pair_equals_jax(name):
    got, want = _pairs(name)
    assert type(got.fwd).__name__ == type(want.fwd).__name__
    assert (got.bwd is got.fwd) == (want.bwd is want.fwd)
    _same(got, want)
    if name == "hybrid_hubs":
        assert got.fwd.dense_cols is not None and len(got.fwd.ell.buckets) > 2


def test_hub_cap_and_budget_rule_equal_jax():
    g, coo, jcoo = _coos("bi_norm")
    for kw in (dict(hub_min_degree=4, max_hub_cols=20), dict(hub_min_degree=4)):
        _same(ell.build_hybrid(coo, **kw), jell.build_hybrid(jcoo, **kw))
    assert len(ell.build_hybrid(coo, hub_min_degree=4,
                                max_hub_cols=20).dense_cols) == 20


def test_to_device_checks_ids_and_keeps_layouts():
    got, _ = _pairs("hybrid_hubs")
    adj = ell.to_device(got, "cpu")
    assert adj.bwd is adj.fwd
    part = adj.fwd.ell.parts[0]
    assert part.idx.dtype == torch.int32 and part.val.dtype == torch.float32
    assert adj.fwd.ell.inv_perm.dtype == torch.int32
    assert adj.fwd.dense_cols.dtype == torch.int32
    mask = ell.ell_mask(part)
    want = jell.ell_mask(jell.to_device(got.fwd.ell.buckets[0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
    bad = got.fwd.ell.buckets[0]._replace(n_cols=3)
    with pytest.raises(ValueError, match="outside"):
        ell.to_device(bad, "cpu")
    with pytest.raises(TypeError, match="no device form"):
        ell.to_device(object(), "cpu")


def test_sectors_must_tile_the_adjacency():
    g, coo, _ = _coos("bi_norm")
    with pytest.raises(ValueError, match="tile"):
        ell.build_dense_sectors(coo, (g.n_user, g.n_item))
    with pytest.raises(ValueError, match="mode"):
        ell.build_adj_pair(coo, mode="sparse")


# -------------------------------------------------------------- propagation

def _xg(n, d=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def test_coo_spmm_and_ell_mm_equal_jax():
    coo, jcoo = _rand_coo()
    x, _ = _xg(50)
    want = np.asarray(jprop.coo_spmm(*map(jnp.asarray, (jcoo.row, jcoo.col,
                                                        jcoo.val, x)), 50))
    got = prop.coo_spmm(*map(torch.from_numpy, (coo.row, coo.col, coo.val, x)),
                        50)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    h = ell.ell_from_coo(coo)
    got = prop.ell_mm(ell.to_device(h, "cpu"), torch.from_numpy(x))
    want = jprop.ell_mm(jell.to_device(h), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), coo.to_dense() @ x, rtol=1e-4,
                               atol=1e-5)


def test_ell_buckets_mm_equals_jax():
    coo, _ = _rand_coo()
    h = ell.build_ell_buckets(coo.row, coo.col, coo.val, 50, 50, (2, 6))
    x, _ = _xg(50)
    got = prop.ell_buckets_mm(ell.to_device(h, "cpu"), torch.from_numpy(x))
    want = jprop.ell_buckets_mm(jell.buckets_to_device(h), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # one-type dispatch of adj_mm
    got2 = prop.adj_mm(ell.to_device(h, "cpu"), torch.from_numpy(x))
    torch.testing.assert_close(got2, got, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_hybrid_mm_and_pair_spmm_equal_jax(name):
    host, jhost = _pairs(name)
    adj = ell.to_device(host, "cpu")
    jadj = jell.adj_pair_to_device(jhost)
    n = host.fwd.ell.n_rows if isinstance(host.fwd, ell.HybridHost) \
        else sum(host.fwd.sizes)
    x, g = _xg(n)
    want = np.asarray(jprop.hybrid_mm(jadj.fwd, jnp.asarray(x)))
    got = prop.hybrid_mm(adj.fwd, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    xt = torch.from_numpy(x).requires_grad_()
    out = prop.adj_mm(adj, xt)
    (out * torch.from_numpy(g)).sum().backward()
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    jout, vjp = jax.vjp(lambda v: jprop.adj_mm(jadj, v), jx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jg)[0]),
                               rtol=RTOL, atol=ATOL)
