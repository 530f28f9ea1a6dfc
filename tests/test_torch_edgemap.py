"""The port's EdgeMap (tagrec_tpu_torch/ops/edgemap.py) against JAX's.

* Builders: ``build_ell_buckets_slots``, ``build_edge_map``,
  ``slot_payload`` and ``cross_slot_maps`` give JAX's arrays exactly, on a
  random COO, on a (relation, node)-keyed map whose empty rows form a
  zero-width bucket, and at ``pad_multiple=1``.
* Primitives: each Function's forward (rtol 1e-4, atol 1e-5) and its
  gradients against fixed cotangents (rtol 5e-4, atol 1e-5) equal JAX's
  custom-VJP primitives on the same seeded inputs, without and with a
  leading [F] factor axis; and equal the plain autograd of the port's own
  raw forms.  Their backwards run no scatter or index_put.
* ``edge_softmax`` on degree-0 rows, ``slot_transfer``, the row-chunked
  path with the budget shrunk, and a call whose operands' leading axes
  differ, which raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tagrec_tpu.ops import edgemap as jem
from tagrec_tpu.ops import ell as jell
from tagrec_tpu_torch.ops import edgemap as em_lib
from tagrec_tpu_torch.ops import ell

from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL, GRAD_RTOL = 1e-4, 1e-5, 5e-4
F = 3
N_ROWS, N_COLS, N_REL = 60, 45, 3


def _edges(seed=7, n_edges=500):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, N_ROWS, n_edges)
    c = rng.integers(0, N_COLS, n_edges)
    key = np.unique(r * N_COLS + c)  # no parallel edges
    return (key // N_COLS, key % N_COLS,
            rng.random(len(key)).astype(np.float32))


def _keyed(seed=3):
    """A square node graph under N_REL relations and its (relation, node)
    keys: most keyed rows are empty (a zero-width bucket)."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    r, c = rng.integers(0, n, 300), rng.integers(0, n, 300)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    rel = rng.integers(0, N_REL, len(r))
    return r, c, rel, n


def _same(got, want, path="host"):
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


def _build_args(case):
    if case == "random":
        r, c, v = _edges()
        return (r, c, v, N_ROWS, N_COLS), {}
    if case == "pad1":
        r, c, v = _edges(seed=5, n_edges=200)
        return (r, c, v, N_ROWS, N_COLS), dict(pad_multiple=1)
    r, c, rel, n = _keyed()
    return (rel * n + r, rel * n + c, None, N_REL * n, N_REL * n), {}


# ----------------------------------------------------------------- builders

@pytest.mark.parametrize("case", ["random", "keyed", "pad1"])
def test_build_ell_buckets_slots_equals_jax(case):
    (r, c, v, n, m), kw = _build_args(case)
    v = np.ones(len(r), np.float32) if v is None else v
    got = ell.build_ell_buckets_slots(r, c, v, n, m, **kw)
    want = jell.build_ell_buckets_slots(r, c, v, n, m, **kw)
    _same(got, want)
    if case == "keyed":  # the empty keyed rows' zero-width bucket
        assert got[0].buckets[0].idx.shape[1] == 0


@pytest.mark.parametrize("case", ["random", "keyed", "pad1"])
def test_build_edge_map_equals_jax(case):
    args, kw = _build_args(case)
    got = em_lib.build_edge_map(*args, **kw)
    want = jem.build_edge_map(*args, **kw)
    _same(got, want)
    rng = np.random.default_rng(1)
    per_edge = rng.random(len(args[0])).astype(np.float32)
    for side in ("f", "b"):
        _same(em_lib.slot_payload(got, per_edge, side=side),
              jem.slot_payload(want, per_edge, side=side))


def test_cross_slot_maps_equal_jax():
    r, c, rel, n = _keyed()
    hosts = {}
    for lib in (em_lib, jem):
        node = lib.build_edge_map(r, c, None, n, n)
        key = lib.build_edge_map(rel * n + r, rel * n + c, None, N_REL * n,
                                 N_REL * n)
        hosts[lib] = (node, key, lib.cross_slot_maps(key, node))
    _same(hosts[em_lib][2], hosts[jem][2])
    node, key, (to_t, from_t) = hosts[em_lib]
    # the maps are inverse bijections over the real edges
    to_flat = np.concatenate([t.ravel() for t in to_t])
    from_flat = np.concatenate([t.ravel() for t in from_t])
    np.testing.assert_array_equal(to_flat[node.f_slot_of_edge],
                                  key.f_slot_of_edge)
    np.testing.assert_array_equal(from_flat[key.f_slot_of_edge],
                                  node.f_slot_of_edge)


# --------------------------------------------------------------- primitives

@pytest.fixture(scope="module")
def maps():
    """(port EdgeMap on the CPU, JAX EdgeMap) of the random COO."""
    (r, c, v, n, m), _ = _build_args("random")
    return (em_lib.to_device(em_lib.build_edge_map(r, c, v, n, m), "cpu"),
            jem.to_device(jem.build_edge_map(r, c, v, n, m)))


def _slot_vals(em, lead, rng):
    """Per-bucket random slot values, 0 on the pads."""
    return tuple(
        rng.standard_normal(lead + tuple(i.shape)).astype(np.float32)
        * (np.arange(i.shape[1])[None, :] < np.asarray(d)[:, None])
        for i, d in zip(em.f_idx, em.f_deg))


def _inputs(name, em, lead, seed=0):
    """The primitive's numpy operands (the tuple operand first)."""
    rng = np.random.default_rng(seed)
    if name == "edge_reduce":
        return (_slot_vals(em, lead, rng),
                rng.standard_normal(lead + (N_COLS, 16)).astype(np.float32))
    if name == "edge_dot":
        return (rng.standard_normal(lead + (N_ROWS, 16)).astype(np.float32),
                rng.standard_normal(lead + (N_COLS, 16)).astype(np.float32))
    if name == "edge_gather":
        return (rng.standard_normal(lead + (N_COLS,)).astype(np.float32),)
    if name == "edge_vgather":
        return (rng.standard_normal(lead + (N_COLS, 8)).astype(np.float32),)
    return (rng.standard_normal(lead + (N_ROWS, 8)).astype(np.float32),)


PRIMS = ["edge_reduce", "edge_dot", "edge_gather", "edge_vgather",
         "rows_gather"]
LEADS = [(), (F,)]


def _cotangent(out, seed=9):
    rng = np.random.default_rng(seed)
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(rng.standard_normal(tuple(o.shape)).astype(np.float32)
                 for o in outs)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def jax_runs(maps):
    """Per (primitive, lead): JAX's forward outputs and the gradients of
    sum(out * cotangent) w.r.t. every operand, jitted once."""
    _, jm = maps
    runs = {}
    for name in PRIMS:
        fn = getattr(jem, name)
        for lead in LEADS:
            args = _inputs(name, jm, lead)
            jargs = jax.tree_util.tree_map(jnp.asarray, args)
            out = jax.jit(fn)(jm, *jargs)
            cots = _cotangent(out)

            def loss(em, *a):
                return sum(jnp.sum(o * c) for o, c in
                           zip(_as_tuple(fn(em, *a)), cots))

            grads = jax.jit(jax.grad(loss, argnums=tuple(
                range(1, 1 + len(args)))))(jm, *jargs)
            runs[name, lead] = (args, cots, jax.tree_util.tree_map(
                np.asarray, _as_tuple(out)),
                jax.tree_util.tree_map(np.asarray, grads))
    return runs


def _torch_run(fn, em, args, cots):
    targs = [tuple(torch.tensor(a, requires_grad=True) for a in x)
             if isinstance(x, tuple) else torch.tensor(x, requires_grad=True)
             for x in args]
    out = _as_tuple(fn(em, *targs))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)
        ).backward()
    grads = [tuple(t.grad for t in x) if isinstance(x, tuple) else x.grad
             for x in targs]
    return out, grads


def _close(got, want, rtol, atol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (tuple, list)):
            _close(g, w, rtol, atol)
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("lead", LEADS, ids=["no_lead", "factor_axis"])
@pytest.mark.parametrize("name", PRIMS)
def test_primitive_equals_jax(maps, jax_runs, name, lead):
    em, _ = maps
    args, cots, want_out, want_grads = jax_runs[name, lead]
    out, grads = _torch_run(getattr(em_lib, name), em, args, cots)
    _close(out, want_out, RTOL, ATOL)
    _close(grads, want_grads, GRAD_RTOL, ATOL)


RAW = {"edge_reduce": lambda em, v, x: em_lib._reduce_raw(em, v, x),
       "edge_dot": lambda em, a, b: em_lib._dot_raw(em, a, b),
       "edge_gather": lambda em, v: em_lib._gather_raw(em, v),
       "edge_vgather": lambda em, x: em_lib._vgather_raw(em, x),
       "rows_gather": lambda em, x: em_lib._rows_gather_raw(em, x)}


@pytest.mark.parametrize("name", PRIMS)
def test_function_equals_raw_autograd(maps, name):
    """Each Function's backward equals the plain autograd of its raw form
    (the backwards change how the cotangents are computed, not what),
    with the leading [F] axis."""
    em, _ = maps
    args = _inputs(name, em, (F,), seed=4)
    cots = _cotangent(getattr(em_lib, name)(em, *[
        tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple)
        else torch.from_numpy(x) for x in args]))
    out, grads = _torch_run(getattr(em_lib, name), em, args, cots)
    raw_out, raw_grads = _torch_run(RAW[name], em, args, cots)
    if name == "edge_reduce":  # d vals is defined on the real slots only
        raw_grads[0] = tuple(g * m for g, m in zip(raw_grads[0], em.masks()))
    _close(out, [t.detach().numpy() for t in raw_out], RTOL, ATOL)
    _close(grads, [tuple(t.numpy() for t in g) if isinstance(g, tuple)
                   else g.numpy() for g in raw_grads], GRAD_RTOL, ATOL)


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


SCATTERS = ("index_put", "index_add", "scatter", "_index_put_impl")


@pytest.mark.parametrize("name", PRIMS)
def test_backward_takes_no_scatter(maps, name):
    """The Functions' backwards are gathers; autograd of the raw form,
    for comparison, scatters (so the check can see a scatter)."""
    em, _ = maps
    found = {}
    for label, fn in (("function", getattr(em_lib, name)),
                      ("raw", RAW[name])):
        args = [tuple(torch.tensor(a, requires_grad=True) for a in x)
                if isinstance(x, tuple) else torch.tensor(x,
                                                          requires_grad=True)
                for x in _inputs(name, em, (F,))]
        loss = sum(o.sum() ** 2 for o in _as_tuple(fn(em, *args)))
        with _AtenOps() as mode:
            loss.backward()
        found[label] = {op for op in mode.ops
                        if any(op.startswith(s) for s in SCATTERS)}
    assert not found["function"], found
    assert found["raw"], "the raw form's backward took no scatter"


def test_edge_softmax_equals_jax_with_degree0_rows():
    args, _ = _build_args("keyed")
    em = em_lib.to_device(em_lib.build_edge_map(*args), "cpu")
    jm = jem.to_device(jem.build_edge_map(*args))
    assert em.f_idx[0].shape[1] == 0 and em.f_deg[0].shape[0] > 0
    rng = np.random.default_rng(2)
    scores = tuple(rng.standard_normal((F,) + tuple(i.shape)).astype(
        np.float32) * 4 for i in jm.f_idx)
    want = jax.jit(jem.edge_softmax)(jm, tuple(map(jnp.asarray, scores)))
    ts = tuple(torch.tensor(s, requires_grad=True) for s in scores)
    got = em_lib.edge_softmax(em, ts)
    _close(got, [np.asarray(w) for w in want], RTOL, ATOL)
    for p, deg in zip(got, em.f_deg):
        sums = p.detach().sum(-1)
        np.testing.assert_allclose(sums[:, deg > 0].numpy(), 1.0, rtol=1e-5)
        assert (sums[:, deg == 0] == 0).all()
    cots = _cotangent(tuple(got))

    def jloss(s):
        return sum(jnp.sum(o * c) for o, c in zip(jem.edge_softmax(jm, s),
                                                   cots))

    jg = jax.grad(jloss)(tuple(map(jnp.asarray, scores)))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cots)
        ).backward()
    _close([t.grad for t in ts], [np.asarray(g) for g in jg], GRAD_RTOL,
           ATOL)


def test_slot_transfer_equals_jax():
    r, c, rel, n = _keyed()
    out = {}
    for lib in (em_lib, jem):
        node = lib.build_edge_map(r, c, None, n, n)
        key = lib.build_edge_map(rel * n + r, rel * n + c, None, N_REL * n,
                                 N_REL * n)
        out[lib] = (key, lib.cross_slot_maps(key, node), node)
    key, (k2n, n2k), node = out[em_lib]
    jk2n, jn2k = out[jem][1]
    rng = np.random.default_rng(6)
    vals = tuple(rng.standard_normal((F,) + b.idx.shape).astype(np.float32)
                 * (np.arange(b.idx.shape[1])[None, :] < b.deg[:, None])
                 for b in key.f.buckets)
    jt = (tuple(map(jnp.asarray, jk2n)), tuple(map(jnp.asarray, jn2k)))
    want = jem.slot_transfer(tuple(map(jnp.asarray, vals)), *jt)
    cots = _cotangent(tuple(want))

    def jloss(v):
        return sum(jnp.sum(o * c) for o, c in
                   zip(jem.slot_transfer(v, *jt), cots))

    jg = jax.grad(jloss)(tuple(map(jnp.asarray, vals)))
    tv = tuple(torch.tensor(v, requires_grad=True) for v in vals)
    hosts = {"em": node, "emk": key}
    got = em_lib.slot_transfer(tv, *(
        em_lib.to_device(em_lib.shard_slot_map(
            em_lib.SlotMapHost(t, src, dst), hosts, None), "cpu")
        for t, src, dst in ((k2n, "emk", "em"), (n2k, "em", "emk"))))
    _close(got, [np.asarray(w) for w in want], 0, 0)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cots)
        ).backward()
    _close([t.grad for t in tv], [np.asarray(g) for g in jg], 0, 0)


@pytest.mark.parametrize("lead", LEADS, ids=["no_lead", "factor_axis"])
def test_chunked_gather_budget_matches_unchunked(maps, monkeypatch, lead):
    """A tiny EDGEMAP_GATHER_BUDGET_BYTES sends every bucket of the raw
    forms (``_reduce_raw``, ``edge_dot`` and ``edge_reduce``'s d vals)
    through row chunks: values and gradients as unchunked."""
    em, _ = maps
    rng = np.random.default_rng(3)
    vals = _slot_vals(em, lead, rng)
    x = rng.standard_normal(lead + (N_COLS, 16)).astype(np.float32)
    a = rng.standard_normal(lead + (N_ROWS, 16)).astype(np.float32)
    cots = _cotangent((np.zeros(lead + (N_ROWS, 16)),))

    def runs():
        reduce_raw = _torch_run(RAW["edge_reduce"], em, (vals, x), cots)
        reduce_fn = _torch_run(em_lib.edge_reduce, em, (vals, x), cots)
        dot = _torch_run(em_lib.edge_dot, em, (a, x), _cotangent(
            em_lib.edge_dot(em, torch.from_numpy(a), torch.from_numpy(x))))
        return reduce_raw, reduce_fn, dot

    want = runs()
    monkeypatch.setattr(em_lib, "EDGEMAP_GATHER_BUDGET_BYTES", 1 << 12)
    assert all(em_lib._row_chunk_for(i.shape[0], i.shape[1], 16, 4, lead)
               for i in em.f_idx if i.shape[1])
    got = runs()
    for (g_out, g_grads), (w_out, w_grads) in zip(got, want):
        _close(g_out, [t.detach().numpy() for t in w_out], 1e-5, 1e-6)
        _close(g_grads, [tuple(t.numpy() for t in g) if isinstance(g, tuple)
                         else g.numpy() for g in w_grads], RTOL, ATOL)


def _blocked_ops(b, v, lead):
    """{name: (op(idx, a, s, h) over a bucket's rows, its one-product
    value)}: ``_dot_bucket``, ``edge_score`` and ``slot_sums``, each over
    fixed row blocks."""
    def gathered(idx):
        return b[..., idx.long(), :]

    return {
        "edge_dot": (lambda idx, a, s, h: em_lib._dot_bucket(a, idx, b),
                     lambda idx, a, s, h: torch.einsum(
                         "...nd,...nkd->...nk", a, gathered(idx))),
        "edge_score": (lambda idx, a, s, h: em_lib.edge_score(
            None, (h,), v)[0], lambda idx, a, s, h: (h @ v.T)[..., 0]),
        "slot_sums": (lambda idx, a, s, h: em_lib.slot_sums(
            (s,), (gathered(idx),))[0],
                      lambda idx, a, s, h: torch.einsum(
                          "...nk,...nkd->...nd", s, gathered(idx)))}


@pytest.mark.parametrize("name", ["edge_dot", "edge_score", "slot_sums"])
@pytest.mark.parametrize("lead", LEADS, ids=["no_lead", "factor_axis"])
def test_block_products_do_not_depend_on_the_row_count(maps, monkeypatch,
                                                       lead, name):
    """The products over fixed row blocks (``_dot_bucket``, ``edge_score``,
    ``slot_sums``) over a bucket's two halves (a ``model`` rank's rows)
    equal them over the whole bucket bit for bit, in blocks of a few rows
    so that the halves end in padded blocks; and one product over all the
    rows within float32 rounding."""
    em, _ = maps
    monkeypatch.setattr(em_lib, "DOT_BLOCK_ELEMS_ELSE", 1 << 10)
    monkeypatch.setattr(em_lib, "SLOT_BLOCK_ROWS_ELSE", 8)
    rng = np.random.default_rng(9)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(lead + shape).astype(np.float32))

    op, one = _blocked_ops(randn(N_COLS, 16), randn(1, 16)[(0,) * len(lead)],
                           lead)[name]
    def half(args, r):
        a, s, hv = args
        return a[..., r, :], s[..., r, :], hv[..., r, :, :]

    padded = 0
    for idx in em.f_idx:
        n, k = idx.shape
        if k == 0 or n < 2:
            continue
        args = (randn(n, 16), randn(n, k), randn(n, k, 16))
        rows = (em_lib._dot_rows(k, 16, 4, lead, idx.device)
                if name == "edge_dot" else em_lib.SLOT_BLOCK_ROWS_ELSE)
        h = n // 2
        padded += n > rows and h % rows != 0
        whole = op(idx, *args)
        halves = torch.cat([op(idx[:h], *half(args, slice(0, h))),
                            op(idx[h:], *half(args, slice(h, n)))], dim=-2)
        assert torch.equal(whole, halves)
        torch.testing.assert_close(whole, one(idx, *args), rtol=1e-5,
                                   atol=1e-6)
    assert padded


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", ["edge_reduce", "edge_dot"])
def test_mixed_leading_axes_raise(maps, monkeypatch, name, chunked):
    """Operands whose leading axes differ raise, in the whole and the
    row-chunked paths, rather than fold into the row axis."""
    em, _ = maps
    if chunked:
        monkeypatch.setattr(em_lib, "EDGEMAP_GATHER_BUDGET_BYTES", 1 << 12)
    rng = np.random.default_rng(8)
    if name == "edge_reduce":
        vals = tuple(torch.from_numpy(v) for v in _slot_vals(em, (F,), rng))
        x = torch.randn(N_COLS, 16)
        calls = (lambda: em_lib.edge_reduce(em, vals, x),
                 lambda: em_lib._reduce_raw(em, vals, x))
    else:
        a, b = torch.randn(F, N_ROWS, 16), torch.randn(2, F, N_COLS, 16)
        calls = (lambda: em_lib.edge_dot(em, a, b),
                 lambda: em_lib._dot_raw(em, a, b))
    for call in calls:
        with pytest.raises(ValueError, match="leading axes"):
            call()


def test_buffers_follow_the_module(maps):
    """EdgeMapBuffers: non-persistent (no state_dict entry), rebuilt equal,
    and carried by ``.to()``."""
    em, _ = maps
    none = em_lib.Exchange(send=torch.zeros(0, dtype=torch.int32),
                           send_splits=(0,), recv_splits=(0,), total=0)
    holder = em_lib.EdgeMapBuffers({"em": em, "tables": em_lib.SlotMapShard(
        read=em.f_src, x=none, mesh=None)})
    assert not holder.state_dict()
    back = holder["em"]
    for got, want in zip(back, em):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(holder["tables"].read,
                                                 em.f_src))
    moved = holder.to(torch.float64)["em"]
    assert moved.f_val[0].dtype == torch.float64
    assert moved.f_idx[0].dtype == torch.int32
    assert back.transpose().transpose() == back
