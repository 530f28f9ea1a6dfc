"""The port's chunked dense tier (``adj_mode="dense_xla"``) against the JAX
package's on the CPU.

Each function of ``ops.dense_adj`` against JAX's on the same inputs, at a
chunk that does not divide the rows: values at rtol 1e-5, atol 1e-6, and
the gradients where JAX differentiates at rtol 1e-4, atol 1e-5 (sums of
up to 75 float32 products in another order).  Then
DGCF, DisenGCN and KGAT ``bi_inter`` on the tiny graph with JAX's params:
the ``dense_xla`` forward at rtol 1e-4, atol 1e-5 and the BPR gradients at
rtol 5e-4, atol 1e-5 against JAX's ``dense_xla``, and against the port's
own kernel tier (its plain versions here) at the same tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models import MODEL_REGISTRY as JAX_MODELS
from tagrec_tpu.ops import dense_adj as jda
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import dense_adj, flash_attention, flash_routing
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.checkpoint import params_from_jax

RTOL, ATOL = 1e-5, 1e-6
OP_GRAD_RTOL, OP_GRAD_ATOL = 1e-4, 1e-5
MODEL_RTOL, MODEL_ATOL, GRAD_RTOL = 1e-4, 1e-5, 5e-4
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CHUNK = 16
N, M, F_, DK = 75, 61, 4, 8  # N, M not multiples of CHUNK


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _mask(rng, n, m, p=0.2):
    mask = rng.random((n, m)) < p
    mask[3] = False  # a row with no edge
    return mask


def _check(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _grads(jfn, tfn, arrays, w):
    """Gradients of sum(fn(*arrays) * w) on both sides, for every input."""
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                          argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    (tfn(*ts) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jg):
        if t.grad is None:  # no path to the input: JAX's gradient is 0
            assert not np.asarray(g).any()
        else:
            _check(t.grad, g, rtol=OP_GRAD_RTOL, atol=OP_GRAD_ATOL)


def test_masked_row_softmax_equals_jax():
    rng = np.random.default_rng(0)
    s, m = _rand(rng, N, M, scale=3), _mask(rng, N, M)
    got = dense_adj.masked_row_softmax(torch.from_numpy(s), torch.from_numpy(m))
    _check(got, jax.jit(jda.masked_row_softmax)(s, m))
    assert torch.all(got[3] == 0) and torch.all(got[torch.from_numpy(~m)] == 0)
    _grads(lambda x: jda.masked_row_softmax(x, jnp.asarray(m)),
           lambda x: dense_adj.masked_row_softmax(x, torch.from_numpy(m)),
           [s], _rand(rng, N, M))


SEGS = ((0, 20), (20, 35), (55, 20))
REL_OF = ((-1, 0, 2), (1, -1, 4), (3, 5, -1))


def test_sector_stack_equals_jax():
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 6, N, DK), _rand(rng, 6, N, DK)
    got = dense_adj.sector_stack(torch.from_numpy(q), torch.from_numpy(k),
                                 SEGS, REL_OF)
    want = jax.jit(lambda a, b: jda.sector_stack(a, b, SEGS, REL_OF))(q, k)
    for a, b in zip(got, want):
        assert a.shape == (N, 6 * DK)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w = _rand(rng, N, N)

    def scores(stack):
        def fn(a, b):
            qhat, khat = stack(a, b, SEGS, REL_OF)
            return qhat @ khat.T
        return fn

    _grads(scores(jda.sector_stack), scores(dense_adj.sector_stack), [q, k], w)


def test_dense_row_softmax_scores_equals_jax():
    rng = np.random.default_rng(2)
    qh, kh, m = _rand(rng, N, 12), _rand(rng, M, 12), _mask(rng, N, M)
    got = dense_adj.dense_row_softmax_scores(
        torch.from_numpy(qh), torch.from_numpy(kh), torch.from_numpy(m), CHUNK)
    assert got.shape == (N, M)
    _check(got, jax.jit(lambda a, b, c: jda.dense_row_softmax_scores(
        a, b, c, CHUNK))(qh, kh, m))
    _grads(lambda a, b: jda.dense_row_softmax_scores(a, b, jnp.asarray(m),
                                                     CHUNK),
           lambda a, b: dense_adj.dense_row_softmax_scores(
               a, b, torch.from_numpy(m), CHUNK),
           [qh, kh], _rand(rng, N, M))


def test_routed_agg_dense_equals_jax():
    """The factor softmax is detached: the gradient reaches the tail only
    through the product, and the head gets none."""
    rng = np.random.default_rng(3)
    head, tail, m = _rand(rng, F_, N, DK), _rand(rng, F_, N, DK), _mask(rng,
                                                                        N, N)
    got = dense_adj.routed_agg_dense(torch.from_numpy(head),
                                     torch.from_numpy(tail),
                                     torch.from_numpy(m), CHUNK)
    _check(got, jax.jit(lambda a, b, c: jda.routed_agg_dense(
        a, b, c, CHUNK))(head, tail, m))
    w = _rand(rng, F_, N, DK)
    _grads(lambda a, b: jda.routed_agg_dense(a, b, jnp.asarray(m), CHUNK),
           lambda a, b: dense_adj.routed_agg_dense(a, b, torch.from_numpy(m),
                                                   CHUNK), [head, tail], w)


def _dgcf_inputs(rng, t=2):
    return (_rand(rng, t, F_, N, DK, scale=0.3), _rand(rng, t, F_, N, DK,
                                                       scale=0.3),
            _mask(rng, N, N))


def _factors(t):
    """JAX's stacked [T, F, N, dk] factors -> the port's [F, N, T*dk]."""
    t = torch.as_tensor(t)
    return t.permute(1, 2, 0, 3).reshape(t.shape[1], t.shape[2], -1)


def test_dgcf_dense_degree_equals_jax():
    rng = np.random.default_rng(4)
    u, v, m = _dgcf_inputs(rng)
    got = dense_adj.dgcf_dense_degree(_factors(u), _factors(v),
                                      torch.from_numpy(m), CHUNK)
    assert got.shape == (F_, N) and not got.requires_grad
    _check(got, jax.jit(lambda a, b, c: jda.dgcf_dense_degree(
        a, b, c, CHUNK))(u, v, m))
    # iteration 0: one zero factor, S = 1, so each factor's row sum is
    # the row's degree over F
    z = torch.zeros((F_, N, 8))
    d0 = dense_adj.dgcf_dense_degree(z, z, torch.from_numpy(m), CHUNK)
    np.testing.assert_allclose(d0.numpy(), np.broadcast_to(
        m.sum(1) / F_, (F_, N)), rtol=1e-6)


def test_dgcf_dense_prop_equals_jax():
    """u and v are detached; x is differentiated."""
    rng = np.random.default_rng(5)
    u, v, m = _dgcf_inputs(rng)
    x = _rand(rng, F_, N, DK)
    got = dense_adj.dgcf_dense_prop(_factors(u), _factors(v),
                                    *map(torch.from_numpy, (m, x)), CHUNK)
    _check(got, jax.jit(lambda a, b, c, d: jda.dgcf_dense_prop(
        a, b, c, d, CHUNK))(u, v, m, x))
    _grads(lambda a, b, c: jda.dgcf_dense_prop(a, b, jnp.asarray(m), c, CHUNK),
           lambda a, b, c: dense_adj.dgcf_dense_prop(
               _factors(a), _factors(b), torch.from_numpy(m), c, CHUNK),
           [u, v, x], _rand(rng, F_, N, DK))


def test_disenhan_dense_rela_equals_jax():
    """Fully differentiable: hs, ts, r and the destination factors."""
    rng = np.random.default_rng(6)
    hs, ts = _rand(rng, F_, N), _rand(rng, F_, M)
    r = np.array(jax.nn.softmax(_rand(rng, F_, N), axis=0))
    old, m = _rand(rng, F_, M, DK), _mask(rng, N, M)
    got = dense_adj.disenhan_dense_rela(
        *map(torch.from_numpy, (hs, ts, r, old, m)), CHUNK)
    assert got.shape == (F_, N, DK)
    _check(got, jax.jit(lambda *a: jda.disenhan_dense_rela(*a, CHUNK))(
        hs, ts, r, old, m))
    _grads(lambda a, b, c, d: jda.disenhan_dense_rela(a, b, c, d,
                                                      jnp.asarray(m), CHUNK),
           lambda a, b, c, d: dense_adj.disenhan_dense_rela(
               a, b, c, d, torch.from_numpy(m), CHUNK),
           [hs, ts, r, old], _rand(rng, F_, N, DK))


# ------------------------------------------------------------ the models

MODELS = {"dgcf": dict(cor_reg=0.1), "disengcn": dict(reg=1e-4),
          "kgat": dict(agg_type="bi_inter", reg=1e-4)}


def _bpr_batch(graph):
    rng = np.random.default_rng(8)
    return np.stack([rng.integers(0, graph.n_user, 40),
                     rng.integers(0, graph.n_item, 40),
                     rng.integers(0, graph.n_item, 40)], axis=1)


def _cor(graph):
    rng = np.random.default_rng(9)
    return {"user": rng.integers(0, graph.n_user, 20),
            "item": rng.integers(0, graph.n_item, 20),
            "tag": rng.integers(0, graph.n_tag, 20)}


@pytest.fixture(scope="module")
def jax_runs(tiny_graph):
    """Per model, JAX's dense_xla tier: params, forward, BPR loss and named
    gradients on one batch."""
    runs = {}
    batch = jnp.asarray(_bpr_batch(tiny_graph), jnp.int32)
    cor = {k: jnp.asarray(v, jnp.int32) for k, v in _cor(tiny_graph).items()}
    for name, cfg in MODELS.items():
        model = JAX_MODELS[name](tiny_graph, jax_preset(name, **cfg,
                                                        adj_mode="dense_xla"))
        params = model.init(jax.random.PRNGKey(0))
        gdev = model.device_data()
        kw = {"cor": cor} if name == "dgcf" else {}

        def total(p):
            return sum(model.bpr_loss(p, gdev, batch, **kw))

        @jax.jit
        def run(p):
            return model.forward(p, gdev), jax.value_and_grad(total)(p)

        fwd, (loss, grads) = run(params)
        runs[name] = {"params": jax.tree_util.tree_map(np.asarray, params),
                      "forward": [np.asarray(t) for t in fwd],
                      "loss": float(loss),
                      "grads": dict(checkpoint._leaves(
                          jax.tree_util.tree_map(np.asarray, grads)))}
    return runs


def _port(name, mode, params):
    torch.backends.cuda.matmul.allow_tf32 = False
    model = model_class(name)(tsyn.synthetic_graph(**TINY),
                              model_preset(name, **MODELS[name],
                                           adj_mode=mode),
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    return params_from_jax(model, params)


def _run(model, name, graph):
    """forward tables, loss and named gradients of one BPR loss."""
    with torch.no_grad():
        fwd = [t.numpy() for t in model.forward()]
    kw = ({"cor": {k: torch.from_numpy(v) for k, v in _cor(graph).items()}}
          if name == "dgcf" else {})
    loss = sum(model.bpr_loss(torch.from_numpy(_bpr_batch(graph)), **kw))
    model.zero_grad(set_to_none=True)
    loss.backward()
    return fwd, float(loss.detach()), {n: p.grad.numpy()
                                       for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", MODELS)
def test_dense_xla_equals_jax(jax_runs, name, tiny_graph):
    model = _port(name, "dense_xla", jax_runs[name]["params"])
    assert not model.flash
    fr = (flash_routing.routed_rowsum.launches,
          flash_routing.routed_mm.launches,
          flash_attention.dot_flash_stats.launches)
    fwd, loss, grads = _run(model, name, tiny_graph)
    assert fr == (flash_routing.routed_rowsum.launches,
                  flash_routing.routed_mm.launches,
                  flash_attention.dot_flash_stats.launches)
    want = jax_runs[name]
    for a, b in zip(fwd, want["forward"]):
        np.testing.assert_allclose(a, b, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(loss, want["loss"], rtol=MODEL_RTOL)
    assert grads.keys() == want["grads"].keys()
    for key, g in grads.items():
        np.testing.assert_allclose(g, want["grads"][key], rtol=GRAD_RTOL,
                                   atol=MODEL_ATOL, err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_dense_xla_equals_the_kernel_tier(jax_runs, name, tiny_graph):
    """The same weights through both of the port's tiers: the chunked dense
    tier and the kernel tier (its plain versions on the CPU)."""
    params = jax_runs[name]["params"]
    xla = _run(_port(name, "dense_xla", params), name, tiny_graph)
    kern_model = _port(name, "auto", params)
    assert kern_model.flash
    kern = _run(kern_model, name, tiny_graph)
    for a, b in zip(xla[0], kern[0]):
        np.testing.assert_allclose(a, b, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(xla[1], kern[1], rtol=MODEL_RTOL)
    for key, g in xla[2].items():
        np.testing.assert_allclose(g, kern[2][key], rtol=GRAD_RTOL,
                                   atol=MODEL_ATOL, err_msg=key)
