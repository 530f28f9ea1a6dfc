"""The port's NGCF against the JAX package's on the CPU, on each adjacency
tier: dense (type sectors), ELL (degree buckets) and hybrid (a hub block;
``hub_min_degree`` 12 on both sides, so that hub columns exist on the tiny
graph).  NGCF's adjacency D^-1 A is not symmetric, so every tier keeps its
own transpose tables.

With JAX's params carried across: the built tables array-equal (bfloat16
blocks bit for bit); the forward and ``predict`` at rtol 1e-4, atol 1e-5;
the BPR loss at rtol 1e-4 and every gradient at rtol 5e-4, atol 1e-5; 3
Adam steps on the same fed batches at rtol 5e-3.  ``adj_dtype="bf16"``
against JAX's bf16 at rtol 2e-3, atol 1e-4 (gradients rtol 5e-3, atol
1e-4): x is rounded to bfloat16 before each product on both sides, and an
x that differs in its last float32 bit may round to the neighbouring
bfloat16 value (one part in 256).  Then ``edge_dropout`` on every
adjacency form and ``ell_softmax``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.ngcf import NGCF as JaxNGCF
from tagrec_tpu.ops import ell as jell
from tagrec_tpu.ops import propagate as jprop
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import dma_gather, ell, propagate
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.train import Trainer

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 5e-4
TRAJ_RTOL = 5e-3
BF16_RTOL, BF16_ATOL, BF16_GRAD_RTOL = 2e-3, 1e-4, 5e-3
HUB_MIN = 12
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CASES = {"dense": dict(adj_mode="dense"), "ell": dict(adj_mode="ell"),
         "hybrid": dict(adj_mode="hybrid"),
         "bf16": dict(adj_mode="dense", adj_dtype="bf16")}
CFG = dict(reg=1e-4)
TRAJ_CASES = ("dense", "hybrid")


def _batches(graph, n=3, size=48):
    """BPR batches from numpy: negatives outside the user's positives."""
    rng = np.random.default_rng(123)
    train = graph.user_items["train"]
    out = []
    for _ in range(n):
        u = rng.choice(sorted(train), size)
        p = np.array([rng.choice(train[x]) for x in u])
        neg = np.array([rng.choice(np.setdiff1d(np.arange(graph.n_item),
                                                train[x])) for x in u])
        out.append(np.stack([u, p, neg], axis=1).astype(np.int64))
    return out


def _hub_pair(graph, build):
    """NGCF's stored si_norm pair on the hybrid tier with hub columns."""
    return build(graph.joint_norm_adj("si_norm", True), symmetric=False,
                 mode="hybrid", hub_min_degree=HUB_MIN)


def _port(case, tcfg=TrainConfig(), **cfg):
    """Pipeline and Trainer of the port on the CPU; hybrid with hubs."""
    graph = tsyn.synthetic_graph(**TINY)
    pipe = build_pipeline(graph, model_preset("ngcf", **{**CASES[case], **CFG,
                                                         **cfg}), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    if case == "hybrid":
        pipe.model.adj = ell.to_device(_hub_pair(graph, ell.build_adj_pair),
                                       "cpu")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer


@pytest.fixture(scope="module")
def jax_runs(tiny_graph):
    """Per case: the host pair, params, forward, predict, BPR loss and
    named gradients on a fixed batch, and the losses of 3 Adam steps; one
    jitted function a case (its first call at the init params)."""
    runs = {}
    batches = [jnp.asarray(b, jnp.int32) for b in _batches(tiny_graph)]
    users = jnp.arange(7, dtype=jnp.int32)
    opt = joptim.make_optimizer(JaxTrainConfig(adam_impl="torch"))
    for case, kw in CASES.items():
        model = JaxNGCF(tiny_graph, jax_preset("ngcf", **kw, **CFG))
        if case == "hybrid":
            model._adj_host = _hub_pair(tiny_graph, jell.build_adj_pair)
        params = model.init(jax.random.PRNGKey(0))
        gdev = model.device_data()

        def total(p, b):
            return sum(model.bpr_loss(p, gdev, b, key=jax.random.PRNGKey(1)))

        @jax.jit
        def step(p, s, b):
            loss, grads = jax.value_and_grad(total)(p, b)
            updates, s = opt.update(grads, s, p)
            return (optax.apply_updates(p, updates), s, loss, grads,
                    model.forward(p, gdev), model.predict(p, gdev, users))

        p, s = params, opt.init(params)
        traj = []
        for b in batches[:3 if case in TRAJ_CASES else 1]:
            p, s, lv, g, f, pr = step(p, s, b)
            if not traj:
                loss, grads, fwd, pred = lv, g, f, pr
            traj.append(float(lv))
        runs[case] = {
            "host": model._adj_host,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "forward": [np.asarray(t) for t in fwd],
            "predict": np.asarray(pred),
            "loss": float(loss),
            "grads": dict(checkpoint._leaves(
                jax.tree_util.tree_map(np.asarray, grads))),
            "traj": traj}
    return runs


def _loaded(case, jax_runs):
    pipe, trainer = _port(case)
    checkpoint.params_from_jax(pipe.model, jax_runs[case]["params"])
    return pipe, trainer


def _tolerances(case):
    if case == "bf16":
        return BF16_RTOL, BF16_ATOL, BF16_GRAD_RTOL, BF16_ATOL
    return RTOL, ATOL, GRAD_RTOL, ATOL


def _assert_same_host(a, b, path="pair"):
    """The port's host form ``a`` equal to JAX's ``b``, array for array; a
    JAX bfloat16 array against the port's uint16 bits."""
    if isinstance(b, tuple) and hasattr(b, "_fields"):
        assert type(a).__name__ == type(b).__name__, path
        for f in b._fields:
            _assert_same_host(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_host(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        if b.dtype.name == "bfloat16":
            assert a.dtype == np.uint16, path
            b = b.view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("case", CASES)
def test_built_tables_equal_jax(jax_runs, case):
    graph = tsyn.synthetic_graph(**TINY)
    if case == "hybrid":
        host = _hub_pair(graph, ell.build_adj_pair)
        assert host.fwd.dense_cols is not None and host.bwd.ell.buckets
    else:
        kw = CASES[case]
        host = ell.build_adj_pair(
            graph.joint_norm_adj("si_norm", True), symmetric=False,
            mode=kw["adj_mode"],
            dense_dtype="bf16" if case == "bf16" else np.float32,
            sectors=(graph.n_user, graph.n_item, graph.n_tag))
    assert host.bwd is not host.fwd
    _assert_same_host(host, jax_runs[case]["host"])


@pytest.mark.parametrize("case", CASES)
def test_forward_and_predict_equal_jax(jax_runs, case):
    pipe, _ = _loaded(case, jax_runs)
    rtol, atol, _, _ = _tolerances(case)
    with torch.no_grad():
        got = pipe.model.forward()
    assert [t.shape[1] for t in got] == [176] * 3
    for a, b in zip(got, jax_runs[case]["forward"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)
    np.testing.assert_allclose(pipe.model.predict(np.arange(7)).numpy(),
                               jax_runs[case]["predict"], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_bpr_loss_and_gradients_equal_jax(jax_runs, case, tiny_graph):
    pipe, _ = _loaded(case, jax_runs)
    rtol, _, grad_rtol, atol = _tolerances(case)
    batch = torch.from_numpy(_batches(tiny_graph)[0])
    before = (dma_gather.gather_reduce.launches,
              dma_gather.gather_rows.launches)
    loss = sum(pipe.model.bpr_loss(batch))
    loss.backward()
    # the CPU runs the plain versions: no kernel is launched
    assert (dma_gather.gather_reduce.launches,
            dma_gather.gather_rows.launches) == before
    np.testing.assert_allclose(float(loss.detach()), jax_runs[case]["loss"],
                               rtol=rtol)
    grads = jax_runs[case]["grads"]
    assert set(grads) == {n for n, _ in pipe.model.named_parameters()}
    for name, p in pipe.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name],
                                   rtol=grad_rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", TRAJ_CASES)
def test_adam_trajectory_equals_jax(jax_runs, case, tiny_graph):
    pipe, trainer = _loaded(case, jax_runs)
    (phase,) = pipe.phases
    got = [float(trainer.step(phase, torch.from_numpy(b)).sum())
           for b in _batches(tiny_graph)]
    np.testing.assert_allclose(got, jax_runs[case]["traj"], rtol=TRAJ_RTOL,
                               atol=1e-5)


def test_bias_is_folded_into_the_weight(jax_runs):
    """Quirk #4: a layer computes x @ (W + b), not x @ W + b: one layer
    against numpy over the dense D^-1 A + I."""
    graph = tsyn.synthetic_graph(**TINY)
    model = model_class("ngcf")(graph, model_preset("ngcf",
                                                    dim_layer_list=(32,)),
                                generator=torch.Generator().manual_seed(5),
                                device="cpu")
    with torch.no_grad():
        got = torch.cat(model.forward(), dim=0)[:, 64:].numpy()
    a = graph.joint_norm_adj("ngcf", True).to_dense()
    x = torch.cat(list(model.embed)).detach().numpy().astype(np.float64)
    w1, b1, w2, b2 = (model.mat[k].detach().numpy().astype(np.float64)
                      for k in ("W1_0", "b1_0", "W2_0", "b2_0"))
    nei = a @ x

    def layer(folded):
        def lin(h, w, b):
            return h @ (w + b) if folded else h @ w + b

        def leaky(h):
            return np.where(h > 0, h, 0.2 * h)

        y = leaky(lin(nei + x, w1, b1)) + leaky(lin(nei * x, w2, b2))
        return y / np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1e-12)

    np.testing.assert_allclose(got, layer(True), rtol=RTOL, atol=ATOL)
    assert np.abs(got - layer(False)).max() > 1e-2


def test_pipeline_trains_and_evaluates_and_dense_xla_is_dense():
    tcfg = TrainConfig(train_batch=64)
    pipe, trainer = _port("dense", tcfg, adj_mode="dense_xla")
    assert type(pipe.model.adj.fwd).__name__ == "DenseSectors"
    losses = trainer.run_epoch(max_steps=3)["bpr"]
    assert losses.shape == (3, 2) and np.isfinite(losses).all()
    res = pipe.evaluator.run(pipe.model)
    assert 0.0 < res["auc"][0] < 1.0 and len(res["recall"]) == 2


# ------------------------------------------------------------- edge dropout

RATE = 0.3
FORMS = ("ell", "buckets", "hybrid", "dense", "sectors", "sectors_bf16",
         "pair")


def _form(name):
    """(adjacency form of the tiny graph's si_norm COO, its dense
    matrix)."""
    graph = tsyn.synthetic_graph(**TINY)
    coo = graph.joint_norm_adj("si_norm", True)
    sectors = (graph.n_user, graph.n_item, graph.n_tag)
    if name == "ell":
        host = ell.ell_from_coo(coo)
    elif name == "buckets":
        host = ell.build_ell_buckets(coo.row, coo.col, coo.val, *coo.shape)
    elif name == "hybrid":
        host = _hub_pair(graph, ell.build_adj_pair).fwd
    elif name == "dense":
        host = ell.build_dense(coo)
    elif name == "sectors":
        host = ell.build_dense_sectors(coo, sectors)
    elif name == "sectors_bf16":
        host = ell.build_dense_sectors(coo, sectors, dtype="bf16")
    else:
        host = _hub_pair(graph, ell.build_adj_pair)
    return ell.to_device(host, "cpu"), coo.shape[0]


def _dense(adj, n):
    """The dense matrix of one adjacency form: A @ I."""
    with torch.no_grad():
        fwd = adj.fwd if isinstance(adj, ell.AdjPair) else adj
        return propagate.adj_mm(fwd, torch.eye(n)).double()


@pytest.mark.parametrize("name", FORMS)
def test_edge_dropout_invariants(name):
    adj, n = _form(name)
    dropped = propagate.edge_dropout(adj, RATE,
                                     torch.Generator().manual_seed(3), True)
    assert propagate.edge_dropout(adj, RATE, None, False) is adj
    assert propagate.edge_dropout(adj, 0.0, None, True) is adj
    a, b = _dense(adj, n), _dense(dropped, n)
    # zeros stay zero; survivors scaled by exactly 1 / keep
    assert torch.all(b[a == 0] == 0)
    kept = (b != 0) & (a != 0)
    want = (a[kept].float() / (1 - RATE))
    if name == "sectors_bf16":
        want = want.to(torch.bfloat16).double()
    torch.testing.assert_close(b[kept], want.double(), rtol=1e-6, atol=0)
    share = 1 - float(kept.sum()) / float((a != 0).sum())
    edges = int((a != 0).sum())
    assert abs(share - RATE) < 4 * np.sqrt(RATE * (1 - RATE) / edges), share
    # the gradient through the dropped adjacency is (A_drop)^T g, as JAX's
    # autodiff of the dropped form gives it
    x = torch.randn(n, 8, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    g = torch.randn(n, 8, generator=torch.Generator().manual_seed(2))
    propagate.adj_mm(dropped, x).backward(g)
    want = b.T @ g.double()
    if name == "sectors_bf16":
        # JAX's autodiff rounds each block's product to bfloat16
        offs = np.cumsum((0,) + dropped.sizes)
        want = torch.zeros_like(want)
        for blk, (ri, ci) in zip(dropped.blocks, dropped.coords):
            part = blk.double().T @ g[offs[ri]:offs[ri + 1]].double()
            want[offs[ci]:offs[ci + 1]] += part.float().bfloat16().double()
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_edge_dropout_draws_from_the_generator():
    adj, n = _form("hybrid")
    a, b = (_dense(propagate.edge_dropout(
        adj, RATE, torch.Generator().manual_seed(9), True), n)
        for _ in range(2))
    c = _dense(propagate.edge_dropout(adj, RATE,
                                      torch.Generator().manual_seed(10),
                                      True), n)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------- softmax

def test_ell_softmax_equals_jax():
    rng = np.random.default_rng(0)
    graph = tsyn.synthetic_graph(**TINY)
    coo = graph.joint_norm_adj("si_norm", True)
    keep = coo.row % 7 != 3  # rows 3, 10, ... lose every edge
    host = ell.build_ell(coo.row[keep], coo.col[keep], coo.val[keep],
                         *coo.shape)
    assert (host.deg == 0).any()
    scores = rng.normal(size=host.idx.shape).astype(np.float32) * 3
    jell_ = jell.Ell(idx=jnp.asarray(host.idx), val=jnp.asarray(host.val),
                     deg=jnp.asarray(host.deg))
    w = rng.normal(size=scores.shape).astype(np.float32)
    want, jgrad = jax.jit(lambda x: (
        jprop.ell_softmax(jell_, x),
        jax.grad(lambda y: jnp.sum(jprop.ell_softmax(jell_, y) * w))(x)))(
        jnp.asarray(scores))
    dev = ell.to_device(host, "cpu")
    s = torch.tensor(scores, requires_grad=True)
    got = propagate.ell_softmax(dev, s)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert torch.all(got[torch.from_numpy(host.deg == 0)] == 0)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
