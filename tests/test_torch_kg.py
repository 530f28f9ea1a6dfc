"""The port's KGAT over a true knowledge graph against the JAX package on
the CPU.

The loader (file and ``synthetic`` modes), ``rel_id_host`` and the
pipeline's TransE triples are array-equal to JAX's;
``rel_dense_row_softmax_scores`` (with and without row segments) and the
KG model on the relation-dense tier (2 layers at narrow widths, JAX's
params carried across) match JAX's forward at rtol 1e-4, atol 1e-5, its
gradients at rtol 5e-4 and a 3-step Adam trajectory (BPR, BPR, TransE) at
rtol 5e-3; the bf16 score planes at rtol 2e-3, atol 1e-4.  A KG with
parallel (h, t) edges takes the EdgeMap tier.  JAX's
steps are jitted in one module fixture.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.data.kg import KnowledgeGraph as JaxKG
from tagrec_tpu.models.kgat import KGAT as JaxKGAT
from tagrec_tpu.ops import dense_adj as jdense
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch import serving
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.data.kg import KnowledgeGraph
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import dense_adj
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.train import Trainer
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 5e-4
TRAJ_RTOL = 5e-3
BF16_RTOL, BF16_ATOL = 2e-3, 1e-4
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
KG = dict(n_entity=120, n_triples=400, n_rela=3, seed=0)
CFG = dict(agg_type="bi_inter", dim_latent=16, dim_layer_list=(16, 8),
           dim_relation=16, reg=1e-4, cor_reg=1e-4)
SEQ = (0, 0, 1)  # the fed steps: BPR, BPR, TransE


def _kgs(tiny_graph):
    """The same synthetic KG in both packages."""
    graph = tsyn.synthetic_graph(**TINY)
    return (graph, KnowledgeGraph.synthetic(graph, **KG),
            JaxKG.synthetic(tiny_graph, **KG))


def _fed(graph, kg):
    """BPR batches of 48 and a TransE batch of 64 over the KG's triplets,
    from numpy."""
    rng = np.random.default_rng(123)
    train = graph.user_items["train"]
    out = []
    for ph in SEQ:
        if ph == 0:
            u = rng.choice(sorted(train), 48)
            p = np.array([rng.choice(train[x]) for x in u])
            n = np.array([rng.choice(np.setdiff1d(np.arange(graph.n_item),
                                                  train[x])) for x in u])
            out.append(np.stack([u, p, n], axis=1).astype(np.int64))
        else:
            sel = kg.all_triplet[rng.choice(len(kg.all_triplet), 64)]
            neg = rng.integers(0, graph.n_user + kg.num_entity, 64)
            out.append(np.concatenate([sel, neg[:, None]],
                                      axis=1).astype(np.int64))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    """JAX's KG model on the relation-dense tier: params, forward, the
    first step's parts and grads, the trajectory's losses and counts; the
    bf16 forward."""
    graph, kg, jkg = _kgs(tiny_graph)
    fed = _fed(graph, kg)
    model = JaxKGAT(tiny_graph, jax_preset("kgat", **CFG), kg=jkg)
    assert model.kg_rel_dense
    gdev = model.device_data()
    params = model.init(jax.random.PRNGKey(0))
    opt = joptim.torch_adam(JaxTrainConfig().lr)

    def make_step(loss_fn):
        @jax.jit
        def step(p, s, batch):
            def total(q):
                parts = loss_fn(q, gdev, batch)
                return sum(parts), parts

            (_, parts), grads = jax.value_and_grad(total, has_aux=True)(p)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s, parts, grads
        return step

    steps = [make_step(lambda p, g, b: model.bpr_loss(p, g, b)),
             make_step(model.transe_loss)]
    p, s, losses, first = params, opt.init(params), [], None
    for ph, b in zip(SEQ, fed):
        p, s, parts, grads = steps[ph](p, s, jnp.asarray(b, jnp.int32))
        if first is None:
            first = ([float(x) for x in parts],
                     dict(checkpoint._leaves(_np(grads))))
        losses.append(float(sum(parts)))
    m16 = JaxKGAT(tiny_graph, jax_preset("kgat", adj_dtype="bf16", **CFG),
                  kg=jkg)
    g16 = m16.device_data()
    return {"params": _np(params), "fed": fed, "first": first,
            "losses": losses,
            "counts": {k: int(v) for k, v in checkpoint._leaves(_np(s.count))},
            "segments": model._kg_row_segments,
            "rel_id": np.asarray(gdev["rel_id"]),
            "forward": [np.asarray(e) for e in jax.jit(
                lambda q: model.forward(q, gdev))(params)],
            "bf16": [np.asarray(e) for e in jax.jit(
                lambda q: m16.forward(q, g16))(params)]}


def _pipeline(run=None, **cfg):
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = tsyn.synthetic_graph(**TINY)
    kg = KnowledgeGraph.synthetic(graph, **KG)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("kgat", **{**CFG, **cfg}), tcfg,
                          kg=kg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    if run is not None:
        checkpoint.params_from_jax(pipe.model, run["params"])
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer, kg


def _assert_kg_equal(got, want):
    assert (got.num_entity, got.num_rela, got.num_relation) == (
        want.num_entity, want.num_rela, want.num_relation)
    np.testing.assert_array_equal(got.kg_data, want.kg_data)
    np.testing.assert_array_equal(got.all_triplet, want.all_triplet)
    g, w = got.relation_dict(), want.relation_dict()
    assert g.keys() == w.keys()
    for r in g:
        np.testing.assert_array_equal(g[r], w[r])


@pytest.mark.parametrize("mode", ["file", "synthetic"])
def test_loader_equals_jax(tiny_graph, tmp_path, mode):
    graph = tsyn.synthetic_graph(**TINY)
    if mode == "synthetic":
        _assert_kg_equal(KnowledgeGraph.synthetic(graph, **KG),
                         JaxKG.synthetic(tiny_graph, **KG))
        return
    d = tmp_path / "kgds"
    d.mkdir()
    rng = np.random.default_rng(0)
    # repeated rows too: the loader drops them
    kg = np.stack([rng.integers(0, 120, 400), rng.integers(0, 3, 400),
                   rng.integers(0, 120, 400)], axis=1)
    np.savetxt(d / "kg_final.txt", np.concatenate([kg, kg[:7]]), fmt="%d")
    got = KnowledgeGraph(graph, str(tmp_path), "kgds")
    _assert_kg_equal(got, JaxKG(tiny_graph, str(tmp_path), "kgds"))
    assert len(got.kg_data) == len(np.unique(kg, axis=0))


def test_rel_id_host_equals_jax():
    rng = np.random.default_rng(3)
    n = 50
    cells = rng.choice(n * n, 300, replace=False)
    rows, cols = cells // n, cells % n
    rels = rng.integers(0, 14, 300)
    got = dense_adj.rel_id_host(rows, cols, rels, n, n)
    want = jdense.rel_id_host(rows, cols, rels, n, n)
    assert got.dtype == np.int8 and (got == -1).sum() == n * n - 300
    np.testing.assert_array_equal(got, want)
    # a parallel edge, and more than 127 relations: not dense
    par = (np.append(rows, rows[0]), np.append(cols, cols[0]),
           np.append(rels, (rels[0] + 1) % 14))
    many = (rows, cols, np.where(np.arange(300) == 5, 128, rels))
    for r, c, rl in (par, many):
        assert dense_adj.rel_id_host(r, c, rl, n, n) is None
        assert jdense.rel_id_host(r, c, rl, n, n) is None


@pytest.mark.parametrize("segmented", [False, True])
def test_rel_dense_scores_equal_jax(segmented):
    """P and the VJP of random cotangents through q and k; row chunks of 16
    over 70 rows, so the last chunk is a slice."""
    rng = np.random.default_rng(4)
    r_, n, dq = 5, 70, 8
    q = rng.standard_normal((r_, n, dq)).astype(np.float32)
    k = rng.standard_normal((r_, n, dq)).astype(np.float32)
    rel = rng.integers(-1, r_, (n, n))
    if segmented:  # rows 0..29 carry relation 0 only, the rest 1..4
        rel[:30] = np.where(rel[:30] > 0, -1, rel[:30])
        rel[30:] = np.where(rel[30:] == 0, -1, rel[30:])
        segs = ((0, 30, (0,)), (30, 40, (1, 2, 3, 4)))
    else:
        segs = None
    rel[7] = -1  # a row without edges
    rel = rel.astype(np.int8)
    cot = rng.standard_normal((n, n)).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jdense.rel_dense_row_softmax_scores(
            a, b, jnp.asarray(rel), chunk=16, row_segments=segs) * cot)

    want = np.asarray(jdense.rel_dense_row_softmax_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(rel), chunk=16,
        row_segments=segs))
    wq, wk = jax.grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.tensor(x, requires_grad=True) for x in (q, k))
    got = dense_adj.rel_dense_row_softmax_scores(
        tq, tk, torch.from_numpy(rel), chunk=16, row_segments=segs)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert (got[7] == 0).all()
    for g, w in ((tq.grad, wq), (tk.grad, wk)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=ATOL)


def test_model_tier_and_buffers(jax_run):
    pipe, _, kg = _pipeline(jax_run)
    model = pipe.model
    assert model.kg_rel_dense and not model.flash
    assert (model.num_entity, model.num_relation) == (kg.num_entity,
                                                      kg.num_relation)
    assert [n for n, _ in model.named_buffers()] == ["rel_id"]
    assert model.rel_id.dtype == torch.int8
    np.testing.assert_array_equal(model.rel_id.numpy(), jax_run["rel_id"])
    assert model._kg_row_segments == jax_run["segments"]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["entity"] == (kg.num_entity, 16)
    assert shapes["transE"] == (kg.num_relation, 16, 16)


def test_forward_equals_jax(jax_run):
    pipe, _, _ = _pipeline(jax_run)
    with torch.no_grad():
        got = pipe.model.forward()
    assert [t.shape[1] for t in got] == [16 + 16 + 8] * 2
    for a, b in zip(got, jax_run["forward"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)


def test_loss_and_gradients_equal_jax(jax_run):
    pipe, _, _ = _pipeline(jax_run)
    model = pipe.model
    parts = model.bpr_loss(torch.from_numpy(jax_run["fed"][0]))
    sum(parts).backward()
    want_parts, want_grads = jax_run["first"]
    np.testing.assert_allclose([float(x.detach()) for x in parts],
                               want_parts, rtol=RTOL, atol=1e-7)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                                   rtol=GRAD_RTOL, atol=ATOL, err_msg=name)
    # the attention is not detached: relation and transE get gradients
    assert float(model.relation.grad.abs().max()) > 0


def test_adam_trajectory_equals_jax(jax_run):
    pipe, trainer, _ = _pipeline(jax_run)
    assert [ph.name for ph in pipe.phases] == ["bpr", "transe"]
    got = [float(trainer.step(pipe.phases[ph], torch.from_numpy(b)).sum())
           for ph, b in zip(SEQ, jax_run["fed"])]
    np.testing.assert_allclose(got[0], jax_run["losses"][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, jax_run["losses"], rtol=TRAJ_RTOL,
                               atol=1e-6)
    state = trainer.opt.state
    counts = {n: int(state[p]["step"]) if p in state else 0
              for n, p in pipe.model.named_parameters()}
    assert counts == jax_run["counts"]


def test_bf16_score_planes_equal_jax(jax_run):
    pipe, _, _ = _pipeline(jax_run, adj_dtype="bf16")
    with torch.no_grad():
        got = pipe.model.forward()
    for a, b, f32 in zip(got, jax_run["bf16"], jax_run["forward"]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        assert not np.array_equal(b, f32)  # bf16 really ran


def test_parallel_edges_raise_a17():
    """One (h, t) pair under two relations cannot share a cell: JAX falls
    back to the EdgeMap tier, and so does the port since the tier was
    ported (A17; this raised before), as under ``adj_mode="ell"``: the two
    maps and their slot tables, no ``rel_id`` (held against JAX in
    test_torch_edgemap_models.py)."""
    graph = tsyn.synthetic_graph(**TINY)
    kg = KnowledgeGraph.synthetic(graph, **KG)
    h, r, t = kg.kg_data[0]
    kg.kg_data = np.concatenate([kg.kg_data, [[h, (r + 1) % 3, t]]])
    kg._finish_init()
    gen = torch.Generator().manual_seed(0)
    for cfg, g in ((model_preset("kgat", **CFG), kg),
                   (model_preset("kgat", **CFG, adj_mode="ell"),
                    KnowledgeGraph.synthetic(graph, **KG))):
        m = model_class("kgat")(graph, cfg, device="cpu", generator=gen,
                                kg=g)
        assert not m.kg_rel_dense and not m.dense
        assert {n.split("_")[0] for n, _ in m.named_buffers()} == {
            "edges.em", "edges.emk", "edges.k2n", "edges.n2k"}
    # quirk #3 builds nothing, so nothing raises
    m = model_class("kgat")(graph, model_preset("kgat", dim_latent=16,
                                                dim_relation=16),
                            device="cpu", generator=gen, kg=kg)
    assert m.skip_adj and not list(m.named_buffers())
    assert m.entity.shape[0] == kg.num_entity


def test_transe_phase_triples(tiny_graph):
    """The TransE phase runs over the KG's triplets, JAX's window sampler
    (quirk #5, the kgat preset's) giving the same (h, r, t+) batches."""
    from tagrec_tpu import compose as jcompose

    pipe, trainer, kg = _pipeline()
    phase = pipe.phases[1]
    np.testing.assert_array_equal(phase.data["trips"].numpy(), kg.all_triplet)
    jkg = JaxKG.synthetic(tiny_graph, **KG)
    jpipe = jcompose.build_pipeline(tiny_graph, jax_preset("kgat", **CFG),
                                    JaxTrainConfig(), kg=jkg)
    jphase = jpipe.phases[1]
    assert phase.steps_per_epoch == jphase.steps_per_epoch
    key = jax.random.PRNGKey(0)
    jstate = jphase.epoch_reset(key, jphase.data)
    state = phase.epoch_reset(trainer.generator, phase.data)
    observed = {tuple(x) for x in kg.all_triplet[:, :3].tolist()}
    n_ids = kg.graph.n_user + kg.num_entity
    for i in (0, phase.steps_per_epoch - 1):
        want = np.asarray(jphase.make_batch(key, i, jstate, jphase.data))
        got = phase.make_batch(trainer.generator, i, state, phase.data).numpy()
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        assert ((got[:, 3] >= 0) & (got[:, 3] < n_ids)).all()
        assert not any((h, r, n) in observed for h, r, _, n in got.tolist())


def test_pipeline_trains_evaluates_and_exports():
    pipe, trainer, kg = _pipeline()
    out = trainer.run_epoch(max_steps=2)
    assert list(out) == ["bpr", "transe"]
    assert all(np.isfinite(v).all() for v in out.values())
    res = pipe.evaluator.run(pipe.model)
    assert 0.0 < res["auc"][0] < 1.0
    graph = pipe.graph
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    assert u_t.shape == (graph.n_user, 40) and i_t.shape == (graph.n_item, 40)
    assert np.isfinite(u_t).all() and np.isfinite(i_t).all()
    with torch.no_grad():
        assert pipe.model.forward()[1].shape[0] == kg.num_entity
