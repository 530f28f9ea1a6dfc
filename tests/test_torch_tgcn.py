"""The port's TGCN against the JAX package on the CPU.

Two layers at narrow widths (``dim_latent=16``, ``dim_layer_list=(16, 8)``)
with the preset's k = 25, so the dedup ladder is exercised; JAX's neighbour
tables are fed to the port, and JAX's params carried across.  The port
draws its default tables as JAX does (its native sampler, the numpy loop
only when no library loads), so those fed tables equal its own.
On ``auto`` (the dedup buckets) and ``dense_xla`` (the plain takes): the
forward at rtol 1e-4, atol 1e-5; the BPR and TransTag loss parts at rtol
1e-4 and every gradient at rtol 5e-4; a 5-step Adam trajectory (BPR, BPR,
TransTag, TransTag, BPR) under ``torch_adam`` at rtol 5e-3; the bf16
forwards at rtol 2e-3, atol 1e-4 (``dense_xla`` against JAX's eager bf16
forward: jitted, XLA keeps its fused bf16 intermediates in float32).  The sampler (against JAX's native
sampler, and against JAX's numpy fallback with both native libraries
switched off), the default tables and the dedup buckets are array-equal.
JAX's steps are jitted in one module fixture.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tagrec_tpu import runtime as jruntime
from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models import tgcn as jtgcn
from tagrec_tpu.ops import losses as jlosses
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch import runtime, serving
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.models import tgcn
from tagrec_tpu_torch.ops import losses, sampling
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.train import Trainer
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 5e-4
TRAJ_RTOL = 5e-3
BF16_RTOL, BF16_ATOL = 2e-3, 1e-4
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CFG = dict(dim_latent=16, dim_layer_list=(16, 8), reg=1e-3)
MODES = ("auto", "dense_xla")
# the fed steps: phase index per step (0 BPR, 1 TransTag)
SEQ = (0, 0, 1, 1, 0)


def _fed(graph):
    """BPR batches of 48 (a negative outside the user's positives) and
    TransTag batches of 64 (user, tag, item+, item-), from numpy, in
    SEQ's order."""
    rng = np.random.default_rng(123)
    train = graph.user_items["train"]
    uti = graph.uit_data[:, [0, 2, 1]]
    out = []
    for ph in SEQ:
        if ph == 0:
            u = rng.choice(sorted(train), 48)
            p = np.array([rng.choice(train[x]) for x in u])
            n = np.array([rng.choice(np.setdiff1d(np.arange(graph.n_item),
                                                  train[x])) for x in u])
            out.append(np.stack([u, p, n], axis=1).astype(np.int64))
        else:
            sel = uti[rng.choice(len(uti), 64)]
            neg = rng.integers(0, graph.n_item, 64)
            out.append(np.concatenate([sel, neg[:, None]],
                                      axis=1).astype(np.int64))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    """Per mode: JAX's model, tables, params, forward, first-step parts and
    grads (BPR and TransTag at the init params), the trajectory's losses
    and step counts; and the bf16 forwards."""
    fed = _fed(tiny_graph)
    out = {}
    for mode in MODES:
        model = jtgcn.TGCN(tiny_graph, jax_preset("tgcn", adj_mode=mode, **CFG))
        gdev = model.device_data()
        params = model.init(jax.random.PRNGKey(0))
        opt = joptim.torch_adam(JaxTrainConfig().lr)
        fns = (lambda p, b: model.bpr_loss(p, gdev, b),
               lambda p, b: model.transtag_loss(p, gdev, b))

        def make_step(loss_fn):
            @jax.jit
            def step(p, s, batch):
                def total(q):
                    parts = loss_fn(q, batch)
                    return sum(parts), parts

                (_, parts), grads = jax.value_and_grad(total, has_aux=True)(p)
                updates, s = opt.update(grads, s, p)
                return optax.apply_updates(p, updates), s, parts, grads
            return step

        steps = [make_step(f) for f in fns]
        p, s, losses_, first = params, opt.init(params), [], {}
        for ph, b in zip(SEQ, fed):
            p2, s, parts, grads = steps[ph](p, s, jnp.asarray(b, jnp.int32))
            if ph not in first:  # the first step of each phase
                first[ph] = ([float(x) for x in parts],
                             dict(checkpoint._leaves(_np(grads))), _np(p))
            p = p2
            losses_.append(float(sum(parts)))
        # the same seed draws the same tables
        bf16 = jtgcn.TGCN(tiny_graph, jax_preset(
            "tgcn", adj_mode=mode, adj_dtype="bf16", **CFG))
        bf16_gdev = bf16.device_data()
        out[mode] = {
            "tables": [(np.asarray(i), np.asarray(w)) for i, w in model._tables],
            "dedup": model._dedup_host,
            "params": _np(params), "first": first, "losses": losses_,
            "counts": {k: int(v) for k, v in checkpoint._leaves(_np(s.count))},
            "forward": [np.asarray(e) for e in jax.jit(
                lambda q: model.forward(q, gdev))(params)],
            # dense_xla eager: under jit, XLA's fusions keep its bf16
            # intermediates in float32 (its default excess precision),
            # which the port's op-by-op bf16 does not (up to 3.4e-4 apart)
            "bf16": [np.asarray(e) for e in (
                bf16.forward(params, bf16_gdev) if mode == "dense_xla" else
                jax.jit(lambda q: bf16.forward(q, bf16_gdev))(params))]}
    out["fed"] = fed
    return out


def _model(mode, run=None, **kw):
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = tsyn.synthetic_graph(**TINY)
    model = model_class("tgcn")(
        graph, model_preset("tgcn", adj_mode=kw.pop("adj_mode", mode),
                            **CFG, **kw),
        device="cpu", generator=torch.Generator().manual_seed(0),
        tables=run["tables"] if run else None)
    if run:
        checkpoint.params_from_jax(model, run["params"])
    return model


@pytest.mark.parametrize("k", [25, 42])
def test_sampler_equals_jax_native(tiny_graph, k):
    """Both native libraries load here (g++ is present): the port's draw
    of every relation's table equals JAX's native draw at two seeds."""
    assert jruntime.available() and runtime.sampler() == "native"
    graph = tsyn.synthetic_graph(**TINY)
    for seed in (0, 3):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for coo, jcoo in zip((graph.ui_adj, graph.it_adj, graph.ut_adj),
                             (tiny_graph.ui_adj, tiny_graph.it_adj,
                              tiny_graph.ut_adj)):
            got = tgcn._sample_neighbor_table(coo, k, rng)
            want = jtgcn._sample_neighbor_table(jcoo, k, jrng)
            assert got[0].shape == (coo.shape[0], k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_default_tables_equal_jax_default(tiny_graph):
    """From one seed the port's TGCN holds JAX's default tables."""
    want = jtgcn.TGCN(tiny_graph, jax_preset("tgcn", **CFG))._tables
    model = _model("auto")
    assert model.sampler == "native"
    assert len(model.tables_host) == len(want) == 6
    for (gi, gw), (wi, ww) in zip(model.tables_host, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)


def test_sampler_equals_jax_fallback(tiny_graph, monkeypatch):
    """With both native libraries off, JAX's tables are its numpy
    fallback's: the port's default tables equal them, and so does each
    draw."""
    monkeypatch.setattr(jruntime, "get_lib", lambda: None)
    monkeypatch.setattr(runtime, "get_lib", lambda: None)
    want = jtgcn.TGCN(tiny_graph, jax_preset("tgcn", **CFG))._tables
    model = _model("auto")
    assert model.sampler == "numpy"
    got = model.tables_host
    assert len(got) == len(want) == 6
    for (gi, gw), (wi, ww) in zip(got, want):
        assert gi.shape[1] == 25
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
    graph = tsyn.synthetic_graph(**TINY)
    for seed in (0, 3):
        got = tgcn._sample_neighbor_table(graph.it_adj, 7,
                                          np.random.default_rng(seed))
        want = jtgcn._sample_neighbor_table(tiny_graph.it_adj, 7,
                                            np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [25, 42])
def test_dedup_buckets_equal_jax(jax_run, k):
    """The buckets and ``inv`` of JAX's tables, and of a k = 42 table, which
    takes the ladder's extra rungs."""
    if k == 25:
        tables = jax_run["auto"]["tables"]
    else:
        rng = np.random.default_rng(1)
        deg = rng.integers(0, 60, 200)
        idx = np.where(np.arange(k)[None] < 60, rng.integers(
            0, deg[:, None] + 1, (200, k)), 0).astype(np.int32)
        tables = [(idx, rng.integers(0, 3, (200, k)).astype(np.int32))]
    for idx, w in tables:
        got, got_inv = tgcn._build_dedup_buckets(idx, w)
        want, want_inv = jtgcn._build_dedup_buckets(idx, w)
        assert len(got) == len(want) > 1
        np.testing.assert_array_equal(got_inv, want_inv)
        for g, wb in zip(got, want):
            for a, b in zip(g, wb):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    if k == 42:
        assert want[-1][1].shape[1] == 42


def test_model_buffers_are_jax_tables(jax_run):
    model = _model("auto", jax_run["auto"])
    for name, (idx, w), (buckets, inv) in zip(
            tgcn.REL_ORDER, jax_run["auto"]["tables"],
            jax_run["auto"]["dedup"]):
        t_idx, t_w = model.table(name)
        np.testing.assert_array_equal(t_idx.numpy(), idx)
        np.testing.assert_array_equal(t_w.numpy(), w)
        got, got_inv = model.buckets(name)
        np.testing.assert_array_equal(got_inv.numpy(), inv)
        for g, wb in zip(got, buckets):
            for a, b in zip(g, wb):
                np.testing.assert_array_equal(a.numpy(), b)
    assert not _model("dense_xla", jax_run["dense_xla"]).dedup


@pytest.mark.parametrize("mode", MODES)
def test_forward_equals_jax(jax_run, mode):
    with torch.no_grad():
        got = _model(mode, jax_run[mode]).forward()
    assert [t.shape[1] for t in got] == [16 + 16 + 8] * 3
    for a, b in zip(got, jax_run[mode]["forward"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_loss_and_gradients_equal_jax(jax_run, mode):
    """BPR's and TransTag's parts and every gradient at the step's params."""
    run = jax_run[mode]
    for ph, fn in ((0, "bpr_loss"), (1, "transtag_loss")):
        want_parts, want_grads, params = run["first"][ph]
        model = _model(mode, run)
        checkpoint.params_from_jax(model, params)
        parts = getattr(model, fn)(torch.from_numpy(
            jax_run["fed"][SEQ.index(ph)]))
        sum(parts).backward()
        np.testing.assert_allclose([float(x.detach()) for x in parts],
                                   want_parts,
                                   rtol=RTOL, atol=1e-7)
        for name, p in model.named_parameters():
            g = np.zeros(tuple(p.shape)) if p.grad is None else p.grad.numpy()
            np.testing.assert_allclose(g, want_grads[name], rtol=GRAD_RTOL,
                                       atol=ATOL, err_msg=f"{fn} {name}")


@pytest.mark.parametrize("mode", MODES)
def test_adam_trajectory_equals_jax(jax_run, mode):
    run = jax_run[mode]
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", adj_mode=mode, **CFG),
                          tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert [ph.name for ph in pipe.phases] == ["bpr", "transtag"]
    # the pipeline's phases, their losses those of a model on JAX's tables
    model = _model(mode, run)
    phases = [dataclasses.replace(pipe.phases[0], loss_fn=lambda b, g:
                                  model.bpr_loss(b, generator=g)),
              dataclasses.replace(pipe.phases[1], loss_fn=lambda b, g:
                                  model.transtag_loss(b))]
    trainer = Trainer(model, phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    got = [float(trainer.step(phases[ph], torch.from_numpy(b)).sum())
           for ph, b in zip(SEQ, jax_run["fed"])]
    np.testing.assert_allclose(got[0], run["losses"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, run["losses"], rtol=TRAJ_RTOL, atol=1e-6)
    state = trainer.opt.state
    counts = {n: int(state[p]["step"]) if p in state else 0
              for n, p in model.named_parameters()}
    assert counts == run["counts"]
    assert counts["embed.0"] == 5 and counts["layers.0.Wf"] == 3


def test_auto_equals_dense_xla():
    """The port's two tiers, the same weights and tables: the same sums
    grouped two ways."""
    outs = []
    batch = torch.tensor([[0, 1, 2], [3, 4, 5], [39, 89, 0]])
    for mode in MODES:
        model = _model(mode)
        fwd = [t.detach() for t in model.forward()]
        sum(model.bpr_loss(batch)).backward()
        outs.append((fwd, {n: p.grad for n, p in model.named_parameters()}))
    (fa, ga), (fd, gd) = outs
    for a, b in zip(fa, fd):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert ga.keys() == gd.keys()
    for n in ga:
        torch.testing.assert_close(ga[n], gd[n], rtol=GRAD_RTOL, atol=ATOL,
                                   msg=n)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_forward_equals_jax(jax_run, mode):
    run = jax_run[mode]
    with torch.no_grad():
        got = _model(mode, run, adj_dtype="bf16").forward()
    for a, b, f32 in zip(got, run["bf16"], run["forward"]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        assert not np.array_equal(b, f32)  # bf16 really ran


def test_resample_each_layer_invariants():
    """Each training forward draws fresh [N, k] slots per layer: every draw
    a real neighbour + 1 (and its weight id), degree-0 rows all 0."""
    graph = tsyn.synthetic_graph(**TINY)
    model = model_class("tgcn")(graph, model_preset("tgcn", **CFG),
                                device="cpu", resample_each_layer=True,
                                generator=torch.Generator().manual_seed(0))
    assert not model.dedup
    gen = torch.Generator().manual_seed(4)
    draws = [model._resample(gen) for _ in range(2)]
    adjs = [graph.ui_adj, graph.ut_adj, graph.ui_adj.transpose(),
            graph.it_adj, graph.ut_adj.transpose(), graph.it_adj.transpose()]
    for name, a in zip(tgcn.REL_ORDER, adjs):
        weight = {(int(r), int(c)): int(v)
                  for r, c, v in zip(a.row, a.col, a.val)}
        deg = np.bincount(a.row, minlength=a.shape[0])
        for tabs in draws:
            idx, w = (t.numpy() for t in tabs[name])
            assert idx.shape == w.shape == (a.shape[0], 25)
            assert (idx[deg == 0] == 0).all() and (w[deg == 0] == 0).all()
            for r in np.nonzero(deg)[0]:
                for c, wv in zip(idx[r], w[r]):
                    assert weight[(r, c - 1)] == wv
        assert not torch.equal(draws[0][name][0], draws[1][name][0])
    batch = torch.tensor([[0, 1, 2], [3, 4, 5]])
    a = model.bpr_loss(batch, generator=torch.Generator().manual_seed(1))[0]
    b = model.bpr_loss(batch, generator=torch.Generator().manual_seed(2))[0]
    c = model.bpr_loss(batch, generator=torch.Generator().manual_seed(1))[0]
    assert float(a.detach()) == float(c.detach()) != float(b.detach())
    with torch.no_grad():  # evaluation reads the static tables
        torch.testing.assert_close(
            model.forward()[0], _model("dense_xla").forward()[0])


def test_ell_raises_a17():
    """``adj_mode="ell"``, which raised until the EdgeMap tier was ported
    (A17), builds two EdgeMaps a relation with every row k slots wide
    (held against JAX in test_torch_edgemap_models.py)."""
    model = _model("ell")
    assert model.ell and not model.dedup
    for name in tgcn.REL_ORDER:
        for part in (0, 1):
            em = model.edges[f"em.{name}.{part}"]
            assert [tuple(i.shape) for i in em.f_idx] == [
                (model.table(name)[0].shape[0], model.cfg.neighbor_k)]


def test_transtag_loss_equals_jax():
    rng = np.random.default_rng(2)
    embs = [rng.standard_normal((32, 16)).astype(np.float32)
            for _ in range(4)]
    for margin in (0.0, 1.0):
        want = float(jlosses.transtag_loss(*map(jnp.asarray, embs),
                                           margin=margin))
        got = float(losses.transtag_loss(*map(torch.from_numpy, embs),
                                         margin=margin))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_transtag_phase_triples():
    """(user, tag, item) heads, relations and tails; each negative item
    outside the observed (user, tag, *) set."""
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", **CFG), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    phase = pipe.phases[1]
    uti = graph.uit_data[:, [0, 2, 1]]
    np.testing.assert_array_equal(phase.data["trips"].numpy(), uti)
    assert phase.steps_per_epoch == max(len(uti) // 512, 1)
    gen = torch.Generator().manual_seed(3)
    batch = phase.make_batch(gen, 0, phase.epoch_reset(gen, phase.data),
                             phase.data).numpy()
    observed = {(int(u), int(t), int(i)) for u, t, i in uti}
    assert batch.shape == (min(512, len(uti)), 4)
    assert all(tuple(row[:3]) in observed for row in batch)
    assert not any((u, t, n) in observed for u, t, _, n in batch)
    assert (batch[:, 3] < graph.n_item).all()
    assert isinstance(phase.data["ts"], sampling.TripleSet)


def test_checkpoints_cross_with_jax(jax_run, tmp_path):
    """params both ways through JAX's format, and a train state the port
    writes that JAX restores."""
    run = jax_run["auto"]
    model = _model("auto", run)
    path = str(tmp_path / "p.npz")
    checkpoint.save(path, model)
    got = jckpt.load(path, run["params"])
    for (na, a), (nb, b) in zip(checkpoint._leaves(_np(got)),
                                checkpoint._leaves(run["params"])):
        assert na == nb
        np.testing.assert_array_equal(a, b)
    jpath = str(tmp_path / "j.npz")
    jckpt.save(jpath, run["params"])
    other = _model("auto")
    checkpoint.load(jpath, other)
    for (n, p), (_, q) in zip(other.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(p, q), n
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", **CFG), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    trainer.step(pipe.phases[1], torch.from_numpy(jax_run["fed"][2]))
    spath = str(tmp_path / "s.npz")
    checkpoint.save_train_state(spath, pipe.model, trainer.opt, 1)
    opt = joptim.torch_adam(0.01)
    params, state, step = jckpt.restore_train_state(
        spath, run["params"], opt.init(run["params"]))
    assert step == 1
    counts = dict(checkpoint._leaves(_np(state.count)))
    assert counts["embed.0"] == 1 and counts["layers.1.Wf"] == 0
    named = dict(pipe.model.named_parameters())
    for leaf, arr in checkpoint._leaves(_np(params)):
        np.testing.assert_array_equal(arr, named[leaf].detach().numpy())


def test_pipeline_trains_evaluates_and_exports():
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=64)
    pipe = build_pipeline(graph, model_preset("tgcn"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    out = trainer.run_epoch(max_steps=2)
    assert list(out) == ["bpr", "transtag"]
    assert all(np.isfinite(v).all() for v in out.values())
    res = pipe.evaluator.run(pipe.model)
    assert 0.0 < res["auc"][0] < 1.0
    u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
    assert u_t.shape == (graph.n_user, 176) and i_t.shape == (graph.n_item, 176)
    assert np.isfinite(u_t).all() and np.isfinite(i_t).all()
