"""The port's KGAT training (samplers, phases, one shared Adam, Trainer)
against the JAX package on the CPU.

* Trajectory: from the same params, on the same fed batches, 3 BPR steps
  then 2 TransE steps through the port's Adam and Trainer.step must give
  JAX's losses under ``torch_adam`` at rtol 5e-3 (the bar of
  test_parity_torch.py: Adam's sqrt(v) amplifies float32 rounding in small
  gradients).
* Samplers are random on both sides with different generators, so they are
  held by invariants (no positive drawn, shapes, draws spread over the
  non-positives); the window sampler's (h, r, t+) batches, which draw
  nothing, must equal JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tagrec_tpu import compose as jcompose
from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.kgat import KGAT as JaxKGAT
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch.compose import build_pipeline, relation_triples
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.ops import sampling
from tagrec_tpu_torch.training.checkpoint import params_from_jax
from tagrec_tpu_torch.training.train import Trainer
from torch_threads import one_torch_thread  # noqa: F401

TRAJ_RTOL = 5e-3
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CFG = dict(agg_type="bi_inter", reg=1e-4, cor_reg=1e-4)


def _fed_batches(graph):
    """3 BPR batches (negatives outside the user's positives) and 2 TransE
    batches, from numpy."""
    rng = np.random.default_rng(123)
    train = graph.user_items["train"]
    bpr = []
    for _ in range(3):
        u = rng.choice(sorted(train), 48)
        p = np.array([rng.choice(train[x]) for x in u])
        n = np.array([rng.choice(np.setdiff1d(np.arange(graph.n_item),
                                              train[x])) for x in u])
        bpr.append(np.stack([u, p, n], axis=1).astype(np.int64))
    trips = relation_triples(graph)
    transe = []
    for _ in range(2):
        sel = trips[rng.choice(len(trips), 64)]
        neg = rng.integers(0, graph.n_nodes, 64)
        transe.append(np.concatenate([sel, neg[:, None]], axis=1))
    return bpr, transe


def _pipeline(tcfg=TrainConfig(), **cfg):
    graph = tsyn.synthetic_graph(**TINY)
    pipe = build_pipeline(graph, model_preset("kgat", **CFG, **cfg), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer


@pytest.fixture(scope="module")
def jax_trajectory(tiny_graph):
    model = JaxKGAT(tiny_graph, jax_preset("kgat", **CFG))
    params = model.init(jax.random.PRNGKey(0))
    gdev = model.device_data()
    opt = joptim.torch_adam(JaxTrainConfig().lr)
    state = opt.init(params)
    bpr, transe = _fed_batches(tiny_graph)

    def make_step(loss_fn):
        @jax.jit
        def step(p, s, batch):
            loss, grads = jax.value_and_grad(
                lambda q: sum(loss_fn(q, gdev, batch)))(p)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s, loss
        return step

    steps = ([(make_step(lambda p, g, b: model.bpr_loss(p, g, b)), b)
              for b in bpr]
             + [(make_step(model.transe_loss), b) for b in transe])
    p, losses = params, []
    for step, b in steps:
        p, state, loss = step(p, state, jnp.asarray(b, jnp.int32))
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params), losses


def test_trajectory_matches_torch_adam(jax_trajectory, tiny_graph):
    params, want = jax_trajectory
    pipe, trainer = _pipeline()
    params_from_jax(pipe.model, params)
    bpr_phase, transe_phase = pipe.phases
    assert [bpr_phase.name, transe_phase.name] == ["bpr", "transe"]
    bpr, transe = _fed_batches(tiny_graph)
    got = [float(trainer.step(phase, torch.from_numpy(b)).sum())
           for phase, batches in ((bpr_phase, bpr), (transe_phase, transe))
           for b in batches]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=1e-5)
    # torch's Adam skips what TransE leaves without a grad (mat.*), as
    # torch_adam skips leaves with an exactly-zero gradient
    state = trainer.opt.state
    steps = {n: int(state[p]["step"]) for n, p in
             pipe.model.named_parameters()}
    assert steps["mat.W1_0"] == 3 and steps["user"] == 5


def test_trainer_runs_both_phases():
    pipe, trainer = _pipeline(TrainConfig(train_batch=64), transe_batch=128)
    assert [ph.steps_per_epoch > 2 for ph in pipe.phases] == [True, True]
    before = {n: p.detach().clone() for n, p in pipe.model.named_parameters()}
    out = trainer.run_epoch(max_steps=2)
    assert list(out) == ["bpr", "transe"]
    assert out["bpr"].shape == (2, 2) and out["transe"].shape == (2, 2)
    assert all(np.isfinite(v).all() for v in out.values())
    assert all(not torch.equal(before[n], p)
               for n, p in pipe.model.named_parameters())


def test_bpr_phase_batches():
    pipe, trainer = _pipeline()
    phase = pipe.phases[0]
    train = pipe.graph.user_items["train"]
    edges = pipe.graph.edge_index["train"]
    gen = trainer.generator
    shuffled = phase.epoch_reset(gen, phase.data)
    assert sorted(map(tuple, shuffled.tolist())) == sorted(map(tuple,
                                                               edges.tolist()))
    batch = phase.make_batch(gen, 0, shuffled, phase.data)
    assert batch.shape == (min(TrainConfig().train_batch, len(edges)), 3)
    for u, p, n in batch.tolist():
        assert p in train[u] and n not in train[u] and 0 <= n < pipe.graph.n_item


def test_sample_negatives_invariants():
    graph = tsyn.synthetic_graph(**TINY)
    train = graph.user_items["train"]
    pt = sampling.build_pos_table(train, graph.n_user, graph.n_item,
                                  device="cpu")
    assert pt.table.shape[1] % 8 == 0
    gen = torch.Generator().manual_seed(5)
    heads = torch.arange(graph.n_user).repeat(200)
    neg = sampling.sample_negatives(gen, pt, heads)
    assert neg.shape == heads.shape
    assert not sampling.contains(pt, heads, neg).any()
    assert sampling.contains(pt, heads, pt.table[heads, 0]).all()
    # user 0's 200 draws spread over its non-positives: at least 3/4 of the
    # distinct ids that 200 uniform draws over them are expected to hit
    draws = neg[heads == 0].numpy()
    allowed = np.setdiff1d(np.arange(graph.n_item), train[0])
    assert set(draws) <= set(allowed)
    expected = len(allowed) * (1 - np.exp(-200 / len(allowed)))
    assert len(set(draws)) > 0.75 * expected


def test_sample_negatives_from_set_invariants():
    graph = tsyn.synthetic_graph(**TINY)
    trips = relation_triples(graph)
    ts, keys = sampling.build_triple_set(trips, 6, graph.n_nodes,
                                         device="cpu")
    observed = {(int(h) * 6 + int(r), int(t)) for h, r, t in trips}
    assert ts.codes.shape == (len(trips),) == (len(observed),)
    gen = torch.Generator().manual_seed(6)
    k = keys.repeat(3)
    neg = sampling.sample_negatives_from_set(gen, ts, k)
    assert neg.shape == k.shape
    assert not any((int(a), int(b)) in observed
                   for a, b in zip(k.tolist(), neg.tolist()))
    assert sampling._pair_member(ts, keys, torch.from_numpy(trips[:, 2])).all()
    assert len(set(neg.tolist())) > 0.5 * graph.n_nodes


def test_window_batches_equal_jax(tiny_graph):
    jpipe = jcompose.build_pipeline(tiny_graph, jax_preset("kgat", **CFG),
                                    JaxTrainConfig())
    jphase = jpipe.phases[1]
    pipe, trainer = _pipeline()
    phase = pipe.phases[1]
    assert phase.steps_per_epoch == jphase.steps_per_epoch
    key = jax.random.PRNGKey(0)
    jstate = jphase.epoch_reset(key, jphase.data)
    state = phase.epoch_reset(trainer.generator, phase.data)
    for i in (0, 1, phase.steps_per_epoch - 1):
        want = np.asarray(jphase.make_batch(key, i, jstate, jphase.data))
        got = phase.make_batch(trainer.generator, i, state, phase.data).numpy()
        np.testing.assert_array_equal(got[:, :3], want[:, :3])


@pytest.mark.parametrize("name", ["ngcf", "disenhan"])
def test_ngcf_and_disenhan_train(name):
    """NGCF takes the BPR phase and DisenHAN the resampling phase, as in
    JAX's build_pipeline."""
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=64)
    pipe = build_pipeline(graph, model_preset(name, dim_layer_list=(64,)),
                          tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    (phase,) = pipe.phases
    assert phase.name == "bpr"
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    batch = phase.make_batch(trainer.generator, 0,
                             phase.epoch_reset(trainer.generator, phase.data),
                             phase.data)
    assert isinstance(batch, dict) == (name == "disenhan")
    assert np.isfinite(trainer.run_epoch(max_steps=2)["bpr"]).all()


@pytest.mark.parametrize("name,label", [("tgcn", "A17")])
def test_only_kgat_trains(name, label):
    """Every family trains now (TGCN with its TransTag phase), on every
    tier: TGCN's EdgeMap tier (``adj_mode="ell"``, ROADMAP ``label``),
    which raised until it was ported, builds both phases and steps."""
    graph = tsyn.synthetic_graph(**TINY)
    for cfg in ({}, {"adj_mode": "ell"}):
        pipe = build_pipeline(graph, model_preset(name, **cfg),
                              TrainConfig(),
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
        assert [ph.name for ph in pipe.phases] == ["bpr", "transtag"]
    assert pipe.model.ell
    trainer = Trainer(pipe.model, pipe.phases, TrainConfig(),
                      generator=torch.Generator().manual_seed(0))
    assert np.isfinite(trainer.run_epoch(max_steps=1)["bpr"]).all()
