"""Train states (parameters, Adam's state, the epoch to resume at) cross
between the port and the JAX package on the CPU, both ways, and
``Trainer.run(state_path=...)`` resumes where it stopped.

For LightGCN and for KGAT (the shipped ``bi_agg`` preset), under
``adam_impl`` "torch" (JAX's ``torch_adam``: KGAT's TransE leaves have
count 0 after BPR steps only, the lazy state) and "global" (optax.adam, one
count), from the same params on the same fed batches:

* the port writes after 2 BPR steps and JAX's ``restore_train_state``
  reads: the port's values exactly, JAX's own step counts exactly, and
  JAX's own moments at rtol 5e-3;
* JAX writes and the port reads: JAX's values exactly, count-0 leaves
  without Adam state; then 3 more steps (KGAT: TransE, TransE, BPR) on
  both sides give the same losses, the first at rtol 1e-4 (same params)
  and the rest at rtol 5e-3, the bar of test_trajectory_matches_torch_adam
  (Adam's sqrt(v) amplifies float32 rounding in small gradients).

The whole "global" KGAT trajectory from the start is held against
``optax.adam`` at the same bar.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.kgat import KGAT as JaxKGAT
from tagrec_tpu.models.lightgcn import LightGCN as JaxLightGCN
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch.compose import build_pipeline, relation_triples
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.early_stop import EarlyStop
from tagrec_tpu_torch.training.train import Trainer

RTOL, ATOL = 1e-4, 1e-5
TRAJ_RTOL = 5e-3
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
CFG = dict(reg=1e-4)
MODELS = {"lightgcn": JaxLightGCN, "kgat": JaxKGAT}
IMPLS = ("torch", "global")
SAVED_AT = 2  # the state crosses after this many steps


def _sequence(graph, name):
    """The fed steps: (phase index, batch) x 5, BPR batches of 48 (a
    negative outside the user's positives) and TransE batches of 64."""
    rng = np.random.default_rng(123)
    train = graph.user_items["train"]

    def bpr():
        u = rng.choice(sorted(train), 48)
        p = np.array([rng.choice(train[x]) for x in u])
        n = np.array([rng.choice(np.setdiff1d(np.arange(graph.n_item),
                                              train[x])) for x in u])
        return 0, np.stack([u, p, n], axis=1).astype(np.int64)

    def transe():
        trips = relation_triples(graph)
        sel = trips[rng.choice(len(trips), 64)]
        neg = rng.integers(0, graph.n_nodes, 64)
        return 1, np.concatenate([sel, neg[:, None]], axis=1)

    if name == "kgat":
        return [bpr(), bpr(), transe(), transe(), bpr()]
    return [bpr() for _ in range(5)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs(tiny_graph):
    """Per (model, impl): the initial params; params and Adam state after
    SAVED_AT steps; the 5 losses; the step counts at the end."""
    runs = {}
    for name, cls in MODELS.items():
        model = cls(tiny_graph, jax_preset(name, **CFG))
        params = model.init(jax.random.PRNGKey(0))
        gdev = model.device_data()
        losses = [lambda p, b: sum(model.bpr_loss(p, gdev, b,
                                                  key=jax.random.PRNGKey(1)))]
        if name == "kgat":
            losses.append(lambda p, b: sum(model.transe_loss(p, gdev, b)))
        seq = _sequence(tiny_graph, name)
        for impl in IMPLS:
            opt = joptim.make_optimizer(JaxTrainConfig(adam_impl=impl))

            def make_step(loss_fn, opt=opt):
                @jax.jit
                def step(p, s, b):
                    loss, grads = jax.value_and_grad(loss_fn)(p, b)
                    updates, s = opt.update(grads, s, p)
                    return jax.tree_util.tree_map(jnp.add, p, updates), s, loss
                return step

            steps = [make_step(f) for f in losses]
            p, s, traj = params, opt.init(params), []
            for i, (phase, b) in enumerate(seq):
                if i == SAVED_AT:
                    saved = (_np(p), _np(s))
                p, s, loss = steps[phase](p, s, jnp.asarray(b, jnp.int32))
                traj.append(float(loss))
            runs[name, impl] = {"init": _np(params), "saved": saved,
                                "traj": traj, "final_state": _np(s)}
    return runs


def _port(name, impl, jax_runs):
    """The port's pipeline and Trainer on the CPU from JAX's initial
    params."""
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(adam_impl=impl)
    pipe = build_pipeline(graph, model_preset(name, **CFG), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    checkpoint.params_from_jax(pipe.model, jax_runs[name, impl]["init"])
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer


def _steps(trainer, seq):
    return [float(trainer.step(trainer.phases[phase],
                               torch.from_numpy(b)).sum())
            for phase, b in seq]


def _jax_moments(name, state, impl):
    """JAX's Adam state -> ({leaf name: count}, mu tree, nu tree)."""
    if impl == "torch":
        counts, mu, nu = state.count, state.mu, state.nu
        flat = dict(checkpoint._leaves(counts))
        return {k: int(v) for k, v in flat.items()}, mu, nu
    adam = state[0]
    return int(adam.count), adam.mu, adam.nu


def _port_counts(pipe, trainer):
    return {n: int(trainer.opt.state[p]["step"]) if p in trainer.opt.state
            else 0 for n, p in pipe.model.named_parameters()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_state_reads_in_jax(jax_runs, tiny_graph, tmp_path, name, impl):
    run = jax_runs[name, impl]
    pipe, trainer = _port(name, impl, jax_runs)
    _steps(trainer, _sequence(tiny_graph, name)[:SAVED_AT])
    path = str(tmp_path / "state.npz")
    checkpoint.save_train_state(path, pipe.model, trainer.opt, SAVED_AT, impl)
    like_p, like_s = run["saved"]
    params, state, step = jckpt.restore_train_state(path, like_p, like_s)
    assert step == SAVED_AT
    named = dict(pipe.model.named_parameters())
    for leaf, arr in checkpoint._leaves(params):
        np.testing.assert_array_equal(arr, named[leaf].detach().numpy())
    got_counts, mu, nu = _jax_moments(name, state, impl)
    want_counts, want_mu, want_nu = _jax_moments(name, like_s, impl)
    assert got_counts == want_counts
    if name == "kgat" and impl == "torch":  # the lazy state
        assert got_counts["relation"] == got_counts["transE"] == 0
        assert got_counts["user"] == SAVED_AT
    for got, want, key in ((mu, want_mu, "exp_avg"),
                           (nu, want_nu, "exp_avg_sq")):
        for (leaf, g), (_, w) in zip(checkpoint._leaves(got),
                                     checkpoint._leaves(want)):
            st = trainer.opt.state.get(named[leaf])
            port = st[key].numpy() if st else np.zeros_like(w)
            np.testing.assert_array_equal(g, port)
            np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6,
                                       err_msg=f"{key} {leaf}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_state_reads_in_port(jax_runs, tiny_graph, tmp_path, name, impl):
    run = jax_runs[name, impl]
    params, state = run["saved"]
    path = str(tmp_path / "state.npz")
    jckpt.save_train_state(path, params, state, step=SAVED_AT)
    pipe, trainer = _port(name, impl, jax_runs)
    assert checkpoint.restore_train_state(path, pipe.model, trainer.opt,
                                          impl) == SAVED_AT
    named = dict(pipe.model.named_parameters())
    for leaf, arr in checkpoint._leaves(params):
        np.testing.assert_array_equal(named[leaf].detach().numpy(), arr)
    counts, mu, nu = _jax_moments(name, state, impl)
    mu, nu = dict(checkpoint._leaves(mu)), dict(checkpoint._leaves(nu))
    for leaf, p in named.items():
        c = counts[leaf] if impl == "torch" else counts
        if c == 0:
            assert p not in trainer.opt.state, leaf
            continue
        st = trainer.opt.state[p]
        assert float(st["step"]) == c
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[leaf])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[leaf])
    got = _steps(trainer, _sequence(tiny_graph, name)[SAVED_AT:])
    want = run["traj"][SAVED_AT:]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=ATOL)
    counts = _port_counts(pipe, trainer)
    if impl == "torch":
        assert counts == _jax_moments(name, run["final_state"], impl)[0]
    else:
        assert set(counts.values()) == {5}


def test_global_adam_trajectory_matches_optax(jax_runs, tiny_graph):
    """KGAT under one Adam count: BPR, BPR, TransE, TransE, BPR against
    optax.adam; every parameter steps every time, and the run differs
    from torch's lazy Adam once TransE starts."""
    pipe, trainer = _port("kgat", "global", jax_runs)
    got = _steps(trainer, _sequence(tiny_graph, "kgat"))
    want = jax_runs["kgat", "global"]["traj"]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=ATOL)
    assert set(_port_counts(pipe, trainer).values()) == {5}
    # the tolerance tells the two Adams apart
    lazy = jax_runs["kgat", "torch"]["traj"]
    assert not np.allclose(got[3:], lazy[3:], rtol=TRAJ_RTOL, atol=ATOL)


def test_unknown_adam_impl_raises():
    with pytest.raises(ValueError, match="unknown adam_impl 'adam'"):
        Trainer(torch.nn.Linear(2, 2), [], TrainConfig(adam_impl="adam"),
                generator=torch.Generator())


def test_run_resumes_where_it_stopped(tmp_path):
    """LightGCN: 1 epoch with a state file, then a new Trainer asked for 2
    resumes at epoch 1 with the saved parameters and Adam's step counts and
    trains epoch 1 only."""
    graph = tsyn.synthetic_graph(**TINY)
    path = str(tmp_path / "state.npz")

    def trainer_for(epochs, seed):
        tcfg = TrainConfig(train_batch=64, epochs=epochs, test_interval=1)
        pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg,
                              generator=torch.Generator().manual_seed(seed),
                              device="cpu")
        return pipe, Trainer(pipe.model, pipe.phases, tcfg,
                             generator=torch.Generator().manual_seed(seed))

    pipe, trainer = trainer_for(1, 0)
    trainer.run(pipe.evaluator, EarlyStop(5), log=lambda s: None,
                state_path=path)
    saved = {n: p.detach().clone() for n, p in pipe.model.named_parameters()}
    steps = pipe.phases[0].steps_per_epoch
    assert set(_port_counts(pipe, trainer).values()) == {steps}

    pipe2, trainer2 = trainer_for(2, 1)  # other weights, other draws
    at_restart, logs = {}, []

    def log(line):
        logs.append(line)
        if line.startswith("resumed"):
            at_restart["params"] = {n: p.detach().clone() for n, p in
                                    pipe2.model.named_parameters()}
            at_restart["counts"] = _port_counts(pipe2, trainer2)

    trainer2.run(pipe2.evaluator, EarlyStop(5), log=log, state_path=path)
    assert logs[0] == f"resumed from {path} at epoch 1"
    epochs = [line.split("]")[0] for line in logs if line.startswith("[Epoch")]
    assert epochs == ["[Epoch:1", "[Epoch 1"]
    for n, p in saved.items():
        torch.testing.assert_close(at_restart["params"][n], p, rtol=0, atol=0)
    assert set(at_restart["counts"].values()) == {steps}
    assert set(_port_counts(pipe2, trainer2).values()) == {2 * steps}
    assert checkpoint.restore_train_state(path, pipe2.model,
                                          trainer2.opt) == 2


def test_non_finite_loss_names_epoch_phase_and_state(tmp_path):
    """A loss that turns non-finite in epoch 1 stops the run, naming the
    epoch, the phase and the state saved at epoch 0's evaluation."""
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=64, epochs=3, test_interval=1)
    pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    bpr = pipe.phases[0]
    clean, calls = bpr.loss_fn, [0]

    def loss_fn(batch, gen):
        calls[0] += 1
        parts = clean(batch, gen)
        if calls[0] > bpr.steps_per_epoch:
            parts = (parts[0] * float("nan"),) + tuple(parts[1:])
        return parts

    bpr.loss_fn = loss_fn
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "state.npz")
    logs = []
    with pytest.raises(FloatingPointError,
                       match=f"epoch 1 phase bpr; last saved state: {path}"):
        trainer.run(pipe.evaluator, EarlyStop(5), log=logs.append,
                    state_path=path)
    assert logs[-1].startswith("FATAL: non-finite loss in epoch 1")
    assert checkpoint.restore_train_state(path, pipe.model, trainer.opt) == 1


PINNED = {  # JAX's str(treedef) of LightGCN's train state (jax 0.9, optax 0.2)
    "torch": "PyTreeDef({'opt_state': CustomNode(namedtuple[TorchAdamState], "
             "[{'embed': [*, *, *]}, {'embed': [*, *, *]}, {'embed': "
             "[*, *, *]}]), 'params': {'embed': [*, *, *]}, 'step': *})",
    "global": "PyTreeDef({'opt_state': (CustomNode(namedtuple["
              "ScaleByAdamState], [*, {'embed': [*, *, *]}, {'embed': "
              "[*, *, *]}]), CustomNode(namedtuple[EmptyState], [])), "
              "'params': {'embed': [*, *, *]}, 'step': *})"}


@pytest.mark.parametrize("impl", IMPLS)
def test_treedef_strings_are_jaxs(jax_runs, tmp_path, impl):
    """The sidecar's treedef string is the one JAX prints for the same
    tree, which JAX's ``load`` compares letter for letter."""
    params, state = jax_runs["lightgcn", impl]["saved"]
    want = str(jax.tree_util.tree_structure(
        {"params": params, "opt_state": state, "step": np.asarray(0)}))
    assert want == PINNED[impl]
    pipe, trainer = _port("lightgcn", impl, jax_runs)
    path = str(tmp_path / "state.npz")
    checkpoint.save_train_state(path, pipe.model, trainer.opt, 0, impl)
    with open(path + ".tree") as f:
        assert json.load(f)["treedef"] == want
