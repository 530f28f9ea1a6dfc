"""The port's LightGCN against the JAX package's on the CPU, on each
adjacency tier: dense (type sectors), ELL (degree buckets) and hybrid (a
hub block; ``hub_min_degree`` 12 on both sides, so that hub columns exist on
the tiny graph).

With JAX's params carried across: the forward and ``predict`` at rtol 1e-4,
atol 1e-5; the BPR loss at rtol 1e-4 and every gradient at rtol 5e-4, atol
1e-5 (float32 sums in another order); 3 Adam steps on the same fed batches
through the port's Trainer against JAX's ``adam_impl="torch"`` optimizer at
rtol 5e-3 (Adam's sqrt(v) amplifies float32 rounding in small gradients).
Then the pipeline: ``build_pipeline`` -> ``Trainer.run`` with evaluation,
early stop and the non-finite stop; checkpoints both ways.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.lightgcn import LightGCN as JaxLightGCN
from tagrec_tpu.ops import ell as jell
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch import serving
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import dma_gather, ell
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.early_stop import EarlyStop
from tagrec_tpu_torch.training.evaluate import Evaluator
from tagrec_tpu_torch.training.train import Trainer

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 5e-4
TRAJ_RTOL = 5e-3
HUB_MIN = 12
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
MODES = ("dense", "ell", "hybrid")
CFG = dict(reg=1e-4)


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


def _hub_pair(coo, build):
    return build(coo, symmetric=True, mode="hybrid", hub_min_degree=HUB_MIN)


def _port(mode, tcfg=TrainConfig(), **cfg):
    """Pipeline and Trainer of the port on the CPU; hybrid with hubs."""
    graph = tsyn.synthetic_graph(**TINY)
    pipe = build_pipeline(graph, model_preset("lightgcn", adj_mode=mode,
                                              **CFG, **cfg), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    if mode == "hybrid":
        pipe.model.adj = ell.to_device(
            _hub_pair(graph.joint_norm_adj("bi_norm", True),
                      ell.build_adj_pair), "cpu")
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer


@pytest.fixture(scope="module")
def jax_runs(tiny_graph):
    """Per mode: params, forward, predict, BPR loss and gradients on a fixed
    batch, and the losses of 3 Adam steps on fed batches."""
    runs = {}
    batches = [jnp.asarray(b, jnp.int32) for b in _batches(tiny_graph)]
    users = jnp.arange(7, dtype=jnp.int32)
    for mode in MODES:
        model = JaxLightGCN(tiny_graph, jax_preset("lightgcn", adj_mode=mode,
                                                   **CFG))
        if mode == "hybrid":
            model._adj_host = _hub_pair(
                tiny_graph.joint_norm_adj("bi_norm", True), jell.build_adj_pair)
        params = model.init(jax.random.PRNGKey(0))
        gdev = model.device_data()

        def total(p, b):
            return sum(model.bpr_loss(p, gdev, b, key=jax.random.PRNGKey(1)))

        loss, grads = jax.value_and_grad(total)(params, batches[0])
        opt = joptim.make_optimizer(JaxTrainConfig(adam_impl="torch"))
        step = jax.jit(lambda p, s, b: _adam_step(opt, total, p, s, b))
        p, s, traj = params, opt.init(params), []
        for b in batches:
            p, s, lv = step(p, s, b)
            traj.append(float(lv))
        runs[mode] = {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "forward": [np.asarray(t) for t in model.forward(params, gdev)],
            "predict": np.asarray(model.predict(params, gdev, users)),
            "loss": float(loss),
            "grads": [np.asarray(g) for g in grads["embed"]],
            "traj": traj,
            "tier": type(gdev["adj"].fwd).__name__}
    return runs


def _adam_step(opt, total, p, s, b):
    loss, grads = jax.value_and_grad(total)(p, b)
    updates, s = opt.update(grads, s, p)
    return optax.apply_updates(p, updates), s, loss


def _loaded(mode, jax_runs):
    pipe, trainer = _port(mode)
    checkpoint.params_from_jax(pipe.model, jax_runs[mode]["params"])
    return pipe, trainer


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_predict_equal_jax(jax_runs, mode):
    pipe, _ = _loaded(mode, jax_runs)
    want = {"dense": "DenseSectors", "ell": "Hybrid", "hybrid": "Hybrid"}
    assert type(pipe.model.adj.fwd).__name__ == jax_runs[mode]["tier"] \
        == want[mode]
    with torch.no_grad():
        got = pipe.model.forward()
    assert len(got) == 3
    for a, b in zip(got, jax_runs[mode]["forward"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pipe.model.predict(np.arange(7)).numpy(),
                               jax_runs[mode]["predict"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_bpr_loss_and_gradients_equal_jax(jax_runs, mode, tiny_graph):
    pipe, _ = _loaded(mode, jax_runs)
    batch = torch.from_numpy(_batches(tiny_graph)[0])
    before = (dma_gather.gather_reduce.launches,
              dma_gather.gather_rows.launches)
    loss = sum(pipe.model.bpr_loss(batch))
    loss.backward()
    # the CPU runs the plain versions: no kernel is launched
    assert (dma_gather.gather_reduce.launches,
            dma_gather.gather_rows.launches) == before
    np.testing.assert_allclose(float(loss.detach()), jax_runs[mode]["loss"],
                               rtol=RTOL)
    for p, g in zip(pipe.model.embed, jax_runs[mode]["grads"]):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=GRAD_RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_adam_trajectory_equals_jax(jax_runs, mode, tiny_graph):
    pipe, trainer = _loaded(mode, jax_runs)
    (phase,) = pipe.phases
    got = [float(trainer.step(phase, torch.from_numpy(b)).sum())
           for b in _batches(tiny_graph)]
    np.testing.assert_allclose(got, jax_runs[mode]["traj"], rtol=TRAJ_RTOL,
                               atol=1e-5)


def test_layer_normalize_off_equals_jax(tiny_graph):
    """Quirk #8 switched off: the layers' raw outputs are averaged."""
    jmodel = JaxLightGCN(tiny_graph, jax_preset("lightgcn"),
                         per_layer_normalize=False)
    params = jmodel.init(jax.random.PRNGKey(2))
    want = jmodel.forward(params, jmodel.device_data())
    model = model_class("lightgcn")(
        tsyn.synthetic_graph(**TINY), model_preset("lightgcn"),
        generator=torch.Generator().manual_seed(0), device="cpu",
        per_layer_normalize=False)
    checkpoint.params_from_jax(model,
                               jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = model.forward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_auto_takes_the_hybrid_tier_past_the_dense_budget():
    graph = tsyn.synthetic_graph(**TINY)
    coo = graph.joint_norm_adj("bi_norm", True)
    sectors = (graph.n_user, graph.n_item, graph.n_tag)
    assert isinstance(ell.build_adj_pair(coo, sectors=sectors).fwd,
                      ell.DenseSectorsHost)
    host = ell.build_adj_pair(coo, symmetric=True, mode="auto",
                              dense_budget=coo.shape[0] ** 2 * 4 - 1,
                              hub_min_degree=HUB_MIN)
    assert isinstance(host.fwd, ell.HybridHost) and host.bwd is host.fwd
    assert host.fwd.dense_cols is not None


def test_bf16_adjacency_equals_jax(tiny_graph):
    """``adj_dtype="bf16"``: the sector blocks bit for bit as JAX's, and the
    forward at rtol 2e-3, atol 1e-4 (x is rounded to bfloat16 before each
    product on both sides; a last-bit difference in x may round to the
    neighbouring bfloat16 value)."""
    jmodel = JaxLightGCN(tiny_graph, jax_preset("lightgcn", adj_dtype="bf16"))
    params = jmodel.init(jax.random.PRNGKey(3))
    want = jax.jit(lambda p: jmodel.forward(p, jmodel.device_data()))(params)
    model = model_class("lightgcn")(
        tsyn.synthetic_graph(**TINY), model_preset("lightgcn",
                                                   adj_dtype="bf16"),
        generator=torch.Generator().manual_seed(0), device="cpu")
    checkpoint.params_from_jax(model,
                               jax.tree_util.tree_map(np.asarray, params))
    blocks = model.adj.fwd.blocks
    assert all(b.dtype == torch.bfloat16 for b in blocks)
    for b, (_, _, jb) in zip(blocks, jmodel._adj_host.fwd.blocks):
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(jb).view(np.int16))
    with torch.no_grad():
        got = model.forward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=1e-4)


def test_node_drop_trains():
    """``node_drop`` (JAX's edge dropout): the training forward differs
    from the plain one and the losses stay finite (the invariants are in
    test_torch_ngcf.py)."""
    pipe, trainer = _port("ell", TrainConfig(train_batch=64), node_drop=0.2)
    with torch.no_grad():
        plain = pipe.model.forward()[0]
        dropped = pipe.model.forward(
            training=True, generator=torch.Generator().manual_seed(1))[0]
    assert not torch.allclose(plain, dropped)
    assert np.isfinite(trainer.run_epoch(max_steps=2)["bpr"]).all()


def test_message_dropout_draws_from_the_generator():
    pipe, _ = _port("ell", message_drop_list=(0.5, 0.5, 0.5))
    m = pipe.model
    with torch.no_grad():
        plain = m.forward()[0]
        a = m.forward(training=True, generator=torch.Generator().manual_seed(4))
        b = m.forward(training=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a[0], b[0]) and torch.isfinite(a[0]).all()
    assert not torch.allclose(a[0], plain)


def test_pipeline_trains_evaluates_and_keeps_the_best(tmp_path):
    tcfg = TrainConfig(train_batch=64, test_batch=16, epochs=3,
                       test_interval=1, patient_epoch=100)
    pipe, trainer = _port("hybrid", tcfg)
    assert [ph.name for ph in pipe.phases] == ["bpr"]
    assert isinstance(pipe.evaluator, Evaluator)
    logs = []
    stop = EarlyStop(tcfg.patient_epoch, tcfg.early_stop_key,
                     save_path=str(tmp_path / "best"))
    out = trainer.run(pipe.evaluator, stop, log=logs.append)
    losses = [float(line.split("avg_loss: ")[1].split()[0])
              for line in logs if "avg_loss" in line]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert sum("[eval" in line for line in logs) == 3
    assert out["best_epoch"] == stop.best_epoch
    assert set(out["best_result"]) == {"recall", "precision", "hr", "ndcg",
                                       "auc"}
    assert os.path.exists(tmp_path / "best.npz")
    best = checkpoint.load(str(tmp_path / "best"),
                           _port("hybrid", tcfg)[0].model)
    for name, p in best.named_parameters():
        torch.testing.assert_close(p, stop.best_params[name], rtol=0, atol=0)


def test_early_stop_ends_the_run():
    class Falling:
        """An evaluator whose NDCG@10 falls at every call."""
        calls = 0

        def run(self, model):
            Falling.calls += 1
            return {"ndcg": [1.0 / Falling.calls, 0.0]}

    tcfg = TrainConfig(train_batch=64, epochs=10, test_interval=1)
    pipe, trainer = _port("dense", tcfg)
    logs = []
    out = trainer.run(Falling(), EarlyStop(1), log=logs.append)
    assert Falling.calls == 3 and out["best_epoch"] == 0
    assert "early stop trigger at epoch 2" in logs


def test_non_finite_loss_stops_training():
    tcfg = TrainConfig(train_batch=64, epochs=2, lr=1.0)
    pipe, trainer = _port("ell", tcfg)
    with torch.no_grad():
        pipe.model.embed[0][0, 0] = float("nan")
    logs = []
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.run(pipe.evaluator, EarlyStop(10), log=logs.append)
    assert not any(line.startswith("[Epoch") for line in logs)


def test_checkpoints_cross_both_ways(jax_runs, tmp_path):
    pipe, _ = _loaded("dense", jax_runs)
    path = str(tmp_path / "port")
    checkpoint.save(path, pipe.model)
    tree = jckpt.load(path, jax_runs["dense"]["params"])
    for a, b in zip(tree["embed"], jax_runs["dense"]["params"]["embed"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    jpath = str(tmp_path / "jax")
    jckpt.save(jpath, jax_runs["ell"]["params"])
    with open(jpath + ".tree") as f, open(path + ".tree") as g:
        assert f.read() == g.read()
    other, _ = _port("dense")
    checkpoint.load(jpath, other.model)
    for p, w in zip(other.model.embed, jax_runs["ell"]["params"]["embed"]):
        np.testing.assert_array_equal(p.detach().numpy(), w)


def test_export_and_top_k_on_cpu(jax_runs):
    pipe, _ = _loaded("hybrid", jax_runs)
    g = pipe.graph
    u_t, i_t = serving.export_tables(pipe.model, n_item=g.n_item)
    np.testing.assert_allclose(u_t, jax_runs["hybrid"]["forward"][0],
                               rtol=RTOL, atol=ATOL)
    r = serving.Retriever(u_t, i_t, device="cpu")
    ids, scores = r.topk(np.arange(5), k=10)
    assert ids.shape == (5, 10) and np.isfinite(scores).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    graph = tsyn.synthetic_graph(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_class("lightgcn")(graph, model_preset("lightgcn"),
                                generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(graph, TrainConfig())
