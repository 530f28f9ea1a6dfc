"""The port's evaluation against the JAX package's on the CPU.

Given the same user and item tables, ``Evaluator.run`` and its 4-group
breakdown must equal JAX's within atol 1e-6 (per-block float32 sums, added
in the same order; scores computed by two matmul libraries may differ in
the last bit).  ``user_group_split`` must give JAX's groups exactly under
each of the reference's four measures, the metric functions JAX's values
within atol 1e-6, and ``EarlyStop`` must stop
at JAX's epoch and save a checkpoint that JAX's ``load`` reads.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.data.synthetic import synthetic_graph as jax_synthetic
from tagrec_tpu.models.kgat import KGAT as JaxKGAT
from tagrec_tpu.ops import metrics as jm
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu.training.early_stop import EarlyStop as JaxEarlyStop
from tagrec_tpu.training.evaluate import Evaluator as JaxEvaluator
from tagrec_tpu.training.evaluate import user_group_split as jax_groups
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.ops import metrics as M
from tagrec_tpu_torch.training.checkpoint import params_from_jax
from tagrec_tpu_torch.training.early_stop import EarlyStop
from tagrec_tpu_torch.training.evaluate import Evaluator, user_group_split

ATOL = 1e-6
GRAPHS = {"tiny": dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7),
          "small": dict(n_user=150, n_item=300, n_tag=40, avg_deg=12, seed=3)}


class _JaxTables:
    """A JAX-side model whose forward returns the tables in ``params``."""

    def forward(self, params, gdev, training=False):
        return params["u"], params["i"]


class _Tables:
    """A port-side model whose forward returns fixed tables."""

    def __init__(self, u, i):
        self.u, self.i = torch.from_numpy(u), torch.from_numpy(i)

    def forward(self):
        return self.u, self.i


def _tables(graph, wide: bool, seed=0):
    """Seeded tables; ``wide`` scores every entity (items then tags), as
    KGAT's evaluation does."""
    rng = np.random.default_rng(seed)
    n_cols = graph.n_item + (graph.n_tag if wide else 0)
    return (0.4 * rng.standard_normal((graph.n_user, 16))).astype(np.float32), \
        (0.4 * rng.standard_normal((n_cols, 16))).astype(np.float32)


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("wide", [False, True], ids=["items", "entities"])
@pytest.mark.parametrize("group_k", [0, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_evaluator_equals_jax(name, group_k, wide):
    tcfg = dict(test_batch=16, topks=(10, 20))
    graph = tsyn.synthetic_graph(**GRAPHS[name])
    u, i = _tables(graph, wide)
    got = Evaluator(graph, TrainConfig(**tcfg), device="cpu").run(
        _Tables(u, i), group_k=group_k)
    jgraph = jax_synthetic(**GRAPHS[name])
    want = JaxEvaluator(jgraph, JaxTrainConfig(**tcfg)).run(
        _JaxTables(), {"u": jnp.asarray(u), "i": jnp.asarray(i)}, None,
        group_k=group_k)
    if group_k:
        assert list(got) == list(want) and len(got) >= 2
        for key in want:
            _assert_metrics_equal(got[key], want[key])
    else:
        _assert_metrics_equal(got, want)
        assert len(got["ndcg"]) == 2 and 0.0 < got["auc"][0] < 1.0


def test_kgat_pipeline_evaluates_as_jax():
    """KGAT's evaluator scores every entity: the same weights (the shipped
    preset propagates nothing, quirk #3) give JAX's metrics."""
    graph = tsyn.synthetic_graph(**GRAPHS["tiny"])
    jgraph = jax_synthetic(**GRAPHS["tiny"])
    tcfg = dict(test_batch=32)
    jmodel = JaxKGAT(jgraph, jax_preset("kgat"))
    params = jmodel.init(jax.random.PRNGKey(0))
    want = JaxEvaluator(jgraph, JaxTrainConfig(**tcfg)).run(
        jmodel, params, jmodel.device_data())
    pipe = build_pipeline(graph, model_preset("kgat"), TrainConfig(**tcfg),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    params_from_jax(pipe.model, jax.tree_util.tree_map(np.asarray, params))
    _assert_metrics_equal(pipe.evaluator.run(pipe.model), want)


@pytest.mark.parametrize("graph_name", ["tiny", "small"])
@pytest.mark.parametrize("k", [2, 3, 4, 5, 7, 10])
def test_user_group_split_equals_jax(graph_name, k):
    graph = tsyn.synthetic_graph(**GRAPHS[graph_name])
    test, train = graph.user_items["test"], graph.user_items["train"]
    got = user_group_split(test, train, k)
    assert got == jax_groups(test, train, k)
    assert sorted(u for users in got.values() for u in users) == sorted(test)


@pytest.mark.parametrize("method", ["interaction", "user", "interval",
                                    "degree"])
@pytest.mark.parametrize("graph_name", ["tiny", "small"])
@pytest.mark.parametrize("k", [2, 3, 4, 7])
def test_user_group_split_measures_equal_jax(graph_name, k, method):
    """The reference's four measures, each as JAX cuts it."""
    graph = tsyn.synthetic_graph(**GRAPHS[graph_name])
    test, train = graph.user_items["test"], graph.user_items["train"]
    got = user_group_split(test, train, k, method=method)
    assert got == jax_groups(test, train, k, method=method)
    assert sorted(u for users in got.values() for u in users) == sorted(test)


def test_user_group_split_refuses_an_unknown_measure():
    with pytest.raises(ValueError, match="unknown measure 'nosuch'"):
        user_group_split({0: [1]}, {}, 1, method="nosuch")


def test_user_group_split_refuses():
    test = {0: [1], 1: [2]}
    with pytest.raises(ValueError, match="cannot cut"):
        user_group_split(test, {}, 3)


def test_metric_functions_equal_jax():
    rng = np.random.default_rng(5)
    b, n, p, t = 24, 60, 6, 5
    scores = (1 / (1 + np.exp(-rng.standard_normal((b, n))))).astype(np.float32)
    train_pad = np.full((b, p), 1 << 30, dtype=np.int64)
    test_pad = np.full((b, t), -1, dtype=np.int64)
    train_deg = rng.integers(0, p + 1, b)
    test_deg = rng.integers(1, t + 1, b)
    for r in range(b):
        ids = rng.choice(n, train_deg[r] + test_deg[r], replace=False)
        train_pad[r, :train_deg[r]] = ids[:train_deg[r]]
        test_pad[r, :test_deg[r]] = ids[train_deg[r]:]
    masked = M.mask_train_positives(torch.from_numpy(scores.copy()),
                                    torch.from_numpy(train_pad))
    jmasked = jm.mask_train_positives(jnp.asarray(scores),
                                      jnp.asarray(train_pad, jnp.int32))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    top = torch.topk(masked, 20, dim=1).indices
    label = M.hit_labels(top, torch.from_numpy(test_pad))
    jlabel = jm.hit_labels(jnp.asarray(top.numpy()), jnp.asarray(test_pad))
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    got = M.batch_metric_sums(label, torch.from_numpy(test_deg), (10, 20))
    want = jm.batch_metric_sums(jlabel, jnp.asarray(test_deg), (10, 20),
                                jnp.ones(b, jnp.int32))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL)
    auc = M.batch_auc_sum(masked, torch.from_numpy(test_pad),
                          torch.from_numpy(test_deg),
                          torch.from_numpy(train_deg))
    jauc = jm.batch_auc_sum(jmasked, jnp.asarray(test_pad),
                            jnp.asarray(test_deg), jnp.asarray(train_deg),
                            jnp.ones(b, jnp.int32))
    np.testing.assert_allclose(float(auc), float(jauc), rtol=0, atol=ATOL)


def test_early_stop_stops_and_saves_as_jax(tmp_path):
    pipe = build_pipeline(tsyn.synthetic_graph(**GRAPHS["tiny"]),
                          model_preset("lightgcn"), TrainConfig(),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    model = pipe.model
    ndcg = [0.10, 0.12, 0.11, 0.12, 0.09, 0.08]
    port = EarlyStop(2, save_path=str(tmp_path / "port"))
    jax_stop = JaxEarlyStop(2, save_path=str(tmp_path / "jax"))
    stops = []
    for ep, v in enumerate(ndcg):
        with torch.no_grad():
            for p in model.embed:
                p.fill_(float(ep))
        tree = {"embed": [p.detach().numpy().copy() for p in model.embed]}
        results = {"ndcg": [v, 0.0]}
        stops.append((port(model, results, ep), jax_stop(tree, results, ep)))
        if stops[-1][0]:
            break
    assert [s[0] for s in stops] == [s[1] for s in stops]
    assert stops[-1] == (True, True) and len(stops) == 5
    assert port.best_epoch == jax_stop.best_epoch == 1
    assert port.best_value == jax_stop.best_value
    saved = jckpt.load(str(tmp_path / "port"), jax_stop.best_params)
    for a, b in zip(saved["embed"], jax_stop.best_params["embed"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert torch.all(port.best_params["embed.0"] == 1.0)
