"""The port's DisenGCN (dense routing tier) against the JAX package on the
CPU, with JAX's params carried across and JAX's Pallas kernels in
interpret mode.

* The forward at rtol 1e-4, atol 1e-5 (float32, sums in another order),
  and a JAX checkpoint loading into the port with the same forward.
* The loss parts (rtol 1e-4) and every parameter's gradient (rtol 5e-4,
  atol 1e-5) on JAX's first resampled batch.  q (``new_fac``) is a
  function of W, b and the embeddings, and ``routed_mm`` gives it no
  gradient, as JAX's custom VJP gives it zeros: this is the test of it.
* A 3-step Adam trajectory at rtol 5e-3, with JAX's per-leaf step counts.
* Serving and evaluation: ``export_tables`` freezes the forward's tables,
  and ``Evaluator.run`` gives JAX's metrics (atol 1e-6, as in
  test_torch_evaluate.py) at one layer.  At the preset's three layers the
  untrained tables collapse onto one vector (a user's scores spread by
  about 3e-7), so their metrics are tie-breaks, which two top-k
  implementations need not share.
"""

import os

import numpy as np
import jax
import pytest
import torch

from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.models.disengcn import DisenGCN as JaxDisenGCN
from tagrec_tpu.training import checkpoint as jckpt
from tagrec_tpu.training.evaluate import Evaluator as JaxEvaluator
from tagrec_tpu_torch import serving
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import flash_routing
from tagrec_tpu_torch.training import checkpoint
from torch_routed_parity import (STEPS, TINY, first_step, jax_trajectory,
                                 numpy_tree, port_pipeline, trajectory)
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
TRAJ_RTOL = 5e-3
CFG = dict(reg=1e-3)
LEAVES = ["embed.0", "embed.1", "embed.2"] + [
    f"layers.{i}.{w}" for i in range(3) for w in ("W", "b")]


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    """JAX DisenGCN (dense flash tier) with reg 1e-3."""
    return jax_trajectory(tiny_graph, "disengcn", CFG)


def _assert_tables_close(model, want):
    with torch.no_grad():
        got = model.forward()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_parameters_are_jax_tree():
    pipe, _ = port_pipeline("disengcn", {})
    model = pipe.model
    assert [n for n, _ in model.named_parameters()] == LEAVES
    assert checkpoint.jax_leaf_order(model) == LEAVES
    assert model.layers[0]["W"].shape == (4, 64, 16)
    assert model.layers[0]["b"].shape == (4, 1, 16)
    assert model.maskT is None and model.mask_t is model.mask


def test_forward_matches_jax(jax_run):
    pipe, _ = port_pipeline("disengcn", CFG, jax_run["params"])
    _assert_tables_close(pipe.model, jax_run["forward"])


def test_jax_checkpoint_loads_with_same_forward(jax_run, tmp_path):
    path = os.path.join(tmp_path, "disengcn.npz")
    jckpt.save(path, jax_run["params"])
    pipe, _ = port_pipeline("disengcn", CFG)
    checkpoint.load(path, pipe.model)
    _assert_tables_close(pipe.model, jax_run["forward"])
    # and the port's save is read back by JAX's load as the same tree
    out = os.path.join(tmp_path, "port.npz")
    checkpoint.save(out, pipe.model)
    back = jckpt.load(out, jax_run["params"])
    for (name, a), (_, b) in zip(checkpoint._leaves(jax_run["params"]),
                                 checkpoint._leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=name)


def test_loss_parts_and_gradients_match_jax(jax_run):
    pipe, _ = port_pipeline("disengcn", CFG, jax_run["params"])
    parts, grads = first_step(pipe.model, jax_run["batches"][0])
    assert len(parts) == len(jax_run["parts"]) == 2
    np.testing.assert_allclose(parts, jax_run["parts"], rtol=RTOL, atol=1e-7)
    assert list(grads) == LEAVES and set(jax_run["grads"]) == set(LEAVES)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jax_run["grads"][name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        assert np.abs(g).max() > 0, name


def test_trajectory_matches_torch_adam(jax_run):
    pipe, trainer = port_pipeline("disengcn", CFG, jax_run["params"])
    assert pipe.phases[0].steps_per_epoch == jax_run["steps"]
    got, counts = trajectory(pipe, trainer, jax_run["batches"])
    np.testing.assert_allclose(got, jax_run["losses"], rtol=TRAJ_RTOL,
                               atol=1e-5)
    # no leaf's gradient is exactly 0 (W and b included), so torch's Adam
    # and JAX's torch_adam step the same leaves
    assert counts == jax_run["counts"] == dict.fromkeys(LEAVES, STEPS)


def test_export_freezes_the_tables(jax_run, tmp_path):
    pipe, _ = port_pipeline("disengcn", CFG, jax_run["params"])
    model = pipe.model
    before = flash_routing.routed_mm.launches
    u, i = serving.export_tables(model, n_item=pipe.graph.n_item)
    assert flash_routing.routed_mm.launches == before  # the CPU path
    assert u.shape == (pipe.graph.n_user, 64)
    assert i.shape == (pipe.graph.n_item, 64)
    for got, want in ((u, jax_run["forward"][0]), (i, jax_run["forward"][1])):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # frozen: the tables do not move when the parameters do
    with torch.no_grad():
        model.embed[0].add_(1.0)
        assert not np.allclose(model.forward()[0].numpy(), u)
    path = os.path.join(tmp_path, "art.npz")
    serving.save_export(path, u, i, model_name="disengcn",
                        train_pos=pipe.graph.user_items["train"])
    ids, scores = serving.Retriever.from_export(path, device="cpu").topk(
        np.arange(8), 5)
    assert ids.shape == (8, 5) and np.isfinite(scores).all()


def test_evaluation_matches_jax_at_one_layer(tiny_graph):
    cfg = dict(dim_layer_list=(64,))
    jmodel = JaxDisenGCN(tiny_graph, jax_preset("disengcn", **cfg))
    params = jmodel.init(jax.random.PRNGKey(1))
    want = JaxEvaluator(tiny_graph, JaxTrainConfig()).run(
        jmodel, params, jmodel.device_data())
    pipe, _ = port_pipeline("disengcn", cfg, numpy_tree(params))
    got = pipe.evaluator.run(pipe.model)
    assert set(got) == set(want) and 0.0 < got["auc"][0] < 1.0
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode,item", [("ell", "A17")])
def test_unported_tiers_raise(mode, item):
    """The tier that raised until its ROADMAP item (A17, the EdgeMap tier)
    was ported now builds, with no mask (held against JAX in
    test_torch_edgemap_models.py)."""
    graph = tsyn.synthetic_graph(**TINY)
    model = model_class("disengcn")(graph, model_preset("disengcn",
                                                        adj_mode=mode),
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    assert not model.dense and model.mask is None and model.maskT is None
    assert model.edges["em"].n_buckets > 1


def test_dense_xla_trains():
    """The chunked dense tier through the pipeline: no routing launch, the
    forward equal to the kernel tier's on the same weights (held against
    JAX in test_torch_dense_xla.py)."""
    pipe, trainer = port_pipeline("disengcn", dict(adj_mode="dense_xla"))
    kern, _ = port_pipeline("disengcn", {})
    kern.model.load_state_dict(pipe.model.state_dict())
    with torch.no_grad():
        for a, b in zip(pipe.model.forward(), kern.model.forward()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)
    out = trainer.run_epoch(max_steps=2)["bpr"]
    assert np.isfinite(out).all()


def test_message_dropout_draws_only_when_training():
    graph = tsyn.synthetic_graph(**TINY)
    model = model_class("disengcn")(
        graph, model_preset("disengcn", message_drop_list=(0.5, 0.0, 0.0)),
        device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = model.forward()
        again = model.forward(training=False)
        dropped = model.forward(training=True,
                                generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(plain, again))
    assert not torch.equal(plain[0], dropped[0])
