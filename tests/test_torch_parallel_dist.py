"""The port on gloo meshes of CPU processes, held against the port in one
process (which the other test files hold against JAX): a 2 x 2 mesh, a
data-only and a model-only mesh of 2 ranks, run together by one module
fixture (``tests/torch_mesh_worker.py``; the ranks import torch and the
port only).  On each, 3 steps of every phase of LightGCN (the gather
tier), DGCF with its distance-correlation term and KGAT (BPR, then
TransE, on one Adam), then one evaluation and top-k requests.

* ``model`` alone: bit for bit (an all-gather, a slice and elementwise
  Adam reorder no sum).
* with ``data``: each rank's batch is a slice, so the loss's means and
  the gradients' sums run in another order: loss terms within 1e-6,
  parameters within a hundredth of the most Adam can move one in those
  steps (lr a step: 3e-4 after 3 steps at lr 0.01).  Adam divides each
  gradient by its running scale, so a last-bit difference in a small
  gradient moves its update by a share of lr (2.3e-5 on the CPU; 6.9e-5
  on an H100 for DGCF at hetrec scale after 5 steps, chip_smoke.py
  phase P).

The sharded checkpoints: a 2 x 2 save restored under 1 x 4 and under no
mesh, JAX's ``load_sharded`` over the port's directory on its own meshes,
the port over a directory JAX wrote on its (4, 2) mesh, and a meshed
``Trainer.run`` resumed from its state directory."""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"2x2": (2, 2), "data2": (2, 1), "model2": (1, 2)}
NAMES = [m[0] for m in W.MODELS]
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS


def _jax_state(shapes, counts, seed):
    """A JAX train state {"opt_state", "params", "step"} over LightGCN's
    params tree of ``shapes`` with the given per-table Adam counts."""
    from tagrec_tpu.training.optim import TorchAdamState

    rng = np.random.default_rng(seed)
    embed = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mom = [[rng.random(s).astype(np.float32) for s in shapes]
           for _ in range(2)]
    return {"opt_state": TorchAdamState(
                count={"embed": [np.asarray(c, np.int32) for c in counts]},
                mu={"embed": mom[0]}, nu={"embed": mom[1]}),
            "params": {"embed": embed}, "step": np.asarray(4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (started together), the JAX directory they read,
    and the single-process reference."""
    from tagrec_tpu.parallel import sharding as jshd
    from tagrec_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tagrec_tpu.training import checkpoint as jck

    tmp = tmp_path_factory.mktemp("mesh")
    shapes = [tuple(p.shape) for p in W.pipeline(
        *W.MODELS[0], graph=W.tiny_graph(**W.CKPT_GRAPH)).model.embed]
    jstate = _jax_state(shapes, (5, 3, 0), seed=4)
    placed = jshd.place(jstate, jshd.params_sharding(
        jstate, jmake_mesh(8, data_parallel=4)))
    jax_dir = jck.save_sharded(str(tmp / "jax"), placed, step=4)
    handles = [W.start_ranks(
        dp * mp, "train",
        {"dp": dp, "mp": mp,
         "then": {"2x2": ["checkpoint"], "data2": ["scaling"]}.get(key, []),
         "jax_dir": jax_dir}, str(tmp / key))
        for key, (dp, mp) in MESHES.items()]
    results = W.wait_ranks(*handles)
    return {"mesh": dict(zip(MESHES, results)), "ref": W.train_models(),
            "jax_state": jstate}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_agrees(runs, mesh, name):
    """Control flow is the same on every rank: the same averaged losses,
    the same gathered parameters, metrics and answers."""
    first, *rest = [r["models"][name] for r in runs["mesh"][mesh]]
    for other in rest:
        for ph in first["losses"]:
            np.testing.assert_array_equal(other["losses"][ph],
                                          first["losses"][ph])
        for k in first["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          first["params"][k])
        assert other["eval"] == first["eval"]
        np.testing.assert_array_equal(other["ids"], first["ids"])


@pytest.mark.parametrize("name", NAMES)
def test_model_axis_alone_is_bit_for_bit(runs, name):
    got, ref = runs["mesh"]["model2"][0]["models"][name], runs["ref"][name]
    assert "model" in got["placement"]["params"].values()
    for ph in ref["losses"]:
        np.testing.assert_array_equal(got["losses"][ph], ref["losses"][ph])
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k],
                                      err_msg=k)
    assert got["eval"] == ref["eval"]
    np.testing.assert_array_equal(got["ids"], ref["ids"])
    np.testing.assert_array_equal(got["scores"], ref["scores"])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", ["2x2", "data2"])
def test_data_axis_within_float32(runs, mesh, name):
    got, ref = runs["mesh"][mesh][0]["models"][name], runs["ref"][name]
    for ph in ref["losses"]:
        np.testing.assert_allclose(got["losses"][ph], ref["losses"][ph],
                                   rtol=0, atol=LOSS_ATOL, err_msg=ph)
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    # the evaluation and retrieval on these parameters: JAX's CLI mesh
    # tolerances (tests/test_cli_mesh.py)
    for m in ("recall", "precision", "hr", "ndcg"):
        np.testing.assert_allclose(got["eval"][m], ref["eval"][m],
                                   rtol=2e-3, atol=1e-5, err_msg=m)
    np.testing.assert_allclose(got["eval"]["auc"], ref["eval"]["auc"],
                               rtol=5e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=1e-4)


def test_sharded_save_reshards_under_1x4_and_no_mesh(runs, tmp_path):
    """2 x 2 blocks (rows over 2) restored under 1 x 4 (rows over 4) and
    into an unsharded model in this process, parameters and Adam equal."""
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    ck = runs["mesh"]["2x2"][0]["checkpoint"]
    assert ck["step_1x4"] == 7
    for k in ck["saved"]:
        np.testing.assert_array_equal(ck["loaded_1x4"][k], ck["saved"][k])
    _same_adam(ck["adam_1x4"], ck["adam"])
    pipe = W.pipeline(*W.MODELS[0], graph=W.tiny_graph(**W.CKPT_GRAPH))
    t = Trainer(pipe.model, pipe.phases, W.tcfg(), capture=False,
                generator=torch.Generator().manual_seed(1))
    assert checkpoint.load_sharded(ck["step_dir"], pipe.model, t.opt) == 7
    for k, v in W.full_params(pipe.model).items():
        np.testing.assert_array_equal(v, ck["saved"][k])
    _same_adam(W.adam_full(pipe.model, t.opt), ck["adam"])


def _same_adam(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k][0] == want[k][0], k
        for a, b in zip(got[k][1:], want[k][1:]):
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("dp", [4, 2])
def test_jax_reads_the_ports_sharded_directory(runs, dp):
    """JAX's ``load_sharded`` over the port's 2 x 2 directory, placed on
    its (dp, 8 / dp) mesh (rows over 2 or 4) and assembled on the host."""
    from tagrec_tpu.parallel import sharding as jshd
    from tagrec_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tagrec_tpu.training import checkpoint as jck

    ck = runs["mesh"]["2x2"][0]["checkpoint"]
    like = jax.tree_util.tree_map(np.zeros_like, runs["jax_state"])
    mesh = jmake_mesh(8, data_parallel=dp)
    for shardings in (jshd.params_sharding(like, mesh), None):
        got = jck.load_sharded(ck["step_dir"], like, shardings)
        assert int(np.asarray(got["step"])) == 7
        for i, k in enumerate(f"embed.{j}" for j in range(3)):
            np.testing.assert_array_equal(
                np.asarray(got["params"]["embed"][i]), ck["saved"][k])
            st = ck["adam"][k]
            assert int(np.asarray(got["opt_state"].count["embed"][i])) == (
                st[0] if st else 0)
            if st:
                np.testing.assert_array_equal(
                    np.asarray(got["opt_state"].mu["embed"][i]), st[1])
                np.testing.assert_array_equal(
                    np.asarray(got["opt_state"].nu["embed"][i]), st[2])


def test_port_reads_a_jax_sharded_directory(runs):
    """The 2 x 2 ranks restored a directory JAX wrote on its (4, 2) mesh:
    every table, count and moment JAX saved (count 0: no Adam state)."""
    ck = runs["mesh"]["2x2"][0]["checkpoint"]
    js = runs["jax_state"]
    assert ck["jax_step"] == 4
    for i in range(3):
        k = f"embed.{i}"
        np.testing.assert_array_equal(ck["jax_loaded"][k],
                                      js["params"]["embed"][i])
        count = int(js["opt_state"].count["embed"][i])
        if count == 0:
            assert ck["jax_adam"][k] is None
            continue
        assert ck["jax_adam"][k][0] == count
        np.testing.assert_array_equal(ck["jax_adam"][k][1],
                                      js["opt_state"].mu["embed"][i])
        np.testing.assert_array_equal(ck["jax_adam"][k][2],
                                      js["opt_state"].nu["embed"][i])


def test_meshed_run_resumes_from_its_state_directory(runs):
    ck = runs["mesh"]["2x2"][0]["checkpoint"]
    assert ck["latest"] == "step_00000003"
    resumed = [line for line in ck["logs"] if "resumed sharded state" in line]
    assert len(resumed) == 1 and resumed[0].endswith("at epoch 2"), resumed
    # the resumed run trains epoch 2 only
    epochs = [line.split("]")[0] for line in ck["logs"]
              if line.startswith("[Epoch:")]
    assert epochs == ["[Epoch:0", "[Epoch:1", "[Epoch:2"]


def test_scaling_report_over_sub_meshes(runs):
    """Rank 0 is in the meshes of 1 and 2 ranks, rank 1 in the second."""
    r0, r1 = (r["scaling"] for r in runs["mesh"]["data2"])
    assert sorted(r0) == [1, 2] and sorted(r1) == [2]
    assert all(v > 0 for v in [*r0.values(), *r1.values()])


def test_trainer_refuses_a_mesh_without_process_groups():
    """A mesh of shape only (no torch.distributed) cannot train: its
    collectives have no group."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh
    from tagrec_tpu_torch.training.train import Trainer

    pipe = W.pipeline(*W.MODELS[0])
    with pytest.raises(ValueError, match="no process groups"):
        Trainer(pipe.model, pipe.phases, W.tcfg(), mesh=make_mesh(2, 1),
                generator=torch.Generator().manual_seed(0))
