"""DGCF's and DisenGCN's EdgeMap tier row-partitioned over ``model``: the
map's leaves placed by JAX's ``gdev_sharding`` rule, each ``edge_reduce``
over the rank's rows and all-gathered once, per-slot values moved
between the forward and transpose layouts by one all-to-all.

On PROP_GRAPH's joint map (``torch_mesh_worker``, 480 nodes), whose
forward buckets of 112, 96, 100 and 64 rows shard over 2 and 4 ranks
while those of 69 (width 0), 27, 9 and 3 stay whole, under
``adj_mode="ell"``.  The ranks (gloo over the CPU, torch and the port
only) run on a ``model`` = 2 and a 2 x 2 mesh, started together by one
module fixture, and are held against one process:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its
  (1, 2) and (2, 2) meshes, but ``f_inv`` and ``b_inv``, whole here, and
  JAX's ``masks``, which are not stored (ROADMAP.md section C); each
  rank's tables, and the masks it computes from its ``deg``, array-equal
  to JAX's ``addressable_shards``;
* ``transpose_vals`` there and back on each rank bit for bit with one
  device's rows;
* ``model`` alone bit for bit on the forward, the losses and the
  parameters; every case within the data-axis tolerances of
  test_torch_parallel_dist.py; every rank's gathered parameters equal;
* one DGCF BPR step against JAX's sharded step on its (1, 2) mesh
  (tests/test_parallel.py): loss within 1e-5, parameters within 2e-6
  wherever Adam's first step is well conditioned (|g| >= 100 eps), every
  gradient entry within 5e-4 |g| + 1e-4 max|g|;
* each rank's graph bytes its blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"model2": (1, 2), "2x2": (2, 2)}  # (data, model)
CASES = list(W.EM_CASES)
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 120, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)


def _jax_model(case):
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.data.synthetic import synthetic_graph
    from tagrec_tpu.models.dgcf import DGCF
    from tagrec_tpu.models.disengcn import DisenGCN

    name, over = W.EM_CASES[case]
    cls = {"dgcf": DGCF, "disengcn": DisenGCN}[name]
    graph = synthetic_graph(**W.PROP_GRAPH, avg_deg=8, seed=7)
    return cls(graph, model_preset(name, adj_mode="ell", **over))


def _jmesh(dp, mp):
    from tagrec_tpu.parallel.mesh import make_mesh

    return make_mesh(dp * mp, data_parallel=dp)


def _path(keys):
    """JAX's key path as the port's dotted leaf path."""
    names = []
    for k in keys:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                names.append(str(getattr(k, attr)))
                break
    return ".".join(names)


def _jax_step(model, params, gdev, batch, mesh):
    """tests/test_parallel.py's step, with the port's (torch) Adam."""
    from tagrec_tpu.config import TrainConfig
    from tagrec_tpu.parallel import sharding as shd
    from tagrec_tpu.training import optim

    opt = optim.make_optimizer(TrainConfig())

    def step(params, opt_state, gdev, batch):
        def total(p):
            return sum(model.bpr_loss(p, gdev, batch,
                                      key=jax.random.PRNGKey(1)))

        loss, grads = jax.value_and_grad(total)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda a, u: a + u, params,
                                      updates), loss, grads

    params = shd.place(params, shd.params_sharding(params, mesh))
    gdev = jax.tree_util.tree_map(jax.device_put, gdev,
                                  shd.gdev_sharding(gdev, mesh))
    batch = jax.device_put(batch, shd.batch_sharded(mesh))
    with mesh:
        p, loss, g = jax.jit(step)(params, opt.init(params), gdev, batch)
    return (float(loss), *({f"embed.{i}": np.asarray(t)
                            for i, t in enumerate(tree["embed"])}
                           for tree in (p, g)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh (started together), JAX's sharded step,
    and the one-process reference."""
    tmp = tmp_path_factory.mktemp("edgemap")
    jmodel = _jax_model("dgcf")
    params = jmodel.init(jax.random.PRNGKey(0))
    jparams = str(tmp / "jax_params.npz")
    np.savez(jparams, **{f"embed.{i}": np.asarray(t)
                         for i, t in enumerate(params["embed"])})
    args = {"jax_params": jparams, "batch": BATCH.tolist()}
    handles = [W.start_ranks(dp * mp, "edgemap",
                             dict(args, dp=dp, mp=mp), str(tmp / key))
               for key, (dp, mp) in MESHES.items()]
    jax_step = _jax_step(jmodel, params, jmodel.device_data(),
                         jnp.asarray(BATCH, jnp.int32), _jmesh(1, 2))
    ref = W.em_runs()
    ref_step = W.em_jax_step(args)
    results = W.wait_ranks(*handles)
    return {"mesh": dict(zip(MESHES, results)), "ref": ref,
            "ref_step": ref_step, "jax_step": jax_step}


def _jax_placed(case, mesh):
    """{JAX's leaf path: (spec "model" or None, the placed array)}."""
    from tagrec_tpu.parallel import sharding as jshd

    gdev = _jax_model(case).device_data()
    spec = jshd.gdev_sharding(gdev, mesh)
    placed = jax.tree_util.tree_map(jax.device_put, gdev, spec)
    specs = jax.tree_util.tree_flatten_with_path(spec)[0]
    arrays = jax.tree_util.tree_flatten_with_path(placed)[0]
    return {_path(p): ("model" if s.spec == jshd.row_sharded(mesh).spec
                       else None, a) for (p, s), (_, a) in zip(specs, arrays)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_placement_matches_jax_leaf_by_leaf(runs, case, mesh):
    """The port's ``gdev_sharding`` against JAX's on the whole map;
    ``f_inv`` and ``b_inv`` whole here, JAX's ``masks`` not stored."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    want = {p: s for p, (s, _) in _jax_placed(case, _jmesh(dp, mp)).items()}
    got = sharding.gdev_sharding(W.em_pipeline(case).model,
                                 make_mesh(dp * mp, dp))
    stored = [p for p in want if not p.startswith("masks.")]
    assert list(got) == stored and len(stored) < len(want)
    assert "model" in got.values()
    for path in stored:
        if path.endswith(("f_inv", "b_inv")):
            assert got[path] is None, path
        else:
            assert got[path] == want[path], path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_rank_blocks_equal_jax_addressable_shards(runs, case, mesh):
    """``shard_edge_map`` seen from each rank against the shard JAX puts
    on that rank's device, leaf by leaf, and the masks each rank computes
    from its own ``deg`` against JAX's stored masks."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    jleaves = _jax_placed(case, jmesh)
    model = W.em_pipeline(case).model
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices)
    mine = {}
    for r in range(dp * mp):
        shard = edgemap.shard_edge_map(model.em_hosts["em"],
                                       make_mesh(dp * mp, dp, rank=r))
        masks = edgemap.to_device(shard, "cpu").masks()
        mine[r] = dict(edgemap.leaves(shard), **{
            f"masks.{j}": m.numpy() for j, m in enumerate(masks)})
    assert set(mine[0]) == set(jleaves)
    for path, (spec, leaf) in jleaves.items():
        for shard in leaf.addressable_shards:
            d, m = np.argwhere(ranks == shard.device.id)[0]
            have = np.asarray(mine[d * mp + m][path])
            if path.endswith(("f_inv", "b_inv")):  # whole here
                have = have[shard.index]
            np.testing.assert_array_equal(have, np.asarray(shard.data),
                                          err_msg=path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_transpose_vals_moves_one_devices_values(runs, case, mesh):
    """Each rank's ``transpose_vals`` (one all-to-all) and its way back
    are its rows of one device's, bit for bit."""
    ref = runs["ref"][case]["transposed"]
    for rank in runs["mesh"][mesh]:
        got = rank["cases"][case]
        f_blocks, b_blocks = got["blocks"]
        assert any(f_blocks) and any(b is None for b in f_blocks)
        for tables, want, blocks in ((got["transposed"][0], ref[0], b_blocks),
                                     (got["transposed"][1], ref[1], f_blocks)):
            assert len(tables) == len(want)
            for t, w, k in zip(tables, want, blocks):
                np.testing.assert_array_equal(t, W.cut(w, k))


@pytest.mark.parametrize("case", CASES)
def test_model_axis_alone_is_bit_for_bit(runs, case):
    got = runs["mesh"]["model2"][0]["cases"][case]
    ref = runs["ref"][case]
    assert "model" in got["placement"].values()
    for a, b in zip(got["forward"], ref["forward"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["losses"], ref["losses"])
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k],
                                      err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_within_the_data_axis_tolerances(runs, case, mesh):
    """The forward tables, 3 steps' losses and the parameters against one
    process."""
    got = runs["mesh"][mesh][0]["cases"][case]
    ref = runs["ref"][case]
    for a, b in zip(got["forward"], ref["forward"]):
        np.testing.assert_allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=LOSS_ATOL)
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_every_rank_gathers_the_same_parameters(runs, case, mesh):
    first, *rest = [r["cases"][case] for r in runs["mesh"][mesh]]
    for other in rest:
        np.testing.assert_array_equal(other["losses"], first["losses"])
        for k in first["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          first["params"][k], err_msg=k)


def test_sharded_step_matches_jaxs_sharded_step(runs):
    """From JAX's parameters and one batch: DGCF's ``model`` = 2 ranks
    against JAX's step on its (1, 2) mesh; the one-process port too."""
    jloss, jparams, jgrads = runs["jax_step"]
    conditioned = 0
    for loss, params, grads in [r["jax_step"] for r in
                                runs["mesh"]["model2"]] + [runs["ref_step"]]:
        assert abs(loss - jloss) < 1e-5
        for k in jparams:
            g = jgrads[k]
            np.testing.assert_allclose(
                grads[k], g, rtol=5e-4, atol=1e-4 * np.abs(g).max(),
                err_msg=k)
            well = np.abs(g) >= 100 * ADAM_EPS
            conditioned += well.sum()
            np.testing.assert_allclose(params[k][well], jparams[k][well],
                                       rtol=0, atol=2e-6, err_msg=k)
    # the parameter hold covers most entries (86% on this graph)
    assert conditioned > 0.75 * sum(g.size for g in jgrads.values()) * 3


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_graph_bytes_are_the_ranks_blocks(runs, case, mesh):
    """rows / ``model`` of every row-sharded leaf, all of every other; the
    rank's bytes below one device's."""
    _, mp = MESHES[mesh]
    ref = runs["ref"][case]
    for rank in runs["mesh"][mesh]:
        got = rank["cases"][case]
        assert list(got["leaves"]) == list(ref["leaves"])
        for path, shape in ref["leaves"].items():
            rows = shape[0] // mp if got["placement"][path] else shape[0]
            assert got["leaves"][path] == (rows,) + shape[1:], path
        assert got["bytes"] < ref["bytes"]


def test_shard_graph_is_idempotent_and_refuses_another_mesh():
    from tagrec_tpu_torch.ops import edgemap, ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.em_pipeline("dgcf").model
    whole = ell.graph_bytes(model.edges["em"])
    mesh = make_mesh(2, 1, rank=1)
    spec = sharding.shard_graph(model, mesh)
    em = model.edges["em"]
    assert isinstance(em, edgemap.EdgeMapShard) and em.mesh is mesh
    assert sharding.shard_graph(model, mesh) == spec
    assert sharding.graph_mesh(model) is mesh
    assert ell.graph_bytes(em) < whole
    assert [tuple(i.shape) for i in em.f_idx][1] == (56, 8)
    with pytest.raises(ValueError, match="sharded over"):
        sharding.shard_graph(model, make_mesh(2, 1, rank=1))


def test_one_rank_holds_the_whole_map():
    """Over one rank the cut tables, read tables and inverse permutations
    are the whole map's, and there is no exchange: today's code runs on
    them."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    host = W.em_pipeline("dgcf").model.em_hosts["em"]
    whole = edgemap.to_device(host, "cpu")
    one = edgemap.to_device(edgemap.shard_edge_map(host, make_mesh(1)),
                            "cpu")
    assert one.f_x.total == one.b_x.total == 0
    for a, b in zip(whole, one.local):
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            assert torch.equal(x, y)
