"""LightGCN's and NGCF's propagation row-partitioned over ``model``: the
graph tables placed by JAX's ``gdev_sharding`` rule, each SpMM over the
rank's rows, all-gathered once.

On a 480-node graph (``torch_mesh_worker.PROP_GRAPH``) whose pieces mix
row-sharded and whole tables over 2 and 4 ranks: LightGCN on the ELL
tier, on the hybrid tier with hub columns (``hub_min_degree`` 12, also
with ``node_drop`` 0.1) and on the dense sectors, and NGCF's asymmetric
pair with hub columns.  The ranks (gloo over the CPU, torch and the port
only) run on a ``model`` = 2 and a 2 x 2 mesh, started together by one
module fixture, and are held against one process:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its
  (1, 2) and (2, 2) meshes, but ``inv_perm`` and ``dense_cols``, whole
  here (ROADMAP.md section C); each rank's tables array-equal to JAX's
  ``addressable_shards``;
* ``model`` alone on the ELL tier bit for bit; every case within the
  data-axis tolerances of test_torch_parallel_dist.py; every rank's
  gathered parameters equal bit for bit;
* one hybrid BPR step against JAX's sharded step on its (1, 2) mesh
  (tests/test_parallel.py): loss within 1e-5 and parameters within 2e-6,
  JAX's own tolerances, wherever Adam's first step is well conditioned
  (|g| >= 100 eps); every gradient entry within 5e-4 |g| + 1e-4 max|g|,
  the repo's rule for gradients.  Adam's first step moves an entry by
  lr g / (|g| + eps): at |g| near eps a last-bit change in g moves it by
  a share of lr, and JAX's own single-device and (1, 2) steps differ by
  5.9e-6 on this graph at |g| = 1.4e-8;
* ``node_drop``'s masks bit for bit with one device's;
* each rank's graph bytes its blocks: rows / ``model`` of each sharded
  leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"model2": (1, 2), "2x2": (2, 2)}  # (data, model)
CASES = list(W.PROP_CASES)
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 120, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)


def _jax_graph():
    from tagrec_tpu.data.synthetic import synthetic_graph

    return synthetic_graph(**W.PROP_GRAPH, avg_deg=8, seed=7)


def _jax_model(case, graph):
    """JAX's model of ``case`` (hub columns by JAX's ``build_adj_pair``)."""
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.models.lightgcn import LightGCN
    from tagrec_tpu.models.ngcf import NGCF
    from tagrec_tpu.ops import ell as jell

    name, mode, over, hub = W.PROP_CASES[case]
    cls = {"lightgcn": LightGCN, "ngcf": NGCF}[name]
    model = cls(graph, model_preset(name, adj_mode=mode, **over))
    if hub:
        model._adj_host = W.hub_pair(graph, name, jell.build_adj_pair)
    return model


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
    tmp = tmp_path_factory.mktemp("prop")
    jgraph = _jax_graph()
    jmodel = _jax_model("hub", jgraph)
    params = jmodel.init(jax.random.PRNGKey(0))
    jparams = str(tmp / "jax_params.npz")
    np.savez(jparams, **{f"embed.{i}": np.asarray(t)
                         for i, t in enumerate(params["embed"])})
    args = {"jax_params": jparams, "batch": BATCH.tolist()}
    handles = [W.start_ranks(dp * mp, "propagate",
                             dict(args, dp=dp, mp=mp), str(tmp / key))
               for key, (dp, mp) in MESHES.items()]
    jax_step = _jax_step(jmodel, params, jmodel.device_data(),
                         jnp.asarray(BATCH, jnp.int32), _jmesh(1, 2))
    ref = W.prop_runs()
    ref_step = W.jax_step(args)
    results = W.wait_ranks(*handles)
    return {"mesh": dict(zip(MESHES, results)), "ref": ref,
            "ref_step": ref_step, "jax_step": jax_step, "jgraph": jgraph}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["ell", "hub", "sectors", "ngcf"])
def test_placement_matches_jax_leaf_by_leaf(runs, case, mesh):
    """The port's ``gdev_sharding`` against JAX's on the whole tables;
    ``inv_perm`` and ``dense_cols`` whole here, whatever JAX does."""
    from tagrec_tpu.parallel import sharding as jshd
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    gdev = _jax_model(case, runs["jgraph"]).device_data()
    flat = jax.tree_util.tree_flatten_with_path(
        jshd.gdev_sharding(gdev, jmesh))[0]
    want = {_path(p): ("model" if s.spec == jshd.row_sharded(jmesh).spec
                       else None) for p, s in flat}
    got = sharding.gdev_sharding(W.prop_pipeline(case).model,
                                 make_mesh(dp * mp, dp))
    assert list(got) == list(want)
    assert "model" in got.values()
    for path, axis in want.items():
        if path.endswith(("inv_perm", "dense_cols")):
            assert got[path] is None, path
        else:
            assert got[path] == axis, path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["ell", "hub", "sectors", "ngcf"])
def test_rank_blocks_equal_jax_addressable_shards(runs, case, mesh):
    """``ell.shard_rows`` seen from each rank against the shard JAX puts
    on that rank's device, table by table."""
    from tagrec_tpu.parallel import sharding as jshd
    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    gdev = _jax_model(case, runs["jgraph"]).device_data()
    placed = jax.tree_util.tree_map(jax.device_put, gdev,
                                    jshd.gdev_sharding(gdev, jmesh))
    jleaves = {_path(p): a for p, a in
               jax.tree_util.tree_flatten_with_path(placed)[0]}
    model = W.prop_pipeline(case).model
    spec = sharding.gdev_sharding(model, make_mesh(dp * mp, dp))
    mine = {r: dict(ell.leaves(ell.shard_rows(
        model.adj_host, make_mesh(dp * mp, dp, rank=r))))
        for r in range(dp * mp)}
    assert list(mine[0]) == list(jleaves)
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices)
    for path, leaf in jleaves.items():
        for shard in leaf.addressable_shards:
            d, m = np.argwhere(ranks == shard.device.id)[0]
            have = np.asarray(mine[d * mp + m][path])
            if spec[path] is None:  # whole here: JAX's rows of it
                have = have[shard.index]
            np.testing.assert_array_equal(have, np.asarray(shard.data),
                                          err_msg=path)


def test_model_axis_alone_is_bit_for_bit_on_the_ell_tier(runs):
    got = runs["mesh"]["model2"][0]["cases"]["ell"]
    ref = runs["ref"]["ell"]
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
    """From JAX's parameters and one batch: the port's ``model`` = 2
    ranks against JAX's step on its (1, 2) mesh; the one-process port
    too."""
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
    # the parameter hold covers most entries (85% on this graph)
    assert conditioned > 0.75 * sum(g.size for g in jgrads.values()) * 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_node_drop_masks_equal_one_devices(runs, mesh):
    """Each rank's dropped tables are its rows of the one-device dropped
    tables, bit for bit (one generator, each table's whole mask drawn)."""
    ref = runs["ref"]["drop"]["dropped"]
    dp, mp = MESHES[mesh]
    for r, rank in enumerate(runs["mesh"][mesh]):
        got, spec = rank["cases"]["drop"]["dropped"], rank["cases"]["drop"][
            "placement"]
        assert list(got) == list(ref)
        m = r % mp
        for path, a in ref.items():
            if spec[path] == "model":
                n = a.shape[0] // mp
                a = a[m * n:(m + 1) * n]
            np.testing.assert_array_equal(got[path], a, err_msg=path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_graph_bytes_are_the_ranks_blocks(runs, case, mesh):
    """rows / ``model`` of every row-sharded leaf, all of every other;
    the bytes those leaves and the cut buckets' real-slot lists hold."""
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
    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.prop_pipeline("hub").model
    whole = ell.graph_bytes(model.adj)
    mesh = make_mesh(2, 1, rank=1)
    spec = sharding.shard_graph(model, mesh)
    adj = model.adj
    assert isinstance(adj.fwd, ell.RowShard) and adj.bwd is adj.fwd
    assert sharding.shard_graph(model, mesh) == spec and model.adj is adj
    assert sharding.graph_mesh(model) is mesh
    assert ell.graph_bytes(adj) < whole
    with pytest.raises(ValueError, match="sharded over"):
        sharding.shard_graph(model, make_mesh(2, 1, rank=1))


def test_other_families_keep_their_graph_tables_whole():
    """What JAX's rule keeps whole stays whole on every rank: KGAT's
    shipped ``bi_agg`` preset reads no adjacency and holds no graph table;
    on the tiny graph DisenHAN's dense tier keeps its masks of fewer than
    64 rows (40 users, 25 tags) whole, and cuts the 90-row item masks
    (tests/test_torch_parallel_dense.py holds every chunked tier against
    JAX's placement).  TGCN's tables are row-sharded
    (tests/test_torch_parallel_tgcn.py), and so are the masks of DGCF's,
    DisenGCN's and KGAT's kernel tiers
    (tests/test_torch_parallel_masks.py)."""
    from tagrec_tpu_torch.ops import dense_adj
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.pipeline("kgat", {}, "auto").model
    assert model.tier == "none"
    assert sharding.shard_graph(model, make_mesh(2, 1)) == {}
    assert sharding.graph_mesh(model) is None
    assert not list(model.named_buffers())

    model = W.pipeline("disenhan", {}, "auto").model
    assert model.tier == "dense"
    mesh = make_mesh(2, 1)
    spec = sharding.shard_graph(model, mesh)
    assert spec == {f"masks.{e}": ("model" if e in (1, 4) else None)
                    for e in range(6)}
    assert sharding.graph_mesh(model) is mesh
    for path, name, host, _ in model.mask_hosts:
        held = model.sweep_mask(name)
        if spec[path] is None:
            assert torch.equal(held, torch.from_numpy(host)), path
        else:
            assert isinstance(held, dense_adj.MaskShard), path
            assert torch.equal(held.local, torch.from_numpy(
                host[:host.shape[0] // 2])), path
