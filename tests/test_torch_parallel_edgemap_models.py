"""The EdgeMap tier of DisenHAN, KGAT and TGCN ``ell`` row-partitioned
over ``model``: every map's leaves placed by JAX's ``gdev_sharding``
rule, KGAT's slot maps ``k2n`` and ``n2k`` cut as their destination map,
every primitive over the rank's rows, what it returns in row order whole
on every rank.

On PROP_GRAPH (``torch_mesh_worker``, 480 nodes) under ``adj_mode="ell"``:
DisenHAN's six maps, KGAT's ``em``, ``emk`` and slot maps on the tag graph
and over a tiny KG, and TGCN's twelve maps, one forward bucket each of 120
or 300 rows (row-sharded over 2 ranks) or 60 (whole).  The ranks (gloo over
the CPU, torch and the port only) run every case on a ``model`` = 2 mesh
and KGAT on a 2 x 2 one, started together by one module fixture, and are
held against one process:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its (1, 2)
  mesh, but ``f_inv`` and ``b_inv``, whole here (ROADMAP.md section C);
  each rank's cut tables, ``k2n`` and ``n2k`` and TGCN's neighbour tables
  among them, array-equal to JAX's ``addressable_shards``;
* ``rows_gather``, ``edge_gather``, ``edge_vgather``, ``edge_softmax``,
  ``rows_ordered``, ``edge_score`` and ``slot_transfer`` on each rank: the
  forward its rows of one device's, the backward one device's, bit for
  bit;
* ``model`` alone bit for bit on the forward, every phase's losses and the
  parameters; 2 x 2 within the data-axis tolerances of
  test_torch_parallel_dist.py; every rank's gathered parameters equal;
* one KGAT BPR step against JAX's sharded step on its (1, 2) mesh: loss
  within 1e-5, parameters within 2e-6 wherever Adam's first step is well
  conditioned (|g| >= 100 eps), every gradient entry within
  5e-4 |g| + 1e-4 max|g|;
* each rank's map bytes its blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

CASES = list(W.EMM_CASES)
# (data, model) and the cases each mesh runs
MESHES = {"model2": ((1, 2), CASES), "2x2": ((2, 2), ["kgat"])}
MESH_CASES = [(m, c) for m, (_, cases) in MESHES.items() for c in cases]
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 120, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)


def _jax_model(case):
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.data.kg import KnowledgeGraph
    from tagrec_tpu.data.synthetic import synthetic_graph
    from tagrec_tpu.models import MODEL_REGISTRY

    name, over, with_kg = W.EMM_CASES[case]
    graph = synthetic_graph(**W.PROP_GRAPH, avg_deg=8, seed=7)
    kw = ({"kg": KnowledgeGraph.synthetic(graph, **W.KG_TINY)} if with_kg
          else {})
    return MODEL_REGISTRY[name](graph, model_preset(name, adj_mode="ell",
                                                    **over), **kw)


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


def _flat(tree):
    return {_path(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


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
    return float(loss), _flat(p), _flat(g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh (started together), JAX's sharded KGAT
    step, and the one-process reference."""
    tmp = tmp_path_factory.mktemp("em_models")
    jmodel = _jax_model("kgat")
    params = jmodel.init(jax.random.PRNGKey(0))
    jparams = str(tmp / "jax_params.npz")
    np.savez(jparams, **_flat(params))
    args = {"jax_params": jparams, "batch": BATCH.tolist()}
    handles = [W.start_ranks(dp * mp, "em_models",
                             dict(args, dp=dp, mp=mp, cases=cases,
                                  jax_step=key == "model2"),
                             str(tmp / key))
               for key, ((dp, mp), cases) in MESHES.items()]
    jax_step = _jax_step(jmodel, params, jmodel.device_data(),
                         jnp.asarray(BATCH, jnp.int32), _jmesh(1, 2))
    ref = W.emm_runs()
    ref_step = W.emm_jax_step(args)
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


def _kept_whole(case, path):
    """The leaves JAX row-shards that stay whole here: the inverse
    permutations."""
    return path.endswith(("f_inv", "b_inv"))


@pytest.mark.parametrize("case", CASES)
def test_placement_matches_jax_leaf_by_leaf(runs, case):
    """The port's ``gdev_sharding`` against JAX's on the whole maps (and
    TGCN's tables), in JAX's leaf order; ``f_inv`` and ``b_inv`` whole
    here."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    want = {p: s for p, (s, _) in _jax_placed(case, _jmesh(1, 2)).items()}
    got = sharding.gdev_sharding(W.emm_pipeline(case).model, make_mesh(2, 1))
    assert list(got) == list(want)
    assert "model" in got.values()
    for path in want:
        if _kept_whole(case, path):
            assert got[path] is None, path
        else:
            assert got[path] == want[path], path
    assert runs["mesh"]["model2"][0]["cases"][case]["placement"] == got


@pytest.mark.parametrize("case", CASES)
def test_rank_blocks_equal_jax_addressable_shards(runs, case):
    """Every map and slot map cut for each rank (``shard_edge_map``,
    ``shard_slot_map``), and TGCN's tables (``table_leaves``), against
    the shard JAX puts on that rank's device, leaf by leaf; the leaves
    kept whole here hold JAX's shard at its index."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    jmesh = _jmesh(1, 2)
    jleaves = _jax_placed(case, jmesh)
    model = W.emm_pipeline(case).model
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(-1)
    def cut(h, mesh):
        return (edgemap.shard_slot_map(h, model.em_hosts, mesh)
                if isinstance(h, edgemap.SlotMapHost)
                else edgemap.shard_edge_map(h, mesh))

    def tables(mesh):
        """TGCN's neighbour tables as the rank holds them."""
        return dict(model.table_leaves(mesh)) if case == "tgcn" else {}

    mine = {r: dict(edgemap.host_leaves({
        k: cut(h, make_mesh(2, 1, rank=r))
        for k, h in model.em_hosts.items()}),
        **tables(make_mesh(2, 1, rank=r))) for r in range(2)}
    assert set(mine[0]) == set(jleaves)
    for path, (spec, leaf) in jleaves.items():
        for shard in leaf.addressable_shards:
            have = np.asarray(mine[int(np.argwhere(
                ranks == shard.device.id)[0, 0])][path])
            if _kept_whole(case, path):
                have = have[shard.index]
            np.testing.assert_array_equal(have, np.asarray(shard.data),
                                          err_msg=path)


PRIMS = ["rows_gather", "edge_gather", "edge_vgather", "edge_softmax",
         "rows_ordered", "edge_score", "slot_transfer"]


@pytest.mark.parametrize("prim", PRIMS)
@pytest.mark.parametrize("case", CASES)
def test_primitive_on_a_rank_is_one_devices(runs, case, prim):
    """Each rank's forward is its rows of one device's and its backward
    one device's (whole where the input is whole), bit for bit."""
    ref = runs["ref"][case]["prims"]
    if prim == "slot_transfer" and prim not in ref:
        assert not case.startswith("kgat")
        return
    cut = False
    for rank in runs["mesh"]["model2"]:
        got = rank["cases"][case]["prims"][prim]
        for kind in ("out", "grad"):
            assert len(got[kind]) == len(ref[prim][kind])
            for (blk, a), (_, want) in zip(got[kind], ref[prim][kind]):
                np.testing.assert_array_equal(a, W.cut1(want, blk),
                                              err_msg=f"{prim} {kind}")
                cut |= blk is not None
    assert cut, "no bucket of the map is row-sharded"


@pytest.mark.parametrize("case", CASES)
def test_model_axis_alone_is_bit_for_bit(runs, case):
    got = runs["mesh"]["model2"][0]["cases"][case]
    ref = runs["ref"][case]
    assert got["tier"] == "ell" and got["sharded"]
    assert "model" in got["placement"].values()
    for a, b in zip(got["forward"], ref["forward"]):
        np.testing.assert_array_equal(a, b)
    assert list(got["losses"]) == list(ref["losses"])
    for phase in ref["losses"]:
        np.testing.assert_array_equal(got["losses"][phase],
                                      ref["losses"][phase], err_msg=phase)
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k],
                                      err_msg=k)


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_within_the_data_axis_tolerances(runs, mesh, case):
    """The forward tables, each phase's 3 steps' losses and the parameters
    against one process."""
    got = runs["mesh"][mesh][0]["cases"][case]
    ref = runs["ref"][case]
    for a, b in zip(got["forward"], ref["forward"]):
        np.testing.assert_allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL)
    for phase in ref["losses"]:
        np.testing.assert_allclose(got["losses"][phase], ref["losses"][phase],
                                   rtol=0, atol=LOSS_ATOL, err_msg=phase)
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_every_rank_gathers_the_same_parameters(runs, mesh, case):
    first, *rest = [r["cases"][case] for r in runs["mesh"][mesh]]
    for other in rest:
        for phase in first["losses"]:
            np.testing.assert_array_equal(other["losses"][phase],
                                          first["losses"][phase])
        for k in first["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          first["params"][k], err_msg=k)


def test_sharded_step_matches_jaxs_sharded_step(runs):
    """From JAX's parameters and one batch: KGAT's ``model`` = 2 ranks
    against JAX's step on its (1, 2) mesh; the one-process port too."""
    jloss, jparams, jgrads = runs["jax_step"]
    conditioned = total = 0
    for loss, params, grads in [r["jax_step"] for r in
                                runs["mesh"]["model2"]] + [runs["ref_step"]]:
        assert abs(loss - jloss) < 1e-5
        assert params.keys() == jparams.keys()
        for k in jparams:
            g = jgrads[k]
            np.testing.assert_allclose(
                grads[k], g, rtol=5e-4, atol=1e-4 * np.abs(g).max(),
                err_msg=k)
            well = np.abs(g) >= 100 * ADAM_EPS
            conditioned += well.sum()
            total += g.size
            np.testing.assert_allclose(params[k][well], jparams[k][well],
                                       rtol=0, atol=2e-6, err_msg=k)
    assert conditioned > 0.5 * total


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_graph_bytes_are_the_ranks_blocks(runs, mesh, case):
    """rows / ``model`` of every row-sharded leaf, all of every other; the
    rank's bytes below one device's."""
    _, mp = MESHES[mesh][0]
    ref = runs["ref"][case]
    for rank in runs["mesh"][mesh]:
        got = rank["cases"][case]
        assert list(got["leaves"]) == list(ref["leaves"])
        for path, shape in ref["leaves"].items():
            rows = (shape[0] // mp if got["placement"][path] == "model"
                    else shape[0])
            assert got["leaves"][path] == (rows,) + shape[1:], path
        assert got["bytes"] < ref["bytes"]


def test_shard_graph_cuts_every_map_and_is_idempotent():
    """``shard_graph`` after the build: every map and slot map of KGAT a
    rank's; again over the same mesh a no-op; over another it raises."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.emm_pipeline("kgat").model
    whole = model.edges.nbytes()
    mesh = make_mesh(2, 1, rank=1)
    spec = sharding.shard_graph(model, mesh)
    kinds = {k: type(model.edges[k]) for k in model.em_hosts}
    assert kinds == {"em": edgemap.EdgeMapShard, "emk": edgemap.EdgeMapShard,
                     "k2n": edgemap.SlotMapShard, "n2k": edgemap.SlotMapShard}
    assert sharding.shard_graph(model, mesh) == spec
    assert sharding.graph_mesh(model) is mesh
    assert model.edges.nbytes() < whole
    with pytest.raises(ValueError, match="sharded over"):
        sharding.shard_graph(model, make_mesh(2, 1, rank=1))


def test_one_rank_holds_the_whole_maps():
    """Over one rank every cut table and read table is the whole map's or
    slot map's, and nothing is exchanged: today's code runs on them."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.emm_pipeline("kgat").model
    whole = edgemap.maps_to_device(model.em_hosts, "cpu")
    one = edgemap.maps_to_device(model.em_hosts, "cpu", make_mesh(1))
    for key, item in one.items():
        if isinstance(item, edgemap.SlotMapShard):
            assert item.x.total == 0
            assert all(torch.equal(a, b) for a, b in zip(item.read,
                                                         whole[key].read))
            continue
        assert item.f_x.total == item.b_x.total == 0
        for a, b in zip(whole[key], item.local):
            for x, y in zip(a if isinstance(a, tuple) else [a],
                            b if isinstance(b, tuple) else [b]):
                assert torch.equal(x, y)


def test_raw_reduce_refuses_a_ranks_rows():
    """``_reduce_raw`` would put a rank's rows in order by the whole
    ``f_inv``: it raises on a shard instead of computing wrong rows."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    host = W.emm_pipeline("kgat").model.em_hosts["em"]
    shard = edgemap.to_device(edgemap.shard_edge_map(
        host, make_mesh(2, 1, rank=0)), "cpu")
    vals = tuple(torch.zeros(i.shape) for i in shard.f_idx)
    with pytest.raises(ValueError, match="whole EdgeMap"):
        edgemap._reduce_raw(shard, vals, torch.zeros(host.f.n_cols, 4))
