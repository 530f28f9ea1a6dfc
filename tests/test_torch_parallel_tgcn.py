"""TGCN's neighbour tables and dedup buckets row-partitioned over
``model``: every table leaf placed by JAX's ``gdev_sharding`` rule, the
attention of the ``auto`` (dedup) and ``dense_xla`` (plain takes) tiers
on a rank's rows, one all-gather forward, one sum over ``model`` a
relation backward.

On ``torch_mesh_worker.TGCN_GRAPH`` (556 nodes, one layer of width 16:
JAX's sharded step compiles in half the time of two layers'; phase R5b
of ``chip_smoke.py`` runs the preset's three on the card), where at
``model`` = 2 every relation's dedup buckets mix row-sharded ones with
whole ones and every [N, k] table row-shards.  The
ranks (gloo over the CPU, torch and the port only) run both tiers on a
``model`` = 2 and a 2 x 2 mesh, rank 0 of the first also on a one-rank
mesh, started together by one module fixture, and are held against one
process:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its
  (1, 2) and (2, 2) meshes on ``auto``, ``dense_xla``, ``ell`` and under
  per-layer resampling, but each relation's ``inv`` and the CSR lists,
  whole here (ROADMAP.md section C); each rank's cut tables array-equal
  to JAX's ``addressable_shards``;
* the rows each rank feeds the attention: its block of every row-sharded
  piece, every whole piece;
* a one-rank mesh bit for bit with no mesh;
* ``model`` = 2: the forward and every phase's 3 steps' losses within
  rtol 1e-6; one BPR step's gradients entry by entry within
  5e-4 |g| + 1e-4 max|g|, and its parameters within 2e-6 wherever Adam's
  first step is well conditioned (|g| >= 100 eps, as
  test_torch_parallel_propagate.py holds it); the parameters after the
  steps within the data-axis tolerances of test_torch_parallel_dist.py;
  each planted fault (every rank back-propagating the whole buckets, or
  no sum over ``model``) outside the gradient hold;
* 2 x 2 within the data-axis tolerances; every rank's gathered parameters
  equal;
* one ``auto`` BPR step against JAX's sharded step on its (1, 2) mesh:
  loss within 1e-5, gradients and parameters as above;
* each rank's table bytes its blocks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

CASES = list(W.TGCN_CASES)
MESHES = {"model2": (1, 2), "2x2": (2, 2)}  # (data, model)
# the placement's tiers: adj_mode, per-layer resampling
TIERS = {"auto": ("auto", False), "dense_xla": ("dense_xla", False),
         "ell": ("ell", False), "resample": ("dense_xla", True)}
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
MODEL_RTOL = 1e-6
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 128, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)


def _jax_model(tier):
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.data.synthetic import synthetic_graph
    from tagrec_tpu.models.tgcn import TGCN

    mode, resample = TIERS[tier]
    graph = synthetic_graph(**W.TGCN_GRAPH, avg_deg=8)
    return TGCN(graph, model_preset("tgcn", adj_mode=mode, **W.TGCN_CFG),
                resample_each_layer=resample)


def _port_model(tier, mesh=None):
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models.tgcn import TGCN

    mode, resample = TIERS[tier]
    return TGCN(W.tgcn_graph(), model_preset("tgcn", adj_mode=mode,
                                             **W.TGCN_CFG),
                generator=torch.Generator().manual_seed(0), device="cpu",
                resample_each_layer=resample, mesh=mesh)


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


def _jax_placed(tier, mesh):
    """{JAX's leaf path: (spec "model" or None, the placed array)}."""
    from tagrec_tpu.parallel import sharding as jshd

    gdev = _jax_model(tier).device_data()
    spec = jshd.gdev_sharding(gdev, mesh)
    placed = jax.tree_util.tree_map(jax.device_put, gdev, spec)
    specs = jax.tree_util.tree_flatten_with_path(spec)[0]
    arrays = jax.tree_util.tree_flatten_with_path(placed)[0]
    return {_path(p): ("model" if s.spec == jshd.row_sharded(mesh).spec
                       else None, a) for (p, s), (_, a) in zip(specs, arrays)}


def _kept_whole(path):
    """The leaves JAX may row-shard that stay whole here: the EdgeMaps'
    inverse permutations, each relation's ``inv`` and the CSR lists."""
    parts = path.split(".")
    return (path.endswith(("f_inv", "b_inv")) or parts[0] == "csr"
            or parts[0] == "dedup" and parts[2] == "1")


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
    """The ranks of both meshes and the one-process reference (each in
    its own processes, started together), and JAX's sharded ``auto``
    step meanwhile, all from JAX's initial parameters (its init jitted:
    eager, it takes seconds on the CPU)."""
    tmp = tmp_path_factory.mktemp("tgcn_rows")
    jparams = str(tmp / "jax_params.npz")
    args = {"jax_params": jparams, "batch": BATCH.tolist()}
    handles = [W.start_ranks(dp * mp, "tgcn_rows",
                             dict(args, dp=dp, mp=mp,
                                  one_rank=key == "model2"),
                             str(tmp / key))
               for key, (dp, mp) in MESHES.items()]
    handles.append(W.start_ranks(1, "tgcn_rows", dict(args, plain=True),
                                 str(tmp / "plain")))
    # the ranks read the parameters once they need them (wait_for)
    jmodel = _jax_model("auto")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    np.savez(str(tmp / "part.npz"), **_flat(params))
    os.replace(tmp / "part.npz", jparams)
    jax_step = _jax_step(jmodel, params, jmodel.device_data(),
                         jnp.asarray(BATCH, jnp.int32), _jmesh(1, 2))
    *results, (ref,) = W.wait_ranks(*handles)
    return {"mesh": dict(zip(MESHES, results)), "ref": ref["cases"],
            "jax_step": jax_step}


def _grad_errors(got, want):
    """The largest error of any entry over its bound 5e-4 |g| +
    1e-4 max|g|, over every gradient (above 1: outside the hold)."""
    worst = 0.0
    for k, g in want.items():
        bound = 5e-4 * np.abs(g) + 1e-4 * np.abs(g).max()
        err = np.abs(got[k] - g)
        worst = max(worst, float((err / np.maximum(bound, 1e-38)).max()))
    return worst


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("tier", list(TIERS))
def test_placement_matches_jax_leaf_by_leaf(runs, tier, mesh):
    """The port's ``gdev_sharding`` against JAX's on the whole tables, in
    JAX's leaf order; ``inv``, the CSR lists and the maps' ``f_inv`` and
    ``b_inv`` whole here.  The port's CSR lists carry one pad slot past
    JAX's, so their lengths, and with them JAX's rule, differ."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jleaves = _jax_placed(tier, _jmesh(dp, mp))
    model = _port_model(tier)
    got = sharding.gdev_sharding(model, make_mesh(dp * mp, dp))
    assert list(got) == list(jleaves)
    assert "model" in got.values()
    host = dict(model.table_leaves())
    for path, (spec, leaf) in jleaves.items():
        if _kept_whole(path):
            assert got[path] is None, path
        else:
            assert got[path] == spec, path
        if path.startswith("csr.") and not path.endswith(".0"):
            assert host[path].shape[0] == leaf.shape[0] + 1, path
    if tier in CASES:
        for rank in runs["mesh"][mesh]:
            assert rank["cases"][tier]["placement"] == got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("tier", list(TIERS))
def test_rank_blocks_equal_jax_addressable_shards(tier, mesh):
    """Each rank's tables (``table_leaves`` of its mesh: what
    ``place_tables`` uploads) against the shard JAX puts on that rank's
    device, leaf by leaf; a leaf kept whole here holds JAX's shard at its
    index (the CSR lists without their pad slot)."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    jleaves = {p: v for p, v in _jax_placed(tier, jmesh).items()
               if not p.startswith("em.")}
    model = _port_model(tier)
    mine = {r: dict(model.table_leaves(make_mesh(dp * mp, dp, rank=r)))
            for r in range(dp * mp)}
    assert list(mine[0]) == list(jleaves)
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices)
    cut = 0
    for path, (spec, leaf) in jleaves.items():
        for shard in leaf.addressable_shards:
            d, m = np.argwhere(ranks == shard.device.id)[0]
            have = np.asarray(mine[d * mp + m][path])[:leaf.shape[0]]
            if _kept_whole(path) or spec is None:
                have = have[shard.index]
            else:
                cut += 1
            np.testing.assert_array_equal(have, np.asarray(shard.data),
                                          err_msg=path)
    assert cut


@pytest.mark.parametrize("case", CASES)
def test_each_rank_feeds_the_attention_its_rows(runs, case):
    """The rows a rank feeds the attention over a forward: its block of
    each row-sharded piece (bucket or table) and every whole piece, each
    layer; so the ranks together feed one device's rows and the whole
    pieces' once more."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.tgcn_pipeline(case).model
    n_layer = len(model.layers)
    sizes = {path: a.shape[0] for path, a in model.table_leaves()}
    pieces = {name: model.piece_paths(name) for name in model.REL_ORDER}
    ref = runs["ref"][case]["rows"]
    total = dict.fromkeys(ref, 0)
    for r, rank in enumerate(runs["mesh"]["model2"]):
        blocks = model.leaf_blocks(make_mesh(2, 1, rank=r))
        got = rank["cases"][case]["rows"]
        for name, paths in pieces.items():
            want = sum(sizes[p] if blocks[p] is None
                       else blocks[p][1] - blocks[p][0] for p in paths)
            assert got[name] == n_layer * want < ref[name], name
            total[name] += got[name]
    for name, paths in pieces.items():
        whole = sum(sizes[p] for p in paths if blocks[p] is None)
        assert ref[name] == n_layer * sum(sizes[p] for p in paths)
        assert total[name] == ref[name] + n_layer * whole, name
        assert whole > 0 or case == "dense_xla", name


@pytest.mark.parametrize("case", CASES)
def test_one_rank_mesh_is_bit_for_bit(runs, case):
    """A one-rank mesh runs today's code: the forward, every phase's
    losses, the parameters, the evaluation and one step bit for bit."""
    got = runs["mesh"]["model2"][0]["one"][case]
    ref = runs["ref"][case]
    assert got["tier"] == ref["tier"]
    assert "model" in got["placement"].values()
    for a, b in zip(got["forward"], ref["forward"]):
        np.testing.assert_array_equal(a, b)
    for phase in ref["losses"]:
        np.testing.assert_array_equal(got["losses"][phase],
                                      ref["losses"][phase], err_msg=phase)
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k],
                                      err_msg=k)
    assert got["eval"] == ref["eval"]
    (gl, gp, gg), (rl, rp, rg) = got["step"], ref["step"]
    assert gl == rl
    for k in rg:
        np.testing.assert_array_equal(gg[k], rg[k], err_msg=k)
        np.testing.assert_array_equal(gp[k], rp[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_model_axis_against_one_device(runs, case):
    """``model`` = 2: the forward and every phase's losses within rtol
    1e-6, the parameters after the steps within the data-axis bound; one
    step's gradients within the gradient rule and its parameters within
    2e-6 where |g| >= 100 eps; the evaluation's metrics equal."""
    ref = runs["ref"][case]
    for rank in runs["mesh"]["model2"]:
        got = rank["cases"][case]
        assert got["tier"] == ("dedup" if case == "auto" else "takes")
        for a, b in zip(got["forward"], ref["forward"]):
            np.testing.assert_allclose(a, b, rtol=MODEL_RTOL, atol=1e-9)
        for phase in ref["losses"]:
            np.testing.assert_allclose(got["losses"][phase],
                                       ref["losses"][phase], rtol=MODEL_RTOL,
                                       atol=0, err_msg=phase)
        for k in ref["params"]:
            np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert got["eval"] == ref["eval"]
        (gl, gp, gg), (rl, rp, rg) = got["step"], ref["step"]
        assert abs(gl - rl) <= MODEL_RTOL * abs(rl)
        assert _grad_errors(gg, rg) <= 1.0
        for k in rg:
            well = np.abs(rg[k]) >= 100 * ADAM_EPS
            np.testing.assert_allclose(gp[k][well], rp[k][well], rtol=0,
                                       atol=2e-6, err_msg=k)


@pytest.mark.parametrize("fault", W.TGCN_FAULTS)
def test_planted_faults_fail_the_gradient_hold(runs, fault):
    """Every rank back-propagating the whole buckets (each of their rows
    counted ``model`` times), or the inputs' gradients left unsummed over
    ``model``, puts one step's gradients outside the hold that the
    sound step meets."""
    rg = runs["ref"]["auto"]["step"][2]
    for rank in runs["mesh"]["model2"]:
        assert _grad_errors(rank["cases"]["auto"]["step"][2], rg) <= 1.0
        assert _grad_errors(rank["cases"]["auto"]["faults"][fault][2],
                            rg) > 10.0


@pytest.mark.parametrize("case", CASES)
def test_2x2_within_the_data_axis_tolerances(runs, case):
    """The forward, each phase's 3 steps' losses and the parameters
    against one process; the evaluation's metrics equal."""
    ref = runs["ref"][case]
    for rank in runs["mesh"]["2x2"]:
        got = rank["cases"][case]
        for a, b in zip(got["forward"], ref["forward"]):
            np.testing.assert_allclose(a, b, rtol=FWD_RTOL, atol=FWD_ATOL)
        for phase in ref["losses"]:
            np.testing.assert_allclose(got["losses"][phase],
                                       ref["losses"][phase], rtol=0,
                                       atol=LOSS_ATOL, err_msg=phase)
        for k in ref["params"]:
            np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert got["eval"] == ref["eval"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
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
    """From JAX's parameters and one batch: the port's ``auto`` on
    ``model`` = 2 ranks against JAX's step on its (1, 2) mesh; the
    one-process port too."""
    jloss, jparams, jgrads = runs["jax_step"]
    conditioned = total = 0
    for loss, params, grads in [r["cases"]["auto"]["step"] for r in
                                runs["mesh"]["model2"]] + [
                                    runs["ref"]["auto"]["step"]]:
        assert abs(loss - jloss) < 1e-5
        assert params.keys() == jparams.keys()
        assert _grad_errors(grads, jgrads) <= 1.0
        for k in jparams:
            well = np.abs(jgrads[k]) >= 100 * ADAM_EPS
            conditioned += well.sum()
            total += well.size
            np.testing.assert_allclose(params[k][well], jparams[k][well],
                                       rtol=0, atol=2e-6, err_msg=k)
    # the parameter hold covers 34% of the entries on this graph: the
    # attention weights' gradients lie below 1e-6, and the rows outside
    # the batch's neighbourhood get none
    assert conditioned > 0.2 * total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_table_bytes_are_the_ranks_blocks(runs, mesh, case):
    """rows / ``model`` of every row-sharded leaf, all of every other; the
    rank's table bytes below one device's."""
    _, mp = MESHES[mesh]
    ref = runs["ref"][case]
    for rank in runs["mesh"][mesh]:
        got = rank["cases"][case]
        assert list(got["leaves"]) == list(ref["leaves"])
        for path, shape in ref["leaves"].items():
            rows = (shape[0] // mp if got["placement"][path] == "model"
                    else shape[0])
            assert got["leaves"][path] == (rows,) + shape[1:], path
        assert got["bytes"] < ref["bytes"]


def test_shard_graph_cuts_the_tables_and_is_idempotent():
    """``shard_graph`` after the build: the tables a rank's; again over
    the same mesh a no-op; over another it raises.  On ``ell`` the tables
    are cut at rest beside the maps."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    for tier in ("auto", "ell"):
        model = _port_model(tier)
        whole = model.table_nbytes()
        assert sharding.graph_mesh(model) is None
        mesh = make_mesh(2, 1, rank=1)
        spec = sharding.shard_graph(model, mesh)
        assert sharding.graph_mesh(model) is mesh
        assert model.table_nbytes() < whole
        held = dict(model.table_tensors())
        for path, arr in model.table_leaves(mesh):
            np.testing.assert_array_equal(held[path].numpy(), arr,
                                          err_msg=path)
        assert sharding.shard_graph(model, mesh) == spec
        with pytest.raises(ValueError, match="sharded over"):
            sharding.shard_graph(model, make_mesh(2, 1, rank=1))
        if tier == "ell":
            assert all(isinstance(model.edges[k], edgemap.EdgeMapShard)
                       for k in model.em_hosts)


def test_resampling_keeps_its_draw_whole():
    """Under per-layer resampling on a rank's mesh the CSR lists stay
    whole and a training forward draws whole tables, no collective: the
    same draw and forward as one device's."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    one = _port_model("resample")
    mesh = make_mesh(2, 1, rank=1)
    ranked = _port_model("resample", mesh)
    held = dict(ranked.table_tensors())
    for path, arr in one.table_leaves():
        if path.startswith("csr."):
            np.testing.assert_array_equal(held[path].numpy(), arr)
        else:
            assert held[path].shape[0] == arr.shape[0] // 2, path
    draws = [m._resample(torch.Generator().manual_seed(5))
             for m in (one, ranked)]
    for name in one.REL_ORDER:
        for a, b in zip(draws[0][name], draws[1][name]):
            assert torch.equal(a, b)
    outs = [m.forward(training=True,
                      generator=torch.Generator().manual_seed(5))
            for m in (one, ranked)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
