"""The kernel tiers' masks row-partitioned over ``model``: DGCF's and
DisenGCN's routing ``mask`` and KGAT ``bi_inter``'s flash masks placed by
JAX's ``gdev_sharding`` rule, the port's transposes by the same rule on
their own rows, every edge sweep run on a rank's rows and its result
all-gathered once (``ops.dense_adj.MaskShard``).

On PROP_GRAPH (``torch_mesh_worker``, 480 nodes) under ``adj_mode="auto"``,
the kernel tier: DGCF's and DisenGCN's [480, 480] mask cut 240 and 120
rows a rank over 2 and 4; KGAT's [256, 768], [512, 512] and [256, 768]
flash masks and their transposes, whose 768 rows put a rank's block left
of the split at 512, across it, or right of it.  The ranks (gloo over the
CPU, torch and the port only) run on a ``model`` = 2 and a 2 x 2 mesh and
the one-process reference in a process of its own, all started together
by one module fixture, while JAX's init and sharded steps are jitted
here:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its
  (1, 2) and (2, 2) meshes, the transposes by the same rule on their
  rows; each rank's cut masks array-equal to JAX's ``addressable_shards``
  (the transposes to the transposed shards of JAX's mask columns);
* each sweep over a row block equal to the whole sweep's rows, and
  ``dot_bwd_col`` over blocks left of, across and right of the split;
* ``model`` = 2 against one process: the forward and every phase's 3
  steps' losses bit for bit, the parameters too; 2 x 2 within the
  data-axis tolerances of test_torch_parallel_dist.py; every rank's
  gathered parameters equal;
* one DGCF and one KGAT BPR step against JAX's sharded step on its (1, 2)
  mesh: loss within 1e-5, every gradient entry within 5e-4 |g| +
  1e-4 max|g|, parameters within 2e-6 wherever Adam's first step is well
  conditioned (|g| >= 100 eps);
* each planted fault (routed_mm's dx from the rank's rows without the
  all-gather; ``dot_bwd_col`` choosing a column's plane and its k and x
  rows by its row in the rank's block, not by the global column) outside
  that gradient hold;
* each rank's mask bytes its blocks; ``shard_graph`` idempotent,
  refusing another mesh."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

CASES = list(W.MASK_CASES)
MESHES = {"model2": (1, 2), "2x2": (2, 2)}  # (data, model)
LOSS_ATOL = 1e-6
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 120, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)
TRANSPOSES = {"kgat": [f"fmasksT.{a}" for a in range(3)]}


def _jax_model(case):
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.data.synthetic import synthetic_graph
    from tagrec_tpu.models import MODEL_REGISTRY

    name, over = W.MASK_CASES[case]
    graph = synthetic_graph(**W.PROP_GRAPH, avg_deg=8, seed=7)
    return MODEL_REGISTRY[name](graph, model_preset(name, adj_mode="auto",
                                                    **over))


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
    its own processes, started together), and JAX's sharded steps
    meanwhile, all from JAX's initial parameters (its init jitted)."""
    tmp = tmp_path_factory.mktemp("masks")
    jparams = {case: str(tmp / f"jax_{case}.npz") for case in W.MASK_STEPS}
    args = {"jax_params": jparams, "batch": BATCH.tolist()}
    handles = [W.start_ranks(dp * mp, "masks", dict(args, dp=dp, mp=mp),
                             str(tmp / key))
               for key, (dp, mp) in MESHES.items()]
    handles.append(W.start_ranks(1, "masks", dict(args, plain=True),
                                 str(tmp / "plain")))
    # the ranks read each case's parameters once they need them (wait_for)
    jax_steps = {}
    for case in W.MASK_STEPS:
        jmodel = _jax_model(case)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        np.savez(str(tmp / "part.npz"), **_flat(params))
        os.replace(tmp / "part.npz", jparams[case])
        jax_steps[case] = _jax_step(jmodel, params, jmodel.device_data(),
                                    jnp.asarray(BATCH, jnp.int32),
                                    _jmesh(1, 2))
    *results, (ref,) = W.wait_ranks(*handles)
    return {"mesh": dict(zip(MESHES, results)), "ref": ref["cases"],
            "jax_step": jax_steps}


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
@pytest.mark.parametrize("case", CASES)
def test_placement_matches_jax_leaf_by_leaf(runs, case, mesh):
    """The port's ``gdev_sharding`` against JAX's on the whole masks, in
    JAX's leaf order, then the port's transposes, each by JAX's rule on
    its own rows; the ranks placed them so."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    want = {p: s for p, (s, _) in _jax_placed(case, _jmesh(dp, mp)).items()}
    model = W.mask_pipeline(case).model
    got = sharding.gdev_sharding(model, make_mesh(dp * mp, dp))
    assert model.tier == "kernels"
    assert list(got) == list(want) + TRANSPOSES.get(case, [])
    assert set(got.values()) == {"model"}
    for path in want:
        assert got[path] == want[path], path
    for rank in runs["mesh"][mesh]:
        assert rank["cases"][case]["placement"] == got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_rank_blocks_equal_jax_addressable_shards(case, mesh):
    """Each rank's masks as ``place_masks`` uploads them (the whole
    buffers let go first) against the shard JAX puts on that rank's
    device; each transpose against JAX's mask's columns there,
    transposed."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    jleaves = _jax_placed(case, jmesh)
    whole = {p: np.asarray(leaf) for p, (_, leaf) in jleaves.items()}
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices)
    model = W.mask_pipeline(case).model
    for path, (spec, leaf) in jleaves.items():
        assert spec == "model"
        for shard in leaf.addressable_shards:
            d, m = np.argwhere(ranks == shard.device.id)[0]
            model.place_masks(make_mesh(dp * mp, dp, rank=d * mp + m), "cpu")
            held = {p: getattr(model, name).numpy()
                    for p, name, _, _ in model.mask_hosts}
            np.testing.assert_array_equal(held[path], np.asarray(shard.data),
                                          err_msg=path)
            for tpath in TRANSPOSES.get(case, []):
                mask = whole[tpath.replace("fmasksT", "fmasks")]
                rows = held[tpath].shape[0]
                assert rows == mask.shape[1] // mp, tpath
                np.testing.assert_array_equal(
                    held[tpath], mask[:, m * rows:(m + 1) * rows].T,
                    err_msg=tpath)


SWEEP_BLOCKS = [(0, 240), (240, 480), (120, 360)]


@pytest.mark.parametrize("block", SWEEP_BLOCKS)
def test_routing_sweeps_over_a_row_block(block):
    """``routed_rowsum``, ``routed_mm_rows`` and ``routed_mm_bwd`` over a
    block of the mask's (and of its transpose's) rows: the whole sweep's
    rows there, bit for bit, into ``out`` too."""
    from tagrec_tpu_torch.ops import flash_routing as fr

    model = W.mask_pipeline("dgcf").model
    mask = model.mask
    rng = np.random.default_rng(5)
    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    q, k, x, g = draw(4, 480, 24), draw(4, 480, 24), draw(4, 480, 16), \
        draw(4, 480, 16)
    s, e = block
    part = mask[s:e]
    whole = (fr.routed_rowsum(q, k, mask, 1.0),
             fr.routed_mm_rows(q, k, mask, x, 1.0),
             fr.routed_mm_bwd(q, k, mask, g, 1.0))
    rows = (fr.routed_rowsum(q, k, part, 1.0, row0=s),
            fr.routed_mm_rows(q, k, part, x, 1.0, row0=s),
            fr.routed_mm_bwd(q, k, part, g, 1.0, row0=s))
    for w, r in zip(whole, rows):
        assert torch.equal(r, w[:, s:e])
    out = torch.full((4, e - s, 16), float("nan"))
    assert fr.routed_mm_rows(q, k, part, x, 1.0, row0=s, out=out) is out
    assert torch.equal(out, whole[1][:, s:e])
    with pytest.raises(ValueError, match="shape mismatch"):
        fr.routed_rowsum(q, k, part, 1.0, row0=480 - (e - s) + 1)


# fmaskT_0's rows against its split at 512: left of it, across it, right
FLASH_BLOCKS = [(0, 384), (384, 768), (192, 576), (576, 768)]


@pytest.mark.parametrize("block", FLASH_BLOCKS)
def test_flash_sweeps_over_a_row_block(block):
    """The four flash sweeps over a block of fmask_0's rows (stats,
    apply, ``dot_bwd_row``) and of fmaskT_0's (``dot_bwd_col``, left of,
    across or right of the split): the whole sweeps' rows there, bit for
    bit."""
    from tagrec_tpu_torch.ops import flash_attention as fa

    model = W.mask_pipeline("kgat").model
    mask, mask_t = model.fmask_0, model.fmaskT_0
    split = model.flash_splits()[0]
    ns, nd = mask.shape
    rng = np.random.default_rng(6)

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    q2, k, x, g = draw(2, ns, 32), draw(nd, 32), draw(nd, 16), draw(ns, 16)
    ms, zs = fa.dot_flash_stats(q2, k, mask, split)
    delta = draw(ns)
    s, e = block
    cs, ce = min(s, ns - 64), min(s, ns - 64) + 64  # a block of mask rows
    got_m, got_z = fa.dot_flash_stats(q2, k, mask[cs:ce], split, row0=cs)
    assert torch.equal(got_m, ms[cs:ce]) and torch.equal(got_z, zs[cs:ce])
    apply = fa.dot_flash_apply_rows(q2, k, mask, ms, zs, x, split)
    assert torch.equal(fa.dot_flash_apply_rows(q2, k, mask[cs:ce], ms, zs, x,
                                               split, row0=cs),
                       apply[cs:ce])
    args = (ms, zs, x, g, delta, split)
    assert torch.equal(fa.dot_bwd_row(q2, k, mask[cs:ce], *args, row0=cs),
                       fa.dot_bwd_row(q2, k, mask, *args)[:, cs:ce])
    dk, dx = fa.dot_bwd_col(q2, k, mask_t, *args)
    bk, bx = fa.dot_bwd_col(q2, k, mask_t[s:e], *args, row0=s)
    assert torch.equal(bk, dk[s:e]) and torch.equal(bx, dx[s:e])


@pytest.mark.parametrize("case", CASES)
def test_model_axis_alone_is_bit_for_bit(runs, case):
    """``model`` = 2 against one process: the forward, every phase's
    losses and the parameters after the steps bit for bit, and the step
    from JAX's parameters."""
    ref = runs["ref"][case]
    for rank in runs["mesh"]["model2"]:
        got = rank["cases"][case]
        assert got["tier"] == ref["tier"] == "kernels"
        for a, b in zip(got["forward"], ref["forward"]):
            np.testing.assert_array_equal(a, b)
        for phase in ref["losses"]:
            np.testing.assert_array_equal(got["losses"][phase],
                                          ref["losses"][phase], err_msg=phase)
        for k in ref["params"]:
            np.testing.assert_array_equal(got["params"][k], ref["params"][k],
                                          err_msg=k)
        if "step" in ref:
            (gl, gp, gg), (rl, rp, rg) = got["step"], ref["step"]
            assert gl == rl
            for k in rg:
                np.testing.assert_array_equal(gg[k], rg[k], err_msg=k)
                np.testing.assert_array_equal(gp[k], rp[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_2x2_within_the_data_axis_tolerances(runs, case):
    """The forward, each phase's 3 steps' losses and the parameters
    against one process."""
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


@pytest.mark.parametrize("case", W.MASK_STEPS)
def test_sharded_step_matches_jaxs_sharded_step(runs, case):
    """From JAX's parameters and one batch: the ``model`` = 2 ranks
    against JAX's step on its (1, 2) mesh; the one-process port too."""
    jloss, jparams, jgrads = runs["jax_step"][case]
    conditioned = total = 0
    for loss, params, grads in [r["cases"][case]["step"] for r in
                                runs["mesh"]["model2"]] + [
                                    runs["ref"][case]["step"]]:
        assert abs(loss - jloss) < 1e-5
        assert params.keys() == jparams.keys()
        assert _grad_errors(grads, jgrads) <= 1.0
        for k in jparams:
            well = np.abs(jgrads[k]) >= 100 * ADAM_EPS
            conditioned += well.sum()
            total += well.size
            np.testing.assert_allclose(params[k][well], jparams[k][well],
                                       rtol=0, atol=2e-6, err_msg=k)
    assert conditioned > 0.2 * total


@pytest.mark.parametrize("fault", list(W.MASK_FAULTS))
def test_planted_faults_fail_the_gradient_hold(runs, fault):
    """routed_mm's dx without the all-gather, or ``dot_bwd_col`` reading
    a rank's block of fmaskT as the attention's first columns, puts one
    step's gradients outside the hold that the sound step meets."""
    case = W.MASK_FAULTS[fault]
    rg = runs["ref"][case]["step"][2]
    for rank in runs["mesh"]["model2"]:
        assert _grad_errors(rank["cases"][case]["step"][2], rg) <= 1.0
    assert max(_grad_errors(rank["cases"][case]["faults"][fault][2], rg)
               for rank in runs["mesh"]["model2"]) > 10.0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_mask_bytes_are_the_ranks_blocks(runs, case, mesh):
    """rows / ``model`` of every mask and transpose: 1 / ``model`` of one
    device's bytes."""
    _, mp = MESHES[mesh]
    ref = runs["ref"][case]
    for rank in runs["mesh"][mesh]:
        got = rank["cases"][case]
        assert list(got["leaves"]) == list(ref["leaves"])
        for path, shape in ref["leaves"].items():
            assert got["placement"][path] == "model"
            assert got["leaves"][path] == (shape[0] // mp,) + shape[1:], path
        assert got["bytes"] * mp == ref["bytes"]


@pytest.mark.parametrize("case", CASES)
def test_shard_graph_is_idempotent_and_refuses_another_mesh(case):
    """``shard_graph`` after the build: the rank's rows of each mask,
    its sweeps' MaskShards; again over the same mesh a no-op; over
    another it raises."""
    from tagrec_tpu_torch.ops import dense_adj
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.mask_pipeline(case).model
    whole = model.mask_nbytes()
    assert sharding.graph_mesh(model) is None
    mesh = make_mesh(2, 1, rank=1)
    spec = sharding.shard_graph(model, mesh)
    assert sharding.graph_mesh(model) is mesh
    assert model.mask_nbytes() * 2 == whole
    for _, name, _, _ in model.mask_hosts:
        shard = model.sweep_mask(name)
        assert isinstance(shard, dense_adj.MaskShard) and shard.mesh is mesh
        assert shard.stop == shard.rows == 2 * shard.start
    assert sharding.shard_graph(model, mesh) == spec
    with pytest.raises(ValueError, match="sharded over"):
        sharding.shard_graph(model, make_mesh(2, 1, rank=1))
