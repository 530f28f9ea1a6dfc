"""The chunked dense tiers row-partitioned over ``model``: DisenHAN's six
relation masks, KGAT's ``rel_id`` over a KG and the ``dense_xla`` tier's
``mask`` (DGCF, DisenGCN, KGAT) placed by JAX's ``gdev_sharding`` rule,
each chunked function run on a rank's rows in JAX's fixed chunks, one
all-gather forward, one sum over ``model`` backward
(``ops.dense_adj``, ``models.base.MaskGraph``).

On PROP_GRAPH (``torch_mesh_worker``, 480 nodes) and a KG of 520 nodes
(``KG_TINY``): DisenHAN's [120, 300], [300, 120] and [300, 60] masks cut
over 2 and its tag masks' 60 rows whole, as JAX keeps them; ``rel_id``
[520, 520], whose 260 rows a rank hold the whole user segment (rank 0)
or start mid-segment (rank 1); the [480, 480] ``dense_xla`` mask.  The
ranks (gloo over the CPU, torch and the port only) run on a ``model`` =
2 mesh and the one-process reference in a process of its own, started
together by one module fixture, while JAX's init and sharded steps are
jitted here from the port's initial parameters:

* the placement leaf by leaf against JAX's ``gdev_sharding`` on its
  (1, 2) and (2, 2) meshes; each rank's cut tables array-equal to JAX's
  ``addressable_shards``;
* each chunked function over a block that starts mid-chunk (the KG's
  also mid-segment) bit for bit with the whole call's rows, at a small
  chunk;
* ``model`` = 2 against one process: the forward and the exported tables
  bit for bit, each of 3 steps' gradients within 5e-4 |g| + 1e-4 max|g|,
  the parameters within the data-axis tolerance; every rank's gathered
  parameters equal;
* one DisenHAN and one KG BPR step, from the port's initial parameters,
  against JAX's sharded step on its (1, 2) mesh;
* each planted fault (a whole mask's relation back-propagated on every
  rank; no sum over ``model``) outside that gradient hold;
* each rank's table bytes its blocks; ``shard_graph`` idempotent,
  refusing another mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_threads import one_torch_thread  # noqa: F401

CASES = list(W.DENSE_CASES)
MESHES = {"model2": (1, 2), "2x2": (2, 2)}  # (data, model)
PARAM_ATOL = 0.01 * W.tcfg().lr * W.STEPS
LOSS_RTOL = 1e-6
ADAM_EPS = 1e-8
BATCH = np.stack([np.arange(16) % 120, np.arange(16) % 300,
                  (np.arange(16) * 7 + 3) % 300], 1)
# the leaves JAX's rule keeps whole here: DisenHAN's tag masks (60 rows)
WHOLE = {"disenhan": {"masks.3", "masks.5"}}


def _jax_model(case):
    from tagrec_tpu.config import model_preset
    from tagrec_tpu.data.kg import KnowledgeGraph
    from tagrec_tpu.data.synthetic import synthetic_graph
    from tagrec_tpu.models import MODEL_REGISTRY

    name, over, adj_mode, with_kg = W.DENSE_CASES[case]
    graph = synthetic_graph(**W.PROP_GRAPH, avg_deg=8, seed=7)
    kw = ({"kg": KnowledgeGraph.synthetic(graph, **W.KG_TINY)} if with_kg
          else {})
    return MODEL_REGISTRY[name](graph, model_preset(name, adj_mode=adj_mode,
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
    """The ``model`` = 2 ranks and the one-process reference (each in
    their own processes, started together), and meanwhile JAX's sharded
    steps from the port's initial parameters."""
    from tagrec_tpu_torch.training import checkpoint

    tmp = tmp_path_factory.mktemp("dense")
    args = {"batch": BATCH.tolist()}
    handles = [W.start_ranks(2, "dense", dict(args, dp=1, mp=2),
                             str(tmp / "model2")),
               W.start_ranks(1, "dense", dict(args, plain=True),
                             str(tmp / "plain"))]
    jax_steps = {}
    for case in W.DENSE_STEPS:
        jmodel = _jax_model(case)
        params = checkpoint._tree_of({
            k: jnp.asarray(v) for k, v in W.full_params(
                W.dense_pipeline(case).model).items()})
        jax_steps[case] = _jax_step(jmodel, params, jmodel.device_data(),
                                    jnp.asarray(BATCH, jnp.int32),
                                    _jmesh(1, 2))
    ranks, (ref,) = W.wait_ranks(*handles)
    return {"ranks": ranks, "ref": ref["cases"], "jax_step": jax_steps}


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
    """The port's ``gdev_sharding`` against JAX's, in JAX's leaf order;
    the ``model`` = 2 ranks placed them so."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    want = {p: s for p, (s, _) in _jax_placed(case, _jmesh(dp, mp)).items()}
    model = W.dense_pipeline(case).model
    got = sharding.gdev_sharding(model, make_mesh(dp * mp, dp))
    assert got == want and list(got) == list(want)
    assert {p for p, s in got.items() if s is None} == WHOLE.get(case, set())
    if mesh == "model2":
        for rank in runs["ranks"]:
            assert rank["cases"][case]["placement"] == got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_rank_blocks_equal_jax_addressable_shards(case, mesh):
    """Each rank's tables as ``place_masks`` uploads them against the
    shard JAX puts on that rank's device (a whole leaf: all of it)."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    dp, mp = MESHES[mesh]
    jmesh = _jmesh(dp, mp)
    ranks = np.vectorize(lambda d: d.id)(jmesh.devices)
    model = W.dense_pipeline(case).model
    for path, (_, leaf) in _jax_placed(case, jmesh).items():
        for shard in leaf.addressable_shards:
            d, m = np.argwhere(ranks == shard.device.id)[0]
            model.place_masks(make_mesh(dp * mp, dp, rank=d * mp + m), "cpu")
            held = {p: getattr(model, name).numpy()
                    for p, name, _, _ in model.mask_hosts}
            np.testing.assert_array_equal(held[path], np.asarray(shard.data),
                                          err_msg=path)


CHUNK = 16


def _draw(rng, *shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)


def _chunked_calls(rng):
    """{function: (call(mask, row0 = 0) on the whole mask or a block of
    its rows, the whole mask's rows, the rows' axis of the result)}, on
    seeded inputs at CHUNK."""
    from tagrec_tpu_torch.ops import dense_adj as da

    n, m, f = 100, 90, 3
    mask = torch.from_numpy(rng.random((n, m)) < 0.3)
    sq = torch.from_numpy(rng.random((n, n)) < 0.3)
    rel = torch.from_numpy(np.where(rng.random((n, m)) < 0.3,
                                    rng.integers(0, 3, (n, m)), -1)
                           .astype(np.int8))
    qhat, khat = _draw(rng, n, 8), _draw(rng, m, 8)
    q, k = _draw(rng, 3, n, 4), _draw(rng, 3, m, 4)
    head, tail = _draw(rng, f, n, 4), _draw(rng, f, n, 4)
    u, v, x = _draw(rng, f, n, 5), _draw(rng, f, n, 5), _draw(rng, f, n, 6)
    hs, ts, r_src = _draw(rng, f, n), _draw(rng, f, m), _draw(rng, f, n)
    old_dst, p = _draw(rng, f, m, 4), _draw(rng, n, m)
    xm = _draw(rng, m, 7)
    # two segments, the second starting mid-chunk: (start, length, rels)
    segs = ((0, 37, (0,)), (37, n - 37, (1, 2)))
    return {
        "dense_row_softmax_scores": (lambda mk: da.dense_row_softmax_scores(
            qhat, khat, mk, CHUNK), mask, 0),
        "rel_dense_row_softmax_scores": (
            lambda mk: da.rel_dense_row_softmax_scores(
                q, k, mk, CHUNK, row_segments=segs), rel, 0),
        "routed_agg_dense": (lambda mk: da.routed_agg_dense(
            head, tail, mk, CHUNK), sq, 1),
        "dgcf_dense_degree": (lambda mk: da.dgcf_dense_degree(
            u, v, mk, CHUNK), sq, 1),
        "dgcf_dense_prop": (lambda mk: da.dgcf_dense_prop(
            u, v, mk, x, CHUNK), sq, 1),
        "disenhan_dense_rela": (lambda mk: da.disenhan_dense_rela(
            hs, ts, r_src, old_dst, mk, CHUNK), mask, 1),
        "rows_mm": (lambda mk: da.rows_mm(
            p[mk.start:mk.stop] if isinstance(mk, da.MaskShard) else p, xm,
            CHUNK, mk.start if isinstance(mk, da.MaskShard) else 0), mask,
            0)}


# rows of a block: mid-chunk on both ends (and past the KG's second
# segment's start), from row 0, to the last row
BLOCKS = [(21, 70), (0, 50), (50, 100), (40, 45)]
FUNCTIONS = ["dense_row_softmax_scores", "rel_dense_row_softmax_scores",
             "routed_agg_dense", "dgcf_dense_degree", "dgcf_dense_prop",
             "disenhan_dense_rela", "rows_mm"]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_chunked_function_over_a_row_block(fn):
    """Each chunked function over a MaskShard of rows [start, stop): the
    whole call's rows there, bit for bit, for every block of BLOCKS (the
    KG's relation-dense function with its second segment starting at row
    37, mid-chunk)."""
    from tagrec_tpu_torch.ops import dense_adj as da

    call, mask, ax = _chunked_calls(np.random.default_rng(8))[fn]
    whole = call(mask)
    for s, e in BLOCKS:
        got = call(da.MaskShard(mask[s:e], s, e, mask.shape[0], None))
        assert got.shape[ax] == e - s
        assert torch.equal(got, whole.narrow(ax, s, e - s)), (fn, s, e)


@pytest.mark.parametrize("case", CASES)
def test_model_axis_against_one_process(runs, case):
    """``model`` = 2 against one process: the forward and the exported
    tables bit for bit; each of the 3 steps' gradients within the
    gradient rule, the losses within rtol 1e-6, the parameters after the
    steps within the data-axis bound; the ranks' gathered parameters
    equal."""
    ref = runs["ref"][case]
    ranks = [r["cases"][case] for r in runs["ranks"]]
    for got in ranks:
        assert got["tier"] == ref["tier"]
        for a, b in zip(got["forward"] + list(got["export"]),
                        ref["forward"] + list(ref["export"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert len(got["grads"]) == len(ref["grads"]) == W.STEPS
        for g, r in zip(got["grads"], ref["grads"]):
            assert _grad_errors(g, r) <= 1.0
        for k in ref["params"]:
            np.testing.assert_allclose(got["params"][k], ref["params"][k],
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[1]["params"][k],
                                      ranks[0]["params"][k], err_msg=k)


@pytest.mark.parametrize("case", W.DENSE_STEPS)
def test_sharded_step_matches_jaxs_sharded_step(runs, case):
    """From the initial parameters and one batch: the ``model`` = 2 ranks
    against JAX's step on its (1, 2) mesh; the one-process port too."""
    jloss, jparams, jgrads = runs["jax_step"][case]
    conditioned = total = 0
    for loss, params, grads in [r["cases"][case]["step"] for r in
                                runs["ranks"]] + [runs["ref"][case]["step"]]:
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


@pytest.mark.parametrize("fault", list(W.DENSE_FAULTS))
def test_planted_faults_fail_the_gradient_hold(runs, fault):
    """DisenHAN's whole tag-mask relations back-propagated on every rank
    (counted twice; two layers, through which alone they reach the loss),
    or the KG's q, k and x gradients left unsummed over ``model``, puts
    one step's gradients outside the hold that the sound step meets."""
    case = W.DENSE_FAULTS[fault]
    rg = runs["ref"][case]["step"][2]
    for rank in runs["ranks"]:
        assert _grad_errors(rank["cases"][case]["step"][2], rg) <= 1.0
    assert max(_grad_errors(rank["cases"][case]["faults"][fault][2], rg)
               for rank in runs["ranks"]) > 10.0


@pytest.mark.parametrize("case", CASES)
def test_table_bytes_are_the_ranks_blocks(runs, case):
    """rows / ``model`` of every cut table, all of a whole one."""
    ref = runs["ref"][case]
    for i, rank in enumerate(runs["ranks"]):
        got = rank["cases"][case]
        held = 0
        for (path, shape), name in zip(ref["leaves"].items(), got["blocks"]):
            cut = got["placement"][path] == "model"
            rows = shape[0] // 2 if cut else shape[0]
            assert got["leaves"][path] == (rows,) + shape[1:], path
            assert got["blocks"][name] == (
                (i * rows, (i + 1) * rows) if cut else None), path
            held += rows * int(np.prod(shape[1:]))
        assert got["bytes"] == held < ref["bytes"]


@pytest.mark.parametrize("case", CASES)
def test_shard_graph_is_idempotent_and_refuses_another_mesh(case):
    """``shard_graph`` after the build: the rank's rows of each cut
    table, its MaskShards; again over the same mesh a no-op; over another
    it raises."""
    from tagrec_tpu_torch.ops import dense_adj
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    model = W.dense_pipeline(case).model
    whole = model.mask_nbytes()
    assert sharding.graph_mesh(model) is None
    mesh = make_mesh(2, 1, rank=1)
    spec = sharding.shard_graph(model, mesh)
    assert sharding.graph_mesh(model) is mesh
    assert model.mask_nbytes() < whole
    for path, name, _, _ in model.mask_hosts:
        shard = model.sweep_mask(name)
        if spec[path] is None:
            assert isinstance(shard, torch.Tensor)
            continue
        assert isinstance(shard, dense_adj.MaskShard) and shard.mesh is mesh
        assert shard.stop == shard.rows == 2 * shard.start
    assert sharding.shard_graph(model, mesh) == spec
    with pytest.raises(ValueError, match="sharded over"):
        sharding.shard_graph(model, make_mesh(2, 1, rank=1))
