"""The port's parallel layer held against JAX's on the 8-device CPU mesh,
in one process: mesh shapes, the per-process row and batch bounds (8
processes, and 2 hosts x 4), row-sharded blocks, the placement rule,
the batch slice, ``shard_items``' padding, and the per-shard bodies and
merges of the distributed top-k and the sharded evaluation, each shard's
body run in turn (ids exact, sums within 1e-6).  The multi-process runs
are in test_torch_parallel_dist.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagrec_tpu.parallel import launch as jlaunch
from tagrec_tpu.parallel import sharding as jshd
from tagrec_tpu.parallel import topk as jtopk
from tagrec_tpu.parallel.mesh import make_mesh as jmake_mesh
from tagrec_tpu_torch.parallel import launch, sharding, topk
from tagrec_tpu_torch.parallel.mesh import make_mesh

SHAPES = [(8, 4), (8, 8), (8, 2), (8, 1), (4, 2)]  # (ranks, data)


def _jmesh(n, dp):
    assert len(jax.devices()) >= 8
    return jmake_mesh(n, data_parallel=dp)


def _meshes(n, dp):
    """The port's shape-only mesh seen from each rank."""
    return [make_mesh(n, dp, rank=r) for r in range(n)]


@pytest.mark.parametrize("n, dp", SHAPES)
def test_mesh_shape_and_rank_layout_match_jax(n, dp):
    jm, m = _jmesh(n, dp), make_mesh(n, dp)
    assert m.shape == dict(jm.shape)
    np.testing.assert_array_equal(
        m.ranks, np.vectorize(lambda d: d.id)(jm.devices))
    for r in range(n):
        d, mm = np.argwhere(m.ranks == r)[0]
        assert (m.index("data", r), m.index("model", r)) == (d, mm)
    assert m.groups is None


@pytest.mark.parametrize("axis", ["model", "data"])
@pytest.mark.parametrize("hosts", [8, 2])
@pytest.mark.parametrize("n, dp", [(8, 4), (8, 2), (8, 1)])
def test_shard_and_batch_bounds_match_jax(n, dp, hosts, axis):
    """Per simulated process (8 processes, or 2 hosts x 4 ranks)."""
    jm, m = _jmesh(n, dp), make_mesh(n, dp)
    per = n // hosts
    for p in range(hosts):
        if axis == "model":
            want = jlaunch.shard_bounds(64, jm, "model", process_index=p,
                                        process_of=lambda d: d.id // per)
            got = launch.shard_bounds(64, m, "model", process_index=p,
                                      process_of=lambda r: r // per)
        else:
            want = jlaunch.batch_bounds(32, jm, process_index=p,
                                        process_of=lambda d: d.id // per)
            got = launch.batch_bounds(32, m, process_index=p,
                                      process_of=lambda r: r // per)
        assert got == want, (p, got, want)


@pytest.mark.parametrize("n, dp", [(8, 4), (8, 2)])
def test_materialize_row_sharded_blocks_match_jax(n, dp):
    """Each rank's block is JAX's shard on that rank's device, and fill is
    called for that block only."""
    rows, d = 48, 8
    ref = np.arange(rows * d, dtype=np.float32).reshape(rows, d)
    arr = jlaunch.materialize_row_sharded((rows, d), _jmesh(n, dp),
                                          lambda s, e: ref[s:e])
    by_device = {s.device.id: np.asarray(s.data)
                 for s in arr.addressable_shards}
    for m in _meshes(n, dp):
        calls = []

        def fill(s, e):
            calls.append((s, e))
            return ref[s:e]

        block = launch.materialize_row_sharded((rows, d), m, fill,
                                               device="cpu")
        np.testing.assert_array_equal(block.numpy(), by_device[m.rank])
        assert calls == [launch.row_block(rows, m)]


@pytest.mark.parametrize("model", ["lightgcn", "dgcf", "kgat"])
@pytest.mark.parametrize("n, dp", [(8, 4), (8, 8)])
def test_placement_rule_matches_jax(tiny_graph, model, n, dp):
    """``params_sharding`` puts the same leaves on ``model`` as JAX's, on
    JAX's own parameter tree for the same model."""
    from tagrec_tpu.models import MODEL_REGISTRY
    from tagrec_tpu.config import model_preset as jpreset
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.training.checkpoint import _leaves

    over = {"agg_type": "bi_inter"} if model == "kgat" else {}
    jm = _jmesh(n, dp)
    jparams = MODEL_REGISTRY[model](tiny_graph, jpreset(model, **over)).init(
        jax.random.PRNGKey(0))
    want = {name: spec.spec == jax.sharding.PartitionSpec("model")
            for name, spec in _leaves(jshd.params_sharding(jparams, jm))}
    from tagrec_tpu_torch.data.synthetic import synthetic_graph

    port = model_class(model)(synthetic_graph(n_user=40, n_item=90, n_tag=25,
                                              avg_deg=8, seed=7),
                              model_preset(model, **over), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    got = sharding.params_sharding(port, make_mesh(n, dp))
    assert {k: v == "model" for k, v in got.items()} == want
    assert any(want.values())


@pytest.mark.parametrize("n, dp", [(8, 4), (8, 1)])
def test_batch_slice_is_the_ranks_batch_bounds(n, dp):
    """``constrain_batch`` gives each rank the rows JAX's batch_bounds
    assign it; an indivisible leaf and the correlation ids stay whole."""
    batch = {"bpr": torch.arange(32 * 3).reshape(32, 3),
             "odd": torch.arange(7), "cor": {"user": torch.arange(16)}}
    jm = _jmesh(n, dp)
    for m in _meshes(n, dp):
        got = sharding.constrain_batch(batch, m)
        (s, e), = jlaunch.batch_bounds(32, jm, process_index=m.rank,
                                       process_of=lambda d: d.id)
        assert torch.equal(got["bpr"], batch["bpr"][s:e])
        assert torch.equal(got["odd"], batch["odd"])
        assert got["cor"] is batch["cor"]


@pytest.mark.parametrize("n_item", [101, 96])
@pytest.mark.parametrize("n, dp", [(8, 4), (8, 2)])
def test_shard_items_padding_matches_jax(n_item, n, dp):
    rng = np.random.default_rng(0)
    it = rng.standard_normal((n_item, 8)).astype(np.float32)
    jpad, jn = jtopk.shard_items(jnp.asarray(it), _jmesh(n, dp))
    blocks = {}
    for m in _meshes(n, dp):
        block, nv = topk.shard_items(torch.from_numpy(it), m)
        assert nv == jn == n_item
        blocks.setdefault(m.index("model"), block)
    np.testing.assert_array_equal(
        torch.cat([blocks[i] for i in sorted(blocks)]).numpy(),
        np.asarray(jpad))


def _inputs(seed, b=16, n_item=101, d=8):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, d)).astype(np.float32)
    it = rng.standard_normal((n_item, d)).astype(np.float32)
    train = [sorted(rng.choice(n_item, size=rng.integers(1, 6),
                               replace=False).tolist()) for _ in range(b)]
    test = [sorted(rng.choice(np.setdiff1d(np.arange(n_item), tr),
                              size=rng.integers(1, 7),
                              replace=False).tolist()) for tr in train]
    tr_pad = np.full((b, max(map(len, train))), 1 << 30, np.int32)
    te_pad = np.full((b, max(map(len, test))), -1, np.int32)
    for i in range(b):
        tr_pad[i, :len(train[i])] = train[i]
        te_pad[i, :len(test[i])] = test[i]
    return (u, it, tr_pad, te_pad, np.asarray([len(t) for t in test], np.int32),
            np.asarray([len(t) for t in train], np.int32))


def _shards(it, n, dp):
    """[(offset, block)] of each model index, in order."""
    out = {}
    for m in _meshes(n, dp):
        block, n_valid = topk.shard_items(torch.from_numpy(it), m)
        out[m.index("model")] = (m.index("model") * block.shape[0], block)
    return [out[i] for i in sorted(out)], n_valid


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("n, dp", [(8, 4), (8, 2)])
def test_distributed_topk_bodies_match_jax(k, n, dp):
    """Each shard's body, then the merge: JAX's ids exactly, its values
    within 1e-6 (k = 40 is past a shard of 26 items at model = 4)."""
    u, it, tr_pad, *_ = _inputs(1)
    jm = _jmesh(n, dp)
    fn = jax.jit(functools.partial(jtopk.distributed_masked_topk, k=k,
                                   mesh=jm, n_valid=it.shape[0]))
    jv, ji = fn(jnp.asarray(u), jtopk.shard_items(jnp.asarray(it), jm)[0],
                jnp.asarray(tr_pad))
    shards, n_valid = _shards(it, n, dp)
    tu, ttp = torch.from_numpy(u), torch.from_numpy(tr_pad).long()
    cands = [topk.local_topk(topk.shard_scores(tu, blk, ttp, off, n_valid),
                             k, off) for off, blk in shards]
    v, ids = topk.merge_topk([c[0] for c in cands], [c[1] for c in cands], k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("n, dp", [(8, 4), (8, 2)])
def test_sharded_eval_bodies_match_jax(seed, n, dp):
    """The two passes over every shard and the merges: each metric sum and
    the count-based AUC within 1e-6 of JAX's ``sharded_eval_metrics``
    (every row a user: JAX's ``valid`` all ones)."""
    u, it, tr_pad, te_pad, te_deg, tr_deg = _inputs(seed)
    topks = (10, 20)
    jm = _jmesh(n, dp)
    fn = jax.jit(functools.partial(jtopk.sharded_eval_metrics, topks=topks,
                                   mesh=jm, n_valid=it.shape[0]))
    want = fn(jnp.asarray(u), jtopk.shard_items(jnp.asarray(it), jm)[0],
              jnp.asarray(tr_pad), jnp.asarray(te_pad), jnp.asarray(te_deg),
              jnp.asarray(tr_deg), jnp.ones(len(u), jnp.int32))
    shards, n_valid = _shards(it, n, dp)
    t = [torch.from_numpy(x).long() for x in (tr_pad, te_pad, te_deg, tr_deg)]
    first = [topk.eval_shard(torch.from_numpy(u), blk, t[0], t[1], max(topks),
                             off, n_valid) for off, blk in shards]
    _, ids = topk.merge_topk([f[1] for f in first], [f[2] for f in first],
                             max(topks))
    pos = sum(f[3] for f in first)
    below = sum(topk.eval_below(f[0], pos) for f in first)
    got = topk.eval_merge(ids, t[1], t[2], t[3], below, topks,
                          sum(b.shape[0] for _, b in shards), n_valid)
    for key in ("recall", "precision", "hr", "ndcg", "auc"):
        np.testing.assert_allclose(got[key].numpy().reshape(-1),
                                   np.asarray(want[key]).reshape(-1),
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group in this process, torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_sharded_evaluation_pads_no_block(one_rank_mesh):
    """JAX pads the last block of users with user 0 at weight 0, so a user
    0 with no test item makes its AUC NaN (ROADMAP.md section C).  The
    port's sharded evaluation, like its one-device one, takes a shorter
    last block: with user 0 out of the test split and 40 users in blocks
    of 16, a finite AUC within rtol 5e-3 of the one-device one (ranks by
    counting) and the same ranking metrics."""
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.training.evaluate import Evaluator

    graph = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8,
                            seed=7)
    graph.user_items["test"].pop(0, None)
    tcfg = TrainConfig(test_batch=16)
    pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg, device="cpu",
                          mesh=one_rank_mesh,
                          generator=torch.Generator().manual_seed(0))
    got = pipe.evaluator.run(pipe.model)
    want = Evaluator(graph, tcfg, device="cpu").run(pipe.model)
    assert np.isfinite(got["auc"][0])
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=5e-3)
    for m in ("recall", "precision", "hr", "ndcg"):
        assert got[m] == want[m], m
