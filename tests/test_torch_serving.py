"""The port's serving (tagrec_tpu_torch.serving) against the JAX package's.

For the same tables the two retrievers must serve the same lists: scores
equal at atol 1e-6 (float32 sigmoid of the same products), and ids equal
wherever the scores around a rank differ by more than 1e-6 (``lax.top_k``
breaks ties by lower index; ``torch.topk`` promises no order among ties).
Artifacts written by either side load in the other.
"""

import os

import numpy as np
import pytest
import torch

from tagrec_tpu import serving as jserving
from tagrec_tpu_torch import serving
from tagrec_tpu_torch.ops import metrics

ATOL, GAP = 1e-6, 1e-6
N_USER, N_ITEM, DIM = 23, 57, 8


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((N_USER, DIM)).astype(np.float32)
    i = rng.standard_normal((N_ITEM, DIM)).astype(np.float32)
    i[7] = i[3]  # two items that tie for every user
    pos = {int(x): sorted(rng.choice(N_ITEM, int(rng.integers(0, 9)),
                                     replace=False).tolist())
           for x in range(N_USER) if x != 4}  # user 4 has no positives
    return u, i, pos


def _assert_same_lists(ids, scores, want_ids, want_scores):
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=ATOL)
    padded = np.pad(want_scores, ((0, 0), (1, 1)), constant_values=np.inf)
    padded[:, -1] = -np.inf
    clear = ((padded[:, :-2] - padded[:, 1:-1] > GAP)
             & (padded[:, 1:-1] - padded[:, 2:] > GAP))
    np.testing.assert_array_equal(ids[clear], want_ids[clear])


@pytest.mark.parametrize("users,block,k", [
    ([0, 3, 7, 11, 2], 4, 10),          # not a multiple of the block
    (list(range(N_USER)), 8, 20),
    ([4, 4, 9], 256, 5),                # one user twice, one block
])
def test_topk_matches_jax(tables, users, block, k):
    u, i, pos = tables
    pad, _ = metrics.pad_lists(pos, N_USER, serving.PAD_ID)
    ids, scores = serving.Retriever(u, i, train_pad=pad, block=block,
                                    device="cpu").topk(users, k)
    want_ids, want_scores = jserving.Retriever(
        u, i, train_pad=pad, block=block).topk(users, k)
    assert ids.dtype == np.int32 and scores.dtype == np.float32
    assert ids.shape == scores.shape == (len(users), k)
    _assert_same_lists(ids, scores, want_ids, want_scores)
    for b, user in enumerate(users):
        assert not set(ids[b].tolist()) & set(pos.get(user, []))


def test_pad_sentinel_masks_nothing(tables):
    """Rows padded with the 1 << 30 sentinel, and a table of nothing but
    sentinels, serve the unmasked ranking."""
    u, i, _ = tables
    assert serving.PAD_ID == 1 << 30
    want_ids, want = serving.Retriever(u, i, device="cpu").topk([1, 2], N_ITEM)
    pad = np.full((N_USER, 3), serving.PAD_ID, dtype=np.int32)
    pad[2, 0] = 5
    ids, scores = serving.Retriever(u, i, train_pad=pad,
                                    device="cpu").topk([1, 2], N_ITEM)
    np.testing.assert_allclose(scores[0], want[0], rtol=0, atol=ATOL)
    assert scores[1, -1] == serving.MASK_SCORE and ids[1, -1] == 5
    np.testing.assert_allclose(scores[1, :-1], want[1][want_ids[1] != 5],
                               rtol=0, atol=ATOL)
    assert sorted(ids[1, :-1].tolist()) == sorted(set(range(N_ITEM)) - {5})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_load(tables, tmp_path, writer):
    u, i, pos = tables
    path = os.path.join(tmp_path, "art")  # '.npz' appended by both sides
    save = jserving.save_export if writer == "jax" else serving.save_export
    meta = save(path, u, i, model_name="dgcf", train_pos=pos,
                extra={"dataset": "tiny"})
    assert meta["version"] == serving.EXPORT_VERSION == jserving.EXPORT_VERSION
    for load in (serving.load_export, jserving.load_export):
        data, got_meta = load(path)
        assert got_meta == meta
        np.testing.assert_array_equal(data["user_table"], u)
        np.testing.assert_array_equal(data["item_table"], i)
    users = [0, 4, 6]
    ids, scores = serving.Retriever.from_export(path, block=2,
                                                device="cpu").topk(users, 10)
    want_ids, want_scores = jserving.Retriever.from_export(
        path, block=2).topk(users, 10)
    _assert_same_lists(ids, scores, want_ids, want_scores)


def test_export_tables_and_query_cli(tmp_path, capsys):
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.models import model_class

    graph = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
    model = model_class("dgcf")(graph, model_preset("dgcf"), device="cpu",
                                generator=torch.Generator().manual_seed(2))
    u_t, i_t = serving.export_tables(model, n_item=graph.n_item)
    assert u_t.shape == (40, 64) and i_t.shape == (90, 64)
    assert u_t.dtype == np.float32 and np.isfinite(u_t).all()
    with torch.no_grad():
        want = model.predict([1, 2]).numpy()
    np.testing.assert_allclose(1 / (1 + np.exp(-(u_t[[1, 2]] @ i_t.T))), want,
                               rtol=1e-5, atol=1e-6)
    path = os.path.join(tmp_path, "art.npz")
    serving.save_export(path, u_t, i_t, model_name="dgcf",
                        train_pos=graph.user_items["train"])
    serving.main(["--artifact", path, "--users", "1", "2", "--k", "3",
                  "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and '"user": 1' in lines[0]
