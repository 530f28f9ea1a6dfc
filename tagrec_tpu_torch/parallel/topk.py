"""Top-k over a row-sharded item table (tagrec_tpu/parallel/topk.py).

Each ``model`` rank holds a block of the item (or entity) table: it scores
its block, masks the table's padding and the users' train positives, and
takes a local top-k; the candidates are all-gathered over ``model`` and
merged.  Communication is O(B k model), never the full score matrix.
Users are replicated (``P()`` in JAX).

Each function is a per-shard body and a merge, so that one process can run
every shard's body in turn (the tests) and a rank runs its own between two
collectives.  The merge sorts the candidates stably, in shard order, so
ties go to the lower id, as ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tagrec_tpu_torch.ops import metrics as M
from tagrec_tpu_torch.parallel.launch import row_block
from tagrec_tpu_torch.parallel.mesh import Mesh

AXIS = "model"


def shard_items(item_emb: torch.Tensor, mesh: Mesh, axis: str = AXIS
                ) -> Tuple[torch.Tensor, int]:
    """(this rank's block of the table zero-padded to a multiple of the
    axis size, the table's length): pass the length as ``n_valid`` so
    the padding is masked out of the top-k."""
    i = item_emb.shape[0]
    pad = (-i) % mesh.shape[axis]
    if pad:
        item_emb = torch.cat([item_emb, item_emb.new_zeros(
            (pad,) + tuple(item_emb.shape[1:]))])
    start, stop = row_block(item_emb.shape[0], mesh, axis)
    return item_emb[start:stop], i


def shard_scores(u: torch.Tensor, i_shard: torch.Tensor,
                 train_pad: torch.Tensor, offset: int,
                 n_valid: int) -> torch.Tensor:
    """sigmoid(u @ i_shard^T) [B, I/s] of the shard whose first global id
    is ``offset``: columns at or past ``n_valid`` and the train positives
    that fall in the shard set to MASK_VALUE."""
    scores = torch.sigmoid(u @ i_shard.T)
    cols = offset + torch.arange(i_shard.shape[0], device=scores.device)
    scores = torch.where(cols[None, :] < n_valid, scores,
                         scores.new_full((), M.MASK_VALUE))
    return M.mask_train_positives(scores, train_pad - offset)


def local_topk(scores: torch.Tensor, k: int, offset: int):
    """The shard's top-min(k, I/s) candidates -> (values, global ids)."""
    v, idx = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return v, idx + offset


def merge_topk(values: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
               k: int):
    """Every shard's candidates, in shard order -> the top k (values,
    ids); among equal values the earlier candidate first."""
    v_all, i_all = torch.cat(list(values), 1), torch.cat(list(ids), 1)
    mv, mi = torch.sort(v_all, dim=1, descending=True, stable=True)
    return mv[:, :k], torch.gather(i_all, 1, mi[:, :k])


def _gather(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return parts


def _offset(item_shard: torch.Tensor, mesh: Mesh, axis: str) -> int:
    return mesh.index(axis) * item_shard.shape[0]


def distributed_masked_topk(user_emb: torch.Tensor, item_shard: torch.Tensor,
                            train_pad: torch.Tensor, k: int, mesh: Mesh,
                            axis: str = AXIS, n_valid: Optional[int] = None):
    """Top-k item ids and scores of each user over a row-sharded item
    table.

    user_emb [B, D] (every rank the same); item_shard [I/s, D], this
    rank's block (``shard_items``); train_pad [B, P] global ids masked to
    MASK_VALUE (ids outside the table mask nothing).  -> (values [B, k],
    global ids [B, k]), the same on every rank of ``axis``."""
    offset = _offset(item_shard, mesh, axis)
    if n_valid is None:
        n_valid = item_shard.shape[0] * mesh.shape[axis]
    v, ids = local_topk(shard_scores(user_emb, item_shard, train_pad, offset,
                                     n_valid), k, offset)
    return merge_topk(_gather(v, mesh, axis), _gather(ids, mesh, axis), k)


# ------------------------------------------------- sharded evaluation

def eval_shard(u, i_shard, train_pad, test_pad, max_k: int, offset: int,
               n_valid: int):
    """A shard's first pass of ``sharded_eval_metrics`` -> (masked scores
    [B, I/s], candidate values and global ids [B, <=max_k], the scores of
    the test positives that fall in the shard, 0 elsewhere [B, T])."""
    scores = shard_scores(u, i_shard, train_pad, offset, n_valid)
    v, ids = local_topk(scores, max_k, offset)
    local = test_pad - offset
    inside = (test_pad >= 0) & (local >= 0) & (local < scores.shape[1])
    pos = torch.gather(scores, 1, torch.where(inside, local, 0))
    return scores, v, ids, pos * inside


def eval_below(scores: torch.Tensor, pos_scores: torch.Tensor):
    """A shard's second pass: the count of its scores strictly below each
    test positive's score [B, T] (float32, as JAX's)."""
    ordered = torch.sort(scores, dim=1).values
    return torch.searchsorted(ordered, pos_scores.contiguous(),
                              side="left").to(torch.float32)


def eval_merge(topk_ids, test_pad, test_deg, train_deg, below,
               topks: Sequence[int], i_total: int,
               n_valid: int) -> Dict[str, torch.Tensor]:
    """The block's metric sums from the merged top-k ids and the summed
    below counts: {"recall", "precision", "hr", "ndcg": [len(topks)],
    "auc": [1]}.  AUC counts ranks, JAX's way: masked and padding columns
    sit below every positive and are taken off its rank."""
    sums = M.batch_metric_sums(M.hit_labels(topk_ids, test_pad), test_deg,
                               tuple(topks))
    n_masked = train_deg.to(torch.float32)
    ranks = below - (n_masked + (i_total - n_valid))[:, None] + 1.0
    sum_pos = torch.sum(ranks * (test_pad >= 0).to(torch.float32), dim=1)
    npos = test_deg.to(torch.float32)
    nneg = torch.clamp(n_valid - n_masked - npos, min=1.0)
    auc = (sum_pos - npos * (npos + 1.0) / 2.0) / (npos * nneg)
    sums["auc"] = torch.sum(auc)[None]
    return sums


def sharded_eval_metrics(user_emb, item_shard, train_pad, test_pad, test_deg,
                         train_deg, topks: Sequence[int], mesh: Mesh,
                         axis: str = AXIS, n_valid: Optional[int] = None):
    """One block of the full-catalog evaluation over a row-sharded item
    table: the contract of ``ops.metrics.batch_metric_sums`` and
    ``batch_auc_sum``, the AUC by counting (strictly-below counts summed
    over shards; equal to the sort's ranks up to float ties).
    Communication: the candidates' all-gather and two [B, T] all-reduces.
    Every row of the block is a user (the evaluator does not pad)."""
    n_shards = mesh.shape[axis]
    i_total = item_shard.shape[0] * n_shards
    if n_valid is None:
        n_valid = i_total
    max_k = max(topks)
    scores, v, ids, pos = eval_shard(user_emb, item_shard, train_pad,
                                     test_pad, max_k,
                                     _offset(item_shard, mesh, axis), n_valid)
    _, topk_ids = merge_topk(_gather(v, mesh, axis), _gather(ids, mesh, axis),
                             max_k)
    group = mesh.group(axis)
    dist.all_reduce(pos, group=group)
    below = eval_below(scores, pos)
    dist.all_reduce(below, group=group)
    return eval_merge(topk_ids, test_pad, test_deg, train_deg, below, topks,
                      i_total, n_valid)
