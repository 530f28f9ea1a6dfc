"""Ranking metrics of the full-catalog evaluation (tagrec_tpu/ops/metrics.py).

The reference protocol on a block of users, on the tables' device: train
positives masked to -1024, top-k, hit labels, recall / precision / HR /
NDCG sums at each k, and the exact rank-based AUC over the unmasked items
(sklearn's roc_auc_score without tie averaging; sigmoid scores make exact
float32 ties rare).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MASK_VALUE = -1024.0  # -(1 << 10), the reference's train-positive score
PAD_ID = 1 << 30      # train-positive filler past every column: masks nothing


def pad_lists(lists: Dict[int, List[int]], n_rows: int,
              fill: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host tables of per-row id lists: ([n_rows, P] int32, each row's ids
    then ``fill``; [n_rows] int32 list lengths), P the longest list (at
    least 1)."""
    deg = np.zeros(n_rows, dtype=np.int32)
    for r, ids in lists.items():
        deg[r] = len(ids)
    pad = np.full((n_rows, max(int(deg.max(initial=0)), 1)), fill,
                  dtype=np.int32)
    for r, ids in lists.items():
        pad[r, :len(ids)] = ids
    return pad, deg


def mask_train_positives(scores: torch.Tensor,
                         train_pad: torch.Tensor) -> torch.Tensor:
    """``scores`` with each row's train positives set to MASK_VALUE, in
    place.  train_pad [B, P] is padded with PAD_ID; it and any other id
    outside the columns mask nothing (they are filtered, not dropped as
    under JAX: index_put_ would raise on them)."""
    keep = (train_pad >= 0) & (train_pad < scores.shape[1])
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    scores[rows.expand_as(train_pad)[keep], train_pad[keep]] = MASK_VALUE
    return scores


def hit_labels(topk_ids: torch.Tensor, test_pad: torch.Tensor) -> torch.Tensor:
    """[B, K] float32: 1 where the ranked item is a test positive.  test_pad
    is padded with -1, which matches no id."""
    eq = topk_ids[:, :, None] == test_pad[:, None, :]
    return eq.any(dim=-1).to(torch.float32)


def batch_metric_sums(label: torch.Tensor, test_deg: torch.Tensor,
                      topks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Sums over the block's users of recall (right / |test|), precision
    (right / k), HR (right > 0) and binary-relevance NDCG, one per k ->
    {metric: [len(topks)]}."""
    deg = test_deg.to(torch.float32)
    max_k = label.shape[1]
    discounts = 1.0 / torch.log2(torch.arange(2, max_k + 2, dtype=torch.float32,
                                              device=label.device))
    slots = torch.arange(max_k, device=label.device)[None, :]
    rec, pre, hr, ndcg = [], [], [], []
    for k in topks:
        right = label[:, :k].sum(dim=1)
        rec.append(torch.sum(right / torch.clamp(deg, min=1.0)))
        pre.append(torch.sum(right) / k)
        hr.append(torch.sum((right > 0).to(torch.float32)))
        # ideal gain: the first min(k, |test|) slots are hits
        ideal = (slots[:, :k] < torch.clamp(test_deg, max=k)[:, None])
        idcg = torch.sum(ideal.to(torch.float32) * discounts[None, :k], dim=1)
        dcg = torch.sum(label[:, :k] * discounts[None, :k], dim=1)
        ndcg.append(torch.sum(dcg / torch.where(idcg == 0.0, 1.0, idcg)))
    return {"recall": torch.stack(rec), "precision": torch.stack(pre),
            "hr": torch.stack(hr), "ndcg": torch.stack(ndcg)}


def batch_auc_sum(masked_scores: torch.Tensor, test_pad: torch.Tensor,
                  test_deg: torch.Tensor,
                  train_deg: torch.Tensor) -> torch.Tensor:
    """Sum over the block's users of the rank-based ROC AUC of the test
    items among the unmasked items.  Masked scores sort below every sigmoid
    score, so an item's rank among the unmasked is its rank minus the
    user's masked count.  Ranks come from a stable sort, as jnp.argsort's."""
    n_items = masked_scores.shape[1]
    order = torch.argsort(masked_scores, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(1, n_items + 1, device=order.device)
                   .expand_as(order))
    pos_ranks = torch.gather(ranks, 1, test_pad.clamp(0, n_items - 1))
    is_pos = (test_pad >= 0).to(torch.float32)
    n_masked = train_deg.to(torch.float32)
    sum_pos = torch.sum((pos_ranks.to(torch.float32) - n_masked[:, None])
                        * is_pos, dim=1)
    npos = test_deg.to(torch.float32)
    nneg = torch.clamp(n_items - n_masked - npos, min=1.0)
    return torch.sum((sum_pos - npos * (npos + 1.0) / 2.0) / (npos * nneg))
