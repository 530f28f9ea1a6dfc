"""Plain reference of the full-catalog evaluation protocol of the
tag-aware reference: for every test user, sigmoid(u . i) over every item,
the user's train items set to -1024, the top k, recall (hits / |test|),
precision (hits / k), HR (any hit) and NDCG (binary relevance) at each k,
and the rank-based ROC AUC of the test items among the items not masked.

In the control's precision (``Precision("tf32")``) the scores' products
take TF32 operands, and the scores as the top-k and the AUC's sort take
them, the ranks and every metric sum are bfloat16: the step below the
stated float32 that each operation has on the card.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import _common as C

MASK_VALUE = -1024.0
METRICS = ("recall", "precision", "hr", "ndcg")


def _block_mask(pairs: torch.Tensor, slot: torch.Tensor, b: int,
                n_item: int) -> torch.Tensor:
    """[b, n_item] bool: True at (slot of the pair's user, item) for the
    pairs whose user has a slot (>= 0) in the block."""
    s = slot[pairs[:, 0]]
    keep = s >= 0
    out = torch.zeros((b, n_item), dtype=torch.bool, device=pairs.device)
    out[s[keep], pairs[keep, 1]] = True
    return out


def _sums_type(prec: C.Precision) -> torch.dtype:
    return torch.float64 if prec.mode == "ref" else torch.bfloat16


@torch.no_grad()
def metrics_of(tops: torch.Tensor, test: np.ndarray, n_item: int,
               topks: Sequence[int], block: int,
               dtype: torch.dtype = torch.float64) -> Dict[str, list]:
    """{metric: [value at each k]} of the top lists ``tops`` [U, >= max k]
    of the test users in ascending id order, against the test pairs: the
    hits exact, the sums in blocks of ``block`` users, in ``dtype``."""
    dev = tops.device
    test_t = torch.as_tensor(test, device=dev)
    keys = torch.unique(test_t[:, 0] * n_item + test_t[:, 1])
    users, n_test_all = torch.unique(keys // n_item, return_counts=True)
    if users.shape[0] != tops.shape[0]:
        raise ValueError(f"{tops.shape[0]} top lists for {users.shape[0]} "
                         "test users")
    kmax = max(topks)
    disc = (1.0 / torch.log2(torch.arange(2, kmax + 2, device=dev,
                                          dtype=torch.float64))).to(dtype)
    sums = torch.zeros(len(METRICS) * len(topks), dtype=dtype, device=dev)
    for lo in range(0, users.shape[0], block):
        q = users[lo:lo + block, None] * n_item + tops[lo:lo + block, :kmax]
        at = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
        hit = (keys[at] == q).to(dtype)
        n_test = n_test_all[lo:lo + block].to(dtype)
        parts = []
        for k in topks:
            right = hit[:, :k].sum(dim=1)
            ideal = (torch.arange(k, device=dev)[None, :]
                     < torch.clamp(n_test, max=k)[:, None]).to(dtype)
            parts.append((torch.sum(right / n_test), torch.sum(right) / k,
                          torch.sum((right > 0).to(dtype)),
                          torch.sum((hit[:, :k] * disc[:k]).sum(dim=1)
                                    / (ideal * disc[:k]).sum(dim=1))))
        sums += torch.stack([p[j] for j in range(len(METRICS))
                             for p in parts])
    acc = (sums / users.shape[0]).double().tolist()
    nk = len(topks)
    return {name: acc[j * nk:(j + 1) * nk] for j, name in enumerate(METRICS)}


@torch.no_grad()
def evaluate(users: torch.Tensor, items: torch.Tensor, train: np.ndarray,
             test: np.ndarray, topks: Sequence[int], block: int,
             prec: C.Precision) -> Tuple[np.ndarray, Dict[str, list]]:
    """(top ids [U, max k] of the test users in ascending id order,
    {metric: [value at each k]} and {"auc": [mean]}) of the final tables
    ``users`` and ``items``."""
    dev = users.device
    n_item = items.shape[0]
    kmax = max(topks)
    low = _sums_type(prec)
    train_t = torch.as_tensor(train, device=dev)
    test_t = torch.as_tensor(test, device=dev)
    test_users = torch.unique(test_t[:, 0])
    slot = torch.full((users.shape[0],), -1, dtype=torch.int64, device=dev)
    auc_sum = torch.zeros((), dtype=low, device=dev)
    tops = []
    it = C.tf32(items) if prec.mode == "tf32" else items
    for lo in range(0, len(test_users), block):
        u = test_users[lo:lo + block]
        b = len(u)
        slot[u] = torch.arange(b, device=dev)
        seen = _block_mask(train_t, slot, b, n_item)
        truth = _block_mask(test_t, slot, b, n_item)
        slot[u] = -1
        uu = C.tf32(users[u]) if prec.mode == "tf32" else users[u]
        scores = torch.sigmoid(uu @ it.T)
        if prec.mode == "tf32":
            scores = scores.to(torch.bfloat16)
        scores[seen] = MASK_VALUE
        tops.append(torch.topk(scores, kmax, dim=1).indices)
        order = torch.argsort(scores, dim=1, stable=True)
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, torch.arange(1, n_item + 1, device=dev)
                       .expand_as(order))
        n_seen = seen.sum(dim=1).to(low)
        n_test = truth.sum(dim=1).to(low)
        pos_rank = torch.where(truth, ranks.to(low) - n_seen[:, None],
                               torch.zeros((), dtype=low, device=dev))
        auc = ((pos_rank.sum(dim=1) - n_test * (n_test + 1) / 2)
               / (n_test * (n_item - n_seen - n_test)))
        auc_sum += auc.sum()
    top = torch.cat(tops)
    out = metrics_of(top, test, n_item, topks, block, low)
    out["auc"] = [float((auc_sum / len(test_users)).double())]
    return top.cpu().numpy(), out
