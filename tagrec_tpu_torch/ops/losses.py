"""Loss functions (tagrec_tpu/ops/losses.py), cut to what the ported slices
use: the pairwise BPR loss, the batch-mean L2 term, TGCN's TransTag
margin loss, KGAT's squared-norm TransE loss and DGCF's
distance-correlation loss.  JAX's ``transe_loss`` (L2-distance softplus)
has no caller in either package and is left out."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bpr_loss(users_emb: torch.Tensor, pos_emb: torch.Tensor,
             neg_emb: torch.Tensor, kind: str = "softplus") -> torch.Tensor:
    """Pairwise BPR loss: ``-mean(logsigmoid(pos - neg))`` for
    kind='logsigmoid', else ``mean(softplus(neg - pos))`` (equal
    algebraically; both kept for config parity)."""
    pos = torch.sum(users_emb * pos_emb, dim=1)
    neg = torch.sum(users_emb * neg_emb, dim=1)
    if kind == "logsigmoid":
        return -torch.mean(F.logsigmoid(pos - neg))
    return torch.mean(F.softplus(neg - pos))


def l2reg_loss(*embs: torch.Tensor) -> torch.Tensor:
    """0.5 * sum_i ||E_i||_F^2 / batch."""
    total = sum(torch.sum(e * e) for e in embs)
    return 0.5 * total / embs[0].shape[0]


def transtag_loss(head_e, rela_e, pos_tail_e, neg_tail_e,
                  margin: float = 0.0) -> torch.Tensor:
    """TGCN's TransTag hinge on translation distances:
    mean(relu(margin + |h + r - t+| - |h + r - t-|))."""
    pos = torch.linalg.vector_norm(head_e + rela_e - pos_tail_e, dim=1)
    neg = torch.linalg.vector_norm(head_e + rela_e - neg_tail_e, dim=1)
    return torch.mean(torch.relu(margin + pos - neg))


def transe_loss_sq(head_e, rela_e, pos_tail_e, neg_tail_e) -> torch.Tensor:
    """KGAT's squared-norm TransE: mean(softplus(|h + r - t+|^2 -
    |h + r - t-|^2))."""
    pos = torch.sum(torch.square(head_e + rela_e - pos_tail_e), dim=1)
    neg = torch.sum(torch.square(head_e + rela_e - neg_tail_e), dim=1)
    return torch.mean(F.softplus(pos - neg))


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with JAX's gradient at a tie (half to each side), which
    ``torch.clamp`` would give whole: the distance matrix's diagonal sits
    at 0 exactly."""
    return torch.maximum(x, x.new_zeros(()))


def cor_loss(factor_embs, factor_k: int) -> torch.Tensor:
    """Distance correlation between neighbouring factor chunks [B, dk],
    summed over the factor_k - 1 pairs and divided by (k + 1) k / 2, with
    JAX's 1e-8 and 1e-10 guards."""

    def centered_distance(x):
        r = torch.sum(x * x, dim=1, keepdim=True)
        d = torch.sqrt(_relu0(r - 2 * x @ x.T + r.T) + 1e-8)
        return (d - torch.mean(d, dim=0, keepdim=True)
                - torch.mean(d, dim=1, keepdim=True) + torch.mean(d))

    def distance_covariance(d1, d2):
        n = d1.shape[0]
        return torch.sqrt(_relu0(torch.sum(d1 * d2) / (n * n)) + 1e-8)

    def distance_correlation(x, y):
        d1, d2 = centered_distance(x), centered_distance(y)
        dxy = distance_covariance(d1, d2)
        dxx = distance_covariance(d1, d1)
        dyy = distance_covariance(d2, d2)
        return dxy / (torch.sqrt(_relu0(dxx * dyy)) + 1e-10)

    loss = 0.0
    for i in range(factor_k - 1):
        loss = loss + distance_correlation(factor_embs[i], factor_embs[i + 1])
    return loss / ((factor_k + 1.0) * factor_k / 2.0)
