"""Loss functions (tagrec_tpu/ops/losses.py), cut to what the ported slices
use: the pairwise BPR loss, the batch-mean L2 term and KGAT's squared-norm
TransE loss."""

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


def transe_loss_sq(head_e, rela_e, pos_tail_e, neg_tail_e) -> torch.Tensor:
    """KGAT's squared-norm TransE: mean(softplus(|h + r - t+|^2 -
    |h + r - t-|^2))."""
    pos = torch.sum(torch.square(head_e + rela_e - pos_tail_e), dim=1)
    neg = torch.sum(torch.square(head_e + rela_e - neg_tail_e), dim=1)
    return torch.mean(F.softplus(pos - neg))
