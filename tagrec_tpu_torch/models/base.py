"""Shared model utilities: initializers, embedding splits, prediction
(tagrec_tpu/models/base.py)."""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from tagrec_tpu_torch.ops.losses import bpr_loss, l2reg_loss


def _fan_in_out(shape: Sequence[int]):
    """torch.nn.init._calculate_fan_in_and_fan_out semantics: for an
    N-d tensor, receptive = prod(shape[2:]), fan_in = shape[1]*receptive,
    fan_out = shape[0]*receptive."""
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
    fan_out = shape[0] * receptive
    return fan_in, fan_out


def xavier_uniform(shape: Sequence[int], generator: torch.Generator,
                   device) -> torch.Tensor:
    """Xavier/Glorot uniform matching torch.nn.init.xavier_uniform_.  Drawn
    on the CPU from ``generator``, then moved, so one seed gives the same
    weights on every device."""
    fan_in, fan_out = _fan_in_out(shape)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(tuple(shape), dtype=torch.float32)
    w.uniform_(-a, a, generator=generator)
    return w.to(device)


def init_embeddings(num_list: Sequence[int], dim: int,
                    generator: torch.Generator, device) -> List[torch.Tensor]:
    return [xavier_uniform((n, dim), generator, device) for n in num_list]


def split_nodes(x: torch.Tensor, num_list: Sequence[int]):
    """Split a stacked [sum(num_list), D] node matrix back into per-type
    parts."""
    return tuple(torch.split(x, list(num_list), dim=0))


def predict_sigmoid(user_emb_sel: torch.Tensor,
                    item_emb: torch.Tensor) -> torch.Tensor:
    """sigmoid(U_sel @ I^T) — the shared predict_rating surface."""
    return torch.sigmoid(user_emb_sel @ item_emb.T)


def bpr_with_reg(u_all, i_all, u_reg_src, i_reg_src, batch, loss_kind: str,
                 reg: float):
    """BPR on the propagated tables plus ``reg`` times the L2 term on the
    given regularization source, for a [B, 3] (user, pos, neg) batch ->
    (loss, reg term)."""
    users, pos, neg = batch[:, 0], batch[:, 1], batch[:, 2]
    loss = bpr_loss(u_all[users], i_all[pos], i_all[neg], loss_kind)
    return loss, reg * l2reg_loss(u_reg_src[users], i_reg_src[pos],
                                  i_reg_src[neg])
