"""Propagation helpers (tagrec_tpu/ops/propagate.py); the ported slices need
the L2 normalize and message dropout."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Row L2 normalize matching torch.nn.functional.normalize (clamp-min eps),
    through a clamped squared norm so an all-zero row stays finite (and its
    gradient is 0, not NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def message_dropout(x: torch.Tensor, rate: float,
                    generator: torch.Generator, training: bool) -> torch.Tensor:
    """Inverted dropout (torch.nn.functional.dropout semantics), its mask
    drawn from ``generator``, which lies on ``x``'s device."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
