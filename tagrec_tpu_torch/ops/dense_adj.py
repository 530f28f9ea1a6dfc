"""Dense-tier selection and the host edge mask (tagrec_tpu/ops/dense_adj.py).

At hetrec scale the [N, N] edge pattern is a 1-byte mask on the device and
the routing kernels recompute every score tile from per-node factors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Auto-dense when the full f32 matrix fits this (tagrec_tpu/ops/ell.py).
DENSE_ADJ_BUDGET_BYTES = 2 << 30


def use_dense(adj_mode: str, n_rows: int, n_cols: int) -> bool:
    """Resolve a ModelConfig.adj_mode against the dense byte budget."""
    if adj_mode in ("dense", "dense_xla"):
        return True
    if adj_mode == "ell":
        return False
    return n_rows * n_cols * 4 <= DENSE_ADJ_BUDGET_BYTES


def dense_mask_host(rows, cols, n_rows: int, n_cols: int) -> np.ndarray:
    """[n_rows, n_cols] bool edge-pattern mask (host, built once)."""
    m = np.zeros((n_rows, n_cols), dtype=bool)
    m[np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)] = True
    return m


def routing_masks(coo, adj_mode: str, device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The dense routing tier's bool edge mask of ``coo`` on ``device``, and
    the contiguous transpose that ``routed_mm``'s backward sweeps: None where
    the host finds the mask symmetric (the mask is then its own transpose,
    with no second buffer).  Raises for the tiers the port has not got."""
    if adj_mode == "ell":
        raise NotImplementedError(
            "adj_mode='ell' needs the EdgeMap tier (ROADMAP.md A17)")
    if adj_mode == "dense_xla":
        raise NotImplementedError(
            "adj_mode='dense_xla' needs the chunked dense tier "
            "(ROADMAP.md A12)")
    if not use_dense(adj_mode, *coo.shape):
        raise NotImplementedError(
            f"a {coo.shape[0]}-node graph is over the dense budget of "
            f"{DENSE_ADJ_BUDGET_BYTES} bytes and needs the EdgeMap tier "
            "(ROADMAP.md A17)")
    mask = dense_mask_host(coo.row, coo.col, *coo.shape)
    mask_t = None
    if not np.array_equal(mask, mask.T):
        mask_t = torch.from_numpy(np.ascontiguousarray(mask.T)).to(device)
    return torch.from_numpy(mask).to(device), mask_t
