"""Graph propagation over the ELL and dense formats of ``ops.ell``
(tagrec_tpu/ops/propagate.py).

``adj_mm`` is the SpMM of every constant-adjacency model: per degree bucket
one ``gather_reduce`` (kernel), the buckets' rows put back in order by one
``gather_rows`` (kernel), and one ``torch.matmul`` for a dense block (the
hub columns, or the whole adjacency at small scale).  ``pair_spmm``
differentiates it without a scatter: the gradient of A @ x is A^T @ g, the
same SpMM over the transpose tables.  ``coo_spmm`` is the oracle.
"""

from __future__ import annotations

import torch

from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.dma_gather import gather_reduce, gather_rows


def coo_spmm(row, col, val, x, n_rows: int) -> torch.Tensor:
    """Oracle SpMM: out[r] = sum over edges e of row r of val[e] * x[col[e]]."""
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, row.long(), x[col.long()] * val[:, None])


def ell_mm(ell: ell_lib.Ell, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: out[n] = sum_k val[n, k] * x[idx[n, k]] over the row's
    deg[n] edges (the pad slots after them are not read).  Forward only."""
    return gather_reduce(x, ell.idx, ell.val, ell.deg)


def ell_buckets_mm(eb: ell_lib.EllBuckets, x: torch.Tensor) -> torch.Tensor:
    """Bucketed ELL SpMM: one gather-reduce per bucket, then one row gather
    to restore row order.  Forward only."""
    outs = torch.cat([ell_mm(p, x) for p in eb.parts])
    return gather_rows(outs, eb.inv_perm)


def dense_sectors_mm(ds: ell_lib.DenseSectors, x: torch.Tensor) -> torch.Tensor:
    """Sector-blocked dense SpMM: one matmul per nonzero sector block."""
    xs = torch.split(x, list(ds.sizes))
    outs = [None] * len(ds.sizes)
    for b, (ri, ci) in zip(ds.blocks, ds.coords):
        y = b @ xs[ci]
        outs[ri] = y if outs[ri] is None else outs[ri] + y
    return torch.cat([o if o is not None else x.new_zeros((s, x.shape[1]))
                      for o, s in zip(outs, ds.sizes)])


def hybrid_mm(h, x: torch.Tensor) -> torch.Tensor:
    """Hybrid SpMM: the ELL tail plus the hub block times the hub columns'
    rows; a block with no hub columns is the whole adjacency.  Also takes
    the sector-blocked dense form."""
    if isinstance(h, ell_lib.DenseSectors):
        return dense_sectors_mm(h, x)
    if h.dense_block is not None and h.dense_cols is None:
        return h.dense_block @ x
    out = ell_buckets_mm(h.ell, x)
    if h.dense_block is not None:
        out = out + h.dense_block @ gather_rows(x, h.dense_cols)
    return out


class _PairSpmm(torch.autograd.Function):
    """A @ x over ``fwd``; its gradient A^T @ g over ``bwd``.  The adjacency
    is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return hybrid_mm(fwd, x)

    @staticmethod
    def backward(ctx, g):
        return hybrid_mm(ctx.bwd, g.contiguous()), None, None


def pair_spmm(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """SpMM with a scatter-free backward: ``fwd`` aggregates, its transpose
    ``bwd`` carries the gradient."""
    return _PairSpmm.apply(x.contiguous(), fwd, bwd)


def adj_mm(adj, x: torch.Tensor) -> torch.Tensor:
    """Propagate with an AdjPair (differentiable), or forward only with a
    Hybrid, DenseSectors, EllBuckets or Ell."""
    if isinstance(adj, ell_lib.AdjPair):
        return pair_spmm(x, adj.fwd, adj.bwd)
    if isinstance(adj, (ell_lib.Hybrid, ell_lib.DenseSectors)):
        return hybrid_mm(adj, x)
    if isinstance(adj, ell_lib.EllBuckets):
        return ell_buckets_mm(adj, x)
    return ell_mm(adj, x)


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
