"""Graph propagation over the ELL and dense formats of ``ops.ell``
(tagrec_tpu/ops/propagate.py).

``adj_mm`` is the SpMM of every constant-adjacency model: per degree bucket
one ``gather_reduce`` (kernel), the buckets' rows put back in order by one
``gather_rows`` (kernel), and one matmul for a dense block (the hub
columns, or the whole adjacency at small scale; a bfloat16 block takes x
rounded to bfloat16 and returns the float32 sums, as JAX's
``preferred_element_type=float32``).  ``pair_spmm`` differentiates it
without a scatter: the gradient of A @ x is A^T @ g, the same SpMM over the
transpose tables.  An adjacency with no transpose, such as the one
``edge_dropout`` returns, is differentiated by ``transpose_mm``: the
scatter-add of JAX's autodiff (a deterministic accumulate over the ELL
slots, the hub block's transpose product into the hub columns).  ``coo_spmm`` is the
oracle.
"""

from __future__ import annotations

import torch

from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.dma_gather import (GATHER_BUDGET_BYTES,
                                             gather_reduce, gather_rows)


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


def block_mm(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """b @ x for a dense adjacency block.  A bfloat16 block times x rounded
    to bfloat16, accumulated and returned in float32: on the card one
    ``torch.mm(..., out_dtype=float32)``; on the CPU, which has no kernel
    for it, the same product of the operands widened to float32 (exact:
    a product of two bfloat16 values fits a float32)."""
    if b.dtype != torch.bfloat16:
        return b @ x
    xb = x.to(torch.bfloat16)
    if b.is_cuda:
        return torch.mm(b, xb, out_dtype=torch.float32)
    return b.float() @ xb.float()


def block_t_mm(b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """b^T @ g as JAX's autodiff transposes ``block_mm``: for a bfloat16
    block the float32 product of b and g, rounded to bfloat16 (the dtype of
    the product's bfloat16 operand), then widened back."""
    if b.dtype != torch.bfloat16:
        return b.t() @ g
    return (b.t().float() @ g).to(torch.bfloat16).float()


def dense_sectors_mm(ds: ell_lib.DenseSectors, x: torch.Tensor) -> torch.Tensor:
    """Sector-blocked dense SpMM: one matmul per nonzero sector block."""
    xs = torch.split(x, list(ds.sizes))
    outs = [None] * len(ds.sizes)
    for b, (ri, ci) in zip(ds.blocks, ds.coords):
        y = block_mm(b, xs[ci])
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
        return block_mm(h.dense_block, x)
    out = ell_buckets_mm(h.ell, x)
    if h.dense_block is not None:
        out = out + h.dense_block @ gather_rows(x, h.dense_cols)
    return out


def ell_mm_t(ell: ell_lib.Ell, g: torch.Tensor, n_cols: int,
             budget: int = GATHER_BUDGET_BYTES) -> torch.Tensor:
    """A^T @ g for one ELL table: each real slot (k < deg[n]) adds
    val[n, k] * g[n] into row idx[n, k] of the [n_cols, D] result, over
    chunks of the real slots (``ell.live``, found once on the host) whose
    [slots, D] terms fit ``budget``, in row-major order.  Its shapes are
    fixed when the table is built and it reads nothing back to the host,
    so a CUDA graph can hold it.

    The sum is deterministic on both devices: ``index_add_`` on the CPU;
    on the card, whose ``index_add_`` adds floats atomically in no fixed
    order, ``index_put_(accumulate=True)``, which sorts the target rows
    and sums each row's terms in slot order, so two runs and a replayed
    graph agree bit for bit."""
    k = ell.idx.shape[1]
    d = g.shape[1]
    out = g.new_zeros((n_cols, d))
    chunk = max(budget // max(d * g.element_size(), 1), 1)
    idx, val = ell.idx.reshape(-1), ell.val.reshape(-1)
    for i in range(0, ell.live.shape[0], chunk):
        live = ell.live[i:i + chunk]
        rows = torch.div(live, k, rounding_mode="floor")
        dest = idx.index_select(0, live).long()
        terms = val.index_select(0, live)[:, None] * g.index_select(0, rows)
        if out.is_cuda:
            out.index_put_((dest,), terms, accumulate=True)
        else:
            out.index_add_(0, dest, terms)
    return out


def transpose_mm(h, g: torch.Tensor, n_cols: int) -> torch.Tensor:
    """A^T @ g for any one adjacency form (Hybrid, DenseSectors,
    EllBuckets, Ell) with ``n_cols`` columns: the backward of
    ``hybrid_mm``, as JAX's autodiff computes it (a scatter-add over the
    ELL slots; the dense blocks' transpose products, ``block_t_mm``)."""
    if isinstance(h, ell_lib.DenseSectors):
        gs = torch.split(g, list(h.sizes))
        outs = [None] * len(h.sizes)
        for b, (ri, ci) in zip(h.blocks, h.coords):
            y = block_t_mm(b, gs[ri])
            outs[ci] = y if outs[ci] is None else outs[ci] + y
        return torch.cat([o if o is not None else g.new_zeros((s, g.shape[1]))
                          for o, s in zip(outs, h.sizes)])
    if isinstance(h, ell_lib.Hybrid):
        if h.dense_block is not None and h.dense_cols is None:
            return block_t_mm(h.dense_block, g)
        out = transpose_mm(h.ell, g, n_cols)
        if h.dense_block is not None:
            out.index_add_(0, h.dense_cols.long(), h.dense_block.t() @ g)
        return out
    if isinstance(h, ell_lib.EllBuckets):
        if not h.parts:
            return g.new_zeros((n_cols, g.shape[1]))
        # the buckets' rows in concatenated order: row r sits at inv_perm[r]
        g_cat = torch.empty_like(g)
        g_cat[h.inv_perm.long()] = g
        out, start = None, 0
        for p in h.parts:
            rows = p.idx.shape[0]
            y = ell_mm_t(p, g_cat[start:start + rows], n_cols)
            out = y if out is None else out + y
            start += rows
        return out
    return ell_mm_t(h, g, n_cols)


class _AdjSpmm(torch.autograd.Function):
    """A @ x over one adjacency form; its gradient A^T @ g by
    ``transpose_mm``.  The adjacency is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.n = adj, x.shape[0]
        if isinstance(adj, ell_lib.EllBuckets):
            return ell_buckets_mm(adj, x)
        if isinstance(adj, ell_lib.Ell):
            return ell_mm(adj, x)
        return hybrid_mm(adj, x)

    @staticmethod
    def backward(ctx, g):
        return transpose_mm(ctx.adj, g.contiguous(), ctx.n), None


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
    """Propagate with an AdjPair (its gradient over the transpose tables),
    or with a Hybrid, DenseSectors, EllBuckets or Ell (its gradient by
    ``transpose_mm``)."""
    if isinstance(adj, ell_lib.AdjPair):
        return pair_spmm(x, adj.fwd, adj.bwd)
    return _AdjSpmm.apply(x.contiguous(), adj)


def ell_softmax(ell: ell_lib.Ell, scores: torch.Tensor) -> torch.Tensor:
    """Row softmax over an ELL table's slots, the dense form of
    ``torch.sparse.softmax(adj, dim=1)``: ``scores`` [N, K] per-slot
    logits; the pad slots get 0 and a row with no edge is all zero."""
    mask = ell_lib.ell_mask(ell)
    masked = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    m = torch.max(masked, dim=1, keepdim=True).values
    e = torch.exp(masked - m.detach()) * mask
    s = torch.sum(e, dim=1, keepdim=True)
    return e / torch.where(s == 0, 1.0, s)


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


def _drop(v: torch.Tensor, keep: float, generator) -> torch.Tensor:
    """v * floor(u + keep) / keep, u uniform on [0, 1) from ``generator``:
    each value kept with probability ``keep`` and scaled by 1 / keep; a
    zero stays zero."""
    u = torch.rand(v.shape, generator=generator, device=v.device)
    return v * torch.floor(u + keep).to(v.dtype) / keep


def edge_dropout(adj, rate: float, generator: torch.Generator,
                 training: bool):
    """Edge dropout (the reference's ``node_drop``): each stored edge value
    dropped with probability ``rate``, the survivors scaled by 1 / (1 -
    rate), the masks drawn from ``generator`` (on the adjacency's device).
    Takes an Ell, EllBuckets, Hybrid (its ELL slots and every hub-block
    cell), DenseSectors or AdjPair.  A dropped AdjPair is its dropped
    forward form, with no transpose tables, as in JAX: ``adj_mm``
    differentiates it by ``transpose_mm``."""
    if not training or rate == 0.0:
        return adj
    keep = 1.0 - rate
    if isinstance(adj, ell_lib.AdjPair):
        return edge_dropout(adj.fwd, rate, generator, training)
    if isinstance(adj, ell_lib.DenseSectors):
        return ell_lib.DenseSectors(
            blocks=tuple(_drop(b, keep, generator) for b in adj.blocks),
            coords=adj.coords, sizes=adj.sizes)
    if isinstance(adj, ell_lib.Hybrid):
        return ell_lib.Hybrid(
            ell=edge_dropout(adj.ell, rate, generator, training),
            dense_cols=adj.dense_cols,
            dense_block=None if adj.dense_block is None
            else _drop(adj.dense_block, keep, generator))
    if isinstance(adj, ell_lib.EllBuckets):
        return ell_lib.EllBuckets(
            parts=tuple(edge_dropout(p, rate, generator, training)
                        for p in adj.parts),
            inv_perm=adj.inv_perm)
    return adj._replace(val=_drop(adj.val, keep, generator))
