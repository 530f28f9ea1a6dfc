"""Dense attention tiers (tagrec_tpu/ops/dense_adj.py).

At hetrec scale the [N, N] edge pattern is a 1-byte mask on the device.
The routing and flash kernels recompute every score tile from per-node
factors.  The chunked dense tier (``adj_mode="dense_xla"``) computes the
same propagation in plain PyTorch instead: each function below runs over
row chunks of JAX's sizes, materialises one chunk's [chunk, N] scores at a
time, and recomputes each chunk in the backward (``torch.utils.checkpoint``
per chunk, JAX's ``jax.checkpoint`` under ``lax.map``) instead of saving
it.  It is a tier the caller names, never a fallback, and it is the
kernels' second, independent computation at full size.  KGAT over a
knowledge graph has no kernel tier: its relation-dense tier
(``rel_dense_row_softmax_scores``) is the same chunked form, with the
relation of each cell read from an int8 matrix.

Under a mesh the kernel tiers' masks (DGCF's and DisenGCN's ``mask``,
KGAT's flash masks, and the port's transposes of them) hold one
``model`` rank's rows, cut on the host before the upload by JAX's
``gdev_sharding`` rule (``mask_block``, ``cut_mask``; on the device a
``MaskShard``): every edge sweep reads one mask row a result row, so a
rank's rows are all its rows of a result need, and the sweep's wrapper
all-gathers the result once (``sweep_gathered``, from
``ops.flash_routing`` and ``ops.flash_attention``).  The chunked tiers'
tables (the ``dense_xla`` mask, DisenHAN's six relation masks, the KG's
``rel_id``) are cut by the same rule, and each chunked function takes
a ``MaskShard`` too: it runs the chunks that hold the rank's rows,
reads the inputs indexed by row at their global rows, and returns the
rank's block of rows, which the model makes whole by one all-gather
(``propagate.RankRows``).  Its chunks are JAX's: a fixed row count,
the last padded, at the multiples of the chunk from the first row (of a
segment, on the KG), so a rank's rows get one device's products and
bits; ``rows_mm`` takes the product with the attention matrix P in the
same blocks.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.propagate import gathered_blocks

# Auto-dense when the full f32 matrix fits this (tagrec_tpu/ops/ell.py).
DENSE_ADJ_BUDGET_BYTES = 2 << 30
NEG = -1e30
# JAX's row chunks: the chunked tier's, the relation-dense tier's
CHUNK, REL_CHUNK = 1024, 512


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


class MaskShard(NamedTuple):
    """One ``model`` rank's rows of a mask on the device: rows [start,
    stop) of the whole ``rows``, the i-th of ``model`` even blocks.  The
    edge sweeps take it in place of the mask, run over these rows and
    all-gather their results over ``mesh``'s ``model`` axis."""

    local: torch.Tensor  # rows [start, stop) of the mask
    start: int
    stop: int
    rows: int            # the whole mask's rows
    mesh: object         # the parallel.Mesh


def sweep_gathered(mask: MaskShard, like: torch.Tensor, parts, fill) -> list:
    """``fill(local, row0, *outs)`` over the rank's rows of ``mask``: each
    result ([*lead, R, *tail] for each (lead, tail) of ``parts``) written
    into the rank's part of one send buffer of ``like``'s dtype, and all
    of them all-gathered whole over ``model`` at once
    (``propagate.gathered_blocks``)."""
    rows = mask.stop - mask.start
    return gathered_blocks(mask.mesh, like,
                           [(lead, rows, tail) for lead, tail in parts],
                           lambda *o: fill(mask.local, mask.start, *o))


def sweep_rows(mask):
    """(the rows a sweep reads, the first one's row) of a mask or a
    MaskShard."""
    if isinstance(mask, MaskShard):
        return mask.local, mask.start
    return mask, 0


def mask_block(n_rows: int, mesh):
    """(start, stop) of ``mesh``'s rank's rows of a mask of ``n_rows``
    rows where JAX's rule row-shards it (64 rows or more, dividing by
    ``model``), else None (whole on every rank, as without a mesh)."""
    if mesh is None:
        return None
    m, i = mesh.shape["model"], mesh.index("model")
    if not ell_lib.row_sharded(n_rows, m):
        return None
    return i * (n_rows // m), (i + 1) * (n_rows // m)


def cut_mask(host: np.ndarray, block, transpose: bool = False) -> np.ndarray:
    """Rows ``block`` of ``host`` (of its transpose when ``transpose``),
    contiguous, cut on the host without building the whole transpose."""
    if transpose:
        part = host if block is None else host[:, block[0]:block[1]]
        return np.ascontiguousarray(part.T)
    return np.ascontiguousarray(ell_lib.cut_rows(host, block))


def _row_map(fn, start: int, stop: int, chunk: int, *, base: int = 0,
             dim: int = 0, remat: bool = True):
    """fn over the row chunks that hold rows [start, stop): chunks of
    ``chunk`` rows at ``base`` + k * ``chunk``, as one device chunks all
    the rows from ``base``.  ``fn(c0, lo, hi)`` computes chunk [c0, c0 +
    chunk), whose real rows are [lo, hi) (the rest padded: ``_rows``),
    and returns its result, rows on ``dim``, which is cut to [lo, hi).
    Every chunk has one shape and holds a row at one place, on one device
    and on a ``model`` rank holding any block of the rows, so a library
    product's kernel and its order of sums are one device's and the row
    gets one device's bits.  Each chunk is recomputed in the backward
    rather than saved (``remat``); no chunk draws a random number, so the
    recompute needs no RNG state stashed (reading it would break a CUDA
    graph's capture), and none runs a collective (a recompute would run it
    again, out of step with the other ranks)."""
    outs = []
    for c0 in range(base + (start - base) // chunk * chunk, stop, chunk):
        lo, hi = max(c0, start), min(c0 + chunk, stop)
        out = (checkpoint(fn, c0, lo, hi, use_reentrant=False,
                          preserve_rng_state=False) if remat
               else fn(c0, lo, hi))
        outs.append(out if hi - lo == chunk
                    else out.narrow(dim, lo - c0, hi - lo))
    return outs


def _rows(t: torch.Tensor, c0: int, lo: int, hi: int, chunk: int,
          dim: int = 0, first: int = 0, value=0) -> torch.Tensor:
    """Chunk [c0, c0 + chunk) of ``t``'s rows on ``dim``: its rows [lo,
    hi) (``t`` holding rows from ``first`` on), padded with ``value``
    before and after, as JAX pads its last chunk."""
    part = t.narrow(dim, lo - first, hi - lo)
    if hi - lo == chunk:
        return part
    return F.pad(part, [0, 0] * (t.dim() - 1 - dim) + [lo - c0,
                                                       c0 + chunk - hi],
                 value=value)


class _RowsMm(torch.autograd.Function):
    """p @ x over blocks of ``chunk`` rows (``rows_mm``); the backward
    is the plain product's, two products (g @ x^T, p^T @ g): the blocks'
    own backward would build a zero-filled gradient of the whole p for
    each block."""

    @staticmethod
    def forward(ctx, p, x, chunk, row0):
        ctx.save_for_backward(p, x)

        def f(c0, lo, hi):
            return _rows(p, c0, lo, hi, chunk, first=row0) @ x

        return torch.cat(_row_map(f, row0, row0 + p.shape[0], chunk,
                                  remat=False))

    @staticmethod
    def backward(ctx, g):
        p, x = ctx.saved_tensors
        return (g @ x.T if ctx.needs_input_grad[0] else None,
                p.T @ g if ctx.needs_input_grad[1] else None, None, None)


def rows_mm(p: torch.Tensor, x: torch.Tensor, chunk: int,
            row0: int = 0) -> torch.Tensor:
    """p @ x for ``p`` the rows [row0, row0 + len(p)) of a matrix, over
    blocks of ``chunk`` of its rows at the multiples of ``chunk``
    (``_row_map``): one device's products, however many rows ``p``
    holds.  Differentiable in p and x."""
    return _RowsMm.apply(p, x, chunk, row0)


def masked_row_softmax(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``s`` over masked entries; 0 where the mask is False
    and on all-masked rows (torch.sparse.softmax on the dense pattern)."""
    s = torch.where(m, s, NEG)
    mx = torch.max(s, dim=-1, keepdim=True).values.detach()
    e = torch.exp(s - torch.clamp(mx, min=NEG)) * m
    z = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.where(z == 0, 1.0, z)


# --------------------------------------------------------------------- KGAT

def sector_stack(q: torch.Tensor, k: torch.Tensor,
                 segs: Sequence[Tuple[int, int]],
                 rel_of: Sequence[Sequence[int]]):
    """Fold per-relation score tables into one score-feature pair.

    q, k: [R, N, dq] head and tail projections per relation; ``segs``
    [(start, length)] the node-type segments (rows sorted by type);
    ``rel_of[a][c]`` the relation of (row type a -> column type c), or -1.
    Returns qhat, khat [N, P * dq], one plane per valid (a, c), such that
    ``qhat @ khat.T`` holds q[r_ac, n] . k[r_ac, m] in each sector."""
    n = q.shape[1]
    planes = [(a, c) for a in range(len(segs)) for c in range(len(segs))
              if rel_of[a][c] >= 0]

    def plane(table, r, seg):
        start, length = seg
        return F.pad(table[r, start:start + length],
                     (0, 0, start, n - start - length))

    qhat = torch.cat([plane(q, rel_of[a][c], segs[a]) for a, c in planes], 1)
    khat = torch.cat([plane(k, rel_of[a][c], segs[c]) for a, c in planes], 1)
    return qhat, khat


def dense_row_softmax_scores(qhat: torch.Tensor, khat: torch.Tensor,
                             mask, chunk: int = CHUNK) -> torch.Tensor:
    """P [N, M] = masked row softmax of qhat @ khat^T, chunked over rows;
    differentiable in qhat and khat.  ``mask`` a MaskShard: the rank's
    rows of P, qhat read at their global rows."""
    local, row0 = sweep_rows(mask)

    def f(c0, lo, hi):
        return masked_row_softmax(
            _rows(qhat, c0, lo, hi, chunk) @ khat.T,
            _rows(local, c0, lo, hi, chunk, first=row0))

    return torch.cat(_row_map(f, row0, row0 + local.shape[0], chunk))


# ------------------------------------------------------------ KGAT, true KG
# The relation is per edge, not fixed by the sector as on the tag graph: an
# int8 matrix holds each cell's relation id, and each row chunk selects its
# scores from R per-relation score planes (R matmuls and R selects, on
# cuBLAS).

def rel_id_host(rows, cols, rels, n_rows: int, n_cols: int):
    """[n_rows, n_cols] int8 relation-id matrix (-1 = no edge), or ``None``
    when the edge set cannot be dense: parallel edges (one (h, t) pair under
    several relations) cannot share a cell, and int8 caps the relations at
    127."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    rels = np.asarray(rels, dtype=np.int64)
    if rels.size and int(rels.max()) > 127:
        return None
    key = rows * n_cols + cols
    if len(np.unique(key)) != len(key):
        return None
    m = np.full((n_rows, n_cols), -1, dtype=np.int8)
    m[rows, cols] = rels.astype(np.int8)
    return m


def rel_dense_row_softmax_scores(q: torch.Tensor, k: torch.Tensor,
                                 rel_id, chunk: int = REL_CHUNK,
                                 score_dtype=torch.float32,
                                 row_segments=None) -> torch.Tensor:
    """P [N, M] = masked row softmax of S, S[h, t] = q[r, h] . k[r, t] with
    r = rel_id[h, t] (int8, -1 = no edge); q, k: [R, N, dq] and [R, M, dq].

    Each row chunk accumulates ``where(rel_id == r, q_r @ k_r^T, s)`` over
    its segment's relations, then the softmax runs in float32 (or wider).
    Differentiable in q and k (the attention is not detached); each chunk
    is recomputed in the backward.  ``row_segments``: optional
    ((start, length, rels), ...) tiling [0, N) in order, each row range
    with the relations that occur on its rows (KGAT's user rows carry
    relation 0 only); each segment is chunked from its start, as JAX
    chunks it, its last chunk padded with relation id -1.
    ``score_dtype=torch.bfloat16`` runs the score planes and the select
    chain in bf16.  ``rel_id`` a MaskShard: the rank's rows of P, each
    segment's chunks over its rows within the rank's block."""
    r_, n, _ = q.shape
    m = k.shape[1]
    local, row0 = sweep_rows(rel_id)
    stop = row0 + local.shape[0]
    if row_segments is None:
        row_segments = ((0, n, tuple(range(r_))),)
    q = q.to(score_dtype)
    kt = [k[r].T.to(score_dtype) for r in range(r_)]
    soft_dtype = torch.promote_types(score_dtype, torch.float32)

    parts = []
    for start, length, rels in row_segments:
        def f(c0, lo, hi, rels=rels):
            rc = _rows(local, c0, lo, hi, chunk, first=row0, value=-1)
            s = torch.zeros((chunk, m), dtype=score_dtype, device=q.device)
            for r in rels:  # only this segment's planes
                s = torch.where(rc == r,
                                _rows(q[r], c0, lo, hi, chunk) @ kt[r], s)
            return masked_row_softmax(s.to(soft_dtype), rc >= 0)

        lo, hi = max(start, row0), min(start + length, stop)
        if lo < hi:
            parts += _row_map(f, lo, hi, chunk, base=start)
    return torch.cat(parts)


# ----------------------------------------------------------------- DisenGCN

def routed_agg_dense(head: torch.Tensor, tail: torch.Tensor, mask,
                     chunk: int = CHUNK) -> torch.Tensor:
    """agg[f] = (detach(softmax_F(head_f @ tail_f^T)) * mask) @ tail_f.

    head, tail: [F, N, dk]; mask [N, N] bool.  The routing weights are
    detached, so the gradient reaches ``tail`` through the product only.
    ``mask`` a MaskShard: the rank's rows [F, R, dk], head read at their
    global rows."""
    local, row0 = sweep_rows(mask)

    def f(c0, lo, hi):
        s = torch.einsum("fcd,fnd->fcn", _rows(head, c0, lo, hi, chunk, 1),
                         tail)
        p = torch.softmax(s, dim=0).detach() * _rows(
            local, c0, lo, hi, chunk, first=row0)[None]
        return torch.einsum("fcn,fnd->fcd", p, tail)

    return torch.cat(_row_map(f, row0, row0 + local.shape[0], chunk, dim=1),
                     dim=1)


# --------------------------------------------------------------------- DGCF
# The score table is the low-rank series S = 1 + sum_t U_t V_t^T per factor,
# so a chunk's scores are recomputed from the update factors concatenated to
# [F, N, r] (sum_t U_t V_t^T = cat(U) cat(V)^T), the routing kernels' layout.
# The routed adjacency is detached, so u and v get no gradient.

def _dgcf_scores(uc, v, mc):
    """A [F, C, N] = softmax_F(1 + uc @ v^T) * mask."""
    s = 1.0 + torch.einsum("fcr,fnr->fcn", uc, v)
    return torch.softmax(s, dim=0) * mc[None]


def dgcf_dense_degree(u: torch.Tensor, v: torch.Tensor, mask,
                      chunk: int = CHUNK) -> torch.Tensor:
    """Row sums d[f, n] of the routed adjacency A_f; no gradient.
    ``mask`` a MaskShard: the rank's rows [F, R]."""
    u, v = u.detach(), v.detach()
    local, row0 = sweep_rows(mask)

    def f(c0, lo, hi):
        return _dgcf_scores(_rows(u, c0, lo, hi, chunk, 1), v, _rows(
            local, c0, lo, hi, chunk, first=row0)).sum(-1)

    with torch.no_grad():
        outs = _row_map(f, row0, row0 + local.shape[0], chunk, dim=1,
                        remat=False)
    return torch.cat(outs, dim=1)


def dgcf_dense_prop(u: torch.Tensor, v: torch.Tensor, mask,
                    x: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """A @ x per factor with A = softmax_F(S) * mask (detached): x
    [F, N, dx], differentiated.  ``mask`` a MaskShard: the rank's rows
    [F, R, dx]."""
    u, v = u.detach(), v.detach()
    local, row0 = sweep_rows(mask)

    def f(c0, lo, hi):
        return torch.einsum("fcn,fnd->fcd", _dgcf_scores(
            _rows(u, c0, lo, hi, chunk, 1), v,
            _rows(local, c0, lo, hi, chunk, first=row0)), x)

    return torch.cat(_row_map(f, row0, row0 + local.shape[0], chunk, dim=1),
                     dim=1)


# ----------------------------------------------------------------- DisenHAN

def disenhan_dense_rela(hs: torch.Tensor, ts: torch.Tensor,
                        r_src: torch.Tensor, old_dst: torch.Tensor,
                        mask, chunk: int = CHUNK) -> torch.Tensor:
    """One relation's attention aggregation on its rectangular block.

    hs [F, Ns], ts [F, Nd]: the separable head and tail score terms;
    r_src [F, Ns] the relation-factor distribution; old_dst [F, Nd, dk];
    mask [Ns, Nd].  Scores e = sum_f relu(hs + ts) * r, row-softmaxed over
    the mask, fully differentiable.  Returns zk [F, Ns, dk]; ``mask`` a
    MaskShard: the rank's source rows [F, R, dk], hs and r_src read at
    their global rows."""
    local, row0 = sweep_rows(mask)

    def f(c0, lo, hi):
        e = torch.relu(_rows(hs, c0, lo, hi, chunk, 1)[:, :, None]
                       + ts[:, None, :])                         # [F, C, Nd]
        er = torch.sum(e * _rows(r_src, c0, lo, hi, chunk, 1)[:, :, None],
                       dim=0)                                    # [C, Nd]
        p = masked_row_softmax(er, _rows(local, c0, lo, hi, chunk,
                                         first=row0))
        return torch.einsum("cn,fnd->fcd", p, old_dst)

    return torch.cat(_row_map(f, row0, row0 + local.shape[0], chunk, dim=1),
                     dim=1)
