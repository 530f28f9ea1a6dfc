"""ELL (padded fixed-width) adjacency formats (tagrec_tpu/ops/ell.py).

Host builders in numpy, with the JAX package's layouts, so that both give
the same arrays for the same COO: every row stores a zero-padded row of
neighbour ids and edge values, its width the row's bucket's largest degree
rounded up to 8.  Rows are bucketed by degree quantiles so that a few hub
rows do not widen every row; on zipf graphs the most popular columns go to
one dense hub block instead (the hybrid form); at small scale the whole
adjacency is dense, split into the joint graph's nonzero type sectors.

The device containers hold tensors on one device: ids int32 and values
float32, converted once by ``to_device``, never per call.  ``ops.propagate``
runs them: ``ops.dma_gather.gather_reduce`` over each bucket, then
``gather_rows`` to restore row order, and ``torch.matmul`` for the dense
blocks.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class EllHost(NamedTuple):
    idx: np.ndarray  # [N, K] int32 neighbour ids, 0 in pad slots
    val: np.ndarray  # [N, K] float32 edge values, 0 in pad slots
    deg: np.ndarray  # [N] int32 true neighbour count
    n_cols: int


class Ell(NamedTuple):
    idx: torch.Tensor  # [N, K] int32
    val: torch.Tensor  # [N, K] float32
    deg: torch.Tensor  # [N] int32
    # [E] the real slots' flat positions n * K + k, row-major (int32 while
    # N * K < 2**31): found once on the host, so that a scatter over the
    # real slots (``propagate.ell_mm_t``) has fixed shapes and reads
    # nothing back
    live: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else m


def build_ell(row, col, val, n_rows: int, n_cols: int, pad_multiple: int = 8,
              width: Optional[int] = None) -> EllHost:
    """Pack COO edges into padded [N, K] tables, each row's edges in their
    input order.  K is the largest row degree rounded up to
    ``pad_multiple``, or ``width``."""
    row = np.asarray(row, dtype=np.int64)
    order = np.argsort(row, kind="stable")
    row, col, val = row[order], np.asarray(col)[order], np.asarray(val)[order]
    deg = np.bincount(row, minlength=n_rows).astype(np.int32)
    k = _round_up(int(deg.max()) if len(deg) else 0, pad_multiple)
    if width is not None:
        if width < int(deg.max(initial=0)):
            raise ValueError(f"width {width} is below the largest row degree "
                             f"{int(deg.max())}")
        k = width
    idx = np.zeros((n_rows, k), dtype=np.int32)
    v = np.zeros((n_rows, k), dtype=np.float32)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(row)) - starts[row]
    idx[row, slot] = col.astype(np.int32)
    v[row, slot] = val.astype(np.float32)
    return EllHost(idx=idx, val=v, deg=deg, n_cols=n_cols)


def live_slots(h: EllHost) -> np.ndarray:
    """[E] the flat positions n * K + k of ``h``'s real slots (k < deg[n]),
    row-major; int32 while N * K < 2**31, else int64."""
    n, k = h.idx.shape
    deg = h.deg.astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    first = np.cumsum(deg) - deg
    live = rows * k + (np.arange(len(rows), dtype=np.int64) - first[rows])
    return live.astype(np.int32 if n * k < 2**31 else np.int64)


def ell_from_coo(coo, pad_multiple: int = 8,
                 width: Optional[int] = None) -> EllHost:
    return build_ell(coo.row, coo.col, coo.val, coo.shape[0], coo.shape[1],
                     pad_multiple=pad_multiple, width=width)


def ell_mask(ell: Ell) -> torch.Tensor:
    """[N, K] bool, True on the slots that hold an edge."""
    k = ell.idx.shape[1]
    return (torch.arange(k, device=ell.deg.device)[None, :]
            < ell.deg[:, None])


# ------------------------------------------------------------ degree buckets

class EllBucketsHost(NamedTuple):
    buckets: List[EllHost]    # one table per bucket, over its own rows
    rows: List[np.ndarray]    # the global row ids of each bucket
    inv_perm: np.ndarray      # [N]: concat(bucket outputs)[inv_perm] is row order
    n_rows: int
    n_cols: int


class EllBuckets(NamedTuple):
    parts: Tuple[Ell, ...]
    inv_perm: torch.Tensor    # [N] int32


def auto_boundaries(deg: np.ndarray,
                    quantiles=(0.25, 0.5, 0.75, 0.9, 0.97, 0.995)) \
        -> Tuple[int, ...]:
    """Degree-quantile bucket boundaries, deduplicated and increasing."""
    pos = deg[deg > 0]
    if len(pos) == 0:
        return ()
    qs = sorted({int(np.quantile(pos, q)) for q in quantiles})
    mx = int(pos.max())
    return tuple(q for q in qs if 0 < q < mx)


def build_ell_buckets(row, col, val, n_rows: int, n_cols: int,
                      boundaries: Optional[Tuple[int, ...]] = None,
                      pad_multiple: int = 8) -> EllBucketsHost:
    """Bucket rows by degree at ``boundaries`` (degree quantiles when None)
    and pack each bucket; rows of degree 0 join the first bucket."""
    row = np.asarray(row, dtype=np.int64)
    deg = np.bincount(row, minlength=n_rows)
    order = np.argsort(row, kind="stable")
    row_s = row[order]
    col_s, val_s = np.asarray(col)[order], np.asarray(val)[order]
    if boundaries is None:
        boundaries = auto_boundaries(deg)
    top = max(int(deg.max(initial=0)), 1)
    buckets, rows_list = [], []
    lo = -1
    for b in list(boundaries) + [top]:
        sel = np.flatnonzero((deg > lo) & (deg <= b))
        lo = b
        if len(sel):
            local_of = np.full(n_rows, -1, dtype=np.int64)
            local_of[sel] = np.arange(len(sel))
            e_sel = local_of[row_s] >= 0
            buckets.append(build_ell(local_of[row_s[e_sel]], col_s[e_sel],
                                     val_s[e_sel], len(sel), n_cols,
                                     pad_multiple=pad_multiple))
            rows_list.append(sel)
        if b >= deg.max(initial=0):
            break
    perm = np.concatenate(rows_list)
    inv_perm = np.empty(n_rows, dtype=np.int64)
    inv_perm[perm] = np.arange(n_rows)
    return EllBucketsHost(buckets=buckets, rows=rows_list, inv_perm=inv_perm,
                          n_rows=n_rows, n_cols=n_cols)


def build_ell_buckets_slots(row, col, val, n_rows: int, n_cols: int,
                            boundaries: Optional[Tuple[int, ...]] = None,
                            pad_multiple: int = 8):
    """``build_ell_buckets`` that also tracks where each edge lands ->
    (EllBucketsHost, slot_of_edge): ``slot_of_edge[e]`` is the flat
    position of input edge e in the concatenation of the bucket tables,
    each bucket row-major [Nb * Kb].  ``ops.edgemap`` builds its
    forward/transpose slot maps on it.

    Rows of degree 0 get a bucket of their own of width 0, not the first
    bucket's width: in a keyed row space ((relation, node) keys) most rows
    are empty, and padding each to 8 slots would dominate the tables."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float32)
    n_edges = len(row)
    deg = np.bincount(row, minlength=n_rows)
    order = np.argsort(row, kind="stable")
    row_s, col_s, val_s = row[order], col[order], val[order]
    if boundaries is None:
        boundaries = auto_boundaries(deg)
    bounds = list(boundaries) + [max(int(deg.max()) if n_edges else 1, 1)]
    # each (row-sorted) edge's slot within its row
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot_in_row = np.arange(n_edges, dtype=np.int64) - starts[row_s]

    buckets, rows_list = [], []
    zero_rows = np.flatnonzero(deg == 0)
    if len(zero_rows):
        buckets.append(EllHost(idx=np.zeros((len(zero_rows), 0), np.int32),
                               val=np.zeros((len(zero_rows), 0), np.float32),
                               deg=np.zeros(len(zero_rows), np.int32),
                               n_cols=n_cols))
        rows_list.append(zero_rows)
    slot_of_sorted = np.zeros(n_edges, dtype=np.int64)
    offset, lo = 0, 0
    for b in bounds:
        sel = np.flatnonzero((deg > lo) & (deg <= b))
        lo = b
        if len(sel) == 0:
            continue
        local_of = np.full(n_rows, -1, dtype=np.int64)
        local_of[sel] = np.arange(len(sel))
        e_sel = local_of[row_s] >= 0
        local_rows = local_of[row_s[e_sel]]
        h = build_ell(local_rows, col_s[e_sel], val_s[e_sel], len(sel),
                      n_cols, pad_multiple=pad_multiple)
        k = h.idx.shape[1]
        slot_of_sorted[e_sel] = offset + local_rows * k + slot_in_row[e_sel]
        offset += len(sel) * k
        buckets.append(h)
        rows_list.append(sel)
        if len(deg) and b >= deg.max():
            break
    perm = (np.concatenate(rows_list) if rows_list
            else np.zeros(0, dtype=np.int64))
    inv_perm = np.empty(n_rows, dtype=np.int64)
    inv_perm[perm] = np.arange(n_rows)
    slot_of_edge = np.empty(n_edges, dtype=np.int64)
    slot_of_edge[order] = slot_of_sorted
    return (EllBucketsHost(buckets=buckets, rows=rows_list, inv_perm=inv_perm,
                           n_rows=n_rows, n_cols=n_cols), slot_of_edge)


# ------------------------------------------------- hybrid and dense forms

class HybridHost(NamedTuple):
    """Dense hub-column block plus bucketed ELL over the other edges.
    ``dense_cols`` None with a block present: the block is the whole
    adjacency (``build_dense``)."""

    ell: EllBucketsHost
    dense_cols: Optional[np.ndarray]   # [H] int32 hub column ids
    dense_block: Optional[np.ndarray]  # [N, H] float32 values


class Hybrid(NamedTuple):
    ell: EllBuckets
    dense_cols: Optional[torch.Tensor]   # [H] int32
    dense_block: Optional[torch.Tensor]  # [N, H] float32


def _empty_buckets(n_rows: int, n_cols: int) -> EllBucketsHost:
    return EllBucketsHost(buckets=[], rows=[],
                          inv_perm=np.zeros(0, dtype=np.int64),
                          n_rows=n_rows, n_cols=n_cols)


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16, rounded to nearest even (as JAX's ``asarray(...,
    bfloat16)``), held as its uint16 bit patterns: numpy has no bfloat16.
    ``to_device`` turns such a block into a torch.bfloat16 tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _cast_block(b: np.ndarray, dtype) -> np.ndarray:
    if dtype is np.float32:
        return b
    if dtype == "bf16":
        return bf16_bits(b)
    raise ValueError(f"dense dtype {dtype!r}: np.float32 or 'bf16'")


def build_dense(coo, dtype=np.float32) -> HybridHost:
    """The whole adjacency as one dense block, float32 or ``"bf16"`` (its
    values rounded to bfloat16; products accumulate in float32,
    ``ops.propagate.hybrid_mm``)."""
    return HybridHost(ell=_empty_buckets(*coo.shape), dense_cols=None,
                      dense_block=_cast_block(coo.to_dense(), dtype))


# Byte budget of the hub block, which sets how many hub columns the hybrid
# form takes by default (at least 512).
HUB_BLOCK_BUDGET_BYTES = 1 << 30


def build_hybrid(coo, hub_min_degree: int = 96, max_hub_cols=None,
                 boundaries=None, pad_multiple: int = 8) -> HybridHost:
    """Hub columns (in-degree >= ``hub_min_degree``, the ``max_hub_cols``
    most popular; by default as many as fill HUB_BLOCK_BUDGET_BYTES) as a
    dense block, the other edges as bucketed ELL."""
    n_rows, n_cols = coo.shape
    if max_hub_cols is None:
        max_hub_cols = max(HUB_BLOCK_BUDGET_BYTES // (n_rows * 4) // 128 * 128,
                           512)
    indeg = np.bincount(coo.col, minlength=n_cols)
    hub = np.flatnonzero(indeg >= hub_min_degree)
    if len(hub) > max_hub_cols:
        hub = np.sort(hub[np.argsort(-indeg[hub])[:max_hub_cols]])
    if len(hub) == 0:
        return HybridHost(
            ell=build_ell_buckets(coo.row, coo.col, coo.val, n_rows, n_cols,
                                  boundaries=boundaries,
                                  pad_multiple=pad_multiple),
            dense_cols=None, dense_block=None)
    col_of = np.full(n_cols, -1, dtype=np.int64)
    col_of[hub] = np.arange(len(hub))
    is_hub = col_of[coo.col] >= 0
    block = np.zeros((n_rows, len(hub)), dtype=np.float32)
    block[coo.row[is_hub], col_of[coo.col[is_hub]]] = coo.val[is_hub]
    tail = ~is_hub
    ell = build_ell_buckets(coo.row[tail], coo.col[tail], coo.val[tail],
                            n_rows, n_cols, boundaries=boundaries,
                            pad_multiple=pad_multiple)
    return HybridHost(ell=ell, dense_cols=hub.astype(np.int32),
                      dense_block=block)


class DenseSectorsHost(NamedTuple):
    """The joint {user, item, tag} adjacency's nonzero type sectors as dense
    blocks; its diagonal sectors are structurally zero."""

    blocks: tuple  # ((row sector, col sector, [rows, cols] block), ...):
    #                float32, or bfloat16 as uint16 bits (``bf16_bits``)
    sizes: tuple   # node count of each sector


class DenseSectors(NamedTuple):
    blocks: Tuple[torch.Tensor, ...]
    coords: Tuple[Tuple[int, int], ...]
    sizes: Tuple[int, ...]


def build_dense_sectors(coo, sectors, dtype=np.float32) -> DenseSectorsHost:
    """Split a square COO over per-type sectors into dense blocks, keeping
    the blocks that hold an edge; ``dtype`` as ``build_dense``'s."""
    sizes = tuple(int(s) for s in sectors)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    if not offs[-1] == coo.shape[0] == coo.shape[1]:
        raise ValueError(f"sectors {sizes} do not tile a {coo.shape} "
                         "adjacency")
    ri_of = np.searchsorted(offs, coo.row, side="right") - 1
    ci_of = np.searchsorted(offs, coo.col, side="right") - 1
    blocks = []
    for ri in range(len(sizes)):
        for ci in range(len(sizes)):
            sel = (ri_of == ri) & (ci_of == ci)
            if not sel.any():
                continue
            b = np.zeros((sizes[ri], sizes[ci]), dtype=np.float32)
            np.add.at(b, (coo.row[sel] - offs[ri], coo.col[sel] - offs[ci]),
                      coo.val[sel])
            blocks.append((ri, ci, _cast_block(b, dtype)))
    return DenseSectorsHost(blocks=tuple(blocks), sizes=sizes)


# ------------------------------------------------------------- the pair

class AdjPairHost(NamedTuple):
    fwd: object  # HybridHost or DenseSectorsHost
    bwd: object  # its transpose; the same object when symmetric


class AdjPair(NamedTuple):
    """Forward and transpose adjacency: the backward of A @ x is A^T @ g,
    another SpMM over ``bwd`` (``ops.propagate.pair_spmm``)."""

    fwd: object  # Hybrid or DenseSectors
    bwd: object


# Auto-dense when the full float32 matrix fits this.
DENSE_ADJ_BUDGET_BYTES = 2 << 30


def build_adj_pair(coo, symmetric: bool = False, boundaries=None,
                   pad_multiple: int = 8, hub_min_degree: int = 96,
                   max_hub_cols=None, mode: str = "auto",
                   dense_budget: int = DENSE_ADJ_BUDGET_BYTES,
                   dense_dtype=np.float32, sectors=None) -> AdjPairHost:
    """Forward and transpose adjacency of ``coo``.

    mode: "auto" (dense when N*M*4 bytes fit ``dense_budget``, else
    hybrid), "dense", "hybrid", or "ell" (hybrid with no hub block).
    ``sectors``: per-type sizes of a square joint adjacency; the dense form
    then keeps only its nonzero sector blocks.  ``dense_dtype`` (float32 or
    ``"bf16"``) applies to the dense forms only: the hybrid form's hub block
    stays float32, as in JAX.  ``symmetric=True`` (bi_norm and plain joint
    adjacencies) shares the forward for the backward."""
    if mode == "auto":
        mode = ("dense" if coo.shape[0] * coo.shape[1] * 4 <= dense_budget
                else "hybrid")
    if mode not in ("dense", "hybrid", "ell"):
        raise ValueError(f"mode {mode!r}: auto, dense, hybrid or ell")
    if mode == "ell":
        hub_min_degree, max_hub_cols = 1 << 30, 0

    def build_one(c):
        if mode == "dense" and sectors is not None:
            return build_dense_sectors(c, sectors, dtype=dense_dtype)
        if mode == "dense":
            return build_dense(c, dtype=dense_dtype)
        return build_hybrid(c, hub_min_degree=hub_min_degree,
                            max_hub_cols=max_hub_cols, boundaries=boundaries,
                            pad_multiple=pad_multiple)

    fwd = build_one(coo)
    return AdjPairHost(fwd=fwd, bwd=fwd if symmetric
                       else build_one(coo.transpose()))


# ------------------------------------------------------------- to device

def _ids(a: np.ndarray, n: int, device) -> torch.Tensor:
    """int32 ids on ``device``, checked to lie in [0, n) once here: the
    gather kernels do not check them."""
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() >= n):
        raise ValueError(f"ids outside [0, {n})")
    return torch.as_tensor(a.astype(np.int32), device=device)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _block(a: np.ndarray, device) -> torch.Tensor:
    """A dense block on ``device``: float32, or bfloat16 from its uint16
    bits (``bf16_bits``)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return _f32(a, device)


def to_device(h, device):
    """The device container of a host form (EllHost, EllBucketsHost,
    HybridHost, DenseSectorsHost, RowShardHost or AdjPairHost), its
    tensors on ``device``."""
    if isinstance(h, RowShardHost):
        return RowShard(form=to_device(h.form, device), blocks=h.blocks,
                        rows=h.rows, mesh=h.mesh)
    if isinstance(h, AdjPairHost):
        fwd = to_device(h.fwd, device)
        return AdjPair(fwd=fwd, bwd=fwd if h.bwd is h.fwd
                       else to_device(h.bwd, device))
    if isinstance(h, DenseSectorsHost):
        return DenseSectors(blocks=tuple(_block(b, device)
                                         for _, _, b in h.blocks),
                            coords=tuple((ri, ci) for ri, ci, _ in h.blocks),
                            sizes=h.sizes)
    if isinstance(h, HybridHost):
        n_cols = h.ell.n_cols
        return Hybrid(
            ell=to_device(h.ell, device),
            dense_cols=None if h.dense_cols is None
            else _ids(h.dense_cols, n_cols, device),
            dense_block=None if h.dense_block is None
            else _block(h.dense_block, device))
    if isinstance(h, EllBucketsHost):
        # inv_perm indexes the whole buckets' rows, also for a rank's cut
        return EllBuckets(parts=tuple(to_device(b, device)
                                      for b in h.buckets),
                          inv_perm=_ids(h.inv_perm, max(h.n_rows, 1), device))
    if isinstance(h, EllHost):
        return Ell(idx=_ids(h.idx, h.n_cols, device), val=_f32(h.val, device),
                   deg=torch.as_tensor(h.deg.astype(np.int32), device=device),
                   live=torch.as_tensor(live_slots(h), device=device))
    raise TypeError(f"no device form for {type(h).__name__}")


# ------------------------------------------- rows over the ``model`` axis

# JAX's rule (``_shardable``, tagrec_tpu/parallel/sharding.py): a table of
# at least this many rows, which divide by the ``model`` axis, is
# row-sharded over it; every other table is whole on every rank
MIN_SHARD_ROWS = 64
# the leaves JAX row-shards too, but which stay whole here: a rank's rows
# of the product are put in order by the whole inv_perm, and its hub
# products read the whole hub column ids (ROADMAP.md section C)
WHOLE_LEAVES = ("inv_perm", "dense_cols")


def row_sharded(n_rows: int, model: int) -> bool:
    """JAX's ``_shardable`` for a table of ``n_rows`` rows."""
    return n_rows >= MIN_SHARD_ROWS and n_rows % model == 0


class RowShardHost(NamedTuple):
    """One ``model`` rank's rows of a Hybrid or DenseSectors form
    (``shard_rows``).  Its pieces are the tables that hold rows of the
    product, in order: a Hybrid's buckets, then its dense block; a
    DenseSectors' blocks."""

    form: object   # the form, each row-sharded piece cut to the rank's rows
    blocks: tuple  # per piece: (start, stop) of the rank's rows, or None
    #                for a piece that is whole on every rank
    rows: tuple    # per piece: the whole piece's rows
    mesh: object   # the parallel.Mesh


class RowShard(NamedTuple):
    """A RowShardHost on the device (``ops.propagate.sharded_mm``)."""

    form: object   # Hybrid or DenseSectors
    blocks: tuple
    rows: tuple
    mesh: object


def cut_rows(a, block):
    """Rows [start, stop) = ``block`` of ``a``; all of ``a`` for None."""
    return a if block is None else a[block[0]:block[1]]


def shard_rows(h, mesh):
    """``mesh``'s rank's rows of a host form (AdjPairHost, HybridHost or
    DenseSectorsHost), cut before anything is uploaded, as JAX's
    ``gdev_sharding`` places them: each bucket's idx, val and deg, the
    dense block and each sector block row-sharded over ``model`` where
    ``row_sharded``, the rank's block the i-th of ``model`` even blocks;
    every other table whole.  A cut bucket gets its own real-slot list
    (``Ell.live``, made by ``to_device``).  ``inv_perm`` and
    ``dense_cols`` stay whole (WHOLE_LEAVES).  A symmetric pair stays
    one structure."""
    if isinstance(h, AdjPairHost):
        fwd = shard_rows(h.fwd, mesh)
        return AdjPairHost(fwd=fwd, bwd=fwd if h.bwd is h.fwd
                           else shard_rows(h.bwd, mesh))
    m, i = mesh.shape["model"], mesh.index("model")

    def block(n):
        return ((i * (n // m), (i + 1) * (n // m)) if row_sharded(n, m)
                else None)

    if isinstance(h, DenseSectorsHost):
        rows = tuple(b.shape[0] for _, _, b in h.blocks)
        blocks = tuple(block(n) for n in rows)
        form = h._replace(blocks=tuple((ri, ci, cut_rows(b, k)) for
                                       (ri, ci, b), k in zip(h.blocks,
                                                             blocks)))
    elif isinstance(h, HybridHost):
        rows = tuple([b.idx.shape[0] for b in h.ell.buckets]
                     + ([] if h.dense_block is None
                        else [h.dense_block.shape[0]]))
        blocks = tuple(block(n) for n in rows)
        buckets = [EllHost(idx=cut_rows(b.idx, k), val=cut_rows(b.val, k),
                           deg=cut_rows(b.deg, k), n_cols=b.n_cols)
                   for b, k in zip(h.ell.buckets, blocks)]
        form = h._replace(
            ell=h.ell._replace(buckets=buckets),
            dense_block=None if h.dense_block is None
            else cut_rows(h.dense_block, blocks[-1]))
    else:
        raise TypeError(f"no row shards of {type(h).__name__}")
    return RowShardHost(form=form, blocks=blocks, rows=rows, mesh=mesh)


def leaves(h, prefix: str = "adj"):
    """[(JAX's leaf path, array)] of an adjacency form, host or device (a
    row shard's form under the same paths), in JAX's leaf order:
    ``adj.fwd.ell.parts.0.idx``, ``...val``, ``...deg``,
    ``adj.fwd.ell.inv_perm``, ``adj.fwd.dense_cols``,
    ``adj.fwd.dense_block``; a DenseSectors' blocks ``adj.fwd.0``, ...;
    a pair's ``fwd`` then ``bwd``, also when they are one structure."""
    if isinstance(h, (AdjPairHost, AdjPair)):
        return leaves(h.fwd, prefix + ".fwd") + leaves(h.bwd, prefix + ".bwd")
    if isinstance(h, (RowShardHost, RowShard)):
        return leaves(h.form, prefix)
    if isinstance(h, DenseSectorsHost):
        return [(f"{prefix}.{j}", b) for j, (_, _, b) in enumerate(h.blocks)]
    if isinstance(h, DenseSectors):
        return [(f"{prefix}.{j}", b) for j, b in enumerate(h.blocks)]
    if isinstance(h, (HybridHost, Hybrid)):
        return leaves(h.ell, prefix + ".ell") + [
            (f"{prefix}.{k}", getattr(h, k)) for k in ("dense_cols",
                                                       "dense_block")
            if getattr(h, k) is not None]
    if isinstance(h, (EllBucketsHost, EllBuckets)):
        parts = h.buckets if isinstance(h, EllBucketsHost) else h.parts
        return [(f"{prefix}.parts.{j}.{k}", getattr(p, k))
                for j, p in enumerate(parts) for k in ("idx", "val", "deg")
                ] + [(f"{prefix}.inv_perm", h.inv_perm)]
    raise TypeError(f"no leaves of {type(h).__name__}")


def graph_bytes(adj) -> int:
    """Bytes of the device tensors of ``adj`` (an AdjPair, RowShard or
    form), each counted once: the leaves and the buckets' real-slot
    lists."""
    seen = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            seen[id(t)] = t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
    walk(adj)
    return sum(seen.values())
