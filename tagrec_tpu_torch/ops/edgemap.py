"""EdgeMap: paired forward/transpose ELL tables with scatter-free backwards
(tagrec_tpu/ops/edgemap.py).

The attention and routing models (KGAT, DGCF, DisenGCN, DisenHAN, TGCN's
``adj_mode="ell"``) compute learned per-edge values every step.  Autograd
of a gather-based formulation turns every gather into a scatter-add in the
backward.  But every cotangent of an edge op over a fixed edge set is an
edge op over the same edge set: an aggregation transposes to an
aggregation over the reversed edges, a per-edge product to gathers.  So
the host builds, once, the forward AND the transpose degree-bucketed ELL
tables and the flat slot bijection between them, and each primitive below
is a ``torch.autograd.Function`` whose backward is written over the
transpose structure with gathers only, never a scatter or ``index_add_``:

* ``edge_reduce(em, vals, x)``  out[r] = sum_k vals[r, k] * x[idx[r, k]]
    backward: d vals = edge_dot(em, g, x); d x = edge_reduce(em^T, T(vals), g)
* ``edge_dot(em, a, b)``        s[r, k] = a[r] . b[idx[r, k]]  (0 on pads)
    backward: d a = edge_reduce(em, ds, b); d b = edge_reduce(em^T, T(ds), a)
* ``edge_gather(em, v)``        s[r, k] = v[idx[r, k]]         (0 on pads)
* ``edge_vgather(em, x)``       s[r, k, :] = x[idx[r, k], :]   (0 on pads)
* ``rows_gather(em, x)``        row-ordered node data split into bucket order
* ``slot_transfer(vals, to, from)`` per-slot values between two EdgeMaps of
    one edge set (``cross_slot_maps``)

``T(.)`` (``transpose_vals``) moves per-slot values to the transpose layout
by the bijection, a gather with a zero sentinel for the pads.  Each value
operand may carry leading axes (the disentangled models' [F] factor
axis); the leading axes of the two operands of ``edge_reduce`` and
``edge_dot`` must be equal.  Per-bucket value tuples follow the map's
buckets, as JAX's do.

Each bucket's sum of ``edge_reduce`` (forward, and the two reductions of
the backwards of ``edge_reduce`` and ``edge_dot``) is
``ops.dma_gather.gather_reduce(x_f, idx, vals_f, deg)``, once per element
of the flattened leading axes: on a CUDA tensor the hand-written kernel
(float32 only; it raises on anything else), on a CPU tensor its plain
version.  ``deg`` keeps the pad slots out of the sum; JAX sums every slot,
which is the same on finite inputs because the pads' values are 0.  A
zero-width bucket gives zeros without a launch.  The other primitives
take rows by indexing, as JAX's ``jnp.take`` does.

The raw forms (``_reduce_raw``, ``_dot_raw``) are plain differentiable
PyTorch: ``edge_dot``'s forward and ``edge_reduce``'s d vals use
``_dot_raw``, and the tests differentiate both against the Functions.
Buckets whose [rows, K, D] gather is over ``EDGEMAP_GATHER_BUDGET_BYTES``
(priced with JAX's TPU padding, so the same buckets chunk) run in row
chunks, each recomputed in the backward rather than saved.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tagrec_tpu_torch.ops import dma_gather
from tagrec_tpu_torch.ops import ell as ell_lib


class EdgeMapHost(NamedTuple):
    f: ell_lib.EllBucketsHost
    b: ell_lib.EllBucketsHost
    f_src: List[np.ndarray]  # per fwd bucket [Nb, Kb]: flat bwd slot
    b_src: List[np.ndarray]  # per bwd bucket [Mb, Kb]: flat fwd slot
    f_slot_of_edge: np.ndarray  # [E] flat fwd slot of each input edge
    b_slot_of_edge: np.ndarray


class EdgeMap(NamedTuple):
    """The device side: per-bucket int32 tensors (``f_val``/``b_val`` the
    float32 static payload), on one device."""

    f_idx: tuple   # per bucket [Nb, Kb] column ids
    f_val: tuple   # per bucket [Nb, Kb] static edge payload
    f_rows: tuple  # per bucket [Nb] row ids
    f_deg: tuple   # per bucket [Nb]
    f_inv: torch.Tensor  # [n_rows]: concat(bucket rows)[f_inv] is row order
    b_idx: tuple
    b_val: tuple
    b_rows: tuple
    b_deg: tuple
    b_inv: torch.Tensor
    f_src: tuple
    b_src: tuple

    @property
    def n_buckets(self) -> int:
        return len(self.f_idx)

    def transpose(self) -> "EdgeMap":
        return EdgeMap(f_idx=self.b_idx, f_val=self.b_val, f_rows=self.b_rows,
                       f_deg=self.b_deg, f_inv=self.b_inv, b_idx=self.f_idx,
                       b_val=self.f_val, b_rows=self.f_rows, b_deg=self.f_deg,
                       b_inv=self.f_inv, f_src=self.b_src, b_src=self.f_src)

    def masks(self, dtype=torch.float32) -> tuple:
        """Per-bucket [Nb, Kb] validity masks."""
        return tuple(_slot_mask(i, d).to(dtype)
                     for i, d in zip(self.f_idx, self.f_deg))


def _slot_mask(idx: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    return (torch.arange(idx.shape[1], device=deg.device)[None, :]
            < deg[:, None])


def build_edge_map(row, col, val, n_rows: int, n_cols: int,
                   boundaries=None, pad_multiple: int = 8) -> EdgeMapHost:
    """The paired forward/transpose bucketed tables and their slot
    bijection (host, once)."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if val is None:
        val = np.ones(len(row), dtype=np.float32)
    f, f_slot = ell_lib.build_ell_buckets_slots(
        row, col, val, n_rows, n_cols, boundaries=boundaries,
        pad_multiple=pad_multiple)
    b, b_slot = ell_lib.build_ell_buckets_slots(
        col, row, val, n_cols, n_rows, boundaries=boundaries,
        pad_multiple=pad_multiple)
    f_total, b_total = _total_slots(f), _total_slots(b)
    return EdgeMapHost(f=f, b=b,
                       f_src=_slot_tables(f, f_slot, b_slot, b_total),
                       b_src=_slot_tables(b, b_slot, f_slot, f_total),
                       f_slot_of_edge=f_slot, b_slot_of_edge=b_slot)


def _total_slots(h: ell_lib.EllBucketsHost) -> int:
    return sum(b.idx.shape[0] * b.idx.shape[1] for b in h.buckets)


def _split_flat(h: ell_lib.EllBucketsHost, flat: np.ndarray) -> List:
    """A flat per-slot array cut into ``h``'s per-bucket [Nb, Kb] tables."""
    out, off = [], 0
    for bk in h.buckets:
        n = bk.idx.shape[0] * bk.idx.shape[1]
        out.append(flat[off:off + n].reshape(bk.idx.shape))
        off += n
    return out


def _slot_tables(h: ell_lib.EllBucketsHost, slot, other_slot,
                 sentinel: int) -> List[np.ndarray]:
    """Per bucket of ``h``, each edge's slot in the other layout
    (``other_slot[e]`` at ``slot[e]``), ``sentinel`` (the other layout's
    zero slot) on the pads."""
    flat = np.full(_total_slots(h), sentinel, dtype=np.int64)
    flat[slot] = other_slot
    return [t.astype(np.int32) for t in _split_flat(h, flat)]


def slot_payload(host: EdgeMapHost, per_edge: np.ndarray, fill=0,
                 side: str = "f") -> List[np.ndarray]:
    """A per-edge array placed into per-bucket [Nb, Kb] tables (host,
    once), ``fill`` on the pads."""
    h = host.f if side == "f" else host.b
    slot = host.f_slot_of_edge if side == "f" else host.b_slot_of_edge
    per_edge = np.asarray(per_edge)
    flat = np.full(_total_slots(h), fill, dtype=per_edge.dtype)
    flat[slot] = per_edge
    return _split_flat(h, flat)


def to_device(host: EdgeMapHost, device) -> EdgeMap:
    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    def side(h):
        return (tuple(ell_lib._ids(b.idx, h.n_cols, device)
                      for b in h.buckets),
                tuple(ell_lib._f32(b.val, device) for b in h.buckets),
                tuple(i32(r) for r in h.rows),
                tuple(i32(b.deg) for b in h.buckets),
                i32(h.inv_perm))

    f_idx, f_val, f_rows, f_deg, f_inv = side(host.f)
    b_idx, b_val, b_rows, b_deg, b_inv = side(host.b)
    return EdgeMap(f_idx=f_idx, f_val=f_val, f_rows=f_rows, f_deg=f_deg,
                   f_inv=f_inv, b_idx=b_idx, b_val=b_val, b_rows=b_rows,
                   b_deg=b_deg, b_inv=b_inv,
                   f_src=tuple(i32(s) for s in host.f_src),
                   b_src=tuple(i32(s) for s in host.b_src))


class EdgeMapBuffers(nn.Module):
    """EdgeMaps and tuples of slot tables, held as a model's non-persistent
    buffers: ``.to()`` carries them, ``state_dict`` and the checkpoints do
    not see them.  ``buffers[key]`` rebuilds the EdgeMap (or tuple) from
    the current buffers."""

    def __init__(self, items: Dict[str, object]):
        super().__init__()
        self._layout = {}
        for key, item in items.items():
            if isinstance(item, EdgeMap):
                self._layout[key] = {f: self._put(f"{key}_{f}", v)
                                     for f, v in zip(item._fields, item)}
            else:
                self._layout[key] = self._put(key, tuple(item))

    def _put(self, name: str, v):
        if isinstance(v, tuple):
            for i, t in enumerate(v):
                self.register_buffer(f"{name}_{i}", t, persistent=False)
            return len(v)
        self.register_buffer(name, v, persistent=False)
        return None

    def _get(self, name: str, n):
        if n is None:
            return getattr(self, name)
        return tuple(getattr(self, f"{name}_{i}") for i in range(n))

    def __getitem__(self, key: str):
        lay = self._layout[key]
        if isinstance(lay, dict):
            return EdgeMap(**{f: self._get(f"{key}_{f}", n)
                              for f, n in lay.items()})
        return self._get(key, lay)


# ---------------------------------------------------------------------------
# raw forms (plain differentiable PyTorch)
# ---------------------------------------------------------------------------

# Budget of one bucket's [Nb, Kb, D] vector-gather intermediate, priced as
# JAX prices it on the TPU (minor dim padded to 128, slot dim to 8), so the
# same buckets run in row chunks in both packages.
EDGEMAP_GATHER_BUDGET_BYTES = 1 << 30


def _gather_bytes_per_row(k: int, d: int, itemsize: int = 4) -> int:
    return -(-k // 8) * 8 * (-(-d // 128) * 128) * itemsize


def _lead_n(lead) -> int:
    n = 1
    for s in lead:
        n *= int(s)
    return n


def _row_chunk_for(n: int, k: int, d: int, itemsize: int, lead=()) -> int:
    """0: no chunking (the bucket fits the budget); else the row-chunk size,
    a multiple of 8."""
    per_row = _gather_bytes_per_row(k, d, itemsize) * _lead_n(lead)
    if n == 0 or k == 0 or n * per_row <= EDGEMAP_GATHER_BUDGET_BYTES:
        return 0
    return max(EDGEMAP_GATHER_BUDGET_BYTES // per_row // 8 * 8, 8)


def _lead(what: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The common leading axes of two operands, which must be equal: a
    mismatch would otherwise fold into the row axis of a chunk."""
    la, lb = tuple(a.shape[:-2]), tuple(b.shape[:-2])
    if la != lb:
        raise ValueError(f"{what}: leading axes {la} and {lb} differ")
    return la


def _row_chunks(body, n: int, chunk: int) -> torch.Tensor:
    """body(start, stop) over row chunks, concatenated on axis -2; each
    chunk recomputed in the backward rather than saved; no chunk draws a
    random number, so no RNG state is stashed (graph-safe)."""
    remat = torch.is_grad_enabled()
    outs = [checkpoint(body, i, min(i + chunk, n), use_reentrant=False,
                       preserve_rng_state=False)
            if remat else body(i, min(i + chunk, n))
            for i in range(0, n, chunk)]
    return torch.cat(outs, dim=-2)


def _reduce_bucket(v, idx, x):
    """sum_k v[..., n, k] * x[..., idx[n, k], :] for one bucket, over row
    chunks where the [chunk, Kb, D] gather is over the budget."""
    n, k = idx.shape
    lead = _lead("reduce", v, x)
    chunk = _row_chunk_for(n, k, x.shape[-1], x.element_size(), lead)

    def body(i, j):
        return torch.einsum("...nk,...nkd->...nd", v[..., i:j, :],
                            x[..., idx[i:j], :])

    if chunk == 0 or n <= chunk:
        return body(0, n)
    return _row_chunks(body, n, chunk)


def _reduce_raw(em: EdgeMap, vals, x):
    """out[..., r, :] = sum_k vals[..., rb, k] * x[..., idx[rb, k], :] in
    row order (the pads' vals must be 0)."""
    outs = [_reduce_bucket(v, idx, x) for v, idx in zip(vals, em.f_idx)]
    return torch.cat(outs, dim=-2)[..., em.f_inv, :]


def _dot_bucket(ar, idx, b):
    """s[..., n, k] = ar[..., n, :] . b[..., idx[n, k], :] for one bucket,
    chunked on the same budget as ``_reduce_bucket``."""
    n, k = idx.shape
    lead = _lead("dot", ar, b)
    chunk = _row_chunk_for(n, k, b.shape[-1], b.element_size(), lead)

    def body(i, j):
        return torch.einsum("...nd,...nkd->...nk", ar[..., i:j, :],
                            b[..., idx[i:j], :])

    if chunk == 0 or n <= chunk:
        return body(0, n)
    return _row_chunks(body, n, chunk)


def _dot_raw(em: EdgeMap, a, b, masked: bool = True):
    """s[..., rb, k] = a[..., rows[rb], :] . b[..., idx[rb, k], :], 0 on
    the pads."""
    out = []
    for idx, rows, deg in zip(em.f_idx, em.f_rows, em.f_deg):
        s = _dot_bucket(a[..., rows, :], idx, b)
        out.append(torch.where(_slot_mask(idx, deg), s, 0.0) if masked
                   else s)
    return tuple(out)


def _gather_raw(em: EdgeMap, v, masked: bool = True):
    """s[..., rb, k] = v[..., idx[rb, k]], 0 on the pads."""
    out = []
    for idx, deg in zip(em.f_idx, em.f_deg):
        s = v[..., idx]
        out.append(torch.where(_slot_mask(idx, deg), s, 0.0) if masked
                   else s)
    return tuple(out)


def _vgather_raw(em: EdgeMap, x, masked: bool = True):
    """s[..., rb, k, :] = x[..., idx[rb, k], :], zero vectors on the pads."""
    out = []
    for idx, deg in zip(em.f_idx, em.f_deg):
        s = x[..., idx, :]
        out.append(torch.where(_slot_mask(idx, deg)[..., None], s, 0.0)
                   if masked else s)
    return tuple(out)


def _rows_gather_raw(em: EdgeMap, x):
    return tuple(x[..., rows, :] for rows in em.f_rows)


def _mask_tuple(em: EdgeMap, vals):
    return tuple(torch.where(_slot_mask(idx, deg), v, 0.0)
                 for v, idx, deg in zip(vals, em.f_idx, em.f_deg))


def _flat_slots(vals, tail: int = 0) -> torch.Tensor:
    """The per-bucket values concatenated over the flat slots, with one
    zero slot appended (the pads' sentinel); ``tail`` trailing axes kept."""
    lead = vals[0].shape[:vals[0].dim() - 2 - tail]
    rest = tuple(vals[0].shape[vals[0].dim() - tail:])
    flat = torch.cat([v.reshape(lead + (-1,) + rest) for v in vals],
                     dim=len(lead))
    zero = flat.new_zeros(lead + (1,) + rest)
    return torch.cat([flat, zero], dim=len(lead))


def transpose_vals(em: EdgeMap, vals):
    """Per-slot values moved from the forward layout to the transpose's;
    the transpose's pads read the zero sentinel."""
    flat = _flat_slots(vals)
    return tuple(flat[..., src] for src in em.b_src)


def _transfer_raw(vals, dst_tables):
    flat = _flat_slots(vals)
    return tuple(flat[..., t] for t in dst_tables)


# ---------------------------------------------------------------------------
# the per-bucket sum on the gather_reduce kernel
# ---------------------------------------------------------------------------

def _bucket_sum(v, idx, deg, x):
    """sum over k < deg[n] of v[..., n, k] * x[..., idx[n, k], :] for one
    bucket: one ``gather_reduce`` per element of the flattened leading
    axes; zeros without a launch for a bucket of width 0."""
    n, k = idx.shape
    lead = _lead("edge_reduce", v, x)
    d = x.shape[-1]
    if n == 0 or k == 0:
        return x.new_zeros(lead + (n, d))
    vf = v.reshape((-1, n, k))
    xf = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = [dma_gather.gather_reduce(xf[i].contiguous(), idx,
                                    vf[i].contiguous(), deg)
           for i in range(vf.shape[0])]
    return torch.stack(out).reshape(lead + (n, d))


def _reduce(em: EdgeMap, vals, x):
    """``_reduce_raw``'s value, each bucket through ``_bucket_sum``."""
    outs = [_bucket_sum(v, idx, deg, x)
            for v, idx, deg in zip(vals, em.f_idx, em.f_deg)]
    return torch.cat(outs, dim=-2)[..., em.f_inv, :]


# ---------------------------------------------------------------------------
# the primitives: autograd Functions whose backwards are gathers only
# ---------------------------------------------------------------------------

class _RowsGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x):
        ctx.em = em
        return _rows_gather_raw(em, x)

    @staticmethod
    def backward(ctx, *dparts):
        # the buckets partition the rows: the cotangent is a gather
        return None, torch.cat(dparts, dim=-2)[..., ctx.em.f_inv, :]


def rows_gather(em: EdgeMap, x) -> tuple:
    """Row-ordered node data [..., n_rows, D] split into the buckets' row
    order -> tuple of [..., Nb, D]."""
    return _RowsGather.apply(em, x)


class _EdgeReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x, *vals):
        ctx.em = em
        ctx.save_for_backward(x, *vals)
        return _reduce(em, vals, x)

    @staticmethod
    def backward(ctx, g):
        em = ctx.em
        x, *vals = ctx.saved_tensors
        dvals = ((None,) * len(vals) if not any(ctx.needs_input_grad[2:])
                 else _dot_raw(em, g, x, masked=True))
        dx = (_reduce(em.transpose(), transpose_vals(em, vals), g)
              if ctx.needs_input_grad[1] else None)
        return (None, dx, *dvals)


def edge_reduce(em: EdgeMap, vals, x) -> torch.Tensor:
    """The learned-value SpMM: vals a tuple of [..., Nb, Kb] (0 on the
    pads), x [..., n_cols, D] -> [..., n_rows, D] in row order."""
    return _EdgeReduce.apply(em, x, *vals)


class _EdgeDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, a, b):
        ctx.em = em
        ctx.save_for_backward(a, b)
        return _dot_raw(em, a, b, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        em = ctx.em
        a, b = ctx.saved_tensors
        ds = _mask_tuple(em, ds)
        da = _reduce(em, ds, b) if ctx.needs_input_grad[1] else None
        db = (_reduce(em.transpose(), transpose_vals(em, ds), a)
              if ctx.needs_input_grad[2] else None)
        return None, da, db


def edge_dot(em: EdgeMap, a, b) -> tuple:
    """Per-edge inner products s[r, k] = a[r] . b[idx[r, k]], 0 on the pads:
    a [..., n_rows, D] in row order, b [..., n_cols, D] -> tuple of
    [..., Nb, Kb]."""
    return _EdgeDot.apply(em, a, b)


class _EdgeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, v):
        ctx.em = em
        return _gather_raw(em, v, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        em = ctx.em
        ds_t = transpose_vals(em, _mask_tuple(em, ds))
        dv = torch.cat([s.sum(dim=-1) for s in ds_t], dim=-1)[..., em.b_inv]
        return None, dv


def edge_gather(em: EdgeMap, v) -> tuple:
    """Per-slot gather of a per-node value: s[r, k] = v[idx[r, k]], 0 on
    the pads; v [..., n_cols] -> tuple of [..., Nb, Kb]."""
    return _EdgeGather.apply(em, v)


class _EdgeVGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x):
        ctx.em = em
        return _vgather_raw(em, x, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        # the forward's pad slots are in no b_src table, so their
        # cotangents drop out; D stays the minor axis throughout
        em = ctx.em
        flat = _flat_slots(ds, tail=1)
        parts = [flat[..., src, :].sum(dim=-2) for src in em.b_src]
        return None, torch.cat(parts, dim=-2)[..., em.b_inv, :]


def edge_vgather(em: EdgeMap, x) -> tuple:
    """Per-slot vector gather: s[r, k, :] = x[idx[r, k], :], zero vectors
    on the pads; x [..., n_cols, D] -> tuple of [..., Nb, Kb, D].  Its
    backward sums each transpose row's slots (TGCN's neighbour reads,
    whose autograd backward is a scatter-add into the node table)."""
    return _EdgeVGather.apply(em, x)


def edge_softmax(em: EdgeMap, scores) -> tuple:
    """Masked softmax over each row's slots (torch.sparse.softmax over
    dim 1): 0 on the pads, all-zero rows for degree-0 rows; the row max is
    detached, as JAX's stop_gradient.  scores: tuple of [..., Nb, Kb]."""
    out = []
    for s, idx, deg in zip(scores, em.f_idx, em.f_deg):
        if s.shape[-1] == 0:
            out.append(s)
            continue
        m = _slot_mask(idx, deg)
        masked = torch.where(m, s, torch.finfo(s.dtype).min)
        mx = torch.amax(masked, dim=-1, keepdim=True).detach()
        e = torch.exp(masked - mx) * m
        z = torch.sum(e, dim=-1, keepdim=True)
        out.append(e / torch.where(z == 0, 1.0, z))
    return tuple(out)


# ---------------------------------------------------------------------------
# two EdgeMaps over one edge set
# ---------------------------------------------------------------------------

def cross_slot_maps(host_from: EdgeMapHost, host_to: EdgeMapHost):
    """The slot bijections between two EdgeMaps built over the same edges
    in the same order (a node-keyed and a (relation, node)-keyed map) ->
    (to_tables, from_tables): per to-bucket [Nb, Kb] indices into the
    from-side flat slots (the from total on the pads), and the reverse.
    ``slot_transfer`` takes them."""
    assert len(host_from.f_slot_of_edge) == len(host_to.f_slot_of_edge)
    f_tot = _total_slots(host_from.f)
    t_tot = _total_slots(host_to.f)
    to_tables = _slot_tables(host_to.f, host_to.f_slot_of_edge,
                             host_from.f_slot_of_edge, f_tot)
    from_tables = _slot_tables(host_from.f, host_from.f_slot_of_edge,
                               host_to.f_slot_of_edge, t_tot)
    return to_tables, from_tables


class _SlotTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, to_tables, from_tables, *vals):
        ctx.from_tables = from_tables
        return _transfer_raw(vals, to_tables)

    @staticmethod
    def backward(ctx, *ds):
        # the inverse transfer: a gather, not a scatter
        return (None, None, *_transfer_raw(ds, ctx.from_tables))


def slot_transfer(vals, to_tables, from_tables) -> tuple:
    """Per-slot values moved between the layouts of two EdgeMaps over one
    edge set (``cross_slot_maps``'s tables)."""
    return _SlotTransfer.apply(tuple(to_tables), tuple(from_tables), *vals)
