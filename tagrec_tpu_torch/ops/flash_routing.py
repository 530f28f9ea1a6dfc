"""Factor-softmax routing for DGCF's and DisenGCN's dense mode
(tagrec_tpu/ops/flash_routing.py).

* ``routed_rowsum(q, k, mask, base)``          d_f[n] = sum_m P_f[n, m]
* ``routed_mm(q, k, mask, x, base, mask_t)``   out_f = P_f @ x_f
* ``routed_mm_bwd(q, k, mask_t, g, base)``     dx_f = P_f^T @ g_f

with P_f = softmax over the F factors of (base + q_f @ k_f^T), times the 0/1
edge mask.  q [F, N, r], k [F, M, r], mask [N, M] (bool or int8), its
transpose mask_t [M, N], x [F, M, dx], g [F, N, dx], all float32.

On a CUDA tensor each wrapper launches its hand-written kernel and counts
the launch in its ``launches`` attribute (the mask rows it covered in
``rows``, the edges it worked in ``edges``).  The kernels
(``csrc/routed_rowsum.cu``, ``csrc/routed_mm.cu``, one per-edge body in
``csrc/routed.cuh``) read no dense mask: they sweep the mask's edges as a
``RoutingEdges``, a compressed row list built once on the host
(``mask_edges``, or ``coo_edges`` from the coordinates the mask came from)
and cut into segments of at most ``seg_edges`` edges, a warp a segment, so
a heavy row is spread over the card.  Each wrapper still takes the mask,
which the plain versions read and the checks hold the list against, and
takes the list as ``edges=`` (``routed_mm``'s backward, the list of mask_t,
as ``edges_t=``); on the card a call without it raises.  The kernels never
write the [F, N, M] plane to device memory.  ``routed_mm_bwd`` is the
``routed_mm`` kernel over the rows of mask_t with q and k swapped, as JAX's
``_routed_mm_bwd`` is ``_mm_call`` over mask.T.  On a CPU tensor each
wrapper runs the plain PyTorch version beside it, and only there (the list
unused): a CUDA tensor never falls back.

Each sweep also runs over a block of rows: ``mask`` rows row0 .. row0 + R
of the whole (q and the results' other inputs whole), the result [F, R,
...] written into ``out`` when given (``routed_rowsum``,
``routed_mm_rows``, ``routed_mm_bwd``; the plain versions take the same
``row0``; the list is that of the block's rows, built with its ``row0``).
Under a mesh a model passes ``ops.dense_adj.MaskShard``s, a ``model``
rank's rows, in place of its masks, with the lists of those rows: each
sweep then runs on the rank's rows and one all-gather over ``model`` makes
its result whole (``ops.dense_adj.sweep_gathered``), the forward's over
the mask's rows, the backward's over mask_t's, so no rank holds or gathers
a whole mask.

``routed_rowsum`` is a constant for autograd (JAX's stop_gradient).
``routed_mm`` is differentiable in x only: the routing weights are
detached, so q, k and the mask get no gradient (JAX gives them zeros), and
its backward is ``routed_mm_bwd``, which on the card needs ``mask_t`` and
``edges_t``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tagrec_tpu_torch.ops import _build
from tagrec_tpu_torch.ops.dense_adj import (MaskShard, sweep_gathered,
                                             sweep_rows)
from tagrec_tpu_torch.utils import profiling

# Limits of csrc/routed.cuh (both kernels): one lane of a 4-lane edge group
# per factor, q rows of at most 128 staged in shared memory, 16 accumulators
# a lane (routed_mm's dx), and columns packed in 24 bits of an edge entry.
_MAX_F, _MAX_R, _MAX_DX, _MAX_COLS = 4, 128, 16, 1 << 24
# The kernels' warps: 8 edges a step, blocks of 8 warps at 3 blocks an SM
# (their launch bounds); an H100's SMs where no card is at hand
_STEP, _RESIDENT_WARPS, _H100_SMS = 8, 3 * 8, 132
_MIN_SEG = 4 * _STEP


# ----------------------------------------------------------- the edge list

class RoutingEdges(NamedTuple):
    """The edges of rows row0 .. row0 + R of a [N, M] mask, as the routing
    kernels read them.  ``entries`` holds one int32 an edge, column | mask
    byte << 24, row by row in column order (``np.nonzero`` of the rows);
    ``indptr`` [R + 1] each row's first entry.  ``segs`` [S, 4] cuts each
    row into ceil(degree / ``seg_len``) segments of near-equal length, one
    for an empty row: (row, first entry, end entry, scratch slot, or -1
    where the segment is its row's only one), longest first.  ``splits``
    [K, 3] names each row cut into more than one segment: (row, first slot,
    slots), its slots consecutive in segment order; ``slots`` counts them
    all."""

    indptr: torch.Tensor
    entries: torch.Tensor
    segs: torch.Tensor
    splits: torch.Tensor
    row0: int
    cols: int
    seg_len: int
    slots: int

    @property
    def rows(self) -> int:
        return self.indptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.entries.numel()


def seg_edges(nnz: int, sms: int) -> int:
    """The most edges a segment holds: half of an even share of ``nnz``
    over the card's resident warps, in whole steps of 8, at least 32; so
    the longest segment is a fraction of a warp's share and the card ends
    its launch evenly.  ``nnz`` is the whole mask's: a row is then cut
    alike in every block of rows, and a block's sums are the whole
    launch's, bit for bit."""
    share = nnz // (2 * sms * _RESIDENT_WARPS)
    return max(_MIN_SEG, share // _STEP * _STEP)


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


def _plan(indptr: np.ndarray, seg_len: int):
    """(segs, splits, slots) of a list's row offsets (int64)."""
    deg = np.diff(indptr)
    nseg = np.maximum(1, -(-deg // seg_len))
    row = np.repeat(np.arange(len(deg)), nseg)
    j = np.arange(len(row)) - np.repeat(np.cumsum(nseg) - nseg, nseg)
    first = indptr[row] + j * deg[row] // nseg[row]
    end = indptr[row] + (j + 1) * deg[row] // nseg[row]
    split = nseg[row] > 1
    slot = np.full(len(row), -1)
    slot[split] = np.arange(int(split.sum()))
    order = np.argsort(first - end, kind="stable")  # longest first
    segs = np.stack([row, first, end, slot], axis=1)[order]
    split_rows = np.flatnonzero(nseg > 1)
    n = nseg[split_rows]
    splits = np.stack([split_rows, np.cumsum(n) - n, n], axis=1)
    return segs, splits, int(split.sum())


def _edge_list(rows, cols, vals, n_rows: int, n_cols: int, row0: int,
               device, whole_nnz: int, seg_len=None) -> RoutingEdges:
    """The RoutingEdges of coordinates sorted by row, then column (``rows``
    local to the block), ``vals`` the int8 mask bytes, on ``device``; its
    segments of at most ``seg_len`` edges (by default ``seg_edges`` of the
    whole mask's ``whole_nnz``).  The plan's size goes to the
    ``routing.*`` counters."""
    if n_cols >= _MAX_COLS:
        raise ValueError(f"M={n_cols}: the routing kernels take fewer than "
                         f"{_MAX_COLS} columns")
    device = torch.device(device)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    entries = (np.asarray(cols, dtype=np.uint32)
               | np.asarray(vals, dtype=np.int8).view(np.uint8)
               .astype(np.uint32) << 24).view(np.int32)
    seg_len = seg_len or seg_edges(whole_nnz, _sm_count(device))
    segs, splits, slots = _plan(indptr, seg_len)
    profiling.count("routing.edges", len(entries))
    profiling.count("routing.segments", len(segs))
    profiling.count("routing.split_rows", len(splits))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device)

    return RoutingEdges(up(indptr), up(entries), up(segs), up(splits), row0,
                        n_cols, seg_len, slots)


def mask_edges(mask, row0: int = 0, seg_len=None) -> RoutingEdges:
    """The RoutingEdges of a dense mask (a tensor, on its device, or a numpy
    array, on the CPU) holding rows row0 .. row0 + R of the whole: its
    nonzero bytes, for tests and tools.  For a block of rows give
    ``seg_len`` of the whole mask's list to cut its rows as that does."""
    device = mask.device if isinstance(mask, torch.Tensor) else "cpu"
    host = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
            else np.asarray(mask))
    rows, cols = np.nonzero(host)
    return _edge_list(rows, cols, host[rows, cols].astype(np.int8),
                      *host.shape, row0, device, len(rows), seg_len)


def coo_edges(row, col, shape, block=None, transpose: bool = False,
              device="cpu") -> RoutingEdges:
    """The RoutingEdges of the 0/1 mask of coordinates (``row``, ``col``) of
    a ``shape`` matrix (``dense_adj.dense_mask_host``'s), of its transpose
    when ``transpose``, over rows ``block`` = (start, stop) of it (all
    where None), without building the dense mask; its rows cut as the
    whole mask's list cuts them."""
    r, c = (col, row) if transpose else (row, col)
    n_rows, n_cols = shape[::-1] if transpose else shape
    keys = np.sort(np.asarray(r, dtype=np.int64) * n_cols
                   + np.asarray(c, dtype=np.int64))
    # duplicates dropped after a sort: np.unique hashes in newer numpy,
    # which took 0.6 s for hetrec's 986,300 keys on an H100 host
    keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    r, c = np.divmod(keys, n_cols)
    start, stop = (0, n_rows) if block is None else block
    keep = (r >= start) & (r < stop)
    return _edge_list(r[keep] - start, c[keep], np.ones(int(keep.sum()),
                                                        np.int8),
                      stop - start, n_cols, start, device, len(keys))


def _check(q, k, mask, row0: int = 0, x=None):
    """Shapes, devices and dtypes; ``mask`` holds rows row0 .. row0 + R of
    the [N, M] mask."""
    if q.dim() != 3 or k.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} must be "
                         f"[F, N, r], [F, M, r]; mask {tuple(mask.shape)} [N, M]")
    f, n, r = q.shape
    m = k.shape[1]
    if (k.shape[0] != f or k.shape[2] != r or mask.shape[1] != m
            or not 0 <= row0 <= n - mask.shape[0]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, mask {tuple(mask.shape)} "
                         f"from row {row0}")
    if x is not None and (x.dim() != 3 or x.shape[:2] != (f, m)):
        raise ValueError(f"x {tuple(x.shape)} must be [F={f}, M={m}, dx]")
    tensors = [q, k, mask] + ([x] if x is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, mask and x must lie on one device")
    if mask.dtype not in (torch.bool, torch.int8):
        raise TypeError(f"mask dtype {mask.dtype}: bool or int8")


def _check_kernel_args(q, k, mask, x=None, out=None):
    """What the CUDA kernels take: contiguous float32, shapes in their
    limits (one set for both; x and its width for routed_mm only), and an
    ``out`` of the result's shape."""
    tensors = [q, k] + [t for t in (x, out) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the routing kernels take float32 q, k and x")
    if not all(t.is_contiguous() for t in tensors + [mask]):
        raise ValueError("the routing kernels take contiguous tensors")
    f, _, r = q.shape
    if not 1 <= f <= _MAX_F:
        raise ValueError(f"F={f}: the routing kernels take 1..{_MAX_F} "
                         "factors")
    if not 1 <= r <= _MAX_R:
        raise ValueError(f"r={r} out of range: the routing kernels take "
                         f"1..{_MAX_R}")
    if k.shape[1] >= _MAX_COLS:
        raise ValueError(f"M={k.shape[1]}: the routing kernels take fewer "
                         f"than {_MAX_COLS} columns")
    if x is not None and x.shape[2] > _MAX_DX:
        raise ValueError(f"dx={x.shape[2]} too wide: routed_mm takes at most "
                         f"{_MAX_DX}")


def _lib(name: str, fn: str, n_ptr: int, n_int: int):
    lib = _build.load(name)
    c = getattr(lib, fn)
    if c.argtypes is None:
        c.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_float, ctypes.c_void_p])
        c.restype = ctypes.c_int
    return lib, c


def _raise_on(lib, err: int, what: str):
    """Raise with the CUDA error of a failed launch; every library exports
    ``<what>_error_string``."""
    if err:
        msg = getattr(lib, f"{what}_error_string")
        msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: {msg(err).decode()}")


# ------------------------------------------------------------ plain versions

def _routed_chunks(q, k, mask, base, chunk):
    """The routed adjacency [F, C, M], one chunk of C rows at a time, so that
    no [F, N, M] plane is ever held (tagrec_tpu/ops/dense_adj.py
    ``_dgcf_scores``)."""
    for i in range(0, q.shape[1], chunk):
        s = base + torch.einsum("fcr,fmr->fcm", q[:, i:i + chunk], k)
        yield torch.softmax(s, dim=0) * mask[i:i + chunk].to(s.dtype)


def routed_rowsum_plain(q, k, mask, base: float = 0.0, chunk: int = 1024,
                        row0: int = 0):
    """The routed adjacency's row sums in plain PyTorch
    (``dgcf_dense_degree``), over ``mask``'s rows row0 .. row0 + R."""
    q = q[:, row0:row0 + mask.shape[0]]
    return torch.cat([p.sum(dim=2)
                      for p in _routed_chunks(q, k, mask, base, chunk)], dim=1)


def routed_mm_plain(q, k, mask, x, base: float = 0.0, chunk: int = 1024,
                    row0: int = 0):
    """The routed adjacency times x in plain PyTorch (``dgcf_dense_prop``),
    over ``mask``'s rows row0 .. row0 + R."""
    q = q[:, row0:row0 + mask.shape[0]]
    return torch.cat([torch.einsum("fcm,fmd->fcd", p, x)
                      for p in _routed_chunks(q, k, mask, base, chunk)], dim=1)


# ------------------------------------------------------------------ wrappers

def _on_card(name: str, q) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


def _into(out, y):
    """``y``, copied into ``out`` when one is given."""
    return y if out is None else out.copy_(y)


def _check_edges(name: str, edges, mask, row0: int, q, kw: str = "edges"):
    """``edges``, the list a launch over ``mask`` (rows row0 .. row0 + R)
    takes: there at all, of those rows, on q's device."""
    if edges is None:
        raise ValueError(
            f"{name} on the card needs {kw}=, the RoutingEdges of the mask's "
            "rows it sweeps (flash_routing.mask_edges, or the model's "
            "routing_masks()): the kernels read no dense mask")
    if (edges.rows, edges.cols, edges.row0) != (*mask.shape, row0):
        raise ValueError(
            f"{name}: {kw} holds rows {edges.row0} .. "
            f"{edges.row0 + edges.rows} of {edges.cols} columns, not the "
            f"mask's {tuple(mask.shape)} from row {row0}")
    if edges.entries.device != q.device:
        raise ValueError(f"{name}: {kw} lies on {edges.entries.device}, "
                         f"q on {q.device}")


def _edge_args(edges: RoutingEdges, f: int, width: int, device):
    """The list's pointers and a scratch of its slots [slots, F, width], as
    the kernels take them: (pointers, (S, K), the scratch, kept alive by
    the caller until the launch is queued)."""
    scratch = (torch.empty((edges.slots, f, width), device=device,
                           dtype=torch.float32) if edges.slots else None)
    ptrs = (edges.entries.data_ptr(), edges.segs.data_ptr(),
            edges.splits.data_ptr())
    return ptrs, (edges.segs.shape[0], edges.splits.shape[0]), scratch


def routed_rowsum(q, k, mask, base: float = 0.0, row0: int = 0, out=None, *,
                  edges: RoutingEdges = None):
    """d_f[n] = sum_m (softmax_F(base + q_f k_f^T) * mask)[n, m] -> [F, R]
    over ``mask``'s rows row0 .. row0 + R (into ``out`` when given); a
    ``MaskShard`` gives the whole [F, N], each rank sweeping its rows.  On
    the card ``edges`` is the RoutingEdges of the rows swept (the rank's,
    for a MaskShard).

    The result is a constant for autograd, as under JAX's stop_gradient."""
    if isinstance(mask, MaskShard):
        return sweep_gathered(mask, q, [((q.shape[0],), ())], lambda m, r0, o:
                              routed_rowsum(q, k, m, base, row0=r0, out=o,
                                            edges=edges))[0]
    _check(q, k, mask, row0)
    if not _on_card("routed_rowsum", q):
        with torch.no_grad():
            return _into(out, routed_rowsum_plain(q, k, mask, base, row0=row0))
    _check_edges("routed_rowsum", edges, mask, row0, q)
    f, n, r = q.shape
    rows, m = mask.shape
    if out is None:
        out = torch.empty((f, rows), device=q.device, dtype=torch.float32)
    _check_kernel_args(q, k, mask, out=out)
    if tuple(out.shape) != (f, rows):
        raise ValueError(f"out {tuple(out.shape)} must be [{f}, {rows}]")
    ptrs, counts, scratch = _edge_args(edges, f, 1, q.device)
    lib, fn = _lib("routed_rowsum", "routed_rowsum_f32", 7, 8)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), *ptrs, out.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 f, rows, m, r, row0, n, *counts, float(base),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "routed_rowsum")
    routed_rowsum.launches += 1
    routed_rowsum.rows += rows
    routed_rowsum.edges += edges.nnz
    return out


def _routed_mm_kernel(q, k, mask, x, base, row0: int = 0, out=None,
                      edges: RoutingEdges = None):
    """One launch of csrc/routed_mm.cu on q's device over ``mask``'s rows
    row0 .. row0 + R, given as ``edges`` -> [F, R, dx] (into ``out``);
    uncounted."""
    f, n, r = q.shape
    rows, m = mask.shape
    dx = x.shape[2]
    if out is None:
        out = torch.empty((f, rows, dx), device=q.device, dtype=torch.float32)
    _check_kernel_args(q, k, mask, x, out)
    if tuple(out.shape) != (f, rows, dx):
        raise ValueError(f"out {tuple(out.shape)} must be [{f}, {rows}, {dx}]")
    ptrs, counts, scratch = _edge_args(edges, f, dx, q.device)
    lib, fn = _lib("routed_mm", "routed_mm_f32", 8, 9)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), *ptrs, x.data_ptr(),
                 out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                 f, rows, m, r, dx, row0, n, *counts, float(base),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "routed_mm")
    return out


def routed_mm_rows(q, k, mask, x, base: float = 0.0, row0: int = 0,
                   out=None, *, edges: RoutingEdges = None):
    """Rows row0 .. row0 + R of ``routed_mm``'s output -> [F, R, dx] (into
    ``out`` when given), with no gradient; ``mask`` its rows of the mask,
    ``edges`` their RoutingEdges on the card.  On the card one launch of
    the forward's kernel, counted in ``routed_mm.launches``."""
    _check(q, k, mask, row0, x)
    if not _on_card("routed_mm", q):
        with torch.no_grad():
            return _into(out, routed_mm_plain(q, k, mask, x, base, row0=row0))
    _check_edges("routed_mm", edges, mask, row0, q)
    out = _routed_mm_kernel(q, k, mask, x, base, row0, out, edges)
    routed_mm.launches += 1
    routed_mm.rows += mask.shape[0]
    routed_mm.edges += edges.nnz
    return out


def routed_mm_bwd(q, k, mask_t, g, base: float = 0.0, row0: int = 0,
                  out=None, *, edges: RoutingEdges = None):
    """dx_f = (softmax_F(base + q_f k_f^T) * mask)^T @ g_f -> [F, M, dx]: the
    gradient of ``routed_mm`` in x (JAX ``_routed_mm_bwd``).  q [F, N, r],
    k [F, M, r] are the forward's; mask_t [M, N] is the mask's transpose
    (on the card contiguous, or the mask itself where it is symmetric),
    ``edges`` its RoutingEdges on the card; g [F, N, dx] the output's
    gradient.  Over mask_t's rows row0 .. row0 + R: dx's rows [F, R, dx]
    (into ``out`` when given); a ``MaskShard`` of mask_t gives the whole
    dx, each rank sweeping its rows."""
    if isinstance(mask_t, MaskShard):
        return sweep_gathered(
            mask_t, g, [((g.shape[0],), (g.shape[2],))],
            lambda m, r0, o: routed_mm_bwd(q, k, m, g, base, row0=r0,
                                           out=o, edges=edges))[0]
    _check(k, q, mask_t, row0, g)
    if not _on_card("routed_mm_bwd", q):
        with torch.no_grad():
            return _into(out, routed_mm_plain(k, q, mask_t, g, base,
                                              row0=row0))
    _check_edges("routed_mm_bwd", edges, mask_t, row0, q)
    out = _routed_mm_kernel(k, q, mask_t, g, base, row0, out, edges)
    routed_mm_bwd.launches += 1
    routed_mm_bwd.rows += mask_t.shape[0]
    routed_mm_bwd.edges += edges.nnz
    return out


class _RoutedMM(torch.autograd.Function):
    """routed_mm with JAX's custom VJP: x gets ``routed_mm_bwd`` of the
    output's gradient; q, k, mask and mask_t get none.  ``mask`` and
    ``mask_t`` are tensors or MaskShards, ``edges`` and ``edges_t`` their
    RoutingEdges (all kept on ``ctx``, not saved)."""

    @staticmethod
    def forward(ctx, q, k, mask, x, base, mask_t, edges, edges_t):
        if isinstance(mask, MaskShard):
            out, = sweep_gathered(
                mask, x, [((x.shape[0],), (x.shape[2],))],
                lambda m, r0, o: routed_mm_rows(q, k, m, x, base, row0=r0,
                                                out=o, edges=edges))
        else:
            out = routed_mm_rows(q, k, mask, x, base, edges=edges)
        ctx.save_for_backward(q, k)
        ctx.mask, ctx.mask_t, ctx.base = mask, mask_t, base
        ctx.edges_t = edges_t
        return out

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        mask_t = ctx.mask_t
        if mask_t is None:
            if q.device.type != "cpu" or isinstance(ctx.mask, MaskShard):
                raise ValueError(
                    "routed_mm's backward on the card, or over a rank's "
                    "rows, needs mask_t, the mask's contiguous [M, N] "
                    "transpose (or the mask itself where it is symmetric): "
                    "pass it to routed_mm")
            mask_t = ctx.mask.T  # a view: the plain version reads it back
        if q.device.type != "cpu" and ctx.edges_t is None:
            raise ValueError(
                "routed_mm's backward on the card needs edges_t, the "
                "RoutingEdges of mask_t's rows (the mask's own where it is "
                "symmetric): pass it to routed_mm")
        dx = routed_mm_bwd(q, k, mask_t, g.contiguous(), ctx.base,
                           edges=ctx.edges_t)
        return None, None, None, dx, None, None, None, None


def routed_mm(q, k, mask, x, base: float = 0.0, mask_t=None, *,
              edges: RoutingEdges = None, edges_t: RoutingEdges = None):
    """out_f = (softmax_F(base + q_f k_f^T) * mask) @ x_f -> [F, N, dx].

    Differentiable in x (q, k and the mask are constants, as in JAX); the
    backward on the card needs ``mask_t``, the mask's contiguous [M, N]
    transpose or, for a symmetric mask, the mask itself (build it once).
    On the card the forward sweeps ``edges``, the mask's RoutingEdges, the
    backward ``edges_t``, mask_t's.  ``mask`` and ``mask_t`` may each be a
    ``MaskShard``: the forward then sweeps the rank's rows of the mask, the
    backward those of mask_t, each list holding those rows."""
    _check(q, k, *sweep_rows(mask), x=x)
    if mask_t is not None:
        _check(k, q, *sweep_rows(mask_t))
    # q and k get no gradient (JAX's VJP gives them zeros); detached, they
    # keep autograd from calling a backward whose only way to the loss is
    # through them (DisenGCN's first routing round feeds only the next
    # round's q), which would sweep a zero cotangent
    return _RoutedMM.apply(q.detach(), k.detach(), mask, x, base, mask_t,
                           edges, edges_t)


# launches on the card, and the mask rows and edges they swept
for _fn in (routed_rowsum, routed_mm, routed_mm_bwd):
    _fn.launches = _fn.rows = _fn.edges = 0
