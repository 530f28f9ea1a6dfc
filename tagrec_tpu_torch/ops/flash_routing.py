"""Factor-softmax routing for DGCF's and DisenGCN's dense mode
(tagrec_tpu/ops/flash_routing.py).

* ``routed_rowsum(q, k, mask, base)``          d_f[n] = sum_m P_f[n, m]
* ``routed_mm(q, k, mask, x, base, mask_t)``   out_f = P_f @ x_f
* ``routed_mm_bwd(q, k, mask_t, g, base)``     dx_f = P_f^T @ g_f

with P_f = softmax over the F factors of (base + q_f @ k_f^T), times the 0/1
edge mask.  q [F, N, r], k [F, M, r], mask [N, M] (bool or int8), its
transpose mask_t [M, N], x [F, M, dx], g [F, N, dx], all float32.

On a CUDA tensor each wrapper launches its hand-written kernel and counts
the launch in its ``launches`` attribute (and the mask rows it swept in
``rows``): both kernels are edge sweeps
(``csrc/routed_rowsum.cu``, ``csrc/routed_mm.cu``, one per-edge body in
``csrc/routed.cuh``) that stream the mask rows once, work only the mask's
nonzero entries and never write the [F, N, M] plane to device memory.
``routed_mm_bwd`` is the ``routed_mm`` kernel over the rows of mask_t with
q and k swapped, as JAX's ``_routed_mm_bwd`` is ``_mm_call`` over mask.T.
On a CPU tensor each wrapper runs the plain PyTorch version beside it, and
only there: a CUDA tensor never falls back.

Each sweep also runs over a block of rows: ``mask`` rows row0 .. row0 + R
of the whole (q and the results' other inputs whole), the result [F, R,
...] written into ``out`` when given (``routed_rowsum``,
``routed_mm_rows``, ``routed_mm_bwd``; the plain versions take the same
``row0``).  Under a mesh a model passes ``ops.dense_adj.MaskShard``s, a
``model`` rank's rows, in place of its masks: each sweep then runs on the
rank's rows and one all-gather over ``model`` makes its result whole
(``ops.dense_adj.sweep_gathered``), the forward's over the mask's rows,
the backward's over mask_t's, so no rank holds or gathers a whole mask.

``routed_rowsum`` is a constant for autograd (JAX's stop_gradient).
``routed_mm`` is differentiable in x only: the routing weights are
detached, so q, k and the mask get no gradient (JAX gives them zeros), and
its backward is ``routed_mm_bwd``, which on the card needs ``mask_t``.
"""

from __future__ import annotations

import ctypes

import torch

from tagrec_tpu_torch.ops import _build
from tagrec_tpu_torch.ops.dense_adj import (MaskShard, sweep_gathered,
                                             sweep_rows)

# Limits of csrc/routed.cuh (both kernels): one lane of a 4-lane edge group
# per factor, q rows of at most 128 staged in shared memory, 16 accumulators
# a lane (routed_mm's dx), and columns packed in 24 bits of an edge entry.
_MAX_F, _MAX_R, _MAX_DX, _MAX_COLS = 4, 128, 16, 1 << 24


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


def routed_rowsum(q, k, mask, base: float = 0.0, row0: int = 0, out=None):
    """d_f[n] = sum_m (softmax_F(base + q_f k_f^T) * mask)[n, m] -> [F, R]
    over ``mask``'s rows row0 .. row0 + R (into ``out`` when given); a
    ``MaskShard`` gives the whole [F, N], each rank sweeping its rows.

    The result is a constant for autograd, as under JAX's stop_gradient."""
    if isinstance(mask, MaskShard):
        return sweep_gathered(mask, q, [((q.shape[0],), ())], lambda m, r0, o:
                              routed_rowsum(q, k, m, base, row0=r0, out=o))[0]
    _check(q, k, mask, row0)
    if not _on_card("routed_rowsum", q):
        with torch.no_grad():
            return _into(out, routed_rowsum_plain(q, k, mask, base, row0=row0))
    f, n, r = q.shape
    rows, m = mask.shape
    if out is None:
        out = torch.empty((f, rows), device=q.device, dtype=torch.float32)
    _check_kernel_args(q, k, mask, out=out)
    if tuple(out.shape) != (f, rows):
        raise ValueError(f"out {tuple(out.shape)} must be [{f}, {rows}]")
    lib, fn = _lib("routed_rowsum", "routed_rowsum_f32", 4, 6)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 f, rows, m, r, row0, n, float(base),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "routed_rowsum")
    routed_rowsum.launches += 1
    routed_rowsum.rows += rows
    return out


def _routed_mm_kernel(q, k, mask, x, base, row0: int = 0, out=None):
    """One launch of csrc/routed_mm.cu on q's device over ``mask``'s rows
    row0 .. row0 + R -> [F, R, dx] (into ``out``); uncounted."""
    f, n, r = q.shape
    rows, m = mask.shape
    dx = x.shape[2]
    if out is None:
        out = torch.empty((f, rows, dx), device=q.device, dtype=torch.float32)
    _check_kernel_args(q, k, mask, x, out)
    if tuple(out.shape) != (f, rows, dx):
        raise ValueError(f"out {tuple(out.shape)} must be [{f}, {rows}, {dx}]")
    lib, fn = _lib("routed_mm", "routed_mm_f32", 5, 7)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), mask.data_ptr(), x.data_ptr(),
                 out.data_ptr(), f, rows, m, r, dx, row0, n, float(base),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "routed_mm")
    return out


def routed_mm_rows(q, k, mask, x, base: float = 0.0, row0: int = 0,
                   out=None):
    """Rows row0 .. row0 + R of ``routed_mm``'s output -> [F, R, dx] (into
    ``out`` when given), with no gradient; ``mask`` its rows of the mask.
    On the card one launch of the forward's kernel, counted in
    ``routed_mm.launches``."""
    _check(q, k, mask, row0, x)
    if not _on_card("routed_mm", q):
        with torch.no_grad():
            return _into(out, routed_mm_plain(q, k, mask, x, base, row0=row0))
    out = _routed_mm_kernel(q, k, mask, x, base, row0, out)
    routed_mm.launches += 1
    routed_mm.rows += mask.shape[0]
    return out


def routed_mm_bwd(q, k, mask_t, g, base: float = 0.0, row0: int = 0,
                  out=None):
    """dx_f = (softmax_F(base + q_f k_f^T) * mask)^T @ g_f -> [F, M, dx]: the
    gradient of ``routed_mm`` in x (JAX ``_routed_mm_bwd``).  q [F, N, r],
    k [F, M, r] are the forward's; mask_t [M, N] is the mask's transpose
    (on the card contiguous, or the mask itself where it is symmetric);
    g [F, N, dx] the output's gradient.  Over mask_t's rows row0 .. row0 +
    R: dx's rows [F, R, dx] (into ``out`` when given); a ``MaskShard`` of
    mask_t gives the whole dx, each rank sweeping its rows."""
    if isinstance(mask_t, MaskShard):
        return sweep_gathered(
            mask_t, g, [((g.shape[0],), (g.shape[2],))],
            lambda m, r0, o: routed_mm_bwd(q, k, m, g, base, row0=r0,
                                           out=o))[0]
    _check(k, q, mask_t, row0, g)
    if not _on_card("routed_mm_bwd", q):
        with torch.no_grad():
            return _into(out, routed_mm_plain(k, q, mask_t, g, base,
                                              row0=row0))
    out = _routed_mm_kernel(k, q, mask_t, g, base, row0, out)
    routed_mm_bwd.launches += 1
    routed_mm_bwd.rows += mask_t.shape[0]
    return out


class _RoutedMM(torch.autograd.Function):
    """routed_mm with JAX's custom VJP: x gets ``routed_mm_bwd`` of the
    output's gradient; q, k, mask and mask_t get none.  ``mask`` and
    ``mask_t`` are tensors or MaskShards (kept on ``ctx``, not saved)."""

    @staticmethod
    def forward(ctx, q, k, mask, x, base, mask_t):
        if isinstance(mask, MaskShard):
            out, = sweep_gathered(
                mask, x, [((x.shape[0],), (x.shape[2],))],
                lambda m, r0, o: routed_mm_rows(q, k, m, x, base, row0=r0,
                                                out=o))
        else:
            out = routed_mm_rows(q, k, mask, x, base)
        ctx.save_for_backward(q, k)
        ctx.mask, ctx.mask_t, ctx.base = mask, mask_t, base
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
        dx = routed_mm_bwd(q, k, mask_t, g.contiguous(), ctx.base)
        return None, None, None, dx, None, None


def routed_mm(q, k, mask, x, base: float = 0.0, mask_t=None):
    """out_f = (softmax_F(base + q_f k_f^T) * mask) @ x_f -> [F, N, dx].

    Differentiable in x (q, k and the mask are constants, as in JAX); the
    backward on the card needs ``mask_t``, the mask's contiguous [M, N]
    transpose or, for a symmetric mask, the mask itself (build it once).
    ``mask`` and ``mask_t`` may each be a ``MaskShard``: the forward then
    sweeps the rank's rows of the mask, the backward those of mask_t."""
    _check(q, k, *sweep_rows(mask), x=x)
    if mask_t is not None:
        _check(k, q, *sweep_rows(mask_t))
    # q and k get no gradient (JAX's VJP gives them zeros); detached, they
    # keep autograd from calling a backward whose only way to the loss is
    # through them (DisenGCN's first routing round feeds only the next
    # round's q), which would sweep a zero cotangent
    return _RoutedMM.apply(q.detach(), k.detach(), mask, x, base, mask_t)


# launches on the card, and the mask rows they swept
routed_rowsum.launches = routed_rowsum.rows = 0
routed_mm.launches = routed_mm.rows = 0
routed_mm_bwd.launches = routed_mm_bwd.rows = 0
