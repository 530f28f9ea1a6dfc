"""Two-segment dot-score flash attention for KGAT's dense mode
(tagrec_tpu/ops/flash_attention.py).

For one row type of KGAT, columns are the concatenation of two padded type
segments.  Columns left of ``split`` score with q plane 0 (the relation to
the first segment), columns right of it with plane 1:

    S[i, j] = q2[0 if j < split else 1][i] . k[j]

and the row softmax over the 0/1 edge mask spans both segments.

* ``dot_flash_stats(q2, k, mask, split)``   -> m, z [Ns]: the row max and sum
* ``dot_flash_apply(q2, k, mask, ms, zs, x, split, mask_t)`` -> P @ x
  [Ns, dx], with ``P = exp(S - max(m, NEG)) * mask / (z == 0 ? 1 : z)``;
  differentiable in q2, k and x (the flash decomposition: ``delta =
  rowsum(g * out)``, then a row sweep over the mask for dq2 and a row sweep
  over its transpose ``mask_t`` for dk and dx).

Shapes: q2 [2, Ns, dq], k [Nd, dq], mask [Ns, Nd] (int8, 0/1), mask_t
[Nd, Ns] (its contiguous transpose, a constant the caller builds once),
x [Nd, dx], m, z [Ns], float32; ``split`` is a column offset (JAX's
``split_j * TILE_J``).  JAX keeps m and z as [Ns/256, 256]; the port keeps
them flat.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/dot_flash_{stats,apply,bwd_row,bwd_col}.cu``), which never writes an
[Ns, Nd] plane, and counts the launch in its ``launches`` attribute.  Each
kernel is an edge sweep: stats, the apply and the row backward make one
pass over the mask rows (stats keeps an online max and sum, the others
work P per edge from the stats), the column backward one pass over the
rows of ``mask_t``.  On a CPU tensor it runs the plain PyTorch version
beside it, chunked over rows, and only there: a CUDA tensor never falls
back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tagrec_tpu_torch.ops import _build

TILE_I = 256   # the model's padding unit (JAX's Pallas tile)
TILE_J = 256
NEG = -1e30

# Limits of the kernels, all edge sweeps (stats, apply and bwd_row over the
# mask, bwd_col over its transpose): rows of q, k, x and g at most 64 wide,
# any split, and mask rows of fewer than 2^24 bytes (csrc/mask_rows.cuh
# packs their columns in 24 bits).
_MAXD, _MAX_COLS = 64, 1 << 24


def _pad_axis(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, pad]
    return F.pad(x, widths)


# ------------------------------------------------------------------ checks

def _check(q2, k, mask, split, x=None, ms=None, zs=None, g=None, delta=None,
           mask_t=None):
    """Shapes, devices and mask dtypes; ``mask`` [Ns, Nd] and ``mask_t``
    [Nd, Ns] are each checked where given."""
    if q2.dim() != 3 or q2.shape[0] != 2 or k.dim() != 2:
        raise ValueError(f"q2 {tuple(q2.shape)}, k {tuple(k.shape)} must be "
                         "[2, Ns, dq], [Nd, dq]")
    ns, dq = q2.shape[1], q2.shape[2]
    nd = k.shape[0]
    for name, mk, want in (("k", k, (nd, dq)), ("mask", mask, (ns, nd)),
                           ("mask_t", mask_t, (nd, ns))):
        if mk is not None and tuple(mk.shape) != want:
            raise ValueError(f"shape mismatch: q2 {tuple(q2.shape)}, "
                             f"k {tuple(k.shape)}; {name} {tuple(mk.shape)} "
                             f"must be {list(want)}")
    if not 0 <= split <= nd:
        raise ValueError(f"split {split} outside the {nd} columns")
    if x is not None and (x.dim() != 2 or x.shape[0] != nd):
        raise ValueError(f"x {tuple(x.shape)} must be [Nd={nd}, dx]")
    for name, t in (("m", ms), ("z", zs), ("delta", delta)):
        if t is not None and tuple(t.shape) != (ns,):
            raise ValueError(f"{name} {tuple(t.shape)} must be [Ns={ns}]")
    if g is not None and tuple(g.shape) != (ns, x.shape[1]):
        raise ValueError(f"g {tuple(g.shape)} must be [Ns={ns}, dx]")
    tensors = [t for t in (q2, k, mask, x, ms, zs, g, delta, mask_t)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the flash attention inputs must lie on one device")
    for name, mk in (("mask", mask), ("mask_t", mask_t)):
        if mk is not None and mk.dtype != torch.int8:
            raise TypeError(f"{name} dtype {mk.dtype}: int8")


def _on_card(name: str, q2, mask, *tensors, dx: int = 0) -> bool:
    """True for CUDA tensors, after checking what the kernel takes; False for
    CPU tensors (the plain version runs); raises on any other device.
    ``mask`` is the mask the kernel reads: mask_t for bwd_col."""
    if q2.device.type == "cpu":
        return False
    if q2.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q2.device}")
    if any(t.dtype != torch.float32 for t in (q2,) + tensors):
        raise TypeError(f"{name} takes float32 q2, k, x, g and stats")
    if not all(t.is_contiguous() for t in (q2, mask) + tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    ns, dq = q2.shape[1], q2.shape[2]
    if ns < 1 or tensors[0].shape[0] < 1:
        raise ValueError(f"{name} needs at least one row and one column")
    if not 1 <= dq <= _MAXD or not 0 <= dx <= _MAXD:
        raise ValueError(f"dq={dq}, dx={dx}: {name} takes widths 1..{_MAXD}")
    if mask.shape[1] >= _MAX_COLS:  # an edge sweep over mask's rows
        raise ValueError(f"{name} takes mask rows of fewer than {_MAX_COLS} "
                         "bytes")
    return True


def _lib(name: str, n_ptr: int, n_int: int):
    lib = _build.load(f"dot_flash_{name}")
    c = getattr(lib, f"dot_flash_{name}_f32")
    if c.argtypes is None:
        c.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        c.restype = ctypes.c_int
        lib.dot_flash_error_string.argtypes = [ctypes.c_int]
        lib.dot_flash_error_string.restype = ctypes.c_char_p
    return lib, c


def _launch(name: str, n_ptr: int, device, *args):
    """Call ``dot_flash_<name>_f32(*args, stream)``; raise if the launch
    failed.  ``args`` are tensors (passed as pointers) then ints."""
    lib, fn = _lib(name, n_ptr, len(args) - n_ptr)
    ptrs = [a.data_ptr() for a in args[:n_ptr]]
    with torch.cuda.device(device):
        err = fn(*ptrs, *args[n_ptr:], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dot_flash_{name} launch failed: "
                           f"{lib.dot_flash_error_string(err).decode()}")


# ------------------------------------------------------------ plain versions

def _scores(q2, k, split, i, j):
    """S for rows i:j: plane 0 against the columns left of ``split``, plane 1
    against the rest."""
    return torch.cat([q2[0, i:j] @ k[:split].T, q2[1, i:j] @ k[split:].T],
                     dim=1)


def _p_chunks(q2, k, mask, ms, zs, split, chunk):
    """(row offset, P) for each chunk of ``chunk`` rows (JAX ``_dot_p``)."""
    for i in range(0, q2.shape[1], chunk):
        j = i + chunk
        mv = mask[i:j].to(torch.float32)
        s = torch.where(mv > 0, _scores(q2, k, split, i, j), NEG)
        z = torch.where(zs[i:j] == 0, 1.0, zs[i:j])
        yield i, (torch.exp(s - torch.clamp(ms[i:j], min=NEG)[:, None]) * mv
                  / z[:, None])


def dot_flash_stats_plain(q2, k, mask, split: int, chunk: int = 1024):
    """Row max m and sum z of the masked scores in plain PyTorch."""
    ms, zs = [], []
    for i in range(0, q2.shape[1], chunk):
        mv = mask[i:i + chunk].to(torch.float32)
        s = torch.where(mv > 0, _scores(q2, k, split, i, i + chunk), NEG)
        m = torch.clamp(s.max(dim=1).values, min=NEG)
        ms.append(m)
        zs.append(torch.sum(torch.exp(s - m[:, None]) * mv, dim=1))
    return torch.cat(ms), torch.cat(zs)


def dot_flash_apply_plain(q2, k, mask, ms, zs, x, split: int,
                          chunk: int = 1024):
    """P @ x in plain PyTorch."""
    return torch.cat([p @ x for _, p in
                      _p_chunks(q2, k, mask, ms, zs, split, chunk)])


def dot_bwd_row_plain(q2, k, mask, ms, zs, x, g, delta, split: int,
                      chunk: int = 1024):
    """dq2 [2, Ns, dq] of the apply's backward in plain PyTorch."""
    out = []
    for i, p in _p_chunks(q2, k, mask, ms, zs, split, chunk):
        j = i + p.shape[0]
        ds = p * (g[i:j] @ x.T - delta[i:j, None])
        out.append(torch.stack([ds[:, :split] @ k[:split],
                                ds[:, split:] @ k[split:]]))
    return torch.cat(out, dim=1)


def dot_bwd_col_plain(q2, k, mask, ms, zs, x, g, delta, split: int,
                      chunk: int = 1024):
    """(dk [Nd, dq], dx [Nd, dx]) of the apply's backward in plain PyTorch."""
    dk = torch.zeros_like(k)
    dx = torch.zeros_like(x)
    for i, p in _p_chunks(q2, k, mask, ms, zs, split, chunk):
        j = i + p.shape[0]
        ds = p * (g[i:j] @ x.T - delta[i:j, None])
        dk[:split] += ds[:, :split].T @ q2[0, i:j]
        dk[split:] += ds[:, split:].T @ q2[1, i:j]
        dx += p.T @ g[i:j]
    return dk, dx


# ------------------------------------------------------------------ wrappers

def dot_flash_stats(q2, k, mask, split: int):
    """Softmax stats (m [Ns], z [Ns]) of the two-segment scores.  The result
    is a constant for autograd, as under JAX's stop_gradient."""
    _check(q2, k, mask, split)
    with torch.no_grad():
        if not _on_card("stats", q2, mask, k):
            return dot_flash_stats_plain(q2, k, mask, split)
        ns, dq = q2.shape[1], q2.shape[2]
        m = torch.empty(ns, device=q2.device, dtype=torch.float32)
        z = torch.empty_like(m)
        _launch("stats", 5, q2.device, q2, k, mask, m, z,
                ns, k.shape[0], dq, split)
    dot_flash_stats.launches += 1
    return m, z


def _dot_apply(q2, k, mask, ms, zs, x, split):
    if not _on_card("apply", q2, mask, k, ms, zs, x, dx=x.shape[1]):
        return dot_flash_apply_plain(q2, k, mask, ms, zs, x, split)
    ns, dq = q2.shape[1], q2.shape[2]
    out = torch.empty((ns, x.shape[1]), device=q2.device, dtype=torch.float32)
    _launch("apply", 7, q2.device, q2, k, mask, ms, zs, x, out,
            ns, k.shape[0], dq, x.shape[1], split)
    dot_flash_apply.launches += 1
    return out


def dot_bwd_row(q2, k, mask, ms, zs, x, g, delta, split: int):
    """dq2 [2, Ns, dq] of dot_flash_apply's backward (JAX ``_dot_bwd_row``)."""
    _check(q2, k, mask, split, x, ms, zs, g, delta)
    dx = x.shape[1]
    if not _on_card("bwd_row", q2, mask, k, ms, zs, x, g, delta, dx=dx):
        return dot_bwd_row_plain(q2, k, mask, ms, zs, x, g, delta, split)
    ns, dq = q2.shape[1], q2.shape[2]
    dq2 = torch.empty_like(q2)
    _launch("bwd_row", 9, q2.device, q2, k, mask, ms, zs, x, g, delta,
            dq2, ns, k.shape[0], dq, dx, split)
    dot_bwd_row.launches += 1
    return dq2


def dot_bwd_col(q2, k, mask_t, ms, zs, x, g, delta, split: int):
    """(dk [Nd, dq], dx [Nd, dx]) of dot_flash_apply's backward (JAX
    ``_dot_bwd_col``), from the mask's transpose ``mask_t`` [Nd, Ns]."""
    _check(q2, k, None, split, x, ms, zs, g, delta, mask_t=mask_t)
    dx_w = x.shape[1]
    if not _on_card("bwd_col", q2, mask_t, k, ms, zs, x, g, delta, dx=dx_w):
        return dot_bwd_col_plain(q2, k, mask_t.T, ms, zs, x, g, delta, split)
    ns, dq = q2.shape[1], q2.shape[2]
    dk = torch.empty_like(k)
    dx = torch.empty_like(x)
    _launch("bwd_col", 10, q2.device, q2, k, mask_t, ms, zs, x, g, delta,
            dk, dx, ns, k.shape[0], dq, dx_w, split)
    dot_bwd_col.launches += 1
    return dk, dx


class _DotFlashApply(torch.autograd.Function):
    """P @ x with the flash backward of JAX ``_dot_flash_bwd``: delta in
    PyTorch, then the row sweep over mask and the column sweep over mask_t.
    mask, mask_t, ms and zs get no gradient (the stats reparameterize
    softmax(S))."""

    @staticmethod
    def forward(ctx, q2, k, mask, ms, zs, x, split, mask_t):
        out = _dot_apply(q2, k, mask, ms, zs, x, split)
        ctx.save_for_backward(q2, k, mask, ms, zs, x, out, mask_t)
        ctx.split = split
        return out

    @staticmethod
    def backward(ctx, g):
        q2, k, mask, ms, zs, x, out, mask_t = ctx.saved_tensors
        g = g.contiguous()
        delta = torch.sum(g * out, dim=1)
        dq2 = dot_bwd_row(q2, k, mask, ms, zs, x, g, delta, ctx.split)
        if mask_t is None:
            if q2.device.type != "cpu":
                raise ValueError(
                    "dot_flash_apply's backward on the card needs mask_t, "
                    "the mask's contiguous [Nd, Ns] int8 transpose (KGAT's "
                    "fmaskT_* buffers): pass it to dot_flash_apply")
            mask_t = mask.T  # a view: the plain version reads it back
        dk, dx = dot_bwd_col(q2, k, mask_t, ms, zs, x, g, delta, ctx.split)
        return dq2, dk, None, None, None, dx, None, None


def dot_flash_apply(q2, k, mask, ms, zs, x, split: int, mask_t=None):
    """out = P @ x [Ns, dx], P the masked row softmax of the two-segment
    scores, normalised by the stats of ``dot_flash_stats``.  Differentiable
    in q2, k and x; the backward on the card needs ``mask_t``, the mask's
    contiguous transpose (a constant: build it once)."""
    _check(q2, k, mask, split, x, ms, zs, mask_t=mask_t)
    return _DotFlashApply.apply(q2, k, mask, ms, zs, x, split, mask_t)


dot_flash_stats.launches = 0
dot_flash_apply.launches = 0
dot_bwd_row.launches = 0
dot_bwd_col.launches = 0
