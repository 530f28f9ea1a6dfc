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
[Ns, Nd] plane, and counts the launch in its ``launches`` attribute (and
the mask rows it swept in ``rows``).  Each
kernel is an edge sweep: stats, the apply and the row backward make one
pass over the mask rows (stats keeps an online max and sum, the others
work P per edge from the stats), the column backward one pass over the
rows of ``mask_t``.  On a CPU tensor it runs the plain PyTorch version
beside it, chunked over rows, and only there: a CUDA tensor never falls
back.

Each sweep also runs over a block of its mask's rows: ``mask`` rows row0
.. row0 + R of the whole (``mask_t``'s for ``dot_bwd_col``: columns row0
.. row0 + R of the attention, each on the side of the global ``split``
where it lies), every other input whole, the [R, ...] results written
into ``out`` when given; the plain versions take the same ``row0``.
Under a mesh KGAT passes ``ops.dense_adj.MaskShard``s, a ``model`` rank's
rows, in place of its masks and transposes: ``dot_flash_stats`` and
``dot_flash_apply`` then sweep the rank's rows and all-gather m and z,
and the output, once each, and the backward sweeps the rank's rows of the
mask (dq2, one all-gather) and of its transpose (dk and dx, one
all-gather; ``ops.dense_adj.sweep_gathered``): no rank holds or gathers
a whole mask.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tagrec_tpu_torch.ops import _build
from tagrec_tpu_torch.ops.dense_adj import (MaskShard, sweep_gathered,
                                             sweep_rows)

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
           mask_t=None, row0: int = 0):
    """Shapes, devices and mask dtypes; ``mask`` [R, Nd] (rows row0 .. row0
    + R of the [Ns, Nd] mask) and ``mask_t`` [R, Ns] (rows row0 .. row0 + R
    of its transpose) are each checked where given; ``split`` against the
    whole Nd columns."""
    if q2.dim() != 3 or q2.shape[0] != 2 or k.dim() != 2:
        raise ValueError(f"q2 {tuple(q2.shape)}, k {tuple(k.shape)} must be "
                         "[2, Ns, dq], [Nd, dq]")
    ns, dq = q2.shape[1], q2.shape[2]
    nd = k.shape[0]
    if k.shape[1] != dq:
        raise ValueError(f"shape mismatch: q2 {tuple(q2.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, mk, width, n in (("mask", mask, nd, ns),
                               ("mask_t", mask_t, ns, nd)):
        if mk is not None and (mk.dim() != 2 or mk.shape[1] != width
                               or not 0 <= row0 <= n - mk.shape[0]):
            raise ValueError(f"shape mismatch: q2 {tuple(q2.shape)}, "
                             f"k {tuple(k.shape)}; {name} {tuple(mk.shape)} "
                             f"must be [{n}, {width}], or its rows from "
                             f"row {row0}")
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
    if ns < 1 or tensors[0].shape[0] < 1 or mask.shape[0] < 1:
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
    failed.  ``args`` are tensors (passed as pointers, each contiguous
    float32 or the int8 mask) then ints."""
    if not all(a.is_contiguous() for a in args[:n_ptr]):
        raise ValueError(f"dot_flash_{name} takes contiguous tensors")
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


def _rows(row0, mask, *ts):
    """Rows row0 .. row0 + R (R = ``mask``'s rows) of each of ``ts`` (q2
    along its second axis)."""
    r = slice(row0, row0 + mask.shape[0])
    return [t[:, r] if t.dim() == 3 else t[r] for t in ts]


def dot_flash_stats_plain(q2, k, mask, split: int, chunk: int = 1024,
                          row0: int = 0):
    """Row max m and sum z of the masked scores in plain PyTorch, over
    ``mask``'s rows row0 .. row0 + R."""
    q2, = _rows(row0, mask, q2)
    ms, zs = [], []
    for i in range(0, q2.shape[1], chunk):
        mv = mask[i:i + chunk].to(torch.float32)
        s = torch.where(mv > 0, _scores(q2, k, split, i, i + chunk), NEG)
        m = torch.clamp(s.max(dim=1).values, min=NEG)
        ms.append(m)
        zs.append(torch.sum(torch.exp(s - m[:, None]) * mv, dim=1))
    return torch.cat(ms), torch.cat(zs)


def dot_flash_apply_plain(q2, k, mask, ms, zs, x, split: int,
                          chunk: int = 1024, row0: int = 0):
    """P @ x in plain PyTorch, over ``mask``'s rows row0 .. row0 + R."""
    q2, ms, zs = _rows(row0, mask, q2, ms, zs)
    return torch.cat([p @ x for _, p in
                      _p_chunks(q2, k, mask, ms, zs, split, chunk)])


def dot_bwd_row_plain(q2, k, mask, ms, zs, x, g, delta, split: int,
                      chunk: int = 1024, row0: int = 0):
    """dq2 [2, R, dq] of the apply's backward in plain PyTorch, over
    ``mask``'s rows row0 .. row0 + R."""
    q2, ms, zs, g, delta = _rows(row0, mask, q2, ms, zs, g, delta)
    out = []
    for i, p in _p_chunks(q2, k, mask, ms, zs, split, chunk):
        j = i + p.shape[0]
        ds = p * (g[i:j] @ x.T - delta[i:j, None])
        out.append(torch.stack([ds[:, :split] @ k[:split],
                                ds[:, split:] @ k[split:]]))
    return torch.cat(out, dim=1)


def dot_bwd_col_plain(q2, k, mask, ms, zs, x, g, delta, split: int,
                      chunk: int = 1024, row0: int = 0):
    """(dk [R, dq], dx [R, dx]) of the apply's backward in plain PyTorch,
    for the attention's columns row0 .. row0 + R; ``mask`` [Ns, R] is the
    mask's columns there (``mask_t``'s rows, transposed)."""
    n = mask.shape[1]
    k, x = k[row0:row0 + n], x[row0:row0 + n]
    split = min(max(split - row0, 0), n)  # the split among these columns
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

def _check_out(name, outs, shapes):
    """Each of ``outs`` float32 of its shape in ``shapes``."""
    for o, want in zip(outs, shapes):
        if tuple(o.shape) != tuple(want) or o.dtype != torch.float32:
            raise ValueError(f"{name}: out {tuple(o.shape)} {o.dtype} must "
                             f"be {list(want)} float32")


def dot_flash_stats(q2, k, mask, split: int, row0: int = 0, out=None):
    """Softmax stats (m [R], z [R]) of the two-segment scores over
    ``mask``'s rows row0 .. row0 + R (into ``out`` = (m, z) when given); a
    ``MaskShard`` gives the whole [Ns] of each, each rank sweeping its
    rows.  The result is a constant for autograd, as under JAX's
    stop_gradient."""
    if isinstance(mask, MaskShard):
        return tuple(sweep_gathered(
            mask, q2, [((), ()), ((), ())],
            lambda m, r0, *o: dot_flash_stats(q2, k, m, split, row0=r0,
                                              out=o)))
    _check(q2, k, mask, split, row0=row0)
    with torch.no_grad():
        if not _on_card("stats", q2, mask, k):
            res = dot_flash_stats_plain(q2, k, mask, split, row0=row0)
            return res if out is None else tuple(
                o.copy_(r) for o, r in zip(out, res))
        rows, dq = mask.shape[0], q2.shape[2]
        if out is None:
            out = (torch.empty(rows, device=q2.device, dtype=torch.float32),
                   torch.empty(rows, device=q2.device, dtype=torch.float32))
        _check_out("stats", out, [(rows,), (rows,)])
        _launch("stats", 5, q2.device, q2, k, mask, *out,
                rows, k.shape[0], dq, split, row0, q2.shape[1])
    dot_flash_stats.launches += 1
    dot_flash_stats.rows += rows
    return out


def _dot_apply(q2, k, mask, ms, zs, x, split, row0: int = 0, out=None):
    """Rows row0 .. row0 + R of P @ x (into ``out``), no gradient."""
    if not _on_card("apply", q2, mask, k, ms, zs, x, dx=x.shape[1]):
        y = dot_flash_apply_plain(q2, k, mask, ms, zs, x, split, row0=row0)
        return y if out is None else out.copy_(y)
    rows, dq = mask.shape[0], q2.shape[2]
    if out is None:
        out = torch.empty((rows, x.shape[1]), device=q2.device,
                          dtype=torch.float32)
    _check_out("apply", [out], [(rows, x.shape[1])])
    _launch("apply", 7, q2.device, q2, k, mask, ms, zs, x, out,
            rows, k.shape[0], dq, x.shape[1], split, row0, q2.shape[1])
    dot_flash_apply.launches += 1
    dot_flash_apply.rows += rows
    return out


def dot_flash_apply_rows(q2, k, mask, ms, zs, x, split: int, row0: int = 0,
                         out=None):
    """Rows row0 .. row0 + R of ``dot_flash_apply``'s output [R, dx] (into
    ``out`` when given), with no gradient; ``mask`` its rows of the mask,
    m and z whole.  On the card one launch, counted in
    ``dot_flash_apply.launches``."""
    _check(q2, k, mask, split, x, ms, zs, row0=row0)
    with torch.no_grad():
        return _dot_apply(q2, k, mask, ms, zs, x, split, row0, out)


def dot_bwd_row(q2, k, mask, ms, zs, x, g, delta, split: int,
                row0: int = 0, out=None):
    """dq2 [2, R, dq] of dot_flash_apply's backward (JAX ``_dot_bwd_row``)
    over ``mask``'s rows row0 .. row0 + R (into ``out`` when given)."""
    _check(q2, k, mask, split, x, ms, zs, g, delta, row0=row0)
    dx = x.shape[1]
    if not _on_card("bwd_row", q2, mask, k, ms, zs, x, g, delta, dx=dx):
        y = dot_bwd_row_plain(q2, k, mask, ms, zs, x, g, delta, split,
                              row0=row0)
        return y if out is None else out.copy_(y)
    rows, dq = mask.shape[0], q2.shape[2]
    if out is None:
        out = torch.empty((2, rows, dq), device=q2.device,
                          dtype=torch.float32)
    _check_out("bwd_row", [out], [(2, rows, dq)])
    _launch("bwd_row", 9, q2.device, q2, k, mask, ms, zs, x, g, delta,
            out, rows, k.shape[0], dq, dx, split, row0, q2.shape[1])
    dot_bwd_row.launches += 1
    dot_bwd_row.rows += rows
    return out


def dot_bwd_col(q2, k, mask_t, ms, zs, x, g, delta, split: int,
                row0: int = 0, out=None):
    """(dk [R, dq], dx [R, dx]) of dot_flash_apply's backward (JAX
    ``_dot_bwd_col``), from rows row0 .. row0 + R of the mask's transpose
    ``mask_t`` (the attention's columns there; into ``out`` = (dk, dx)
    when given)."""
    _check(q2, k, None, split, x, ms, zs, g, delta, mask_t=mask_t, row0=row0)
    dx_w = x.shape[1]
    if not _on_card("bwd_col", q2, mask_t, k, ms, zs, x, g, delta, dx=dx_w):
        res = dot_bwd_col_plain(q2, k, mask_t.T, ms, zs, x, g, delta, split,
                                row0=row0)
        return res if out is None else tuple(
            o.copy_(r) for o, r in zip(out, res))
    rows, dq = mask_t.shape[0], q2.shape[2]
    if out is None:
        out = (torch.empty((rows, dq), device=q2.device, dtype=torch.float32),
               torch.empty((rows, dx_w), device=q2.device,
                           dtype=torch.float32))
    _check_out("bwd_col", out, [(rows, dq), (rows, dx_w)])
    _launch("bwd_col", 10, q2.device, q2, k, mask_t, ms, zs, x, g, delta,
            *out, q2.shape[1], rows, dq, dx_w, split, row0)
    dot_bwd_col.launches += 1
    dot_bwd_col.rows += rows
    return out


class _DotFlashApply(torch.autograd.Function):
    """P @ x with the flash backward of JAX ``_dot_flash_bwd``: delta in
    PyTorch, then the row sweep over mask and the column sweep over mask_t.
    mask, mask_t, ms and zs get no gradient (the stats reparameterize
    softmax(S)).  ``mask`` and ``mask_t`` are tensors or MaskShards (kept
    on ``ctx``, not saved): a MaskShard's rows are swept and the results
    all-gathered whole."""

    @staticmethod
    def forward(ctx, q2, k, mask, ms, zs, x, split, mask_t):
        if isinstance(mask, MaskShard):
            out, = sweep_gathered(
                mask, x, [((), (x.shape[1],))],
                lambda m, r0, o: _dot_apply(q2, k, m, ms, zs, x, split, r0,
                                            o))
        else:
            out = _dot_apply(q2, k, mask, ms, zs, x, split)
        ctx.save_for_backward(q2, k, ms, zs, x, out)
        ctx.split, ctx.mask, ctx.mask_t = split, mask, mask_t
        return out

    @staticmethod
    def backward(ctx, g):
        q2, k, ms, zs, x, out = ctx.saved_tensors
        mask, mask_t, split = ctx.mask, ctx.mask_t, ctx.split
        g = g.contiguous()
        delta = torch.sum(g * out, dim=1)
        args = (ms, zs, x, g, delta, split)
        if isinstance(mask, MaskShard):
            dq2, = sweep_gathered(
                mask, q2, [((2,), (q2.shape[2],))],
                lambda m, r0, o: dot_bwd_row(q2, k, m, *args, row0=r0,
                                             out=o))
        else:
            dq2 = dot_bwd_row(q2, k, mask, *args)
        if mask_t is None:
            if q2.device.type != "cpu" or isinstance(mask, MaskShard):
                raise ValueError(
                    "dot_flash_apply's backward on the card, or over a "
                    "rank's rows, needs mask_t, the mask's contiguous "
                    "[Nd, Ns] int8 transpose (KGAT's fmaskT_* buffers): "
                    "pass it to dot_flash_apply")
            mask_t = mask.T  # a view: the plain version reads it back
        if isinstance(mask_t, MaskShard):
            dk, dx = sweep_gathered(
                mask_t, x, [((), (k.shape[1],)), ((), (x.shape[1],))],
                lambda m, r0, *o: dot_bwd_col(q2, k, m, *args, row0=r0,
                                              out=o))
        else:
            dk, dx = dot_bwd_col(q2, k, mask_t, *args)
        return dq2, dk, None, None, None, dx, None, None


def dot_flash_apply(q2, k, mask, ms, zs, x, split: int, mask_t=None):
    """out = P @ x [Ns, dx], P the masked row softmax of the two-segment
    scores, normalised by the stats of ``dot_flash_stats``.  Differentiable
    in q2, k and x; the backward on the card needs ``mask_t``, the mask's
    contiguous transpose (a constant: build it once).  ``mask`` and
    ``mask_t`` may each be a ``MaskShard``: the forward then sweeps the
    rank's rows of the mask, the backward those of the mask (dq2) and of
    mask_t (dk, dx)."""
    rows, row0 = sweep_rows(mask)
    _check(q2, k, rows, split, x, ms, zs, row0=row0)
    if mask_t is not None:
        rows, row0 = sweep_rows(mask_t)
        _check(q2, k, None, split, x, ms, zs, mask_t=rows, row0=row0)
    return _DotFlashApply.apply(q2, k, mask, ms, zs, x, split, mask_t)


# launches on the card, and the mask rows they swept
dot_flash_stats.launches = dot_flash_stats.rows = 0
dot_flash_apply.launches = dot_flash_apply.rows = 0
dot_bwd_row.launches = dot_bwd_row.rows = 0
dot_bwd_col.launches = dot_bwd_col.rows = 0
