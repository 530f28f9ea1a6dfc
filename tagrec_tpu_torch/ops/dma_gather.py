"""Row gather and fused ELL gather-reduce (tagrec_tpu/ops/dma_gather.py).

* ``gather_rows(x, idx)``             out[r] = x[idx[r]]
* ``gather_reduce(x, idx, val, deg)`` out[n] = sum_k val[n, k] * x[idx[n, k]]
  over k < deg[n], or over every k without ``deg``

x [M, D] float32, idx int32 ([R] or [N, K]) with every id in [0, M),
val [N, K] float32, deg [N] int32; pad slots of an ELL table hold id 0 and
value 0, after the row's deg edges (``ops.ell.build_ell``).  Without deg a
pad may sit anywhere and is summed like any slot, as JAX's kernel does;
with it the pads are never read, so a non-finite row of x reaches only the
rows that have it as a real neighbour.  Both are forward only:
``ops.propagate.pair_spmm`` runs the backward of an SpMM as another SpMM
over the transpose tables.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/gather_rows.cu``, ``csrc/gather_reduce.cu``) and counts the launch
in its ``launches`` attribute.  On a CPU tensor it runs the plain PyTorch
version beside it, and only there: a CUDA tensor never falls back.  The
TPU kernels' lane padding and id-table chunking belong to the TPU's scalar
memory and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from tagrec_tpu_torch.ops import _build

# Limits of the kernels: rows of D floats as D/4 float4 lanes, so D a
# multiple of 4 and x on a 16-byte boundary; csrc/gather_reduce.cu takes D
# up to 128.  Rows wider than WIDE_K slots take a block of 8 warps for every
# SPAN slots instead of one warp.
_MAX_D = 128
WIDE_K = 256
SPAN = 2048
# Budget of the plain gather_reduce's [rows, K, D] intermediate: rows are
# taken in chunks that fit it (JAX's ELL_GATHER_BUDGET_BYTES).
GATHER_BUDGET_BYTES = 1 << 30


def _check(name, x, idx, val=None, deg=None):
    want = 1 if val is None else 2
    if x.dim() != 2 or idx.dim() != want:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [M, D] and idx "
                         f"{tuple(idx.shape)} {'[R]' if want == 1 else '[N, K]'}")
    if val is not None and val.shape != idx.shape:
        raise ValueError(f"{name}: val {tuple(val.shape)} must match idx "
                         f"{tuple(idx.shape)}")
    if deg is not None and tuple(deg.shape) != (idx.shape[0],):
        raise ValueError(f"{name}: deg {tuple(deg.shape)} must be "
                         f"[N={idx.shape[0]}]")
    if deg is not None and deg.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 deg, not {deg.dtype}")
    tensors = [t for t in (x, idx, val, deg) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: x, idx, val and deg must lie on one "
                         "device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward only (the backward of an SpMM is an SpMM "
            "over the transpose, ops.propagate.pair_spmm): call it under "
            "torch.no_grad()")


def _on_card(name, x, idx, val=None, deg=None) -> bool:
    """True for CUDA tensors, after checking what the kernel takes; False
    for CPU tensors (the plain version runs); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32 or (val is not None
                                    and val.dtype != torch.float32):
        raise TypeError(f"{name} takes float32 x and val")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 ids, not {idx.dtype}")
    if not all(t.is_contiguous() for t in (x, idx, val, deg)
               if t is not None):
        raise ValueError(f"{name} takes contiguous tensors")
    d = x.shape[1]
    if d % 4 or (val is not None and not 4 <= d <= _MAX_D):
        raise ValueError(f"{name} takes rows of a multiple of 4 floats"
                         + (f", 4 to {_MAX_D}" if val is not None else "")
                         + f", not {d}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} takes x on a 16-byte boundary")
    return True


def _lib(name: str, n_int: int, n_ptr: int):
    lib = _build.load(name)
    c = getattr(lib, f"{name}_f32")
    if c.argtypes is None:
        c.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        c.restype = ctypes.c_int
        lib.gather_error_string.argtypes = [ctypes.c_int]
        lib.gather_error_string.restype = ctypes.c_char_p
    return lib, c


def _launch(name: str, n_ptr: int, device, *args):
    """Call ``<name>_f32(*args, stream)``; raise if the launch failed.
    ``args`` are tensors or None (passed as pointers, None as null) then
    ints."""
    lib, fn = _lib(name, len(args) - n_ptr, n_ptr)
    ptrs = [None if a is None else a.data_ptr() for a in args[:n_ptr]]
    with torch.cuda.device(device):
        err = fn(*ptrs, *args[n_ptr:], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gather_error_string(err).decode()}")


# ------------------------------------------------------------ plain versions

def gather_rows_plain(x, idx):
    """x[idx] in plain PyTorch."""
    return x[idx.long()]


def gather_reduce_plain(x, idx, val, deg=None,
                        budget: int = GATHER_BUDGET_BYTES):
    """einsum("nk,nkd->nd", val, x[idx]) in plain PyTorch, over row chunks
    whose [rows, K, D] gather fits ``budget`` bytes.  With ``deg``, the
    slots k >= deg[n] are taken out of the gathered rows and values by
    ``where``, not multiplied by 0, so that a non-finite x or val there does
    not reach the row, as in the kernel, which never reads them."""
    n, k = idx.shape
    d = x.shape[1]
    chunk = max(budget // max(k * d * x.element_size(), 1) // 8 * 8, 8)

    def part(i):
        v, rows = val[i:i + chunk], x[idx[i:i + chunk].long()]
        if deg is not None:
            keep = (torch.arange(k, device=idx.device)[None, :]
                    < deg[i:i + chunk, None])
            v = torch.where(keep, v, 0.0)
            rows = torch.where(keep[:, :, None], rows, 0.0)
        return torch.einsum("nk,nkd->nd", v, rows)

    if n <= chunk:
        return part(0)
    return torch.cat([part(i) for i in range(0, n, chunk)])


# ------------------------------------------------------------------ wrappers

def gather_rows(x, idx):
    """out[r] = x[idx[r]] -> [R, D]; ids must lie in [0, M)."""
    _check("gather_rows", x, idx)
    if not _on_card("gather_rows", x, idx):
        return gather_rows_plain(x, idx)
    out = torch.empty((idx.shape[0], x.shape[1]), device=x.device,
                      dtype=torch.float32)
    if out.numel():
        _launch("gather_rows", 3, x.device, x, idx, out, idx.shape[0],
                x.shape[1])
        gather_rows.launches += 1
    return out


def gather_reduce(x, idx, val, deg=None, out=None):
    """out[n] = sum_k val[n, k] * x[idx[n, k]] -> [N, D] over the slots
    k < deg[n] (``deg`` [N] int32, the ELL rows' degrees), or over every
    slot without it; ids must lie in [0, M), pad slots hold value 0.
    ``out``: an optional contiguous float32 [N, D] tensor on x's device
    that receives the rows (a slice of a larger buffer)."""
    _check("gather_reduce", x, idx, val, deg)
    n, k = idx.shape
    d = x.shape[1]
    if out is not None and (tuple(out.shape) != (n, d) or not
                            out.is_contiguous() or out.dtype != torch.float32
                            or out.device != x.device):
        raise ValueError(f"gather_reduce: out must be a contiguous float32 "
                         f"[{n}, {d}] tensor on {x.device}")
    if not _on_card("gather_reduce", x, idx, val, deg):
        rows = gather_reduce_plain(x, idx, val, deg)
        return rows if out is None else out.copy_(rows)
    if out is None:
        out = torch.empty((n, d), device=x.device, dtype=torch.float32)
    if n:
        span = SPAN if k > WIDE_K else 0
        blocks = -(-k // span) if span else 1
        # a row split across blocks leaves its partial sums and a count
        part = count = None
        if blocks > 1:
            part = torch.empty((n, blocks, d), device=x.device,
                               dtype=torch.float32)
            count = torch.zeros(n, device=x.device, dtype=torch.int32)
        _launch("gather_reduce", 7, x.device, x, idx, val, deg, out, part,
                count, n, k, d, span)
        gather_reduce.launches += 1
    return out


gather_rows.launches = 0
gather_reduce.launches = 0
