"""Row gather and fused ELL gather-reduce (tagrec_tpu/ops/dma_gather.py).

* ``gather_rows(x, idx)``        out[r] = x[idx[r]]
* ``gather_reduce(x, idx, val)`` out[n] = sum_k val[n, k] * x[idx[n, k]]

x [M, D] float32, idx int32 ([R] or [N, K]) with every id in [0, M),
val [N, K] float32; pad slots of an ELL table hold id 0 and value 0.  Both
are forward only: ``ops.propagate.pair_spmm`` runs the backward of an SpMM
as another SpMM over the transpose tables.

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
# up to 128.  Rows wider than WIDE_K slots take one block each instead of
# one warp.
_MAX_D = 128
WIDE_K = 256
# Budget of the plain gather_reduce's [rows, K, D] intermediate: rows are
# taken in chunks that fit it (JAX's ELL_GATHER_BUDGET_BYTES).
GATHER_BUDGET_BYTES = 1 << 30


def _check(name, x, idx, val=None):
    want = 1 if val is None else 2
    if x.dim() != 2 or idx.dim() != want:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [M, D] and idx "
                         f"{tuple(idx.shape)} {'[R]' if want == 1 else '[N, K]'}")
    if val is not None and val.shape != idx.shape:
        raise ValueError(f"{name}: val {tuple(val.shape)} must match idx "
                         f"{tuple(idx.shape)}")
    tensors = [t for t in (x, idx, val) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: x, idx and val must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward only (the backward of an SpMM is an SpMM "
            "over the transpose, ops.propagate.pair_spmm): call it under "
            "torch.no_grad()")


def _on_card(name, x, idx, val=None) -> bool:
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
    if not all(t.is_contiguous() for t in (x, idx, val) if t is not None):
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
    ``args`` are tensors (passed as pointers) then ints."""
    lib, fn = _lib(name, len(args) - n_ptr, n_ptr)
    ptrs = [a.data_ptr() for a in args[:n_ptr]]
    with torch.cuda.device(device):
        err = fn(*ptrs, *args[n_ptr:], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gather_error_string(err).decode()}")


# ------------------------------------------------------------ plain versions

def gather_rows_plain(x, idx):
    """x[idx] in plain PyTorch."""
    return x[idx.long()]


def gather_reduce_plain(x, idx, val, budget: int = GATHER_BUDGET_BYTES):
    """einsum("nk,nkd->nd", val, x[idx]) in plain PyTorch, over row chunks
    whose [rows, K, D] gather fits ``budget`` bytes."""
    n, k = idx.shape
    d = x.shape[1]
    chunk = max(budget // max(k * d * x.element_size(), 1) // 8 * 8, 8)
    if n <= chunk:
        return torch.einsum("nk,nkd->nd", val, x[idx.long()])
    return torch.cat([
        torch.einsum("nk,nkd->nd", val[i:i + chunk], x[idx[i:i + chunk].long()])
        for i in range(0, n, chunk)])


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


def gather_reduce(x, idx, val):
    """out[n] = sum_k val[n, k] * x[idx[n, k]] -> [N, D]; ids must lie in
    [0, M), pad slots hold value 0."""
    _check("gather_reduce", x, idx, val)
    if not _on_card("gather_reduce", x, idx, val):
        return gather_reduce_plain(x, idx, val)
    n, k = idx.shape
    out = torch.empty((n, x.shape[1]), device=x.device, dtype=torch.float32)
    if n:
        _launch("gather_reduce", 4, x.device, x, idx, val, out, n, k,
                x.shape[1], int(k > WIDE_K))
        gather_reduce.launches += 1
    return out


gather_rows.launches = 0
gather_reduce.launches = 0
