"""The port's native host runtime: TGCN's neighbour-table sampler
(``runtime/native.cpp``, the port's copy of the ``neighbor_sample`` entry
of tagrec_tpu/runtime/native.cpp), bound with ctypes.

JAX's TGCN draws its tables with its g++-built library whenever that
library loads, and with a numpy loop only when it does not
(tagrec_tpu/runtime/__init__.py ``neighbor_sample_csr``); the two draw
different tables from one seed.  The port keeps the same rule
(``models.tgcn.neighbor_sample_csr``): the library, built here with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``tagrec_tpu_torch/build/`` (rebuilt when the source is newer), and the
numpy loop only when no library loads.  The first draw says, through the
port's logger, which sampler drew the tables.  Host only: nothing here
touches a device, and nothing runs at import.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "native.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
LIB = os.path.join(BUILD, "libtagrec_native.so")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

log = logging.getLogger("tagrec_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None
_said = False


def _build() -> None:
    """Compile SRC into LIB (a temporary name renamed into place, so a
    concurrent loader never sees half a library); raise on failure."""
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libtagrec_native.", suffix=".so",
                               dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing or stale; None when it
    cannot be built or loaded (the first draw's warning says why)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        try:
            if (not os.path.exists(LIB)
                    or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
                _build()
            lib = ctypes.CDLL(LIB)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            _failed = f"{type(e).__name__}: {detail}"
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.neighbor_sample.restype = None
        lib.neighbor_sample.argtypes = [
            i64p, i64p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, i32p, i32p]
        _lib = lib
        return _lib


def sampler() -> str:
    """The sampler TGCN's tables are drawn with here: "native" (the
    library, JAX's default) or "numpy" (the fallback)."""
    return "native" if get_lib() is not None else "numpy"


def _say(name: str) -> None:
    global _said
    if _said:
        return
    _said = True
    if name == "native":
        log.info("TGCN neighbour tables drawn by the native sampler (%s)",
                 LIB)
    else:
        log.warning("TGCN neighbour tables drawn by the numpy fallback: the "
                    "native sampler did not load (%s), so the tables differ "
                    "from those JAX's library draws from the same seed",
                    _failed)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def neighbor_sample(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    k: int, seed: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The native draw of k slots per row, with replacement, from a CSR
    list (int64 ``indptr`` and ``cols``, float32 ``vals``) -> ([n, k]
    neighbour ids + 1, [n, k] weight ids), 0 for a row without neighbours;
    None when the library does not load.  The first call says which
    sampler draws."""
    lib = get_lib()
    _say("native" if lib is not None else "numpy")
    if lib is None:
        return None
    n_rows = len(indptr) - 1
    idx = np.zeros((n_rows, k), dtype=np.int32)
    w = np.zeros((n_rows, k), dtype=np.int32)
    lib.neighbor_sample(_ptr(indptr, ctypes.c_int64),
                        _ptr(cols, ctypes.c_int64),
                        _ptr(vals, ctypes.c_float), n_rows, k, seed,
                        _ptr(idx, ctypes.c_int32), _ptr(w, ctypes.c_int32))
    return idx, w
