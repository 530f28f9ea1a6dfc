"""Build the hand-written CUDA kernels (``tagrec_tpu_torch/csrc/*.cu``) and load
them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/<name>.so`` with ``nvcc`` for ``sm_90a`` (Hopper).  A library is
built at first use and rebuilt when any source under ``csrc/`` is newer than
it; independent sources compile in parallel (one ``nvcc`` each).  Nothing here
runs at import: this module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: the CUDA toolkit's, else the one on ``PATH``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale ``csrc/<name>.cu`` in parallel; raise with the
    compiler's output if one fails.  Each library is written to a temporary
    name and renamed into place, so a concurrent loader never sees half.
    Returns the compiler's output (ptxas's register and spill report) of
    each library built."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in todo:
        src = os.path.join(CSRC, f"{name}.cu")
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors, reports = [], {}
    for name, tmp, cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode == 0:
            os.replace(tmp, _lib_path(name))
            reports[name] = out
        else:
            os.remove(tmp)
            errors.append(f"{' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(_lib_path(name))
        return _loaded[name]
