"""Multi-process entry (tagrec_tpu/parallel/launch.py): the process group
from torchrun's environment, the mesh over every rank, which rows of a
row-sharded table or a batch each process holds, and the examples/s
scaling harness.

A rank is one process with one device: ``torchrun --nproc_per_node N``
starts N of them on a host and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  The same code runs
in one process (the tests, one card), where ``initialize`` does nothing.

* ``initialize()``   -- torch.distributed from that environment; a no-op
                        without it or when already initialised
* ``global_mesh()``  -- the (data, model) mesh over every rank
* ``shard_bounds()`` -- the global rows of a row-sharded table a process
                        holds (no process holds the whole table)
* ``materialize_row_sharded()`` -- this rank's block, ``fill`` called for
                        its rows only
* ``batch_bounds()`` -- the rows of the global batch a process steps on
"""

from __future__ import annotations

import inspect
import os
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(backend: Optional[str] = None, *, device="cuda",
               timeout: Optional[timedelta] = None) -> bool:
    """Bring up torch.distributed from torchrun's environment -> whether a
    process group exists.  Without ``RANK`` and ``WORLD_SIZE`` in the
    environment (one process) it does nothing; a second call does nothing.
    ``backend``: NCCL when ``device`` is a card, gloo on the CPU, unless
    named.  Under NCCL the rank takes card ``LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return True


def shutdown() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def is_writer() -> bool:
    """Rank 0 writes what the run writes once (params, metrics, exports)."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def global_mesh(data_parallel: Optional[int] = None,
                model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over every rank of the world; ``model``
    innermost, so a table's all-gathers stay among neighbouring ranks (one
    host's cards) and the gradient's all-reduce crosses hosts once a
    step."""
    n = world_size()
    if data_parallel is None:
        if n % model_parallel:
            raise ValueError(f"{n} ranks do not split into "
                             f"model={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"data={data_parallel} x model={model_parallel} "
                         f"!= {n} ranks")
    return make_mesh(n, data_parallel=data_parallel)


def row_block(n_rows: int, mesh: Mesh, axis: str = "model",
              rank: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of ``rank``'s block of ``n_rows`` rows split evenly
    over ``axis``."""
    size = mesh.shape[axis]
    if n_rows % size:
        raise ValueError(f"{n_rows} rows do not split over {axis}={size}")
    block = n_rows // size
    i = mesh.index(axis, rank)
    return i * block, (i + 1) * block


def shard_bounds(n_rows: int, mesh: Mesh, axis: str = "model",
                 process_index: Optional[int] = None,
                 process_of: Optional[Callable[[int], int]] = None
                 ) -> List[Tuple[int, int]]:
    """Sorted, distinct [start, stop) row ranges of a table row-sharded
    over ``axis`` that process ``process_index`` holds: the blocks of the
    ranks it runs.  ``process_of(rank) -> process`` maps ranks to
    processes (each rank its own by default); the tests use it to simulate
    several ranks a host."""
    if process_of is None:
        process_of = lambda r: r  # noqa: E731
    if process_index is None:
        process_index = process_of(mesh.rank)
    return sorted({row_block(n_rows, mesh, axis, r)
                   for r in range(mesh.size) if process_of(r) == process_index})


def materialize_row_sharded(global_shape: Tuple[int, ...], mesh: Mesh,
                            fill: Callable[[int, int], np.ndarray],
                            axis: str = "model", dtype=np.float32,
                            device="cuda") -> torch.Tensor:
    """This rank's block of a row-sharded table on ``device``:
    ``fill(start, stop)`` returns rows [start, stop), and is called for
    this rank's rows only."""
    start, stop = row_block(global_shape[0], mesh, axis)
    block = np.asarray(fill(start, stop), dtype=dtype)
    want = (stop - start,) + tuple(global_shape[1:])
    if block.shape != want:
        raise ValueError(f"fill({start}, {stop}) gave {block.shape}, "
                         f"expected {want}")
    return torch.as_tensor(block, device=resolve(device))


def batch_bounds(global_batch: int, mesh: Mesh,
                 process_index: Optional[int] = None,
                 process_of: Optional[Callable[[int], int]] = None
                 ) -> List[Tuple[int, int]]:
    """The rows of the [global_batch, ...] batch that a process steps on:
    its ranks' slices over ``data``."""
    return shard_bounds(global_batch, mesh, axis="data",
                        process_index=process_index, process_of=process_of)


def _host_sync(result) -> float:
    """The sum of every float tensor in ``result`` (a tensor, or a tuple,
    list or dict of them), read back to the host: the step has run."""
    if isinstance(result, dict):
        result = list(result.values())
    leaves = result if isinstance(result, (list, tuple)) else [result]
    tot = 0.0
    for leaf in leaves:
        if isinstance(leaf, (list, tuple, dict)):
            tot += _host_sync(leaf)
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            tot += float(leaf.sum())
    if not np.isfinite(tot):
        raise FloatingPointError("non-finite step result in scaling_report")
    return tot


def scaling_report(step_fn, args_fn, mesh_sizes: List[int], batch,
                   reps: int = 3, weak: bool = False) -> Dict[int, float]:
    """Examples/s of ``step_fn`` over meshes of the first n ranks, n in
    ``mesh_sizes`` (all on ``data``).

    ``args_fn(mesh, rep)`` (or ``args_fn(mesh)``, reused) builds a step's
    inputs; each step's float results are read back to the host before
    the next, so the time is the step's.  ``batch``: global examples a
    step, an int (strong scaling), ``batch(n)``, or with ``weak`` the int
    times n.  Every rank of the world calls this (each mesh's groups are
    made by all of them); the ranks of a mesh run it, the others wait at
    the next mesh.  -> {n: examples/s} for the meshes this rank is in."""
    batch_of = batch if callable(batch) else (
        (lambda n: batch * n) if weak else (lambda n: batch))
    takes_rep = len(inspect.signature(args_fn).parameters) >= 2
    out = {}
    for n in mesh_sizes:
        mesh = make_mesh(n)
        if not mesh.member:
            continue
        args = [args_fn(mesh, r) if takes_rep else args_fn(mesh)
                for r in range(reps if takes_rep else 1)]
        _host_sync(step_fn(*args[0]))  # warm-up
        t0 = time.perf_counter()
        for r in range(reps):
            _host_sync(step_fn(*args[r if takes_rep else 0]))
        out[n] = batch_of(n) / ((time.perf_counter() - t0) / reps)
    barrier()
    return out
