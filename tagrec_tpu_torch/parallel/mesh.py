"""The (data, model) mesh of ranks (tagrec_tpu/parallel/mesh.py).

A rank is one process and one device.  The mesh lays the first
``data * model`` ranks of the world out as JAX lays its devices,
``reshape(data, model)`` with ``model`` innermost: rank = d * model + m.

* ``data``  -- batch-parallel: every rank draws the whole global batch and
  steps on its slice; gradients and loss terms are averaged over it.
* ``model`` -- node-parallel: embedding-table rows are split over it and
  all-gathered for the propagation.

Once a process group exists, ``make_mesh`` builds the ``data`` and
``model`` subgroups (every rank of the world creates every group, in one
order).  Without one it gives the shape only, for a given rank, so that a
single process can run each rank's share of the math in turn.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("data", "model")


class Mesh:
    """``data`` x ``model`` ranks; ``rank`` is this process's rank in the
    world, ``groups`` its (data, model) process groups (None for a mesh of
    shape only), ``backend`` the world's backend."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: Optional[Tuple] = None,
                 backend: Optional[str] = None):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got {data} x {model}")
        self.data, self.model = data, model
        self.rank = rank
        self.groups = groups
        self.backend = backend

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f"{', ' + self.backend if self.backend else ''})")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def ranks(self) -> np.ndarray:
        """[data, model] ranks, as JAX's ``mesh.devices`` holds devices."""
        return np.arange(self.size).reshape(self.data, self.model)

    @property
    def member(self) -> bool:
        """This process holds a place in the mesh."""
        return self.rank < self.size

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        """The position of ``rank`` (this process's by default) on
        ``axis``."""
        rank = self.rank if rank is None else rank
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside {self}")
        d, m = divmod(rank, self.model)
        return {"data": d, "model": m}[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is outside {self}")
        if self.groups is None:
            raise RuntimeError(f"{self} has no process group: collectives "
                               "need torch.distributed initialised")
        return self.groups[AXES.index(axis)]


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None, *,
              rank: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` ranks (all of the
    world by default), ``data_parallel`` of them on ``data`` (all by
    default, as JAX's ``make_mesh``).

    With torch.distributed initialised every rank of the world must call
    this, in the same order, since each subgroup is created by all of
    them.  Without it the mesh has its shape only, seen from ``rank``
    (0 by default)."""
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else None
    n = n_devices if n_devices is not None else (world or 1)
    if world is not None and n > world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if data_parallel is None:
        data_parallel = n
    if n % data_parallel:
        raise ValueError(f"{n} ranks do not split into data={data_parallel}")
    model = n // data_parallel
    if not live:
        return Mesh(data_parallel, model, rank=rank or 0)
    if rank is not None and rank != dist.get_rank():
        raise ValueError(f"rank {rank} given, but this process is rank "
                         f"{dist.get_rank()}")
    me = dist.get_rank()
    ranks = np.arange(n).reshape(data_parallel, model)
    data_groups = [dist.new_group(ranks[:, m].tolist())
                   for m in range(model)]
    model_groups = [dist.new_group(ranks[d].tolist())
                    for d in range(data_parallel)]
    groups = None
    if me < n:
        d, m = divmod(me, model)
        groups = (data_groups[m], model_groups[d])
    return Mesh(data_parallel, model, rank=me, groups=groups,
                backend=dist.get_backend())
