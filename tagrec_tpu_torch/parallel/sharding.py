"""Placement on the (data, model) mesh (tagrec_tpu/parallel/sharding.py).

JAX's rule, exactly (``_shardable``): a parameter whose dim 0 holds at
least 64 rows and divides by the ``model`` axis is row-sharded over
``model``; every other parameter is replicated.  Adam's moments follow
their parameter, since the Adam is built over what each rank holds.

JAX annotates shardings and XLA inserts the collectives.  Here they are
explicit, and the models stay as they are:

* ``shard_params`` (JAX's ``params_sharding`` + ``place``, and the job of
  ``constrain_params``, which pins the layout across steps) registers on
  each shardable parameter a parametrization whose original is this
  rank's row block and whose value is the table all-gathered over
  ``model``.  The layout holds by construction: Adam updates the blocks
  in place.  ``gathered()`` gathers each table once per step.
* The gather's backward is this rank's slice of the incoming gradient,
  not a reduce-scatter sum: the propagation runs whole on every ``model``
  rank, so every one of them computes the same full gradient.
* ``constrain_batch`` (JAX's ``constrain_batch``) is this rank's slice of
  the global batch; ``data_mean_`` averages gradients and loss terms over
  ``data``.
* ``shard_graph`` (JAX's ``gdev_sharding`` + ``place`` of the graph
  tables) goes through one protocol of the model, ``graph_leaves``,
  ``graph_mesh`` and ``place_graph`` (``models.base``).  LightGCN's and
  NGCF's adjacency pair keeps this rank's rows of each table JAX
  row-shards (``ops.ell.shard_rows``), and its SpMM
  computes those rows and all-gathers them over ``model`` once
  (``ops.propagate.sharded_mm``), the partition XLA derives.  On the
  EdgeMap tier every map of the model (DGCF's and DisenGCN's ``em``,
  DisenHAN's six ``ems``, KGAT's ``em`` and ``emk``, TGCN ``ell``'s
  twelve) keeps this rank's rows of each bucket JAX row-shards
  (``ops.edgemap.shard_edge_map``), and KGAT's slot maps ``k2n`` and
  ``n2k`` the rank's rows of their destination map
  (``ops.edgemap.shard_slot_map``): what a primitive returns in row order
  is the rank's rows all-gathered once, and per-slot values that another
  rank reads move by one all-to-all.  TGCN keeps the rank's rows of its
  neighbour tables and dedup buckets (``models.tgcn.TGCN.place_tables``):
  its attention runs on them and one all-gather makes it whole, and one
  all-reduce over ``model`` a relation (``ops.propagate.model_sum``)
  makes its inputs' gradients whole.  The kernel tiers' masks (DGCF's
  and DisenGCN's ``mask``, KGAT's ``fmasks``, and the port's transposes
  ``maskT`` and ``fmasksT`` by the same rule on their own rows) keep this
  rank's rows (``models.base.MaskGraph``): every edge sweep runs on them
  and one all-gather makes its result whole
  (``ops.dense_adj.MaskShard``).  So do the chunked tiers' tables
  (``dense_xla``'s ``mask``, DisenHAN's ``masks.0..5``, the KG's
  ``rel_id``): each chunked function runs its row chunks on the rank's
  rows, one all-gather makes its result whole, and one all-reduce over
  ``model`` (``model_sum``) makes the gradients of the inputs it reads
  whole.  Every graph leaf is then placed as JAX's ``gdev_sharding``
  places it, but the few that stay whole on purpose (ROADMAP.md
  section C).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.parallel.launch import row_block
from tagrec_tpu_torch.parallel.mesh import Mesh

# batch entries kept whole on every rank: DGCF's distance-correlation ids,
# a term that is not a mean over batch rows
WHOLE = ("cor",)


def shardable(shape, mesh: Mesh) -> bool:
    """JAX's ``_shardable``: at least 64 rows, divisible by ``model``."""
    return len(shape) >= 1 and ell_lib.row_sharded(shape[0],
                                                   mesh.shape["model"])


class _GatherRows(torch.autograd.Function):
    """[rows / model, ...] blocks -> the [rows, ...] table on every
    ``model`` rank; backward: this rank's rows of the incoming gradient."""

    @staticmethod
    def forward(ctx, block, gather):
        ctx.rows = (gather.start, gather.stop)
        parts = [torch.empty_like(block)
                 for _ in range(gather.mesh.shape["model"])]
        dist.all_gather(parts, block.contiguous(),
                        group=gather.mesh.group("model"))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.rows
        return grad[start:stop], None


class RowGather(nn.Module):
    """The parametrization of a row-sharded parameter of ``n_rows`` rows:
    original = this rank's rows [start, stop), value = the whole table."""

    def __init__(self, mesh: Mesh, n_rows: int):
        super().__init__()
        self.mesh = mesh
        self.n_rows = n_rows
        self.start, self.stop = row_block(n_rows, mesh)

    def forward(self, block):
        return _GatherRows.apply(block, self)

    def right_inverse(self, table):
        return table[self.start:self.stop].clone()


def jax_name(name: str) -> str:
    """A parameter's name with the parametrization's path taken out:
    ``embed.parametrizations.0.original`` -> ``embed.0``, JAX's leaf
    path."""
    parts = name.split(".")
    if parts[-1] == "original" and "parametrizations" in parts:
        i = parts.index("parametrizations")
        parts = parts[:i] + parts[i + 1:-1]
    return ".".join(parts)


def gathers(model: nn.Module) -> Dict[str, RowGather]:
    """{JAX name: its RowGather} of ``model``'s row-sharded parameters."""
    out = {}
    for prefix, mod in model.named_modules():
        if not parametrize.is_parametrized(mod):
            continue
        for attr, plist in mod.parametrizations.items():
            if isinstance(plist[0], RowGather):
                out[f"{prefix}.{attr}" if prefix else attr] = plist[0]
    return out


def mesh_of(model: nn.Module) -> Optional[Mesh]:
    """The mesh ``model`` is sharded over, or None."""
    gs = gathers(model)
    return next(iter(gs.values())).mesh if gs else None


def full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{JAX name: the whole table's shape} of ``model``'s parameters."""
    gs = gathers(model)
    return {jax_name(n): (tuple(p.shape) if jax_name(n) not in gs else
                          (gs[jax_name(n)].n_rows,) + tuple(p.shape[1:]))
            for n, p in model.named_parameters()}


def value(model: nn.Module, name: str) -> torch.Tensor:
    """The parameter ``name`` (JAX's name) as the model reads it: a
    row-sharded one all-gathered (a collective over ``model``)."""
    owner, _, attr = name.rpartition(".")
    return getattr(model.get_submodule(owner) if owner else model, attr)


def params_sharding(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[str]]:
    """{JAX name: "model" (row-sharded) or None (replicated)} by JAX's
    rule, on the whole tables' shapes."""
    return {name: ("model" if shardable(shape, mesh) else None)
            for name, shape in full_shapes(model).items()}


def gdev_sharding(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[str]]:
    """{graph table: "model" (row-sharded) or None (whole on every rank)},
    as ``shard_graph`` places them, by JAX's rule on JAX's leaf paths: the
    model's ``graph_leaves`` (``models.base.AdjPairGraph``,
    ``EdgeMapGraph``, ``MaskGraph``, TGCN's tables beside its maps).  A
    tier with none of these tables: its buffers by name, every one
    whole."""
    return (model.graph_leaves(mesh)
            or {n: None for n, _ in model.named_buffers()})


def graph_mesh(model: nn.Module) -> Optional[Mesh]:
    """The mesh ``model``'s graph tables are row-sharded over, or None."""
    return model.graph_mesh()


def shard_graph(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[str]]:
    """Put this rank's rows of ``model``'s graph tables on ``mesh``
    (``model.place_graph``: each cut on the host and uploaded to the
    parameters' device after the whole tables are let go) ->
    ``gdev_sharding``.  A model already sharded over ``mesh`` is left as
    it is; one sharded over another mesh raises.  A tier with none of
    these tables keeps its tables whole."""
    have = model.graph_mesh()
    if have is None:
        model.place_graph(mesh)
    elif have is not mesh:
        raise ValueError(f"the graph is sharded over {have}, not {mesh}")
    return gdev_sharding(model, mesh)


def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[str]]:
    """Row-shard ``model``'s shardable parameters over ``mesh`` in place
    (each keeps its Parameter object, now holding this rank's rows) ->
    ``params_sharding``.  A model already sharded over ``mesh`` is left
    as it is; one sharded over another mesh raises."""
    have = mesh_of(model)
    if have is not None:
        if have is not mesh:
            raise ValueError(f"the model is sharded over {have}, not {mesh}")
        return params_sharding(model, mesh)
    spec = params_sharding(model, mesh)
    for name, axis in spec.items():
        if axis is None:
            continue
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        n_rows = getattr(mod, attr).shape[0]
        parametrize.register_parametrization(mod, attr,
                                             RowGather(mesh, n_rows),
                                             unsafe=True)
    return spec


def gathered():
    """Within it, each row-sharded table is all-gathered once and the
    result reused by every read (``parametrize.cached``)."""
    return parametrize.cached()


def constrain_batch(batch, mesh: Mesh, whole=WHOLE):
    """This rank's slice over ``data`` of a global batch (a tensor or a
    dict of them): a tensor whose dim 0 divides by ``data`` is sliced, any
    other, and every entry named in ``whole``, kept whole."""
    d, i = mesh.shape["data"], mesh.index("data")

    def c(x):
        if isinstance(x, dict):
            return {k: (v if k in whole else c(v)) for k, v in x.items()}
        if x.ndim >= 1 and x.shape[0] > 0 and x.shape[0] % d == 0:
            n = x.shape[0] // d
            return x[i * n:(i + 1) * n]
        return x
    return c(batch)


def data_mean_(tensors, mesh: Mesh, axis: str = "data") -> None:
    """In place: each of ``tensors`` its mean over the ``axis`` axis
    (``data`` by default), one all-reduce a dtype.  Over one rank the
    tensors come back unchanged."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.group(axis))
        flat.div_(mesh.shape[axis])
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))

