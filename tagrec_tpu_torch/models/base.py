"""Shared model utilities: initializers, embedding splits, prediction
(tagrec_tpu/models/base.py)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tagrec_tpu_torch.ops import dense_adj, edgemap, flash_routing
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.losses import bpr_loss, l2reg_loss
from tagrec_tpu_torch.ops.propagate import RankRows, model_sum


def _fan_in_out(shape: Sequence[int]):
    """torch.nn.init._calculate_fan_in_and_fan_out semantics: for an
    N-d tensor, receptive = prod(shape[2:]), fan_in = shape[1]*receptive,
    fan_out = shape[0]*receptive."""
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
    fan_out = shape[0] * receptive
    return fan_in, fan_out


def xavier_uniform(shape: Sequence[int], generator: torch.Generator,
                   device) -> torch.Tensor:
    """Xavier/Glorot uniform matching torch.nn.init.xavier_uniform_.  Drawn
    on the CPU from ``generator``, then moved, so one seed gives the same
    weights on every device."""
    fan_in, fan_out = _fan_in_out(shape)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(tuple(shape), dtype=torch.float32)
    w.uniform_(-a, a, generator=generator)
    return w.to(device)


def init_embeddings(num_list: Sequence[int], dim: int,
                    generator: torch.Generator, device) -> List[torch.Tensor]:
    return [xavier_uniform((n, dim), generator, device) for n in num_list]


def split_nodes(x: torch.Tensor, num_list: Sequence[int]):
    """Split a stacked [sum(num_list), D] node matrix back into per-type
    parts."""
    return tuple(torch.split(x, list(num_list), dim=0))


def predict_sigmoid(user_emb_sel: torch.Tensor,
                    item_emb: torch.Tensor) -> torch.Tensor:
    """sigmoid(U_sel @ I^T) — the shared predict_rating surface."""
    return torch.sigmoid(user_emb_sel @ item_emb.T)


def bpr_with_reg(u_all, i_all, u_reg_src, i_reg_src, batch, loss_kind: str,
                 reg: float):
    """BPR on the propagated tables plus ``reg`` times the L2 term on the
    given regularization source, for a [B, 3] (user, pos, neg) batch ->
    (loss, reg term)."""
    users, pos, neg = batch[:, 0], batch[:, 1], batch[:, 2]
    loss = bpr_loss(u_all[users], i_all[pos], i_all[neg], loss_kind)
    return loss, reg * l2reg_loss(u_reg_src[users], i_reg_src[pos],
                                  i_reg_src[neg])


# --------------------------------------------- graph tables on a mesh
# The protocol ``parallel.sharding`` places a model's graph through:
# ``graph_leaves(mesh)`` -> {JAX's leaf path: "model" (row-sharded) or None
# (whole on every rank)} in JAX's leaf order, empty where the tier holds no
# such tables; ``graph_mesh()`` -> the mesh the tables are row-sharded
# over, or None; ``place_graph(mesh)`` puts this rank's rows in place, cut
# on the host before the upload, the whole tables let go first.


def rule_leaves(found, whole, mesh) -> Dict[str, Optional[str]]:
    """JAX's ``gdev_sharding`` rule over [(leaf path, host array)]: a leaf
    of 64 rows or more that divide by ``model`` row-shards, but a path
    ending in one of ``whole``."""
    m = mesh.shape["model"]
    return {path: ("model" if not path.endswith(whole) and len(a.shape) >= 1
                   and ell_lib.row_sharded(a.shape[0], m) else None)
            for path, a in found}


class AdjPairGraph:
    """The protocol for a model whose graph is an adjacency pair:
    ``adj_host`` on the host, ``adj`` on the device (LightGCN, NGCF).  Its
    leaves ``adj.fwd.ell.parts.0.idx``, ``adj.fwd.dense_block``,
    ``adj.fwd.0`` ..., but ``inv_perm`` and ``dense_cols`` whole
    (``ell.WHOLE_LEAVES``); the rank's rows by ``ell.shard_rows``."""

    def graph_leaves(self, mesh) -> Dict[str, Optional[str]]:
        return rule_leaves(ell_lib.leaves(self.adj_host),
                           ell_lib.WHOLE_LEAVES, mesh)

    def graph_mesh(self):
        fwd = self.adj.fwd
        return fwd.mesh if isinstance(fwd, ell_lib.RowShard) else None

    def place_graph(self, mesh) -> None:
        device = next(self.parameters()).device
        self.adj = None
        self.adj = ell_lib.to_device(ell_lib.shard_rows(self.adj_host, mesh),
                                     device)


class EdgeMapGraph:
    """The protocol for a model whose graph is EdgeMaps and slot maps:
    ``em_hosts`` ({JAX's leaf prefix: EdgeMapHost or SlotMapHost}, empty
    on the other tiers) on the host, ``edges`` on the device (DGCF,
    DisenGCN, DisenHAN, KGAT, TGCN ``ell``).  Its leaves each map's
    ``<prefix>.f_idx.0`` ... ``<prefix>.b_src.*`` and each slot map's
    ``<prefix>.0`` ..., but ``f_inv`` and ``b_inv`` whole
    (``edgemap.WHOLE_LEAVES``); JAX's ``masks.*`` are not stored (each rank
    computes its rows of them from its ``deg``).  The rank's rows by
    ``edgemap.maps_to_device``."""

    def graph_leaves(self, mesh) -> Dict[str, Optional[str]]:
        return rule_leaves(edgemap.host_leaves(self.em_hosts),
                           edgemap.WHOLE_LEAVES, mesh)

    def graph_mesh(self):
        if not self.em_hosts:
            return None
        em = self.edges[next(iter(self.em_hosts))]
        return em.mesh if isinstance(em, edgemap.EdgeMapShard) else None

    def place_graph(self, mesh) -> None:
        if self.em_hosts:
            device = next(self.parameters()).device
            self.edges = None
            self.edges = edgemap.EdgeMapBuffers(
                edgemap.maps_to_device(self.em_hosts, device, mesh))


class MaskGraph(EdgeMapGraph):
    """The protocol for a model whose graph is dense masks: the kernel
    tiers' (DGCF, DisenGCN, KGAT ``bi_inter``) and the chunked tiers'
    (``dense_xla``'s ``mask``, DisenHAN's ``masks.0..5``, the KG's
    ``rel_id``): ``mask_hosts`` [(leaf path, buffer name, host mask,
    transposed)] on the host, the buffers on the device; the other tiers
    (``mask_hosts`` empty) are placed as an ``EdgeMapGraph``.  Its leaves
    are JAX's (``mask``; ``fmasks.0`` ...), then the port's contiguous
    transposes (``maskT``; ``fmasksT.0`` ...), each by JAX's rule on its
    own rows; a transposed entry's buffer holds rows of the host mask's
    transpose, cut from its columns.  ``sweep_mask(name)`` is what the
    sweeps and the chunked functions take: the buffer, or the
    ``ops.dense_adj.MaskShard`` of the rank's rows where the mesh cuts
    it; a chunked function's rows are made whole by ``rows_whole``, its
    inputs' gradients by ``mesh_sum``."""

    mask_hosts = ()
    masks_mesh = None

    def graph_leaves(self, mesh) -> Dict[str, Optional[str]]:
        if not self.mask_hosts:
            return super().graph_leaves(mesh)
        return rule_leaves([(path, host.T if t else host)
                            for path, _, host, t in self.mask_hosts], (), mesh)

    def graph_mesh(self):
        return self.masks_mesh if self.mask_hosts else super().graph_mesh()

    def place_graph(self, mesh) -> None:
        if self.mask_hosts:
            self.place_masks(mesh)
        else:
            super().place_graph(mesh)

    def place_masks(self, mesh=None, device=None) -> None:
        """The masks as buffers on ``device`` (the parameters' by
        default): whole, or the rows ``mesh``'s rank holds of each that
        JAX's rule cuts, cut on the host before the upload, the whole
        buffers let go first."""
        device = device or next(self.parameters()).device
        for _, name, _, _ in self.mask_hosts:
            self._buffers[name] = None
        self.mask_blocks = {}
        for _, name, host, t in self.mask_hosts:
            blk = dense_adj.mask_block(host.shape[1 if t else 0], mesh)
            self.register_buffer(name, torch.from_numpy(
                dense_adj.cut_mask(host, blk, t)).to(device))
            self.mask_blocks[name] = blk
        self.masks_mesh = mesh

    def sweep_mask(self, name: str):
        """The buffer ``name``, or the MaskShard of its rows where the
        mesh cuts it."""
        mask = getattr(self, name)
        blk = self.mask_blocks.get(name)
        if blk is None:
            return mask
        return dense_adj.MaskShard(
            mask, blk[0], blk[1],
            mask.shape[0] * self.masks_mesh.shape["model"], self.masks_mesh)

    def rows_whole(self, name: str, out: torch.Tensor,
                   ax: int = 0) -> torch.Tensor:
        """``out``, a chunked function's rows over ``sweep_mask(name)``
        (on axis ``ax``), whole on every rank: under a mesh one all-gather
        of the rank's rows, a whole mask's result back-propagated on
        ``model`` rank 0 only (``propagate.RankRows`` of one piece)."""
        if self.masks_mesh is None:
            return out
        return RankRows.apply((self.masks_mesh, [self.mask_blocks[name]],
                               None, [None], ax), out)

    def mesh_sum(self, *xs) -> tuple:
        """``xs`` as they are; under a mesh their gradients summed over
        ``model`` in one all-reduce (``propagate.model_sum``): the inputs
        a chunked function reads whole on a rank's rows."""
        if self.masks_mesh is None:
            return xs
        return model_sum(self.masks_mesh, *xs)

    def mask_nbytes(self) -> int:
        """Bytes of the masks the model holds on its device."""
        return sum(getattr(self, name).numel()
                   * getattr(self, name).element_size()
                   for _, name, _, _ in self.mask_hosts)


class RoutingMaskGraph(MaskGraph):
    """``MaskGraph`` for DGCF's and DisenGCN's dense tiers: the joint
    graph's bool edge mask ``mask`` [N, N] and ``maskT``, its contiguous
    transpose, None where the mask is symmetric or under ``dense_xla``
    (both None on the EdgeMap tier).  On the kernel tier ``edge_coords``
    keeps the coordinates the masks came from and ``routing_edges`` each
    placed mask's ``ops.flash_routing.RoutingEdges``, built from them over
    the rows its buffer holds: what the routing kernels sweep."""

    edge_coords = None

    def place_routing_masks(self, coo, mesh, device) -> None:
        """``mask`` (and ``maskT``) of ``coo`` built on the host, placed by
        ``place_masks``, the rank's rows with ``mesh``; under ``dense_xla``
        no transpose (the chunked tier's backward is autograd's) and no
        edge list."""
        mask = dense_adj.dense_mask_host(coo.row, coo.col, *coo.shape)
        own_t = self.flash and not np.array_equal(mask, mask.T)
        self.mask_hosts = (("mask", "mask", mask, False),) + (
            (("maskT", "maskT", mask, True),) if own_t else ())
        self.edge_coords = ((coo.row, coo.col, coo.shape) if self.flash
                            else None)
        self.place_masks(mesh, device)

    def place_masks(self, mesh=None, device=None) -> None:
        """``MaskGraph.place_masks``, then on the kernel tier each placed
        mask's edge list over the rows its buffer holds, uploaded beside
        it."""
        super().place_masks(mesh, device)
        self.routing_edges = {}
        if self.edge_coords is not None:
            for _, name, _, t in self.mask_hosts:
                self.routing_edges[name] = flash_routing.coo_edges(
                    *self.edge_coords, self.mask_blocks[name], t,
                    getattr(self, name).device)

    @property
    def mask_t(self):
        """What ``routed_mm``'s backward sweeps: the mask's transpose."""
        return self.mask if self.maskT is None else self.maskT

    def routing_masks(self):
        """What the routing kernels sweep: the mask and its transpose for
        ``routed_mm``'s backward (``sweep_mask``), then their edge lists."""
        t = "mask" if self.maskT is None else "maskT"
        return (self.sweep_mask("mask"), self.sweep_mask(t),
                self.routing_edges["mask"], self.routing_edges[t])
