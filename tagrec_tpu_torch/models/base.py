"""Shared model utilities: initializers, embedding splits, prediction
(tagrec_tpu/models/base.py)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from tagrec_tpu_torch.ops import edgemap
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.losses import bpr_loss, l2reg_loss


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
