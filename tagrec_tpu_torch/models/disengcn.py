"""DisenGCN (+tags) (tagrec_tpu/models/disengcn.py).

Neighbourhood routing over factor projections.  Each layer projects the
node table into ``factor_k`` factors through per-factor W and b, the bias
folded into the weight before the product (``x @ (W + b)``), then
LeakyReLU 0.2 and a per-factor L2 normalize.  Then ``iterate_k`` routing
rounds: per edge the factor affinity softmax_F(new_fac_f[n] . fac_f[m]),
detached, routes fac over the edges (``ops.flash_routing.routed_mm``,
base 0), followed by a residual and a normalize.  The factors are
concatenated; the layers chain with no layer mean.  The loss is BPR plus
L2 on the **final** tables.  Gradients reach W, b and the embeddings
through ``routed_mm``'s x (its backward is the sweep over the mask's
transpose) and the residual; the routing weights get none, as in JAX.

``adj_mode="dense_xla"`` routes on the chunked dense tier
(``ops.dense_adj.routed_agg_dense``) instead of the kernel; under a mesh
over the rank's rows of the mask, the aggregation gathered whole and
the routed factors' gradient summed over ``model``.  Past the
dense budget, or under ``adj_mode="ell"``, the routing runs on the
EdgeMap tier (``ops.edgemap``), as JAX picks it: the per-edge affinities
by ``edge_dot``, their factor softmax detached, the aggregation by
``edge_reduce`` (the ``gather_reduce`` kernel per factor); under a mesh
over the rank's rows of the map, the aggregation whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import dense_adj, edgemap, flash_routing
from tagrec_tpu_torch.ops.propagate import l2_normalize, message_dropout


class DisenGCN(base.RoutingMaskGraph, nn.Module):
    """Parameters ``embed.{0,1,2}`` (user, item, tag: the tag table is
    always there, as in the reference) and ``layers.{i}.W``,
    ``layers.{i}.b``, drawn in that order from ``generator`` (a CPU
    ``torch.Generator``), the tree of JAX's params; the edge mask of the
    joint graph is a bool buffer [N, N] on ``device``, and ``maskT`` its
    transpose, None where the mask is symmetric; on the dense tiers
    ``mask_hosts`` keeps them on the host and, with ``mesh``, both
    buffers hold the rank's rows (``models.base.RoutingMaskGraph``: each
    ``routed_mm``, or each ``dense_xla`` aggregation, runs on them and
    all-gathers its result once); on the
    EdgeMap tier both are None, ``em_hosts`` keeps the joint graph's
    EdgeMapHost as ``em`` and ``edges`` holds its EdgeMap, or with
    ``mesh`` the rank's rows of it (``ops.edgemap.shard_edge_map``,
    ``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda", mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        # the reference always takes the tripartite tables here
        self.num_list = [graph.n_user, graph.n_item, graph.n_tag]
        if cfg.dim_latent % cfg.factor_k:
            raise ValueError(f"dim_latent {cfg.dim_latent} is not a multiple "
                             f"of factor_k {cfg.factor_k}")
        self.dim_k = cfg.dim_latent // cfg.factor_k
        coo = graph.joint_norm_adj(cfg.norm_type, cfg.use_tag)  # 'plain'
        self.dense = dense_adj.use_dense(cfg.adj_mode, *coo.shape)
        self.flash = cfg.adj_mode != "dense_xla"
        self.em_hosts = {}
        self.register_buffer("mask", None)
        self.register_buffer("maskT", None)
        if self.dense:
            self.place_routing_masks(coo, mesh, dev)
        else:
            self.em_hosts = {"em": edgemap.build_edge_map(
                coo.row, coo.col, coo.val, *coo.shape)}
            self.edges = edgemap.EdgeMapBuffers(
                edgemap.maps_to_device(self.em_hosts, dev, mesh))
        self.embed = nn.ParameterList(
            base.init_embeddings(self.num_list, cfg.dim_latent, generator, dev))
        # per layer, the per-factor projection W [F, D, dk] and b [F, 1, dk]
        self.layers = nn.ModuleList(nn.ParameterDict({
            "W": base.xavier_uniform((cfg.factor_k, cfg.dim_latent,
                                      self.dim_k), generator, dev),
            "b": base.xavier_uniform((cfg.factor_k, 1, self.dim_k),
                                     generator, dev)})
            for _ in range(cfg.num_layer))

    @property
    def tier(self) -> str:
        """The execution tier built: "kernels" (the dense kernel tier),
        "dense_xla" (the chunked dense tier) or "ell" (the EdgeMap tier)."""
        if not self.dense:
            return "ell"
        return "kernels" if self.flash else "dense_xla"

    def _layer(self, layer, x: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, F * dk]: ``layer``'s projection, then the routing
        rounds."""
        fac = torch.einsum("nd,fdk->fnk", x, layer["W"] + layer["b"])
        fac = F.leaky_relu(fac, negative_slope=0.2)
        # the routing kernel takes contiguous q, k and x
        fac = l2_normalize(fac, dim=2).contiguous()            # [F, N, dk]
        new_fac = fac
        if not self.dense:
            em = self.edges["em"]
            masks = em.masks(fac.dtype)
        elif self.flash:
            mask, mask_t, edges, edges_t = self.routing_masks()
        else:
            mask = self.sweep_mask("mask")
        for _ in range(self.cfg.iterate_k):
            if not self.dense:
                # the affinities reach the loss only through the detached
                # routing weights, so they are not traced
                with torch.no_grad():
                    p = tuple(torch.softmax(s, dim=0) * m for s, m in zip(
                        edgemap.edge_dot(em, new_fac, fac), masks))
                agg = edgemap.edge_reduce(em, p, fac)
            elif self.flash:
                agg = flash_routing.routed_mm(new_fac, fac, mask, fac,
                                              mask_t=mask_t, edges=edges,
                                              edges_t=edges_t)
            else:  # head reaches only the detached routing weights
                tail, = self.mesh_sum(fac)
                agg = self.rows_whole("mask", dense_adj.routed_agg_dense(
                    new_fac, tail, mask), ax=1)
            new_fac = l2_normalize(fac + agg, dim=2)
        return torch.cat(list(new_fac), dim=1)

    def forward(self, *, training: bool = False, generator=None):
        """-> (user, item, tag) final tables; ``generator`` (on the model's
        device) draws the message dropout when ``training``."""
        rates = self.cfg.message_drop_list
        drop = training and any(r > 0 for r in rates)
        x = torch.cat(list(self.embed), dim=0)
        for k, layer in enumerate(self.layers):
            x = self._layer(layer, x)
            if drop:
                x = message_dropout(x, rates[k], generator, training)
        return base.split_nodes(x, self.num_list)

    def bpr_loss(self, batch, *, cor=None, generator=None,
                 training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the
        final rows -> (loss, reg * l2); ``cor`` is unused, as in JAX."""
        embs = self.forward(training=training, generator=generator)
        return base.bpr_with_reg(embs[0], embs[1], embs[0], embs[1], batch,
                                 self.cfg.mul_loss_func, self.cfg.reg)

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores for ``users``."""
        embs = self.forward()
        users = torch.as_tensor(users, device=embs[0].device)
        return base.predict_sigmoid(embs[0][users], embs[1])
