"""DGCF (+tags) (tagrec_tpu/models/dgcf.py).

Intent-disentangled propagation with per-edge factor routing: the dim-64
embeddings split into ``factor_k`` chunks; each layer runs ``iterate_k``
routing iterations of a symmetric, degree-renormalized propagation
D^-1/2 A_f D^-1/2 over the routed adjacency A_f = softmax_F(S) * mask,
detached; the score table S persists across layers.  Final embeddings are
the mean over [ego, layer_1..L].  The loss is BPR on the final tables
plus L2 on the ego rows and, when ``cor_reg`` > 0, the distance
correlation of the factor chunks.

Two tiers, as JAX picks them (``ops.dense_adj.use_dense``):

* dense (a graph within the dense budget): S is the low-rank series
  S_t = 1 + sum_tau U_tau V_tau^T, kept as the lists of update factors.
  Each iteration runs the two routing kernels (``ops.flash_routing``) at
  its true rank over the mask's edge list (built once at set-up), so the
  [F, N, N] adjacency never exists; gradients reach
  the embeddings through ``routed_mm``'s backward (the sweep over the
  mask's transpose).  Under a mesh the mask holds one ``model`` rank's
  rows (JAX's rule), each kernel sweeps them and its result is
  all-gathered once (``ops.dense_adj.MaskShard``).
  ``adj_mode="dense_xla"`` computes the same iterations on the chunked
  dense tier (``ops.dense_adj``) instead; under a mesh over the rank's
  rows of the mask, the degree and the aggregation gathered whole, the
  aggregated x's gradient summed over ``model``.
* EdgeMap (``adj_mode="ell"``, or a graph over the dense budget): S is
  held per degree bucket ([F, Nb, Kb] each); the degree is the per-bucket
  row sums of the routed values (``row_sums``), the aggregation
  ``edge_reduce`` (the ``gather_reduce`` kernel per factor) and the score
  update ``edge_dot`` (``ops.edgemap``).  Under a mesh the map holds one
  ``model`` rank's rows, S only those rows, and the row sums and the
  aggregation come back whole on every rank (``ops.edgemap``).
"""

from __future__ import annotations

import torch
from torch import nn

from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import dense_adj, edgemap, flash_routing, losses
from tagrec_tpu_torch.ops.propagate import l2_normalize


class DGCF(base.RoutingMaskGraph, nn.Module):
    """``embed`` holds the user, item[, tag] tables, drawn from
    ``generator`` (a CPU ``torch.Generator``).  On the dense tier the edge
    mask of the joint graph is a bool buffer [N, N] on ``device``, and
    ``maskT`` its transpose, None where the mask is symmetric (``mask_t``
    is the mask then); on the kernel tier ``mask_hosts`` keeps them on
    the host and, with ``mesh``, both buffers hold the rank's rows, as
    the mask does under ``dense_xla``
    (``models.base.RoutingMaskGraph``); on the EdgeMap tier both are None,
    ``em_hosts`` keeps the joint graph's EdgeMapHost as ``em`` and
    ``edges`` holds its EdgeMap, or with ``mesh`` the rank's rows of it
    (``ops.edgemap.shard_edge_map``, ``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda", mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        use_tag = cfg.use_tag and graph.has_tags
        self.num_list = [graph.n_user, graph.n_item] + (
            [graph.n_tag] if use_tag else [])
        if cfg.dim_latent % cfg.factor_k:
            raise ValueError(f"dim_latent {cfg.dim_latent} is not a multiple "
                             f"of factor_k {cfg.factor_k}")
        self.dim_k = cfg.dim_latent // cfg.factor_k
        coo = graph.joint_norm_adj(cfg.norm_type, use_tag)  # 'plain'
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

    @property
    def tier(self) -> str:
        """The execution tier built: "kernels" (the dense kernel tier),
        "dense_xla" (the chunked dense tier) or "ell" (the EdgeMap tier)."""
        if not self.dense:
            return "ell"
        return "kernels" if self.flash else "dense_xla"

    def _iterate_update_dense(self, state, ego_embed):
        """One layer: ``iterate_k`` routing iterations.  ``state`` is the pair
        of lists (u_list, v_list) of [F, n, dk] update factors; iteration t
        routes at rank t*dk on their concatenation, and iteration 0 (S = 1
        everywhere) at a rank-8 series of zeros."""
        cfg = self.cfg
        u_list, v_list = state
        ego_f = torch.stack(torch.split(ego_embed, self.dim_k, dim=1))
        femb = None
        if self.flash:
            mask, mask_t, edges, edges_t = self.routing_masks()
        else:
            mask = self.sweep_mask("mask")
        for _ in range(cfg.iterate_k):
            if u_list:
                ueff = torch.cat(u_list, dim=2)
                veff = torch.cat(v_list, dim=2)
            else:
                ueff = ego_f.new_zeros((ego_f.shape[0], ego_f.shape[1], 8))
                veff = torch.zeros_like(ueff)
            if self.flash:
                d = flash_routing.routed_rowsum(ueff, veff, mask, base=1.0,
                                                edges=edges)
            else:  # the rank's rows, gathered (no gradient)
                d = self.rows_whole("mask", dense_adj.dgcf_dense_degree(
                    ueff, veff, mask), ax=1)
            # an empty row has degree 0 and gets scale 0, not inf
            dr = torch.where(d > 0, torch.rsqrt(torch.where(d > 0, d, 1.0)),
                             0.0)
            scaled = ego_f * dr[:, :, None]
            if self.flash:
                agg = flash_routing.routed_mm(ueff, veff, mask, scaled,
                                              base=1.0, mask_t=mask_t,
                                              edges=edges, edges_t=edges_t)
            else:  # the rank's rows of A @ x read all of x
                x, = self.mesh_sum(scaled)
                agg = self.rows_whole("mask", dense_adj.dgcf_dense_prop(
                    ueff, veff, mask, x), ax=1)
            femb = dr[:, :, None] * agg
            # score update factors, stored detached (the routed adjacency is
            # detached, so score gradients never reach the loss)
            t_norm = torch.tanh(l2_normalize(ego_f, dim=2))
            h_norm = l2_normalize(femb, dim=2)
            u_list = u_list + [h_norm.detach()]
            v_list = v_list + [t_norm.detach()]
        layer = l2_normalize(femb, dim=2)
        ego_embed = layer.permute(1, 0, 2).reshape(layer.shape[1], -1)
        return (u_list, v_list), ego_embed

    def _iterate_update(self, a_values, ego_embed, em, masks):
        """One layer on the EdgeMap tier: ``iterate_k`` routing iterations
        over the per-bucket score tables ``a_values`` ([F, Nb, Kb] each),
        all factors on the leading axis."""
        ego_f = torch.stack(torch.split(ego_embed, self.dim_k, dim=1))
        femb = None
        for _ in range(self.cfg.iterate_k):
            # softmax over the factors, detached (the routed adjacency)
            a_used = tuple(torch.softmax(av, dim=0).detach() * m[None]
                           for av, m in zip(a_values, masks))
            # each row's degree per factor: per-bucket row sums, row order
            d = edgemap.row_sums(em, a_used)                   # [F, n]
            d = torch.where(d > 0, torch.rsqrt(torch.where(d > 0, d, 1.0)),
                            0.0)
            agg = edgemap.edge_reduce(em, a_used, ego_f * d[:, :, None])
            femb = d[:, :, None] * agg
            # the score update (head = row, tail = ego): it reaches the
            # loss only through the detached routing, so it is not traced
            with torch.no_grad():
                t_norm = torch.tanh(l2_normalize(ego_f, dim=2))
                sc = edgemap.edge_dot(em, l2_normalize(femb, dim=2), t_norm)
                a_values = tuple(av + s for av, s in zip(a_values, sc))
        layer = l2_normalize(femb, dim=2)
        return a_values, layer.permute(1, 0, 2).reshape(layer.shape[1], -1)

    def forward(self):
        """-> (user, item[, tag]) propagated embeddings."""
        ego = torch.cat(list(self.embed), dim=0)
        outs = [ego]
        cur = ego
        if self.dense:
            state = ([], [])
            for _ in range(self.cfg.num_layer):
                state, cur = self._iterate_update_dense(state, cur)
                outs.append(cur)
        else:
            em = self.edges["em"]
            masks = em.masks(ego.dtype)
            state = tuple(ego.new_ones((self.cfg.factor_k,) + i.shape)
                          for i in em.f_idx)
            for _ in range(self.cfg.num_layer):
                state, cur = self._iterate_update(state, cur, em, masks)
                outs.append(cur)
        final = torch.mean(torch.stack(outs, dim=0), dim=0)
        return base.split_nodes(final, self.num_list)

    def bpr_loss(self, batch, *, cor=None, generator=None,
                 training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the ego
        rows -> (loss, reg * l2), and ``cor_reg`` times the distance
        correlation of the factor chunks of the ``cor`` rows ({"user",
        "item"[, "tag"]: ids}) when ``cor_reg`` > 0 and ``cor`` is given.
        DGCF has no dropout: ``generator`` and ``training`` are unused."""
        cfg = self.cfg
        embs = self.forward()
        parts = base.bpr_with_reg(embs[0], embs[1], self.embed[0],
                                  self.embed[1], batch, cfg.mul_loss_func,
                                  cfg.reg)
        if cfg.cor_reg > 0.0 and cor is not None:
            sel = [embs[0][cor["user"]], embs[1][cor["item"]]]
            if "tag" in cor and len(embs) > 2:
                sel.append(embs[2][cor["tag"]])
            chunks = torch.split(torch.cat(sel, dim=0), self.dim_k, dim=1)
            return parts + (cfg.cor_reg * losses.cor_loss(chunks,
                                                          cfg.factor_k),)
        return parts

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores for ``users``."""
        embs = self.forward()
        users = torch.as_tensor(users, device=embs[0].device)
        return base.predict_sigmoid(embs[0][users], embs[1])
