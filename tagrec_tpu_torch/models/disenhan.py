"""DisenHAN: disentangled attention over six typed relations
(tagrec_tpu/models/disenhan.py).

* relations [ui, iu, ut, tu, it, ti] with local per-type ids (source and
  destination types ``REL_TYPES``)
* per layer: per node type and factor the projection Wtk [3, F, d, dk]
  (no bias), LeakyReLU 0.2 and a per-factor L2 normalize
* two routing rounds (hard-coded, as in the reference): per relation the
  separable edge score e = ReLU(head(src) + tail(dst)) summed over the
  factors with the relation-factor distribution r, row-softmaxed over each
  source's edges, the destination factors aggregated
  (``ops.dense_adj.disenhan_dense_rela``), LeakyReLU, the shared W, and a
  new r = softmax_F(tanh(z) . q_rela)
* per node type the sum over its incident relations (u <- ui, ut;
  i <- iu, it; t <- tu, ti) with the layer's static projections as the
  residual, then a normalize; factors concatenated; layers chained
* quirk #7: r starts uniform (1 / F) at every forward
* BPR (softplus) plus L2 on the final tables

Two tiers, as JAX picks them (``ops.dense_adj.use_dense``): within the
dense budget each relation is a rectangular bool edge mask
(``ops.dense_adj.disenhan_dense_rela``; under a mesh each mask JAX's
rule cuts holds the rank's source rows, the relation's aggregation runs
on them and is gathered whole once, a whole mask's back-propagated on
``model`` rank 0 only, and its inputs' gradients are summed over
``model``); under ``adj_mode="ell"``, or past
the budget, each relation is an EdgeMap (``ops.edgemap``): the separable
scores from ``rows_gather`` and ``edge_gather``, ``edge_softmax`` over each
source's edges, and ``edge_reduce`` (the ``gather_reduce`` kernel per
factor) over the probabilities broadcast to the factors.  Under a mesh
each map holds one ``model`` rank's rows (``ops.edgemap.shard_edge_map``):
the scores and the softmax over the rank's slots, every row-ordered
result (``edge_reduce``, the backwards) whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import dense_adj, edgemap
from tagrec_tpu_torch.ops.propagate import l2_normalize

# (source type, destination type) of each relation
REL_TYPES = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))
# the relations each node type sums, its row of the new factors
INCIDENT = ((0, 2), (1, 4), (3, 5))
ROUNDS = 2


class DisenHAN(base.MaskGraph, nn.Module):
    """Parameters ``embed.{0,1,2}`` (user, item, tag) and per layer
    ``layers.{i}.{Wtk,at,W,q_rela}``, drawn in that order from
    ``generator`` (a CPU ``torch.Generator``), the tree of JAX's params;
    on the dense tier the six relation masks are bool buffers
    ``mask_0..5`` on ``device``, ``mask_hosts`` keeping them on the host
    under JAX's leaf paths ``masks.0..5``, or with ``mesh`` the rank's
    rows of each that JAX's rule cuts (``models.base.MaskGraph``); on
    the EdgeMap tier ``em_hosts`` keeps
    the six relations' EdgeMapHosts ``ems.0..5`` (JAX's leaf prefixes)
    and ``edges`` their EdgeMaps, or with ``mesh`` the rank's rows of
    them (``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda", mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.num_list = [graph.n_user, graph.n_item, graph.n_tag]
        if cfg.dim_latent % cfg.factor_k:
            raise ValueError(f"dim_latent {cfg.dim_latent} is not a multiple "
                             f"of factor_k {cfg.factor_k}")
        self.dim_k = cfg.dim_latent // cfg.factor_k
        n = sum(self.num_list)
        self.dense = dense_adj.use_dense(cfg.adj_mode, n, n)
        ui, ut, it = graph.ui_adj, graph.ut_adj, graph.it_adj
        rel_coos = (ui, ui.transpose(), ut, ut.transpose(), it,
                    it.transpose())
        self.em_hosts = {}
        if self.dense:
            self.mask_hosts = tuple(
                (f"masks.{e}", f"mask_{e}",
                 dense_adj.dense_mask_host(c.row, c.col, *c.shape), False)
                for e, c in enumerate(rel_coos))
            self.place_masks(mesh, dev)
        else:
            self.em_hosts = {f"ems.{e}": edgemap.build_edge_map(
                c.row, c.col, c.val, *c.shape) for e, c in enumerate(rel_coos)}
            self.edges = edgemap.EdgeMapBuffers(
                edgemap.maps_to_device(self.em_hosts, dev, mesh))
        self.embed = nn.ParameterList(
            base.init_embeddings(self.num_list, cfg.dim_latent, generator, dev))
        f_, d, dk = cfg.factor_k, cfg.dim_latent, self.dim_k

        def xavier(*shape):
            return base.xavier_uniform(shape, generator, dev)

        self.layers = nn.ModuleList(nn.ParameterDict({
            "Wtk": xavier(3, f_, d, dk), "at": xavier(6, f_, 2 * dk),
            "W": xavier(dk, dk), "q_rela": xavier(6, dk)})
            for _ in range(cfg.num_layer))

    @property
    def tier(self) -> str:
        """The execution tier built: "dense" (six relation masks) or "ell"
        (six EdgeMaps)."""
        return "dense" if self.dense else "ell"

    def masks(self):
        """The six relations' masks (dense tier: ``sweep_mask``'s, the
        rank's rows under a mesh) or EdgeMaps."""
        if self.dense:
            return [self.sweep_mask(f"mask_{e}") for e in range(6)]
        return [self.edges[f"ems.{e}"] for e in range(6)]

    def _rela_update(self, lp, e, mask, new_src, old_dst, r_src):
        """One relation's attention aggregation over ``mask`` (its mask or
        EdgeMap): new_src [F, n_src, dk] the routed source factors, old_dst
        [F, n_dst, dk] the static destination projections, r_src [F, n_src]
        -> (new r [F, n_src], z [F, n_src, dk])."""
        a = lp["at"][e]                                         # [F, 2dk]
        head = torch.einsum("fnd,fd->fn", new_src, a[:, :self.dim_k])
        tail = torch.einsum("fnd,fd->fn", old_dst, a[:, self.dim_k:])
        if self.dense:
            # the rank's source rows read head and r_src there, tail and
            # old_dst whole: their gradients summed over ``model``
            name = f"mask_{e}"
            zk = self.rows_whole(name, dense_adj.disenhan_dense_rela(
                *self.mesh_sum(head, tail, r_src, old_dst), mask), ax=1)
        else:
            # the score relu(head + tail) is separable: per-node values
            # gathered per slot, never a [F, Nb, Kb, dk] tail tensor
            em = mask
            hs = edgemap.rows_gather(em, head[..., None])    # [F, Nb, 1]
            ts = edgemap.edge_gather(em, tail)               # [F, Nb, Kb]
            rr = edgemap.rows_gather(em, r_src[..., None])   # [F, Nb, 1]
            e_rela = tuple(torch.sum(torch.relu(h + t) * r, dim=0)
                           for h, t, r in zip(hs, ts, rr))   # [Nb, Kb]
            soft = edgemap.edge_softmax(em, e_rela)
            f_ = self.cfg.factor_k
            zk = edgemap.edge_reduce(
                em, tuple(p[None].expand((f_,) + tuple(p.shape))
                          for p in soft), old_dst)
        emb_z = F.leaky_relu(zk, 0.2) @ lp["W"]
        new_r = torch.softmax(torch.einsum("fnd,d->fn", torch.tanh(emb_z),
                                           lp["q_rela"][e]), dim=0)
        return new_r, emb_z

    def _layer(self, lp, embs):
        """[n_t, d] per type -> [n_t, F * dk] per type."""
        masks = self.masks()
        fac = [l2_normalize(F.leaky_relu(
            torch.einsum("nd,fdk->fnk", embs[t], lp["Wtk"][t]), 0.2), dim=2)
            for t in range(3)]
        new = list(fac)
        f_ = self.cfg.factor_k
        r_list = [fac[src].new_full((f_, fac[src].shape[1]), 1.0 / f_)
                  for src, _ in REL_TYPES]
        for _ in range(ROUNDS):
            rela, emb = [], []
            for e, (src, dst) in enumerate(REL_TYPES):
                nr, ez = self._rela_update(lp, e, masks[e], new[src], fac[dst],
                                           r_list[e])
                rela.append(nr)
                emb.append(ez)
            new = []
            for t, rels in enumerate(INCIDENT):
                out = fac[t]
                for e in rels:
                    out = out + emb[e] * rela[e][:, :, None]
                new.append(l2_normalize(out, dim=2))
            r_list = rela
        return [torch.cat(list(x), dim=1) for x in new]

    def forward(self, *, training: bool = False, generator=None):
        """-> (user, item, tag) final tables; DisenHAN has no dropout."""
        embs = list(self.embed)
        for lp in self.layers:
            embs = self._layer(lp, embs)
        return tuple(embs)

    def bpr_loss(self, batch, *, cor=None, generator=None,
                 training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the
        final rows -> (loss, reg * l2); ``cor`` is unused, as in JAX."""
        embs = self.forward()
        return base.bpr_with_reg(embs[0], embs[1], embs[0], embs[1], batch,
                                 self.cfg.mul_loss_func, self.cfg.reg)

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores for ``users``."""
        embs = self.forward()
        users = torch.as_tensor(users, device=embs[0].device)
        return base.predict_sigmoid(embs[0][users], embs[1])
