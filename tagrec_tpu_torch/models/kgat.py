"""KGAT on the tag tripartite graph, dense flash tier (tagrec_tpu/models/kgat.py).

Entities are items then tags (global ids offset by n_user) under six
relations [ui, iu, ut, tu, it, ti].  With ``agg_type="bi_inter"`` each layer
propagates over the attention adjacency

    pi(h, t) = (W_r e_t) . tanh(W_r e_h + e_r),  row softmax over each head's
                                                   out-edges

with NGCF-style bi-interaction, the bias folded into the weight
(``x @ (W + b)``, quirk #4), a per-layer L2 normalize and the concat of
[ego, layer_1..L] (width 64 + 64 + 32 + 16 = 176 at the preset).  The
attention runs per row type through the flash kernels of
``ops.flash_attention``: one stats sweep per row type, then one apply per
row type per layer, and its backward; the [N, N] attention never exists.
Under a mesh each flash mask and transpose holds one ``model`` rank's rows
(JAX's rule), every sweep runs on them and its results are all-gathered
once (``ops.dense_adj.MaskShard``).
``adj_mode="dense_xla"`` takes the chunked dense tier instead: the
sector-stacked scores softmaxed over the [N, N] edge mask chunk by chunk
(``ops.dense_adj.dense_row_softmax_scores``) into one attention matrix P,
which the layers reuse (``P @ x`` in blocks of the chunk's rows,
``ops.dense_adj.rows_mm``).

Over a true knowledge graph (``kg=``, a ``data.kg.KnowledgeGraph``) the
entities and relations are the KG's, and the relation is per edge: the
relation-dense tier keeps an int8 relation id per cell (``rel_id``, -1 for
no edge) and builds P chunk by chunk from the per-relation score planes
(``ops.dense_adj.rel_dense_row_softmax_scores``; bf16 planes under
``adj_dtype="bf16"``); the layers reuse P.  Under a mesh both dense
tables (``mask``, ``rel_id``) hold the rank's rows (JAX's rule,
``models.base.MaskGraph``): P is built for those rows only, each layer's
product runs on them and is gathered whole once, and the inputs read
whole on them (q, k, x) have their gradients summed over ``model``.

Past the dense budget, under ``adj_mode="ell"``, and over a KG that the
relation-dense tier cannot hold (parallel (h, t) edges, more than 127
relations), the attention runs on the EdgeMap tier (``ops.edgemap``), as
JAX picks it: two EdgeMaps over the same edges, one keyed by node and one
by (relation, node).  The scores are ``edge_dot`` over the keyed map of
the per-relation projection tables, moved to the node-keyed layout by
``slot_transfer``, softmaxed over each head's out-edges
(``edge_softmax``), and each layer's propagation is ``edge_reduce`` (the
``gather_reduce`` kernel).  Under a mesh both maps hold one ``model``
rank's rows (``ops.edgemap.shard_edge_map``) and the slot tables the
rank's rows of their destination map, moving what other ranks hold by
one exchange (``ops.edgemap.shard_slot_map``); the propagation comes
back whole on every rank.

Quirk #3: the shipped preset sets ``agg_type="bi_agg"``, which skips
propagation; the model then builds no masks and ``forward`` returns the ego
tables.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import dense_adj, edgemap, flash_attention, losses
from tagrec_tpu_torch.ops.propagate import l2_normalize, message_dropout

# relation id for (row type -> col type) sectors, in relation_edges order
# [ui, iu, ut, tu, it, ti]
REL_OF = ((-1, 0, 2), (1, -1, 4), (3, 5, -1))


def _pad_len(n: int) -> int:
    return -(-n // flash_attention.TILE_I) * flash_attention.TILE_I


class KGAT(base.MaskGraph, nn.Module):
    """Parameters ``user``, ``entity``, ``relation``, ``transE`` and
    ``mat.{W1,b1,W2,b2}_k``, drawn in that order from ``generator`` (a CPU
    ``torch.Generator``); under ``bi_inter`` the three row types' flash masks
    are int8 buffers ``fmask_0..2`` on ``device``, and their contiguous
    transposes ``fmaskT_0..2`` (the column backward's masks, built once),
    ``mask_hosts`` keeping them on the host, and with ``mesh`` each buffer
    the rank's rows (JAX's ``fmasks.a``; ``fmasksT.a`` by the same rule on
    their own rows: ``models.base.MaskGraph``);
    under ``dense_xla`` the joint edge mask is the bool buffer ``mask``
    [N, N] instead; over a KG (``kg=``) the int8 buffer ``rel_id`` [N, N];
    each, with ``mesh``, the rank's rows (``mask_hosts`` on the host);
    on the EdgeMap tier ``em_hosts`` keeps the maps ``em`` and ``emk``
    and their slot tables ``k2n`` and ``n2k`` (JAX's leaf prefixes) and
    ``edges`` holds them on ``device``, or with ``mesh`` the rank's rows
    of them (``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda", kg=None,
                 mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.num_user = graph.n_user
        if kg is not None:
            # knowledge-graph mode: (h, r, t) over users + entities
            assert kg.num_entity >= graph.n_item, (
                "items must be a prefix of the entity space: "
                f"n_item={graph.n_item} > num_entity={kg.num_entity}")
            self.num_entity = kg.num_entity
            self.num_relation = kg.num_relation
        else:
            self.num_entity = graph.n_item + graph.n_tag
            self.num_relation = 6
        self.n = self.num_user + self.num_entity
        self.kg_rel_dense = False
        self.dims = [cfg.dim_latent] + list(cfg.dim_layer_list)
        self.skip_adj = cfg.agg_type != "bi_inter"

        def xavier(*shape):
            return nn.Parameter(base.xavier_uniform(shape, generator, dev))

        self.user = xavier(self.num_user, cfg.dim_latent)
        self.entity = xavier(self.num_entity, cfg.dim_latent)
        self.relation = xavier(self.num_relation, cfg.dim_relation)
        self.transE = xavier(self.num_relation, cfg.dim_latent,
                             cfg.dim_relation)
        mat = {}
        for k in range(cfg.num_layer):
            d_in, d_out = self.dims[k], self.dims[k + 1]
            mat[f"W1_{k}"] = xavier(d_in, d_out)
            mat[f"b1_{k}"] = xavier(1, d_out)
            mat[f"W2_{k}"] = xavier(d_in, d_out)
            mat[f"b2_{k}"] = xavier(1, d_out)
        self.mat = nn.ParameterDict(mat)
        self.dense = self.flash = False
        self.em_hosts = {}
        if self.skip_adj:  # quirk #3: no adjacency is ever read
            return

        if kg is not None:
            trips = kg.all_triplet
            rows, rels, cols = (trips[:, c].astype(np.int64)
                                for c in range(3))
        else:
            rel_edges = graph.relation_edges()
            rows = np.concatenate([rel_edges[k][0] for k in range(6)])
            cols = np.concatenate([rel_edges[k][1] for k in range(6)])
            rels = np.concatenate([np.full(rel_edges[k].shape[1], k,
                                           dtype=np.int64)
                                   for k in range(6)])
        fits = dense_adj.use_dense(cfg.adj_mode, self.n, self.n)
        if kg is not None and fits and self._build_rel_dense(rows, cols,
                                                             rels, dev, mesh):
            return
        self.dense = kg is None and fits
        if not self.dense:
            self._build_edge_maps(rows, cols, rels, dev, mesh)
            return
        self.flash = cfg.adj_mode != "dense_xla"
        self.segs = ((0, graph.n_user),
                     (graph.n_user, graph.n_item),
                     (graph.n_user + graph.n_item, graph.n_tag))
        if not self.flash:
            self.mask_hosts = (("mask", "mask", dense_adj.dense_mask_host(
                rows, cols, self.n, self.n), False),)
            self.place_masks(mesh, dev)
            return
        masks = self._build_flash_masks(rows, cols, rels)
        for a in range(3):
            self.register_buffer(f"fmask_{a}", None)
            self.register_buffer(f"fmaskT_{a}", None)
        self.mask_hosts = tuple(
            (f"fmasks{'T' * t}.{a}", f"fmask{'T' * t}_{a}", m, t)
            for t in (False, True) for a, m in enumerate(masks))
        self.place_masks(mesh, dev)

    def _build_rel_dense(self, rows, cols, rels, dev, mesh) -> bool:
        """The int8 relation-id buffer ``rel_id`` [N, N] of the KG's triples
        (with ``mesh`` the rank's rows where JAX's rule cuts it) and the
        static row segments: user rows with the relations seen on a user
        head (relation 0), entity rows with the rest.  False, with nothing
        built, where one cell cannot hold the KG's edges."""
        rel_id = dense_adj.rel_id_host(rows, cols, rels, self.n, self.n)
        if rel_id is None:
            return False
        self.kg_rel_dense = True
        self.mask_hosts = (("rel_id", "rel_id", rel_id, False),)
        self.place_masks(mesh, dev)
        user = rows < self.num_user
        self._kg_row_segments = (
            (0, self.num_user, tuple(int(r) for r in np.unique(rels[user]))),
            (self.num_user, self.num_entity,
             tuple(int(r) for r in np.unique(rels[~user]))))
        return True

    def _build_edge_maps(self, rows, cols, rels, dev, mesh):
        """The EdgeMap tier: a node-keyed map for the row softmax and the
        propagation, a (relation, node)-keyed map on which the scores are
        plain per-edge dot products of the projection tables, and the slot
        tables between the two (``k2n``: each ``em`` slot's ``emk`` slot;
        ``n2k`` the reverse)."""
        n, rk = self.n, rels * self.n
        em = edgemap.build_edge_map(rows, cols, None, n, n)
        emk = edgemap.build_edge_map(rk + rows, rk + cols, None,
                                     self.num_relation * n,
                                     self.num_relation * n)
        k2n, n2k = edgemap.cross_slot_maps(emk, em)
        self.em_hosts = {"em": em, "emk": emk,
                         "k2n": edgemap.SlotMapHost(k2n, "emk", "em"),
                         "n2k": edgemap.SlotMapHost(n2k, "em", "emk")}
        self.edges = edgemap.EdgeMapBuffers(
            edgemap.maps_to_device(self.em_hosts, dev, mesh))

    def _build_flash_masks(self, rows, cols, rels):
        """Per-row-type int8 masks [pad(la), pad(l1) + pad(l2)] in the
        two-segment column layout of ``ops.flash_attention`` (host)."""
        masks = []
        for a in range(3):
            c1, c2 = [c for c in range(3) if c != a]
            sa, la = self.segs[a]
            s1, l1 = self.segs[c1]
            s2, l2 = self.segs[c2]
            m = np.zeros((_pad_len(la), _pad_len(l1) + _pad_len(l2)), np.int8)
            for c, sc, off in ((c1, s1, 0), (c2, s2, _pad_len(l1))):
                sel = rels == REL_OF[a][c]
                m[rows[sel] - sa, cols[sel] - sc + off] = 1
            masks.append(m)
        return masks

    @property
    def tier(self) -> str:
        """The execution tier built: "none" (quirk #3 reads no adjacency),
        "kg_rel_dense" (the relation-id buffer over a KG), "ell" (the
        EdgeMap tier), "kernels" (the flash kernels) or "dense_xla"."""
        if self.skip_adj:
            return "none"
        if self.kg_rel_dense:
            return "kg_rel_dense"
        if not self.dense:
            return "ell"
        return "kernels" if self.flash else "dense_xla"

    def flash_masks(self):
        return [getattr(self, f"fmask_{a}") for a in range(3)]

    def flash_masks_t(self):
        return [getattr(self, f"fmaskT_{a}") for a in range(3)]

    def flash_splits(self):
        """Per row type, the column offset where its second segment starts
        (JAX's ``split_j * TILE_J``)."""
        return [_pad_len(self.segs[[c for c in range(3) if c != a][0]][1])
                for a in range(3)]

    def _flash_att_mm(self, q, proj):
        """Per row type: one stats sweep over the two-segment columns (the
        softmax spans all of a head's out-edges), then ``att_mm(x)`` runs one
        apply per row type; the stats stay outside autograd."""
        tile = flash_attention.TILE_I

        def pad0(t):
            return flash_attention._pad_axis(t, tile, 0)

        plans = []
        for a, split in enumerate(self.flash_splits()):
            mask = self.sweep_mask(f"fmask_{a}")
            mask_t = self.sweep_mask(f"fmaskT_{a}")
            c1, c2 = [c for c in range(3) if c != a]
            r1, r2 = REL_OF[a][c1], REL_OF[a][c2]
            sa, la = self.segs[a]
            s1, l1 = self.segs[c1]
            s2, l2 = self.segs[c2]
            q2 = torch.stack([pad0(q[r1, sa:sa + la]), pad0(q[r2, sa:sa + la])])
            kcat = torch.cat([pad0(proj[r1, s1:s1 + l1]),
                              pad0(proj[r2, s2:s2 + l2])])
            ms, zs = flash_attention.dot_flash_stats(q2.detach(), kcat.detach(),
                                                     mask, split)
            plans.append((q2, kcat, mask, mask_t, ms, zs, split, la,
                          (s1, l1, s2, l2)))

        def att_mm(x):
            outs = []
            for (q2, kcat, mask, mask_t, ms, zs, split, la,
                 (s1, l1, s2, l2)) in plans:
                xcat = torch.cat([pad0(x[s1:s1 + l1]), pad0(x[s2:s2 + l2])])
                out = flash_attention.dot_flash_apply(q2, kcat, mask, ms, zs,
                                                      xcat, split, mask_t)
                outs.append(out[:la])
            return torch.cat(outs, dim=0)

        return att_mm

    def _dense_att_mm(self, name, chunk, scores, q, k):
        """The chunked tiers' propagation: P = ``scores(q, k, mask)`` over
        ``sweep_mask(name)``, then ``att_mm(x)`` = P @ x in blocks of
        ``chunk`` rows (``dense_adj.rows_mm``).  Under a mesh P is the
        rank's rows [N / model, N], each product its rows, gathered whole
        once; q, k and each x read whole on the rank's rows, so their
        gradients are summed over ``model``.  ``att_nbytes``: P's bytes."""
        mask = self.sweep_mask(name)
        _, row0 = dense_adj.sweep_rows(mask)
        p_att = scores(*self.mesh_sum(q, k), mask)
        self.att_nbytes = p_att.numel() * p_att.element_size()

        def att_mm(x):
            x, = self.mesh_sum(x)
            return self.rows_whole(name, dense_adj.rows_mm(p_att, x, chunk,
                                                           row0))

        return att_mm

    def _propagate(self, all_embed, training: bool, generator):
        """Bi-interaction propagation over the attention adjacency."""
        cfg = self.cfg
        # head side tanh(W_r e + e_r), tail side W_r e, per relation
        proj = torch.einsum("nd,rde->rne", all_embed, self.transE)
        q = torch.tanh(proj + self.relation[:, None, :])
        if self.kg_rel_dense:
            # one attention matrix from the relation score planes (the
            # rank's rows of it under a mesh), reused by every layer
            att_mm = self._dense_att_mm(
                "rel_id", dense_adj.REL_CHUNK,
                lambda q, k, rel_id: dense_adj.rel_dense_row_softmax_scores(
                    q, k, rel_id,
                    score_dtype=(torch.bfloat16 if cfg.adj_dtype == "bf16"
                                 else q.dtype),
                    row_segments=self._kg_row_segments), q, proj)
        elif not self.dense:
            # scores over the (relation, node)-keyed map, then the node-keyed
            # layout: gathers both ways, no scatter in the step
            em, emk = self.edges["em"], self.edges["emk"]
            pai = edgemap.slot_transfer(
                edgemap.edge_dot(emk, q.reshape(-1, q.shape[-1]),
                                 proj.reshape(-1, proj.shape[-1])),
                self.edges["k2n"], self.edges["n2k"])
            att = edgemap.edge_softmax(em, pai)

            def att_mm(x):
                return edgemap.edge_reduce(em, att, x)
        elif self.flash:
            att_mm = self._flash_att_mm(q, proj)
        else:
            # sector-stacked scores -> one row-softmax attention P (the
            # rank's rows of it under a mesh), reused by every layer
            att_mm = self._dense_att_mm(
                "mask", dense_adj.CHUNK, dense_adj.dense_row_softmax_scores,
                *dense_adj.sector_stack(q, proj, self.segs, REL_OF))
        x = all_embed
        outs = [x]
        for k in range(cfg.num_layer):
            nei = att_mm(x)
            sum_emb = F.leaky_relu(
                (nei + x) @ (self.mat[f"W1_{k}"] + self.mat[f"b1_{k}"]), 0.2)
            bi_emb = F.leaky_relu(
                (nei * x) @ (self.mat[f"W2_{k}"] + self.mat[f"b2_{k}"]), 0.2)
            x = sum_emb + bi_emb
            x = message_dropout(x, cfg.message_drop_list[k], generator,
                                training)
            outs.append(l2_normalize(x))
        return torch.cat(outs, dim=1)

    def forward(self, *, training: bool = False, generator=None):
        """-> (user table, entity table); ``generator`` (on the model's
        device) draws the message dropout when ``training``."""
        all_embed = torch.cat([self.user, self.entity], dim=0)
        if not self.skip_adj:
            all_embed = self._propagate(all_embed, training, generator)
        # else quirk #3: propagation skipped, the ego tables returned
        return all_embed[:self.num_user], all_embed[self.num_user:]

    def bpr_loss(self, batch, *, generator=None, training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the
        propagated rows -> (loss, reg * l2)."""
        u_all, e_all = self.forward(training=training, generator=generator)
        # items are the first n_item entity rows; batch ids are item ids
        return base.bpr_with_reg(u_all, e_all, u_all, e_all, batch,
                                 self.cfg.mul_loss_func, self.cfg.reg)

    def transe_loss(self, batch):
        """Per-relation projected squared-norm TransE on a [B, 4]
        (h, r, t+, t-) batch -> (loss, cor_reg * l2)."""
        h, r, tp, tn = batch[:, 0], batch[:, 1], batch[:, 2], batch[:, 3]
        all_embed = torch.cat([self.user, self.entity], dim=0)
        w = self.transE[r]                                   # [B, d, dr]
        r_e = self.relation[r]
        h_e = torch.einsum("bd,bde->be", all_embed[h], w)
        p_e = torch.einsum("bd,bde->be", all_embed[tp], w)
        n_e = torch.einsum("bd,bde->be", all_embed[tn], w)
        kg_loss = losses.transe_loss_sq(h_e, r_e, p_e, n_e)
        reg = losses.l2reg_loss(h_e, r_e, p_e, n_e)
        return kg_loss, self.cfg.cor_reg * reg

    @torch.no_grad()
    def predict(self, users):
        """[B, num_entity] sigmoid scores of ``users`` against every entity
        (items and tags, or the KG's entities), as JAX's ``predict``."""
        u_all, e_all = self.forward()
        users = torch.as_tensor(users, device=u_all.device)
        return base.predict_sigmoid(u_all[users], e_all)
