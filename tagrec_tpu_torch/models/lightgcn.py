"""LightGCN (+tags): SpMM propagation with a layer-mean readout
(tagrec_tpu/models/lightgcn.py).

* the joint normalized {user, item, tag} adjacency, ``bi_norm`` by default
* L layers x <- A x, with optional per-layer message dropout and edge
  dropout (``node_drop``: the adjacency's values dropped once a forward)
* a per-layer L2 normalize of each layer's output (quirk #8, switchable)
* final embedding = mean over [ego, layer_1..L]
* BPR (softplus) on the final tables plus L2 on the ego tables

The adjacency is an ``ops.ell`` pair built as JAX builds it: the sector
blocks of the dense form within the dense budget (hetrec scale), the hybrid
hub block + degree-bucketed ELL above it, whose SpMM runs the
``gather_reduce`` and ``gather_rows`` kernels forward and backward.
``adj_dtype="bf16"`` stores the dense forms in bfloat16 (float32 sums).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.propagate import (adj_mm, edge_dropout,
                                            l2_normalize, message_dropout)


class LightGCN(base.AdjPairGraph, nn.Module):
    """``embed`` holds the user, item[, tag] tables, drawn from
    ``generator`` (a CPU ``torch.Generator``); ``adj`` is the adjacency
    pair (``ops.ell.AdjPair``) on ``device``, built from ``adj_host``;
    with ``mesh`` its pieces are that rank's rows (``ops.ell.shard_rows``,
    ``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda",
                 per_layer_normalize: bool = True, mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.per_layer_normalize = per_layer_normalize
        use_tag = cfg.use_tag and graph.has_tags
        self.num_list = [graph.n_user, graph.n_item] + (
            [graph.n_tag] if use_tag else [])
        coo = graph.joint_norm_adj(cfg.norm_type, use_tag)
        # bi_norm and plain adjacencies are symmetric, so the backward shares
        # the forward tables; norms without self-loops have empty diagonal
        # sectors, which the dense form skips
        host = ell_lib.build_adj_pair(
            coo, symmetric=cfg.norm_type in ("bi_norm", "plain"),
            mode={"dense_xla": "dense"}.get(cfg.adj_mode, cfg.adj_mode),
            dense_dtype=np.float32 if cfg.adj_dtype == "f32" else "bf16",
            sectors=(tuple(self.num_list)
                     if cfg.norm_type in ("bi_norm", "plain", "si_norm")
                     else None))
        self.adj_host = host
        self.adj = ell_lib.to_device(
            host if mesh is None else ell_lib.shard_rows(host, mesh), dev)
        self.embed = nn.ParameterList(
            base.init_embeddings(self.num_list, cfg.dim_latent, generator, dev))

    def forward(self, *, training: bool = False, generator=None):
        """-> (user, item[, tag]) final tables; ``generator`` (on the
        model's device) draws the edge and message dropout when
        ``training``."""
        cfg = self.cfg
        adj = edge_dropout(self.adj, cfg.node_drop, generator, training)
        x = torch.cat(list(self.embed), dim=0)
        outs = [x]
        for k in range(cfg.num_layer):
            x = adj_mm(adj, x)
            x = message_dropout(x, cfg.message_drop_list[k], generator,
                                training)
            outs.append(l2_normalize(x) if self.per_layer_normalize else x)
        final = torch.mean(torch.stack(outs, dim=1), dim=1)
        return base.split_nodes(final, self.num_list)

    def bpr_loss(self, batch, *, generator=None, training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the ego
        tables -> (loss, reg * l2)."""
        embs = self.forward(training=training, generator=generator)
        return base.bpr_with_reg(embs[0], embs[1], self.embed[0],
                                 self.embed[1], batch, self.cfg.mul_loss_func,
                                 self.cfg.reg)

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores for ``users``."""
        embs = self.forward()
        users = torch.as_tensor(users, device=embs[0].device)
        return base.predict_sigmoid(embs[0][users], embs[1])
