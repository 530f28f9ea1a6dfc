"""NGCF (+tags): bi-interaction propagation with a layer concat
(tagrec_tpu/models/ngcf.py).

* the joint adjacency with the ``ngcf`` norm D^-1 A + I, stored as
  ``si_norm`` (D^-1 A, no self-loops) and the +I added analytically:
  nei = A x + x, so the dense form keeps only the nonzero type sectors
* per layer k: sum = LeakyReLU((nei + x) (W1_k + b1_k)),
  bi = LeakyReLU((nei * x) (W2_k + b2_k)), x <- sum + bi, message dropout,
  then each layer's output L2-normalized and the [ego, layer_1..L] outputs
  concatenated (64 + 64 + 32 + 16 = 176 columns at the preset)
* quirk #4: the bias is added to the weight before the product,
  ``x @ (W + b)``, not ``x @ W + b``
* BPR (logsigmoid at the preset) plus L2 on the **final** tables

D^-1 A is not symmetric, so the adjacency pair keeps its own transpose
tables: on the hybrid and ELL tiers the backward runs the gather kernels
over other buckets than the forward's.  ``adj_mode="dense_xla"`` means
``dense`` here, as in JAX; ``node_drop`` is unused, as in JAX.
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
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.propagate import adj_mm, l2_normalize, message_dropout


class NGCF(base.AdjPairGraph, nn.Module):
    """Parameters ``embed.{0,1[,2]}`` (user, item[, tag]) and
    ``mat.{W1,b1,W2,b2}_k``, drawn in that order from ``generator`` (a CPU
    ``torch.Generator``), the tree of JAX's params; ``adj`` is the
    adjacency pair (``ops.ell.AdjPair``) on ``device``, built from
    ``adj_host``; with ``mesh`` its pieces are that rank's rows
    (``ops.ell.shard_rows``, ``parallel.sharding.shard_graph``)."""

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda", mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        use_tag = cfg.use_tag and graph.has_tags
        self.num_list = [graph.n_user, graph.n_item] + (
            [graph.n_tag] if use_tag else [])
        self.dims = [cfg.dim_latent] + list(cfg.dim_layer_list)
        self.add_identity = cfg.norm_type == "ngcf"
        stored_norm = "si_norm" if self.add_identity else cfg.norm_type
        coo = graph.joint_norm_adj(stored_norm, use_tag)
        host = ell_lib.build_adj_pair(
            coo, symmetric=stored_norm in ("bi_norm", "plain"),
            mode={"dense_xla": "dense"}.get(cfg.adj_mode, cfg.adj_mode),
            dense_dtype=np.float32 if cfg.adj_dtype == "f32" else "bf16",
            sectors=(tuple(self.num_list)
                     if stored_norm in ("bi_norm", "plain", "si_norm")
                     else None))
        self.adj_host = host
        self.adj = ell_lib.to_device(
            host if mesh is None else ell_lib.shard_rows(host, mesh), dev)
        self.embed = nn.ParameterList(
            base.init_embeddings(self.num_list, cfg.dim_latent, generator, dev))
        mat = {}
        for k in range(cfg.num_layer):
            d_in, d_out = self.dims[k], self.dims[k + 1]
            for name, shape in (("W1", (d_in, d_out)), ("b1", (1, d_out)),
                                ("W2", (d_in, d_out)), ("b2", (1, d_out))):
                mat[f"{name}_{k}"] = nn.Parameter(
                    base.xavier_uniform(shape, generator, dev))
        self.mat = nn.ParameterDict(mat)

    def forward(self, *, training: bool = False, generator=None):
        """-> (user, item[, tag]) final tables [n, sum(dims)];
        ``generator`` (on the model's device) draws the message dropout
        when ``training``."""
        cfg = self.cfg
        x = torch.cat(list(self.embed), dim=0)
        outs = [x]
        for k in range(cfg.num_layer):
            nei = adj_mm(self.adj, x)
            if self.add_identity:
                nei = nei + x  # the +I of the ngcf norm
            # quirk #4: the bias folded into the weight before the product
            sum_emb = F.leaky_relu(
                (nei + x) @ (self.mat[f"W1_{k}"] + self.mat[f"b1_{k}"]), 0.2)
            bi_emb = F.leaky_relu(
                (nei * x) @ (self.mat[f"W2_{k}"] + self.mat[f"b2_{k}"]), 0.2)
            x = message_dropout(sum_emb + bi_emb, cfg.message_drop_list[k],
                                generator, training)
            outs.append(l2_normalize(x))
        return base.split_nodes(torch.cat(outs, dim=1), self.num_list)

    def bpr_loss(self, batch, *, generator=None, training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch, the L2 term on the
        final rows -> (loss, reg * l2)."""
        embs = self.forward(training=training, generator=generator)
        return base.bpr_with_reg(embs[0], embs[1], embs[0], embs[1], batch,
                                 self.cfg.mul_loss_func, self.cfg.reg)

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores for ``users``."""
        embs = self.forward()
        users = torch.as_tensor(users, device=embs[0].device)
        return base.predict_sigmoid(embs[0][users], embs[1])
