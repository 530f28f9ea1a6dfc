"""Plain reference of LightGCN on the joint user-item-tag graph, as the
tag-aware reference defines it (chenzheng5555/tag-aware-recommendation;
He et al., arXiv:2002.02126, with tags as a third node type).

* A: the symmetric joint {user, item, tag} adjacency of the train edges,
  a pair's weight its interaction count, normalised D^-1/2 A D^-1/2;
* L layers x <- A x; each layer's output L2-normalised (the reference's
  per-layer normalize); final = the mean of [x_0, x_1 .. x_L];
* BPR: mean softplus(score- - score+) on the final tables, plus reg times
  the L2 term of the batch's ego rows.

Built from the raw edges alone; the products run in the precision given
(``_common.Precision``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from portbench.reference import _common as C


def leaves(raw, cfg: dict) -> List[Tuple[str, Tuple[int, int]]]:
    """The trained leaves, by the name the system's module gives them."""
    d = cfg["dim_latent"]
    return [("embed.0", (raw.n_user, d)), ("embed.1", (raw.n_item, d)),
            ("embed.2", (raw.n_tag, d))]


class Model:
    def __init__(self, raw, cfg: dict, prec: C.Precision, device):
        if cfg["norm_type"] != "bi_norm":
            raise ValueError("the reference LightGCN takes bi_norm")
        self.raw, self.cfg, self.prec = raw, cfg, prec
        n = raw.n_nodes
        row, col, w = C.joint_edges(raw.n_user, raw.n_item, raw.n_tag,
                                    raw.train, raw.uit)
        self.adj = C.SparseMatrix(row, col, C.bi_norm(row, col, w, n), n,
                                  prec, device)

    def forward(self, tables: Sequence[torch.Tensor]):
        """-> (user, item, tag) final tables."""
        x = torch.cat(list(tables), dim=0)
        outs = [x]
        for _ in self.cfg["dim_layer_list"]:
            x = C.spmm(self.adj, x)
            outs.append(C.l2_normalize(x))
        final = torch.mean(torch.stack(outs, dim=0), dim=0)
        r = self.raw
        return torch.split(final, [r.n_user, r.n_item, r.n_tag], dim=0)

    def loss(self, tables, leaves, batch):
        return C.bpr(tables[0], tables[1], batch, self.cfg["mul_loss_func"],
                     self.cfg["reg"], leaves[0], leaves[1], self.prec)


def train_steps(raw, cfg: dict, w0, batches, prec: C.Precision,
                device) -> dict:
    """``_common.train_steps`` of this model from ``w0`` on ``batches``."""
    model = Model(raw, cfg, prec, device)
    w0 = [w.to(device=device, dtype=prec.dtype) for w in w0]
    return C.train_steps(model.forward, model.loss, w0,
                         [b["bpr"].to(device) for b in batches], cfg["lr"])


@torch.no_grad()
def final_tables(raw, cfg: dict, w, prec: C.Precision, device):
    """(user, item) final tables at the leaves ``w``."""
    model = Model(raw, cfg, prec, device)
    out = model.forward([x.to(device=device, dtype=prec.dtype) for x in w])
    return out[0], out[1]
