"""Plain reference of DGCF on the joint user-item-tag graph (Wang et al.,
"Disentangled Graph Collaborative Filtering", SIGIR 2020, as the
tag-aware reference chenzheng5555/tag-aware-recommendation runs it).

Per edge (r, c) of the joint graph's pattern (no weights, no self-loops)
a score S[f, e] for each of F factors, 1 at the start and kept across
layers.  A layer splits its input into F chunks x_f of width d / F and
runs ``iterate_k`` routing iterations:

* P[f, e] = softmax over f of S[:, e] (no gradient);
* deg[f, r] = sum of P[f, e] over the row's edges, s = deg^-1/2 (0 at 0);
* h_f[r] = s[f, r] * sum over the row's edges of P[f, e] s[f, c] x_f[c];
* S[f, e] += <h_f[r] / |h_f[r]|, tanh(x_f[c] / |x_f[c]|)> (no gradient).

The layer's output is the last iteration's h, each chunk L2-normalised,
the chunks side by side; final = the mean of [x_0, x_1 .. x_L]; BPR as
LightGCN's.  The distance-correlation term is off in the published
preset (cor_reg 0) and not modelled here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from portbench.reference import _common as C
from portbench.reference.lightgcn import leaves  # noqa: F401  (same leaves)


class Model:
    def __init__(self, raw, cfg: dict, prec: C.Precision, device):
        if cfg.get("cor_reg", 0.0):
            raise ValueError("the reference DGCF models cor_reg 0 only")
        self.raw, self.cfg, self.prec = raw, cfg, prec
        row, col, _ = C.joint_edges(raw.n_user, raw.n_item, raw.n_tag,
                                    raw.train, raw.uit)
        self.row = torch.as_tensor(row, device=device)
        self.col = torch.as_tensor(col, device=device)

    def forward(self, tables: Sequence[torch.Tensor]):
        cfg, prec, row, col = self.cfg, self.prec, self.row, self.col
        f = cfg["factor_k"]
        ego = torch.cat(list(tables), dim=0)
        n, d = ego.shape
        score = ego.new_ones((f, row.shape[0]))
        outs, cur = [ego], ego
        for _ in cfg["dim_layer_list"]:
            xf = cur.reshape(n, f, d // f).permute(1, 0, 2)      # [F, N, dk]
            tail = torch.tanh(C.l2_normalize(xf.detach()))
            h = None
            for _ in range(cfg["iterate_k"]):
                p = torch.softmax(score, dim=0)
                deg = ego.new_zeros((f, n)).index_add_(1, row, p)
                s = torch.where(deg > 0, torch.rsqrt(torch.where(
                    deg > 0, deg, 1.0)), 0.0)
                msg = prec.round(p)[:, :, None] * prec.round(
                    (xf * s[:, :, None])[:, col])
                agg = ego.new_zeros((f, n, d // f)).index_add(1, row, msg)
                h = s[:, :, None] * agg
                head = C.l2_normalize(h.detach())
                score = score + C.dot(head[:, row], tail[:, col], prec)
            layer = C.l2_normalize(h)
            cur = layer.permute(1, 0, 2).reshape(n, d)
            outs.append(cur)
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
