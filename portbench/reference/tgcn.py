"""Plain reference of TGCN (Chen et al., "TGCN: Tag Graph Convolutional
Network for Tag-Aware Recommendation", CIKM 2020), as the tag-aware
reference chenzheng5555/tag-aware-recommendation runs it (``model/tgcn.py``
11-268, preset ``utility/config.py`` 72-81).

Six relations [ui, ut, iu, it, tu, ti] (centre type, neighbour type), each
a fixed [N, k] table of sampled neighbours, ids + 1 with 0 the pad, and a
weight id a slot: the pair's interaction count, 0 on a pad.  Per layer,
with d its input width:

* Attention 1, per relation with the attention of its neighbour type
  (W1 [d + dw, da], W2 [d, da], b, v [1, da]): a slot's score
  v . ReLU([e_v | e_w(w_s)] W1 + e_j(n_s) W2 + b), a softmax over the k
  slots (pads included), agg = sum_s a_s e_j(n_s);
* Attention 2: each node's stack [3, d] (user: own, ui, ut; item: iu, own,
  it; tag: tu, ti, own) times a softmax over the 3 of p . ReLU(x U + q);
* a bit-level convolution (32 filters of (3, 1)) and a vector-level one
  (8 filters of (j, d) for j = 1, 2, 3) over the stack, each through ReLU,
  flattened channel-major and side by side, then ReLU(x Wf + bf);
* the output: the ego table and each layer's output L2-normalised, side by
  side (64 + 64 + 32 + 16 = 176 at the preset).

Phase 1 is BPR with logsigmoid on the final tables (plus ``reg`` times
the L2 term of the batch's final rows); phase 2 TransTag on the ego
tables: mean ReLU(margin + |u + t - i+| - |u + t - i-|) plus
``transtag_reg`` times half the squared norms of the four rows over B.
One Adam steps both phases; a leaf a phase does not reach has no gradient
there and is skipped, its moments and step count frozen (``Adam``): the
source's one ``torch.optim.Adam`` with its grads cleared to None.

The tables are the program's, taken as data as the batches are, and
judged (``table_faults``); the attention runs over the plain k-wide takes.

Departures from the source:

* the tables are drawn once and kept (quirk #6 of the source: its
  per-layer ``sample()`` shuffles an index it never reads and takes the
  first k columns of the tables drawn at start), so they are an input;
* the weight rows are a [num_weight, dw] table behind a zero pad row, a
  count c reading row c - 1 (the program's tree);
* no bias on the convolutions (the program's tree has none);
* message dropout is 0 at the preset and not modelled.

Plain PyTorch only; the products run in the precision given
(``_common.Precision``), TF32 off.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import _common as C

# the relations, in the order of the program's tables: (name, centre type,
# neighbour type); the attention of a relation is its neighbour type's
RELATIONS = (("ui", 0, 1), ("ut", 0, 2), ("iu", 1, 0), ("it", 1, 2),
             ("tu", 2, 0), ("ti", 2, 1))
TYPES = ("user", "item", "tag")


def relations(raw) -> List[Tuple[int, int, np.ndarray, np.ndarray,
                                  np.ndarray]]:
    """Each relation's (rows, columns, row, col, count) from the raw edges:
    the distinct pairs sorted by row then column and their interaction
    counts (a train pair 1; a (user, tag) or (item, tag) pair the
    assignments that hold it)."""
    sizes = (raw.n_user, raw.n_item, raw.n_tag)
    by_types = {(0, 1): (raw.train[:, 0], raw.train[:, 1]),
                (0, 2): (raw.uit[:, 0], raw.uit[:, 2]),
                (1, 2): (raw.uit[:, 1], raw.uit[:, 2])}
    out = []
    for _, a, b in RELATIONS:
        r, c = by_types[(a, b)] if (a, b) in by_types else \
            by_types[(b, a)][::-1]
        key, cnt = np.unique(r * sizes[b] + c, return_counts=True)
        out.append((sizes[a], sizes[b], key // sizes[b], key % sizes[b], cnt))
    return out


def num_weight(raw) -> int:
    """Rows of the weight table: the largest interaction count."""
    return int(max(rel[4].max() for rel in relations(raw)))


def _fans(name: str, shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(fan in, fan out) of a leaf as the source's module holds it: the
    convolutions as Conv2d weights [out, 1, kh, kw]."""
    parts = name.split(".")
    if parts[-1] == "bit":                              # Conv2d(1, 32, (3, 1))
        return 3, shape[0] * 3
    if parts[-2:-1] == ["vec"]:                         # Conv2d(1, 8, (j, d))
        return shape[1] * shape[2], shape[0] * shape[1] * shape[2]
    return shape[0], shape[1]


def leaves(raw, cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The trained leaves, by the name the system's module gives them."""
    d, dw, da = cfg["dim_latent"], cfg["dim_weight"], cfg["dim_atten"]
    out = [(f"embed.{j}", (n, d)) for j, n in
           enumerate((raw.n_user, raw.n_item, raw.n_tag))]
    out.append(("weight", (num_weight(raw), dw)))
    dims = [d] + list(cfg["dim_layer_list"])
    for li, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        p = f"layers.{li}."
        for t in TYPES:
            out += [(p + f"atten1.{t}.W1", (di + dw, da)),
                    (p + f"atten1.{t}.W2", (di, da)),
                    (p + f"atten1.{t}.b", (1, da)),
                    (p + f"atten1.{t}.v", (1, da))]
        nb, nv = cfg["num_bit_conv"], cfg["num_vec_conv"]
        out += [(p + "U", (di, da)), (p + "q", (1, da)), (p + "p", (1, da)),
                (p + "bit", (nb, 3))]
        out += [(p + f"vec.{j - 1}", (nv, j, di)) for j in (1, 2, 3)]
        out += [(p + "Wf", (nb * di + nv * 6, do)), (p + "bf", (1, do))]
    return out


def draw_leaves(specs, seed: int, device) -> List[torch.Tensor]:
    """Each leaf Xavier-uniform for its module's fans (the source's
    ``xavier_uniform_``), in ``specs``' order from one generator on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for name, shape in specs:
        fi, fo = _fans(name, shape)
        u = torch.rand(shape, generator=gen, device=device)
        out.append((2.0 * u - 1.0) * math.sqrt(6.0 / (fi + fo)))
    return out


def table_faults(raw, cfg: dict, tables) -> int:
    """Slots of the six [N, k] tables (ids + 1, weight ids) that break the
    sampler's promise: a slot that is not a neighbour of its row in that
    relation (a pad in a row that has neighbours included), a non-zero
    slot or weight id in a row of degree 0, or a weight id that is not the
    pair's count.  A table of the wrong shape counts every slot."""
    faults = 0
    k = cfg["neighbor_k"]
    for (n_rows, n_cols, row, col, cnt), (idx, w) in zip(relations(raw),
                                                         tables):
        idx, w = np.asarray(idx, np.int64), np.asarray(w, np.int64)
        if idx.shape != (n_rows, k) or w.shape != (n_rows, k):
            faults += max(idx.size, n_rows * k)
            continue
        live = (np.bincount(row, minlength=n_rows) > 0)[:, None]
        keys = row * n_cols + col
        q = np.arange(n_rows)[:, None] * n_cols + (idx - 1)
        pos = np.searchsorted(keys, q).clip(0, len(keys) - 1)
        edge = (idx >= 1) & (idx <= n_cols) & (keys[pos] == q)
        ok = np.where(live, edge & (cnt[pos] == w), (idx == 0) & (w == 0))
        faults += int((~ok).sum())
    return faults


class Model:
    """TGCN's forward and both losses over the given tables, in the
    precision given."""

    def __init__(self, raw, cfg: dict, tables, prec: C.Precision, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.raw, self.cfg, self.prec = raw, cfg, prec
        self.names = [name for name, _ in leaves(raw, cfg)]
        self.tables = [(torch.as_tensor(np.asarray(i, np.int64),
                                        device=device),
                        torch.as_tensor(np.asarray(w, np.int64),
                                        device=device))
                       for i, w in tables]

    def _mm(self, a, b):
        r = self.prec.round
        return r(a) @ r(b)

    def _atten1(self, ap, ev, ej0, ew0, idx, w):
        """One relation's aggregate [N, d]: the source's per-slot score
        over the k-wide takes."""
        e_nj = ej0[idx]                                       # [N, k, d]
        e_nw = ew0[w]                                         # [N, k, dw]
        e_nv = ev[:, None, :].expand(-1, idx.shape[1], -1)
        h = (self._mm(torch.cat([e_nv, e_nw], dim=-1), ap["W1"])
             + self._mm(e_nj, ap["W2"]) + ap["b"])
        score = self._mm(torch.relu(h), ap["v"].T)[..., 0]   # [N, k]
        a = torch.softmax(score, dim=1)
        r = self.prec.round
        return torch.einsum("nk,nkd->nd", r(a), r(e_nj))

    def _atten2(self, lp, stack):
        x = self._mm(torch.relu(self._mm(stack, lp["U"]) + lp["q"]),
                     lp["p"].T)                               # [N, 3, 1]
        return torch.softmax(x, dim=1) * stack

    def _conv_fusion(self, lp, stack):
        """The source's Conv2d pair over the [N, 1, 3, d] stack, then the
        linear fusion."""
        r = self.prec.round
        x = r(stack[:, None])
        n = stack.shape[0]
        parts = [torch.relu(F.conv2d(x, r(lp["bit"])[:, None, :, None]))
                 .reshape(n, -1)]                             # [N, 32 d]
        parts += [torch.relu(F.conv2d(x, r(lp[f"vec.{j}"])[:, None]))
                  .reshape(n, -1) for j in range(3)]          # [N, 8 (3-j+1)]
        return torch.relu(self._mm(torch.cat(parts, dim=1), lp["Wf"])
                          + lp["bf"])

    def forward(self, leaves: Sequence[torch.Tensor]):
        """-> (user, item, tag) final tables."""
        p = dict(zip(self.names, leaves))
        ego = [p[f"embed.{j}"] for j in range(3)]
        ew0 = torch.cat([p["weight"].new_zeros((1, p["weight"].shape[1])),
                         p["weight"]])
        cur, outs = list(ego), [[e] for e in ego]
        for li in range(len(self.cfg["dim_layer_list"])):
            pre = f"layers.{li}."
            lp = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
            padded = [torch.cat([e.new_zeros((1, e.shape[1])), e])
                      for e in cur]
            agg = {}
            for (name, a, b), (idx, w) in zip(RELATIONS, self.tables):
                ap = {k: lp[f"atten1.{TYPES[b]}.{k}"]
                      for k in ("W1", "W2", "b", "v")}
                agg[name] = self._atten1(ap, cur[a], padded[b], ew0, idx, w)
            stacks = (torch.stack([cur[0], agg["ui"], agg["ut"]], dim=1),
                      torch.stack([agg["iu"], cur[1], agg["it"]], dim=1),
                      torch.stack([agg["tu"], agg["ti"], cur[2]], dim=1))
            cur = [self._conv_fusion(lp, self._atten2(lp, s))
                   for s in stacks]
            for o, e in zip(outs, cur):
                o.append(C.l2_normalize(e))
        return tuple(torch.cat(o, dim=1) for o in outs)

    def bpr_loss(self, leaves, batch):
        u, i, _ = self.forward(leaves)
        return C.bpr(u, i, batch, self.cfg["mul_loss_func"], self.cfg["reg"],
                     u, i, self.prec)

    def transtag_loss(self, leaves, batch):
        p = dict(zip(self.names, leaves))
        eu, ei, et = (p[f"embed.{j}"] for j in range(3))
        ue, te = eu[batch[:, 0]], et[batch[:, 1]]
        pe, ne = ei[batch[:, 2]], ei[batch[:, 3]]
        pos = torch.linalg.vector_norm(ue + te - pe, dim=1)
        neg = torch.linalg.vector_norm(ue + te - ne, dim=1)
        loss = torch.mean(torch.relu(self.cfg["margin"] + pos - neg))
        l2 = sum(torch.sum(e * e) for e in (ue, te, pe, ne))
        return loss + self.cfg["transtag_reg"] * 0.5 * l2 / batch.shape[0]

    def loss(self, phase: str, leaves, batch):
        if phase == "bpr":
            return self.bpr_loss(leaves, batch)
        if phase == "transtag":
            return self.transtag_loss(leaves, batch)
        raise ValueError(f"phase {phase!r}: bpr or transtag")


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) with a step count a leaf: a leaf
    with no gradient in a step is skipped (``torch.optim.Adam`` over
    grads cleared to None)."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float):
        self.lr = lr
        self.t = [0] * len(leaves)
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    def step(self, leaves, grads) -> None:
        b1, b2 = 0.9, 0.999
        for j, (p, g) in enumerate(zip(leaves, grads)):
            if g is None:
                continue
            self.t[j] += 1
            c1, c2 = 1 - b1 ** self.t[j], 1 - b2 ** self.t[j]
            self.m[j].mul_(b1).add_(g, alpha=1 - b1)
            self.v[j].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * self.m[j]
                   / (torch.sqrt(self.v[j] / c2) + 1e-8))


def train_steps(raw, cfg: dict, w0, batches, prec: C.Precision, device,
                tables=None) -> dict:
    """The steps of ``batches`` ({phase: batch} each, in the order the
    Trainer ran them) from ``w0`` over ``tables`` -> each step's loss, each
    phase's first gradient as {leaf: norm} of the leaves it reaches, each
    leaf's norm of the change after the last step, and ``table_faults``."""
    model = Model(raw, cfg, tables, prec, device)
    w0 = [w.to(device=device, dtype=prec.dtype) for w in w0]
    leaves_ = [w.detach().clone().requires_grad_(True) for w in w0]
    opt = Adam([w.detach() for w in leaves_], cfg["lr"])
    losses, grad1 = [], {}
    for step in batches:
        (phase, batch), = step.items()
        loss = model.loss(phase, leaves_, batch.to(device))
        grads = torch.autograd.grad(loss, leaves_, allow_unused=True)
        losses.append(float(loss.detach()))
        if phase not in grad1:
            grad1[phase] = {
                name: float(torch.linalg.vector_norm(g.double()))
                for name, g in zip(model.names, grads) if g is not None}
        with torch.no_grad():
            opt.step([w.data for w in leaves_], grads)
    change = [float(torch.linalg.vector_norm((w.detach() - a).double()))
              for w, a in zip(leaves_, w0)]
    return {"losses": losses, "grad1": grad1, "change": change,
            "table_faults": table_faults(raw, cfg, tables)}


def transtag_faults(raw, rows: torch.Tensor) -> int:
    """Rows of TransTag batches [steps, B, 4] (user, tag, item+, item-)
    from one epoch shuffle that break the sampler's promise: ids out of
    range, a positive that is no (user, item, tag) assignment, a negative
    that is one, or an assignment twice."""
    dev = rows.device
    nu, ni, nt = raw.n_user, raw.n_item, raw.n_tag
    keys = torch.as_tensor(np.sort((raw.uit[:, 0] * nt + raw.uit[:, 2]) * ni
                                   + raw.uit[:, 1]), device=dev)
    u, t, p, n = (rows[..., j] for j in range(4))
    bad = ((u < 0) | (u >= nu) | (t < 0) | (t >= nt) | (p < 0) | (p >= ni)
           | (n < 0) | (n >= ni))
    u, t, p, n = u.clamp(0, nu - 1), t.clamp(0, nt - 1), \
        p.clamp(0, ni - 1), n.clamp(0, ni - 1)

    def member(q):
        i = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
        return keys[i] == q

    pos = (u * nt + t) * ni + p
    bad |= ~member(pos) | member((u * nt + t) * ni + n)
    flat = pos.reshape(-1)
    return int(bad.sum()) + int(flat.numel() - torch.unique(flat).numel())
