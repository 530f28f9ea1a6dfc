"""What the plain references share: the joint graph from raw edges, the
precision they compute in, a sparse product, BPR and Adam.

Plain PyTorch only; nothing of the system under test.  A reference runs
in one of two precisions:

* ``"ref"``: float64 throughout, the reference proper;
* ``"tf32"``: the control, float32 with every product's operands rounded
  to TF32 (10 explicit mantissa bits, to nearest even) as a TF32 matmul
  rounds them, sums in float32: the precision just below the float32
  (TF32 off) that the configurations state.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class Precision:
    def __init__(self, mode: str):
        if mode not in ("ref", "tf32"):
            raise ValueError(f"precision {mode!r}: ref or tf32")
        self.mode = mode
        self.dtype = torch.float64 if mode == "ref" else torch.float32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x as a product's operand: unchanged for ``ref``, rounded to
        TF32 for ``tf32`` (the gradient passes straight through)."""
        if self.mode == "ref":
            return x
        return x + (tf32(x.detach()) - x.detach())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def joint_edges(n_user: int, n_item: int, n_tag: int, train: np.ndarray,
                uit: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The symmetric joint {user, item, tag} adjacency from raw edges:
    (row, col, weight), distinct pairs sorted by row then column; items
    at +n_user, tags at +n_user+n_item; a weight counts the pair's
    interactions (a train pair 1; a (user, tag) or (item, tag) pair the
    assignments that hold it)."""
    oi, ot = n_user, n_user + n_item
    u, i = train[:, 0], train[:, 1]
    au, ai, at = uit[:, 0], uit[:, 1], uit[:, 2]
    row = np.concatenate([u, i + oi, au, at + ot, ai + oi, at + ot])
    col = np.concatenate([i + oi, u, at + ot, au, at + ot, ai + oi])
    n = n_user + n_item + n_tag
    key, cnt = np.unique(row * n + col, return_counts=True)
    return key // n, key % n, cnt.astype(np.float64)


def bi_norm(row: np.ndarray, col: np.ndarray, w: np.ndarray,
            n: int) -> np.ndarray:
    """D^-1/2 A D^-1/2 weights; a row of degree 0 gets 0."""
    deg = np.bincount(row, weights=w, minlength=n)
    dis = np.zeros(n)
    dis[deg > 0] = deg[deg > 0] ** -0.5
    return dis[row] * w * dis[col]


class SparseMatrix:
    """A square sparse matrix and its transpose on one device, in the
    precision's type (values rounded as a product's operands)."""

    def __init__(self, row, col, val, n: int, prec: Precision, device):
        idx = torch.as_tensor(np.stack([row, col]), device=device)
        v = prec.round(torch.as_tensor(val, dtype=prec.dtype, device=device))
        self.a = torch.sparse_coo_tensor(
            idx, v, (n, n), check_invariants=False).coalesce()
        self.at = torch.sparse_coo_tensor(
            idx.flip(0), v, (n, n), check_invariants=False).coalesce()
        self.prec = prec


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return torch.sparse.mm(m.a, m.prec.round(x))

    @staticmethod
    def backward(ctx, g):
        m = ctx.m
        return torch.sparse.mm(m.at, m.prec.round(g)), None


def spmm(m: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """A @ x, its gradient A^T @ g, each product in the precision."""
    return _SpMM.apply(x, m)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x over its L2 norm along ``dim``, the norm clamped at 1e-12."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=1e-24))


def dot(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Row dot products of a and b, as a product in the precision."""
    return torch.sum(prec.round(a) * prec.round(b), dim=-1)


def bpr(users, items, batch: torch.Tensor, kind: str, reg: float,
        ego_users, ego_items, prec: Precision) -> torch.Tensor:
    """BPR over a [B, 3] (user, item+, item-) batch, plus reg times half
    the squared norm of the batch's ego rows over B."""
    u, p, n = batch[:, 0], batch[:, 1], batch[:, 2]
    pos = dot(users[u], items[p], prec)
    neg = dot(users[u], items[n], prec)
    if kind == "logsigmoid":
        loss = -torch.mean(torch.nn.functional.logsigmoid(pos - neg))
    else:
        loss = torch.mean(torch.nn.functional.softplus(neg - pos))
    if reg:
        l2 = sum(torch.sum(e * e) for e in (ego_users[u], ego_items[p],
                                            ego_items[n]))
        loss = loss + reg * 0.5 * l2 / batch.shape[0]
    return loss


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) over a list of leaves."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    def step(self, leaves: List[torch.Tensor], grads) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / (torch.sqrt(v / c2) + 1e-8))


def train_steps(forward, loss_fn, w0: Sequence[torch.Tensor], batches,
                lr: float) -> dict:
    """The first steps of BPR training from ``w0`` on ``batches``: each
    step's loss, each leaf's norm of the first gradient, and each leaf's
    norm of the change after the last step.  ``forward(leaves)`` gives
    the final tables, ``loss_fn(tables, leaves, batch)`` the loss."""
    leaves = [w.detach().clone().requires_grad_(True) for w in w0]
    opt = Adam([w.detach() for w in leaves], lr)
    losses, g1 = [], None
    for batch in batches:
        loss = loss_fn(forward(leaves), leaves, batch)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        with torch.no_grad():
            opt.step([w.data for w in leaves], grads)
    change = [float(torch.linalg.vector_norm((w.detach() - w0_).double()))
              for w, w0_ in zip(leaves, w0)]
    return {"losses": losses, "grad1": g1, "change": change}
