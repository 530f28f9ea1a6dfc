"""Serving: freeze a model into embedding tables + top-k retrieval
(tagrec_tpu/serving.py).

* **export** (offline, once): one forward pass, the propagated user/item
  tables frozen into a versioned ``.npz`` artifact with a ``.meta.json``
  sidecar.  The format is the JAX package's, so each side reads the other's
  artifacts.
* **retrieve** (online): per block of request users, sigmoid(U_sel @ I^T),
  the users' train positives set to ``MASK_SCORE`` (the evaluator's
  protocol), then top-k.  Under a mesh the item table is row-sharded over
  ``model`` and each block goes through
  ``parallel.topk.distributed_masked_topk``.

Query a saved artifact from the shell:
``python -m tagrec_tpu_torch.serving --artifact art.npz --users 1 2 3 --k 10``
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.ops import metrics
from tagrec_tpu_torch.parallel import sharding
from tagrec_tpu_torch.parallel import topk as ptopk

EXPORT_VERSION = 1
MASK_SCORE = metrics.MASK_VALUE  # the evaluator's train-positive sentinel
PAD_ID = metrics.PAD_ID          # train_pad filler; out of range, so never masked


# ----------------------------------------------------------------- export

def export_tables(model, *, n_item: Optional[int] = None):
    """One forward pass -> frozen (user, item) float32 numpy tables.

    ``n_item`` trims an entity-wide item table to its first ``n_item`` rows.
    """
    with torch.no_grad(), sharding.gathered():
        embs = model.forward()
    u_all = embs[0].float().cpu().numpy()
    i_all = embs[1].float().cpu().numpy()
    if n_item is not None:
        if i_all.shape[0] < n_item:
            raise ValueError(f"item table has {i_all.shape[0]} rows, "
                             f"fewer than n_item={n_item}")
        i_all = i_all[:n_item]
    return u_all, i_all


def _norm_artifact_path(path: str) -> str:
    # np.savez appends '.npz' when the path lacks it; normalize here so the
    # meta sidecar and load_export always key off the same on-disk name.
    return path if path.endswith(".npz") else path + ".npz"


def save_export(path: str, user_table: np.ndarray, item_table: np.ndarray,
                *, model_name: str = "", train_pos=None, extra: dict = None):
    """Write the versioned serving artifact (.npz + sidecar meta json).

    ``train_pos``: optional {user: [item, ...]} dict frozen into the padded
    mask table so the retriever needs no graph object at load time.
    """
    path = _norm_artifact_path(path)
    arrays = {"user_table": user_table, "item_table": item_table}
    if train_pos is not None:
        pad, deg = metrics.pad_lists(train_pos, user_table.shape[0], PAD_ID)
        arrays["train_pad"] = pad
        arrays["train_deg"] = deg
    meta = {"version": EXPORT_VERSION, "model": model_name,
            "n_user": int(user_table.shape[0]),
            "n_item": int(item_table.shape[0]),
            "dim": int(user_table.shape[1])}
    meta.update(extra or {})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_export(path: str):
    """-> (npz arrays, meta dict); raises on a missing table or a newer
    artifact version."""
    path = _norm_artifact_path(path)
    data = np.load(path)
    for key in ("user_table", "item_table"):
        if key not in data:
            raise ValueError(f"serving artifact {path!r} missing {key!r}")
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        v = meta.get("version", -1)
        if v > EXPORT_VERSION:
            raise ValueError(
                f"artifact version {v} is newer than supported {EXPORT_VERSION}")
    return data, meta


# --------------------------------------------------------------- retriever

class Retriever:
    """Online top-k over frozen tables, on ``device``.

    ``topk(users, k)`` scores ``block`` users at a time (bounding the
    [block, n_item] score matrix), masks each user's train positives to
    MASK_SCORE and returns global item ids + sigmoid scores.  Ties between
    equal scores may come in any order.

    ``mesh``: an optional ``parallel.Mesh``; this rank keeps its block of
    the item table (zero-padded to the ``model`` axis), and every rank of
    the mesh calls ``topk`` together and gets the same answer.
    """

    def __init__(self, user_table, item_table, *, train_pad=None,
                 block: int = 256, mesh=None, device="cuda"):
        dev = resolve(device)
        self.mesh = mesh
        self.n_user, self.dim = user_table.shape
        self.n_item = item_table.shape[0]
        self.block = max(int(block), 1)
        self._U = torch.as_tensor(np.asarray(user_table, np.float32), device=dev)
        self._I = torch.as_tensor(np.asarray(item_table, np.float32), device=dev)
        if mesh is not None:  # this rank's rows only
            self._I = ptopk.shard_items(self._I, mesh)[0].clone()
        if train_pad is None:
            train_pad = np.full((self.n_user, 1), PAD_ID, dtype=np.int32)
        self._train_pad = torch.as_tensor(
            np.asarray(train_pad, dtype=np.int64), device=dev)

    @classmethod
    def from_export(cls, path: str, **kw):
        data, _ = load_export(path)
        return cls(data["user_table"], data["item_table"],
                   train_pad=data.get("train_pad"), **kw)

    def _block_topk(self, users: torch.Tensor, k: int):
        if self.mesh is not None:
            return ptopk.distributed_masked_topk(
                self._U[users], self._I, self._train_pad[users], k, self.mesh,
                n_valid=self.n_item)
        scores = torch.sigmoid(self._U[users] @ self._I.T)      # [B, I]
        metrics.mask_train_positives(scores, self._train_pad[users])
        return torch.topk(scores, k, dim=1)

    def topk(self, users, k: int = 20):
        """-> (item ids [n, k] int32, scores [n, k] f32) numpy for ``users``."""
        users = torch.as_tensor(np.asarray(users, dtype=np.int64),
                                device=self._U.device)
        ids, vals = [], []
        with torch.no_grad():
            for i in range(0, users.shape[0], self.block):
                v, idx = self._block_topk(users[i:i + self.block], k)
                ids.append(idx)
                vals.append(v)
        return (torch.cat(ids).to(torch.int32).cpu().numpy(),
                torch.cat(vals).float().cpu().numpy())


# --------------------------------------------------------------- CLI query

def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="query a serving export: top-k items per user")
    ap.add_argument("--artifact", required=True, help="path to export .npz")
    ap.add_argument("--users", type=int, nargs="+", required=True)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = Retriever.from_export(args.artifact, device=args.device)
    ids, scores = r.topk(args.users, args.k)
    for u, row_i, row_s in zip(args.users, ids, scores):
        print(json.dumps({"user": int(u), "items": row_i.tolist(),
                          "scores": [round(float(s), 5) for s in row_s]}))


if __name__ == "__main__":
    main()
