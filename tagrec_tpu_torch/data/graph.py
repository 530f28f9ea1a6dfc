"""Heterogeneous graph container + joint-adjacency algebra (pure numpy).

The port's copy of tagrec_tpu/data/graph.py, cut to what the ported slices
use: a duplicate-summing COO, the joint {user, item, tag} adjacency, its
normalizations, the six typed relations of KGAT, the dataset loader and
its load-time ``summary``.
Both packages give the same arrays for the same inputs
(tests/test_torch_dgcf.py, tests/test_torch_kgat.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tagrec_tpu_torch.data import io as data_io


@dataclass
class COO:
    """Duplicate-summed COO sparse matrix (float32 values)."""

    row: np.ndarray  # [nnz] int64
    col: np.ndarray  # [nnz] int64
    val: np.ndarray  # [nnz] float32
    shape: tuple

    @staticmethod
    def from_edges(row, col, shape, val=None) -> "COO":
        """Build a COO, summing duplicates (scipy ``.tocsr()`` accumulation:
        repeated (u, i, t) assignments become integer interaction weights)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        if val is None:
            val = np.ones(len(row), dtype=np.float32)
        else:
            val = np.asarray(val, dtype=np.float32)
        key = row * shape[1] + col
        uniq, inv = np.unique(key, return_inverse=True)
        sval = np.zeros(len(uniq), dtype=np.float32)
        np.add.at(sval, inv, val)
        return COO(uniq // shape[1], uniq % shape[1], sval, tuple(shape))

    @property
    def nnz(self) -> int:
        return len(self.row)

    def transpose(self) -> "COO":
        return COO(self.col.copy(), self.row.copy(), self.val.copy(),
                   (self.shape[1], self.shape[0]))

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=np.float32)
        d[self.row, self.col] = self.val
        return d

    def row_sum(self) -> np.ndarray:
        return np.bincount(self.row, weights=self.val,
                           minlength=self.shape[0]).astype(np.float32)

    def max(self) -> float:
        return float(self.val.max()) if self.nnz else 0.0

    def row_degrees(self) -> np.ndarray:
        """Number of stored entries per row."""
        return np.bincount(self.row, minlength=self.shape[0]).astype(np.int64)

    def sorted_by_row(self) -> "COO":
        order = np.lexsort((self.col, self.row))
        return COO(self.row[order], self.col[order], self.val[order], self.shape)


def joint_adjacency(ui: COO, ut: Optional[COO] = None,
                    it: Optional[COO] = None) -> COO:
    """Compose the square joint adjacency over {user, item[, tag]} nodes.

    Bipartite [[0, UI], [UI^T, 0]] or tripartite
    [[0, UI, UT], [UI^T, 0, IT], [UT^T, IT^T, 0]].
    Node ids: users 0.., items +n_user, tags +n_user+n_item.
    """
    n_user, n_item = ui.shape
    if ut is None:
        n = n_user + n_item
        rows = np.concatenate([ui.row, ui.col + n_user])
        cols = np.concatenate([ui.col + n_user, ui.row])
        vals = np.concatenate([ui.val, ui.val])
        return COO.from_edges(rows, cols, (n, n), vals)
    if it is None:
        raise ValueError("a tripartite adjacency needs both ut and it")
    n_tag = ut.shape[1]
    n = n_user + n_item + n_tag
    off_i, off_t = n_user, n_user + n_item
    rows = np.concatenate([
        ui.row, ui.col + off_i,          # u->i, i->u
        ut.row, ut.col + off_t,          # u->t, t->u
        it.row + off_i, it.col + off_t,  # i->t, t->i
    ])
    cols = np.concatenate([
        ui.col + off_i, ui.row,
        ut.col + off_t, ut.row,
        it.col + off_t, it.row + off_i,
    ])
    vals = np.concatenate([ui.val, ui.val, ut.val, ut.val, it.val, it.val])
    return COO.from_edges(rows, cols, (n, n), vals)


def normalize_adj(adj: COO, norm_type: str) -> COO:
    """The four adjacency normalizations.

    * ``bi_norm``:       D^-1/2 A D^-1/2            (LightGCN)
    * ``si_norm``:       D^-1 A                      (GC-MC style)
    * ``si_norm_self``:  D'^-1 (A + I)               (with self-loops in degree)
    * ``ngcf``:          D^-1 A + I                  (NGCF default)
    * ``plain``/other:   A unchanged
    Zero-degree rows get coefficient 0.
    """
    n = adj.shape[0]
    if norm_type == "bi_norm":
        d = adj.row_sum()
        with np.errstate(divide="ignore"):
            dis = np.power(d, -0.5)
        dis[np.isinf(dis)] = 0.0
        val = dis[adj.row] * adj.val * dis[adj.col]
        return COO(adj.row.copy(), adj.col.copy(), val.astype(np.float32), adj.shape)
    if norm_type == "si_norm":
        d = adj.row_sum()
        with np.errstate(divide="ignore"):
            di = np.power(d, -1.0)
        di[np.isinf(di)] = 0.0
        val = di[adj.row] * adj.val
        return COO(adj.row.copy(), adj.col.copy(), val.astype(np.float32), adj.shape)
    if norm_type == "si_norm_self":
        eye = np.arange(n, dtype=np.int64)
        with_self = COO.from_edges(
            np.concatenate([adj.row, eye]), np.concatenate([adj.col, eye]),
            adj.shape, np.concatenate([adj.val, np.ones(n, dtype=np.float32)]))
        return normalize_adj(with_self, "si_norm")
    if norm_type == "ngcf":
        si = normalize_adj(adj, "si_norm")
        eye = np.arange(n, dtype=np.int64)
        return COO.from_edges(
            np.concatenate([si.row, eye]), np.concatenate([si.col, eye]),
            adj.shape, np.concatenate([si.val, np.ones(n, dtype=np.float32)]))
    return COO(adj.row.copy(), adj.col.copy(), adj.val.copy(), adj.shape)


@dataclass
class HeteroGraph:
    """User-item-tag training graph + eval splits: typed id spaces in ``num``,
    per-split {user: items} dicts, train adjacencies as duplicate-summed COO
    (values = interaction multiplicities)."""

    num: Dict[str, int]
    user_items: Dict[str, Dict[int, List[int]]]
    ui_adj: COO
    ut_adj: Optional[COO] = None
    it_adj: Optional[COO] = None
    uit_data: Optional[np.ndarray] = None  # [T, 3] unique (u, i, t) assignments
    edge_index: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        for split, d in self.user_items.items():
            if split not in self.edge_index:
                self.edge_index[split] = data_io.interactions_to_edges(d)

    @staticmethod
    def load(data_root: str, dataset: str, has_val: bool = False,
             use_tag: bool = True) -> "HeteroGraph":
        """Load ``train.txt``/``test.txt``[/``val.txt``][/``user_item_tag.txt``].

        Entity counts are max-id-over-all-splits + 1.
        """

        def read_split(path):
            # parse -> dedup (u, i) pairs -> {user: sorted items}
            edges = data_io.interactions_to_edges(
                data_io.read_interaction_file(path))
            out: Dict[int, List[int]] = {}
            for u, i in np.unique(edges, axis=0):
                out.setdefault(int(u), []).append(int(i))
            return out

        d = data_io.dataset_dir(data_root, dataset)
        user_items = {"train": read_split(os.path.join(d, "train.txt"))}
        if has_val:
            user_items["val"] = read_split(os.path.join(d, "val.txt"))
        user_items["test"] = read_split(os.path.join(d, "test.txt"))

        max_u, max_i = 0, 0
        for ui in user_items.values():
            for u, items in ui.items():
                max_u = max(max_u, u)
                max_i = max(max_i, max(items))
        num = {"user": max_u + 1, "item": max_i + 1}

        train_edges = data_io.interactions_to_edges(user_items["train"])
        ui_adj = COO.from_edges(train_edges[:, 0], train_edges[:, 1],
                                (num["user"], num["item"]))

        ut_adj = it_adj = None
        uit = None
        if use_tag:
            uit = data_io.read_triple_file(os.path.join(d, "user_item_tag.txt"))
            num["tag"] = int(uit[:, 2].max()) + 1
            ut_adj = COO.from_edges(uit[:, 0], uit[:, 2], (num["user"], num["tag"]))
            it_adj = COO.from_edges(uit[:, 1], uit[:, 2], (num["item"], num["tag"]))
            num["weight"] = int(max(ui_adj.max(), ut_adj.max(), it_adj.max()))

        return HeteroGraph(num=num, user_items=user_items, ui_adj=ui_adj,
                           ut_adj=ut_adj, it_adj=it_adj, uit_data=uit)

    @property
    def n_user(self) -> int:
        return self.num["user"]

    @property
    def n_item(self) -> int:
        return self.num["item"]

    @property
    def n_tag(self) -> int:
        return self.num.get("tag", 0)

    @property
    def has_tags(self) -> bool:
        return self.ut_adj is not None

    @property
    def n_nodes(self) -> int:
        return self.n_user + self.n_item + self.n_tag

    def joint_norm_adj(self, norm_type: str, use_tag: bool = True) -> COO:
        """Joint adjacency -> normalized, as a row-sorted COO."""
        if use_tag and self.has_tags:
            adj = joint_adjacency(self.ui_adj, self.ut_adj, self.it_adj)
        else:
            adj = joint_adjacency(self.ui_adj)
        return normalize_adj(adj, norm_type).sorted_by_row()

    def summary(self) -> Dict[str, object]:
        """Load-time invariant stats: the schema checks the reference prints
        on every load (data/utils.py:109-129 column_info/dict_info)."""
        out = {"num": dict(self.num), "train_pairs": self.ui_adj.nnz,
               "max_multiplicity": self.ui_adj.max()}
        for split, d in self.user_items.items():
            e = self.edge_index[split]
            if len(e):
                out[split] = {"users": len(d), "pairs": len(e),
                              "item_range": (int(e[:, 1].min()),
                                             int(e[:, 1].max()))}
        if self.uit_data is not None:
            out["uit"] = {"triples": len(self.uit_data),
                          "tags": int(self.uit_data[:, 2].max()) + 1}
        return out

    def relation_edges(self) -> Dict[int, np.ndarray]:
        """Six globally-indexed directed relations [ui, iu, ut, tu, it, ti],
        each [2, E].  Items offset +n_user, tags +n_user+n_item."""
        off_i, off_t = self.n_user, self.n_user + self.n_item
        ui, ut, it = self.ui_adj, self.ut_adj, self.it_adj
        return {
            0: np.stack([ui.row, ui.col + off_i]),
            1: np.stack([ui.col + off_i, ui.row]),
            2: np.stack([ut.row, ut.col + off_t]),
            3: np.stack([ut.col + off_t, ut.row]),
            4: np.stack([it.row + off_i, it.col + off_t]),
            5: np.stack([it.col + off_t, it.row + off_i]),
        }
