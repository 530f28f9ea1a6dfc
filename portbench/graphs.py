"""The benchmark's graphs: a vectorised copy of
``tagrec_tpu_torch/data/synthetic.py::synthetic_graph_large``.

``make`` draws the same arrays from the same seed as the original, in the
same order of random calls, but without its per-pair Python loops: the
{user: items} dicts and the edge lists come from sorted arrays split by
user, and duplicate-summed adjacencies from ``np.unique`` counts.  It
returns plain arrays (``RawGraph``), which the plain references read;
``to_hetero`` wraps them in the port's ``HeteroGraph`` for the system
under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class RawGraph:
    """A user-item-tag graph as arrays.

    train, test: [E, 2] int64 (user, item) pairs, unique, sorted by user
                 then item
    uit:         [A, 3] int64 unique (user, item, tag) assignments over the
                 train pairs, sorted
    """

    n_user: int
    n_item: int
    n_tag: int
    train: np.ndarray
    test: np.ndarray
    uit: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.n_user + self.n_item + self.n_tag


def _unique_rows(cols: List[np.ndarray], sizes: List[int]) -> np.ndarray:
    """``np.unique(np.stack(cols, 1), axis=0)`` for non-negative integer
    columns below ``sizes``: one int64 key a row, the same sorted order."""
    key = np.zeros(len(cols[0]), dtype=np.int64)
    for c, s in zip(cols, sizes):
        key = key * s + c
    key = np.unique(key)
    out = np.empty((len(key), len(cols)), dtype=np.int64)
    for j in range(len(cols) - 1, -1, -1):
        out[:, j] = key % sizes[j]
        key = key // sizes[j]
    return out


def make(n_user: int, n_item: int, n_tag: int, n_edges: int,
         tag_per_inter: float = 0.5, seed: int = 0,
         test_frac: float = 0.2) -> RawGraph:
    """The graph ``synthetic_graph_large`` draws with these arguments."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / (np.arange(1, n_item + 1) ** 0.8)
    cdf = np.cumsum(pop / pop.sum())
    m = int(n_edges * 1.3) + n_user
    u = rng.integers(0, n_user, m)
    i = np.searchsorted(cdf, rng.random(m)).clip(0, n_item - 1)
    pairs = _unique_rows([u, i], [n_user, n_item])
    if len(pairs) > n_edges:
        pairs = pairs[rng.choice(len(pairs), n_edges, replace=False)]
    cnt = np.bincount(pairs[:, 0], minlength=n_user)
    need = np.where(cnt < 2)[0]
    if len(need):
        extra = np.stack([np.repeat(need, 2),
                          rng.integers(0, n_item, 2 * len(need))], axis=1)
        both = np.concatenate([pairs, extra])
        pairs = _unique_rows([both[:, 0], both[:, 1]], [n_user, n_item])

    # the pairs are distinct, so sorting their keys is the lexsort by
    # (user, item)
    key = np.sort(pairs[:, 0] * n_item + pairs[:, 1])
    pairs = np.stack([key // n_item, key % n_item], axis=1)
    starts = np.searchsorted(pairs[:, 0], np.arange(n_user))
    is_test = rng.random(len(pairs)) < test_frac
    is_test[starts[np.bincount(pairs[:, 0], minlength=n_user) > 0]] = False
    train = pairs[~is_test]

    n_assign = int(len(train) * tag_per_inter) + n_tag
    sel = rng.integers(0, len(train), n_assign)
    tpop = 1.0 / (np.arange(1, n_tag + 1) ** 0.9)
    tcdf = np.cumsum(tpop / tpop.sum())
    tags = np.searchsorted(tcdf, rng.random(n_assign)).clip(0, n_tag - 1)
    tags[:n_tag] = np.arange(n_tag)
    uit = _unique_rows([train[sel, 0], train[sel, 1], tags],
                       [n_user, n_item, n_tag])
    return RawGraph(n_user, n_item, n_tag, train, pairs[is_test], uit)


def user_lists(pairs: np.ndarray) -> Dict[int, List[int]]:
    """{user: items} of [E, 2] pairs sorted by user, in their order."""
    if not len(pairs):
        return {}
    users, starts = np.unique(pairs[:, 0], return_index=True)
    return dict(zip(users.tolist(),
                    (a.tolist() for a in np.split(pairs[:, 1], starts[1:]))))


def _counted(row: np.ndarray, col: np.ndarray, n_cols: int):
    """(row, col, float32 multiplicity) of the distinct (row, col) pairs,
    sorted: what ``COO.from_edges`` makes of unit-valued edges."""
    key, cnt = np.unique(row * n_cols + col, return_counts=True)
    return key // n_cols, key % n_cols, cnt.astype(np.float32)


def to_hetero(raw: RawGraph):
    """The port's ``HeteroGraph`` of ``raw``, as ``synthetic_graph_large``
    returns it."""
    from tagrec_tpu_torch.data.graph import COO, HeteroGraph

    ui = COO(*_counted(raw.train[:, 0], raw.train[:, 1], raw.n_item),
             (raw.n_user, raw.n_item))
    ut = COO(*_counted(raw.uit[:, 0], raw.uit[:, 2], raw.n_tag),
             (raw.n_user, raw.n_tag))
    it = COO(*_counted(raw.uit[:, 1], raw.uit[:, 2], raw.n_tag),
             (raw.n_item, raw.n_tag))
    num = {"user": raw.n_user, "item": raw.n_item, "tag": raw.n_tag,
           "weight": int(max(ui.max(), ut.max(), it.max()))}
    return HeteroGraph(
        num=num,
        user_items={"train": user_lists(raw.train),
                    "test": user_lists(raw.test)},
        ui_adj=ui, ut_adj=ut, it_adj=it, uit_data=raw.uit,
        edge_index={"train": raw.train.copy(), "test": raw.test.copy()})
