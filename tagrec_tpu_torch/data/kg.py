"""Knowledge-graph loader (a copy of tagrec_tpu/data/kg.py; reference
``KGAT_load``, data/kgat_load.py:8-50).

Reads ``kg_final.txt`` (h r t triples), counts the entities and the
relations with their reverses, and builds the full triplet set: the
user-item interactions as relation 0, the KG triples shifted +1, and their
reversed copies with relations offset by num_rela + 1, items and entities
offset by n_user.  The file is read with the port's ``io.read_triple_file``
(JAX's native reader gives the same rows after the dedup).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.data.io import read_triple_file


class KnowledgeGraph:
    def __init__(self, graph: HeteroGraph, data_root: str, dataset: str):
        self.graph = graph
        path = os.path.join(data_root, dataset, "kg_final.txt")
        self.kg_data = np.unique(read_triple_file(path), axis=0)
        self._finish_init()

    @classmethod
    def synthetic(cls, graph: HeteroGraph, n_entity: int = 15_000,
                  n_triples: int = 500_000, n_rela: int = 6,
                  seed: int = 0) -> "KnowledgeGraph":
        """An in-memory KG (no kg_final.txt on disk).

        Entities 0..n_entity-1 include the items (item ids are the low
        entity ids).  Free of parallel edges by construction: one relation
        per unique (h, t) pair, and h < t, so the reverse copies cannot
        collide either; the relation-dense tier of KGAT stays eligible."""
        self = cls.__new__(cls)
        self.graph = graph
        rng = np.random.default_rng(seed)
        h = rng.integers(0, n_entity, int(n_triples * 1.3))
        t = rng.integers(0, n_entity, int(n_triples * 1.3))
        h, t = np.minimum(h, t), np.maximum(h, t)
        keep = h != t
        h, t = h[keep], t[keep]
        _, first = np.unique(h.astype(np.int64) * n_entity + t,
                             return_index=True)
        h, t = h[first][:n_triples], t[first][:n_triples]
        r = rng.integers(0, n_rela, len(h))
        self.kg_data = np.unique(  # the file loader's (h, r, t) sort
            np.stack([h, r, t], axis=1).astype(np.int64), axis=0)
        self._finish_init()
        return self

    def _finish_init(self) -> None:
        h_max = int(self.kg_data[:, 0].max())
        r_max = int(self.kg_data[:, 1].max())
        t_max = int(self.kg_data[:, 2].max())
        # entities are max(h, t) + 1; (num_rela + 1) * 2 relations count the
        # interaction relation 0 and the reversed copies
        # (data/kgat_load.py:14-17)
        self.num_entity = max(h_max, t_max) + 1
        self.num_rela = r_max + 1
        self.num_relation = (self.num_rela + 1) * 2
        self.all_triplet = self._build_triplets()

    def _build_triplets(self) -> np.ndarray:
        """(h, r, t) over users + entities (data/kgat_load.py:22-38)."""
        g = self.graph
        edges = g.edge_index["train"]
        user = edges[:, 0]
        item = edges[:, 1] + g.n_user
        ui = np.stack([user, np.zeros_like(user), item], axis=1)
        r_ui = ui[:, [2, 1, 0]].copy()
        r_ui[:, 1] += self.num_rela + 1

        head = self.kg_data[:, 0] + g.n_user
        rela = self.kg_data[:, 1] + 1
        tail = self.kg_data[:, 2] + g.n_user
        kg = np.stack([head, rela, tail], axis=1)
        r_kg = kg[:, [2, 1, 0]].copy()
        r_kg[:, 1] += self.num_rela + 1
        return np.concatenate([ui, r_ui, kg, r_kg], axis=0)

    def relation_dict(self) -> Dict[int, np.ndarray]:
        """{relation: [N, 2] (head, tail)} (data/kgat_load.py:40-50)."""
        out = {}
        for k in range(self.num_relation):
            sel = self.all_triplet[:, 1] == k
            out[k] = self.all_triplet[sel][:, [0, 2]]
        return out
