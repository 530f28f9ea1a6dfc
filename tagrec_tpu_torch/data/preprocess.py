"""Offline dataset preprocessing — Hetrec2011 semantics (the port's copy of
tagrec_tpu/data/preprocess.py: numpy only, the same files byte for byte
from the same ``.dat`` and seed).

Re-derivation of the reference pipeline (data/preprocess/preprocess.py:12-59,
data/preprocess/help.py:7-169) for the three hetrec2011 datasets:

* read the tab-separated ``user_taggedbookmarks``/``user_taggedartists``/
  ``user_taggedmovies`` .dat file, keep (user, item, tag) columns
* drop tags with fewer than ``min_tag_count`` occurrences (15 for delicious,
  5 for lastfm/movielens)
* densify user and item ids (maps written to ``*_map.txt``)
* per-user random 80/20 train/test split; users with a single item go
  entirely to test
* write ``train.txt``/``test.txt`` in ``u i1 i2 ...`` format
* filter tag triples to train (u, i) pairs, densify tag ids, write
  ``user_item_tag.txt``
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# dataset -> (.dat file, min tag count) (reference preprocess.py:5-9)
DATASET_FILES = {
    "hetrec2011-delicious-2k": ("user_taggedbookmarks.dat", 15),
    "hetrec2011-lastfm-2k": ("user_taggedartists.dat", 5),
    "hetrec2011-movielens-2k-v2": ("user_taggedmovies.dat", 5),
}


def read_dat(path: str, n_cols: int = 3) -> np.ndarray:
    """Tab-separated .dat with a header line; take the first n_cols columns."""
    rows = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        header = True
        for line in f:
            if header:
                header = False
                continue
            parts = line.strip().split("\t")
            if len(parts) < n_cols:
                continue
            rows.append([int(x) for x in parts[:n_cols]])
    return np.asarray(rows, dtype=np.int64)


def drop_rare_tags(uit: np.ndarray, min_count: int) -> np.ndarray:
    """Drop triples whose tag occurs < min_count times (help.py delete_tag)."""
    tags, counts = np.unique(uit[:, 2], return_counts=True)
    keep = set(tags[counts >= min_count].tolist())
    mask = np.fromiter((t in keep for t in uit[:, 2]), dtype=bool,
                       count=len(uit))
    return uit[mask]


def densify(ids: np.ndarray) -> Tuple[np.ndarray, Dict[int, int]]:
    """Map raw ids to dense 0..n-1 (np.unique return_inverse, help.py:index_to_dense)."""
    uniq, inv = np.unique(ids, return_inverse=True)
    return inv, {int(raw): i for i, raw in enumerate(uniq)}


def split_user_items(pairs: np.ndarray, train_frac: float, rng) \
        -> Tuple[Dict[int, List[int]], Dict[int, List[int]]]:
    """Per-user random split; single-item users -> test
    (help.py random_split_user_items_dict:99-112)."""
    by_user: Dict[int, List[int]] = {}
    for u, i in pairs:
        by_user.setdefault(int(u), []).append(int(i))
    train, test = {}, {}
    for u, items in by_user.items():
        items = sorted(set(items))
        if len(items) == 1:
            test[u] = items
            continue
        k = int(round(len(items) * train_frac))
        k = min(max(k, 1), len(items) - 1)
        sel = rng.permutation(len(items))
        train[u] = sorted(items[j] for j in sel[:k])
        test[u] = sorted(items[j] for j in sel[k:])
    return train, test


def write_interactions(path: str, d: Dict[int, List[int]]) -> None:
    with open(path, "w") as f:
        for u in sorted(d):
            f.write(" ".join(str(x) for x in [u] + list(d[u])) + "\n")


def write_map(path: str, m: Dict[int, int]) -> None:
    with open(path, "w") as f:
        for raw, dense in sorted(m.items(), key=lambda kv: kv[1]):
            f.write(f"{raw} {dense}\n")


def preprocess_hetrec(data_root: str, dataset: str, out_dir: str | None = None,
                      train_frac: float = 0.8, seed: int = 2020) -> Dict[str, int]:
    """Run the full pipeline; returns entity counts."""
    dat_file, min_tag = DATASET_FILES[dataset]
    uit = read_dat(os.path.join(data_root, dataset, dat_file))
    uit = drop_rare_tags(uit, min_tag)

    dense_u, u_map = densify(uit[:, 0])
    dense_i, i_map = densify(uit[:, 1])
    uit = np.stack([dense_u, dense_i, uit[:, 2]], axis=1)

    out = out_dir or os.path.join(data_root, dataset + "-out")
    os.makedirs(out, exist_ok=True)
    write_map(os.path.join(out, "user_map.txt"), u_map)
    write_map(os.path.join(out, "item_map.txt"), i_map)

    pairs = np.unique(uit[:, :2], axis=0)
    rng = np.random.default_rng(seed)
    train, test = split_user_items(pairs, train_frac, rng)
    write_interactions(os.path.join(out, "train.txt"), train)
    write_interactions(os.path.join(out, "test.txt"), test)

    # filter triples to train pairs, then densify tags
    train_pairs = {(u, i) for u, items in train.items() for i in items}
    mask = np.fromiter(((int(r[0]), int(r[1])) in train_pairs for r in uit),
                       dtype=bool, count=len(uit))
    t_uit = uit[mask]
    dense_t, t_map = densify(t_uit[:, 2])
    t_uit = np.stack([t_uit[:, 0], t_uit[:, 1], dense_t], axis=1)
    write_map(os.path.join(out, "tag_map.txt"), t_map)
    t_uit = np.unique(t_uit, axis=0)
    with open(os.path.join(out, "user_item_tag.txt"), "w") as f:
        for u, i, t in t_uit:
            f.write(f"{u} {i} {t}\n")

    return {"user": len(u_map), "item": len(i_map), "tag": len(t_map),
            "train_pairs": sum(len(v) for v in train.values()),
            "test_pairs": sum(len(v) for v in test.values()),
            "triples": len(t_uit), "out_dir": out}


def main(argv=None):
    """Standalone preprocessing entry (the reference runs its pipeline as a
    script, data/preprocess/preprocess.py:62-64):

        python -m tagrec_tpu_torch.data.preprocess --data_root /data \
            --dataset hetrec2011-lastfm-2k
    """
    import argparse

    ap = argparse.ArgumentParser(description="hetrec2011 preprocessing")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--dataset", required=True, choices=sorted(DATASET_FILES))
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--train_frac", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=2020)
    args = ap.parse_args(argv)
    info = preprocess_hetrec(args.data_root, args.dataset, args.out_dir,
                             args.train_frac, args.seed)
    print(info)
    return info


if __name__ == "__main__":
    main()
