"""On-device negative and positive sampling (tagrec_tpu/ops/sampling.py).

Positive sets live on the device; negatives are drawn uniformly with a fixed
number of masked re-draw rounds in place of a host rejection loop.  After R
rounds the chance that a drawn id is still a positive is (density)^R,
negligible for CF densities; in that case the last candidate is kept, so the
shapes stay fixed.  Draws come from an explicit ``torch.Generator`` on the
tables' device.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class PosTable(NamedTuple):
    """Padded per-head positive-id table.

    table: [H, P] int64, padded with ``n_ids`` (out of range, so it never
           equals a candidate)
    deg:   [H] int64, the number of valid entries per head
    n_ids: the size of the candidate id space
    """

    table: torch.Tensor
    deg: torch.Tensor
    n_ids: int


def build_pos_table(pos_dict: Dict[int, List[int]], n_heads: int, n_ids: int,
                    pad_multiple: int = 8, device="cuda") -> PosTable:
    """Build the padded positive table from a {head: ids} dict."""
    deg = np.zeros(n_heads, dtype=np.int64)
    for h, ids in pos_dict.items():
        deg[h] = len(ids)
    p = int(deg.max()) if n_heads and deg.max() > 0 else 1
    p = -(-p // pad_multiple) * pad_multiple
    table = np.full((n_heads, p), n_ids, dtype=np.int64)
    for h, ids in pos_dict.items():
        table[h, :len(ids)] = ids
    return PosTable(torch.from_numpy(table).to(device),
                    torch.from_numpy(deg).to(device), int(n_ids))


def contains(pt: PosTable, heads: torch.Tensor,
             cand: torch.Tensor) -> torch.Tensor:
    """[B] bool: is cand[b] among head[b]'s positives."""
    return torch.any(pt.table[heads] == cand[:, None], dim=1)


def _first_good(cands: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """Per column of the [R, B] candidates, the first one that is not bad
    (the last one when all are)."""
    good = ~bad
    first = torch.argmax(good.to(torch.uint8), dim=0)
    sel = torch.where(torch.any(good, dim=0), first, cands.shape[0] - 1)
    return torch.gather(cands, 0, sel[None, :])[0]


def sample_negatives(generator: torch.Generator, pt: PosTable,
                     heads: torch.Tensor, rounds: int = 16) -> torch.Tensor:
    """Uniform negatives outside each head's positive set: ``rounds``
    candidates per head at once, the first one that is no positive kept."""
    rows = pt.table[heads]                                        # [B, P]
    cands = torch.randint(0, pt.n_ids, (rounds, heads.shape[0]),
                          generator=generator, device=heads.device)
    bad = torch.any(cands[:, :, None] == rows[None, :, :], dim=-1)  # [R, B]
    return _first_good(cands, bad)


def sample_positive(generator: torch.Generator, pt: PosTable,
                    heads: torch.Tensor) -> torch.Tensor:
    """One uniformly drawn positive id per head: a draw below 2**31 - 1
    modulo the head's degree (at least 1), as JAX draws it."""
    deg = torch.clamp(pt.deg[heads], min=1)
    j = torch.randint(0, 2**31 - 1, heads.shape, generator=generator,
                      device=heads.device) % deg
    return torch.gather(pt.table[heads], 1, j[:, None])[:, 0]


class TripleSet(NamedTuple):
    """Sorted membership set of observed (key = h * n_rel + r, tail) pairs
    for corrupted-tail sampling, each pair one int64 code
    ``key * n_ids + tail`` (O(T) memory and no padding, unlike a per-key
    table on a graph with hub heads).  JAX keeps two int32 arrays, as its
    default mode has no int64; the code orders the pairs the same way."""

    codes: torch.Tensor  # [T] int64, sorted
    n_ids: int


def build_triple_set(triples: np.ndarray, n_rel: int, n_ids: int,
                     device="cuda"):
    """-> (TripleSet, per-triple int64 flat keys h * n_rel + r) for [T, 3]
    (h, r, t) triples."""
    if len(triples) == 0:
        raise ValueError("build_triple_set: empty triple array")
    h, r, t = (triples[:, c].astype(np.int64) for c in range(3))
    keys = h * n_rel + r
    if keys.max() >= 2**31 or n_ids >= 2**31:
        raise ValueError("triple keys or tail ids beyond 2**31")
    codes = np.sort(keys * n_ids + t)
    return (TripleSet(torch.from_numpy(codes).to(device), int(n_ids)),
            torch.from_numpy(keys).to(device))


def _pair_member(ts: TripleSet, k: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Is each (k, t) pair in the set?  A binary search over the codes."""
    code = k * ts.n_ids + t
    idx = torch.searchsorted(ts.codes, code)
    hit = ts.codes[torch.clamp(idx, max=ts.codes.shape[0] - 1)] == code
    return hit & (idx < ts.codes.shape[0])


def sample_negatives_from_set(generator: torch.Generator, ts: TripleSet,
                              keys: torch.Tensor,
                              rounds: int = 16) -> torch.Tensor:
    """Uniform corrupted tails outside each key's observed tails, with the
    masked re-draw scheme of ``sample_negatives``."""
    cands = torch.randint(0, ts.n_ids, (rounds, keys.shape[0]),
                          generator=generator, device=keys.device)
    bad = _pair_member(ts, keys[None, :].expand_as(cands), cands)
    return _first_good(cands, bad)
