#!/usr/bin/env python3
"""``ell_mm_t``'s three forms on the card, at LightGCN's 10x hybrid tier.

``ops.propagate.ell_mm_t`` is A^T @ g over one ELL table, the backward of
an SpMM over a dropped adjacency (LightGCN's and NGCF's ``node_drop``).
Three ways to add its real slots (k < deg[n]):

- ``nonzero``: find them with ``torch.nonzero`` on every call, a host
  read that a CUDA graph cannot hold (the form before the step capture);
- ``select``: add every slot, the pad slots' terms selected to zero
  (graph-safe, but it works the pads too);
- ``live``: scatter over the real-slot list that ``ops.ell.to_device``
  builds once on the host (``Ell.live``): graph-safe, the port's form.

This script times the three on the 10x graph's ELL buckets (150,000
nodes, the hub columns in the dense block), per bucket and summed, by
CUDA events (median of 7 after a warm-up), at D = 64, and checks that
they agree (float32 sums by atomics in another order: rtol 1e-5, atol
1e-6).
Beside them, the rest of a dropped layer's backward and the dropout
itself: the hub block's transpose product and ``edge_dropout`` of the
whole adjacency at ``node_drop`` 0.1.

    python3 experiments/torch_ell_mm_t_forms.py

Needs one NVIDIA GPU; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tagrec_tpu_torch.data.synthetic import synthetic_graph_large  # noqa: E402
from tagrec_tpu_torch.ops import ell as ell_lib  # noqa: E402
from tagrec_tpu_torch.ops.propagate import (block_t_mm, edge_dropout,  # noqa: E402
                                            ell_mm_t)

LGCN_10X = (20000, 100000, 30000, 4_000_000)  # chip_smoke.py's 10x graph
D = 64


def ell_mm_t_nonzero(ell, g, n_cols, budget=1 << 30):
    """The parent's form: the real slots found by ``torch.nonzero``."""
    n, k = ell.idx.shape
    d = g.shape[1]
    out = g.new_zeros((n_cols, d))
    chunk = max(budget // max(k * d * g.element_size(), 1), 1)
    slots = torch.arange(k, device=g.device)
    for i in range(0, n, chunk):
        r, s = torch.nonzero(slots[None, :] < ell.deg[i:i + chunk, None],
                             as_tuple=True)
        cols = ell.idx[i:i + chunk][r, s].long()
        out.index_add_(0, cols, ell.val[i:i + chunk][r, s][:, None]
                       * g[i + r])
    return out


def ell_mm_t_select(ell, g, n_cols, budget=1 << 30):
    """Every slot added, a pad's term selected to zero."""
    n, k = ell.idx.shape
    d = g.shape[1]
    out = g.new_zeros((n_cols, d))
    chunk = max(budget // max(k * d * g.element_size(), 1), 1)
    slots = torch.arange(k, device=g.device)
    for i in range(0, n, chunk):
        live = slots[None, :] < ell.deg[i:i + chunk, None]
        terms = torch.where(live[:, :, None], ell.val[i:i + chunk, :, None]
                            * g[i:i + chunk, None, :], 0.0)
        out.index_add_(0, ell.idx[i:i + chunk].reshape(-1).long(),
                       terms.reshape(-1, d))
    return out


FORMS = {"live": ell_mm_t, "select": ell_mm_t_select,
         "nonzero": ell_mm_t_nonzero}


def events_ms(fn, runs=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in times)[runs // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    graph = synthetic_graph_large(*LGCN_10X, 0.3, seed=0)
    nums = (graph.n_user, graph.n_item, graph.n_tag)
    host = ell_lib.build_adj_pair(graph.joint_norm_adj("bi_norm", True),
                                  symmetric=True, mode="auto",
                                  sectors=nums)
    adj = ell_lib.to_device(host, "cuda")
    n = sum(nums)
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = dict.fromkeys(FORMS, 0.0)
    ok = True
    for i, part in enumerate(adj.fwd.ell.parts):
        rows, k = part.idx.shape
        g = torch.randn((rows, D), generator=gen, device="cuda")
        fill = float(part.deg.sum()) / max(rows * k, 1)
        ms = {key: events_ms(lambda: fn(part, g, n))
              for key, fn in FORMS.items()}
        want = ell_mm_t_nonzero(part, g, n)
        same = all(torch.allclose(fn(part, g, n), want, rtol=1e-5, atol=1e-6)
                   for fn in FORMS.values())
        ok &= same
        for key in total:
            total[key] += ms[key]
        print(f"bucket {i}: {rows} x {k}, {fill:.3f} of the slots real: "
              + ", ".join(f"{key} {v:.3f} ms" for key, v in ms.items())
              + f"; {'agree' if same else 'DIFFER'}")
    print(f"one ell_mm_t over every bucket at D = {D}: "
          + ", ".join(f"{key} {v:.3f} ms" for key, v in total.items())
          + f" (CUDA events, median of 7; {card})")
    block = adj.fwd.dense_block
    g = torch.randn((n, D), generator=gen, device="cuda")
    hub_ms = events_ms(lambda: block_t_mm(block, g))
    drop_ms = events_ms(lambda: edge_dropout(adj, 0.1, gen, True))
    print(f"hub block {tuple(block.shape)}: its transpose product "
          f"{hub_ms:.3f} ms; edge_dropout of the adjacency {drop_ms:.3f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
