#!/usr/bin/env python3
"""The seven edge sweeps' device times on one NVIDIA GPU, with the package
and ``chip_smoke.py`` of a given tree.

Builds the routing and flash kernels and ``chip_smoke.py``'s hetrec
graph, then times each sweep over its whole mask at the main path's
shapes by ``chip_smoke.device_ms`` (10 calls captured in a CUDA graph,
its replays timed by CUDA events): ``routed_rowsum``, ``routed_mm`` and
``routed_mm_bwd`` over DGCF's joint mask at F = 4, r = 80, dx = 16 (the
mask is its own transpose; over its edge list where the tree's routing
wrappers take one, ``edges=``); ``dot_flash_stats``, ``dot_flash_apply``,
``dot_bwd_row`` and ``dot_bwd_col`` summed over KGAT ``bi_inter``'s three
row types at dq = dx = 64.  Prints one JSON line of ms a call.
``--tree`` names the checkout whose ``tagrec_tpu_torch`` and
``chip_smoke.py`` run (default: this one), so two trees compare in one
call on one card, in the order parent, change, change, parent:

    python3 experiments/torch_sweep_times.py --tree /path/to/parent
    python3 experiments/torch_sweep_times.py

Needs one NVIDIA GPU; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SEED = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import tagrec_tpu_torch
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import _build, dense_adj
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr

    if not torch.cuda.is_available():
        print("no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    assert tagrec_tpu_torch.__file__.startswith(tree), tagrec_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    _build.build(["routed_rowsum", "routed_mm", "dot_flash_stats",
                  "dot_flash_apply", "dot_flash_bwd_row",
                  "dot_flash_bwd_col"])
    graph = synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG, cs.N_EDGES,
                                  cs.TAG_PER_INTER, seed=0)
    coo = graph.joint_norm_adj("plain", True)
    mask = torch.from_numpy(dense_adj.dense_mask_host(
        coo.row, coo.col, *coo.shape)).cuda()
    q, k, x = cs.kernel_inputs(torch, 4, mask.shape[0], 80, 16, SEED)
    g = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    # a tree from before the edge lists sweeps the dense mask
    kw = {"edges": fr.mask_edges(mask)} if hasattr(fr, "mask_edges") else {}
    out = {}
    with torch.no_grad():
        for name, fn in (
                ("routed_rowsum",
                 lambda: fr.routed_rowsum(q, k, mask, 1.0, **kw)),
                ("routed_mm", lambda: fr.routed_mm(q, k, mask, x, 1.0, **kw)),
                ("routed_mm_bwd",
                 lambda: fr.routed_mm_bwd(q, k, mask, g, 1.0, **kw))):
            out[name] = cs.device_ms(torch, fn)
        del mask, q, k, x, g, kw
        kgat = model_class("kgat")(graph, model_preset(
            "kgat", agg_type="bi_inter"), device="cuda",
            generator=torch.Generator().manual_seed(0))
        flash = dict.fromkeys(cs.FLASH, 0.0)
        for a, (fm, fmt, split) in enumerate(zip(
                kgat.flash_masks(), kgat.flash_masks_t(),
                kgat.flash_splits())):
            q2, kk, xx, gg = cs.flash_inputs(torch, *fm.shape, 64, SEED + a)
            m, z = fa.dot_flash_stats(q2, kk, fm, split)
            o = fa.dot_flash_apply(q2, kk, fm, m, z, xx, split)
            delta = torch.sum(gg * o, dim=1)
            args = (m, z, xx, gg, delta, split)
            for name, fn in (
                    ("dot_flash_stats",
                     lambda: fa.dot_flash_stats(q2, kk, fm, split)),
                    ("dot_flash_apply",
                     lambda: fa.dot_flash_apply(q2, kk, fm, m, z, xx, split)),
                    ("dot_bwd_row",
                     lambda: fa.dot_bwd_row(q2, kk, fm, *args)),
                    ("dot_bwd_col",
                     lambda: fa.dot_bwd_col(q2, kk, fmt, *args))):
                flash[name] += cs.device_ms(torch, fn)
        out.update(flash)
    print(json.dumps({"tree": tree, "card": card,
                      "ms": {k: round(v, 5) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
