"""Where the port's edge-sweep kernels spend their time, on one NVIDIA GPU.

routed_rowsum and routed_mm (DGCF, at every rank of a forward),
dot_flash_stats (KGAT bi_inter, each row type), dot_flash_apply and
dot_bwd_row (each row type, dx 64 and 32), and dot_bwd_col (the same, over
the transposed mask) run on three masks at the hetrec graph's shapes:

* full: the model's own mask (for dot_bwd_col its transpose);
* light rows: the same mask with every row of more than 400 edges
  cleared (what is left once the heaviest rows' tail is gone; for
  dot_bwd_col the rows of the transpose, the attention's columns);
* empty: no edge at all (the flash kernels' mask stream and per-row
  fixed cost; the routing kernels read each mask's edge list, built once
  here, so theirs is a launch over empty segments).

Each time is the kernel's device time from torch.profiler, averaged over 10
launches after one warm-up (chip_smoke.device_ms), so the host's launch
overhead is not in it.  The KGAT kernels take each mask's own stats.

    python3 experiments/torch_edge_sweep_split.py     # from the repo root

Needs one GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

HEAVY = 400  # edges: rows past it are cleared in the "light rows" mask


def masks(mask: torch.Tensor) -> dict:
    deg = (mask != 0).sum(dim=1)
    light = mask * (deg <= HEAVY)[:, None].to(mask.dtype)
    return {"full": mask, "light rows": light, "empty": torch.zeros_like(mask)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    graph = synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG, cs.N_EDGES,
                                  cs.TAG_PER_INTER, seed=0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        dgcf = model_class("dgcf")(graph, model_preset("dgcf"), device="cuda",
                                   generator=gen)
        n = dgcf.mask.shape[0]
        variants = masks(dgcf.mask)
        lists = {id(mk): fr.mask_edges(mk) for mk in variants.values()}
        print(f"DGCF mask {n}x{n}: " + ", ".join(
            f"{name} {int(mk.sum())} edges" for name, mk in variants.items()))
        for r in cs.DGCF_RANKS:
            q, k, x = cs.kernel_inputs(torch, 4, n, r, 16, seed=r)
            kernels = {"routed_rowsum": lambda mk: fr.routed_rowsum(
                           q, k, mk, 1.0, edges=lists[id(mk)]),
                       "routed_mm": lambda mk: fr.routed_mm(
                           q, k, mk, x, 1.0, edges=lists[id(mk)])}
            for kname, kern in kernels.items():
                print(f"{kname} r={r}: " + ", ".join(
                    f"{name} {cs.device_ms(torch, lambda: kern(mk)):.4f} ms"
                    for name, mk in variants.items()))
        del dgcf, variants, lists
        kgat = model_class("kgat")(graph, model_preset("kgat",
                                                       agg_type="bi_inter"),
                                   device="cuda", generator=gen)
        for a, (mask, mask_t, split) in enumerate(zip(
                kgat.flash_masks(), kgat.flash_masks_t(),
                kgat.flash_splits())):
            ns, nd = mask.shape
            variants = masks(mask)
            # dot_bwd_col's: light rows of the transpose, and each one's
            # mask for the stats and the apply
            variants_t = {name: (mt.T.contiguous(), mt)
                          for name, mt in masks(mask_t).items()}
            for dx, _ in cs.KGAT_DX:
                q2, k, x, g = cs.flash_inputs(torch, ns, nd, dx, seed=a)
                times = {"dot_flash_apply": {}, "dot_bwd_row": {},
                         "dot_bwd_col": {}}
                if dx == cs.KGAT_DX[0][0]:  # stats does not depend on dx
                    times["dot_flash_stats"] = {
                        name: cs.device_ms(torch, lambda: fa.dot_flash_stats(
                            q2, k, mk, split))
                        for name, mk in variants.items()}
                edges = {"dot_bwd_col": variants_t["light rows"][1]}
                for name, mk in variants.items():
                    m, z = fa.dot_flash_stats(q2, k, mk, split)
                    delta = torch.sum(
                        g * fa.dot_flash_apply(q2, k, mk, m, z, x, split), 1)
                    times["dot_flash_apply"][name] = cs.device_ms(
                        torch, lambda: fa.dot_flash_apply(q2, k, mk, m, z, x,
                                                          split))
                    times["dot_bwd_row"][name] = cs.device_ms(
                        torch, lambda: fa.dot_bwd_row(q2, k, mk, m, z, x, g,
                                                      delta, split))
                for name, (mk, mt) in variants_t.items():
                    m, z = fa.dot_flash_stats(q2, k, mk, split)
                    delta = torch.sum(
                        g * fa.dot_flash_apply(q2, k, mk, m, z, x, split), 1)
                    times["dot_bwd_col"][name] = cs.device_ms(
                        torch, lambda: fa.dot_bwd_col(q2, k, mt, m, z, x, g,
                                                      delta, split))
                for kname, by_mask in times.items():
                    light = edges.get(kname, variants["light rows"])
                    print(f"{kname} type {a} ({ns}x{nd}, "
                          f"{int(variants['full'].ne(0).sum())} edges, light "
                          f"rows {int(light.ne(0).sum())}) "
                          f"dx={dx}: " + ", ".join(
                              f"{name} {ms:.4f} ms"
                              for name, ms in by_mask.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
