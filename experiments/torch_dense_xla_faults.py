"""Does chip_smoke.py's hold of the kernel tiers against ``dense_xla`` catch
a wrong backward?  On one NVIDIA GPU.

DGCF, DisenGCN and KGAT ``bi_inter`` at the preset's full width on the
hetrec graph: the chunked dense tier in float64 and in float32 is computed
once per model, then the kernel tier is held against them
(chip_smoke.hold_tiers: the forward tables, the BPR gradients and the
forward's vector-Jacobian product) as it is and with a fault planted in
one backward wrapper, in this process only:

* routed_mm_bwd zeroed (DGCF, DisenGCN);
* routed_mm_bwd with q and k unswapped, P g where P^T g is due (DGCF,
  DisenGCN);
* dot_bwd_row's dq2 zeroed (KGAT);
* dot_bwd_col's dx zeroed (KGAT);
* dot_bwd_col's dk zeroed (KGAT).

Exits 0 when every clean hold passes and every planted fault fails it.

    python3 experiments/torch_dense_xla_faults.py     # from the repo root

Needs one GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _zeroed(orig, *args, **kw):
    return torch.zeros_like(orig(*args, **kw))


def _unswapped(orig, q, k, mask_t, g, base=0.0, **kw):
    return orig(k, q, mask_t, g, base, **kw)


def _zero_part(part):
    def fault(orig, *args, **kw):
        out = list(orig(*args, **kw))
        out[part] = torch.zeros_like(out[part])
        return tuple(out)
    return fault


# (label, module name, wrapper, fault(orig, *args), models)
FAULTS = (
    ("routed_mm_bwd zeroed", "fr", "routed_mm_bwd", _zeroed,
     ("dgcf", "disengcn")),
    ("routed_mm_bwd with q and k unswapped", "fr", "routed_mm_bwd",
     _unswapped, ("dgcf", "disengcn")),
    ("dot_bwd_row zeroed", "fa", "dot_bwd_row", _zeroed, ("kgat",)),
    ("dot_bwd_col dx zeroed", "fa", "dot_bwd_col", _zero_part(1), ("kgat",)),
    ("dot_bwd_col dk zeroed", "fa", "dot_bwd_col", _zero_part(0), ("kgat",)),
)


def planted(mod, name, fault):
    """Replace ``mod.name`` by ``fault`` around it -> the restoring call.
    The wrapper carries its own launch count, which the original's
    ``<name>.launches += 1`` then increments."""
    orig = getattr(mod, name)

    def wrapper(*args, **kw):  # the routing wrappers take edges=
        return fault(orig, *args, **kw)

    wrapper.launches = 0
    setattr(mod, name, wrapper)
    return lambda: setattr(mod, name, orig)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.ops import _build
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    print(card)
    _build.build(["routed_rowsum", "routed_mm", "dot_flash_stats",
                  "dot_flash_apply", "dot_flash_bwd_row", "dot_flash_bwd_col"])
    mods = {"fr": fr, "fa": fa}
    graph = synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG, cs.N_EDGES,
                                  cs.TAG_PER_INTER, seed=0)
    batch = cs.dense_xla_batch(torch, graph)
    held = {}
    for name, cfg in cs.DENSE_XLA_MODELS:
        ref, plain = (cs.tier_run(torch, graph, name, cfg, "dense_xla",
                                  dtype, batch, fr, fa)
                      for dtype in (torch.float64, torch.float32))
        runs = [("clean", None)] + [(f[0], f) for f in FAULTS if name in f[4]]
        for label, fault in runs:
            restore = (planted(mods[fault[1]], fault[2], fault[3])
                       if fault else None)
            try:
                kern = cs.tier_run(torch, graph, name, cfg, "auto",
                                   torch.float32, batch, fr, fa)
            finally:
                if restore:
                    restore()
            ok = cs.hold_tiers(torch, name, kern, plain, ref)
            print(f"{name}, {label}: hold {'passes' if ok else 'fails'}")
            held[f"{name}: {label}"] = ok
            del kern
            cs.gc_cuda(torch)
        del ref, plain
        cs.gc_cuda(torch)
    print(card)
    print(json.dumps({"held": held}))
    right = all(ok == label.endswith("clean") for label, ok in held.items())
    print("every clean hold passes and every planted fault fails"
          if right else "a clean hold failed or a planted fault passed")
    return 0 if right else 1


if __name__ == "__main__":
    sys.exit(main())
