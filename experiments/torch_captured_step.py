#!/usr/bin/env python3
"""One training path captured on one NVIDIA GPU, with the package and
``chip_smoke.py`` of a given tree.

Builds the gather kernels and ``chip_smoke.py``'s graph for the path,
then runs ``chip_smoke.capture_hold`` on its pipeline (two eager runs and
one captured run from one snapshot, held against each other; ms a step
eager and captured, a phase's wall with one sync, a replay's device busy
time, idle share and operations, the peak) and prints its rows, and the
largest device operations of a replay of the first phase (profiler), as
one JSON line.  The paths: ``tgcn_ell`` (TGCN ``adj_mode="ell"`` at hetrec),
``dgcf_10x`` and ``kgat_10x`` (DGCF and KGAT ``bi_inter`` on the 10x
graph, where ``auto`` takes the EdgeMap tier), ``disenhan`` (DisenHAN
at hetrec, its dense tier) and ``kg`` (KGAT ``bi_inter`` over
``chip_smoke.py``'s phase-K KG, the relation-dense tier).  ``--tree`` names the
checkout whose ``tagrec_tpu_torch`` and ``chip_smoke.py`` run (default:
this one), so two trees compare in one call on one card, in the order
parent, change, change, parent:

    python3 experiments/torch_captured_step.py tgcn_ell --tree /path/to/parent
    python3 experiments/torch_captured_step.py tgcn_ell

Needs one NVIDIA GPU; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# path: (graph, model, preset overrides, the tier it must take)
PATHS = {"tgcn_ell": ("hetrec", "tgcn", {"adj_mode": "ell"}, "ell"),
         "dgcf_10x": ("10x", "dgcf", {}, "ell"),
         "kgat_10x": ("10x", "kgat", {"agg_type": "bi_inter"}, "ell"),
         "disenhan": ("hetrec", "disenhan", {}, "dense"),
         "kg": ("kg", "kgat", {"agg_type": "bi_inter"}, "kg_rel_dense")}
TOP_OPS = 14  # the replay's largest device operations printed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", choices=sorted(PATHS))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import tagrec_tpu_torch
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.ops import _build
    from tagrec_tpu_torch.training.train import WARMUP_STEPS, Trainer

    if not torch.cuda.is_available():
        print("no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    assert tagrec_tpu_torch.__file__.startswith(tree), tagrec_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    print(card, torch.__version__, torch.version.cuda, tree)
    _build.build(["gather_reduce", "gather_rows"])
    g, name, over, tier = PATHS[args.path]
    graph = (synthetic_graph_large(*cs.LGCN_10X, cs.TAG_PER_INTER, seed=0)
             if g == "10x" else
             synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG,
                                   cs.N_EDGES, cs.TAG_PER_INTER, seed=0))
    kg = None
    if g == "kg":
        from tagrec_tpu_torch.data.kg import KnowledgeGraph

        kg = KnowledgeGraph.synthetic(graph, **cs.KG_SIZE)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset(name, **over), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cuda", kg=kg)
    cs.check(pipe.model.tier == tier, f"{args.path}: took {pipe.model.tier}")
    cs.capture_hold(torch, args.path, pipe.model, pipe.phases, tcfg)
    # the first phase's replay by device operation, from a fresh trainer
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    phase = pipe.phases[0]
    trainer.run_phase(phase, max_steps=WARMUP_STEPS + 1)
    run = trainer.runs[phase.name]
    run.counter.zero_()
    ops = cs.replay_ops(torch, run.graph)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP_OPS]
    print(json.dumps({"tree": tree, "path": args.path, "card": card,
                      "rows": cs.CAPTURED,
                      "top_ops": [(k[:90], n, round(ms, 4))
                                  for k, (n, ms) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
