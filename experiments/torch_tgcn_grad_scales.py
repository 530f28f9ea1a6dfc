#!/usr/bin/env python3
"""The scale of each TGCN parameter's gradient, in float64, on the CPU.

Some of TGCN's gradients are far below the largest: if one is zero in
exact arithmetic, what a run holds there is rounding residue, and two
runs that sum in another order (one device against a ``model`` mesh)
differ there by the whole of its value, in float64 as in float32.  This
script builds TGCN at the preset's width (``model_preset("tgcn")``, three
layers) on a seeded synthetic graph, casts it to float64, takes one BPR
step from the initial parameters on the phase's first batch through the
``Trainer`` (as ``chip_smoke.py`` R5b's float64 step does), and prints
each parameter's max |g| over the largest gradient's, smallest first:

    python3 experiments/torch_tgcn_grad_scales.py [--mode dense_xla]

A gradient of 1e-16 of the largest or less is float64's rounding of
cancelling terms, which is zero in exact arithmetic.  Runs on the CPU in
about 5 s.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tagrec_tpu_torch.compose import build_pipeline  # noqa: E402
from tagrec_tpu_torch.config import TrainConfig, model_preset  # noqa: E402
from tagrec_tpu_torch.data.synthetic import synthetic_graph  # noqa: E402
from tagrec_tpu_torch.training.train import Trainer  # noqa: E402

# a graph with every relation non-empty, small enough for the CPU
GRAPH = dict(n_user=300, n_item=500, n_tag=200, avg_deg=12, seed=3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="dense_xla",
                    help="TGCN's adj_mode: auto, dense_xla or ell")
    args = ap.parse_args()
    graph = synthetic_graph(**GRAPH)
    tcfg = TrainConfig()
    pipe = build_pipeline(graph, model_preset("tgcn", adj_mode=args.mode),
                          tcfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    model = pipe.model.to(torch.float64)
    trainer = Trainer(model, pipe.phases, tcfg, capture=False,
                      generator=torch.Generator().manual_seed(0))
    bpr = pipe.phases[0]
    batch = bpr.make_batch(trainer.generator, 0,
                           bpr.epoch_reset(trainer.generator, bpr.data),
                           bpr.data)
    trainer.step(bpr, batch)
    tops = {n: float(p.grad.abs().max()) for n, p in model.named_parameters()}
    largest = max(tops.values())
    print(f"TGCN {args.mode}, float64, one BPR step on {GRAPH}: each "
          f"gradient's max |g| over the largest ({largest:.3e}), smallest "
          "first")
    for name, top in sorted(tops.items(), key=lambda kv: kv[1]):
        print(f"{name:32s} {top / largest:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
