"""Readings that the limits of ``correct`` are set from, for one cell at
its own size, in one process:

* ``program``: the system's numbers against the reference, as a run
  compares them (for training the check steps of set-up, no window; for
  evaluation one pass after the warm-up pass);
* ``control``: the reference computed one step below float32 (TF32
  products; in evaluation bfloat16 scores, ranks and sums) put in the
  program's place (on the first ``--control`` seeds);
* ``half_batch`` (training): the system with half of each batch left out
  of the loss, the mean taken over the rest (on the same seeds).

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--control 3] [--out chiprun_out/control.<name>.jsonl]

One JSON line a seed on standard output, and in ``--out``.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_readings(ctx, d, with_control: bool) -> dict:
    from tagrec_tpu_torch.models import base

    out = {}
    state = d.build(ctx)
    raw, check = state["raw"], state["check"]
    del state
    _free()
    ref = d.reference_run(ctx, raw, check["batches"], "ref")
    out["program"] = d.compare(check, ref)
    if with_control:
        out["control"] = d.compare(
            d.reference_run(ctx, raw, check["batches"], "tf32"), ref)
        inner = base.bpr_with_reg

        def half(u_all, i_all, u_src, i_src, batch, kind, reg):
            return inner(u_all, i_all, u_src, i_src,
                         batch[:batch.shape[0] // 2], kind, reg)

        base.bpr_with_reg = half
        try:
            state = d.build(ctx)
        finally:
            base.bpr_with_reg = inner
        bad = state["check"]
        del state
        _free()
        out["half_batch"] = d.compare(
            bad, d.reference_run(ctx, raw, bad["batches"], "ref"))
    return out


def eval_readings(ctx, d, with_control: bool) -> dict:
    state = d.build(ctx)
    result = d._pass(state)
    import torch

    prog = {"result": result,
            "tops": torch.cat(state["tops"]).cpu().numpy()}
    state["undo"]()
    raw = state["raw"]
    del state
    _free()
    ref = d.reference_run(ctx, raw, "ref")
    out = {"program": d.compare(prog, ref, raw, ctx.mix)}
    if with_control:
        out["control"] = d.compare(d.reference_run(ctx, raw, "tf32"), ref,
                                   raw, ctx.mix)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = harness.cell(args.workload, seed, 0.0, False, "cuda", t0)
            d = harness.load(f"drivers/{ctx.mix['driver']}.py")
            if ctx.mix["driver"] == "train":
                rec = train_readings(ctx, d, n < args.control)
            else:
                rec = eval_readings(ctx, d, n < args.control)
            rec.update(workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            _free()
    finally:
        if sink:
            sink.close()
    bad = harness.banned_modules()
    if bad:
        print(f"control: the run loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
