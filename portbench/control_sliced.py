"""``control.py``'s readings for a cell of the sliced training driver
(``drivers/train_sliced.py``), whose set-up and comparison are those of
the whole-epoch driver: ``control.py`` takes every driver but ``train``
for an evaluation driver, so this calls its ``train_readings`` itself.

    python3 portbench/control_sliced.py --workload <name> --seeds 1,2,3 \
        [--control 3] [--out chiprun_out/control.<name>.jsonl]

One JSON line a seed on standard output, and in ``--out``: ``program``,
and on the first ``--control`` seeds ``control`` (the reference in TF32
put in the program's place) and ``half_batch`` (the program with half of
each BPR batch left out of the loss); ``worst`` names the leaves that
set each comparison's gradient and change gaps.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _noting:
    """The driver, its ``compare`` noting in ``worst`` the three leaves
    with the largest first-gradient and change gaps of each comparison."""

    def __init__(self, driver, worst: list):
        self._d, self._worst = driver, worst

    def __getattr__(self, name):
        return getattr(self._d, name)

    def compare(self, prog, ref):
        g = self._d.gaps(prog, ref)
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa
        self._worst.append({"grad1": top(g["grad1"]),
                            "change": top(g["change"])})
        return self._d.compare(prog, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import control, harness

    if not torch.cuda.is_available():
        print("control_sliced: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = harness.load("drivers/train_sliced.py")
    sink = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = harness.cell(args.workload, seed, 0.0, False, "cuda", t0)
            if ctx.mix["driver"] != "train_sliced":
                raise SystemExit(f"{args.workload} runs driver "
                                 f"{ctx.mix['driver']!r}: use control.py")
            worst = []
            rec = control.train_readings(ctx, _noting(d, worst),
                                         n < args.control)
            rec["worst"] = dict(zip(("program", "control", "half_batch"),
                                    worst))
            rec.update(workload=args.workload, seed=seed,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            control._free()
    finally:
        if sink:
            sink.close()
    bad = harness.banned_modules()
    if bad:
        print(f"control_sliced: the run loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
