#!/usr/bin/env python3
"""What the port's own spans and counters (``tagrec_tpu_torch/utils/profiling.py``)
read in one cell of the port's benchmark on one NVIDIA GPU.

    python3 experiments/torch_program_spans.py --workload <cell> \
        --seed <n> --seconds <s> --trace <0|1> [--spans_out <file.json>]

It runs the cell through ``portbench/run.py`` (its arguments) with the
program's recorder enabled before the benchmark builds anything; the run is
otherwise the benchmark's own, which prints its result line (with
``--trace 1`` its ``breakdown`` names the idle gaps by the program's spans,
whose ``record_function`` ranges are then the innermost host ranges).  With
``--trace 0`` it is the recorder's cost: the same run with every span and
counter recorded and no profiler.  After the run, one JSON line
``{"spans": ...}`` of what the spans read:

* ``model_build_s``: the ``build.model`` span (``build_pipeline``'s other
  stages beside it);
* training: ``warmup_s``, set-up's ``trainer.init`` and ``trainer.eager``
  spans (the optimizer's construction and the eager steps, where the first
  Adam's ``torch._dynamo`` import lands); the window's ``trainer.epoch``,
  ``trainer.epoch_reset``, ``trainer.replays`` and ``trainer.readback``
  spans (the window is the whole epochs; the profiled epoch, shorter, is no
  window epoch);
* evaluation: ``eval_host_ms``, the median over the window's passes (the
  set-up's warm pass and, traced, the profiled pass left out) of
  ``eval.pass`` less its ``eval.sync`` spans, with the passes' and the
  syncs' ms beside it;
* the counters.

With ``--spans_out`` the recorder's Chrome-trace file is written there.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _s(span) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def _spread(xs):
    return [min(xs), statistics.median(xs), max(xs)] if xs else None


def readings(snap: dict, traced: bool) -> dict:
    """What a run's snapshot reads (the module docstring's list)."""
    spans = sorted(snap["spans"], key=lambda s: s["start_ns"])
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)

    def named(name, among=spans):
        return [s for s in among if s["name"] == name]

    def below(span, name):
        out = []
        for k in kids.get(span["id"], []):
            out += [k] if k["name"] == name else below(k, name)
        return out

    out: dict = {"counters": snap["counters"]}
    for b in named("build_pipeline")[:1]:
        out["build_pipeline_s"] = _s(b)
        out["build_stages_s"] = {k["name"]: _s(k) for k in kids.get(b["id"], [])}
        out["model_build_s"] = out["build_stages_s"].get("build.model")
    out["native_s"] = {n: sum(_s(s) for s in named(n))
                       for n in ("native.build", "native.load")}
    epochs = named("trainer.epoch")
    if epochs:
        whole = max(e["attrs"]["steps"] for e in epochs)
        window = [e for e in epochs if e["attrs"]["steps"] == whole]
        setup = [s for s in spans if s["end_ns"] <= window[0]["start_ns"]]
        init = [_s(s) for s in named("trainer.init", setup)]
        eager = [_s(s) for s in named("trainer.eager", setup)]
        out["warmup_s"] = sum(init) + sum(eager)
        out["trainer_init_s"], out["eager_s"] = init, eager
        out["capture_s"] = [_s(s) for s in named("trainer.capture")]
        out["window_epochs"] = len(window)
        out["epoch_s min/median/max"] = _spread([_s(e) for e in window])
        for name in ("trainer.epoch_reset", "trainer.replays",
                     "trainer.readback"):
            out[f"{name} ms min/median/max"] = _spread(
                [1e3 * _s(k) for e in window for k in below(e, name)])
    passes = named("eval.pass")
    if passes:
        window = passes[1:-1] if traced else passes[1:]
        host, sync, total = [], [], []
        for p in window:
            waits = sum(_s(s) for s in below(p, "eval.sync"))
            total.append(1e3 * _s(p))
            sync.append(1e3 * waits)
            host.append(total[-1] - sync[-1])
        out["eval_host_ms"] = statistics.median(host) if host else None
        out["window_passes"] = len(window)
        out["pass ms min/median/max"] = _spread(total)
        out["sync ms min/median/max"] = _spread(sync)
        out["host ms min/median/max"] = _spread(host)
        out["forward ms min/median/max"] = _spread(
            [1e3 * _s(k) for p in window for k in below(p, "eval.forward")])
        out["blocks a pass"] = _spread(
            [len(below(p, "eval.block")) for p in window])
    return out


def card() -> str:
    """The card's name and power limit, or "" where they cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
    except OSError:
        return ""
    return out.stdout.strip()


def cell(argv) -> int:
    from portbench import run  # its clock starts the run's set-up
    from tagrec_tpu_torch.utils import profiling

    p = argparse.ArgumentParser()
    for flag, kind in (("--workload", str), ("--seed", int),
                       ("--seconds", float), ("--trace", int)):
        p.add_argument(flag, type=kind, required=True)
    p.add_argument("--spans_out", default="")
    a = p.parse_args(argv)
    profiling.enable()
    rc = run.main([f"--{k}={getattr(a, k)}"
                   for k in ("workload", "seed", "seconds", "trace")])
    snap = profiling.snapshot()
    if a.spans_out:
        profiling.write(a.spans_out)
    print(json.dumps({"card": card(), "workload": a.workload, "seed": a.seed,
                      "trace": a.trace, "rc": rc,
                      "spans": readings(snap, a.trace == 1)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(cell(sys.argv[1:]))
