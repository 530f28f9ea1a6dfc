"""One run of one cell: the cell's files found by the names in
``BENCHMARK.json``, its driver run, the result line printed.

A cell names a configuration (``configs/<config>.json``, its reference
``reference/<config>.py`` and its counts ``counts/<config>.py``) and a
traffic mix (``mixes/<traffic>.json``, which names its driver,
``drivers/<driver>.py``); its limits are ``limits/<workload>.json`` and
each per-layer metric is read by ``metrics/<metric>.py``.  A driver's
``run(ctx)`` returns the end-to-end readings, the traced run's readings,
the numbers compared with the reference and the peak memory.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that no run of the port may hold (whole names)
BANNED = ("jax", "jaxlib", "flax", "tagrec_tpu")


def load(rel: str):
    """The module in ``portbench/<rel>``, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(HERE, rel)
    name = "portbench._by_path." + rel[:-3].replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclass
class Cell:
    """What a driver reads of one run of one cell."""

    manifest: dict
    workload: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    limits: Dict[str, float] = field(default_factory=dict)

    def reference(self):
        return load(f"reference/{self.workload['config']}.py")

    def counts(self):
        return load(f"counts/{self.workload['config']}.py")

    def per_layer(self):
        """The cell's per-layer metrics, in the manifest's order."""
        name = self.workload["name"]
        return [m for m in self.manifest["per_layer"]
                if name in m.get("workloads", [name])]

    def kernel_readers(self):
        """{metric: reader} of the cell's per-layer metrics that time
        recorded kernel calls (a reader with ``RECORD``)."""
        out = {}
        for m in self.per_layer():
            r = load(f"metrics/{m['name']}.py")
            if hasattr(r, "RECORD"):
                out[m["name"]] = r
        return out


def cell(workload: str, seed: int, seconds: float, trace: bool,
         device: str, t_start: float, manifest: Optional[dict] = None) -> Cell:
    man = manifest or read_json("BENCHMARK.json")
    found = [w for w in man["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg_file = [c["file"] for c in man["configs"] if c["name"] == w["config"]]
    return Cell(man, w, read_json(cfg_file[0]),
                read_json(f"portbench/mixes/{w['traffic']}.json"), seed,
                seconds, trace, device, t_start,
                read_json(f"portbench/limits/{workload}.json"))


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def judge(limits: Dict[str, float], numbers: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct when every number
    compared is within its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def result_line(ctx: Cell, res: dict) -> dict:
    """The run's result: the verdict; the cell's end-to-end metrics, or
    with trace its per-layer ones that a reader found; the numbers
    compared, last."""
    import torch

    correct, checks = judge(ctx.limits, res["checks"])
    name = ctx.workload["name"]
    metrics = {}
    if ctx.trace:
        for m in ctx.per_layer():
            v = load(f"metrics/{m['name']}.py").read(res["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in ctx.manifest["end_to_end"]:
            if name in m.get("workloads", [name]):
                metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.workload["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        prof = res["trace"]["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["span_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out


def main(args, t_start: float) -> int:
    import torch

    ctx = cell(args.workload, args.seed, args.seconds, bool(args.trace),
               "cuda", t_start)
    chips = ctx.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {ctx.workload['name']} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = load(f"drivers/{ctx.mix['driver']}.py").run(ctx)
    bad = banned_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(ctx, res)
    if ctx.trace:
        tr = res["trace"]
        print(f"replay_ms (CUDA events) {tr.get('replay_ms')}; launches a "
              f"step {tr.get('launches')}; kernels {tr.get('kernels')}; "
              f"peak {res['memory_peak_bytes']} bytes", file=sys.stderr)
    print(f"notes {json.dumps(res.get('notes', {}))}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
