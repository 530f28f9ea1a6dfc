"""What the drivers share: the system under test configured from a cell's
files, the leaves drawn from the seed, the recording of one step's kernel
calls and their device time, and the reading of a profiler trace."""

from __future__ import annotations

import dataclasses
import importlib
import statistics
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

import torch

# the benchmark's own host spans (``record_function``) around its calls into
# the system; a trace's idle gaps are named by the innermost one
SPANS = ("run_epoch", "run_phase", "Evaluator.run", "forward")


def model_config(cfg: dict):
    """The port's ``ModelConfig``: the preset named by ``cfg["preset"]``
    with every field that ``cfg`` gives."""
    from tagrec_tpu_torch.config import ModelConfig, model_preset

    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name"}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in fields}
    return model_preset(cfg["preset"], **kw)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_state() -> str:
    """The card's SM clock, power draw and temperature (``nvidia-smi``),
    or "" where it cannot be read; noted beside a window."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def host_state() -> dict:
    """The host's 1-minute load average and its cores' mean clock (MHz),
    read from ``/proc``; empty where they cannot be read.  Noted beside a
    window, with the window's process CPU seconds, to tell a slow host
    from a slow card."""
    out = {}
    try:
        with open("/proc/loadavg") as f:
            out["load1"] = float(f.read().split()[0])
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        if mhz:
            out["mhz"] = round(sum(mhz) / len(mhz), 1)
    except (OSError, ValueError, IndexError):
        pass
    return out


def draw_leaves(specs: Sequence[Tuple[str, Tuple[int, int]]], seed: int,
                device) -> List[torch.Tensor]:
    """Each leaf of ``specs`` Xavier-uniform for its shape, from one draw
    of a generator on ``device`` seeded with ``seed``."""
    width = {shape[1] for _, shape in specs}
    if len(width) != 1:
        raise ValueError(f"leaves of several widths: {specs}")
    rows = [shape[0] for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((sum(rows), width.pop()), generator=gen, device=device)
    out = []
    for (_, (n, d)), part in zip(specs, torch.split(u, rows)):
        out.append((2.0 * part - 1.0) * (6.0 / (n + d)) ** 0.5)
    return out


def load_leaves(model: torch.nn.Module, specs, tensors) -> None:
    """Copy the drawn leaves into the model's parameters of those names;
    raise unless the names and shapes are exactly the model's."""
    params = dict(model.named_parameters())
    want = {name: tuple(shape) for name, shape in specs}
    got = {name: tuple(p.shape) for name, p in params.items()}
    if want != got:
        raise ValueError(f"the reference's leaves {want} are not the "
                         f"model's {got}")
    with torch.no_grad():
        for (name, _), t in zip(specs, tensors):
            params[name].copy_(t)


@contextmanager
def recorded(specs: Sequence[Tuple[str, str]]):
    """While open, every call of the functions ``specs`` names (module,
    attribute) is recorded as (attribute, function, args, kwargs) in the
    list it yields, and made."""
    calls: list = []
    saved = []
    for mod_name, attr in specs:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapper(*a, _fn=fn, _name=attr, **k):
            calls.append((_name, _fn, a, k))
            return _fn(*a, **k)

        # a wrapped function counts its launches on its module's name
        wrapper.__dict__.update(fn.__dict__)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapper)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def calls_device_ms(calls, reps: int = 3, runs: int = 7) -> float:
    """Device ms of the recorded ``calls`` made once each, in order: ``reps``
    rounds of them captured in one CUDA graph, each replay timed by CUDA
    events, the median over ``reps``.  The system's launch counters are
    put back."""
    from tagrec_tpu_torch.training.train import COUNTED

    before = [f.launches for f in COUNTED]

    def all_calls():
        with torch.no_grad():  # as the step's autograd functions call them
            for _, fn, a, k in calls:
                fn(*a, **k)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        all_calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            all_calls()
    for f, n in zip(COUNTED, before):
        f.launches = n
    graph.replay()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in times) / reps
    del graph
    return ms


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof, outer: str, top: int = 10) -> Dict:
    """From a torch.profiler run whose stretch is the benchmark span
    ``outer``: the device's busy seconds (the union of its operations'
    intervals), the span's seconds, the device operations that took most
    time, and the idle time by what the host was in (the innermost
    benchmark span / the innermost host operation at a gap's start)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [e for e in events if e.name == outer]
    if not spans:
        return {}
    s0 = min(e.time_range.start for e in spans)
    s1 = max(e.time_range.end for e in spans)
    dev, host, bench = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(e)
        elif e.name in SPANS:
            bench.append(e)
        else:
            host.append(e)
    busy = _merged((max(e.time_range.start, s0), min(e.time_range.end, s1))
                   for e in dev if e.time_range.end > s0
                   and e.time_range.start < s1)
    by_op: Dict[str, float] = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us()
    gaps, last = [], s0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if s1 > last:
        gaps.append((last, s1))

    def inner(evs, t):
        live = [e for e in evs if e.time_range.start <= t < e.time_range.end]
        return min(live, key=lambda e: e.time_range.elapsed_us()).name \
            if live else "-"

    by_host: Dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        name = f"{inner(bench, g0)} / {inner(host, g0)}"[:160]
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "span_s": (s1 - s0) / 1e6,
            "device_ops": [[n[:160], us / 1e6] for n, us in rank(by_op)],
            "idle_gaps": [[n, us / 1e6] for n, us in rank(by_host)]}


def profiled(fn, outer: str):
    """``fn()`` under torch.profiler (CPU and CUDA) inside the benchmark span
    ``outer`` -> (its result, ``read_profile``)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(outer):
            out = fn()
        torch.cuda.synchronize()
    return out, read_profile(prof, outer)
