"""One BPR step's Attention 1 (``models/tgcn.py::_atten1_dedup``: 6
relations x 3 layers, 18 calls) against its roofline: the bound of
max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) over its device time.
The calls are recorded at their arguments in one eager step; each is
replayed with its backward against a seeded cotangent, all of them 3
times in one CUDA graph, timed by CUDA events.  The bound is the work
the function needs whatever implements it (``counts/tgcn.py``
``atten1_work``): the distinct (neighbour, weight) pairs' ids and
multiplicities once, each table read once and its gradient written
once, the aggregate written and its cotangent read once; 2 da + 2 d
operations a distinct pair forward and twice that backward, and the
products that factor through a node once a row of their table."""

import statistics

import torch

from portbench.counts.tgcn import atten1_work
from portbench.peaks import bound_ms as _bound

RECORD = (("tagrec_tpu_torch.models.tgcn", "_atten1_dedup"),)


def bound_ms(calls) -> float:
    return _bound(*atten1_work(calls))


def device_ms(calls, reps: int = 3, runs: int = 7) -> float:
    """Device ms of the recorded calls made once each with their
    backward, in order: ``reps`` rounds captured in one CUDA graph, each
    replay timed by CUDA events, the median over ``reps``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    made = []
    for _, fn, a, k in calls:
        ap, ev, ej, ew, buckets, inv = a[:6]
        ap = {key: ap[key].detach().clone().requires_grad_(True)
              for key in ("W1", "W2", "b", "v")}
        ins = [t.detach().clone().requires_grad_(True) for t in (ev, ej, ew)]
        g = torch.randn((ev.shape[0], ej.shape[1]), generator=gen,
                        device="cuda")
        made.append((fn, ap, ins, buckets, inv, g))

    def all_calls():
        for fn, ap, (ev, ej, ew), buckets, inv, g in made:
            out = fn(ap, ev, ej, ew, buckets, inv)
            torch.autograd.grad(out, [*ap.values(), ev, ej, ew], g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        all_calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            all_calls()
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


def read(trace):
    k = trace.get("kernels", {}).get("atten1_roofline")
    if not k or not k["calls"] or not k["device_ms"]:
        return None
    return 100.0 * k["bound_ms"] / k["device_ms"]
