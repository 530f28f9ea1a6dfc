"""Share of a profiled stretch of training (``trace_steps`` steps by the
window's call, after the window) in which no operation ran on the card:
1 - the union of the device operations' intervals over the stretch
(torch.profiler; it has under-read short hand-written launches, so this
may read high)."""


def read(trace):
    p = trace.get("profile") or {}
    if trace.get("driver") != "train" or not p.get("span_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
