"""Share of one profiled evaluation pass, after the window, in which no
operation ran on the card (as ``idle_share.train``)."""


def read(trace):
    p = trace.get("profile") or {}
    if trace.get("driver") != "eval" or not p.get("span_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
