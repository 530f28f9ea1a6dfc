"""The evaluation window's share of the card's float32 peak: the
operations a pass needs (``counts/<config>.py``) times the window's
passes, over its seconds, over 67 TFLOP/s."""

from portbench.peaks import PEAK_F32_FLOPS


def read(trace):
    if "pass_flops" not in trace:
        return None
    w = trace["window"]
    return 100.0 * trace["pass_flops"] * w["passes"] / w["seconds"] \
        / PEAK_F32_FLOPS
