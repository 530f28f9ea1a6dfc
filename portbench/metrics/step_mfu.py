"""The window's share of the card's float32 peak: the operations one
training step needs (``counts/<config>.py``) times the window's steps,
over its seconds, over 67 TFLOP/s."""

from portbench.peaks import PEAK_F32_FLOPS


def read(trace):
    if "step_flops" not in trace:
        return None
    w = trace["window"]
    return 100.0 * trace["step_flops"] * w["steps"] / w["seconds"] \
        / PEAK_F32_FLOPS
