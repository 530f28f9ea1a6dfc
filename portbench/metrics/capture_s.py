"""Seconds the Trainer took to capture its phases' CUDA graphs
(``PhaseRun.capture_s``, summed over the phases)."""


def read(trace):
    return trace.get("capture_s")
