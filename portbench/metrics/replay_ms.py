"""Device ms of one replayed training step: CUDA events around
``trace_steps`` back-to-back replays of the phase's captured graph, over
their count.  Its gap to the window's ms a step is the host's share."""


def read(trace):
    return trace.get("replay_ms")
