"""Seconds of ``compose.build_pipeline`` (the model, its graph tables on
the card, the phases, the evaluator), synchronised on both sides."""


def read(trace):
    return trace.get("build_s")
