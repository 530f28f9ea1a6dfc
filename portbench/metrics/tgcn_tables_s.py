"""Seconds of TGCN's ``tgcn.tables`` span (``models/tgcn.py``, under
``build.model``): the six neighbour tables' draw and the tier's build of
them (the dedup buckets under ``auto``), read from the program's recorder
in a traced run; None where the program records no such span."""


def read(trace):
    spans = [s for s in (trace.get("program") or {}).get("spans", [])
             if s["name"] == "tgcn.tables"]
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9
