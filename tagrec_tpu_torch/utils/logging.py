"""Metrics / logging subsystem (the port's copy of
tagrec_tpu/utils/logging.py: the same JSONL records).

Replaces the reference's disabled tensorboardX scaffolding
(training/basic_train.py:33-47, utility/word.py:15) with an always-on JSONL
metrics stream, and the reference's ANSI-colored key-line printing
(utility/utils.py:76-77).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


def printc(msg: str) -> None:
    """Yellow-on-black highlight print (utility/utils.py:76-77)."""
    print(f"\033[0;33;40m{msg}\033[0m")


class MetricsWriter:
    """JSONL metrics stream, ``<out_dir>/metrics.jsonl``.

    Every record carries a wall-clock timestamp, step, and tag->value pairs.
    """

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"t": time.time(), "step": step}
        rec.update((k, float(v)) for k, v in values.items())
        self._f.write(json.dumps(rec) + "\n")

    def results(self, step: int, results: Dict, topks) -> None:
        """Per-topk eval dict -> flat ``test/`` scalars
        (add_result_to_writer semantics, training/basic_train.py:40-47)."""
        flat = {}
        for key, vals in results.items():
            if isinstance(vals, (list, tuple)) and len(vals) == len(topks):
                for k, v in zip(topks, vals):
                    flat[f"test/{key}@{k}"] = v
            elif isinstance(vals, (list, tuple)):
                flat[f"test/{key}"] = vals[0]
            else:
                flat[f"test/{key}"] = vals
        self.scalars(step, flat)

    def text(self, tag: str, content: str) -> None:
        self._f.write(json.dumps({"t": time.time(), "text": {tag: content}})
                      + "\n")

    def close(self) -> None:
        self._f.close()
