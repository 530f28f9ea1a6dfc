"""The program's recorder of spans and counters, and its profiler capture
(tagrec_tpu/utils/profiling.py).

* ``enable()`` / ``disable()`` / ``enabled()`` — the recorder's switch,
  off by default.  While off, ``span()`` and ``count()`` cost one flag
  check: no clock read and no ``record_function``.
* ``span(name, **attrs)`` — a context that, while on, records its id, its
  parent's id (the innermost open span), its name, its attrs and its start
  and end, and opens a ``record_function`` range of the same name, so that
  a running profiler puts it on the timeline with the kernels (torch's
  ``_RecordFunctionFast`` where it has one: under a profiler about 1 µs a
  range against ``torch.profiler.record_function``'s 15, and its stamps
  within a few µs of the span's).
  Stamps are Unix-epoch nanoseconds, the clock the profiler stamps its own
  events with (``trace_start_ns()`` plus an event's ``time_range``).
* ``timed(name, **attrs)`` — a span that measures its ``seconds`` whether
  or not the recorder is on, and is recorded only while on; for the
  numbers the program reports itself (a capture's seconds, the CLI's
  stage seconds).
* ``count(name, n=1)`` — adds ``n`` to a counter while on.
* ``snapshot()`` -> ``{"spans": [...], "counters": {...}}``; ``reset()``
  clears both; ``write(path)`` writes them as Chrome-trace JSON: ``"X"``
  events in Unix microseconds and one ``"C"`` event of the counters.  The
  profiler's file (``start_trace``) stamps its events relative to its
  ``baseTimeNanoseconds``; add that to set the two on one time axis.
* ``start_trace(dir)`` / ``stop_trace()`` — capture a CPU and, where a
  card is in use, CUDA trace of everything in between into ``dir`` (a
  Chrome-trace ``*.pt.trace.json``, which TensorBoard's profiler plugin
  also reads); the recorder is on from ``start_trace`` to ``stop_trace``
  (and stays on where it was on before).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, List, Optional

import torch

_on = False
_offset_ns = time.time_ns() - time.perf_counter_ns()
_next_id = itertools.count(1)
_stack: List[int] = []
_spans: List["_Span"] = []
_counters: Dict[str, int] = {}
_profiler: Optional[torch.profiler.profile] = None
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_enabled_by_trace = False


def _now_ns() -> int:
    """Unix-epoch nanoseconds from the monotonic clock."""
    return time.perf_counter_ns() + _offset_ns


def enable() -> None:
    """Turn the recorder on; the clock's offset to the Unix epoch is taken
    again here."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Off:
    """The one context every span site gets while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "record", "id", "parent", "start_ns",
                 "end_ns", "_rf")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record = name, attrs, record
        self.id = self.parent = None

    def __enter__(self):
        if self.record:
            self.id = next(_next_id)
            self.parent = _stack[-1] if _stack else None
            _stack.append(self.id)
            self._rf = _range(self.name)
            self._rf.__enter__()
        self.start_ns = _now_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now_ns()
        if self.record:
            self._rf.__exit__(*exc)
            _stack.pop()
            _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, **attrs):
    """A recorded span while the recorder is on, else a shared no-op."""
    if not _on:
        return _OFF
    return _Span(name, attrs, True)


def timed(name: str, **attrs) -> _Span:
    """A span whose ``seconds`` are measured even while the recorder is
    off; it is recorded only while on."""
    return _Span(name, attrs, _on)


def count(name: str, n: int = 1) -> None:
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> Dict:
    """Every span recorded since the last ``reset()``, in the order they
    ended, and the counters."""
    return {"spans": [{"id": s.id, "parent": s.parent, "name": s.name,
                       "start_ns": s.start_ns, "end_ns": s.end_ns,
                       "attrs": dict(s.attrs)} for s in _spans],
            "counters": dict(_counters)}


def reset() -> None:
    _spans.clear()
    _counters.clear()


def write(path: str) -> None:
    """The recorder's snapshot as Chrome-trace JSON at ``path``."""
    snap = snapshot()
    pid = os.getpid()
    events = [{"name": s["name"], "ph": "X", "pid": pid, "tid": 0,
               "ts": s["start_ns"] / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "args": {"id": s["id"], "parent": s["parent"], **s["attrs"]}}
              for s in snap["spans"]]
    if snap["counters"]:
        events.append({"name": "counters", "ph": "C", "pid": pid, "tid": 0,
                       "ts": _now_ns() / 1e3, "args": snap["counters"]})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)


def start_trace(log_dir: str) -> None:
    """Start capturing a trace into ``log_dir``, and enable the recorder;
    one capture at a time."""
    global _profiler, _enabled_by_trace
    if _profiler is not None:
        raise RuntimeError("a trace is already being captured")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _enabled_by_trace = not _on
    enable()
    prof.start()
    _profiler = prof


def stop_trace() -> None:
    """Stop the capture and write its trace file; the recorder goes off
    if ``start_trace`` turned it on."""
    global _profiler
    if _profiler is None:
        raise RuntimeError("no trace is being captured")
    prof, _profiler = _profiler, None
    prof.stop()
    if _enabled_by_trace:
        disable()
