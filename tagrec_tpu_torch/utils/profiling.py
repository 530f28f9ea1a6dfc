"""Tracing / profiling subsystem (tagrec_tpu/utils/profiling.py).

* ``trace(name)`` — a ``torch.profiler.record_function`` range, named in
  captured traces
* ``start_trace/stop_trace`` — capture a CPU and, where a card is in use,
  CUDA trace of everything in between into a directory (a Chrome-trace
  ``*.pt.trace.json``, which TensorBoard's profiler plugin also reads)
* ``StepTimer`` — EMA step timing with examples/s derivation, usable as a
  context manager inside training loops; it reads ``clock()``, which on the
  card synchronises first, so a step's time is the device's too
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

_profiler: Optional[torch.profiler.profile] = None


def trace(name: str):
    """Annotation context that shows up in captured traces."""
    return torch.profiler.record_function(name)


def start_trace(log_dir: str) -> None:
    """Start capturing a trace into ``log_dir``; one capture at a time."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("a trace is already being captured")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    _profiler = prof


def stop_trace() -> None:
    """Stop the capture and write its trace file."""
    global _profiler
    if _profiler is None:
        raise RuntimeError("no trace is being captured")
    prof, _profiler = _profiler, None
    prof.stop()


def clock(device=None) -> float:
    """The host's clock once the card (``device``, else the current one)
    has finished its queued work; on the CPU, the host's clock."""
    if torch.cuda.is_initialized() and (
            device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)
    return time.perf_counter()


class StepTimer:
    """Wall-clock step timer with EMA smoothing and throughput accounting.

    with timer.step(n_examples=512):
        run_train_step()
    print(timer.summary())
    """

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_ms: Optional[float] = None
        self.total_steps = 0
        self.total_examples = 0
        self.total_time = 0.0

    @contextlib.contextmanager
    def step(self, n_examples: int = 0):
        t0 = clock()
        yield
        dt = clock() - t0
        ms = dt * 1e3
        self.avg_ms = ms if self.avg_ms is None else (
            self.ema * self.avg_ms + (1 - self.ema) * ms)
        self.total_steps += 1
        self.total_examples += n_examples
        self.total_time += dt

    @property
    def examples_per_sec(self) -> float:
        return self.total_examples / self.total_time if self.total_time else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "steps": self.total_steps,
            "avg_step_ms": round(self.avg_ms or 0.0, 3),
            "examples_per_sec": round(self.examples_per_sec, 1),
            "total_time_s": round(self.total_time, 3),
        }
