"""Tracing and profiling (port of utils/profiling.py) on
``torch.profiler``.

- ``trace(log_dir, device)``: a context manager that records the host's
  activity and, on a CUDA device, the card's kernels and copies, and
  writes a Chrome trace (``trace.json``, readable by Perfetto and
  ``chrome://tracing``) into ``log_dir``.
- ``annotate(name)``: a named range (``torch.profiler.record_function``)
  for host phases, which shows up inside those traces.
- ``FrameProfiler``: wall time per named phase with a history ring
  buffer (a copy of the JAX package's).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device="cpu"):
    """Record a ``torch.profiler`` trace into ``log_dir/trace.json``:
    the CPU's activity, and the card's when ``device`` is CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named host range that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


class FrameProfiler:
    """Wall-clock per named phase, with history (Stats.zig ring-buffer
    analog, headless)."""

    def __init__(self, history: int = 100):
        self.history: Dict[str, collections.deque] = {}
        self._maxlen = history
        self._open: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.history.setdefault(
                name, collections.deque(maxlen=self._maxlen)
            ).append(dt)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, hist in self.history.items():
            vals = list(hist)
            out[name] = {
                "count": len(vals),
                "last_ms": round(vals[-1] * 1000.0, 3),
                "mean_ms": round(sum(vals) / len(vals) * 1000.0, 3),
                "min_ms": round(min(vals) * 1000.0, 3),
                "max_ms": round(max(vals) * 1000.0, 3),
            }
        return out
