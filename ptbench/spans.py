"""Spans and ray samples taken from outside the program, for the traced
run: the program's step functions are wrapped by name while the window
runs and put back after it.

A per-layer metric declares what it reads (``ptbench/metrics/*.py``):

- ``WRAP = (module, (function, ...))``: the functions whose device time
  the metric sums.  Each call is timed by a pair of CUDA events; a call
  made inside another wrapped call of the same metric is not counted
  again (the outermost call only).
- ``SAMPLE = (module, {function: "closest" | "any"})``: traversal
  calls whose rays are counted, and every ``SAMPLE_EVERY``-th call of
  each kind sampled: the ``SAMPLE_RAYS`` live rays of smallest seeded
  hash of their origin and direction, so that the same rays give the
  same sample whatever order the program keeps them in.

While ``HostSteps`` is on (the profiled window), each wrapped call and
each step of the harness is logged by the host clock, which names the
idle gaps of the device trace (devtrace.py).  A declared function the
program lacks is recorded as missing, and every metric that declared it
is reported absent.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

SAMPLE_EVERY = 8
SAMPLE_RAYS = 256
_MASK31 = (1 << 31) - 1
_PRIMES = (73856093, 19349663, 83492791, 1540483477, 40503, 1274126177)


def ray_hash(origin, direction, seed: int):
    """(N,) int64 in [0, 2^31): a seeded hash of each ray's bits."""
    bits = torch.cat([origin, direction], dim=1).contiguous().view(
        torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = torch.full((origin.shape[0],), seed & _MASK31, dtype=torch.int64,
                   device=origin.device)
    for k, p in enumerate(_PRIMES):
        h = ((h ^ bits[:, k]) * p) & _MASK31
        h = h ^ (h >> 13)
    return h


class HostSteps:
    """(name, start ns, end ns) of host steps by ``time.perf_counter_ns``,
    logged while ``on``."""

    def __init__(self):
        self.on = False
        self.log = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            self.log.append((name, start, time.perf_counter_ns()))


class Recorder:
    """The spans and ray samples of one traced window."""

    def __init__(self, device, seed: int, steps: HostSteps = None):
        self.steps = steps or HostSteps()
        self.device = device
        self.seed = seed
        self.cuda = device.type == "cuda"
        self.spans = {}      # metric -> [(start, end)]
        self.depth = {}      # metric -> nesting depth
        self.missing = set()
        self.every = SAMPLE_EVERY
        self._undo = []
        self.clear_samples()

    def clear_samples(self) -> None:
        self.rays = {"closest": [], "any": []}   # [(count, sample or None)]
        self.calls = {"closest": 0, "any": 0}

    # -- installing ----------------------------------------------------------
    def _wrap(self, module, name, before, after):
        fn = getattr(module, name, None)
        if fn is None:
            return False

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with self.steps(name):
                state = before(args, kwargs)
                out = fn(*args, **kwargs)
                after(state)
            return out

        setattr(module, name, run)
        self._undo.append((module, name, fn))
        return True

    def time(self, metric: str, module_name: str, names) -> None:
        module = importlib.import_module(module_name)
        self.spans.setdefault(metric, [])
        self.depth.setdefault(metric, 0)

        def before(args, kwargs):
            self.depth[metric] += 1
            if self.depth[metric] > 1 or not self.cuda:
                return None
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start

        def after(start):
            self.depth[metric] -= 1
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.spans[metric].append((start, end))

        for name in names:
            if not self._wrap(module, name, before, after):
                self.missing.add(metric)

    def log(self, metric: str, module_name: str, names) -> None:
        """The functions as host steps alone (no CUDA events)."""
        module = importlib.import_module(module_name)
        for name in names:
            if not self._wrap(module, name, lambda a, k: None,
                              lambda state: None):
                self.missing.add(metric)

    def sample(self, metric: str, module_name: str, kinds: dict) -> None:
        module = importlib.import_module(module_name)
        for name, kind in kinds.items():
            def before(args, kwargs, kind=kind):
                origin, direction = args[1], args[2]
                active = args[3] if len(args) > 3 else kwargs.get("active")
                self._take(kind, origin, direction, active)

            if not self._wrap(module, name, before, lambda state: None):
                self.missing.add(metric)

    def _take(self, kind, origin, direction, active) -> None:
        n = origin.shape[0]
        live = (torch.ones(n, dtype=torch.bool, device=origin.device)
                if active is None else active)
        count = live.sum()
        sample = None
        if self.calls[kind] % self.every == 0 and n:
            h = ray_hash(origin, direction, self.seed + self.calls[kind])
            h = torch.where(live, h, torch.full_like(h, 1 << 40))
            k = min(SAMPLE_RAYS, n)
            h_top, idx = torch.topk(h, k, largest=False)
            sample = (origin[idx].clone(), direction[idx].clone(),
                      h_top < (1 << 40))
        self.calls[kind] += 1
        self.rays[kind].append((count, sample))

    def restore(self) -> None:
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        self._undo.clear()

    # -- reading -------------------------------------------------------------
    def span_ms(self, metric: str):
        """Total device ms of the metric's spans, or None where a
        declared function is missing or none ran."""
        if metric in self.missing or not self.spans.get(metric):
            return None
        return sum(s.elapsed_time(e) for s, e in self.spans[metric])
