"""What the device trace of the traced window says: the profiler's
device operations (kernels, copies, sets) as intervals, the seconds in
which any of them ran (the union of the intervals), the time of the
operations whose names match given patterns, the operations that took
most time, and the longest idle gaps, each named by the host step (spans.HostSteps:
a step of the harness or a wrapped function of the program) that the
host was in when the gap began.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from torch.autograd import DeviceType

TOP = 10


@dataclass
class DeviceTrace:
    ops: list = field(default_factory=list)    # (name, start_us, end_us)
    ranges: list = field(default_factory=list)  # host (name, start, end)
    window_s: float = 0.0

    @classmethod
    def read(cls, prof, window_s: float, steps=(),
             marker_ns: int = None) -> "DeviceTrace":
        """The profiler's device operations; ``steps``: host steps
        (name, start ns, end ns) by ``time.perf_counter_ns``, placed on
        the trace's clock by ``marker_ns``, the host time at which the
        window's first ``cudaDeviceSynchronize`` was called."""
        ops, marker = [], None
        for e in prof.events():
            r = e.time_range
            if e.device_type == DeviceType.CUDA:
                ops.append((e.name, r.start, r.end))
            elif e.name == "cudaDeviceSynchronize" and (
                    marker is None or r.start < marker):
                marker = r.start
        ops.sort(key=lambda o: o[1])
        ranges = []
        if marker is not None and marker_ns is not None:
            offset = marker - marker_ns / 1e3
            ranges = [(name, s / 1e3 + offset, e / 1e3 + offset)
                      for name, s, e in steps]
        return cls(ops=ops, ranges=ranges, window_s=window_s)

    def _merged(self):
        merged = []
        for _, s, e in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e6

    def seconds_of(self, patterns) -> float | None:
        """Device seconds of the operations whose names hold one of
        ``patterns``; None where no operation matches."""
        hits = [e - s for name, s, e in self.ops
                if any(p in name for p in patterns)]
        return sum(hits) / 1e6 if hits else None

    def top_ops(self):
        by_name = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    def _step_at(self, t: float) -> str:
        inner = None
        for name, s, e in self.ranges:
            if s <= t <= e and (inner is None or e - s < inner[1]):
                inner = (name, e - s)
        return inner[0] if inner else "between steps"

    def idle_gaps(self):
        merged = self._merged()
        gaps = [(merged[k][1], merged[k + 1][0])
                for k in range(len(merged) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._step_at(s), (e - s) / 1e6] for s, e in gaps[:TOP]]
