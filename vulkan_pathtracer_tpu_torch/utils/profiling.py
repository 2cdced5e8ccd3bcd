"""Tracing and profiling of the program (port of utils/profiling.py).

The tracer: spans and counters inside the frame loop and the wavefront,
on the host clock (``time.perf_counter_ns``), off by default.

- ``tracing()`` turns it on for the calls made inside it and hands over
  a ``Tracer``; ``Tracer.collect()`` returns what it recorded (a
  ``Record``) after the window and clears it.
- ``span(name, j)`` at each site: a span with its parent, the root span
  of the call into the program, and a bounce index ``j``.  Off, it is
  one test of the module's tracer and returns a shared no-op context:
  no allocation, no CUDA event, no device read, no synchronise.
- ``launched(key, origin)``: called by ``ops.stack_traverse._dispatch``
  after each traversal launch (the same place that counts ``LAUNCHES``),
  and by ``ops.shade`` after each shading kernel's launch (inside a
  ``shade`` span): the launch's key and lanes go to the innermost span,
  and its host time to the list that places the spans on a device
  trace's clock: the time at which the C launcher returned
  (``launch_returned``, called by ``ops.kernels._launch``), else the time
  of the call.  A frame graph's replay (render/pipeline.FrameGraph) is
  one such launch (``GRAPH_KEY``) in its ``frame`` span; the spans inside
  the frame are entered only at the capture.
- ``count_live(count)``: the live lanes of a bounce, a device tensor the
  program computes anyway, kept while on and read once by ``collect``.
- ``count(name, value)``: a counter of the innermost span, a host int
  (the scene update's ``instances_moved`` and ``update_records``, once
  a posed frame, in its ``update`` span under the frame's root; the
  pose's evaluation is the ``animate`` span beside it).
- Synchronising calls: while on, PyTorch's sync debug mode warns at each
  call that waits for the card (``.item()``, ``int()``, ``.cpu()``, a
  copy from pageable host memory); each is counted against the innermost
  span with the program's line that made it.

On a device trace (the Chrome trace of ``torch.profiler``):

- ``clock_offset``: the trace's clock against the host's, the median of
  (runtime launch call of a reported kernel, ``launched`` host time)
  pairs, with its spread; where no such kernel ran (a CPU run), the ends
  of the ``record_function`` range that each root span opens (their
  starts carry the profiler's first-call cost).
- ``attribute``: each device operation to the innermost span open when
  its launch call was made, each idle gap to the innermost span open at
  its start (or ``OUTSIDE``), the host's time in root spans against its
  time blocked in synchronising calls, and the idle time while the host
  is inside the program and not waiting.

``trace(log_dir, device)``: the ``--profile DIR`` exporter, a
``torch.profiler`` trace written to ``log_dir/trace.json`` with the
tracer on and its spans added to that file on the trace's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import statistics
import sys
import time
import warnings
from dataclasses import dataclass, field

import torch

TRACE_FILE = "trace.json"
SYNC_WARNING = "called a synchronizing CUDA operation"
OUTSIDE = "outside the program"
# The entry points (csrc/) of the kernels whose launches are reported to
# ``launched``: the walks of ``_dispatch`` and the shading kernels.
LAUNCHED_KERNELS = ("stack_kernel", "stack_chan_kernel",
                    "skip_closest_hit_kernel", "skip_chan_kernel",
                    "wide_closest_hit_kernel", "wide_chan_kernel",
                    "shade_extend_kernel", "pixel_shade_kernel",
                    "joint_draw_kernel", "anyhit_sky_kernel")
# The key of a frame graph's replay (render/pipeline.FrameGraph), reported
# as one launch of the frame's pixels.
GRAPH_KEY = "frame_graph"
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_tracer = None   # the Tracer of the enclosing tracing(), or None
_OFF = contextlib.nullcontext()   # every site's span while it is off


class Span:
    """One span: ``start`` and ``end`` in host ns, the ``parent`` span's
    id and the ``root``'s (-1 and its own id for a root), the bounce
    ``j``, and the launches reported inside it (``lanes``, the last
    launch's ``key``).  A root span also opens a ``record_function``
    range, which places it on a profiler's clock where nothing else
    can."""

    __slots__ = ("name", "id", "parent", "root", "start", "end", "j",
                 "lanes", "key", "_tracer", "_annotation")

    def __init__(self, tracer, name: str, j):
        self._tracer = tracer
        self.name = name
        self.id = len(tracer.spans)
        self.j = j
        self.lanes = 0
        self.key = None
        self.start = self.end = None
        self._annotation = None

    def __enter__(self):
        stack = self._tracer.stack
        self.parent = stack[-1].id if stack else -1
        self.root = stack[0].id if stack else self.id
        if not stack:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self._tracer.stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        return False


@dataclass
class Record:
    """What one window recorded.

    - ``spans``: one dict a span (``name``, ``id``, ``parent``,
      ``root``, ``start_ns``, ``end_ns``, ``j``, ``lanes``, ``key``,
      ``live``: the live lanes counted in it), in the order opened;
    - ``syncs``: (span id or -1, the program's line, host ns) of each
      synchronising call, -1 outside every span;
    - ``launches``: (host ns at which it returned, key, lanes) of each
      reported launch (traversal and shading kernels);
    - ``counters``: (span id or -1, name, value) of each ``count``."""

    spans: list = field(default_factory=list)
    syncs: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    counters: list = field(default_factory=list)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s["name"] == name]

    def counted(self, name: str) -> int:
        """The sum of the counter ``name`` over the window."""
        return sum(v for _, n, v in self.counters if n == name)

    def roots(self) -> list:
        return [s for s in self.spans if s["parent"] == -1]

    def program_syncs(self) -> list:
        """The synchronising calls made inside the program's spans."""
        return [s for s in self.syncs if s[0] >= 0]


class Tracer:
    """The spans, counters and synchronising calls of one window."""

    def __init__(self):
        self.spans = []
        self.stack = []
        self.launches = []
        self.syncs = []
        self.live = []       # (span id, int or 0-d tensor)
        self.counters = []   # (span id, name, int)
        self.returned = None  # host ns at which the last C launcher returned
        self._prior = warnings.showwarning   # other warnings go on to it

    def open(self, name: str, j=None) -> Span:
        s = Span(self, name, j)
        self.spans.append(s)
        return s

    def launched(self, key: str, lanes: int) -> None:
        t = self.returned or time.perf_counter_ns()
        self.returned = None
        if self.stack:
            inner = self.stack[-1]
            inner.lanes += lanes
            inner.key = key
        self.launches.append((t, key, lanes))

    def count_live(self, count) -> None:
        self.live.append((self.stack[-1].id if self.stack else -1, count))

    def count(self, name: str, value: int) -> None:
        self.counters.append((self.stack[-1].id if self.stack else -1, name,
                              int(value)))

    def _warning(self, message, category, filename, lineno, file=None,
                 line=None):
        if not str(message).startswith(SYNC_WARNING):
            self._prior(message, category, filename, lineno, file, line)
            return
        t = time.perf_counter_ns()
        self.syncs.append((self.stack[-1].id if self.stack else -1,
                           _site(filename, lineno), t))

    def collect(self) -> Record:
        """Everything recorded so far, the live counts read from the
        device in one transfer; the tracer starts again empty."""
        tensors = [c for _, c in self.live if isinstance(c, torch.Tensor)]
        read = iter(torch.stack([t.reshape(()).to(torch.int64)
                                 for t in tensors]).tolist()
                    if tensors else [])
        live = {}
        for span_id, c in self.live:
            value = next(read) if isinstance(c, torch.Tensor) else int(c)
            live[span_id] = live.get(span_id, 0) + value
        spans = [{"name": s.name, "id": s.id, "parent": s.parent,
                  "root": s.root, "start_ns": s.start, "end_ns": s.end,
                  "j": s.j, "lanes": s.lanes, "key": s.key,
                  "live": live.get(s.id)} for s in self.spans]
        record = Record(spans, list(self.syncs), list(self.launches),
                        list(self.counters))
        self.spans, self.launches, self.syncs, self.live = [], [], [], []
        self.counters = []
        return record


def _site(filename: str, lineno: int) -> str:
    """``path:line`` of the innermost frame of the program's package
    (not this module) on the stack, else of the warning's own frame."""
    here = os.path.abspath(__file__)
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(PACKAGE + os.sep) and path != here:
            return f"{os.path.relpath(path, PACKAGE)}:{frame.f_lineno}"
        frame = frame.f_back
    return f"{os.path.basename(filename)}:{lineno}"


def span(name: str, j=None):
    """A span named ``name`` (``j``: a bounce index) as a context
    manager; a shared no-op one while the tracer is off."""
    tracer = _tracer
    if tracer is None:
        return _OFF
    return tracer.open(name, j)


def launched(key: str, origin) -> None:
    """A kernel launch of ``origin.shape[0]`` lanes under ``key`` (a
    ``LAUNCHES`` key of ``ops.stack_traverse`` or ``ops.shade``), just
    made."""
    tracer = _tracer
    if tracer is not None:
        tracer.launched(key, origin.shape[0])


def launch_returned() -> None:
    """The C launcher of a kernel just returned."""
    tracer = _tracer
    if tracer is not None:
        tracer.returned = time.perf_counter_ns()


def count_live(count) -> None:
    """The live lanes of the innermost span (an int or a 0-d tensor)."""
    tracer = _tracer
    if tracer is not None:
        tracer.count_live(count)


def count(name: str, value: int) -> None:
    """A host counter of the innermost span (module docstring)."""
    tracer = _tracer
    if tracer is not None:
        tracer.count(name, value)


@contextlib.contextmanager
def tracing():
    """The tracer on for the calls made inside; yields the Tracer.
    Where CUDA is initialised, PyTorch's sync debug mode is ``warn``
    inside and restored after."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("the tracer is already on")
    tracer = Tracer()
    mode = None
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = tracer._warning
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _tracer = tracer
        try:
            yield tracer
        finally:
            _tracer = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)


# -- a device trace ----------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_events(path: str) -> list:
    """The ``traceEvents`` of a Chrome trace file."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _corr(e) -> int:
    return (e.get("args") or {}).get("correlation", -1)


def _interval(e):
    return (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))


def _is_blocking(name: str) -> bool:
    """A runtime call that holds the host until the card catches up."""
    return "Synchronize" in name or name.startswith("cudaMemcpy")


@dataclass
class Timeline:
    """A Chrome trace's device operations and runtime calls, in µs on
    the trace's clock: (start, end, name, correlation), by start."""

    ops: list
    runtime: list
    annotations: list   # (start, end, name) of record_function ranges

    @classmethod
    def of(cls, events) -> "Timeline":
        ops, runtime, annotations = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ops.append((*_interval(e), e["name"], _corr(e)))
            elif cat == "cuda_runtime":
                runtime.append((*_interval(e), e["name"], _corr(e)))
            elif cat == "user_annotation":
                annotations.append((*_interval(e), e["name"]))
        for xs in (ops, runtime, annotations):
            xs.sort()
        return cls(ops, runtime, annotations)

    def kernel_launches(self) -> list:
        """The runtime launch calls of the kernels of LAUNCHED_KERNELS,
        by start."""
        walks = {c for _, _, name, c in self.ops
                 if any(k in name for k in LAUNCHED_KERNELS)}
        return [r for r in self.runtime if r[3] in walks]


@dataclass
class Clock:
    """Trace µs = host ns / 1e3 + ``offset_us``; ``spread_us`` the
    quartiles' distance of the pairs' offsets, ``range_us`` their
    range, ``source`` ``launches`` or ``annotations``."""

    offset_us: float
    spread_us: float
    range_us: float
    pairs: int
    source: str


def clock_offset(record: Record, timeline: Timeline) -> Clock | None:
    """The trace's clock against the host's (the module docstring): the
    k-th launch (or root span) paired with the k-th reported kernel's
    launch call (or root range) in the trace; None where there is nothing to
    pair, or the two counts differ (a trace that lost events)."""
    walks = timeline.kernel_launches()
    if walks:
        host = [t / 1e3 for t, _, lanes in record.launches if lanes > 0]
        trace = [end for _, end, _, _ in walks]
        source = "launches"
    else:
        roots = record.roots()
        names = {s["name"] for s in roots}
        host = [s["end_ns"] / 1e3 for s in roots]
        trace = [end for _, end, name in timeline.annotations
                 if name in names]
        source = "annotations"
    if not host or len(host) != len(trace):
        return None
    offsets = [t - h for h, t in zip(host, trace)]
    q = (statistics.quantiles(offsets, n=4) if len(offsets) > 1
         else [offsets[0]] * 3)
    return Clock(statistics.median(offsets), q[2] - q[0],
                 max(offsets) - min(offsets), len(offsets), source)


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _intersect(a, b) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, k = [], 0, 0
    while i < len(a) and k < len(b):
        s, e = max(a[i][0], b[k][0]), min(a[i][1], b[k][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[k][1]:
            i += 1
        else:
            k += 1
    return out


def _subtract(a, b) -> list:
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, k = [], 0
    for s, e in a:
        while k < len(b) and b[k][1] <= s:
            k += 1
        j = k
        while j < len(b) and b[j][0] < e:
            if b[j][0] > s:
                out.append([s, b[j][0]])
            s = max(s, b[j][1])
            j += 1
        if s < e:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _innermost(spans, times) -> list:
    """For each time, the index in ``spans`` ((start, end), nested as
    a call stack's) of the innermost span that holds it, or -1."""
    by_start = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out = [-1] * len(times)
    stack, k = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while k < len(by_start) and spans[by_start[k]][0] <= t:
            i = by_start[k]
            k += 1
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


@dataclass
class Attribution:
    """A window's device trace by the program's spans (µs)."""

    clock: Clock
    window_us: float
    busy_us: float
    device_us: dict          # span id -> device time of its launches
    unattributed_us: float   # device time launched outside every span
    idle_by_span: dict       # span name or OUTSIDE -> idle time
    idle_in_roots: dict      # root name -> idle time inside, not waiting
    host_us: float           # host time inside root spans
    wait_us: float           # ... blocked in synchronising calls
    wait_by_site: dict       # program line -> host time blocked there
    spans: list              # the record's spans

    def device_us_under(self, name: str) -> float:
        """Device time launched in spans named ``name`` or inside one;
        NaN where no such span was entered and a frame of the window
        replayed a graph (``GRAPH_KEY``), whose device time is not split
        by the spans inside it: absent, not 0."""
        if (all(s["name"] != name for s in self.spans)
                and any(s["key"] == GRAPH_KEY for s in self.spans)):
            return math.nan
        by_id = {s["id"]: s for s in self.spans}
        total = 0.0
        for span_id, us in self.device_us.items():
            s = by_id[span_id]
            while s is not None and s["name"] != name:
                s = by_id.get(s["parent"])
            if s is not None:
                total += us
        return total

    @property
    def idle_in_program_us(self) -> float:
        """Idle time while the host is inside a root span and not in a
        synchronising call."""
        return sum(self.idle_in_roots.values())

    @property
    def attributed_share(self) -> float:
        """The share of the device's busy time launched inside a span."""
        total = sum(self.device_us.values()) + self.unattributed_us
        return sum(self.device_us.values()) / total if total else 0.0


def attribute(record: Record, timeline: Timeline, clock: Clock,
              window_ns=None) -> Attribution:
    """``timeline`` by ``record``'s spans (the module docstring).
    ``window_ns``: (start, end) host ns of the window, by default the
    first root span's start to the last one's end."""
    off = clock.offset_us
    spans = record.spans
    placed = [(s["start_ns"] / 1e3 + off, s["end_ns"] / 1e3 + off)
              for s in spans]
    roots = [placed[i] for i, s in enumerate(spans) if s["parent"] == -1]
    root_names = {s["name"] for s in spans if s["parent"] == -1}
    if window_ns is None:
        window = (min(r[0] for r in roots), max(r[1] for r in roots))
    else:
        window = (window_ns[0] / 1e3 + off, window_ns[1] / 1e3 + off)
    ops = [o for o in timeline.ops if window[0] <= o[0] < window[1]]
    calls = {c: s for s, _, _, c in timeline.runtime if c >= 0}
    known = [o for o in ops if o[3] in calls]
    device_us = {}
    unattributed = sum(o[1] - o[0] for o in ops if o[3] not in calls)
    for o, i in zip(known, _innermost(placed, [calls[o[3]] for o in known])):
        if i < 0:
            unattributed += o[1] - o[0]
        else:
            device_us[spans[i]["id"]] = (device_us.get(spans[i]["id"], 0.0)
                                         + o[1] - o[0])
    busy = _intersect(_merge((o[0], o[1]) for o in ops), [list(window)])
    idle = _subtract([list(window)], busy)
    idle_by_span = {}
    for (s, e), i in zip(idle, _innermost(placed, [g[0] for g in idle])):
        name = spans[i]["name"] if i >= 0 else OUTSIDE
        idle_by_span[name] = idle_by_span.get(name, 0.0) + e - s
    in_program = _merge(roots)
    blocking = _merge((s, e) for s, e, name, _ in timeline.runtime
                      if _is_blocking(name))
    idle_in_roots = {
        name: _length(_subtract(_intersect(idle, _merge(
            p for p, s in zip(placed, spans)
            if s["parent"] == -1 and s["name"] == name)), blocking))
        for name in sorted(root_names)}
    waits = _intersect(blocking, in_program)
    # A call's waits are the blocking calls that ended after the call
    # before it returned and before its own warning.
    wait_by_site = {}
    ends = [e for _, e in blocking]
    prior = 0
    for span_id, site, t in sorted(record.syncs, key=lambda x: x[2]):
        k = bisect.bisect_right(ends, t / 1e3 + off)
        if span_id >= 0:
            wait_by_site[site] = wait_by_site.get(site, 0.0) + _length(
                blocking[prior:k])
        prior = max(prior, k)
    return Attribution(
        clock=clock, window_us=window[1] - window[0], busy_us=_length(busy),
        device_us=device_us, unattributed_us=unattributed,
        idle_by_span=idle_by_span, idle_in_roots=idle_in_roots,
        host_us=_length(in_program), wait_us=_length(waits),
        wait_by_site=wait_by_site, spans=spans)


def span_events(record: Record, clock: Clock) -> list:
    """The record's spans as Chrome trace events on the trace's clock
    (one row, ``program spans``), each synchronising call an instant."""
    pid, tid = os.getpid(), "program spans"
    events = []
    for s in record.spans:
        args = {k: s[k] for k in ("id", "parent", "root", "j", "lanes",
                                  "key", "live") if s[k] is not None}
        events.append({"ph": "X", "cat": "program_span", "name": s["name"],
                       "pid": pid, "tid": tid,
                       "ts": s["start_ns"] / 1e3 + clock.offset_us,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": args})
    for span_id, site, t in record.syncs:
        events.append({"ph": "i", "s": "t", "cat": "program_sync",
                       "name": site, "pid": pid, "tid": tid,
                       "ts": t / 1e3 + clock.offset_us,
                       "args": {"span": span_id}})
    return events


@contextlib.contextmanager
def trace(log_dir: str, device="cpu"):
    """Record a ``torch.profiler`` trace into ``log_dir/trace.json``:
    the CPU's activity, and the card's when ``device`` is CUDA; the
    tracer on inside, its spans added to the file on the trace's clock
    (where nothing pairs the clocks, the file is left without them)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with torch.profiler.profile(activities=activities) as prof:
        with tracing() as tracer:
            yield prof
    record = tracer.collect()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    clock = clock_offset(record, Timeline.of(doc["traceEvents"]))
    if clock is not None:
        doc["traceEvents"] += span_events(record, clock)
        with open(path, "w") as f:
            json.dump(doc, f)
