"""The program's own spans and counters over a cell's traffic, placed on
the device trace's clock: the readings of a traced window with the
program's tracer on (``vulkan_pathtracer_tpu_torch.utils.profiling``).

    python3 -m ptbench.program_spans --workload <cell> --seeds 11,12,13 \
        [--seconds 3] [--cost 10]

The scene is loaded and baked once.  For each seed, the cell's traffic
runs for ``--seconds`` under ``torch.profiler`` (CUDA activity alone, as
in the benchmark's profiled window) with the tracer on; the trace is
exported, the spans placed on its clock by the program's launch pairs
(``profiling.clock_offset``) and the trace attributed to them
(``profiling.attribute``).  One JSON line per seed: the metrics of
``METRICS`` (per output frame, or per sample per pixel for a still),
the clock's offset and spread, the share of the device's busy time
launched inside a span, the synchronising calls by site, idle time by
span, and the live lanes against the rays the window's calls returned.

``--cost S`` first runs windows of S seconds with the tracer off, on
(without the profiler), on, off, and prints their rates.

On the CPU there is no device trace: the metrics that read it are None,
and ``host_syncs`` and ``traverse_live_share`` read the program alone.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

METRICS = {
    # name: (unit per frame, per spp)
    "host_enqueue_ms": ("ms/frame", "ms/spp"),
    "host_wait_ms": ("ms/frame", "ms/spp"),
    "host_syncs": ("syncs/frame", "syncs/spp"),
    "idle_in_program": ("%", "%"),
    "shade_span_ms": ("ms/frame", "ms/spp"),
    "sort_span_ms": ("ms/frame", "ms/spp"),
    "traverse_live_share": ("%", "%"),
}


def readings(record, attribution, units: int) -> dict:
    """Each metric of METRICS from a window's record and its attribution
    (None where there is no device trace), per output unit."""
    lanes = sum(s["lanes"] for s in record.named("traverse"))
    live = sum(s["live"] or 0 for s in record.named("bounce"))
    out = {"host_syncs": len(record.program_syncs()) / units,
           "traverse_live_share": 100.0 * live / lanes if lanes else None}
    at = attribution
    if at is None:
        out.update({k: None for k in METRICS if k not in out})
        return out
    out.update({
        "host_enqueue_ms": (at.host_us - at.wait_us) / 1e3 / units,
        "host_wait_ms": at.wait_us / 1e3 / units,
        "idle_in_program": 100.0 * at.idle_in_program_us / at.window_us,
        "shade_span_ms": at.device_us_under("shade") / 1e3 / units,
        "sort_span_ms": at.device_us_under("sort") / 1e3 / units,
    })
    return out


class Rays:
    """The rays returned by the pipeline's calls, kept on the device and
    summed after the window."""

    CALLS = ("render", "render_batch_sum", "render_pooled")

    def __init__(self, pipe):
        self.kept = []
        for name in self.CALLS:
            setattr(pipe, name, self._wrap(getattr(pipe, name)))

    def _wrap(self, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.kept.append(out[1])
            return out
        return call

    def total(self) -> int:
        import torch

        n = int(torch.stack(self.kept).sum()) if self.kept else 0
        self.kept.clear()
        return n


def traced_window(client, seconds: float, device, scratch: str):
    """One window of ``client``'s traffic with the tracer on, under the
    profiler on a card; returns (window, record, attribution or None)."""
    import torch

    from vulkan_pathtracer_tpu_torch.utils import profiling

    if device.type != "cuda":
        with profiling.tracing() as tracer:
            window = client.run(seconds)
        return window, tracer.collect(), None
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with profiling.tracing() as tracer:
            t0 = time.perf_counter_ns()
            window = client.run(seconds)
            t1 = time.perf_counter_ns()
    record = tracer.collect()
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, f"trace.{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        timeline = profiling.Timeline.of(profiling.read_events(path))
    finally:
        if os.path.exists(path):
            os.remove(path)
    clock = profiling.clock_offset(record, timeline)
    attribution = (None if clock is None else
                   profiling.attribute(record, timeline, clock, (t0, t1)))
    return window, record, attribution


def seed_line(cell, mix, seed, window, record, attribution, rays) -> dict:
    unit = mix.get("unit") == "spp"
    units = window.spp if unit else window.frames
    suffix = ".still" if unit else ".frame"
    values = readings(record, attribution, units)
    syncs = record.program_syncs()
    sites = collections.Counter(site for _, site, _ in syncs)
    by_span = collections.Counter(record.spans[i]["name"] for i, _, _ in syncs)
    line = {"workload": cell.name, "seed": seed, "units": units,
            "window_s": window.seconds,
            "metrics": {k + suffix: {"value": v, "unit": METRICS[k][unit]}
                        for k, v in values.items() if v is not None},
            "syncs_by_site": {k: v / units for k, v in sorted(sites.items())},
            "syncs_by_span": {k: v / units
                              for k, v in sorted(by_span.items())},
            "syncs_outside": sum(1 for s in record.syncs if s[0] < 0) / units,
            "live_lanes": sum(s["live"] or 0 for s in record.named("bounce")),
            "lanes_launched": sum(s["lanes"] for s in record.named(
                "traverse")),
            "rays_returned": rays}
    at = attribution
    if at is not None:
        line.update({
            "clock": {"offset_us": at.clock.offset_us,
                      "spread_us": at.clock.spread_us,
                      "range_us": at.clock.range_us,
                      "pairs": at.clock.pairs, "source": at.clock.source},
            "attributed_share": at.attributed_share,
            "unattributed_ms": at.unattributed_us / 1e3,
            "busy_share": at.busy_us / at.window_us,
            "device_idle": 100.0 * (1.0 - at.busy_us / at.window_us),
            "idle_by_span_ms": {k: v / 1e3 / units for k, v in sorted(
                at.idle_by_span.items(), key=lambda kv: -kv[1])},
            "idle_in_roots_ms": {k: v / 1e3 / units
                                 for k, v in at.idle_in_roots.items()},
            "wait_by_site_ms": {k: v / 1e3 / units for k, v in sorted(
                at.wait_by_site.items())},
            "device_ms_by_span": {
                name: at.device_us_under(name) / 1e3 / units
                for name in ("primaries", "bounce", "sort", "traverse",
                             "shade", "finish", "accumulate")}})
    return line


def card(device) -> str:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def cost_windows(client, seconds: float, unit: str) -> dict:
    """Rates of windows with the tracer off, on, on, off (no profiler)."""
    from vulkan_pathtracer_tpu_torch.utils import profiling

    rates = []
    for on in (False, True, True, False):
        if on:
            with profiling.tracing() as tracer:
                window = client.run(seconds)
            tracer.collect()
        else:
            window = client.run(seconds)
        done = window.spp if unit == "spp" else window.frames
        rates.append({"tracer": on, "rate": done / window.seconds})
    return {"cost": rates, "unit": f"{unit}/s"}


def run(workload: str, seeds, seconds: float, device, cost: float = 0.0,
        sizes: dict = None, mix: dict = None, out=sys.stdout) -> list:
    """The lines of ``seeds`` (and of ``cost``) for one cell on
    ``device``; ``sizes`` and ``mix`` override the configuration's and
    the traffic's entries (the CPU tests' small runs)."""
    from ptbench import run as bench
    from ptbench.cell import Cell
    from ptbench.traffic import Traffic

    cell = Cell(workload)
    config = {**cell.config, **(sizes or {})}
    mix = {**cell.mix, **(mix or {})}
    program = bench.Program(config, device)
    rays = Rays(program.pipe)
    lines = []
    for k, seed in enumerate(seeds):
        traffic = Traffic(mix, seed, config["width"], config["height"],
                          device)
        client = program.client(traffic)
        if k == 0:
            client.warm_up()
            if cost:
                line = {"workload": workload, "card": card(device),
                        **cost_windows(client, cost, mix["unit"])}
                print(json.dumps(line), file=out, flush=True)
                lines.append(line)
        rays.total()
        window, record, attribution = traced_window(
            client, seconds, device, os.path.join(bench.BUILD, "spans"))
        line = seed_line(cell, mix, seed, window, record, attribution,
                         rays.total())
        line["card"] = card(device)
        print(json.dumps(line), file=out, flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ptbench.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--cost", type=float, default=0.0,
                    help="seconds of each tracer off / on window first")
    args = ap.parse_args(argv)
    from ptbench import run as bench

    bench.cache_environment()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ptbench.program_spans: needs a CUDA device\n")
        return 3
    run(args.workload, [int(s) for s in args.seeds.split(",")],
        args.seconds, torch.device("cuda"), args.cost)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
