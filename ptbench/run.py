"""The benchmark of the PyTorch and CUDA path tracer on one card.

    python3 -m ptbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (``cell.py`` finds its files) from
the root of a checkout:

1. set-up: the scene's glTF generated once into ``build/ptbench/``
   (``scenes/<generator>.py``), loaded and baked by the program
   (``app.main.load_pipeline``; its CUDA kernels built once into
   ``build/torch_kernels/``), and the traffic's shapes warmed up;
   ``setup_s`` runs from the process's start to the first timed unit;
2. the window: the traffic (``traffic.py``) for ``--seconds``; with
   ``--trace 1`` two windows of at most the mix's ``trace_seconds``
   each: the first under the per-layer metrics' CUDA-event spans
   (``spans.py``), the second under ``torch.profiler`` and the
   traversal's ray samplers;
3. the device's peak memory, then the program's state freed;
4. the check (``check.py``): the (first) window's kept outputs against
   the plain reference; ``correct`` when every number compared is
   within its limit;
5. the result: the numbers compared on standard error's last lines,
   and one JSON line on standard output: ``correct``, ``attempted``,
   ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and ``checks`` last.

A mix with ``"ranks": N`` (N > 1) runs on N cards, one rank each, through
the program's own multi-device path (``ranks.py``); the parent process
prints rank 0's line.

It exits 3 and prints no result where no CUDA device is available or
fewer than the cell asks for, 4 where ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``vulkan_pathtracer_tpu`` is loaded after the window
(top-level module names compared whole; in every rank), and 5 where a
rank raised or died.  Build and kernel caches are kept under
``build/ptbench/`` of the checkout.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build", "ptbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "vulkan_pathtracer_tpu")
_IMPORTED = time.monotonic()


def since_start() -> float:
    """Seconds since this process started (``/proc``: its start tick
    against the uptime), else since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def cache_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library loads JAX by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(BUILD, sub)
    os.environ["USE_FLAX"] = "0"


def scene_file(spec: dict) -> str:
    """The configuration's scene (``scene``: a generator of
    ``scenes/`` and its parameters), generated once into
    build/ptbench/."""
    params = {k: v for k, v in spec.items() if k != "generator"}
    generator = importlib.import_module(f"ptbench.scenes.{spec['generator']}")
    os.makedirs(BUILD, exist_ok=True)
    name = "_".join([spec["generator"]] + [f"{k}{params[k]}"
                                           for k in sorted(params)])
    path = os.path.join(BUILD, f"{name}.glb")
    if not os.path.exists(path):
        part = f"{path}.{os.getpid()}.part"
        generator.make(part, **params)
        os.replace(part, path)
    return path


class Reading:
    """What the per-layer readers read (metrics/*.py)."""

    def __init__(self, span_units, trace_units, recorder, trace, card,
                 bake_s, scene_path, device, rank_spans=None):
        self.span_units = span_units    # output units of the spans' window
        self.trace_units = trace_units  # ... and of the profiled window
        self.recorder = recorder
        self.rank_spans = rank_spans or {}  # metric -> each rank's total
        self.trace = trace
        self.card = card
        self.bake_s = bake_s
        self._scene_path = scene_path
        self._device = device
        self._least = ()

    def span_ms(self, metric: str):
        return self.recorder.span_ms(metric)

    def rank_span_ms(self, metric: str):
        """Each rank's total of the metric's spans, by rank, where the
        cell runs on several ranks and every rank has one; else None."""
        return self.rank_spans.get(metric)

    def kernel_seconds(self, patterns):
        return None if self.trace is None else self.trace.seconds_of(patterns)

    def least_traversal_seconds(self):
        """The least time of the traversal calls' work (work.py), or
        None; computed once."""
        if self._least == ():
            from ptbench import work
            from ptbench.reference import gltf, tree

            self._least = None
            if "traverse_roofline" not in self.recorder.missing:
                tri = gltf.load_triangles(self._scene_path)
                ref = tree.build_tree(tri.v0, tri.e1, tri.e2, self._device)
                self._least = work.least_seconds(
                    work.call_work(ref, self.recorder.rays), self.card)
        return self._least


class Program:
    """The program as the benchmark drives it: the configuration's scene
    loaded and baked (``app.main.load_pipeline``), on one rank of several
    split by ``rank.shard``, and the program's ``Camera`` and
    ``Accumulator`` types."""

    def __init__(self, config: dict, device, rank=None):
        from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
        from vulkan_pathtracer_tpu_torch.models.camera import Camera
        from vulkan_pathtracer_tpu_torch.render.output import Accumulator
        from vulkan_pathtracer_tpu_torch.utils import RenderConfig

        self.camera_type, self.acc_type = Camera, Accumulator
        self.scene_path = scene_file(config["scene"])
        render_config = RenderConfig(num_samples=config["spp"],
                                     num_bounces=config["bounces"],
                                     resolution_x=config["width"],
                                     resolution_y=config["height"])
        t0 = time.perf_counter()
        self.pipe = load_pipeline(self.scene_path, render_config, device,
                                  instanced=config["bake"] == "two-level")
        self.bake_s = time.perf_counter() - t0
        if rank is not None:
            self.pipe = rank.shard(self.pipe, render_config)

    def client(self, traffic):
        from ptbench.traffic import Client

        return Client(traffic, self.pipe, self.camera_type, self.acc_type)


def _install(recorder, per_layer, what: str) -> None:
    """The per-layer readers' ``WRAP`` spans, or for the profiled window
    their ``SAMPLE`` samplers and ``WRAP`` functions as host steps."""
    for metric, reader in per_layer:
        base = metric["name"].split(".")[0]
        if what == "WRAP" and hasattr(reader, "WRAP"):
            recorder.time(base, *reader.WRAP)
        if what == "SAMPLE" and hasattr(reader, "WRAP"):
            recorder.log(base, *reader.WRAP)
        if what == "SAMPLE" and hasattr(reader, "SAMPLE"):
            recorder.sample(base, *reader.SAMPLE)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             sizes: dict = None, mix: dict = None, rank=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line.
    ``sizes`` and ``mix`` override the configuration's and the traffic's
    entries (the CPU tests' small runs).  ``rank`` (``ranks.Rank``):
    this process as one rank of several, which runs the windows in
    lockstep with the others; rank 0 returns the line, the others
    None."""
    import torch

    from ptbench import check, spans
    from ptbench.devtrace import DeviceTrace
    from ptbench.traffic import Traffic

    config = {**cell.config, **(sizes or {})}
    mix = {**cell.mix, **(mix or {})}
    cuda = device.type == "cuda"
    program = Program(config, device, rank)
    path, bake_s = program.scene_path, program.bake_s
    traffic = Traffic(mix, seed, config["width"], config["height"], device)
    client = program.client(traffic)
    client.warm_up()
    if rank is None:
        run, setup_s = client.run, since_start()
    else:
        rank.lockstep(client, int(mix["calibration"]))
        run = functools.partial(rank.window, client)
        setup_s = rank.since_start()

    recorder = spans.Recorder(device, seed, client.steps)
    dtrace = profiled = None
    if trace:
        # Two windows of the same traffic: the spans' CUDA events alone,
        # then the profiler's device trace (CUDA activity alone, the
        # least host cost) with the traversal's ray samples and the host
        # steps logged.
        trace_s = min(seconds, mix["trace_seconds"])
        _install(recorder, cell.per_layer, "WRAP")
        try:
            window = run(trace_s)
        finally:
            recorder.restore()
        _install(recorder, cell.per_layer, "SAMPLE")
        # The samplers' first calls load their kernels: once, here.
        recorder.every = 1
        client.warm_up()
        recorder.every = spans.SAMPLE_EVERY
        recorder.clear_samples()
        activities = ([torch.profiler.ProfilerActivity.CUDA] if cuda
                      else [torch.profiler.ProfilerActivity.CPU])
        client.steps.on = True
        try:
            with torch.profiler.profile(activities=activities) as prof:
                marker_ns = time.perf_counter_ns()
                if cuda:
                    torch.cuda.synchronize()
                profiled = run(trace_s)
        finally:
            client.steps.on = False
            recorder.restore()
        if cuda:
            dtrace = DeviceTrace.read(prof, profiled.seconds,
                                      client.steps.log, marker_ns)
    else:
        window = run(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    busy = None if dtrace is None else dtrace.busy_s
    rank_spans = None
    if rank is not None:
        peak, busy, rank_spans = rank.gather(peak, busy, recorder)
    del client, program
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if rank is not None and not rank.primary:
        return None

    t0 = time.perf_counter()
    result = check.compare(window.kept, traffic, config, path, device)
    sys.stderr.write(f"ptbench: setup {setup_s:.2f} s (bake {bake_s:.2f} s), "
                     f"window {window.seconds:.2f} s, {window.units} units, "
                     f"check {time.perf_counter() - t0:.2f} s\n")
    numbers = result["numbers"]
    correct = bool(window.kept) and all(
        n["value"] <= n["limit"] for n in numbers.values())
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    def units(win):
        return win.spp if mix.get("unit") == "spp" else win.frames

    metrics = {}
    if trace:
        ctx = Reading(units(window), units(profiled), recorder, dtrace, card,
                      bake_s, path, device, rank_spans)
        readers = cell.per_layer
    else:
        readers = cell.end_to_end
    for metric, reader in readers:
        value = (reader.read(ctx) if trace
                 else reader.read(window, setup_s))
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": card,
           "count": 1 if rank is None else rank.world,
           "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": window.units,
            "failed": result["failed"] if window.kept else window.units,
            "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = busy
        dev["window_s"] = dtrace.window_s
        line["breakdown"] = {"device_ops": [list(o) for o in
                                            dtrace.top_ops()],
                             "idle_gaps": dtrace.idle_gaps()}
    line["checks"] = numbers
    return line


def report(line: dict, found: list) -> int:
    """The numbers compared on standard error and the line on standard
    output; exit 4 instead where JAX was loaded (``found``)."""
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        sys.stderr.write(f"ptbench: JAX was loaded: {', '.join(found)}\n")
        return 4
    for name, n in line["checks"].items():
        sys.stderr.write(f"check {name} {n['value']!r} limit {n['limit']!r}\n")
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ptbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_environment()
    from ptbench.cell import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"ptbench: {args.workload} needs {cell.chips} CUDA "
                         f"device(s); this machine has "
                         f"{torch.cuda.device_count()}\n")
        return 3
    if int(cell.mix.get("ranks", 1)) > 1:
        from ptbench import ranks

        return ranks.run_ranks(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda")
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda"))
    return report(line, [])


if __name__ == "__main__":
    raise SystemExit(main())
