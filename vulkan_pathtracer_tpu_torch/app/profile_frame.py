"""Where a frame's device time goes: per-step CUDA-event times of the
headline frame, flat or two-level, of one joint progressive batch, or
of one pooled group of frames.

    [VKPT_KERNEL_PRIMARY=... VKPT_MT=mxu ...] \
    python -m vulkan_pathtracer_tpu_torch.app.profile_frame [--instanced]
        [--traversal auto|pallas|pallas_packet|pallas8|bvh|brute]
        [-s scene.glb] [--frames 5] [--joint B | --pooled F |
         --animate refit|rebuild]

Renders the atrium (``assets/procedural.make_atrium(detail=4.1)``,
generated into ``build/profile_frame/`` when ``-s`` is not given) at
1920x1080, 1 spp, 2 bounces on bench.py's interior orbit: one warm-up
frame, then ``--frames`` frames with every wavefront step wrapped in a
pair of CUDA events, then 3 frames under ``torch.profiler``, through
the closest-hit tier of ``--traversal`` and the kernel tiers of the
``VKPT_*`` variables, read as the CLI reads them (app/main.py
``tier_fields_from_env``; render/wavefront.py).  Prints
one JSON line: the card, ms/frame (median, host clock around frames
that end in a synchronize), per-step device ms per frame (median;
``*_sorted`` steps include their nested ``_sorted_order`` and kernel
step), and the profiled kernel time per frame against the unprofiled
and the profiled wall time (the device busy share).  Needs a CUDA
device.

With ``--joint B`` each "frame" is one joint batch of B frames of the
camera at t=0 (``RenderPipeline.render_batch_sum``, the convergence
path): the steps are the shared primary (``_closest_hit``, with the
middle bounces' closest hits when there are any), its triangle and
material fetch, the 6d key (``_bounce_sort_key``), the argsort
(``state_sort_order``) and the state gathers (``_permute_prefix``),
bounce 0's shading chunks (``_frame_lanes``, the per-pixel shading
copied to each frame's lanes, and ``_next_segment``, the draws; nested
in ``_shade_and_extend`` on middle bounces), the any hit and the sky on
its misses (``_add_sky``),
and the final per-pixel sum (``_sum_frames``); 1 batch runs under the
profiler.  The line also holds the batch's rays, its shading chunks,
the peak device memory, and the state layout's cost: the gathers of the
state's tensors by the sort's order (``_permute_prefix``) against one
row gather of a packed (lanes, 16) f32 state by the same order (the
JAX package's layout), timed on that batch's order.

With ``--pooled F`` each "frame" is one pooled group of F frames of F
cameras on the orbit at ``4.0 * k / F`` (``RenderPipeline.render_pooled``,
the fly-through): the steps are the closest hits of bounce 0 (and of
the middle bounces), their shading (``_shade_and_extend``, with its
nested fetches, ``extend_paths`` and ``_add_sky``), the 6d key, the
argsort and the state gathers of each later bounce, the any hit and
its sky, and the colors put back by lane id (``_by_lane``); 1 group
runs under the profiler.  ``ms_per_output_frame_median`` divides the
wall time by the frames a "frame" holds (B, F or 1).

With ``--animate refit`` each frame first moves the flat atrium's 32
instances (app/dynamic.bob_transforms at ``4.0 * f / --frames``, the
AnimatedScene built with the ``VKPT_*`` tiers) and with ``--animate
rebuild`` twists its triangles (app/dynamic.twist at phase ``4.0 * f /
--frames``) and rebuilds the tree on the device; the line holds the
median device ms of each step (rebake, refit, regenerate; or twist,
morton, radix_tree, aabb, octants, tables), of the 1080p render that
follows and of the render's wavefront steps (as without
``--animate``), per frame, besides the wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
from vulkan_pathtracer_tpu_torch.app.main import (
    load_pipeline,
    tier_fields_from_env,
)
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.render.pipeline import TRAVERSALS
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

STEPS = ("_closest_hit", "_any_hit", "_closest_hit_sorted", "_any_hit_sorted",
         "_sorted_order", "get_triangle_data", "get_material_data",
         "extend_paths")
JOINT_STEPS = ("_closest_hit", "_any_hit", "get_triangle_data",
               "get_material_data", "_frame_lanes", "_next_segment",
               "_bounce_sort_key", "state_sort_order", "_permute_prefix",
               "_shade_and_extend", "_add_sky", "_sum_frames")
POOLED_STEPS = ("_closest_hit", "_any_hit", "get_triangle_data",
                "get_material_data", "extend_paths", "_bounce_sort_key",
                "state_sort_order", "_permute_prefix", "_shade_and_extend",
                "_add_sky", "_by_lane")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _timed(name, fn, log):
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((name, start, end))
        return out
    return run


def packed_gather(frame, tensor_gathers, reps: int = 3) -> dict:
    """The state's tensor gathers of the joint batch (median ms per
    batch) against one row gather of a packed (lanes, 16) f32 state by
    the order of a batch's sort (median of ``reps``)."""
    orders = []
    sort_order = wavefront.state_sort_order

    def keep(key, c):
        out = sort_order(key, c)
        orders.append(out[1])
        return out

    wavefront.state_sort_order = keep
    try:
        frame(1)
    finally:
        wavefront.state_sort_order = sort_order
    order = orders[0]
    packed = torch.zeros((order.numel(), 16), dtype=torch.float32,
                         device=order.device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        packed.index_select(0, order)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"tensors_gather": statistics.median(tensor_gathers),
            "packed_row_gather": statistics.median(times),
            "lanes": order.numel()}


def animate(args, path: str, dev) -> int:
    """--animate: per-step device ms of the dynamic frames (the module
    docstring), one JSON line."""
    from vulkan_pathtracer_tpu_torch.app import dynamic
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.animation import (
        build_animated_scene,
    )
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils.config import default_max_leaf

    tiers = tier_fields_from_env()
    config = RenderConfig(num_samples=1, num_bounces=2, **tiers)
    host = gltf.load(path)
    leaf = config.max_leaf or default_max_leaf(host.triangle_count)
    timer = dynamic.StepTimer(dev)
    if args.animate == "refit":
        anim = build_animated_scene(host, max_leaf_size=leaf, device=dev,
                                    mt=config.mt,
                                    frontier_width=config.frontier_width)
        base_tf = anim.initial_transforms(host)
        ext = dynamic.largest_extent(anim.base)

        def scene_at(t):
            timer.start()
            return anim.with_transforms(
                dynamic.bob_transforms(base_tf, ext, t), on_step=timer.mark)
        first = anim.base
    else:
        template = build_device_scene(host, max_leaf_size=leaf, device=dev,
                                      build_bvh=False)

        def scene_at(t):
            return dynamic.rebuild_frame(template, t, timer,
                                         coefs=config.mt == "mxu")
        first = scene_at(0.0)
    pipe = RenderPipeline(first, config)
    orbit = orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0))
    cam = Camera(aspect_ratio=config.aspect_ratio)

    def frame(f, t):
        orbit.apply(cam, t)
        pipe.scene = scene_at(t)
        steps = timer.ms()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, rays = pipe.render(cam, f, present_order=False)
        end.record()
        rays = int(rays)
        steps["render"] = start.elapsed_time(end)
        return steps, rays

    frame(0, 0.0)   # warm-up
    walls, per, log = [], {}, []
    originals = {n: getattr(wavefront, n) for n in STEPS}
    for n, fn in originals.items():
        setattr(wavefront, n, _timed(n, fn, log))
    try:
        for f in range(args.frames):
            log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps, rays = frame(f + 1, 4.0 * f / args.frames)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            for n in STEPS:
                steps[n] = sum(start.elapsed_time(end)
                               for m, start, end in log if m == n)
            for k, v in steps.items():
                per.setdefault(k, []).append(v)
    finally:
        for n, fn in originals.items():
            setattr(wavefront, n, fn)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, "animate": args.animate, "tiers": tiers, "leaf": leaf,
        "triangles": first.num_triangles, "rays_per_frame": rays,
        "frames": args.frames,
        "ms_per_frame_median": statistics.median(walls),
        "ms_per_frame": walls,
        "step_ms_per_frame_median": {k: statistics.median(v)
                                     for k, v in per.items() if any(v)},
        "step_ms_per_frame": per}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_frame")
    ap.add_argument("-s", "--scene-path", default="")
    ap.add_argument("--instanced", action="store_true")
    ap.add_argument("--traversal", choices=TRAVERSALS, default="auto")
    ap.add_argument("--frames", type=int, default=5)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--joint", type=int, default=0, metavar="B",
                       help="time joint batches of B frames instead")
    group.add_argument("--pooled", type=int, default=0, metavar="F",
                       help="time pooled groups of F frames instead")
    group.add_argument("--animate", choices=["refit", "rebuild"],
                       help="move the flat scene every frame and time "
                       "its refit or device rebuild steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("profile_frame: needs a CUDA device\n")
        return 1
    path = args.scene_path
    if not path:
        sys.path.insert(0, ROOT)
        from assets.procedural import make_atrium

        work = os.path.join(ROOT, "build", "profile_frame")
        os.makedirs(work, exist_ok=True)
        path = os.path.join(work, "atrium_4.1.glb")
        if not os.path.exists(path):
            make_atrium(path, detail=4.1)
    dev = torch.device("cuda")
    if args.animate:
        return animate(args, path, dev)
    tiers = tier_fields_from_env()
    config = RenderConfig(num_samples=1, num_bounces=2,
                          traversal=args.traversal, **tiers)
    pipe = load_pipeline(path, config, dev, instanced=args.instanced)
    orbit = orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0))
    cam = Camera(aspect_ratio=config.aspect_ratio)

    steps_of = (JOINT_STEPS if args.joint else
                POOLED_STEPS if args.pooled else STEPS)
    group_cams = []
    for k in range(args.pooled):
        group_cams.append(Camera(aspect_ratio=config.aspect_ratio))
        orbit.apply(group_cams[-1], 4.0 * k / args.pooled)

    def frame(f):
        if args.joint:
            orbit.apply(cam, 0.0)
            image, rays = pipe.render_batch_sum(cam, f * args.joint,
                                                args.joint)
        elif args.pooled:
            image, rays = pipe.render_pooled(
                group_cams, [f * args.pooled + k for k in range(args.pooled)])
        else:
            orbit.apply(cam, 4.0 * f / args.frames)
            image, rays = pipe.render(cam, f, present_order=False)
        return int(rays)   # syncs: rays is a device scalar

    frame(0)   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    log = []
    originals = {n: getattr(wavefront, n) for n in steps_of}
    for n, fn in originals.items():
        setattr(wavefront, n, _timed(n, fn, log))
    walls, steps = [], {n: [] for n in steps_of}
    try:
        for f in range(args.frames):
            log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rays = frame(f + 1)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            per = {n: 0.0 for n in steps_of}
            for n, start, end in log:
                per[n] += start.elapsed_time(end)
            for n in steps_of:
                steps[n].append(per[n])
            chunks = sum(1 for n, _, _ in log if n == "_next_segment")
    finally:
        for n, fn in originals.items():
            setattr(wavefront, n, fn)

    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    layout = packed_gather(frame, steps["_permute_prefix"]) if args.joint \
        else None
    prof_frames = 1 if args.joint or args.pooled else 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(prof_frames):
            frame(f + 1)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / prof_frames
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    device_ms = device_us / 1e3 / prof_frames
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, "instanced": args.instanced,
        "traversal": args.traversal, "tiers": tiers,
        "leaf": pipe.scene.max_leaf_size,
        "triangles": pipe.scene.num_triangles, "rays_per_frame": rays,
        "frames": args.frames, "joint_batch": args.joint or None,
        "pooled_frames": args.pooled or None,
        "shading_chunks": chunks if args.joint else None,
        "peak_allocated_gb": peak_gb, "state_layout_ms": layout,
        "ms_per_frame_median": statistics.median(walls),
        "ms_per_output_frame_median": (statistics.median(walls)
                                       / (args.joint or args.pooled or 1)),
        "ms_per_frame": walls,
        "step_ms_per_frame_median": {n: statistics.median(v)
                                     for n, v in steps.items() if any(v)},
        "profiled_device_ms_per_frame": device_ms or None,
        "profiled_wall_ms_per_frame": prof_wall,
        # Kernel time against the unprofiled wall (the profiler slows
        # the host's launches) and against the profiled wall.
        "device_busy_share": (device_ms / statistics.median(walls)
                              if device_ms else None),
        "device_busy_share_profiled": (device_ms / prof_wall
                                       if device_ms else None),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
