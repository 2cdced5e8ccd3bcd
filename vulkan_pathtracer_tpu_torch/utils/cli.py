"""CLI with the reference's flag surface, plus TPU-build extensions.

Flag names, short forms and defaults match ``main.zig:29-84`` exactly:
``--scene-path/-s`` (required), ``--num-samples/-c`` (1),
``--num-bounces/-b`` (2), ``--resolution-x/-x`` (1920),
``--resolution-y/-y`` (1080), ``--render-resolution-divider/-d`` (1),
``--enable-validation/-v`` (false).  Like the reference, a missing
scene path prints "Missing path to scene from arguments" on stderr.
"""

from __future__ import annotations

import argparse
import sys

from vulkan_pathtracer_tpu_torch.utils.config import RenderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vulkan-pathtracer-tpu",
        description="TPU-native wavefront path tracer",
    )
    # -- reference surface ---------------------------------------------------
    p.add_argument("--scene-path", "-s", type=str, default="")
    p.add_argument("--num-samples", "-c", type=int, default=1)
    p.add_argument("--num-bounces", "-b", type=int, default=2)
    p.add_argument("--resolution-x", "-x", type=int, default=1920)
    p.add_argument("--resolution-y", "-y", type=int, default=1080)
    p.add_argument("--render-resolution-divider", "-d", type=int, default=1)
    p.add_argument("--enable-validation", "-v", action="store_true")

    # -- TPU-build extensions ------------------------------------------------
    p.add_argument("--output", "-o", type=str, default="out.png",
                   help="output PNG path (headless present target)")
    p.add_argument("--frames", type=int, default=1,
                   help="number of frames to render (camera-path playback)")
    p.add_argument("--camera-path", type=str, default="",
                   help="JSON camera path for animated fly-through")
    p.add_argument("--progressive", action="store_true",
                   help="accumulate radiance across frames")
    p.add_argument("--russian-roulette", action="store_true",
                   help="enable RR path termination (extension)")
    p.add_argument("--traversal",
                   choices=["auto", "bvh", "brute", "pallas",
                            "pallas_packet", "pallas8"],
                   default="auto")
    p.add_argument("--interactive", action="store_true",
                   help="terminal viewer: ANSI half-block frames with "
                        "WASD/space/c movement + ijkl look (the "
                        "zig-window analog); best with small -x/-y")
    p.add_argument("--instanced", action="store_true",
                   help="two-level BVH: per-mesh BLAS + TLAS, geometry "
                        "stored once (Tlas.zig semantics); best for "
                        "instance-heavy / animated scenes")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the framebuffer across this many devices")
    p.add_argument("--checkpoint", type=str, default="",
                   help="accumulation checkpoint file for resume")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="snapshot the accumulator every N frames")
    p.add_argument("--stats-interval", type=float, default=1.0,
                   help="seconds between stats log lines")
    p.add_argument("--profile", type=str, default="",
                   help="capture a jax.profiler trace into this directory")
    p.add_argument("--shard-mode", choices=["tiles", "spp"], default="tiles",
                   help="multi-device sharding strategy for --devices > 1")
    p.add_argument("--save-every", type=int, default=0,
                   help="write the PNG every N frames (progressive preview)")
    p.add_argument("--batch-frames", type=int, default=1,
                   help="progressive frames per device dispatch (static "
                        "camera only; amortizes dispatch overhead)")
    p.add_argument("--gltf-quirk-mode", action="store_true",
                   help="reproduce the reference's node-flattening "
                        "quirk (Scene.zig:515-532: non-mesh nodes pass "
                        "their inherited matrix through, ignoring their "
                        "own TRS) for end-to-end image parity on scenes "
                        "with non-mesh-node transforms")
    p.add_argument("--pool-frames", type=int, default=1,
                   help="frames-in-flight: render N camera-path frames "
                        "as ONE pooled wavefront (1 spp; denser bounce "
                        "sort, higher throughput, same images)")
    return p


def parse_args(argv=None):
    """Returns (config, args) or exits like the reference on bad input."""
    args = build_parser().parse_args(argv)
    if not args.scene_path:
        # main.zig:81-84 semantics.
        sys.stderr.write("Missing path to scene from arguments\n")
        raise SystemExit(1)
    config = RenderConfig(
        num_samples=args.num_samples,
        num_bounces=args.num_bounces,
        resolution_x=args.resolution_x,
        resolution_y=args.resolution_y,
        render_resolution_divider=args.render_resolution_divider,
        enable_validation=args.enable_validation,
        progressive=args.progressive,
        russian_roulette=args.russian_roulette,
        traversal=args.traversal,
    )
    return config, args
