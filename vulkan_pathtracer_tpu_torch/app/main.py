"""Headless CLI — port of app/main.py (single camera, single frame path).

parse CLI -> load scene -> bake device tensors + BVH -> render pipeline
-> frame loop -> PNG.  The flag surface is the reference's
(``-s -c -b -x -y -d``) plus ``-o``/``--frames``, ``--instanced`` (the
two-level BVH: per-mesh BLAS + TLAS, models/instanced_scene.py),
``--traversal`` (the closest-hit tier, render/wavefront.py: ``brute``
bakes no BVH, ``pallas8`` bakes the 8-wide tiles too) and ``--device``
(default ``cuda``).  Every other flag of the JAX package's CLI is
recognised but refused when set: it is not yet ported.

Run:  python -m vulkan_pathtracer_tpu_torch -s scene.glb [flags]
"""

from __future__ import annotations

import sys
import time

import torch

from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import (
    RenderConfig,
    build_parser,
    default_max_leaf,
    upsample_nearest,
    write_png,
)

PORTED_FLAGS = ("scene_path", "num_samples", "num_bounces", "resolution_x",
                "resolution_y", "render_resolution_divider", "output",
                "frames", "instanced", "traversal", "device")
# Leaf size of the two-level bake (app/main.py:75-77 of the JAX package).
INSTANCED_LEAF = 14


def parse_args(argv=None):
    """(RenderConfig, args); exits 1 on a missing scene path (like the
    reference) and 2 on a flag that is not yet ported."""
    parser = build_parser()
    parser.prog = "python -m vulkan_pathtracer_tpu_torch"
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda | cpu)")
    args = parser.parse_args(argv)
    for action in parser._actions:
        dest = action.dest
        if dest in PORTED_FLAGS or dest == "help":
            continue
        if getattr(args, dest) != action.default:
            flag = action.option_strings[0]
            sys.stderr.write(f"{flag}: not yet ported in "
                             f"vulkan_pathtracer_tpu_torch\n")
            raise SystemExit(2)
    if not args.scene_path:
        sys.stderr.write("Missing path to scene from arguments\n")
        raise SystemExit(1)
    config = RenderConfig(
        num_samples=args.num_samples,
        num_bounces=args.num_bounces,
        resolution_x=args.resolution_x,
        resolution_y=args.resolution_y,
        render_resolution_divider=args.render_resolution_divider,
        traversal=args.traversal,
    )
    return config, args


def resolve_device(name: str) -> torch.device:
    """The requested device, or a clear error: no silent CPU fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: vulkan_pathtracer_tpu_torch renders on "
            "the GPU by default; pass --device cpu to run the plain "
            "PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {name!r} (cuda | cpu)")
    return device


def load_pipeline(scene_path: str, config: RenderConfig, device,
                  instanced: bool = False) -> RenderPipeline:
    """Load a glTF scene, bake it — flat with the size-keyed leaf policy
    (utils/config.default_max_leaf), or two-level at leaf 14 — and build
    the render pipeline.  ``config.traversal`` picks what the flat bake
    holds, as the JAX app does (app/main.py:86-90): no BVH for
    ``brute``, the 8-wide tiles too for ``pallas8``."""
    scene = gltf.load(scene_path)
    print(f"scene: {len(scene.instances)} instances, "
          f"{len(scene.primitives)} primitives, {scene.triangle_count} "
          f"triangles, {len(scene.materials)} materials, "
          f"{len(scene.textures)} textures", file=sys.stderr)
    if instanced:
        dev = build_instanced_scene(scene, max_leaf_size=INSTANCED_LEAF,
                                    device=device)
        print(f"two-level BVH: {dev.num_triangles} shared triangles, "
              f"{dev.inst_inv.shape[0]} instances", file=sys.stderr)
    else:
        dev = build_device_scene(
            scene, max_leaf_size=default_max_leaf(scene.triangle_count),
            device=device, build_bvh=config.traversal != "brute",
            wide=config.traversal == "pallas8")
        if dev.wide_nodes is not None:
            print(f"8-wide tiles: {dev.wide_nodes.shape[0] // 8} per octant, "
                  f"baked in {dev.wide_seconds:.2f} s", file=sys.stderr)
    return RenderPipeline(dev, config)


def present(image, config: RenderConfig, output: str) -> None:
    """Divider upsample (nearest blit) + unorm8 quantize + PNG."""
    if config.render_resolution_divider > 1:
        image = upsample_nearest(image, config.resolution_x,
                                 config.resolution_y)
    write_png(output, image)


def main(argv=None) -> int:
    config, args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    print(f"loading scene: {args.scene_path}", file=sys.stderr)
    pipeline = load_pipeline(args.scene_path, config, device,
                             instanced=args.instanced)
    camera = Camera(aspect_ratio=config.aspect_ratio)
    image = None
    rays_total = 0
    t0 = time.perf_counter()
    for frame in range(args.frames):
        image_dev, rays = pipeline.render(camera, frame, present_order=False)
        image = pipeline.to_present(image_dev.cpu().numpy())
        rays_total += int(rays)
    seconds = time.perf_counter() - t0
    if image is not None:
        present(image, config, args.output)
        print(f"wrote {args.output}", file=sys.stderr)
        print(f"{args.frames} frame(s) on {device}: "
              f"{1000.0 * seconds / args.frames:.2f} ms/frame, "
              f"{rays_total / seconds / 1e6:.3f} Mrays/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
