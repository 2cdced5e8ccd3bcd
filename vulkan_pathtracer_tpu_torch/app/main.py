"""Headless CLI — port of app/main.py (single camera, single frame path).

parse CLI -> load scene -> bake device tensors + BVH -> render pipeline
-> frame loop -> PNG.  The flag surface is the reference's
(``-s -c -b -x -y -d``) plus ``-o``/``--frames``, ``--instanced`` (the
two-level BVH: per-mesh BLAS + TLAS, models/instanced_scene.py),
``--traversal`` (the closest-hit tier, render/wavefront.py: ``brute``
bakes no BVH, ``pallas8`` bakes the 8-wide tiles too) and ``--device``
(default ``cuda``).  Every other flag of the JAX package's CLI is
recognised but refused when set: it is not yet ported.

The kernel tiers are chosen, as in the JAX package, by environment
variables, read here once into RenderConfig's tier fields
(``tier_fields_from_env``): ``VKPT_KERNEL_PRIMARY`` /
``VKPT_KERNEL_SECONDARY`` (quad | pair | oct | frontier | packet and
JAX's ``*_hbm`` / ``vgate`` names), ``VKPT_ANYHIT_KERNEL=frontier``,
``VKPT_MT=mxu`` (coefficient leaves), ``VKPT_LEAF`` (the leaf size) and
``VKPT_FRONTIER_WIDTH`` (16 | 32).  ``VKPT_FRONTIER_LEAF`` (cond | drain)
names a TPU staging only and changes nothing here.  No module below
``app/`` reads the environment.

Run:  python -m vulkan_pathtracer_tpu_torch -s scene.glb [flags]
"""

from __future__ import annotations

import os
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
from vulkan_pathtracer_tpu_torch.utils.config import (
    FRONTIER_WIDTH,
    FRONTIER_WIDTHS,
    MT_MODES,
)

PORTED_FLAGS = ("scene_path", "num_samples", "num_bounces", "resolution_x",
                "resolution_y", "render_resolution_divider", "output",
                "frames", "instanced", "traversal", "device")
# Leaf size of the two-level bake (app/main.py:75-77 of the JAX package).
INSTANCED_LEAF = 14


def tier_fields_from_env(environ=None) -> dict:
    """RenderConfig's tier fields from the JAX package's ``VKPT_*``
    variables (unset -> None, JAX's default).  Raises ValueError on a
    value the port refuses: an unknown ``VKPT_MT`` or frontier width,
    ``VKPT_MXU_PRECISION=default`` (mxu_mt.py:58-80, the one-pass bf16
    product of the coefficient leaves) and ``VKPT_PRESPLIT`` other than
    0 (device_scene.py:410, triangle pre-splitting at bake time), which
    are not yet ported."""
    env = os.environ if environ is None else environ

    def get(name):
        value = env.get(name, "").strip()
        return value or None

    mt = (get("VKPT_MT") or "exact").lower()
    if mt not in MT_MODES:
        raise ValueError(f"VKPT_MT={mt!r}: exact | mxu")
    precision = (get("VKPT_MXU_PRECISION") or "highest").lower()
    if precision == "default":
        raise ValueError("VKPT_MXU_PRECISION=default (one bf16 pass for "
                         "the coefficient leaves): not yet ported in "
                         "vulkan_pathtracer_tpu_torch; the port computes "
                         "them in f32 (highest)")
    if precision not in ("high", "highest"):
        raise ValueError(f"VKPT_MXU_PRECISION={precision!r}: highest")
    presplit = get("VKPT_PRESPLIT")
    if presplit is not None and presplit != "0":
        raise ValueError(f"VKPT_PRESPLIT={presplit} (triangle pre-splitting "
                         f"in the bake): not yet ported in "
                         f"vulkan_pathtracer_tpu_torch; unset it or set 0")
    width = int(get("VKPT_FRONTIER_WIDTH") or FRONTIER_WIDTH)
    if width not in FRONTIER_WIDTHS:
        raise ValueError(f"VKPT_FRONTIER_WIDTH={width}: 16 | 32")
    leaf = get("VKPT_LEAF")
    return dict(kernel_primary=get("VKPT_KERNEL_PRIMARY"),
                kernel_secondary=get("VKPT_KERNEL_SECONDARY"),
                anyhit_kernel=get("VKPT_ANYHIT_KERNEL"), mt=mt,
                max_leaf=None if leaf is None else int(leaf),
                frontier_width=width)


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
    try:
        tiers = tier_fields_from_env()
        RenderConfig(**tiers).tiers.validate()
    except ValueError as exc:
        sys.stderr.write(f"error: {exc}\n")
        raise SystemExit(2)
    config = RenderConfig(
        num_samples=args.num_samples,
        num_bounces=args.num_bounces,
        resolution_x=args.resolution_x,
        resolution_y=args.resolution_y,
        render_resolution_divider=args.render_resolution_divider,
        traversal=args.traversal,
        **tiers,
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
    (utils/config.default_max_leaf), or two-level at leaf 14, unless
    ``config.max_leaf`` says otherwise (VKPT_LEAF, JAX app/main.py:76,
    :88) — and build the render pipeline.  ``config.traversal`` picks
    what the flat bake holds, as the JAX app does (app/main.py:86-90):
    no BVH for ``brute``, the 8-wide tiles too for ``pallas8``;
    ``config.mt == "mxu"`` adds the coefficient leaves and
    ``config.frontier_width`` sets the frontier tables' width."""
    scene = gltf.load(scene_path)
    print(f"scene: {len(scene.instances)} instances, "
          f"{len(scene.primitives)} primitives, {scene.triangle_count} "
          f"triangles, {len(scene.materials)} materials, "
          f"{len(scene.textures)} textures", file=sys.stderr)
    if instanced:
        dev = build_instanced_scene(
            scene, max_leaf_size=config.max_leaf or INSTANCED_LEAF,
            device=device, mt=config.mt)
        print(f"two-level BVH: {dev.num_triangles} shared triangles, "
              f"{dev.inst_inv.shape[0]} instances", file=sys.stderr)
    else:
        dev = build_device_scene(
            scene, max_leaf_size=(config.max_leaf
                                  or default_max_leaf(scene.triangle_count)),
            device=device, build_bvh=config.traversal != "brute",
            wide=config.traversal == "pallas8", mt=config.mt,
            frontier_width=config.frontier_width)
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
    if config.mt != "exact" or any((
            config.kernel_primary, config.kernel_secondary,
            config.anyhit_kernel, config.max_leaf)):
        print(f"kernel tiers: primary={config.kernel_primary or 'default'} "
              f"secondary={config.kernel_secondary or 'default'} "
              f"anyhit={config.anyhit_kernel or 'default'} mt={config.mt} "
              f"leaf={pipeline.scene.max_leaf_size}", file=sys.stderr)
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
