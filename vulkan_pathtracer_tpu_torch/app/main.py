"""Headless CLI — port of app/main.py.

parse CLI -> load scene -> bake device tensors + BVH -> render pipeline
-> frame loop -> PNG.  The flag surface is the JAX package's: the
reference's (``-s -c -b -x -y -d -v``) plus ``-o``/``--frames``,
``--instanced`` (the two-level BVH: per-mesh BLAS + TLAS,
models/instanced_scene.py), ``--traversal`` (the closest-hit tier,
render/wavefront.py: ``brute`` bakes no BVH, ``pallas8`` bakes the
8-wide tiles too), the convergence path (``--progressive``,
``--batch-frames``, ``--checkpoint``, ``--checkpoint-interval``,
``--save-every``, ``--russian-roulette``), ``--camera-path``,
``--pool-frames``, ``--interactive``, ``--profile``,
``--gltf-quirk-mode`` and ``--stats-interval`` (parsed and unused, as
in the JAX package), multi-device rendering (``--devices N``,
``--shard-mode tiles|spp``), and the port's own ``--device`` (default
``cuda``) and ``--animation-step``.

A glTF with animations (node channels, models/gltf.py) is baked with
what poses it each frame (``load_pipeline``: the two-level bake moved by
``update_instance_transforms``, the flat bake as an AnimatedScene
refitted by ``with_transforms``; models/node_animation.py evaluates the
channels on the device): the per-frame loop shows frame ``f`` at ``f *
--animation-step`` seconds (default 1/60).  Batches, pooled groups and
several devices refuse to animate such a scene (exit 2), as does a file
whose animations the loader does not play (models/gltf.py);
``--animation-step 0`` bakes and renders any of them at rest, as the
viewer shows it.

``--devices N`` (N > 1) renders each frame on N ranks, one process and
one device each (parallel/): the CLI starts the N ranks itself, or,
when torchrun started it (``WORLD_SIZE`` set, which must equal N), is
one of them.  Every rank loads and bakes the scene, and renders through
``ShardedRenderPipeline`` (framebuffer tiles, or sample shards under
``--shard-mode spp``) in the per-frame loop below; rank 0 alone writes
the PNG, the ``STATS`` lines, the checkpoint and the profile.  CUDA
ranks take one card each (more ranks than cards exits 1, naming both
counts); ``--device cpu`` runs gloo ranks on the CPU.
``--interactive`` with ``--devices`` > 1 runs the viewer on every rank
(app/viewer.py): rank 0 reads its own stdin and presents, the others
follow its camera.

``-v`` checks the host BVH's invariants and renders a checked 64x64
frame (utils/validation.py) before the frame loop, and then checks
every rendered image for NaN and Inf.  ``--interactive`` runs the
terminal viewer (app/viewer.py) instead of the frame loop.

The frame loop keeps the JAX package's branches, in its order
(app/main.py:141-272 there; the first two on one device only), under
``--profile DIR`` inside a ``torch.profiler`` trace written to DIR, with
the program's spans added to it on its clock (utils/profiling.py):

1. ``--progressive --batch-frames B`` (B > 1) without a camera path:
   batches of up to B frames of the static camera per dispatch
   (``RenderPipeline.render_batch_sum``; the joint wavefront at 1 spp)
   into the float64 ``Accumulator``;
2. ``--pool-frames F`` (F > 1) at 1 spp without ``--progressive``:
   groups of up to F camera-path frames, each one pooled wavefront
   (``RenderPipeline.render_pooled``: frames in flight), the group's
   time and rays spread evenly over its frames in ``Stats``;
3. otherwise one frame after another along the camera path, summed
   into the accumulator under ``--progressive``;

``--save-every N`` writes the PNG every N frames (the running mean
under ``--progressive``, the group's last image when pooled).

Under ``--progressive``, ``--checkpoint f.npz`` resumes from that file
when it exists (stderr ``resumed checkpoint at frame N (S spp)``) and
``--checkpoint-interval N`` rewrites it every N frames.  ``Stats``
lines go to stderr as ``STATS {json}``.

The kernel tiers are chosen, as in the JAX package, by environment
variables, read here once into RenderConfig's tier fields
(``tier_fields_from_env``): ``VKPT_KERNEL_PRIMARY`` /
``VKPT_KERNEL_SECONDARY`` (quad | pair | oct | frontier | packet and
JAX's ``*_hbm`` / ``vgate`` names), ``VKPT_ANYHIT_KERNEL=frontier``,
``VKPT_MT=mxu`` (coefficient leaves), ``VKPT_MXU_PRECISION`` (highest
| high | default: the one-pass bf16 product of the coefficient leaves,
with JAX's warning), ``VKPT_LEAF`` (the leaf size),
``VKPT_FRONTIER_WIDTH`` (16 | 32), ``VKPT_FRONTIER_PRECISION`` (default
| high | highest) and ``VKPT_FRONTIER_GUARD`` (the frontier boxes'
guard band: 2^-7 under ``default``, 2^-12 under ``high`` or
``highest``, or the given number) and ``VKPT_PRESPLIT`` (the flat
bake's triangle pre-splitting budget, a float; > 0 splits scenes of
1024 or more triangles, the two-level bake ignores it).  ``VKPT_FRONTIER_LEAF`` (cond | drain)
names a TPU staging only and changes nothing here.  No module below
``app/`` reads the environment.

Run:  python -m vulkan_pathtracer_tpu_torch -s scene.glb [flags]
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys
import time
import warnings

import torch

from vulkan_pathtracer_tpu_torch.app.camera_path import CameraPath
from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.animation import (
    SceneAnimation,
    build_animated_scene,
)
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.models.node_animation import NodeAnimator
from vulkan_pathtracer_tpu_torch.ops.bvh import build_bvh_host, validate_bvh
from vulkan_pathtracer_tpu_torch.parallel import distributed
from vulkan_pathtracer_tpu_torch.parallel.mesh import make_render_group
from vulkan_pathtracer_tpu_torch.parallel.sharding import (
    ShardedRenderPipeline,
)
from vulkan_pathtracer_tpu_torch.render.output import Accumulator
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import (
    RenderConfig,
    build_parser,
    default_max_leaf,
    upsample_nearest,
    write_png,
)
from vulkan_pathtracer_tpu_torch.utils.config import (
    FRONTIER_GUARDS,
    FRONTIER_WIDTH,
    FRONTIER_WIDTHS,
    MT_MODES,
)
from vulkan_pathtracer_tpu_torch.utils.profiling import trace
from vulkan_pathtracer_tpu_torch.utils.stats import Stats
from vulkan_pathtracer_tpu_torch.utils.timer import Timer
from vulkan_pathtracer_tpu_torch.utils.validation import (
    ValidationError,
    check_finite,
    checked_render,
)

# Every flag of the JAX package's CLI, and the port's own.
PORTED_FLAGS = ("scene_path", "num_samples", "num_bounces", "resolution_x",
                "resolution_y", "render_resolution_divider",
                "enable_validation", "output", "frames", "camera_path",
                "progressive", "russian_roulette", "traversal",
                "interactive", "instanced", "devices", "checkpoint",
                "checkpoint_interval", "stats_interval", "profile",
                "shard_mode", "save_every", "batch_frames",
                "gltf_quirk_mode", "pool_frames", "device", "animation_step")
# Seconds between two frames of an animated scene (--animation-step).
ANIMATION_STEP = 1.0 / 60.0
# Leaf size of the two-level bake (app/main.py:75-77 of the JAX package).
INSTANCED_LEAF = 14
# mxu_mt.mxu_precision's warning for VKPT_MXU_PRECISION=default (a TPU
# v5e figure of the JAX package).
MXU_DEFAULT_WARNING = ("VKPT_MXU_PRECISION=default is quality-broken "
                       "(measured -3.8% hit checksum on the atrium A/B); use "
                       "'highest'.")


def tier_fields_from_env(environ=None) -> dict:
    """RenderConfig's tier fields from the JAX package's ``VKPT_*``
    variables (unset -> None, JAX's default; ``presplit`` only when
    ``VKPT_PRESPLIT`` is set, as the float JAX's bake reads,
    device_scene.py:410; ``frontier_guard`` as pallas_frontier._guard
    reads it: ``VKPT_FRONTIER_GUARD``, else 2^-7 for
    ``VKPT_FRONTIER_PRECISION=default`` or unset and 2^-12 for ``high``
    or ``highest``).  Raises ValueError on a value the port refuses: an
    unknown ``VKPT_MT``, frontier width or frontier precision, a
    ``VKPT_PRESPLIT`` or ``VKPT_FRONTIER_GUARD`` that is not a number, a
    negative guard (it would shrink the boxes and drop geometry), and an
    unknown ``VKPT_MXU_PRECISION``.  ``mxu_precision``: "default" (the
    one-pass bf16 product of the coefficient leaves, mxu_mt.py:58-80),
    else "highest" (``high`` is its alias, as in JAX); under
    ``VKPT_MT=mxu`` "default" warns as JAX does (MXU_DEFAULT_WARNING)."""
    env = os.environ if environ is None else environ

    def get(name):
        value = env.get(name, "").strip()
        return value or None

    mt = (get("VKPT_MT") or "exact").lower()
    if mt not in MT_MODES:
        raise ValueError(f"VKPT_MT={mt!r}: exact | mxu")
    precision = (get("VKPT_MXU_PRECISION") or "highest").lower()
    if precision not in ("default", "high", "highest"):
        raise ValueError(f"VKPT_MXU_PRECISION={precision!r}: highest | high "
                         f"| default")
    if precision == "default" and mt == "mxu":
        warnings.warn(MXU_DEFAULT_WARNING, stacklevel=2)
    presplit = get("VKPT_PRESPLIT")
    if presplit is not None:
        try:
            presplit = float(presplit)
        except ValueError:
            raise ValueError(f"VKPT_PRESPLIT={presplit!r}: a number (the "
                             f"pre-splitting budget, e.g. 0.3)") from None
    width = int(get("VKPT_FRONTIER_WIDTH") or FRONTIER_WIDTH)
    if width not in FRONTIER_WIDTHS:
        raise ValueError(f"VKPT_FRONTIER_WIDTH={width}: 16 | 32")
    leaf = get("VKPT_LEAF")
    fields = dict(kernel_primary=get("VKPT_KERNEL_PRIMARY"),
                  kernel_secondary=get("VKPT_KERNEL_SECONDARY"),
                  anyhit_kernel=get("VKPT_ANYHIT_KERNEL"), mt=mt,
                  max_leaf=None if leaf is None else int(leaf),
                  frontier_width=width, frontier_guard=frontier_guard(get),
                  mxu_precision="default" if precision == "default"
                  else "highest")
    if presplit is not None:
        fields["presplit"] = presplit
    return fields


def frontier_guard(get) -> float:
    """The frontier bake's guard band from ``get(name)`` (the variable's
    value or None), as pallas_frontier._guard reads it."""
    name = (get("VKPT_FRONTIER_PRECISION") or "default").lower()
    if name not in FRONTIER_GUARDS:
        raise ValueError(f"VKPT_FRONTIER_PRECISION={name!r}: default | high "
                         f"| highest")
    guard = get("VKPT_FRONTIER_GUARD")
    if guard is None:
        return FRONTIER_GUARDS[name]
    try:
        value = float(guard)
    except ValueError:
        raise ValueError(f"VKPT_FRONTIER_GUARD={guard!r}: a number (the "
                         f"frontier boxes' guard band, e.g. 0.0078125)"
                         ) from None
    if not value >= 0.0:
        raise ValueError(f"VKPT_FRONTIER_GUARD={guard!r}: at least 0 (a "
                         f"negative band shrinks the boxes and drops "
                         f"geometry)")
    return value


def parse_args(argv=None):
    """(RenderConfig, args); exits 1 on a missing scene path (like the
    reference) and 2 on a flag or a kernel tier that is not yet
    ported."""
    parser = build_parser()
    parser.prog = "python -m vulkan_pathtracer_tpu_torch"
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda | cpu)")
    parser.add_argument("--animation-step", type=float,
                        default=ANIMATION_STEP,
                        help="seconds of a glTF's animation between two "
                             "frames: frame f is shown at f * step; 0 "
                             "renders the scene at rest")
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
        enable_validation=args.enable_validation,
        progressive=args.progressive,
        russian_roulette=args.russian_roulette,
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
                  instanced: bool = False, quirk_mode: bool = False,
                  animate: bool = True) -> RenderPipeline:
    """Load a glTF scene, bake it — flat with the size-keyed leaf policy
    (utils/config.default_max_leaf), or two-level at leaf 14, unless
    ``config.max_leaf`` says otherwise (VKPT_LEAF, JAX app/main.py:76,
    :88) — and build the render pipeline.  ``config.traversal`` picks
    what the flat bake holds, as the JAX app does (app/main.py:86-90):
    no BVH for ``brute``, the 8-wide tiles too for ``pallas8``;
    ``config.mt == "mxu"`` adds the coefficient leaves (bf16 under
    ``config.mxu_precision == "default"``),
    ``config.frontier_width`` and ``config.frontier_guard`` set the
    frontier tables' width and guard band and ``config.presplit`` the
    flat bake's pre-splitting budget;
    ``quirk_mode`` is the loader's node-flattening quirk
    (``--gltf-quirk-mode``).  With ``animate``, a scene with animations
    comes with its SceneAnimation (the module docstring), and one whose
    animations the loader does not play (``animation_refused``) raises
    its reason (ValueError); the flat bake's pre-split and 8-wide tiles
    do not survive its refit, so ``presplit`` and ``pallas8`` refuse it
    too.  Without ``animate`` the scene is baked at rest."""
    scene = gltf.load(scene_path, quirk_mode=quirk_mode)
    if not animate:
        scene = dataclasses.replace(scene, animation=None)
    elif scene.animation_refused:
        raise ValueError(f"{scene.animation_refused} (the file renders at "
                         f"rest without a pose)")
    print(f"scene: {len(scene.instances)} instances, "
          f"{len(scene.primitives)} primitives, {scene.triangle_count} "
          f"triangles, {len(scene.materials)} materials, "
          f"{len(scene.textures)} textures", file=sys.stderr)
    animation = None
    if instanced:
        dev = build_instanced_scene(
            scene, max_leaf_size=config.max_leaf or INSTANCED_LEAF,
            device=device, mt=config.mt,
            mxu_precision=config.mxu_precision)
        print(f"two-level BVH: {dev.num_triangles} shared triangles, "
              f"{dev.inst_inv.shape[0]} instances", file=sys.stderr)
        if scene.animation is not None:
            animation = SceneAnimation(NodeAnimator(scene.animation, device),
                                       dev)
    elif scene.animation is not None:
        if config.traversal == "pallas8" or config.presplit > 0:
            raise ValueError("an animated flat scene is refitted each "
                             "frame: --traversal pallas8 and VKPT_PRESPLIT "
                             "do not run on it")
        rest = build_animated_scene(
            scene, max_leaf_size=(config.max_leaf
                                  or default_max_leaf(scene.triangle_count)),
            device=device, mt=config.mt,
            frontier_width=config.frontier_width,
            frontier_guard=config.frontier_guard,
            mxu_precision=config.mxu_precision)
        animation = SceneAnimation(NodeAnimator(scene.animation, device),
                                   rest)
        dev = rest.base
    else:
        dev = build_device_scene(
            scene, max_leaf_size=(config.max_leaf
                                  or default_max_leaf(scene.triangle_count)),
            device=device, build_bvh=config.traversal != "brute",
            wide=config.traversal == "pallas8", mt=config.mt,
            frontier_width=config.frontier_width, presplit=config.presplit,
            frontier_guard=config.frontier_guard,
            mxu_precision=config.mxu_precision)
    if not instanced:
        if config.presplit > 0 and dev.tree is not None:
            print(f"pre-split: {int(dev.tree.block_count.sum())} references "
                  f"of {dev.num_triangles} triangles (budget "
                  f"{config.presplit})", file=sys.stderr)
        if dev.wide_nodes is not None:
            print(f"8-wide tiles: {dev.wide_nodes.shape[0] // 8} per octant, "
                  f"baked in {dev.wide_seconds:.2f} s", file=sys.stderr)
    if animation is not None:
        print(f"animation: {len(scene.animation.channels)} channels move "
              f"{animation.moved} of {len(scene.instances)} instances",
              file=sys.stderr)
    return RenderPipeline(dev, config, animation)


def present(image, config: RenderConfig, output: str) -> None:
    """Divider upsample (nearest blit) + unorm8 quantize + PNG."""
    if config.render_resolution_divider > 1:
        image = upsample_nearest(image, config.resolution_x,
                                 config.resolution_y)
    write_png(output, image)


def load_accumulator(config: RenderConfig, checkpoint: str) -> Accumulator:
    """The progressive accumulator: resumed from ``checkpoint`` when the
    file exists, else empty."""
    if checkpoint and os.path.exists(checkpoint):
        acc = Accumulator.load(checkpoint)
        print(f"resumed checkpoint at frame {acc.frame} ({acc.spp} spp)",
              file=sys.stderr)
        return acc
    return Accumulator(config.render_width, config.render_height,
                       config.num_samples)


def validate(pipeline, config: RenderConfig) -> None:
    """``-v`` (JAX app/main.py:91-115): the host BVH invariants of the
    scene's triangles (``ops/bvh.validate_bvh``) and a checked 64x64
    frame (``utils/validation.checked_render``); raises on a fault."""
    scene = pipeline.scene
    if scene.has_bvh:
        n = scene.num_triangles
        v0, e1, e2 = (t[:n].cpu().numpy() for t in (
            scene.tri_v0, scene.tri_e1, scene.tri_e2))
        host_bvh = build_bvh_host(v0, e1, e2)
        order = host_bvh.tri_order
        validate_bvh(host_bvh, v0[order], e1[order], e2[order])
        print("BVH invariants validated", file=sys.stderr)
    checked_render(scene, Camera(aspect_ratio=config.aspect_ratio), config)
    print("render validation passed", file=sys.stderr)


class FrameLoop:
    """The CLI's frame loop state: the pipeline, the camera (and its
    path), ``Stats``, ``Timer``, the accumulator and the run's rays.
    Only the ``primary`` process (rank 0) writes files and logs."""

    def __init__(self, pipeline, config: RenderConfig, args, device,
                 primary: bool = True):
        self.pipeline = pipeline
        self.config = config
        self.args = args
        self.primary = primary
        self.camera = Camera(aspect_ratio=config.aspect_ratio)
        self.path = (CameraPath.load(args.camera_path) if args.camera_path
                     else None)
        self.stats = Stats(
            rays_per_frame=(config.render_width * config.render_height
                            * config.num_samples * config.num_bounces),
            spp_per_frame=config.num_samples, device=device)
        self.timer = Timer()
        self.acc = (load_accumulator(config, args.checkpoint)
                    if config.progressive else None)
        self.start_frame = self.acc.frame if self.acc is not None else 0
        self.rays = 0
        self.animated = getattr(pipeline, "animation", None) is not None

    def checked(self, image, what: str):
        """``image``; under ``-v`` first checked for NaN and Inf."""
        if self.config.enable_validation:
            check_finite(image, what)
        return image

    def lap(self, rays: int, frames: int = 1) -> None:
        """The time since the last lap and ``rays``, spread evenly over
        ``frames`` frames in ``Stats``."""
        self.rays += rays
        dt = self.timer.lap()
        for _ in range(frames):
            self.stats.lap(dt / frames, self.timer.one_second_elapsed,
                           rays_this_frame=rays // frames)
        if self.timer.one_second_elapsed and self.primary:
            self.stats.log()

    def cameras(self, first: int, count: int):
        """Cameras of frames ``first`` .. ``first + count - 1`` on the
        camera path (JAX app/main.py:211-219)."""
        cams = []
        for k in range(first, first + count):
            cam = Camera(aspect_ratio=self.config.aspect_ratio,
                         position=self.camera.position.copy(),
                         yaw=self.camera.yaw, pitch=self.camera.pitch)
            if self.path is not None:
                self.path.apply(cam, self.path.duration * k
                                / max(self.args.frames - 1, 1))
            cams.append(cam)
        return cams

    def batches(self):
        """Batches of up to ``--batch-frames`` frames of the static camera
        per dispatch into the accumulator.  Returns the final image."""
        args, acc = self.args, self.acc
        frame = self.start_frame
        since_save = 0
        while frame < args.frames:
            b = min(args.batch_frames, args.frames - frame)
            sum_img, rays = self.pipeline.render_batch_sum(self.camera,
                                                           frame, b)
            acc.add_frames_sum(self.checked(
                sum_img, f"frames {frame}..{frame + b - 1}").cpu().numpy(), b)
            frame += b
            since_save += b
            if (args.checkpoint and args.checkpoint_interval
                    and since_save >= args.checkpoint_interval):
                acc.save(args.checkpoint)
                since_save = 0
            self.lap(int(rays))
        return acc.mean

    def pooled(self):
        """Groups of up to ``--pool-frames`` camera-path frames, each one
        pooled wavefront; the group's time and rays are spread over its
        frames.  Returns the last frame's image."""
        args = self.args
        image = None
        frame = self.start_frame
        while frame < args.frames:
            g = min(args.pool_frames, args.frames - frame)
            images, rays = self.pipeline.render_pooled(
                self.cameras(frame, g), list(range(frame, frame + g)))
            image = self.checked(
                images, f"frames {frame}..{frame + g - 1}")[-1].cpu().numpy()
            frame += g
            self.lap(int(rays), g)
            if args.save_every and frame % args.save_every == 0:
                present(image, self.config, args.output)
        return image

    def frames(self):
        """One frame after another along the camera path, summed into the
        accumulator under ``--progressive``.  Returns the final image."""
        args, acc, pipeline = self.args, self.acc, self.pipeline
        image = None
        for frame in range(self.start_frame, args.frames):
            if self.path is not None:
                self.path.apply(self.camera, self.path.duration * frame
                                / max(args.frames - 1, 1))
            pose = ({"time": frame * args.animation_step} if self.animated
                    else {})
            image_dev, rays = pipeline.render(self.camera, frame,
                                              present_order=False, **pose)
            image = pipeline.to_present(
                self.checked(image_dev, f"frame {frame}").cpu().numpy())
            if acc is not None:
                acc.add_frame(image)
                if (args.checkpoint and args.checkpoint_interval
                        and (frame + 1) % args.checkpoint_interval == 0
                        and self.primary):
                    acc.save(args.checkpoint)
            self.lap(int(rays))
            if (args.save_every and (frame + 1) % args.save_every == 0
                    and self.primary):
                present(acc.mean if acc is not None else image, self.config,
                        args.output)
        return acc.mean if acc is not None else image


def main(argv=None) -> int:
    config, args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        sys.stderr.write(f"error: {exc}\n")
        return 1
    if args.devices > 1:
        return run_ranks(config, args, device)
    return render_main(config, args, device)


def run_ranks(config: RenderConfig, args, device) -> int:
    """``--devices N``: this process as one of torchrun's N ranks
    (``WORLD_SIZE`` set), else N ranks started here.  Returns the
    largest of the ranks' exit codes."""
    world = os.environ.get("WORLD_SIZE")
    if world is not None:
        if int(world) != args.devices:
            sys.stderr.write(f"error: --devices {args.devices}, but torchrun "
                             f"started {world} ranks\n")
            return 2
        distributed.initialize(device=device)
        try:
            return rank_main(make_render_group(device), config, args)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    try:
        return max(distributed.spawn(rank_main, args.devices, device,
                                     config, args))
    except RuntimeError as exc:   # more CUDA ranks than cards
        sys.stderr.write(f"error: --devices {args.devices}: {exc}\n")
        return 1


def rank_main(group, config: RenderConfig, args) -> int:
    """One rank of ``--devices N`` (``group``: its mesh.RenderGroup)."""
    return render_main(config, args, group.device, group)


def render_main(config: RenderConfig, args, device, group=None) -> int:
    """Load and bake the scene, then render: on ``device``, or as one
    rank of ``group`` (a RenderGroup) on the rank's device."""
    primary = group is None or group.primary
    if group is not None:
        device = group.device
    # The other ranks bake the same scene: their reports would repeat.
    with (contextlib.nullcontext() if primary
          else contextlib.redirect_stderr(io.StringIO())):
        print(f"loading scene: {args.scene_path}", file=sys.stderr)
        try:
            pipeline = load_pipeline(
                args.scene_path, config, device, instanced=args.instanced,
                quirk_mode=args.gltf_quirk_mode,
                animate=args.animation_step != 0 and not args.interactive)
        except ValueError as exc:
            sys.stderr.write(f"error: {exc}\n")
            return 2
    if pipeline.animation is not None:
        refused = animated_refusal(config, args, group)
        if refused:
            if primary:
                sys.stderr.write(f"error: {refused}: the scene has "
                                 f"animations, and each frame takes a pose "
                                 f"of its own (--animation-step 0 renders "
                                 f"it at rest)\n")
            return 2
    if group is not None:
        pipeline = ShardedRenderPipeline(pipeline.scene, config, group,
                                         mode=args.shard_mode)
        if primary:
            print(f"sharding framebuffer across {group.world} devices "
                  f"(mode={args.shard_mode})", file=sys.stderr)
    if primary and (config.mt != "exact" or any((
            config.kernel_primary, config.kernel_secondary,
            config.anyhit_kernel, config.max_leaf))):
        product = (f" mxu_precision={config.mxu_precision}"
                   if config.mt == "mxu" else "")
        print(f"kernel tiers: primary={config.kernel_primary or 'default'} "
              f"secondary={config.kernel_secondary or 'default'} "
              f"anyhit={config.anyhit_kernel or 'default'} mt={config.mt} "
              f"leaf={pipeline.scene.max_leaf_size}{product}",
              file=sys.stderr)
    try:
        if config.enable_validation:
            validate(pipeline, config)
        return run(pipeline, config, args, device, primary, group)
    except ValidationError as exc:
        sys.stderr.write(f"validation failed: {exc}\n")
        return 1


def animated_refusal(config: RenderConfig, args, group) -> str:
    """The flag whose frame loop cannot render an animated scene (the
    branches ``run`` would take), or ""."""
    if group is not None or args.devices > 1:
        return f"--devices {args.devices}"
    if config.progressive and args.batch_frames > 1 and not args.camera_path:
        return f"--batch-frames {args.batch_frames}"
    if (args.pool_frames > 1 and config.num_samples == 1
            and not config.progressive):
        return f"--pool-frames {args.pool_frames}"
    return ""


def run(pipeline, config: RenderConfig, args, device,
        primary: bool = True, group=None) -> int:
    """The viewer under ``--interactive`` (on every rank of ``group``,
    rank 0 presenting), else the frame loop of the module docstring
    (under ``--profile DIR``, traced into DIR), then the PNG; the files
    and logs on the ``primary`` process only."""
    if args.interactive:
        several = group is not None and group.world > 1
        frames = run_viewer(pipeline, Camera(aspect_ratio=config.aspect_ratio),
                            keys=rank_stdin() if several and primary
                            else None,
                            max_frames=args.frames if args.frames > 1 else 0,
                            group=group)
        if primary:
            print(f"viewer closed after {frames} frames", file=sys.stderr)
        return 0
    loop = FrameLoop(pipeline, config, args, device, primary)
    if (config.progressive and args.batch_frames > 1
            and loop.path is None and args.devices <= 1):
        frame_loop = loop.batches
    elif args.pool_frames > 1 and config.num_samples == 1 and \
            args.devices <= 1 and loop.acc is None:
        frame_loop = loop.pooled
    else:
        frame_loop = loop.frames
    t0 = time.perf_counter()
    if args.profile and primary:
        print(f"profiling to {args.profile}", file=sys.stderr)
        with trace(args.profile, device):
            final = frame_loop()
    else:
        final = frame_loop()
    if not primary:
        return 0
    if final is not None:
        present(final, config, args.output)
        spp = f" ({loop.acc.spp} spp)" if frame_loop == loop.batches else ""
        print(f"wrote {args.output}{spp}", file=sys.stderr)
        report(args.frames - loop.start_frame, loop.rays, t0, device)
    loop.stats.log()
    return 0


def rank_stdin():
    """Rank 0's keys: the process's standard input descriptor, which a
    rank started by ``distributed.spawn`` inherits from the CLI's process
    while its ``sys.stdin`` reads nothing; ``sys.stdin`` where there is
    no such descriptor."""
    try:
        return open(0, closefd=False)
    except OSError:
        return sys.stdin


def report(frames: int, rays: int, t0: float, device) -> None:
    """The run's frame time and ray rate on stderr."""
    seconds = time.perf_counter() - t0
    print(f"{frames} frame(s) on {device}: "
          f"{1000.0 * seconds / max(frames, 1):.2f} ms/frame, "
          f"{rays / seconds / 1e6:.3f} Mrays/s", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
