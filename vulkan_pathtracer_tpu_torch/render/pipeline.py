"""Frame pipeline — port of render/pipeline.py.

``RenderPipeline.render(camera, frame)`` returns linear radiance
(H, W, 3) f32 on the scene's device and the number of rays traced.
Primary rays are generated directly in 2D-tile order (32 x 64 pixel
tiles, when the image is larger than one tile) so that neighbouring
rays share a frustum; the tile permutation is undone at the end, or
on the host with ``to_present``.  A single frame is traced in one
dispatch: one card holds a 1080p frame's state with room to spare.

``RenderPipeline.render_batch_sum(camera, frame0, batch)`` returns the
radiance SUM of ``batch`` consecutive frames of a static camera (the
progressive path): at 1 spp the joint wavefront
(``render_frames_joint``: the shared primary, every frame's bounce
rays sorted together, shaded in chunks of ``wavefront.JOINT_CHUNK``
lanes), else one frame after another (``render_frames_batch``).

An animated scene (``RenderPipeline(scene, config, animation)``, a
models/animation.SceneAnimation, which app/main.load_pipeline builds
for a glTF with animations) is posed by ``render(camera, frame,
time=t)`` before the frame's primaries: ``pose_scene`` evaluates the
motion at ``t`` seconds (span ``animate``) and moves the baked scene
(span ``update``): the two-level bake through
``instanced_scene.update_instance_transforms``, the flat bake through
``AnimatedScene.with_transforms``; all on the device, no host read.
Without ``time``, or without an animation, a frame adds nothing.  The
pooled wavefront refuses an animated scene (its frames would each need
a pose of their own).

On a CUDA device, where the shading is ops/shade.py's kernels, a frame
of the two-level bake's default tier (the unsorted pair path, no
roulette, seeding or kernel choice of its own; ``graphs_frames``) is a
``FrameGraph``, static or posed alike: the frame's launches captured
once and replayed, its camera and counter copied from pinned memory.
The host then enqueues a handful of launches and no synchronising call
in place of a few hundred, and a light scene's frame is the card's
time, not the host's.  Every other tier runs eagerly.  A graph holds
the kernels and the scene of its capture, and is captured again when
the scene changes.  A graphed frame's spans are ``frame`` and the
pose's: the spans inside the frame are entered once, at the capture,
and ``utils/profiling.Attribution`` reads them as absent.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.animation import update_records
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.ops import rng, shade
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import table_precision
from vulkan_pathtracer_tpu_torch.ops.vecmath import normalize
from vulkan_pathtracer_tpu_torch.render.wavefront import (
    JOINT_CHUNK,
    check_seed_secondary,
    trace_progressive_batch,
    trace_sample,
    trace_wavefront_pooled,
)
from vulkan_pathtracer_tpu_torch.utils import RenderConfig
from vulkan_pathtracer_tpu_torch.utils.config import Tiers
from vulkan_pathtracer_tpu_torch.utils import profiling
from vulkan_pathtracer_tpu_torch.utils.profiling import count, span

TILE_H = 32
TILE_W = 64
SORT_MIN_TRIANGLES = 16384  # bounce sorting pays off only on large scenes
TRAVERSALS = ("auto", "pallas", "pallas_packet", "pallas8", "bvh", "brute")


def _scalar(x: float, device) -> torch.Tensor:
    """An f32 0-d tensor on ``device``: dividing by it is an exact IEEE
    division on every device (a Python scalar divisor may become a
    reciprocal multiply on CUDA).  Inside a CUDA graph's capture, where
    no copy from host memory may run, the same value filled on the
    device."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def generate_rays(position, horizontal, vertical, forward, width: int,
                  height: int, y_offset: int = 0, rows: int = None):
    """Primary rays for image rows [y_offset, y_offset + rows), row-major
    (ray_gen.rgen:34-48).  Returns (origin, direction), each (N, 3)."""
    dev = position.device
    if rows is None:
        rows = height
    ys = torch.arange(rows, dtype=torch.float32, device=dev) + float(y_offset)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    px = (xs + 0.5) / _scalar(width, dev) * 2.0 - 1.0
    py = (ys + 0.5) / _scalar(height, dev) * 2.0 - 1.0
    dx = px[None, :].expand(rows, width).reshape(-1)
    dy = py.repeat_interleave(width)
    direction = normalize(forward[None, :] + horizontal[None, :] * dx[:, None]
                          - vertical[None, :] * dy[:, None])
    origin = position[None, :].expand(direction.shape).contiguous()
    return origin, direction


def generate_rays_at(position, horizontal, vertical, forward, width: int,
                     height: int, x_idx, y_idx):
    """Primary rays for explicit pixel coordinates (same per-lane
    formula as generate_rays, so tile order is bit-identical to
    row-major order gathered)."""
    dev = position.device
    px = (x_idx.to(torch.float32) + 0.5) / _scalar(width, dev) * 2.0 - 1.0
    py = (y_idx.to(torch.float32) + 0.5) / _scalar(height, dev) * 2.0 - 1.0
    direction = normalize(forward[None, :] + horizontal[None, :] * px[:, None]
                          - vertical[None, :] * py[:, None])
    origin = position[None, :].expand(direction.shape).contiguous()
    return origin, direction


def lane_pixels(width: int, rows: int, y_offset: int, tiles, device):
    """(x, y) int64 pixel coordinates of each lane of image rows
    [y_offset, y_offset + rows): tile order when ``tiles``
    (tile_pixels()) is given, else scanline."""
    if tiles is not None:
        return tiles[0], tiles[1]
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(rows, dtype=torch.int64, device=device) + y_offset
    return xs.repeat(rows), ys.repeat_interleave(width)


@functools.lru_cache(maxsize=8)
def _tile_order(rows: int, width: int):
    """(order, inverse) NumPy permutations: tile-major lane -> scanline
    pixel index, stable within a tile.  Cached: two argsorts of a 1080p
    frame cost a few hundred ms of host time."""
    y, x = np.mgrid[0:rows, 0:width]
    tiles_x = (width + TILE_W - 1) // TILE_W
    key = ((y // TILE_H).astype(np.int64) * tiles_x
           + (x // TILE_W)).reshape(-1)
    order = np.argsort(key, kind="stable").astype(np.int64)
    inv = np.argsort(order).astype(np.int64)
    return order, inv


def tile_inverse(height: int, width: int):
    """Host-side inverse tile permutation, or None when the launch does
    not use tile order."""
    if height > TILE_H and width > TILE_W:
        return _tile_order(height, width)[1]
    return None


def tile_pixels(rows: int, width: int, y_offset: int, device):
    """(x_idx, y_idx, inverse) of the tile order as tensors on device,
    or None when the launch does not use tile order."""
    if not (rows > TILE_H and width > TILE_W):
        return None
    t_order, t_inv = _tile_order(rows, width)
    pix = torch.from_numpy(t_order).to(device)
    return (pix % width, pix // width + y_offset,
            torch.from_numpy(t_inv).to(device))


def camera_tensors(camera: Camera, device):
    """(position, horizontal, vertical, forward) f32 tensors on device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in camera.push_constants())


def primary_rays(position, horizontal, vertical, forward, frame: int,
                 width: int, height: int, y_offset: int = 0,
                 rows: int = None, tiles=None):
    """Primary rays and RNG seeds for image rows [y_offset, y_offset +
    rows), in 2D-tile order when the launch is larger than one tile.
    ``tiles``: tile_pixels() of this launch, when the caller keeps them.
    Returns (origin, direction, seed_x, seed_y, tile_inv), where
    tile_inv (None in scanline order) maps scanline pixel -> lane."""
    dev = position.device
    if rows is None:
        rows = height
    if tiles is None:
        tiles = tile_pixels(rows, width, y_offset, dev)
    t_inv = None
    if tiles is not None:
        x_idx, y_idx, t_inv = tiles
        origin, direction = generate_rays_at(
            position, horizontal, vertical, forward, width, height,
            x_idx, y_idx)
    else:
        origin, direction = generate_rays(
            position, horizontal, vertical, forward, width, height,
            y_offset=y_offset, rows=rows)
    seed_x, seed_y = rng.prng_seed(
        *lane_pixels(width, rows, y_offset, tiles, dev), frame)
    return origin, direction, seed_x, seed_y, t_inv


def render_rows(scene, position, horizontal, vertical, forward, frame: int,
                *, num_samples: int, num_bounces: int, width: int,
                height: int, y_offset: int = 0, rows: int = None,
                sort_secondary: bool = False, present_order: bool = True,
                tiles=None, tiers="auto", russian_roulette: bool = False,
                rr_start_bounce: int = 2, seed_secondary: bool = False):
    """Render image rows [y_offset, y_offset + rows) through ``tiers``
    (a utils.config.Tiers or a ``--traversal`` name), with Russian
    roulette from ``rr_start_bounce`` when ``russian_roulette``, and
    seeded bounces (wavefront.trace_sample) under ``seed_secondary``.
    Returns
    (image (rows, W, 3) f32, rays traced as an int64 0-d tensor).  With
    ``present_order=False`` radiance stays in tile (dispatch) order."""
    dev = position.device
    if rows is None:
        rows = height
    n = rows * width
    with span("primaries"):
        origin, direction, seed_x, seed_y, tile_inv = primary_rays(
            position, horizontal, vertical, forward, frame, width, height,
            y_offset=y_offset, rows=rows, tiles=tiles)

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(num_samples):
        color, seed_x, seed_y, traced = trace_sample(
            scene, origin, direction, seed_x, seed_y,
            num_bounces=num_bounces, sort_secondary=sort_secondary,
            tiers=tiers, russian_roulette=russian_roulette,
            rr_start_bounce=rr_start_bounce, seed_secondary=seed_secondary)
        acc = acc + color
        rays = rays + traced
    with span("finish"):
        if tile_inv is not None and present_order:
            acc = acc[tile_inv]
        image = (acc / _scalar(num_samples, dev)).reshape(rows, width, 3)
    return image, rays


def render_frame(scene, position, horizontal, vertical, forward, frame: int,
                 *, num_samples: int, num_bounces: int, width: int,
                 height: int, sort_secondary: bool = False,
                 present_order: bool = True, tiles=None,
                 tiers="auto", russian_roulette: bool = False,
                 rr_start_bounce: int = 2, seed_secondary: bool = False):
    """One full frame: (H, W, 3) f32 linear radiance + rays traced."""
    return render_rows(
        scene, position, horizontal, vertical, forward, frame,
        num_samples=num_samples, num_bounces=num_bounces, width=width,
        height=height, sort_secondary=sort_secondary,
        present_order=present_order, tiles=tiles, tiers=tiers,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce,
        seed_secondary=seed_secondary)


def render_frames_batch(scene, position, horizontal, vertical, forward,
                        frame0: int, *, batch: int, num_samples: int,
                        num_bounces: int, width: int, height: int,
                        sort_secondary: bool = False, tiles=None,
                        tiers="auto", russian_roulette: bool = False,
                        rr_start_bounce: int = 2,
                        seed_secondary: bool = False):
    """The radiance SUM of frames frame0 .. frame0 + batch - 1 (JAX
    pipeline.py:359-416, a ``lax.scan`` there), rendered one after
    another and summed on the device in frame order.  Returns
    (sum (H, W, 3) f32 in scanline order, rays traced, int64 0-d)."""
    acc = torch.zeros((height, width, 3), dtype=torch.float32,
                      device=position.device)
    rays = torch.zeros((), dtype=torch.int64, device=position.device)
    for k in range(batch):
        image, traced = render_frame(
            scene, position, horizontal, vertical, forward, frame0 + k,
            num_samples=num_samples, num_bounces=num_bounces, width=width,
            height=height, sort_secondary=sort_secondary, tiles=tiles,
            tiers=tiers, russian_roulette=russian_roulette,
            rr_start_bounce=rr_start_bounce, seed_secondary=seed_secondary)
        acc = acc + image
        rays = rays + traced
    return acc, rays


def render_frames_joint(scene, position, horizontal, vertical, forward,
                        frame0: int, *, batch: int, num_bounces: int,
                        width: int, height: int, sort_secondary: bool = True,
                        tiles=None, tiers="auto",
                        russian_roulette: bool = False,
                        rr_start_bounce: int = 2, chunk: int = JOINT_CHUNK):
    """The radiance SUM of frames frame0 .. frame0 + batch - 1 at 1 spp
    as one joint wavefront (JAX pipeline.py:418-488;
    wavefront.trace_progressive_batch): primaries in tile order, each
    frame's RNG seeded from its frame counter.  Returns (sum (H, W, 3)
    f32 in scanline order, rays physically traced, int64 0-d)."""
    dev = position.device
    with span("primaries"):
        if tiles is None:
            tiles = tile_pixels(height, width, 0, dev)
        origin, direction, _, _, tile_inv = primary_rays(
            position, horizontal, vertical, forward, frame0, width, height,
            tiles=tiles)
        px, py = lane_pixels(width, height, 0, tiles, dev)
        frames = frame0 + torch.arange(batch, dtype=torch.int64, device=dev)
        seed_x, seed_y = rng.prng_seed(px[None, :], py[None, :],
                                       frames[:, None])
    color_sum, rays = trace_progressive_batch(
        scene, origin, direction, seed_x, seed_y, batch=batch,
        num_bounces=num_bounces, tiers=tiers,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce,
        sort_secondary=sort_secondary, chunk=chunk)
    with span("finish"):
        if tile_inv is not None:
            color_sum = color_sum[tile_inv]
        return color_sum.reshape(height, width, 3), rays


def render_frames_pooled(scene, positions, horizontals, verticals, forwards,
                         frames, *, num_bounces: int, width: int,
                         height: int, sort_secondary: bool = True,
                         tiles=None, tiers="auto",
                         russian_roulette: bool = False,
                         rr_start_bounce: int = 2, chunk: int = JOINT_CHUNK):
    """F frames of F cameras at 1 spp as one pooled wavefront (JAX
    pipeline.py:491-560; wavefront.trace_wavefront_pooled).
    ``positions`` .. ``forwards``: (F, 3) f32 camera vectors on the
    device; ``frames``: F frame counters.  Each frame's primaries are
    generated in tile order and seeded from its own frame counter, and
    the frames' lanes are concatenated frame by frame.  Returns (images
    (F, H, W, 3) f32 in scanline order, rays traced, int64 0-d)."""
    dev = positions.device
    with span("primaries"):
        if tiles is None:
            tiles = tile_pixels(height, width, 0, dev)
        prims = [primary_rays(positions[k], horizontals[k], verticals[k],
                              forwards[k], int(frame), width, height,
                              tiles=tiles)
                 for k, frame in enumerate(frames)]
        tile_inv = prims[0][4]
        origin, direction, seed_x, seed_y = (
            torch.cat([p[i] for p in prims]) for i in range(4))
        del prims
    color, traced = trace_wavefront_pooled(
        scene, origin, direction, seed_x, seed_y, num_bounces=num_bounces,
        tiers=tiers, russian_roulette=russian_roulette,
        rr_start_bounce=rr_start_bounce, sort_secondary=sort_secondary,
        chunk=chunk)
    with span("finish"):
        color = color.view(len(frames), height * width, 3)
        if tile_inv is not None:
            color = color[:, tile_inv]
        return color.reshape(len(frames), height, width, 3), traced


def pose_scene(animation, time: float):
    """The scene of ``animation`` (a SceneAnimation) posed at ``time``
    seconds: the motion's transforms (span ``animate``), then the baked
    scene moved to them (span ``update``, with the counters
    ``instances_moved`` and ``update_records``)."""
    with span("animate"):
        transforms = animation.transforms(time)
    with span("update"):
        scene = animation.update(transforms)
        count("instances_moved", animation.moved)
        count("update_records", update_records(scene))
    return scene


class FrameGraph:
    """One frame of ``scene`` as a CUDA graph: ``run(vectors, frame)``
    (the camera's four (3,) f32 device vectors and the frame counter, a
    0-d int64 device tensor) captured once, after one eager run on a
    side stream (kernel builds and loads, cuBLAS's workspace).  Its
    inputs come from a pinned host buffer (the camera's 12 floats and
    the counter, in float64, which holds both exactly), copied without a
    wait; before the buffer is written again, the copy that read it has
    run (an event).  Returns copies of the frame's outputs, which the next
    replay overwrites; the replay is reported to the tracer as a launch
    of the frame's pixels, which places a traced window's spans on the
    device trace's clock."""

    def __init__(self, run, scene):
        self.run, self.scene, self.device = run, scene, scene.device
        self.host = torch.zeros(13, dtype=torch.float64).pin_memory()
        self.staged = torch.zeros(13, dtype=torch.float64,
                                  device=self.device)
        self.copied = torch.cuda.Event()
        self.graph = None

    def _inputs(self):
        return (tuple(self.staged[:12].float().view(4, 3).unbind(0)),
                self.staged[12].to(torch.int64))

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.run(*self._inputs())
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.run(*self._inputs())

    def __call__(self, camera: Camera, frame: int):
        if not self.copied.query():
            self.copied.synchronize()
        host = self.host.numpy()
        host[:12] = np.concatenate(camera.push_constants())
        host[12] = int(frame) & 0xFFFFFFFF   # the bits prng_seed reads
        self.staged.copy_(self.host, non_blocking=True)
        self.copied.record()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        profiling.launched(profiling.GRAPH_KEY, self.out[0].reshape(-1, 3))
        return tuple(t.clone() for t in self.out)


class RenderPipeline:
    """Holds the scene + config and renders frames on the scene's device;
    ``animation`` (a SceneAnimation) poses it (the module docstring)."""

    def __init__(self, scene, config: RenderConfig, animation=None):
        traversal = config.traversal
        if traversal not in TRAVERSALS:
            raise ValueError(f"unknown traversal {traversal!r}")
        if not scene.has_bvh and traversal not in ("auto", "brute"):
            raise ValueError(f"traversal {traversal!r} needs a BVH; the "
                             f"scene was baked without one")
        if (traversal == "pallas8" and not scene.instanced
                and scene.wide_nodes is None):
            raise ValueError("traversal 'pallas8' needs the wide tiles: "
                             "bake with build_device_scene(..., wide=True)")
        if config.seed_secondary:
            check_seed_secondary(scene)
        tiers = Tiers.of(config)
        tiers.validate()
        if (tiers.mt == "mxu" and scene.tri_coefs is not None
                and table_precision(scene.tri_coefs) != tiers.mxu_precision):
            raise ValueError(
                f"mxu_precision {tiers.mxu_precision!r}, but the scene's "
                f"coefficient table is {scene.tri_coefs.dtype}: bake it with "
                f"the same mxu_precision")
        self.scene = scene
        self.config = config
        self.animation = animation
        self.tiers = tiers
        self.width = config.render_width
        self.height = config.render_height
        self._sort_secondary = (config.sort_secondary and
                                scene.num_triangles >= SORT_MIN_TRIANGLES)
        self._rr = dict(russian_roulette=config.russian_roulette,
                        rr_start_bounce=config.rr_start_bounce)
        # The tile permutation of this launch, kept on the device: its
        # upload would cost milliseconds per 1080p frame.
        self._tiles = tile_pixels(self.height, self.width, 0, scene.device)
        # The tier whose launches read nothing back (graphs_frames).
        self._graph_tier = (
            scene.instanced and tiers == Tiers(traversal=tiers.traversal)
            and tiers.traversal in ("auto", "pallas")
            and not self._sort_secondary
            and not config.russian_roulette
            and not config.seed_secondary)
        self._graphs = {}    # present_order -> FrameGraph

    @property
    def graphs_frames(self) -> bool:
        """Whether a frame replays a FrameGraph (the module docstring):
        the graph's tier, its shading the kernels of ops/shade.py (on
        the card; the plain chain copies constants from the host)."""
        return self._graph_tier and shade.fused(self.scene.root_lo)

    def _frame(self, vectors, frame, present_order: bool):
        """render_frame of the current scene."""
        return render_frame(
            self.scene, *vectors, frame,
            num_samples=self.config.num_samples,
            num_bounces=self.config.num_bounces,
            width=self.width, height=self.height,
            sort_secondary=self._sort_secondary,
            present_order=present_order, tiles=self._tiles,
            tiers=self.tiers, seed_secondary=self.config.seed_secondary,
            **self._rr)

    def pose(self, time: float) -> None:
        """Pose an animated scene at ``time`` seconds (``pose_scene``);
        nothing for a static one."""
        if self.animation is not None:
            self.scene = pose_scene(self.animation, time)

    def render(self, camera: Camera, frame: int,
               present_order: bool = True,
               time: float = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (radiance (H, W, 3) on the device, rays traced).  With
        ``present_order=False`` radiance is in tile order; convert on the
        host with ``to_present``.  ``time``: the scene posed at ``time``
        seconds first (``pose``).  Traced as the root span ``frame``."""
        with span("frame"):
            if time is not None:
                self.pose(time)
            if self.graphs_frames:
                graph = self._graphs.get(present_order)
                if graph is None or graph.scene is not self.scene:
                    graph = self._graphs[present_order] = FrameGraph(
                        lambda v, f: self._frame(v, f, present_order),
                        self.scene)
                return graph(camera, frame)
            with span("primaries"):
                vectors = camera_tensors(camera, self.scene.device)
            return self._frame(vectors, int(frame), present_order)

    def render_batch_sum(self, camera: Camera, frame0: int, batch: int,
                         joint: bool = None):
        """The radiance SUM (H, W, 3, scanline order, on the device) of
        ``batch`` consecutive frames from ``frame0``, and the rays
        traced.  At 1 spp the joint wavefront runs when ``batch`` > 1,
        or when ``joint`` is True and ``batch`` >= 1; otherwise (more
        spp, or ``joint=False``) the frames run one after another (JAX
        pipeline.py:628-673).  Traced as the root span ``batch``."""
        with span("batch"):
            with span("primaries"):
                position, horizontal, vertical, forward = camera_tensors(
                    camera, self.scene.device)
            use_joint = (self.config.num_samples == 1
                         and (batch > 1 if joint is None
                              else (joint and batch >= 1)))
            kw = dict(num_bounces=self.config.num_bounces, width=self.width,
                      height=self.height, sort_secondary=self._sort_secondary,
                      tiles=self._tiles, tiers=self.tiers, **self._rr)
            if use_joint:
                return render_frames_joint(
                    self.scene, position, horizontal, vertical, forward,
                    int(frame0), batch=batch, **kw)
            return render_frames_batch(
                self.scene, position, horizontal, vertical, forward,
                int(frame0), batch=batch,
                num_samples=self.config.num_samples,
                seed_secondary=self.config.seed_secondary, **kw)

    def render_pooled(self, cameras, frames):
        """``len(cameras)`` frames, one camera and frame counter each, as
        one pooled wavefront at 1 spp (JAX pipeline.py:675-700).  Returns
        (images (F, H, W, 3) on the device, scanline order; rays traced);
        each image is ``render(cameras[i], frames[i])``'s.  Traced as the
        root span ``group``."""
        if self.config.num_samples != 1:
            raise ValueError(
                "render_pooled requires 1 spp (cross-sample pooling would "
                "break the per-pixel RNG stream's draw order)")
        if self.animation is not None:
            raise ValueError(
                "render_pooled: the scene has animations (glTF node "
                "channels), and a pooled group shares one pose")
        with span("group"):
            with span("primaries"):
                vectors = [camera_tensors(cam, self.scene.device)
                           for cam in cameras]
                positions, horizontals, verticals, forwards = (
                    torch.stack([v[i] for v in vectors]) for i in range(4))
            return render_frames_pooled(
                self.scene, positions, horizontals, verticals, forwards,
                [int(f) for f in frames], num_bounces=self.config.num_bounces,
                width=self.width, height=self.height,
                sort_secondary=self._sort_secondary, tiles=self._tiles,
                tiers=self.tiers, **self._rr)

    def resize(self, width: int, height: int) -> "RenderPipeline":
        """A pipeline at a new resolution (JAX pipeline.py:703-718, the
        RaytracingPass.resize analog): like the reference, the new
        render target takes the FULL new extent and drops the divider."""
        return RenderPipeline(self.scene, dataclasses.replace(
            self.config, resolution_x=width, resolution_y=height,
            render_resolution_divider=1), self.animation)

    def to_present(self, image: np.ndarray) -> np.ndarray:
        """Host-side tile-order -> scanline conversion (identity when the
        launch did not use tile order)."""
        t_inv = tile_inverse(self.height, self.width)
        if t_inv is None:
            return image
        h, w = self.height, self.width
        return np.asarray(image).reshape(h * w, 3)[t_inv].reshape(h, w, 3)

    def render_numpy(self, camera: Camera, frame: int):
        image, rays = self.render(camera, frame)
        return image.cpu().numpy(), float(rays)
