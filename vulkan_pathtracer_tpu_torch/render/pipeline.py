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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.ops import rng
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
from vulkan_pathtracer_tpu_torch.utils.profiling import span

TILE_H = 32
TILE_W = 64
SORT_MIN_TRIANGLES = 16384  # bounce sorting pays off only on large scenes
TRAVERSALS = ("auto", "pallas", "pallas_packet", "pallas8", "bvh", "brute")


def _scalar(x: float, device) -> torch.Tensor:
    """An f32 0-d tensor on ``device``: dividing by it is an exact IEEE
    division on every device (a Python scalar divisor may become a
    reciprocal multiply on CUDA)."""
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


class RenderPipeline:
    """Holds the scene + config and renders frames on the scene's device."""

    def __init__(self, scene, config: RenderConfig):
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

    def render(self, camera: Camera, frame: int,
               present_order: bool = True) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Returns (radiance (H, W, 3) on the device, rays traced).  With
        ``present_order=False`` radiance is in tile order; convert on the
        host with ``to_present``.  Traced as the root span ``frame``."""
        with span("frame"):
            with span("primaries"):
                position, horizontal, vertical, forward = camera_tensors(
                    camera, self.scene.device)
            return render_frame(
                self.scene, position, horizontal, vertical, forward,
                int(frame), num_samples=self.config.num_samples,
                num_bounces=self.config.num_bounces,
                width=self.width, height=self.height,
                sort_secondary=self._sort_secondary,
                present_order=present_order, tiles=self._tiles,
                tiers=self.tiers, seed_secondary=self.config.seed_secondary,
                **self._rr)

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
            render_resolution_divider=1))

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
