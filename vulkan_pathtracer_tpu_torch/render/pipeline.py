"""Frame pipeline — port of render/pipeline.py (single-frame path).

``RenderPipeline.render(camera, frame)`` returns linear radiance
(H, W, 3) f32 on the scene's device and the number of rays traced.
Primary rays are generated directly in 2D-tile order (32 x 64 pixel
tiles, when the image is larger than one tile) so that neighbouring
rays share a frustum; the tile permutation is undone at the end, or
on the host with ``to_present``.

The whole frame is traced in one dispatch.  The JAX package splits
launches above 2^19 rays into ``lax.map`` chunks to bound TPU memory
and to avoid a TPU worker fault; per-ray results do not depend on it,
and one card holds a 1080p frame's state with room to spare.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.ops import rng
from vulkan_pathtracer_tpu_torch.ops.vecmath import normalize
from vulkan_pathtracer_tpu_torch.render.wavefront import trace_sample
from vulkan_pathtracer_tpu_torch.utils import RenderConfig
from vulkan_pathtracer_tpu_torch.utils.config import Tiers

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


def _pixel_seeds(width: int, height: int, frame, y_offset: int = 0,
                 rows: int = None, device="cpu"):
    if rows is None:
        rows = height
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(rows, dtype=torch.int64, device=device) + y_offset
    px = xs[None, :].expand(rows, width).reshape(-1)
    py = ys.repeat_interleave(width)
    return rng.prng_seed(px, py, frame)


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
    if tiles is not None:
        x_idx, y_idx, t_inv = tiles
        origin, direction = generate_rays_at(
            position, horizontal, vertical, forward, width, height,
            x_idx, y_idx)
        seed_x, seed_y = rng.prng_seed(x_idx, y_idx, frame)
        return origin, direction, seed_x, seed_y, t_inv
    origin, direction = generate_rays(
        position, horizontal, vertical, forward, width, height,
        y_offset=y_offset, rows=rows)
    seed_x, seed_y = _pixel_seeds(width, height, frame, y_offset=y_offset,
                                  rows=rows, device=dev)
    return origin, direction, seed_x, seed_y, None


def render_rows(scene, position, horizontal, vertical, forward, frame: int,
                *, num_samples: int, num_bounces: int, width: int,
                height: int, y_offset: int = 0, rows: int = None,
                sort_secondary: bool = False, present_order: bool = True,
                tiles=None, tiers="auto"):
    """Render image rows [y_offset, y_offset + rows) through ``tiers``
    (a utils.config.Tiers or a ``--traversal`` name).  Returns
    (image (rows, W, 3) f32, rays traced as an int64 0-d tensor).  With
    ``present_order=False`` radiance stays in tile (dispatch) order."""
    dev = position.device
    if rows is None:
        rows = height
    n = rows * width
    origin, direction, seed_x, seed_y, tile_inv = primary_rays(
        position, horizontal, vertical, forward, frame, width, height,
        y_offset=y_offset, rows=rows, tiles=tiles)

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(num_samples):
        color, seed_x, seed_y, traced = trace_sample(
            scene, origin, direction, seed_x, seed_y,
            num_bounces=num_bounces, sort_secondary=sort_secondary,
            tiers=tiers)
        acc = acc + color
        rays = rays + traced
    if tile_inv is not None and present_order:
        acc = acc[tile_inv]
    image = (acc / _scalar(num_samples, dev)).reshape(rows, width, 3)
    return image, rays


def render_frame(scene, position, horizontal, vertical, forward, frame: int,
                 *, num_samples: int, num_bounces: int, width: int,
                 height: int, sort_secondary: bool = False,
                 present_order: bool = True, tiles=None,
                 tiers="auto"):
    """One full frame: (H, W, 3) f32 linear radiance + rays traced."""
    return render_rows(
        scene, position, horizontal, vertical, forward, frame,
        num_samples=num_samples, num_bounces=num_bounces, width=width,
        height=height, sort_secondary=sort_secondary,
        present_order=present_order, tiles=tiles, tiers=tiers)


class RenderPipeline:
    """Holds the scene + config and renders frames on the scene's device."""

    def __init__(self, scene, config: RenderConfig):
        unported = {
            "russian_roulette": config.russian_roulette,
            "seed_secondary": config.seed_secondary,
            "progressive": config.progressive,
            "enable_validation": config.enable_validation,
        }
        names = [k for k, v in unported.items() if v]
        if names:
            raise NotImplementedError(
                f"{', '.join(names)}: not yet ported in "
                f"vulkan_pathtracer_tpu_torch")
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
        tiers = Tiers.of(config)
        tiers.validate()
        self.scene = scene
        self.config = config
        self.tiers = tiers
        self.width = config.render_width
        self.height = config.render_height
        self._sort_secondary = (config.sort_secondary and
                                scene.num_triangles >= SORT_MIN_TRIANGLES)
        # The tile permutation of this launch, kept on the device: its
        # upload would cost milliseconds per 1080p frame.
        self._tiles = tile_pixels(self.height, self.width, 0, scene.device)

    def render(self, camera: Camera, frame: int,
               present_order: bool = True) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Returns (radiance (H, W, 3) on the device, rays traced).  With
        ``present_order=False`` radiance is in tile order; convert on the
        host with ``to_present``."""
        position, horizontal, vertical, forward = camera_tensors(
            camera, self.scene.device)
        return render_frame(
            self.scene, position, horizontal, vertical, forward, int(frame),
            num_samples=self.config.num_samples,
            num_bounces=self.config.num_bounces,
            width=self.width, height=self.height,
            sort_secondary=self._sort_secondary,
            present_order=present_order, tiles=self._tiles,
            tiers=self.tiers)

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
