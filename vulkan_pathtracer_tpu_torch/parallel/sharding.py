"""Multi-device frames: framebuffer tiles and sample shards (port of
``parallel/sharding.py``).

Every rank holds the whole scene (``replicate_scene``) and renders its
share of the frame through the single-device pipeline
(render/pipeline.render_rows):

- ``mode="tiles"``: rank r renders image rows [r H / world, (r + 1) H /
  world), in tile order within its block; the ranks' rows are gathered,
  so the frame equals the single-device frame bit for bit (each pixel
  keeps its RNG stream, and per-lane results do not depend on their
  neighbours);
- ``mode="spp"``: every rank renders the whole frame with frame seed
  ``frame * world + r`` (the frame counter only seeds the RNG), and the
  image is the mean over the ranks, summed in rank order and divided by
  ``world`` (the JAX package's ``pmean``; a fixed order, so the last bit
  does not depend on how a collective reduces).

Rays are summed over the ranks.  ``render_tile`` and ``render_spp_shard``
are one rank's work with its rank and world given explicitly, and no
collectives.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

from vulkan_pathtracer_tpu_torch.parallel.mesh import RenderGroup
from vulkan_pathtracer_tpu_torch.render.pipeline import (
    RenderPipeline,
    _scalar,
    camera_tensors,
    render_frame,
    render_rows,
    tile_pixels,
)

MODES = ("tiles", "spp")


def _scene_tensors(obj, prefix: str = ""):
    """(name, tensor) of every tensor of a scene, its nested tables
    (TreeMaps, InstanceMaps) included, in field order."""
    for field in dataclasses.fields(obj):
        value = getattr(obj, field.name)
        if isinstance(value, torch.Tensor):
            yield prefix + field.name, value
        elif dataclasses.is_dataclass(value):
            yield from _scene_tensors(value, prefix + field.name + ".")


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 tensor."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def replicate_scene(scene, group: RenderGroup):
    """Check that every rank holds rank 0's scene, byte for byte, and
    return it.  Each rank bakes its own (the bake is deterministic);
    the ranks compare the tensors' names, dtypes and shapes, then their
    raw bytes against rank 0's broadcast.  Bytes, not values: several
    tables carry int32 payloads in f32 lanes, and a NaN pattern is not
    equal to itself as a value.  Every rank raises when any differs."""
    if group.group is None:
        return scene
    tensors = list(_scene_tensors(scene))
    layout = repr([(n, str(t.dtype), tuple(t.shape)) for n, t in tensors])
    mine = torch.tensor([zlib.crc32(layout.encode()), len(tensors)],
                        dtype=torch.int64, device=group.device)
    if any(not torch.equal(x, mine) for x in group.all_gather(mine)):
        raise RuntimeError(f"rank {group.rank}: the ranks baked scenes of "
                           f"different layouts")
    local = torch.cat([_raw(t) for _, t in tensors])
    root = group.broadcast(local)
    same = torch.tensor([int(torch.equal(root, local))], dtype=torch.int64,
                        device=group.device)
    if int(torch.stack(group.all_gather(same)).min()) == 0:
        differ = []
        start = 0
        for name, t in tensors:
            size = _raw(t).numel()
            if not torch.equal(root[start:start + size],
                               local[start:start + size]):
                differ.append(name)
            start += size
        raise RuntimeError(f"rank {group.rank}: the ranks' scenes differ "
                           f"from rank 0's (here: {differ or 'none'})")
    return scene


def tile_rows(height: int, world: int) -> int:
    """Image rows per rank under ``mode="tiles"``."""
    if height % world:
        raise ValueError(f"height {height} must be divisible by the "
                         f"number of ranks {world}")
    return height // world


def render_tile(scene, position, horizontal, vertical, forward, frame: int,
                *, rank: int, world: int, num_samples: int,
                num_bounces: int, width: int, height: int, tiers="auto",
                russian_roulette: bool = False, rr_start_bounce: int = 2,
                sort_secondary: bool = False, tiles=None):
    """Rank ``rank`` of ``world``'s rows of the frame: (image (H / world,
    W, 3) in scanline order, rays traced).  ``tiles``: tile_pixels() of
    the block, when the caller keeps them."""
    rows = tile_rows(height, world)
    return render_rows(
        scene, position, horizontal, vertical, forward, frame,
        num_samples=num_samples, num_bounces=num_bounces, width=width,
        height=height, y_offset=rank * rows, rows=rows,
        sort_secondary=sort_secondary, tiles=tiles, tiers=tiers,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce)


def render_spp_shard(scene, position, horizontal, vertical, forward,
                     frame: int, *, rank: int, world: int, num_samples: int,
                     num_bounces: int, width: int, height: int,
                     tiers="auto", russian_roulette: bool = False,
                     rr_start_bounce: int = 2, sort_secondary: bool = False,
                     tiles=None):
    """Rank ``rank`` of ``world``'s samples: the whole frame at frame
    seed ``frame * world + rank`` (image (H, W, 3), rays traced)."""
    return render_frame(
        scene, position, horizontal, vertical, forward, frame * world + rank,
        num_samples=num_samples, num_bounces=num_bounces, width=width,
        height=height, sort_secondary=sort_secondary, tiles=tiles,
        tiers=tiers, russian_roulette=russian_roulette,
        rr_start_bounce=rr_start_bounce)


def spp_mean(images) -> torch.Tensor:
    """The ranks' images summed in rank order, divided by their count."""
    acc = images[0]
    for image in images[1:]:
        acc = acc + image
    return acc / _scalar(len(images), acc.device)


def make_sharded_render(group: RenderGroup, scene, *, num_samples: int,
                        num_bounces: int, width: int, height: int,
                        tiers="auto", russian_roulette: bool = False,
                        rr_start_bounce: int = 2, mode: str = "tiles",
                        sort_secondary: bool = False):
    """Returns fn(scene, position, horizontal, vertical, forward, frame)
    -> (image (H, W, 3) in scanline order on every rank, rays traced
    summed over the ranks, int64 0-d).  ``scene`` is an argument, so a
    step may pass a refitted scene of the same layout."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (tiles | spp)")
    rank, world = group.rank, group.world
    kw = dict(rank=rank, world=world, num_samples=num_samples,
              num_bounces=num_bounces, width=width, height=height,
              tiers=tiers, russian_roulette=russian_roulette,
              rr_start_bounce=rr_start_bounce, sort_secondary=sort_secondary)
    if mode == "tiles":
        rows = tile_rows(height, world)
        kw["tiles"] = tile_pixels(rows, width, rank * rows, scene.device)

        def fn(scene, position, horizontal, vertical, forward, frame):
            image, rays = render_tile(scene, position, horizontal, vertical,
                                      forward, int(frame), **kw)
            return torch.cat(group.all_gather(image)), group.sum(rays)
    else:
        kw["tiles"] = tile_pixels(height, width, 0, scene.device)

        def fn(scene, position, horizontal, vertical, forward, frame):
            image, rays = render_spp_shard(scene, position, horizontal,
                                           vertical, forward, int(frame), **kw)
            return spp_mean(group.all_gather(image)), group.sum(rays)
    return fn


class ShardedRenderPipeline:
    """RenderPipeline's ``render`` over the ranks of a RenderGroup (the
    ``--devices N`` path of the CLI): the config's tiers (every
    ``--traversal`` and kernel tier, instanced scenes too) and sort
    policy, the scene checked replicated.  ``seed_secondary`` is not
    passed on: JAX's sharded renders call ``render_rows`` without it
    (the JAX package's parallel/sharding.py:54, :79); RenderPipeline's
    checks still refuse it on a two-level scene."""

    def __init__(self, scene, config, group: RenderGroup,
                 mode: str = "tiles"):
        local = RenderPipeline(scene, config)   # validates the config
        self.scene = replicate_scene(scene, group)
        self.config = config
        self.width = local.width
        self.height = local.height
        self._fn = make_sharded_render(
            group, scene, num_samples=config.num_samples,
            num_bounces=config.num_bounces, width=self.width,
            height=self.height, tiers=local.tiers,
            russian_roulette=config.russian_roulette,
            rr_start_bounce=config.rr_start_bounce, mode=mode,
            sort_secondary=local._sort_secondary)

    def render(self, camera, frame: int, present_order: bool = True):
        """(radiance (H, W, 3) on the rank's device, rays traced over the
        ranks).  The gathered image is always in scanline order, so
        ``present_order`` changes nothing and ``to_present`` is the
        identity."""
        return self._fn(self.scene, *camera_tensors(camera, self.scene.device),
                        int(frame))

    def to_present(self, image):
        return image
