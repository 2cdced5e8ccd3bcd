"""The rank side of tests/test_torch_multidevice.py.

Each function runs in every rank of a gloo group on the CPU (started by
the port's ``parallel.distributed.spawn``, or by ``torch.multiprocessing``
for the group formed with explicit arguments) and returns NumPy arrays
for the parent.  This module imports no JAX: the ranks are fresh
processes that import only it and the port.
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.animation import build_animated_scene
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.parallel import distributed
from vulkan_pathtracer_tpu_torch.parallel.mesh import make_render_group
from vulkan_pathtracer_tpu_torch.parallel.rebalance import (
    _balanced_exchange,
    make_pooled_sharded_render,
)
from vulkan_pathtracer_tpu_torch.parallel.sharding import (
    ShardedRenderPipeline,
    make_sharded_render,
    replicate_scene,
)
from vulkan_pathtracer_tpu_torch.render.pipeline import camera_tensors
from vulkan_pathtracer_tpu_torch.utils import RenderConfig
from vulkan_pathtracer_tpu_torch.utils.config import Tiers

# tests/test_multichip.py: the box seen from (0, 0, -3), 2 bounces.
BOX_CAMERA = (0.0, 0.0, -3.0)
# The tier cases of test_multichip.py:70-165 (traversal "pallas").
TIERS = {"pallas": {},
         "frontier": {"kernel_primary": "frontier",
                      "kernel_secondary": "frontier"},
         "mxu": {"mt": "mxu"}}
BOX_SIZE, TIER_SIZE = 32, 16
COLUMNS_CAMERA = (0.0, 2.0, -8.0)
COLUMNS_W, COLUMNS_H = 16, 32
POOLED_BOUNCES = 3
EXCHANGE_M_LOCAL = 64
ANIM_W, ANIM_H, ANIM_FRAMES = 16, 32, 3
# The multi-rank viewer: the box at VIEWER_SIZE square, and its cases
# (name -> shard mode, rank 0's scripted keys, max_frames): look keys
# then quit, keys then EOF, and the frame limit.
VIEWER_SIZE = 16
VIEWER_CASES = {"tiles": ("tiles", "jlikq", 0), "spp": ("spp", "jlikq", 0),
                "eof": ("tiles", "jl", 0), "max_frames": ("spp", "jjjjjj", 3)}


def viewer_config():
    return RenderConfig(num_samples=1, num_bounces=2,
                        resolution_x=VIEWER_SIZE, resolution_y=VIEWER_SIZE)


def viewer_ranks(group, paths):
    """Every VIEWER_CASES case of the viewer on ``ShardedRenderPipeline``
    (every rank renders each frame, rank 0 reads the keys and presents):
    name -> (frames, the text the rank wrote)."""
    torch.set_num_threads(1)
    scene = replicate_scene(box_scene(paths["box"]), group)
    out = {}
    for name, (mode, keys, max_frames) in VIEWER_CASES.items():
        pipe = ShardedRenderPipeline(scene, viewer_config(), group, mode)
        text = io.StringIO()
        frames = run_viewer(pipe, box_camera(), out=text,
                            keys=io.StringIO(keys) if group.primary else None,
                            max_frames=max_frames, group=group)
        out[name] = (frames, text.getvalue())
    return out


def tier_of(name):
    return Tiers(traversal="pallas", **TIERS[name])


def box_camera(aspect=1.0):
    return Camera(aspect_ratio=aspect,
                  position=np.asarray(BOX_CAMERA, np.float32))


def columns_camera():
    return Camera(aspect_ratio=COLUMNS_W / COLUMNS_H,
                  position=np.asarray(COLUMNS_CAMERA, np.float32))


def box_scene(path, mt="exact"):
    return build_device_scene(gltf.load(path), max_leaf_size=4,
                              device="cpu", mt=mt)


def columns_scene(path):
    return build_instanced_scene(gltf.load(path), max_leaf_size=8,
                                 device="cpu")


def _frame(group, scene, camera, size, mode="tiles", tiers="bvh",
           width=None):
    fn = make_sharded_render(group, scene, num_samples=1, num_bounces=2,
                             width=width or size, height=size, tiers=tiers,
                             mode=mode)
    image, rays = fn(scene, *camera_tensors(camera, "cpu"), 0)
    return image.numpy(), int(rays)


def exchange_counts(group, alive_global):
    """Each rank's alive lanes after one ``_balanced_exchange`` of a
    state whose alive flags are ``alive_global`` (rank r holds rows
    [r m, (r + 1) m)), keyed by global row, dead lanes last."""
    m = alive_global.shape[0] // group.world
    rows = slice(group.rank * m, (group.rank + 1) * m)
    alive = torch.from_numpy(alive_global[rows])
    lane = torch.arange(group.rank * m, (group.rank + 1) * m)
    key = torch.where(alive, lane, torch.full_like(lane, 0xFFFFFFFF))
    state = [torch.zeros((m, 3)), torch.zeros((m, 3)), torch.ones((m, 3)),
             torch.zeros((m, 3)), lane.clone(), lane.clone(), alive, lane]
    out = _balanced_exchange(state, key, group)
    return int(out[6].sum())


def four_ranks(group, paths, pooled):
    """Every 4-rank case; rank 0's dict holds the images, every rank's
    its exchange counts."""
    torch.set_num_threads(1)
    out = {}
    box = replicate_scene(box_scene(paths["box"]), group)
    for mode in ("tiles", "spp"):
        out[mode] = _frame(group, box, box_camera(), BOX_SIZE, mode)
    for name, tiers in TIERS.items():
        scene = box if name != "mxu" else replicate_scene(
            box_scene(paths["box"], "mxu"), group)
        out["tier_" + name] = _frame(group, scene, box_camera(), TIER_SIZE,
                                     tiers=tier_of(name))
    columns = replicate_scene(columns_scene(paths["columns"]), group)
    out["columns"] = _frame(group, columns, columns_camera(), COLUMNS_H,
                            width=COLUMNS_W)
    cornell = replicate_scene(build_device_scene(
        gltf.load(paths["cornell"]), max_leaf_size=4, device="cpu"), group)
    rays = [torch.from_numpy(a) for a in pooled]
    for rebalance in (True, False):
        fn = make_pooled_sharded_render(
            group, cornell, num_bounces=POOLED_BOUNCES, tiers="bvh",
            sort_secondary=True, rebalance=rebalance)
        color, traced = fn(cornell, *rays)
        out[f"pooled_{rebalance}"] = (color.numpy(), int(traced))
    m = group.world * EXCHANGE_M_LOCAL
    full = np.zeros(m, bool)
    full[:2 * EXCHANGE_M_LOCAL] = True     # two ranks' shards alive
    half = (np.arange(m) % EXCHANGE_M_LOCAL) < EXCHANGE_M_LOCAL // 2
    out["exchange"] = (exchange_counts(group, full),
                       exchange_counts(group, half))
    out["viewer"] = viewer_ranks(group, paths)
    if not group.primary:
        return {"exchange": out["exchange"], "viewer": out["viewer"]}
    return out


def animated_transforms(t0, frame):
    """test_animated_multichip.py's motion: instances drift upward."""
    t = t0.clone()
    t[:, 1, 3] += 0.3 * frame
    return t


def animated_camera(frame):
    cam = Camera(aspect_ratio=ANIM_W / ANIM_H)
    orbit_path(radius=10.0, height=4.0, duration=2.0).apply(cam, frame * 0.5)
    return cam


def build_animated(path):
    scene = gltf.load(path)
    anim = build_animated_scene(scene, device="cpu")
    return anim, anim.initial_transforms(scene)


def explicit_group(rank, address, world, paths, out_dir):
    """A rank of a group formed by ``distributed.initialize`` with
    explicit arguments: the group's facts, then the animated step
    (``with_transforms``, then sharded tiles) over ANIM_FRAMES frames."""
    torch.set_num_threads(1)
    formed = distributed.initialize(address, world, rank, device="cpu")
    group = make_render_group("cpu")
    total = group.sum(torch.tensor(rank + 1))
    facts = (formed, distributed.is_primary(), group.rank, group.world,
             int(total))
    anim, t0 = build_animated(paths["columns"])
    render = make_sharded_render(group, anim.with_transforms(t0),
                                 num_samples=1, num_bounces=2, width=ANIM_W,
                                 height=ANIM_H, tiers="bvh")
    frames = []
    for frame in range(ANIM_FRAMES):
        scene = anim.with_transforms(animated_transforms(t0, frame))
        image, rays = render(scene, *camera_tensors(animated_camera(frame),
                                                    "cpu"), frame)
        frames.append((image.numpy(), int(rays)))
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((facts, frames), f)
