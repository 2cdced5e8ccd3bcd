"""Animated flat scenes: per-frame instance transforms, rebake and
refit on the device.

Counterpart of ``vulkan_pathtracer_tpu/models/animation.py``
(``AnimatedScene``, ``with_transforms``, ``build_animated_scene``).  The
flat bake's topology stays; the object-space triangles and vertex
attributes are kept in the bake's slot order, and each frame rebakes
the world-space triangles, geometric normals and packed shading rows
from an (I, 4, 4) transform tensor, then refits (ops/refit.py), which
regenerates every table, the coefficient rows included.

Rebake semantics are the static bake's (models/device_scene.py):
positions by A p + t; normals, tangents and the object-space edge
cross by inverse(A), unnormalized except the geometric normal (the
reference's row-vector quirk, triangle.glsl:79-107).  The rebake runs
in f32 with each 3-term product written as a sum in a fixed order
((a0 x + a1 y) + a2 z), so it does not depend on how a matmul reduces;
it differs from JAX's einsum and from the host bake's float64 products
by rounding (tests/test_torch_presplit_refit.py states the tolerance).
The inverse takes no singularity check (``inv_ex``): a rebake and
its refit read nothing back from the device.

``SceneAnimation`` is what ``render/pipeline.RenderPipeline`` poses a
scene with each frame: a motion (``transforms(t)``: (I, 4, 4) f32 on
the device, such as models/node_animation.NodeAnimator for a glTF's own
channels) and the baked scene it moves, a two-level DeviceScene
(``instanced_scene.update_instance_transforms``) or a flat
AnimatedScene (``with_transforms``).  On a CUDA device the two-level
pose is two CUDA graphs, captured at the first pose (the evaluation at
a time held in a device scalar, then the update), and each later pose
refills the time and replays them: the TLAS, the instance tables, the
skip records and the pair rows are rewritten in place, in two launches
in place of a few hundred (the enqueue of which would leave the card
idle for milliseconds a frame).  The flat refit allocates tables of its
own each frame and runs eagerly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.models import instanced_scene
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    DeviceScene,
    apply_slot_map,
    bake_flat,
)
from vulkan_pathtracer_tpu_torch.models.gltf import Scene
from vulkan_pathtracer_tpu_torch.ops.refit import refit_scene
from vulkan_pathtracer_tpu_torch.utils.config import (
    FRONTIER_GUARD,
    FRONTIER_WIDTH,
)


def _apply(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, 3) rows M (N, 3, 3) @ v (N, 3), each component summed as
    (M[i,0] v0 + M[i,1] v1) + M[i,2] v2."""
    return torch.stack([(M[:, i, 0] * v[:, 0] + M[:, i, 1] * v[:, 1])
                        + M[:, i, 2] * v[:, 2] for i in range(3)], dim=1)


@dataclass
class AnimatedScene:
    """A flat DeviceScene and the object-space sources of its rebake, in
    its slot order (padded slots zero, instance 0)."""

    base: DeviceScene
    obj_v0: torch.Tensor         # (T, 3) f32
    obj_e1: torch.Tensor         # (T, 3) f32
    obj_e2: torch.Tensor         # (T, 3) f32
    obj_gn: torch.Tensor         # (T, 3) f32 object-space edge cross
    tri_instance: torch.Tensor   # (T,) int64
    tri_index: torch.Tensor      # (T, 3) int64 vertex of each corner
    obj_normal: torch.Tensor     # (V, 3) f32
    obj_tangent: torch.Tensor    # (V, 4) f32
    vert_instance: torch.Tensor  # (V,) int64

    @property
    def num_instances(self) -> int:
        return int(self.vert_instance.max()) + 1 if self.vert_instance.numel() \
            else 0

    def initial_transforms(self, scene: Scene) -> torch.Tensor:
        """(I, 4, 4) f32 transforms of the loaded scene, on the device."""
        return torch.as_tensor(
            np.stack([inst.transform for inst in scene.instances]),
            dtype=torch.float32, device=self.base.device)

    def rebake(self, transforms) -> DeviceScene:
        """A copy of the base scene with world-space triangles, geometric
        normals and shading rows for (I, 4, 4) ``transforms``; its boxes
        and tables are still the base's (refit_scene follows)."""
        M = torch.as_tensor(transforms, dtype=torch.float32,
                            device=self.base.device)
        A = M[:, :3, :3]
        N = torch.linalg.inv_ex(A).inverse   # triangle.glsl:79 quirk
        inst = self.tri_instance
        A_t, N_t = A[inst], N[inst]
        v0 = _apply(A_t, self.obj_v0) + M[inst, :3, 3]
        e1 = _apply(A_t, self.obj_e1)
        e2 = _apply(A_t, self.obj_e2)
        gn = _apply(N_t, self.obj_gn)
        norm = torch.sqrt((gn[:, 0] * gn[:, 0] + gn[:, 1] * gn[:, 1])
                          + gn[:, 2] * gn[:, 2])
        gn = gn / torch.clamp(norm, min=1e-30).unsqueeze(1)
        N_v = N[self.vert_instance]
        nrm = _apply(N_v, self.obj_normal)
        tan = torch.cat([_apply(N_v, self.obj_tangent[:, :3]),
                         self.obj_tangent[:, 3:4]], dim=1)
        idx = self.tri_index
        attr = self.base.tri_attr
        tri_attr = torch.cat([nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]],
                              tan[idx[:, 0]], tan[idx[:, 1]], tan[idx[:, 2]],
                              attr[:, 21:27], gn, attr[:, 30:34]], dim=1)
        return dataclasses.replace(self.base, tri_v0=v0, tri_e1=e1,
                                   tri_e2=e2, tri_gn=gn, tri_attr=tri_attr)

    def with_transforms(self, transforms, on_step=None) -> DeviceScene:
        """The scene at (I, 4, 4) ``transforms``: rebake, then refit
        (new boxes, every table regenerated, no 8-wide tiles).
        ``on_step(name)``, when given, is called after the rebake
        ("rebake") and after each step of refit_scene."""
        moved = self.rebake(transforms)
        if on_step is not None:
            on_step("rebake")
        return refit_scene(moved, on_step)


def build_animated_scene(scene: Scene, max_leaf_size: int = 4,
                         device="cuda", mt: str = "exact",
                         frontier_width: int = FRONTIER_WIDTH,
                         presplit: float = 0.0,
                         frontier_guard: float = FRONTIER_GUARD,
                         mxu_precision: str = "highest") -> AnimatedScene:
    """Bake the flat scene (build_device_scene's arguments), then its
    object-space sources in the bake's slot order, through the bake's
    own slot map."""
    base, slot_map = bake_flat(scene, max_leaf_size, device, True, False, mt,
                               frontier_width, presplit, frontier_guard,
                               mxu_precision)
    if slot_map is None:
        raise ValueError("build_animated_scene: the scene has no triangles")
    tri = {k: [] for k in ("inst", "v0", "e1", "e2", "gn", "index")}
    vert = {k: [] for k in ("inst", "normal", "tangent")}
    vert_base = 0
    for ii, inst in enumerate(scene.instances):
        mesh = scene.meshes[inst.mesh_index]
        for prim in scene.primitives[mesh.start:mesh.end]:
            idx = prim.indices.reshape(-1, 3).astype(np.int64)
            p = prim.positions.astype(np.float64)
            v0 = p[idx[:, 0]]
            e1 = p[idx[:, 1]] - v0
            e2 = p[idx[:, 2]] - v0
            tri["inst"].append(np.full(idx.shape[0], ii, np.int64))
            tri["v0"].append(v0.astype(np.float32))
            tri["e1"].append(e1.astype(np.float32))
            tri["e2"].append(e2.astype(np.float32))
            tri["gn"].append(np.cross(e1, e2).astype(np.float32))
            tri["index"].append(idx + vert_base)
            vert["inst"].append(np.full(p.shape[0], ii, np.int64))
            vert["normal"].append(prim.normals)
            vert["tangent"].append(prim.tangents)
            vert_base += p.shape[0]
    rows = base.tri_v0.shape[0]

    def slots(arr):
        arr = apply_slot_map(np.ascontiguousarray(arr), slot_map)
        pad = np.zeros((rows - arr.shape[0],) + arr.shape[1:], arr.dtype)
        return torch.from_numpy(np.concatenate([arr, pad])).to(base.device)

    def verts(key, dtype):
        return torch.from_numpy(np.concatenate(vert[key]).astype(dtype)).to(
            base.device)

    return AnimatedScene(
        base=base, **{f"obj_{k}": slots(np.concatenate(tri[k]))
                      for k in ("v0", "e1", "e2", "gn")},
        tri_instance=slots(np.concatenate(tri["inst"])),
        tri_index=slots(np.concatenate(tri["index"])),
        obj_normal=verts("normal", np.float32),
        obj_tangent=verts("tangent", np.float32),
        vert_instance=verts("inst", np.int64))


def update_records(scene: DeviceScene) -> int:
    """The table rows a pose rewrites: the skip records (each node of
    the 8 octant orders with its box), the pair, quad, oct and frontier
    rows the scene has, and its instance rows."""
    tables = (scene.skip_nodes, scene.pair_box, scene.quad_box,
              scene.oct_box, scene.frontier_box, scene.inst_inv)
    return sum(int(t.shape[0]) for t in tables if t is not None)


@dataclass
class SceneAnimation:
    """A baked scene and the motion that poses it (module docstring).
    ``on_step(name)``, when given, is passed to a flat scene's
    ``with_transforms``."""

    motion: object     # .transforms(t) -> (I, 4, 4) f32; .moved, optional
    rest: object       # a two-level DeviceScene or an AnimatedScene
    on_step: Optional[Callable] = None

    @property
    def flat(self) -> bool:
        return isinstance(self.rest, AnimatedScene)

    @property
    def scene(self) -> DeviceScene:
        """The scene as baked, before any pose."""
        return self.rest.base if self.flat else self.rest

    @property
    def graphed(self) -> bool:
        """Whether a pose replays CUDA graphs (the module docstring)."""
        return not self.flat and self.scene.device.type == "cuda"

    def __post_init__(self):
        # Instances a pose moves: the motion's count, else every one.
        moved = getattr(self.motion, "moved", None)
        if moved is None:
            moved = (self.rest.num_instances if self.flat
                     else int(self.rest.inst_inv.shape[0]))
        self.moved = int(moved)
        self._graphs = None

    def _capture(self) -> None:
        """Capture the evaluation (at the device scalar ``_time``) and
        the update as two graphs, after one eager run on a side stream
        (cuBLAS's handle and workspace are made outside the capture)."""
        dev = self.scene.device
        self._time = torch.zeros((), dtype=torch.float64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            instanced_scene.update_instance_transforms(
                self.rest, self.motion.transforms(self._time))
        torch.cuda.current_stream(dev).wait_stream(side)
        evaluate, update = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(evaluate):
            self._transforms = self.motion.transforms(self._time)
        with torch.cuda.graph(update):
            self._posed = instanced_scene.update_instance_transforms(
                self.rest, self._transforms)
        self._graphs = (evaluate, update)

    def transforms(self, time: float) -> torch.Tensor:
        """The motion's (I, 4, 4) transforms at ``time`` seconds."""
        if not self.graphed:
            return self.motion.transforms(time)
        if self._graphs is None:
            self._capture()
        self._time.fill_(float(time))
        self._graphs[0].replay()
        return self._transforms

    def update(self, transforms) -> DeviceScene:
        """The scene at (I, 4, 4) ``transforms``; graphed, the one posed
        scene, rewritten in place."""
        if self.flat:
            return self.rest.with_transforms(transforms, self.on_step)
        if not self.graphed:
            return instanced_scene.update_instance_transforms(self.rest,
                                                              transforms)
        if self._graphs is None:
            self._capture()
        if transforms is not self._transforms:
            self._transforms.copy_(transforms)
        self._graphs[1].replay()
        return self._posed
