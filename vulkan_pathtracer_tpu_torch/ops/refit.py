"""Refit: new node boxes for moved triangles, and every table
regenerated from them, on the scene's device.

Counterpart of ``vulkan_pathtracer_tpu/ops/refit.py`` (``refit_aabbs``,
``refit_scene``) and of the device builders it calls
(``pallas_pair.build_pair_rows_device``, ``_build_nary_rows_device``,
``pallas_frontier.build_frontier_rows_device``, the ``bvh_packed`` /
``tri_blocks`` rewrite).  The topology stays the bake's (its
``TreeMaps``, below); only boxes move:

1. leaf boxes from their leaf block's valid triangles (min / max of the
   triangles' corners);
2. internal boxes by ``bvh_depth - 1`` whole-array passes, each node
   the union of its children (min and max are exact, so the boxes are
   bitwise JAX's); lo and -hi share one (Nn, 6) tensor, so a pass is
   one gather per child, a minimum and a select;
3. every table the scene has, through the static maps (regenerate):
   the pair, quad and oct boxes, the frontier's guard-dilated boxes (in
   float64 from the new root box, as the host bake computes them), the
   skip records through the octant permutation, the leaf blocks, and
   the coefficient rows when the scene carries them (float64 as the
   host bake; JAX's refit leaves ``tri_coefs`` stale).  The links are
   the bake's.  The 8-wide tiles are dropped (JAX refit.py:85-88), so
   ``--traversal pallas8`` cannot run on a refitted scene.

No step reads the device back: a refit is a fixed sequence of
launches.  JAX's ``jax_debug_nans`` branch has no counterpart: the
port's empty slots are zero boxes with an EMPTY link, not NaN.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from vulkan_pathtracer_tpu_torch.ops.frontier import GUARD, frontier_boxes
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import coef_rows
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import boxes_from_src

BIG = 3e38


@dataclass
class TreeMaps:
    """The build-order binary tree of a flat scene (``DeviceScene.tree``)
    and the static maps from it to the rows of every table, so that the
    refit can regenerate the tables on the device when the boxes move,
    and ops/device_build.py can describe a rebuilt tree: the JAX package's
    ``bvh_left`` / ``bvh_right``, ``bvh_leaf_first_build`` /
    ``bvh_leaf_count_build``, ``bvh_perm`` and the src half of its
    (src, enc) maps (``bvh_quad_src``, ``bvh_oct_src``,
    ``bvh_frontier_src``; the pair rows' children).  The enc half is
    the table's own link (the EMPTY sentinel in an empty slot), which a
    refit keeps.  int64 tensors on the scene's device."""
    left: torch.Tensor          # (Nn,) child node, -1 at a leaf
    right: torch.Tensor         # (Nn,)
    leaf_first: torch.Tensor    # (Nn,) block-aligned first slot, -1 internal
    leaf_count: torch.Tensor    # (Nn,) triangles of a leaf, 0 internal
    block_count: torch.Tensor   # (n_blocks,) triangles of each leaf block
    perm: torch.Tensor          # (8*Nn,) skip record -> build node
    pair_src: torch.Tensor      # (Ni, 2) children of each pair row
    quad_src: Optional[torch.Tensor] = None      # (N4, 4), -1 empty
    oct_src: Optional[torch.Tensor] = None       # (N8, 8)
    frontier_src: Optional[torch.Tensor] = None  # (Nw, W)


def refit_aabbs(tri_v0, tri_e1, tri_e2, tree, block: int, depth: int):
    """(bmin, bmax) (Nn, 3) f32 build-order node boxes of ``tree`` (a
    TreeMaps) over the slot-ordered triangles ``tri_*`` (T, 3)."""
    n_blocks = tree.block_count.shape[0]
    n = n_blocks * block
    v0 = tri_v0[:n]
    v1 = v0 + tri_e1[:n]
    v2 = v0 + tri_e2[:n]
    corners = torch.cat([torch.minimum(torch.minimum(v0, v1), v2),
                         -torch.maximum(torch.maximum(v0, v1), v2)], dim=1)
    slot = torch.arange(block, device=v0.device)
    valid = (slot[None, :] < tree.block_count[:, None]).unsqueeze(-1)
    big = torch.full((), BIG, dtype=torch.float32, device=v0.device)
    leaf_box = torch.where(valid, corners.view(n_blocks, block, 6),
                           big).amin(dim=1)
    is_leaf = (tree.leaf_first >= 0).unsqueeze(1)
    b = torch.where(is_leaf, leaf_box[tree.leaf_first.clamp(min=0) // block],
                    big)
    li = tree.left.clamp(min=0)
    ri = tree.right.clamp(min=0)
    for _ in range(max(depth - 1, 0)):
        b = torch.where(is_leaf, b, torch.minimum(b[li], b[ri]))
    return b[:, :3].contiguous(), (-b[:, 3:]).contiguous()


def regenerate(scene, bmin, bmax) -> dict:
    """The updates of ``scene``'s tables for build-order node boxes
    (Nn, 3): every table the scene has, regenerated through its
    TreeMaps (the skip records' skips and leaves kept), the root box,
    the leaf blocks and the coefficient rows from the scene's
    triangles."""
    tree = scene.tree
    up = dict(pair_box=boxes_from_src(bmin, bmax, tree.pair_src),
              root_lo=bmin[0].clone(), root_hi=bmax[0].clone(),
              skip_nodes=torch.cat([bmin[tree.perm], bmax[tree.perm],
                                    scene.skip_nodes[:, 6:8]], dim=1))
    for name in ("quad", "oct"):
        src = getattr(tree, f"{name}_src")
        if getattr(scene, f"{name}_box") is not None and src is not None:
            up[f"{name}_box"] = boxes_from_src(bmin, bmax, src)
    if scene.frontier_box is not None and tree.frontier_src is not None:
        up["frontier_box"] = frontier_boxes(bmin, bmax, tree.frontier_src,
                                            GUARD)
    n_blocks, block = scene.leaves.shape[0], scene.leaves.shape[1]
    n = n_blocks * block
    up["leaves"] = torch.cat(
        [scene.tri_v0[:n], scene.tri_e1[:n], scene.tri_e2[:n]],
        dim=1).view(n_blocks, block, 9)
    if scene.tri_coefs is not None:
        up["tri_coefs"] = coef_rows(up["leaves"])
    return up


def refit_boxes(scene):
    """(bmin, bmax) of a flat scene's tree over its current triangles."""
    return refit_aabbs(scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tree,
                       scene.max_leaf_size, scene.bvh_depth)


def refit_scene(scene, on_step=None):
    """A copy of a flat scene after its triangles moved: new boxes, every
    table regenerated (refit_boxes, regenerate), no 8-wide tiles.
    ``on_step(name)``, when given, is called after each step ("refit",
    "regenerate")."""
    if scene.tree is None:
        raise ValueError("refit_scene: the scene has no build-order tree "
                         "(a flat bake with a BVH carries one)")
    step = on_step or (lambda name: None)
    bmin, bmax = refit_boxes(scene)
    step("refit")
    up = regenerate(scene, bmin, bmax)
    step("regenerate")
    return dataclasses.replace(scene, wide_nodes=None, **up)


def tree_violations(scene) -> tuple:
    """(triangles outside their leaf box, child boxes outside their
    parent's) of a flat scene, counted on its device from the octant-0
    skip records and the build-order tree: both 0 for a correct refit
    or rebuild."""
    tree = scene.tree
    nn = tree.left.shape[0]
    lo = torch.empty((nn, 3), dtype=torch.float32, device=scene.device)
    hi = torch.empty_like(lo)
    perm0 = tree.perm[:nn]
    lo[perm0] = scene.skip_nodes[:nn, 0:3]
    hi[perm0] = scene.skip_nodes[:nn, 3:6]
    internal = tree.left >= 0
    li, ri = tree.left.clamp(min=0), tree.right.clamp(min=0)
    child_out = torch.zeros((), dtype=torch.int64, device=scene.device)
    for c in (li, ri):
        bad = ((lo[c] < lo) | (hi[c] > hi)).any(dim=1) & internal
        child_out = child_out + bad.sum()
    block = scene.max_leaf_size
    n_blocks = tree.block_count.shape[0]
    v0 = scene.tri_v0[:n_blocks * block]
    v1 = v0 + scene.tri_e1[:n_blocks * block]
    v2 = v0 + scene.tri_e2[:n_blocks * block]
    # The box of each triangle slot's leaf, slots of a block in order.
    leaf_nodes = torch.nonzero(tree.leaf_first >= 0).squeeze(1)
    owner = torch.zeros(n_blocks, dtype=torch.int64, device=scene.device)
    owner[tree.leaf_first[leaf_nodes] // block] = leaf_nodes
    owner = owner.repeat_interleave(block)
    valid = (torch.arange(block, device=scene.device)[None, :]
             < tree.block_count[:, None]).reshape(-1)
    tri_out = torch.zeros((), dtype=torch.int64, device=scene.device)
    for p in (v0, v1, v2):
        bad = ((p < lo[owner]) | (p > hi[owner])).any(dim=1) & valid
        tri_out = tri_out + bad.sum()
    return int(tri_out), int(child_out)
