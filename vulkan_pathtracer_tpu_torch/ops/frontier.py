"""Frontier traversal: the 16- or 32-wide collapse, closest hit and any
hit (``VKPT_KERNEL_*=frontier``, ``VKPT_ANYHIT_KERNEL=frontier``).

Counterpart of ``vulkan_pathtracer_tpu/ops/pallas_frontier.py``: its
bake (``build_frontier_rows``, the guard rule ``_guard``, the Batcher
network ``_batcher_oem``) and its two kernels ``_make_frontier_kernel``
(``pallas_frontier_closest_hit``) and ``_make_frontier_anyhit_kernel``
(``pallas_frontier_any_hit``), each with exact or coefficient leaves
(ops/mxu_mt.py).

On the TPU the collapse's 16 child boxes are tested with one
slab-coefficient matmul per packet; its product gives each plane as
``lo * ix + 1 * (-(ox * ix))``, which in f32 is the stack kernels'
``b * inv - o * inv``.  The port tests the boxes per ray on CUDA cores
(csrc/frontier_traverse.cu) with that same slab, so the node test is
the quad kernel's on guard-dilated boxes: the dilation (baked for a
one-pass bf16 product, pallas_frontier.py:53-63) only adds visits, and
the hits equal the quad kernel's up to ties of equal t.  A later
tensor-core design has to keep the guard above its own rounding error.

Tables (port-native layout, converted from the JAX tiles at the
boundary, ``tables_from_jax``):

- ``frontier_box (Nw, W, 6) f32``: per row the W guard-dilated child
  boxes lo.xyz, hi.xyz (JAX's (Nw, 8, lane_w) coefficient tiles hold
  the same planes);
- ``frontier_link (Nw, W) int32``: a child row, -(leaf+1) a leaf block,
  or ``EMPTY``.  The JAX tiles mark an empty slot with NaN planes and
  enc -1 ("leaf 0"); CUDA's fminf/fmaxf drop NaN, so the port's link
  says so explicitly.

Order inside a node: hit leaf slots in slot order, then the internal
children sorted by entry distance with the Batcher network (swap on
``<=``), pushed far to near, descent to the nearest; the kernel runs
the network only where two or more internal children were hit (with
one finite key every network puts it first).  The any hit visits
internal children in slot order instead (its bit does not depend on
the order).  Both kernels are the stack walk of the quad and pair
kernels at width 16 or 32 (csrc/stack_walk.cuh,
csrc/frontier_traverse.cu).  Exact leaves need a block of at most 14
triangles, as in the JAX package (the Pallas kernel's static lane
indices): a larger block raises its ValueError, so leaf 28 needs
``mt="mxu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.ops import mxu_mt
from vulkan_pathtracer_tpu_torch.ops.intersect import Hit
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    EMPTY,
    _dispatch,
    _launch_name,
    _traverse_plain,
    boxes_from_src,
    channel_args,
    collapse_maps,
    host_boxes,
    lane_limits,
    leaf_table,
)
from vulkan_pathtracer_tpu_torch.utils.config import (
    FRONTIER_GUARD,
    FRONTIER_WIDTH,
)

EXACT_MAX_BLOCK = 14   # block * 9 <= 128 lanes (pallas_frontier.py:1018)
# The default guard band of the bake (pallas_frontier._guard): 2^-7,
# about twice the error bound of the one-pass bf16 node product the JAX
# package runs by default; 2^-12 under VKPT_FRONTIER_PRECISION=high or
# highest (RenderConfig.frontier_guard).  The port's f32 slab needs no
# band; it keeps JAX's boxes, and a scene keeps the band it was baked
# with (DeviceScene.frontier_guard), which its refit regenerates.
GUARD = FRONTIER_GUARD


def batcher_oem(n: int):
    """Batcher odd-even mergesort comparator list for n keys
    (pallas_frontier._batcher_oem): 63 comparators at 16, 191 at 32.
    csrc/sortnet.cuh holds the same lists."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def build_frontier_tables(bvh, block: int, width: int = FRONTIER_WIDTH,
                          guard: float = GUARD):
    """(frontier_box (Nw, width, 6) f32, frontier_link (Nw, width) int32,
    frontier_src) of the width-ary collapse
    (pallas_pair.build_frontier_rows; collapse_maps): each child box
    dilated by guard * (max(|lo|, |hi|) + |root|) per axis, in float64
    and rounded once to f32 (frontier_boxes)."""
    if width not in (16, 32):
        raise ValueError(f"frontier width {width}: 16 or 32")
    src, link = collapse_maps(bvh, block, width)
    box = frontier_boxes(*host_boxes(bvh), torch.from_numpy(src), guard)
    return box.numpy(), link, src


def frontier_boxes(bmin: torch.Tensor, bmax: torch.Tensor,
                   src: torch.Tensor, guard: float = GUARD) -> torch.Tensor:
    """(Nw, W, 6) f32 frontier boxes of build-order node boxes (Nn, 3)
    through the static map ``src`` (-1: empty slot, zero box), on the
    boxes' device: each child box dilated by guard * (max(|lo|, |hi|) +
    |root|) in float64 and rounded once, so a table regenerated after a
    refit is bitwise the host bake's of the same tree
    (pallas_frontier.build_frontier_rows_device computes it in f32)."""
    R = torch.maximum(bmin[0].abs(), bmax[0].abs()).double()
    box = boxes_from_src(bmin, bmax, src).double()
    lo, hi = box[..., :3], box[..., 3:]
    d = guard * (torch.maximum(lo.abs(), hi.abs()) + R)
    box = torch.cat([(lo - d).float(), (hi + d).float()], dim=-1)
    return torch.where((src >= 0).unsqueeze(-1), box,
                       torch.zeros_like(box)).contiguous()


def tables_from_jax(tiles: np.ndarray, width: int):
    """JAX coefficient tiles (Nw, 8, lane_w) as (frontier_box,
    frontier_link): planes of row a (lo) and 3 + a (hi) of axis a, enc
    row 6; NaN planes mark an empty slot."""
    n, w = tiles.shape[0], width
    box = np.zeros((n, w, 6), np.float32)
    for a in range(3):
        box[:, :, a] = tiles[:, a, a * w:(a + 1) * w]
        box[:, :, 3 + a] = tiles[:, a, (3 + a) * w:(4 + a) * w]
    empty = np.isnan(box[:, :, 0])
    link = np.where(empty, EMPTY, tiles[:, 6, :w].astype(np.int64)).astype(
        np.int32)
    box[empty] = 0.0
    return box, link


def check_exact_block(leaves) -> None:
    """Raise JAX's ValueError for exact leaves of more than 14 triangles
    (a coefficient table passes)."""
    if leaves.shape[2] != mxu_mt.COLS and leaves.shape[1] > EXACT_MAX_BLOCK:
        raise ValueError(
            "frontier kernel with exact leaves requires leaf block*9 <= "
            "128 lanes (leaf <= 14); rebuild with a smaller leaf or enable "
            f"the MXU leaf tier (VKPT_MT=mxu) — got {leaves.shape[1] * 9} "
            "lanes")


# -- plain versions --------------------------------------------------------

def frontier_closest_hit_plain(box, link, leaves, origin, direction, t_lane,
                               leaf_visits=None, stats=None, t_near=None,
                               seed=None) -> Hit:
    """Plain version of the frontier closest-hit kernel (any device);
    ``t_near`` (n,) and ``seed`` (t, tri, u, v), its channel build.
    ``stats``, a dict, accumulates node visits, leaf-block visits, the
    early exits of exact leaves and the visited nodes by hit internal
    children (ops/stack_traverse._traverse_plain)."""
    t, tri, u, v = _traverse_plain(box, link, leaves, origin, direction,
                                   t_lane, False, False,
                                   leaf_visits=leaf_visits, stats=stats,
                                   sortnet=batcher_oem(box.shape[1]),
                                   seed=seed, t_near=t_near)
    return Hit(t=t, tri=tri, u=u, v=v)


def frontier_any_hit_plain(box, link, leaves, origin, direction, t_lane,
                           leaf_visits=None, stats=None) -> torch.Tensor:
    """Plain version of the frontier any-hit kernel (any device): (N,)
    bool.  Hit children, leaves and internal nodes, are visited in slot
    order, as the kernel does: the bit does not depend on the order, and
    equals the near-first walk's with the Batcher network
    (pallas_frontier_any_hit's)."""
    return _traverse_plain(box, link, leaves, origin, direction, t_lane,
                           True, False, leaf_visits=leaf_visits, stats=stats,
                           slot_order=True)


# -- wrappers -------------------------------------------------------------

def frontier_args(scene, origin, direction, active, coef: bool = False,
                  t_far=None):
    """The frontier kernels' arguments: tables, rays and t_lane
    (``t_far`` folded in)."""
    if scene.frontier_box is None:
        raise ValueError("the scene has no frontier tables (flat bakes "
                         "only)")
    return (scene.frontier_box, scene.frontier_link, leaf_table(scene, coef),
            origin, direction,
            lane_limits(origin.shape[0], active, origin.device, t_far))


def frontier_closest_hit(scene, origin, direction, active=None,
                         coef: bool = False, seed=None, t_near=None,
                         t_far=None) -> Hit:
    """Closest hit over the scene's frontier tables
    (pallas_frontier_closest_hit): from ``seed`` (a Hit), and only hits
    in [t_near, t_far) when those are given.  Inactive lanes return t =
    MISS_T, tri = -1, u = v = 0, or their seed."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = frontier_args(scene, origin, direction, active, coef, t_far)
    check_exact_block(args[2])
    kw = channel_args(origin, seed, t_near)
    return _dispatch(_launch_name("frontier_closest_hit", args[2], kw),
                     origin,
                     lambda: frontier_closest_hit_plain(*args, **kw),
                     lambda: Hit(*kernels.frontier_closest_hit(*args, **kw)))


def frontier_any_hit(scene, origin, direction, active=None,
                     coef: bool = False) -> torch.Tensor:
    """Occlusion (N,) bool (pallas_frontier_any_hit): True where
    frontier_closest_hit reports t < MISS_T, exactly so with exact
    leaves.  Inactive lanes return False."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = frontier_args(scene, origin, direction, active, coef)
    check_exact_block(args[2])
    return _dispatch(_launch_name("frontier_any_hit", args[2]), origin,
                     lambda: frontier_any_hit_plain(*args),
                     lambda: kernels.frontier_any_hit(*args))
