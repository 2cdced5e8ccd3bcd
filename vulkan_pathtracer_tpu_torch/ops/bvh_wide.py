"""8-wide BVH: binary collapse + per-octant preorder emission.

The port's own copy of ``vulkan_pathtracer_tpu/ops/bvh_wide.py``
(``collapse8``, ``build_wide_bvh``), unchanged in what it builds: the
tiles are bitwise the JAX package's ``bvh_wide_nodes``.  The wide
closest-hit kernel (csrc/skip_traverse.cu, ops/skip_traverse.py) walks
them.

Build: collapse the binary tree by repeatedly expanding the
largest-area internal slot until a node has 8 slots (or all leaves).
Each octant gets its own preorder with near-first slot ordering
(slots sorted by the signed projection of their box centers) and skip
pointers; control flow stays stackless: descend to node+1 when any
*internal* slot was hit, else take the skip pointer.

Slot fields (float32): [bmin xyz, bmax xyz, leafword, pad] where
leafword >= 0 is the slot's leaf-block first-triangle index (exact in
f32 below 2^24), -1 marks an internal slot and -2 an empty slot.  Slot
0's pad holds the tile's skip pointer as an f32 value.

An empty slot's box is inverted (bmin = +3e38, bmax = -3e38), but that
does NOT make it miss: the slab test ``(b - o) * inv`` gives each axis
the interval [-inf-ish, +inf-ish], which spans every t, so the slot
tests as hit.  Traversal is right only because it reads the leafword
(-2 is neither a leaf nor internal) and never acts on an empty slot's
box test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from vulkan_pathtracer_tpu_torch.ops.bvh import HostBVH

EMPTY = -2.0
INTERNAL = -1.0
BIG = np.float32(3e38)
F32_EXACT = 1 << 24   # leafwords and skips are f32 values

_OCT_SIGNS = np.array(
    [[1 if (o >> a) & 1 == 0 else -1 for a in range(3)] for o in range(8)],
    dtype=np.float64,
)  # +1 where direction >= 0 (octant bit clear)


@dataclass
class WideBVH:
    # Stacked per octant: [oct * Nw + i]
    nodes: np.ndarray   # (8*Nw, 8, 8) f32 slot tiles
    skip: np.ndarray    # (8*Nw,) int32, octant-LOCAL skip pointers
    n_wide: int


def _area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def collapse8(bvh: HostBVH) -> List[dict]:
    """Collapse to wide nodes (binary ids in slots).

    Returns a list of wide-node dicts ``{"root", "slots",
    "child_wide"}`` in discovery order; wide node 0 is the root and
    ``child_wide`` maps each internal slot to its wide node."""
    left = bvh.left_child
    right = bvh.right_child
    leaf_first = bvh.leaf_first

    wide: List[dict] = []
    work = [0]   # binary roots of wide nodes still to emit
    wide_index_of_root = {}
    while work:
        root = work.pop()
        if root in wide_index_of_root:
            continue
        slots = [root] if leaf_first[root] >= 0 else [left[root], right[root]]
        # Expand the largest-area internal slot until 8 slots or all leaves.
        while len(slots) < 8:
            best = -1
            best_area = -1.0
            for i, s in enumerate(slots):
                if leaf_first[s] < 0:
                    a = _area(bvh.bmin[s].astype(np.float64),
                              bvh.bmax[s].astype(np.float64))
                    if a > best_area:
                        best_area = a
                        best = i
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([left[s], right[s]])
        wide_index_of_root[root] = len(wide)
        wide.append({"root": root, "slots": slots})
        for s in slots:
            if leaf_first[s] < 0:
                work.append(s)
    # Every internal slot is the root of exactly one wide node.
    root_to_wide = {node["root"]: i for i, node in enumerate(wide)}
    for node in wide:
        node["child_wide"] = {s: root_to_wide[s] for s in node["slots"]
                              if leaf_first[s] < 0}
    return wide


def build_wide_bvh(bvh: HostBVH, block: int) -> WideBVH:
    """Collapse + emit 8 octant-ordered preorders with skip pointers.
    ``bvh``'s leaves must be block-aligned (pad_leaves_to_blocks)."""
    if bvh.leaf_first.max() >= F32_EXACT:
        raise ValueError("build_wide_bvh: leaf offsets reach 2^24 and are "
                         "not exact as f32 leafwords")
    wide = collapse8(bvh)
    n_wide = len(wide)
    leaf_first = bvh.leaf_first
    centers = (bvh.bmin.astype(np.float64) + bvh.bmax) * 0.5

    nodes = np.zeros((8, n_wide, 8, 8), dtype=np.float32)
    skip = np.zeros((8, n_wide), dtype=np.int32)

    for o in range(8):
        signs = _OCT_SIGNS[o]
        count = 0
        # Iterative preorder with skip patching: (wide index, patch slot).
        stack = [(0, -1)]
        while stack:
            w, patch = stack.pop()
            if patch >= 0:
                skip[o, patch] = count
                continue
            me = count
            count += 1
            node = wide[w]
            slots = node["slots"]
            keys = [float(signs @ centers[s]) for s in slots]
            ordered = [s for _, s in sorted(zip(keys, slots),
                                            key=lambda kv: kv[0])]
            for k, s in enumerate(ordered):
                nodes[o, me, k, 0:3] = bvh.bmin[s]
                nodes[o, me, k, 3:6] = bvh.bmax[s]
                lf = leaf_first[s]
                nodes[o, me, k, 6] = float(lf) if lf >= 0 else INTERNAL
            for k in range(len(ordered), 8):
                nodes[o, me, k, 0:3] = BIG
                nodes[o, me, k, 3:6] = -BIG
                nodes[o, me, k, 6] = EMPTY
            stack.append((w, me))
            # Child subtrees in REVERSE visit order (the stack pops the
            # nearest first).
            internal_children = [s for s in ordered if leaf_first[s] < 0]
            for s in reversed(internal_children):
                stack.append((node["child_wide"][s], -1))
        assert count == n_wide, (count, n_wide)
        # The skip pointer rides in slot 0, field 7, so a visit reads
        # one tile and no second table.
        nodes[o, :, 0, 7] = skip[o].astype(np.float32)

    return WideBVH(nodes=nodes.reshape(8 * n_wide, 8, 8),
                   skip=skip.reshape(-1), n_wide=n_wide)
