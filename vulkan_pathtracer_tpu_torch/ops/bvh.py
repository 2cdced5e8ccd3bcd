"""BVH build: Morton-ordered binary BVH, linearized with skip pointers.

The port's own copy of the host build of
``vulkan_pathtracer_tpu/ops/bvh.py``: ``build_bvh_host``,
``pad_leaves_to_blocks``, ``octant_orders``, ``tree_depth``,
``validate_bvh`` and what they call, unchanged.

The reference never builds a BVH — the Vulkan driver does it inside
``vkCmdBuildAccelerationStructuresKHR`` (RaytracingPass.zig:451-465,
``prefer_fast_trace``).  On TPU the acceleration structure is ours to
design.  This builder is LBVH-flavored:

1. 30-bit Morton codes of triangle-centroid positions, normalized to
   the scene AABB (the classic LBVH keying).
2. Sort triangles by code; recursively split ranges at the highest
   differing Morton bit (median fallback on duplicate codes), making
   leaves of <= max_leaf_size contiguous triangles.
3. Emit nodes in DFS preorder and store a *skip pointer* (escape
   index) per node.  Traversal then needs no stack: ``hit -> node+1``,
   ``miss/leaf-done -> skip[node]`` — one int of state per ray, which
   is exactly what a (8,128)-lane vector machine wants (SURVEY.md §7
   "hard parts #1").

Leaf triangle ranges are contiguous because the caller reorders the
triangle arrays by ``tri_order``, so leaf intersection is a short
dense dynamic-slice, not a gather.

The builder itself is host-side NumPy (vectorized per node); a C++
port in native/ can replace it transparently.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HostBVH:
    bmin: np.ndarray        # (Nn, 3) f32
    bmax: np.ndarray        # (Nn, 3) f32
    skip: np.ndarray        # (Nn,) int32 — escape target (Nn == done)
    leaf_first: np.ndarray  # (Nn,) int32 — -1 for internal nodes
    leaf_count: np.ndarray  # (Nn,) int32
    tri_order: np.ndarray   # (T,) int64 — new -> old triangle permutation
    # parent/child links for device refit:
    left_child: np.ndarray  # (Nn,) int32 (-1 for leaves)
    right_child: np.ndarray  # (Nn,) int32

    @property
    def node_count(self) -> int:
        return self.bmin.shape[0]


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit codes (uint32)."""

    def expand(v):
        v = v.astype(np.uint64) & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (expand(x) | (expand(y) << np.uint64(1)) | (expand(z) << np.uint64(2))).astype(np.uint32)


def _morton_codes(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / extent) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    return morton3d(q[:, 0], q[:, 1], q[:, 2])


def build_bvh_host(tri_v0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
                   max_leaf_size: int = 4, use_native: bool = True,
                   builder: str = "sah") -> HostBVH:
    """use_native: the native library's builder, "sah" (binned SAH —
    better trees) or "lbvh" (Morton); it raises where the library cannot
    be built or loaded.  use_native=False: the NumPy LBVH below."""
    if use_native and tri_v0.shape[0] > 0:
        from vulkan_pathtracer_tpu_torch.ops.native import lbvh_build_native

        (bmin, bmax, skip, leaf_first, leaf_count, left, right,
         tri_order) = lbvh_build_native(tri_v0, tri_e1, tri_e2,
                                        max_leaf_size, builder=builder)
        return HostBVH(
            bmin=bmin, bmax=bmax, skip=skip, leaf_first=leaf_first,
            leaf_count=leaf_count, tri_order=tri_order,
            left_child=left, right_child=right,
        )
    t = tri_v0.shape[0]
    v0 = tri_v0.astype(np.float64)
    v1 = v0 + tri_e1
    v2 = v0 + tri_e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroids = (tmin + tmax) * 0.5

    codes = _morton_codes(centroids)
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    tmin = tmin[order]
    tmax = tmax[order]

    # Prefix min/max would cost memory; per-node slicing is O(n log n)
    # and fast enough in NumPy for scene-scale T.
    bmin_l: list = []
    bmax_l: list = []
    skip_l: list = []
    leaf_first_l: list = []
    leaf_count_l: list = []
    left_l: list = []
    right_l: list = []

    def find_split(start: int, end: int) -> int:
        """Highest-differing-bit split (LBVH), median fallback, snapped
        to leaf-block multiples so leaves fill whole blocks (matches
        native/lbvh.cpp)."""
        first = codes[start]
        last = codes[end - 1]
        if first == last:
            split = (start + end) // 2
        else:
            # Most significant differing bit.
            common = int(first ^ last)
            split_bit = common.bit_length() - 1
            mask = np.uint32(1 << split_bit)
            # First index in [start, end) where the bit flips on.
            seg = codes[start:end] & mask
            idx = int(np.searchsorted(seg, 1))  # seg is 0...0 1...1
            split = start + idx
            if split <= start or split >= end:
                split = (start + end) // 2
        b = max_leaf_size
        rel = split - start
        snapped = ((rel + b // 2) // b) * b
        if snapped <= 0:
            snapped = b
        if start + snapped >= end:
            snapped = ((end - start - 1) // b) * b
        if snapped <= 0:
            snapped = b
        split = start + snapped
        if split >= end:
            split = (start + end) // 2
        return split

    # Iterative preorder emission (explicit stack — deep degenerate
    # scenes must not hit Python's recursion limit; the C++ builders
    # are iterative too).  Emit entries are (start, end, parent,
    # is_right); patch entries (node,) fire once the node's subtree has
    # been fully emitted and set its skip pointer to the next index.
    if t > 0:
        stack: list = [(0, t, -1, False)]
        while stack:
            item = stack.pop()
            if len(item) == 1:
                skip_l[item[0]] = len(bmin_l)
                continue
            start, end, parent, is_right = item
            node = len(bmin_l)
            if parent >= 0:
                if is_right:
                    right_l[parent] = node
                else:
                    left_l[parent] = node
            bmin_l.append(tmin[start:end].min(axis=0))
            bmax_l.append(tmax[start:end].max(axis=0))
            skip_l.append(0)
            stack.append((node,))
            if end - start <= max_leaf_size:
                leaf_first_l.append(start)
                leaf_count_l.append(end - start)
                left_l.append(-1)
                right_l.append(-1)
            else:
                leaf_first_l.append(-1)
                leaf_count_l.append(0)
                left_l.append(0)
                right_l.append(0)
                split = find_split(start, end)
                stack.append((split, end, node, True))
                stack.append((start, split, node, False))

    n = len(bmin_l)
    return HostBVH(
        bmin=np.asarray(bmin_l, dtype=np.float32).reshape(n, 3),
        bmax=np.asarray(bmax_l, dtype=np.float32).reshape(n, 3),
        skip=np.asarray(skip_l, dtype=np.int32),
        leaf_first=np.asarray(leaf_first_l, dtype=np.int32),
        leaf_count=np.asarray(leaf_count_l, dtype=np.int32),
        tri_order=order,
        left_child=np.asarray(left_l, dtype=np.int32),
        right_child=np.asarray(right_l, dtype=np.int32),
    )


def pad_leaves_to_blocks(bvh: HostBVH, block: int = 4):
    """Rewrite leaves to fixed-size triangle blocks.

    Returns (gather_map, new_bvh_leaf_first) where gather_map (T',)
    maps padded triangle slots -> pre-pad triangle indices (-1 for
    padding; callers fill those rows with degenerate triangles that
    can never hit).  Every leaf then covers exactly ``block``
    contiguous slots starting at a block-aligned offset, so traversal
    fetches one packed row per leaf visit instead of per-triangle
    gathers.  bvh.leaf_first is updated in place (build order).
    """
    leaf_nodes = np.nonzero(bvh.leaf_first >= 0)[0]
    firsts = bvh.leaf_first[leaf_nodes]
    counts = bvh.leaf_count[leaf_nodes]
    # Keep triangle blocks in ascending spatial (Morton) order.
    rank = np.argsort(firsts, kind="stable")
    gather_map = np.full(len(leaf_nodes) * block, -1, dtype=np.int64)
    for r, li in enumerate(rank):
        node = leaf_nodes[li]
        f = firsts[li]
        c = counts[li]
        gather_map[r * block: r * block + c] = np.arange(f, f + c)
        bvh.leaf_first[node] = r * block
        bvh.leaf_count[node] = c
    return gather_map


def octant_orders(bvh: HostBVH):
    """8 direction-octant DFS linearizations of a built tree.

    Skip-pointer traversal has a fixed child order; rays moving
    against it hit far geometry first and prune poorly.  Emitting one
    preorder per direction octant — visiting the nearer child (along
    the dominant child-separation axis) first — restores near-to-far
    ordering at the cost of 8x node-array memory and zero per-ray
    state: a ray adds ``octant * node_count`` to its cursor.

    Returns (skip8, leaf_first8, leaf_count8, perm8), each (8, Nn);
    skip values are local (0..Nn); perm maps octant-order -> build
    order.  Native C++ fast path with a Python fallback.
    """
    from vulkan_pathtracer_tpu_torch.ops.native import octant_orders_native

    result = octant_orders_native(
        bvh.bmin, bvh.bmax, bvh.left_child, bvh.right_child,
        bvh.leaf_first, bvh.leaf_count,
    )
    if result is not None:
        return result

    n = bvh.node_count
    center = (bvh.bmin.astype(np.float64) + bvh.bmax) * 0.5
    left = bvh.left_child
    right = bvh.right_child
    # Dominant separation axis + lower child per internal node.
    axis = np.zeros(n, np.int8)
    left_is_lower = np.ones(n, bool)
    internal = left >= 0
    li = np.maximum(left, 0)
    ri = np.maximum(right, 0)
    sep = np.abs(center[ri] - center[li])
    axis = np.argmax(sep, axis=1).astype(np.int8)
    rows = np.arange(n)
    left_is_lower = center[li, axis] <= center[ri, axis]

    skip8 = np.zeros((8, n), np.int32)
    leaf_first8 = np.zeros((8, n), np.int32)
    leaf_count8 = np.zeros((8, n), np.int32)
    perm8 = np.zeros((8, n), np.int32)
    for o in range(8):
        count = 0
        stack = [(0, -1)]  # (node, out-if-patch)
        while stack:
            node, out = stack.pop()
            if out >= 0:
                skip8[o, out] = count
                continue
            me = count
            count += 1
            perm8[o, me] = node
            leaf_first8[o, me] = bvh.leaf_first[node]
            leaf_count8[o, me] = bvh.leaf_count[node]
            stack.append((node, me))
            if internal[node]:
                neg = (o >> axis[node]) & 1
                lower_first = not neg
                first = left[node] if (left_is_lower[node] == lower_first) \
                    else right[node]
                second = right[node] if first == left[node] else left[node]
                stack.append((second, -1))
                stack.append((first, -1))
    _ = rows
    return skip8, leaf_first8, leaf_count8, perm8


def tree_depth(bvh: HostBVH) -> int:
    """Max depth (root = 1), computed iteratively over preorder."""
    n = bvh.node_count
    if n == 0:
        return 0
    depth = np.zeros(n, dtype=np.int32)
    depth[0] = 1
    for i in range(n):
        l, r = bvh.left_child[i], bvh.right_child[i]
        if l >= 0:
            depth[l] = depth[i] + 1
            depth[r] = depth[i] + 1
    return int(depth.max())


def validate_bvh(bvh: HostBVH, tri_v0: np.ndarray, tri_e1: np.ndarray,
                 tri_e2: np.ndarray) -> None:
    """Invariant checks (test support / --enable-validation):

    - every triangle is covered by exactly one leaf range
    - each node's AABB contains its triangles (and its children's AABBs)
    - skip pointers are strictly increasing escape targets
    """
    n = bvh.node_count
    t = tri_v0.shape[0]
    covered = np.zeros(t, dtype=np.int32)
    v0 = tri_v0
    v1 = v0 + tri_e1
    v2 = v0 + tri_e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    eps = 1e-4
    for node in range(n):
        first = bvh.leaf_first[node]
        if first >= 0:
            count = bvh.leaf_count[node]
            covered[first:first + count] += 1
            assert (tmin[first:first + count] >= bvh.bmin[node] - eps).all()
            assert (tmax[first:first + count] <= bvh.bmax[node] + eps).all()
        else:
            l, r = bvh.left_child[node], bvh.right_child[node]
            for c in (l, r):
                assert (bvh.bmin[c] >= bvh.bmin[node] - eps).all()
                assert (bvh.bmax[c] <= bvh.bmax[node] + eps).all()
        assert node < bvh.skip[node] <= n
    assert (covered == 1).all(), "leaf ranges must cover each triangle once"
