"""The reference's own bounding volume hierarchy and walk.

``build_tree`` is a frozen plain build: the triangles sorted by the
30-bit Morton code of their centroids in the scene's box, cut into
leaves of ``LEAF`` consecutive triangles, and a complete binary tree
over the leaves (padded to a power of two with empty leaves), stored as
a heap: node ``i`` has the children ``2i + 1`` and ``2i + 2``, and the
leaves are the last ``L`` nodes.  Each box is the exact box of its
triangles, widened by ``PAD`` of its size and ``PAD`` absolute, so the
walk's float rounding can never cull a box that holds a hit: the
triangle test alone decides.

``walk`` traces rays through the tree with a stack per ray, the nearer
child first, and returns the closest hit (or, with ``any_hit``, whether
there is one) and, per ray, the box tests and triangle tests it made.
The same walk on the same rays makes the same tests, whatever program
produced the rays: the kernel roofline counts its work from it.
Everything here is plain PyTorch (NumPy for the build) and runs on the
CPU or on a card, in float32 or, for the control, bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF = 4
PAD = 1e-4
TMIN = 0.001
TMAX = 10000.0
MISS_T = float(np.float32(1e32))


@dataclass
class Tree:
    lo: torch.Tensor      # (2L - 1, 3) node boxes
    hi: torch.Tensor
    v0: torch.Tensor      # (L * LEAF, 3) triangles in leaf order
    e1: torch.Tensor
    e2: torch.Tensor
    order: torch.Tensor   # (L * LEAF,) triangle id of each slot, -1 padding
    leaves: int
    triangles: int

    @property
    def nodes(self) -> int:
        return 2 * self.leaves - 1


def _morton(q: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (n, 3) integer cells in [0, 1024)."""
    code = np.zeros(q.shape[0], np.int64)
    for bit in range(9, -1, -1):
        for axis in range(3):
            code = (code << 1) | ((q[:, axis] >> bit) & 1)
    return code


def build_tree(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
               device="cpu", dtype=torch.float32) -> Tree:
    """The tree of the triangles ``v0``, ``v0 + e1``, ``v0 + e2`` (f32
    NumPy arrays, (T, 3) each), on ``device`` in ``dtype``."""
    n = v0.shape[0]
    p0 = v0.astype(np.float64)
    p1, p2 = p0 + e1, p0 + e2
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    cent = (tri_lo + tri_hi) * 0.5
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    cells = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64)
    order = np.argsort(_morton(cells), kind="stable")
    leaves = 1 << max(int(np.ceil(np.log2(max(-(-n // LEAF), 1)))), 0)
    slots = leaves * LEAF
    slot_tri = np.full(slots, -1, np.int64)
    slot_tri[:n] = order
    real = slot_tri >= 0
    box_lo = np.full((slots, 3), np.inf)
    box_hi = np.full((slots, 3), -np.inf)
    box_lo[real], box_hi[real] = tri_lo[order], tri_hi[order]
    node_lo = np.full((2 * leaves - 1, 3), np.inf)
    node_hi = np.full((2 * leaves - 1, 3), -np.inf)
    node_lo[leaves - 1:] = box_lo.reshape(leaves, LEAF, 3).min(axis=1)
    node_hi[leaves - 1:] = box_hi.reshape(leaves, LEAF, 3).max(axis=1)
    first = leaves - 1
    while first > 0:
        parents = np.arange((first - 1) // 2, first)
        node_lo[parents] = np.minimum(node_lo[2 * parents + 1],
                                      node_lo[2 * parents + 2])
        node_hi[parents] = np.maximum(node_hi[2 * parents + 1],
                                      node_hi[2 * parents + 2])
        first = (first - 1) // 2
    empty = ~np.isfinite(node_lo).all(axis=1)
    size = np.where(empty[:, None], 0.0, node_hi - node_lo)
    # An empty node is a point far beyond TMAX: no ray enters it.
    node_lo = np.where(empty[:, None], 1e30, node_lo - size * PAD - PAD)
    node_hi = np.where(empty[:, None], 1e30, node_hi + size * PAD + PAD)

    def slot_rows(a):
        out = np.zeros((slots, 3), np.float32)
        out[real] = a[order]
        return torch.as_tensor(out, device=device).to(dtype)

    def dev(a):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    return Tree(lo=dev(node_lo), hi=dev(node_hi), v0=slot_rows(v0),
                e1=slot_rows(e1), e2=slot_rows(e2),
                order=torch.as_tensor(slot_tri, device=device),
                leaves=leaves, triangles=n)


def moller_trumbore(origin, direction, v0, e1, e2, tmin, t_limit):
    """Möller-Trumbore with backface culling (det <= 0 culls), as the
    reference renderer tests a triangle: (hit, t, u, v)."""
    px = direction[..., 1] * e2[..., 2] - direction[..., 2] * e2[..., 1]
    py = direction[..., 2] * e2[..., 0] - direction[..., 0] * e2[..., 2]
    pz = direction[..., 0] * e2[..., 1] - direction[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    front = det > 0.0
    inv_det = 1.0 / torch.where(front, det, torch.ones_like(det))
    tx = origin[..., 0] - v0[..., 0]
    ty = origin[..., 1] - v0[..., 1]
    tz = origin[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (direction[..., 0] * qx + direction[..., 1] * qy
         + direction[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    hit = (front & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < t_limit))
    return hit, t, u, v


def _slab(tree: Tree, node, origin, inv_dir, t_far):
    """(hit, t_enter) of the boxes ``node`` against the rays."""
    t0 = (tree.lo[node] - origin) * inv_dir
    t1 = (tree.hi[node] - origin) * inv_dir
    enter = torch.minimum(t0, t1).amax(dim=-1)
    leave = torch.maximum(t0, t1).amin(dim=-1)
    hit = (enter <= leave) & (leave >= 0.0) & (enter < t_far)
    return hit, enter


def walk(tree: Tree, origin, direction, active=None, any_hit: bool = False,
         count: bool = False):
    """The closest hit of each ray (``t`` = MISS_T where none), as
    (t, triangle id, u, v), or with ``any_hit`` a (N,) bool; with
    ``count`` also (box tests, triangle tests) per ray, int64."""
    n = origin.shape[0]
    dev, dtype = origin.device, origin.dtype
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    best_t = torch.full((n,), MISS_T, dtype=dtype, device=dev)
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=dtype, device=dev)
    best_v = torch.zeros(n, dtype=dtype, device=dev)
    boxes = torch.zeros(n, dtype=torch.int64, device=dev)
    tris = torch.zeros(n, dtype=torch.int64, device=dev)
    tiny = torch.full_like(direction, 1e-30)
    inv_dir = 1.0 / torch.where(direction == 0.0, tiny, direction)
    depth = int(np.log2(tree.leaves)) + 2
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, depth), dtype=dtype, device=dev)
    root = torch.zeros(n, dtype=torch.int64, device=dev)
    hit, enter = _slab(tree, root, origin, inv_dir,
                       torch.full_like(best_t, TMAX))
    boxes += active.long()
    sp = (hit & active).long()
    stack_t[:, 0] = enter
    first_leaf = tree.leaves - 1
    lanes = torch.arange(n, device=dev)
    while True:
        idx = lanes[sp > 0]
        if idx.numel() == 0:
            break
        top = sp[idx] - 1
        node = stack[idx, top]
        t_enter = stack_t[idx, top]
        sp[idx] = top
        o, inv, d = origin[idx], inv_dir[idx], direction[idx]
        limit = torch.clamp(best_t[idx], max=TMAX)
        live = t_enter < limit
        leaf = live & (node >= first_leaf)
        inner = live & (node < first_leaf)
        # Leaves: their LEAF triangles against the nearest hit so far;
        # the nearest of them wins, the first slot of equal t.
        slots = (torch.clamp(node - first_leaf, min=0) * LEAF)[:, None] + \
            torch.arange(LEAF, device=dev)
        lt = best_t[idx]
        h, t, u, v = moller_trumbore(
            o[:, None], d[:, None], tree.v0[slots], tree.e1[slots],
            tree.e2[slots], TMIN, torch.clamp(lt, max=TMAX)[:, None])
        h = h & leaf[:, None]
        t = torch.where(h, t, torch.full_like(t, MISS_T))
        t_min, k = t.min(dim=1)
        better = h.any(dim=1)
        lt = torch.where(better, t_min, lt)
        lslot = torch.where(better, slots.gather(1, k[:, None])[:, 0],
                            best_slot[idx])
        lu = torch.where(better, u.gather(1, k[:, None])[:, 0], best_u[idx])
        lv = torch.where(better, v.gather(1, k[:, None])[:, 0], best_v[idx])
        tris[idx] += leaf.long() * (tree.order[slots] >= 0).sum(dim=1)
        best_t[idx], best_slot[idx], best_u[idx], best_v[idx] = lt, lslot, lu, lv
        # Inner nodes: both children, the nearer pushed last.
        left = 2 * node + 1
        h0, t0 = _slab(tree, torch.where(inner, left, root[idx]), o, inv, lt)
        h1, t1 = _slab(tree, torch.where(inner, left + 1, root[idx]), o, inv,
                       lt)
        boxes[idx] += 2 * inner.long()
        h0, h1 = h0 & inner, h1 & inner
        near_first = t0 <= t1
        far = torch.where(near_first, left + 1, left)
        near = torch.where(near_first, left, left + 1)
        far_t = torch.where(near_first, t1, t0)
        near_t = torch.where(near_first, t0, t1)
        far_h = torch.where(near_first, h1, h0)
        near_h = torch.where(near_first, h0, h1)
        pos = top
        for push, push_t, push_h in ((far, far_t, far_h),
                                     (near, near_t, near_h)):
            stack[idx, pos] = torch.where(push_h, push, stack[idx, pos])
            stack_t[idx, pos] = torch.where(push_h, push_t, stack_t[idx, pos])
            pos = pos + push_h.long()
        if any_hit:
            pos = torch.where(lslot >= 0, torch.zeros_like(pos), pos)
        sp[idx] = pos
    tri = torch.where(best_slot >= 0, tree.order[torch.clamp(best_slot,
                                                             min=0)],
                      torch.full_like(best_slot, -1))
    out = (best_slot >= 0) & active if any_hit else (best_t, tri, best_u,
                                                     best_v)
    return (out, boxes, tris) if count else out
