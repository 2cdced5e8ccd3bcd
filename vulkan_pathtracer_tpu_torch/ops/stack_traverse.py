"""Quad-BVH stack traversal: closest hit and any hit.

Counterpart of ``vulkan_pathtracer_tpu/ops/pallas_pair.py``: its quad
row construction (``_nary_collapse``, ``_build_nary_rows``,
``_assert_depth``, ``STACK_CAP``) and its two width-4 stack kernels
(``_make_nary_kernel`` via ``pallas_quad_closest_hit``, and
``_make_nary_anyhit_kernel`` via ``pallas_quad_any_hit``).

Tables (port-native layout, converted from the JAX layout only at the
boundary, see models/device_scene.scene_from_jax_arrays):

- ``quad_box  (N4, 4, 6) f32``: per row, four child boxes lo.xyz, hi.xyz.
- ``quad_link (N4, 4) int32``: a link >= 0 is a child row, -(leaf+1) a
  leaf block, and ``EMPTY`` (INT32_MIN) an empty slot.  The JAX rows
  mark empty slots with NaN boxes and enc -1 ("leaf 0"), which relies
  on NaN propagating through min/max; CUDA's fminf/fmaxf drop NaN, so
  the port tests emptiness explicitly instead.
- ``leaves (n_leaves, block, 9) f32``: v0, e1, e2 of each triangle;
  triangle id = leaf * block + k.

Traversal semantics (shared by the CUDA kernels in
``csrc/stack_traverse.cu`` and the plain PyTorch versions here, which
perform the same float operations in the same order):

- one ray at a time with its own stack of 3 * STACK_CAP entries; the
  four child boxes of a row are slab-tested (pallas_pair.py:1042-1060),
  hit leaf slots run Möller–Trumbore in slot order
  (pallas_pair.py:970-992), hit internal slots are visited near-first
  by entry distance (stable on ties) and the rest pushed far-to-near;
- a popped node whose stored entry distance exceeds the current
  min(t_best, t_lane) is skipped: its children's boxes lie inside its
  box, so none of them could pass the slab test (exact);
- an inactive lane (t_lane < 0) returns a miss without traversing;
- any hit uses t_lim = t_lane throughout and stops at the first
  accepted triangle, so its bit equals ``closest.t < MISS_T``.

The wrappers dispatch on the device of the rays: CPU tensors run the
plain version, CUDA tensors launch the kernel, anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import Hit, MISS_T, TMAX, TMIN

STACK_CAP = 96   # >= binary tree depth; build_quad_tables asserts it
STACK_SIZE = 3 * STACK_CAP  # per-ray entries: <= 3 pushes per quad level
EMPTY = -(2 ** 31)
BIG = float(np.float32(3e38))
INV_EPS = 1e-20

# Kernel launches per wrapper (CUDA path only).  chip_smoke.py zeroes
# these before the main path and reads them after it.
LAUNCHES = {"quad_closest_hit": 0, "quad_any_hit": 0}


def _assert_depth(depth: int, what: str) -> None:
    if depth > STACK_CAP:
        raise ValueError(
            f"{what}: tree depth {depth} exceeds the per-ray stack "
            f"capacity {STACK_CAP}")


def _nary_collapse(bvh, width: int):
    """Collapse log2(width) binary levels per super-node (the walk of
    pallas_pair._nary_collapse, so row numbering is identical: DFS,
    slots expanded left to right, root = row 0).  Returns
    (super_row: node id -> row, children: [(node, [(kind, id)...])])."""
    internal = bvh.left_child >= 0
    if not internal[0]:
        raise ValueError("n-ary rows need an internal root")
    levels = width.bit_length() - 1
    super_row = {}
    children = []
    stack = [0]
    while stack:
        node = stack.pop()
        if node in super_row:
            continue
        super_row[node] = len(children)
        slots = [int(bvh.left_child[node]), int(bvh.right_child[node])]
        for _ in range(levels - 1):
            nxt = []
            for s in slots:
                if internal[s]:
                    nxt.append(int(bvh.left_child[s]))
                    nxt.append(int(bvh.right_child[s]))
                else:
                    nxt.append(s)
            slots = nxt
        kids = []
        for s in slots:
            if internal[s]:
                kids.append(("super", s))
                stack.append(s)
            else:
                kids.append(("leaf", s))
        children.append((node, kids))
    return super_row, children


def build_quad_tables(bvh, block: int):
    """(quad_box (N4, 4, 6) f32, quad_link (N4, 4) int32) for a binary
    host BVH whose leaves are block-aligned (ops/bvh.pad_leaves_to_blocks).

    Empty slots hold a zero box and the EMPTY link.  A tree whose root
    is a leaf becomes one row holding that leaf in slot 0."""
    from vulkan_pathtracer_tpu.ops.bvh import tree_depth

    _assert_depth(tree_depth(bvh), "build_quad_tables")
    if bvh.left_child[0] < 0:
        box = np.zeros((1, 4, 6), np.float32)
        link = np.full((1, 4), EMPTY, np.int32)
        box[0, 0, 0:3] = bvh.bmin[0]
        box[0, 0, 3:6] = bvh.bmax[0]
        link[0, 0] = -(int(bvh.leaf_first[0]) // block + 1)
        return box, link
    super_row, children = _nary_collapse(bvh, 4)
    box = np.zeros((len(children), 4, 6), np.float32)
    link = np.full((len(children), 4), EMPTY, np.int32)
    for node, kids in children:
        r = super_row[node]
        for s, (kind, cid) in enumerate(kids):
            box[r, s, 0:3] = bvh.bmin[cid]
            box[r, s, 3:6] = bvh.bmax[cid]
            if kind == "super":
                link[r, s] = super_row[cid]
            else:
                link[r, s] = -(int(bvh.leaf_first[cid]) // block + 1)
    return box, link


# -- plain PyTorch versions -------------------------------------------------

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-20 replaced by +-1e-20 (pallas_pair.py:912)."""
    eps = torch.full_like(d, INV_EPS)
    sub = torch.where(d >= 0, eps, -eps)
    return 1.0 / torch.where(torch.abs(d) < INV_EPS, sub, d)


def _leaf_mt(tri9, o, d):
    """Möller–Trumbore of rays (M, 1, 3) against leaf triangles
    (M, block, 9), term for term as the kernel's leaf loop.
    Returns (front & barycentric window, t, u, v), each (M, block)."""
    v0x, v0y, v0z = tri9[..., 0], tri9[..., 1], tri9[..., 2]
    e1x, e1y, e1z = tri9[..., 3], tri9[..., 4], tri9[..., 5]
    e2x, e2y, e2z = tri9[..., 6], tri9[..., 7], tri9[..., 8]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det > 0.0
    inv_det = 1.0 / torch.where(front, det, torch.ones_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = front & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > TMIN)
    return ok, t, u, v


def _traverse_plain(quad_box, quad_link, leaves, origin, direction,
                    t_lane, any_hit: bool, leaf_visits=None):
    """Per-ray stack traversal with tensor ops: every live ray advances
    one node per iteration.  Returns (t, tri, u, v) for closest hit or
    a bool tensor for any hit."""
    dev = origin.device
    n = origin.shape[0]
    block = leaves.shape[1]
    inv = _safe_inv(direction)
    oxi = origin * inv

    t_best = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    resolved = torch.zeros(n, dtype=torch.bool, device=dev)

    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    stack_tn = torch.zeros((n, STACK_SIZE), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.where(t_lane >= 0, 0, -1).to(torch.int64)
    cur_tn = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)

    while True:
        idx = torch.nonzero(cur >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        c = cur[idx]
        tl = t_lane[idx]
        t_lim = tl if any_hit else torch.minimum(t_best[idx], tl)
        visit = cur_tn[idx] <= t_lim

        b = quad_box[c]
        lk = quad_link[c]
        inv_i = inv[idx][:, None, :]
        oxi_i = oxi[idx][:, None, :]
        t0 = b[..., 0:3] * inv_i - oxi_i
        t1 = b[..., 3:6] * inv_i - oxi_i
        mn = torch.minimum(t0, t1)
        mx = torch.maximum(t0, t1)
        tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                           torch.clamp(mn[..., 2], min=TMIN))
        tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]),
                           torch.minimum(mx[..., 2], t_lim[:, None]))
        slot_hit = (tn <= tf) & (lk != EMPTY) & visit[:, None]

        done = torch.zeros(idx.shape[0], dtype=torch.bool, device=dev)
        for s in range(4):
            m = slot_hit[:, s] & (lk[:, s] < 0)
            if any_hit:
                m = m & ~done
            j = torch.nonzero(m).squeeze(1)
            if j.numel() == 0:
                continue
            rays = idx[j]
            leaf = (-lk[j, s] - 1).to(torch.int64)
            if leaf_visits is not None:
                leaf_visits.index_add_(
                    0, leaf, torch.ones_like(leaf, dtype=leaf_visits.dtype))
            ok, t, u, v = _leaf_mt(leaves[leaf], origin[rays][:, None, :],
                                   direction[rays][:, None, :])
            tl_r = t_lane[rays]
            lim = tl_r if any_hit else torch.minimum(t_best[rays], tl_r)
            acc = ok & (t < lim[:, None])
            found = acc.any(dim=1)
            if any_hit:
                done[j] = found
                continue
            k = torch.argmin(torch.where(acc, t, torch.full_like(t, BIG)),
                             dim=1)
            sel = torch.nonzero(found).squeeze(1)
            ks = k[sel]
            rs = rays[sel]
            t_best[rs] = t[sel, ks]
            u_best[rs] = u[sel, ks]
            v_best[rs] = v[sel, ks]
            tri_best[rs] = (leaf[sel] * block + ks).to(torch.int32)

        keys = torch.where(slot_hit & (lk >= 0), tn, big)
        skeys, order = torch.sort(keys, dim=1, stable=True)
        child = torch.gather(lk, 1, order).to(torch.int64)
        live = skeys < BIG
        sp_i = sp[idx]
        for s in (3, 2, 1):
            w = torch.nonzero(live[:, s]).squeeze(1)
            stack[idx[w], sp_i[w]] = child[w, s]
            stack_tn[idx[w], sp_i[w]] = skeys[w, s]
            sp_i = sp_i + live[:, s].to(torch.int64)
        desc = live[:, 0]
        new_cur = torch.where(desc, child[:, 0], -1)
        new_tn = skeys[:, 0].clone()
        pop = torch.nonzero(~desc & (sp_i > 0)).squeeze(1)
        top = sp_i[pop] - 1
        new_cur[pop] = stack[idx[pop], top]
        new_tn[pop] = stack_tn[idx[pop], top]
        sp_i[pop] = top
        if any_hit:
            resolved[idx] = done
            new_cur = torch.where(done, -1, new_cur)
        cur[idx] = new_cur
        cur_tn[idx] = new_tn
        sp[idx] = sp_i
    if any_hit:
        return resolved
    return t_best, tri_best, u_best, v_best


def quad_closest_hit_plain(quad_box, quad_link, leaves, origin, direction,
                           t_lane, leaf_visits=None) -> Hit:
    """Plain version of the closest-hit kernel (any device)."""
    t, tri, u, v = _traverse_plain(quad_box, quad_link, leaves, origin,
                                   direction, t_lane, False, leaf_visits)
    return Hit(t=t, tri=tri, u=u, v=v)


def quad_any_hit_plain(quad_box, quad_link, leaves, origin, direction,
                       t_lane, leaf_visits=None) -> torch.Tensor:
    """Plain version of the any-hit kernel (any device): (N,) bool."""
    return _traverse_plain(quad_box, quad_link, leaves, origin, direction,
                           t_lane, True, leaf_visits)


# -- wrappers ---------------------------------------------------------------

def lane_limits(n: int, active, device) -> torch.Tensor:
    """Per-ray t limit: TMAX, or -1 (inactive) where ``active`` is False."""
    t_lane = torch.full((n,), TMAX, dtype=torch.float32, device=device)
    if active is not None:
        t_lane = torch.where(active, t_lane,
                             torch.full_like(t_lane, -1.0))
    return t_lane


def quad_closest_hit(scene, origin, direction, active=None) -> Hit:
    """Closest hit over the scene's quad tables (pallas_quad_closest_hit).
    Inactive lanes return t = MISS_T, tri = -1, u = v = 0."""
    t_lane = lane_limits(origin.shape[0], active, origin.device)
    kind = origin.device.type
    if kind == "cpu":
        return quad_closest_hit_plain(scene.quad_box, scene.quad_link,
                                      scene.leaves, origin, direction, t_lane)
    if kind == "cuda":
        from vulkan_pathtracer_tpu_torch.ops import kernels

        t, tri, u, v = kernels.quad_closest_hit(
            scene.quad_box, scene.quad_link, scene.leaves, origin, direction,
            t_lane)
        LAUNCHES["quad_closest_hit"] += 1
        return Hit(t=t, tri=tri, u=u, v=v)
    raise ValueError(f"quad_closest_hit: no traversal for device type "
                     f"{kind!r} (cpu runs the plain version, cuda the kernel)")


def quad_any_hit(scene, origin, direction, active=None) -> torch.Tensor:
    """Occlusion (N,) bool: True exactly where quad_closest_hit reports
    t < MISS_T (pallas_quad_any_hit).  Inactive lanes return False."""
    t_lane = lane_limits(origin.shape[0], active, origin.device)
    kind = origin.device.type
    if kind == "cpu":
        return quad_any_hit_plain(scene.quad_box, scene.quad_link,
                                  scene.leaves, origin, direction, t_lane)
    if kind == "cuda":
        from vulkan_pathtracer_tpu_torch.ops import kernels

        hit = kernels.quad_any_hit(scene.quad_box, scene.quad_link,
                                   scene.leaves, origin, direction, t_lane)
        LAUNCHES["quad_any_hit"] += 1
        return hit
    raise ValueError(f"quad_any_hit: no traversal for device type "
                     f"{kind!r} (cpu runs the plain version, cuda the kernel)")
