"""Stack traversal of the pair (BVH2), quad (BVH4) and oct (BVH8)
tables: closest hit and any hit.

Counterpart of ``vulkan_pathtracer_tpu/ops/pallas_pair.py``: its row
construction (``build_pair_rows``, ``build_pair_rows_preorder``,
``pair_static_maps_preorder``, ``_nary_collapse``, ``_build_nary_rows``
for ``build_quad_rows`` and ``build_oct_rows``, ``_assert_depth``,
``STACK_CAP``) and five of its stack kernels: ``_make_nary_kernel`` at
width 4 and 8 (``pallas_quad_closest_hit``, ``pallas_oct_closest_hit``),
the width-4 ``_make_nary_anyhit_kernel`` (``pallas_quad_any_hit``), and
the BVH2 ``_make_pair_kernel`` / ``_make_pair_anyhit_kernel``
(``pallas_pair_closest_hit`` / ``pallas_pair_any_hit``), which carry the
instanced leaf decode of two-level scenes.  The quad and pair kernels
also take the coefficient leaf test of ``VKPT_MT=mxu`` (ops/mxu_mt.py);
the oct kernel runs exact leaves only, as JAX's oct launcher does.

Tables (port-native layout, converted from the JAX layout only at the
boundary, see models/device_scene.scene_from_jax_arrays):

- ``quad_box  (N4, 4, 6) f32``: per row, four child boxes lo.xyz, hi.xyz.
- ``quad_link (N4, 4) int32``: a link >= 0 is a child row, -(leaf+1) a
  leaf block, and ``EMPTY`` (INT32_MIN) an empty slot.  The JAX rows
  mark empty slots with NaN boxes and enc -1 ("leaf 0"), which relies
  on NaN propagating through min/max; CUDA's fminf/fmaxf drop NaN, so
  the port tests emptiness explicitly instead.
- ``oct_box (N8, 8, 6)`` / ``oct_link (N8, 8)``: the same for the
  8-wide collapse (three binary levels per row); the frontier tables
  of ops/frontier.py are the 16- and 32-wide ones.
- ``pair_box (Ni, 2, 6) f32`` / ``pair_link (Ni, 2) int32``: the two
  children of each internal node, rows in preorder rank (root = row 0).
  A link >= 0 is a child row, -(leaf_value+1) a leaf.  ``leaf_value``
  is a leaf block for flat scenes and the packed ``inst << mb_bits |
  mesh_block`` of two-level scenes (models/instanced_scene.py), copied
  verbatim; a pair row has no empty slot.
- ``leaves (n_blocks, block, 9) f32``: v0, e1, e2 of each triangle,
  indexed by the leaf block (``leaf_value & (2^mb_bits - 1)`` when
  instanced); the returned triangle id is ``leaf_value * block + k``.
  A ``(n_blocks, block, 20)`` table in its place is the coefficient
  table ``tri_coefs`` (ops/mxu_mt.py), and selects the coefficient
  leaf test; two-level scenes then also pass ``inst_feat``.
- ``inst_inv (I, 16) f32`` (instanced only): the world-to-object
  matrix row-major (0:9), its translation (9:12) and the sign of the
  object-to-world determinant (12).

Traversal semantics (shared by the CUDA kernels in ``csrc/`` and the
plain PyTorch versions here, which perform the same float operations in
the same order):

- one ray at a time with its own stack of STACK_SLOTS[width] entries
  (width - 1 per collapsed level; the bakes refuse deeper trees); the
  child boxes of a row are slab-tested
  (pallas_pair.py:644-651, :1042-1060); hit internal children are
  visited near-first by entry distance (stable on ties) and the rest
  pushed far-to-near;
- hit leaf children run Möller–Trumbore: in slot order in an n-ary
  row (pallas_pair.py:970-992), nearer-first in a pair row
  (pallas_pair.py:805-831);
- hit internal children of an n-ary row are ordered by a stable sort
  of their entry distances, or by a given comparator network (the
  frontier kernels' Batcher network, ops/frontier.py);
- instanced leaves transform the ray into object space first, with
  the 13 ``inst_inv`` floats in the JAX order of operations
  (pallas_pair.py:661-673), and cull by ``det * det_sign > 0``
  (:697-700), the world-winding rule under mirroring transforms;
- a popped node whose stored entry distance exceeds the current
  min(t_best, t_lane) is skipped: its children's boxes lie inside its
  box, so none of them could pass the slab test (exact);
- an inactive lane (t_lane < 0) returns a miss without traversing;
- any hit uses t_lim = t_lane throughout and stops at the first
  accepted triangle, so its bit equals ``closest.t < MISS_T``; the quad
  and pair any hits visit hit children, leaves and internal nodes, in
  slot order (the order does not change the bit, and with a fixed limit
  no popped node is ever culled).

The wrappers dispatch on the device of the rays: CPU tensors run the
plain version, CUDA tensors launch the kernel, anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vulkan_pathtracer_tpu_torch.ops import mxu_mt
from vulkan_pathtracer_tpu_torch.ops.bvh import tree_depth
from vulkan_pathtracer_tpu_torch.ops.intersect import Hit, MISS_T, TMAX, TMIN

STACK_CAP = 96   # >= binary tree depth; the table builders assert it
# Per-ray stack entries of the kernels by table width: one push per
# level for a pair row, else width - 1 per collapsed level, with the
# collapsed depth <= ceil((STACK_CAP - 1) / log2(width)) for any tree of
# depth <= STACK_CAP (the quad kernel keeps 3 * STACK_CAP).  Mirrored in
# csrc/stack_walk.cuh and csrc/frontier_traverse.cu.
STACK_SLOTS = {2: STACK_CAP, 4: 3 * STACK_CAP, 8: 7 * 32, 16: 15 * 24,
               32: 31 * 19}
EMPTY = -(2 ** 31)
BIG = float(np.float32(3e38))
INV_EPS = 1e-20

# Kernel launches per wrapper (CUDA path only), this module's,
# ops/skip_traverse.py's and ops/frontier.py's; a ``_coef`` key counts
# the kernel built with coefficient leaves.  chip_smoke.py zeroes these
# before a main path and reads them after it.
LAUNCHES = {"quad_closest_hit": 0, "quad_any_hit": 0,
            "pair_closest_hit": 0, "pair_any_hit": 0,
            "skip_closest_hit": 0, "wide_closest_hit": 0,
            "oct_closest_hit": 0, "frontier_closest_hit": 0,
            "frontier_any_hit": 0, "quad_closest_hit_coef": 0,
            "quad_any_hit_coef": 0, "pair_closest_hit_coef": 0,
            "pair_any_hit_coef": 0, "frontier_closest_hit_coef": 0,
            "frontier_any_hit_coef": 0}


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


def collapse_maps(bvh, block: int, width: int):
    """(src (Nw, width) int64, link (Nw, width) int32) of the width-ary
    collapse of a binary host BVH whose leaves are block-aligned
    (ops/bvh.pad_leaves_to_blocks), in one walk: ``src`` is the
    build-order node of each slot, -1 in an empty slot, and ``link`` a
    child's row, -(leaf block + 1), or EMPTY — the static (src, enc)
    maps of pallas_pair._nary_static_maps /
    pallas_frontier.frontier_static_maps in the port's layout.  A tree
    whose root is a leaf becomes one row holding that leaf in slot 0.
    Raises ValueError when a kernel's per-ray stack
    (STACK_SLOTS[width]) could overflow on the collapsed tree."""
    what = f"collapse_maps(width={width})"
    _assert_depth(tree_depth(bvh), what)
    if bvh.left_child[0] < 0:
        src = np.full((1, width), -1, np.int64)
        link = np.full((1, width), EMPTY, np.int32)
        src[0, 0] = 0
        link[0, 0] = -(int(bvh.leaf_first[0]) // block + 1)
        return src, link
    super_row, children = _nary_collapse(bvh, width)
    src = np.full((len(children), width), -1, np.int64)
    link = np.full((len(children), width), EMPTY, np.int32)
    depth = np.zeros(len(children), np.int64)
    depth[0] = 1
    for node, kids in children:
        r = super_row[node]
        for s, (kind, cid) in enumerate(kids):
            src[r, s] = cid
            if kind == "super":
                link[r, s] = super_row[cid]
                depth[super_row[cid]] = depth[r] + 1
            else:
                link[r, s] = -(int(bvh.leaf_first[cid]) // block + 1)
    need = (width - 1) * (int(depth.max()) - 1)
    if need > STACK_SLOTS[width]:
        raise ValueError(
            f"{what}: collapsed depth {int(depth.max())} needs {need} "
            f"stack entries, more than the kernels' {STACK_SLOTS[width]}")
    return src, link


def host_boxes(bvh):
    """(bmin, bmax) (Nn, 3) f32 CPU tensors of a host BVH's node boxes."""
    return (torch.from_numpy(np.ascontiguousarray(bvh.bmin, np.float32)),
            torch.from_numpy(np.ascontiguousarray(bvh.bmax, np.float32)))


def build_nary_tables(bvh, block: int, width: int):
    """(box (Nw, width, 6) f32, link (Nw, width) int32, src) of the
    width-ary collapse (pallas_pair._build_nary_rows in the port's
    layout): collapse_maps, the boxes boxes_from_src of its src (a zero
    box in an empty slot)."""
    src, link = collapse_maps(bvh, block, width)
    box = boxes_from_src(*host_boxes(bvh), torch.from_numpy(src))
    return box.numpy(), link, src


def boxes_from_src(bmin: torch.Tensor, bmax: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """(..., 6) f32 child boxes lo | hi of the build-order node boxes
    ``bmin``/``bmax`` (Nn, 3) through a static map ``src``, zero where
    src < 0: a pair, quad or oct table's boxes regenerated on the
    boxes' device (pallas_pair.build_pair_rows_device,
    _build_nary_rows_device)."""
    at = src.clamp(min=0)
    box = torch.cat([bmin[at], bmax[at]], dim=-1)
    return torch.where((src >= 0).unsqueeze(-1), box,
                       torch.zeros_like(box)).contiguous()


def build_quad_tables(bvh, block: int):
    """(quad_box (N4, 4, 6) f32, quad_link (N4, 4) int32, quad_src): the
    4-wide collapse (pallas_pair.build_quad_rows)."""
    return build_nary_tables(bvh, block, 4)


def build_oct_tables(bvh, block: int):
    """(oct_box (N8, 8, 6) f32, oct_link (N8, 8) int32, oct_src): the
    8-wide collapse (pallas_pair.build_oct_rows)."""
    return build_nary_tables(bvh, block, 8)


def nary_tables_from_jax(rows: np.ndarray, width: int):
    """A JAX n-ary row table (Nw, 8 * width) — boxes, then the enc links
    as f32 values, NaN boxes in empty slots — as (box, link) with the
    EMPTY sentinel and zero boxes in empty slots."""
    n = rows.shape[0]
    box = rows[:, :6 * width].reshape(n, width, 6).astype(np.float32)
    enc = rows[:, 6 * width:7 * width]
    empty = np.isnan(box[:, :, 0])
    link = np.where(empty, EMPTY, enc.astype(np.int64)).astype(np.int32)
    box = np.where(empty[:, :, None], np.float32(0.0), box)
    return box, link


def _pair_tables(bmin, bmax, left, right, leaf_value):
    """(pair_box, pair_link, src) over a binary tree in preorder whose
    internal nodes have leaf_value < 0 (``left``/``right`` indexed by
    node, read at internal nodes only).  Rows follow preorder rank among
    internal nodes (pallas_pair.build_pair_rows); src (Ni, 2) int64 holds
    each row's two child node ids.  A tree whose root is a leaf becomes
    one row holding that leaf in both slots (JAX has no pair rows for
    it): the second visit can neither change a closest hit nor an
    occlusion bit."""
    leaf_value = np.asarray(leaf_value, np.int64)
    internal = leaf_value < 0
    if not internal[0]:
        src = np.zeros((1, 2), np.int64)
    else:
        idx = np.nonzero(internal)[0]
        src = np.stack([np.asarray(left)[idx], np.asarray(right)[idx]],
                       axis=1).astype(np.int64)
    row_of = np.cumsum(internal) - 1
    box = np.concatenate([bmin[src], bmax[src]], axis=2).astype(np.float32)
    link = np.where(internal[src], row_of[src], -(leaf_value[src] + 1))
    return box, link.astype(np.int32), src


def build_pair_tables(bvh, block: int):
    """(pair_box, pair_link, pair_src) of a binary host BVH in build
    order, whose leaves are block-aligned: the flat bake's pair table
    (pallas_pair.build_pair_rows, device_scene.py:698) and the
    build-order children of each row (a root leaf: its one row holds
    node 0 twice)."""
    _assert_depth(tree_depth(bvh), "build_pair_tables")
    leaf_value = np.where(bvh.leaf_first >= 0, bvh.leaf_first // block, -1)
    return _pair_tables(bvh.bmin, bvh.bmax, bvh.left_child, bvh.right_child,
                        leaf_value)


def _preorder_depth(internal, left, right) -> int:
    """Max depth (root = 1) of a preorder tree given its internal
    nodes' child indices (pallas_pair._preorder_depth)."""
    depth = np.zeros(internal.shape[0], np.int32)
    depth[0] = 1
    idx = np.nonzero(internal)[0]
    for i, l, r in zip(idx, left, right):
        depth[l] = depth[r] = depth[i] + 1
    return int(depth.max()) if depth.size else 0


def build_pair_tables_preorder(bmin, bmax, skip_local, leaf_value):
    """(pair_box, pair_link, src) from ONE preorder + skip linearization
    (pallas_pair.build_pair_rows_preorder and
    pair_static_maps_preorder): left(n) = n + 1, right(n) =
    skip(n + 1); leaf_value >= 0 marks a leaf and is stored verbatim.
    ``src`` is the static map that regenerates the boxes after the node
    boxes move (models/instanced_scene.update_instance_transforms)."""
    leaf_value = np.asarray(leaf_value, np.int64)
    internal = leaf_value < 0
    idx = np.nonzero(internal)[0]
    n = leaf_value.shape[0]
    left = np.zeros(n, np.int64)
    right = np.zeros(n, np.int64)
    left[idx] = idx + 1
    right[idx] = np.asarray(skip_local)[idx + 1]
    _assert_depth(_preorder_depth(internal, left[idx], right[idx]),
                  "build_pair_tables_preorder")
    return _pair_tables(bmin, bmax, left, right, leaf_value)


# -- plain PyTorch versions -------------------------------------------------

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-20 replaced by +-1e-20 (pallas_pair.py:912)."""
    eps = torch.full_like(d, INV_EPS)
    sub = torch.where(d >= 0, eps, -eps)
    return 1.0 / torch.where(torch.abs(d) < INV_EPS, sub, d)


def _leaf_mt(tri9, o, d, det_sign=None, exits=None):
    """Möller–Trumbore of rays (M, 1, 3) against leaf triangles
    (M, block, 9), term for term as the kernel's leaf loop; with
    ``det_sign`` (M, 1) the front test is det * det_sign > 0.
    Returns (front & barycentric window, t, u, v), each (M, block).
    ``exits``, a dict, counts the triangles at which the kernels'
    early-exit test (traverse.cuh mt, EARLY) stops: at the back face
    (``tri_back``), at u (``tri_u``), at v (``tri_v``)."""
    v0x, v0y, v0z = tri9[..., 0], tri9[..., 1], tri9[..., 2]
    e1x, e1y, e1z = tri9[..., 3], tri9[..., 4], tri9[..., 5]
    e2x, e2y, e2z = tri9[..., 6], tri9[..., 7], tri9[..., 8]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det > 0.0 if det_sign is None else det * det_sign > 0.0
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
    if exits is not None:
        u_ok = front & (u >= 0.0) & (u <= 1.0)
        exits["tri_back"] += int((~front).sum())
        exits["tri_u"] += int((front & ~u_ok).sum())
        exits["tri_v"] += int((u_ok & ~((v >= 0.0) & (u + v <= 1.0))).sum())
    return ok, t, u, v


def _object_rays(inst_inv, mb_bits: int, leaf, o, d):
    """Instanced leaf decode (pallas_pair.py:661-673): block row of the
    packed leaf value, the ray in the instance's object space (same
    operation order as the kernel) and det_sign.  o, d: (M, 3)."""
    row = leaf & ((1 << mb_bits) - 1)
    m = inst_inv[leaf >> mb_bits]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    mo = torch.stack([m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 9],
                      m[:, 3] * ox + m[:, 4] * oy + m[:, 5] * oz + m[:, 10],
                      m[:, 6] * ox + m[:, 7] * oy + m[:, 8] * oz + m[:, 11]],
                     dim=1)
    md = torch.stack([m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz,
                      m[:, 3] * dx + m[:, 4] * dy + m[:, 5] * dz,
                      m[:, 6] * dx + m[:, 7] * dy + m[:, 8] * dz], dim=1)
    return row, mo, md, m[:, 12]


def _sort_children(keys, lk, sortnet):
    """(sorted keys, children) of a row's internal slots: a stable sort,
    or the comparator network ``sortnet`` swapping on ``<=`` as the
    frontier kernels do (pallas_frontier.py:503-518)."""
    if sortnet is None:
        skeys, order = torch.sort(keys, dim=1, stable=True)
        return skeys, torch.gather(lk, 1, order)
    ks = list(keys.unbind(1))
    cs = list(lk.unbind(1))
    for a, b in sortnet:
        lt = ks[a] <= ks[b]
        ks[a], ks[b] = (torch.where(lt, ks[a], ks[b]),
                        torch.where(lt, ks[b], ks[a]))
        cs[a], cs[b] = (torch.where(lt, cs[a], cs[b]),
                        torch.where(lt, cs[b], cs[a]))
    return torch.stack(ks, dim=1), torch.stack(cs, dim=1)


def _coef_rays(inst_inv, inst_feat, mb_bits: int, leaf, o, d):
    """(block row, features (M, 10), det_sign (M,) or None) of a
    coefficient leaf visit: the world features, or on a two-level scene
    the instance's feature transform of them (csrc/stack_walk.cuh
    LeafTest::visit, with traverse.cuh object_features)."""
    feats = mxu_mt.ray_features(o, d)
    if inst_inv is None:
        return leaf, feats, None
    inst = leaf >> mb_bits
    feats = mxu_mt.object_features(inst_feat[inst], feats)
    return leaf & ((1 << mb_bits) - 1), feats, inst_inv[inst, 12]


def _traverse_plain(box, link, leaves, origin, direction, t_lane,
                    any_hit: bool, near_leaves: bool, inst_inv=None,
                    mb_bits: int = 0, leaf_visits=None, stats=None,
                    inst_feat=None, sortnet=None, slot_order: bool = False):
    """Per-ray stack traversal with tensor ops over a width-W table
    (W = box.shape[1]): every live ray advances one node per iteration.
    ``near_leaves`` orders a row's leaf children by entry distance (the
    pair kernels) instead of by slot (the n-ary kernels); ``sortnet``
    orders internal children by that comparator network instead of a
    stable sort; ``slot_order`` (an any hit) visits them in slot order
    and culls no popped node (the quad any-hit kernel).  ``leaves``
    with mxu_mt.COLS columns is a coefficient table (the coefficient
    leaf test; ``inst_feat`` on two-level scenes).  ``stats``, a dict,
    accumulates node visits (row loads), leaf-block visits, the early
    exits of the triangle test (exact leaves: _leaf_mt's; coefficient
    leaves: mxu_mt._count_exits, with the triangles tested), on
    two-level scenes the leaf visits whose instance differs from the
    ray's previous leaf visit (``instance_changes``), and (``sortnet``)
    the visited nodes with 0, 1, 2 or more hit internal children
    (``inner_0`` .. ``inner_2``; the network has work only at the
    last).  Returns (t, tri, u, v) for closest hit or a bool tensor for
    any hit."""
    dev = origin.device
    n = origin.shape[0]
    width = box.shape[1]
    block = leaves.shape[1]
    coef = leaves.shape[2] == mxu_mt.COLS
    inv = _safe_inv(direction)
    oxi = origin * inv

    t_best = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    resolved = torch.zeros(n, dtype=torch.bool, device=dev)

    stack_size = STACK_SLOTS[width]
    stack = torch.zeros((n, stack_size), dtype=torch.int64, device=dev)
    stack_tn = torch.zeros((n, stack_size), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.where(t_lane >= 0, 0, -1).to(torch.int64)
    cur_tn = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    slots = torch.arange(width, dtype=torch.float32, device=dev)
    if stats is not None:
        for key in ("node_visits", "leaf_visits", "tri_tested",
                    "tri_back", "tri_u", "tri_v", "instance_changes") + (
                        ("inner_0", "inner_1", "inner_2")
                        if sortnet is not None else ()):
            stats.setdefault(key, 0)
        # Two-level: each ray's last instance, for instance_changes.
        last_inst = torch.full((n,), -1, dtype=torch.int64, device=dev)

    while True:
        idx = torch.nonzero(cur >= 0).squeeze(1)
        if idx.numel() == 0:
            break
        c = cur[idx]
        tl = t_lane[idx]
        t_lim = tl if any_hit else torch.minimum(t_best[idx], tl)
        visit = (torch.ones_like(tl, dtype=torch.bool) if slot_order
                 else cur_tn[idx] <= t_lim)
        if stats is not None:
            stats["node_visits"] += int(visit.sum())

        b = box[c]
        lk = link[c]
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
        if stats is not None and sortnet is not None:
            inner = (slot_hit & (lk >= 0)).sum(dim=1)[visit].clamp(max=2)
            for k in range(3):
                stats[f"inner_{k}"] += int((inner == k).sum())

        if near_leaves:
            _, leaf_order = torch.sort(torch.where(slot_hit, tn, big), dim=1,
                                       stable=True)
        else:
            leaf_order = torch.arange(width, device=dev).expand(
                idx.shape[0], width)
        lk_o = torch.gather(lk, 1, leaf_order)
        hit_o = torch.gather(slot_hit, 1, leaf_order)
        done = torch.zeros(idx.shape[0], dtype=torch.bool, device=dev)
        for s in range(width):
            m = hit_o[:, s] & (lk_o[:, s] < 0)
            if any_hit:
                m = m & ~done
            j = torch.nonzero(m).squeeze(1)
            if j.numel() == 0:
                continue
            rays = idx[j]
            leaf = (-lk_o[j, s] - 1).to(torch.int64)
            if stats is not None:
                stats["leaf_visits"] += j.numel()
                if inst_inv is not None:
                    inst = leaf >> mb_bits
                    stats["instance_changes"] += int(
                        (inst != last_inst[rays]).sum())
                    last_inst[rays] = inst
            o_r, d_r = origin[rays], direction[rays]
            tl_r = t_lane[rays]
            if coef:
                row, feats, det_sign = _coef_rays(inst_inv, inst_feat,
                                                  mb_bits, leaf, o_r, d_r)
            else:
                det_sign = None
                row = leaf
                if inst_inv is not None:
                    row, o_r, d_r, det_sign = _object_rays(
                        inst_inv, mb_bits, leaf, o_r, d_r)
                    det_sign = det_sign[:, None]
            if leaf_visits is not None:
                leaf_visits.index_add_(
                    0, row, torch.ones_like(row, dtype=leaf_visits.dtype))
            if coef and any_hit:
                done[j] = mxu_mt.coef_leaf_any(leaves[row], feats, tl_r,
                                               det_sign, stats)
                continue
            if coef:
                ok, t, u, v = mxu_mt.coef_leaf_mt(leaves[row], feats,
                                                  det_sign, stats)
            else:
                ok, t, u, v = _leaf_mt(leaves[row], o_r[:, None, :],
                                       d_r[:, None, :], det_sign, stats)
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

        keys = torch.where(slot_hit & (lk >= 0), slots if slot_order else tn,
                           big)
        skeys, child = _sort_children(keys, lk, sortnet)
        child = child.to(torch.int64)
        live = skeys < BIG
        sp_i = sp[idx]
        for s in range(width - 1, 0, -1):
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
                           t_lane, leaf_visits=None, stats=None) -> Hit:
    """Plain version of the quad closest-hit kernel (any device); a
    coefficient table in ``leaves`` selects its coefficient leaves."""
    t, tri, u, v = _traverse_plain(quad_box, quad_link, leaves, origin,
                                   direction, t_lane, False, False,
                                   leaf_visits=leaf_visits, stats=stats)
    return Hit(t=t, tri=tri, u=u, v=v)


def quad_any_hit_plain(quad_box, quad_link, leaves, origin, direction,
                       t_lane, leaf_visits=None, stats=None) -> torch.Tensor:
    """Plain version of the quad any-hit kernel (any device): (N,) bool.
    Hit internal children are visited in slot order, as the kernel does:
    the bit does not depend on the order."""
    return _traverse_plain(quad_box, quad_link, leaves, origin, direction,
                           t_lane, True, False, leaf_visits=leaf_visits,
                           stats=stats, slot_order=True)


def oct_closest_hit_plain(oct_box, oct_link, leaves, origin, direction,
                          t_lane, leaf_visits=None, stats=None) -> Hit:
    """Plain version of the oct closest-hit kernel (any device): the
    quad walk over the 8-wide table, exact leaves."""
    t, tri, u, v = _traverse_plain(oct_box, oct_link, leaves, origin,
                                   direction, t_lane, False, False,
                                   leaf_visits=leaf_visits, stats=stats)
    return Hit(t=t, tri=tri, u=u, v=v)


def pair_closest_hit_plain(pair_box, pair_link, leaves, origin, direction,
                           t_lane, inst_inv=None, mb_bits: int = 0,
                           inst_feat=None, leaf_visits=None,
                           stats=None) -> Hit:
    """Plain version of the pair closest-hit kernel (any device);
    ``inst_inv`` set = the instanced leaf decode (with ``inst_feat``
    under coefficient leaves)."""
    t, tri, u, v = _traverse_plain(pair_box, pair_link, leaves, origin,
                                   direction, t_lane, False, True, inst_inv,
                                   mb_bits, leaf_visits, stats, inst_feat)
    return Hit(t=t, tri=tri, u=u, v=v)


def pair_any_hit_plain(pair_box, pair_link, leaves, origin, direction,
                       t_lane, inst_inv=None, mb_bits: int = 0,
                       inst_feat=None, leaf_visits=None,
                       stats=None) -> torch.Tensor:
    """Plain version of the pair any-hit kernel (any device): (N,) bool.
    Hit children, leaves and internal nodes, are visited in slot order,
    as the kernel does: the bit does not depend on the order."""
    return _traverse_plain(pair_box, pair_link, leaves, origin, direction,
                           t_lane, True, False, inst_inv, mb_bits,
                           leaf_visits, stats, inst_feat, slot_order=True)


# -- wrappers ---------------------------------------------------------------

def lane_limits(n: int, active, device) -> torch.Tensor:
    """Per-ray t limit: TMAX, or -1 (inactive) where ``active`` is False."""
    t_lane = torch.full((n,), TMAX, dtype=torch.float32, device=device)
    if active is not None:
        t_lane = torch.where(active, t_lane,
                             torch.full_like(t_lane, -1.0))
    return t_lane


def _dispatch(name: str, origin, plain, launch):
    """CPU tensors run ``plain()``; CUDA tensors run ``launch()`` and
    count the launch; any other device raises."""
    kind = origin.device.type
    if kind == "cpu":
        return plain()
    if kind == "cuda":
        out = launch()
        LAUNCHES[name] += 1
        return out
    raise ValueError(f"{name}: no traversal for device type {kind!r} (cpu "
                     f"runs the plain version, cuda the kernel)")


def leaf_table(scene, coef: bool):
    """The scene's leaf table: exact blocks, or (``coef``) the
    coefficient table, which a scene has only when baked under
    ``mt="mxu"``."""
    if not coef:
        return scene.leaves
    if scene.tri_coefs is None:
        raise ValueError("coefficient leaves need tri_coefs: bake with "
                         "mt='mxu'")
    return scene.tri_coefs


def _launch_name(name: str, coef: bool) -> str:
    return name + "_coef" if coef else name


def quad_args(scene, origin, direction, active, coef: bool = False):
    """The quad kernels' arguments: tables, rays and t_lane."""
    return (scene.quad_box, scene.quad_link, leaf_table(scene, coef),
            origin, direction,
            lane_limits(origin.shape[0], active, origin.device))


def pair_args(scene, origin, direction, active, coef: bool = False):
    """The pair kernels' arguments: tables, rays, t_lane, the instance
    table (None for a flat scene) with its mb_bits, and the instance
    feature transforms (two-level scenes with coefficient leaves)."""
    t_lane = lane_limits(origin.shape[0], active, origin.device)
    inst_inv, mb_bits = ((scene.inst_inv, scene.mb_bits) if scene.instanced
                         else (None, 0))
    inst_feat = None
    if coef and scene.instanced:
        if scene.inst_feat is None:
            raise ValueError("coefficient leaves of a two-level scene need "
                             "inst_feat: bake with mt='mxu'")
        inst_feat = scene.inst_feat
    return (scene.pair_box, scene.pair_link, leaf_table(scene, coef), origin,
            direction, t_lane, inst_inv, mb_bits, inst_feat)


def quad_closest_hit(scene, origin, direction, active=None,
                     coef: bool = False) -> Hit:
    """Closest hit over the scene's quad tables (pallas_quad_closest_hit;
    ``coef``: the coefficient leaves of VKPT_MT=mxu).  Inactive lanes
    return t = MISS_T, tri = -1, u = v = 0."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = quad_args(scene, origin, direction, active, coef)
    return _dispatch(_launch_name("quad_closest_hit", coef), origin,
                     lambda: quad_closest_hit_plain(*args),
                     lambda: Hit(*kernels.quad_closest_hit(*args)))


def quad_any_hit(scene, origin, direction, active=None,
                 coef: bool = False) -> torch.Tensor:
    """Occlusion (N,) bool: True where quad_closest_hit reports t <
    MISS_T (pallas_quad_any_hit; exactly so with exact leaves).
    Inactive lanes return False."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = quad_args(scene, origin, direction, active, coef)
    return _dispatch(_launch_name("quad_any_hit", coef), origin,
                     lambda: quad_any_hit_plain(*args),
                     lambda: kernels.quad_any_hit(*args))


def oct_closest_hit(scene, origin, direction, active=None) -> Hit:
    """Closest hit over the scene's oct tables (pallas_oct_closest_hit),
    exact leaves.  Inactive lanes return t = MISS_T, tri = -1."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = (scene.oct_box, scene.oct_link, scene.leaves, origin, direction,
            lane_limits(origin.shape[0], active, origin.device))
    return _dispatch("oct_closest_hit", origin,
                     lambda: oct_closest_hit_plain(*args),
                     lambda: Hit(*kernels.oct_closest_hit(*args)))


def pair_closest_hit(scene, origin, direction, active=None,
                     coef: bool = False) -> Hit:
    """Closest hit over the scene's pair tables (pallas_pair_closest_hit),
    flat or instanced.  Inactive lanes return t = MISS_T, tri = -1,
    u = v = 0."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = pair_args(scene, origin, direction, active, coef)
    return _dispatch(_launch_name("pair_closest_hit", coef), origin,
                     lambda: pair_closest_hit_plain(*args),
                     lambda: Hit(*kernels.pair_closest_hit(*args)))


def pair_any_hit(scene, origin, direction, active=None,
                 coef: bool = False) -> torch.Tensor:
    """Occlusion (N,) bool: True where pair_closest_hit reports t <
    MISS_T (pallas_pair_any_hit; exactly so with exact leaves).
    Inactive lanes return False."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = pair_args(scene, origin, direction, active, coef)
    return _dispatch(_launch_name("pair_any_hit", coef), origin,
                     lambda: pair_any_hit_plain(*args),
                     lambda: kernels.pair_any_hit(*args))
