"""Device LBVH build: a new tree for deforming triangles, on the
triangles' device, every frame.

Counterpart of ``vulkan_pathtracer_tpu/ops/device_build.py``
(``_morton3d_device``, ``morton_codes_device``, ``build_radix_tree``,
``_depth_bound``, ``_bottom_up_min``, ``device_build_bvh``,
``device_rebuild_scene``) and of ``pallas_pair.nary_maps_device``.
Every shape depends only on (triangles, block):

1. 30-bit Morton codes of the triangle centroids ``v0 + (e1 + e2) /
   3``, normalized to the centroids' box, each op in JAX's f32 order
   (separate PyTorch ops never contract into FMAs); one stable sort
   orders the triangles;
2. fixed leaf blocks of ``block`` consecutive sorted triangles;
3. a Karras (2012) radix tree over the blocks' first codes: L - 1
   internal nodes (ids 0 .. L-2, root 0) and L leaves (ids L-1 ..
   2L-2), split at the highest differing bit, ties of equal codes
   broken by the index;
4. boxes bottom-up: ``_depth_bound(L)`` passes of child unions;
5. the 8 octant preorders without 8 walks: flipping the Morton bits of
   an octant's negative axes gives an isomorphic tree whose subtrees
   are still contiguous leaf runs, so octant o's preorder sorts nodes
   by (first leaf in the flipped order, size descending), and a node's
   skip is its preorder index + 2 * leaves - 1.

The uint32 arithmetic of JAX runs on int64 masked to 32 bits; ``clz``
is exact (no float log2); JAX's two-key ``lax.sort`` is one stable sort
of a combined int64 key (the keys never tie).  The integer outputs
equal JAX's exactly and the boxes bitwise.

``device_rebuild_scene`` turns a build into a scene: the pair and quad
tables (the quad rows from nary_maps_device, which keeps a row per
internal node and leaves empty slots mid-row where a branch ends
early), the skip records, the leaf blocks and, when the template had
them, the coefficient rows in float64 (mxu_mt.coef_rows); the oct and
frontier tables and the 8-wide tiles are dropped, as JAX drops them
(device_build.py:466-473), so those tiers fall through.  Raises before
any launch when the walk kernels' stacks could overflow on the
static depth bound.
"""

from __future__ import annotations

import dataclasses

import torch

from vulkan_pathtracer_tpu_torch.ops.mxu_mt import (
    coef_rows,
    coef_table,
    table_precision,
)
from vulkan_pathtracer_tpu_torch.ops.refit import TreeMaps
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    EMPTY,
    STACK_CAP,
    STACK_SLOTS,
    boxes_from_src,
)

BIG = 3e38
# Morton bits of the x, y and z axes (device_build.py:288-296).
AXIS_BITS = (0x09249249, 0x12492492, 0x24924924)


def _morton3d(q: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 in [0, 1023] -> (N,) 30-bit Morton codes, int64."""
    def expand(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return expand(q[:, 0]) | (expand(q[:, 1]) << 1) | (expand(q[:, 2]) << 2)


def morton_codes(centroids: torch.Tensor):
    """(codes (N,) int64, lo, hi): Morton codes of f32 centroids (N, 3)
    normalized to their box (morton_codes_device, all valid)."""
    lo = centroids.amin(dim=0)
    hi = centroids.amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((centroids - lo) / extent * 1023.0, 0.0, 1023.0)
    return _morton3d(q.to(torch.int64)), lo, hi


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 values in [0, 2^32) as uint32 (32 for 0):
    32 minus the bit length, read exactly as the binary exponent of the
    value in float64 (which holds every 32-bit integer; frexp(0) = (0,
    0)), not rounded from a logarithm."""
    return 32 - torch.frexp(x.double()).exponent.to(torch.int64)


def build_radix_tree(cb: torch.Tensor):
    """(left, right, first, last), each (2L-1,) int64, of the Karras tree
    over sorted leaf codes ``cb`` (L,) int64 (build_radix_tree): nodes
    0 .. L-2 internal, L-1 .. 2L-2 the leaves; a leaf's children are -1,
    its first and last its own index."""
    L = cb.shape[0]
    dev = cb.device
    i = torch.arange(L - 1, dtype=torch.int64, device=dev)
    ci = cb[:L - 1]

    def delta(j):
        valid = (j >= 0) & (j < L)
        jc = j.clamp(0, L - 1)
        x = ci ^ cb[jc]
        tie = x == 0   # equal codes: 32 + the index bits' prefix
        d = clz32(torch.where(tie, i ^ jc, x)) + 32 * tie
        return torch.where(valid, d, torch.full_like(d, -1))

    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i - d)
    # JAX runs each loop below for L up to 2^26; past bits = bit length
    # of L its steps change nothing (a doubled reach leaves the range,
    # where delta is -1; a halved step is 0; the split's step is done),
    # so the loops stop there with the same tree.
    bits = L.bit_length()
    # Doubling search for an upper bound on the range length.
    lmax = torch.full_like(i, 2)
    for _ in range(bits):
        lmax = torch.where(delta(i + lmax * d) > delta_min, lmax * 2, lmax)
    # Binary search for the other end.
    ln = torch.zeros_like(i)
    for s in range(1, bits + 2):
        t = lmax >> s
        cand = ln + t
        ok = (t >= 1) & (delta(i + cand * d) > delta_min)
        ln = torch.where(ok, cand, ln)
    j = i + ln * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    # Split search (the halving loop, its t == 1 step run once).
    delta_node = delta(j)
    s = torch.zeros_like(i)
    t = ln
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(bits + 1):
        t = torch.where(done, t, (t + 1) // 2)
        ok = ~done & (delta(i + (s + t) * d) > delta_node)
        s = torch.where(ok, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + torch.clamp(d, max=0)
    leaf_base = L - 1
    left = torch.where(first == gamma, leaf_base + gamma, gamma)
    right = torch.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    leaves = torch.arange(L, dtype=torch.int64, device=dev)
    none = torch.full((L,), -1, dtype=torch.int64, device=dev)
    return (torch.cat([left, none]), torch.cat([right, none]),
            torch.cat([first, leaves]), torch.cat([last, leaves]))


def depth_bound(L: int) -> int:
    """Bound on the depth (root = 1) of a Karras tree over L leaves:
    30 code bits and the index bits of the tie-break (_depth_bound)."""
    return 34 + max((max(L, 2) - 1).bit_length(), 1)


def check_stack(L: int) -> None:
    """Raise ValueError when a tree within depth_bound(L) could overflow
    the pair kernels' stack (one entry per level) or the quad kernels'
    (3 per collapsed level), from the bound alone: no device sync."""
    depth = depth_bound(L)
    rows = (depth - 1 + 1) // 2   # collapsed depth of the quad rows
    if depth > STACK_CAP or 3 * (rows - 1) > STACK_SLOTS[4]:
        raise ValueError(
            f"device rebuild of {L} leaves: depth bound {depth} exceeds "
            f"the walk kernels' stacks ({STACK_CAP}; quad "
            f"{STACK_SLOTS[4]})")


def bottom_up_min(left, right, leaf_vals: torch.Tensor,
                  passes: int) -> torch.Tensor:
    """(2L-1, k) per-node minima of (L, k) int64 leaf values over the
    tree: ``passes`` passes of internal node <- min of its children
    (_bottom_up_min, all octants at once)."""
    L = leaf_vals.shape[0]
    vals = torch.cat([torch.full((L - 1,) + leaf_vals.shape[1:], 2 ** 30,
                                 dtype=torch.int64, device=leaf_vals.device),
                      leaf_vals])
    internal = (left >= 0).unsqueeze(1)
    li, ri = left.clamp(min=0), right.clamp(min=0)
    for _ in range(passes):
        vals = torch.where(internal, torch.minimum(vals[li], vals[ri]), vals)
    return vals


def device_build_bvh(tri_v0, tri_e1, tri_e2, num_triangles: int, block: int,
                     on_step=None) -> dict:
    """The tree of the first ``num_triangles`` rows of canonical-order
    triangles (T, 3) f32, built on their device (device_build_bvh, 8
    octants).  Returns a dict: the octant-stacked records' ``bmin``,
    ``bmax`` (8*Nn, 3), ``skip_local``, ``leaf_first``, ``leaf_count``,
    ``perm`` (8*Nn,); the build-order ``left``, ``right``,
    ``leaf_first_build``, ``leaf_count_build``, ``bmin_build``,
    ``bmax_build``; ``leaf_counts`` (L,); ``tri_order`` (t,) slot ->
    canonical triangle; the slot-ordered ``tri_v0/e1/e2`` (L*block, 3),
    zero rows past t; ``n_nodes`` and ``depth`` (the passes).
    ``on_step(name)``, when given, is called after each step (morton,
    radix_tree, aabb, octants) for timing."""
    t = num_triangles
    dev = tri_v0.device
    step = on_step or (lambda name: None)
    L = max((t + block - 1) // block, 1)
    n_slots = L * block
    v0 = tri_v0[:t]
    cent = v0 + (tri_e1[:t] + tri_e2[:t]) / 3.0
    codes, _, _ = morton_codes(cent)
    sorted_codes, tri_order = torch.sort(codes, stable=True)
    tail = torch.zeros(n_slots - t, dtype=torch.int64, device=dev)
    idx = torch.cat([tri_order, tail])
    pad = (torch.arange(n_slots, device=dev) >= t).unsqueeze(1)

    def slot_gather(arr):
        out = arr[:t][idx]
        return torch.where(pad, torch.zeros_like(out), out)

    s_v0, s_e1, s_e2 = (slot_gather(a) for a in (tri_v0, tri_e1, tri_e2))
    cb = sorted_codes[torch.arange(L, device=dev) * block]
    leaf_counts = torch.clamp(
        t - torch.arange(L, dtype=torch.int64, device=dev) * block, max=block)
    leaf_first_slots = torch.arange(L, dtype=torch.int64, device=dev) * block
    step("morton")

    if L == 1:
        v1, v2 = s_v0 + s_e1, s_v0 + s_e2
        lo = torch.minimum(torch.minimum(s_v0, v1), v2)[:t].amin(dim=0)
        hi = torch.maximum(torch.maximum(s_v0, v1), v2)[:t].amax(dim=0)
        one = torch.ones(1, dtype=torch.int64, device=dev)
        step("radix_tree")
        step("aabb")
        step("octants")
        return dict(
            bmin=lo.expand(8, 3).contiguous(),
            bmax=hi.expand(8, 3).contiguous(),
            skip_local=one.expand(8).contiguous(),
            leaf_first=torch.zeros(8, dtype=torch.int64, device=dev),
            leaf_count=leaf_counts.expand(8).contiguous(),
            perm=torch.zeros(8, dtype=torch.int64, device=dev),
            left=-one, right=-one, leaf_first_build=0 * one,
            leaf_count_build=leaf_counts, bmin_build=lo[None].clone(),
            bmax_build=hi[None].clone(), leaf_counts=leaf_counts,
            tri_order=tri_order, tri_v0=s_v0, tri_e1=s_e1, tri_e2=s_e2,
            n_nodes=1, depth=1)

    left, right, first, last = build_radix_tree(cb)
    step("radix_tree")
    n_nodes = 2 * L - 1
    leaf_base = L - 1
    passes = depth_bound(L)

    # Leaf boxes over valid slots, then the bottom-up fit of lo | -hi.
    v1, v2 = s_v0 + s_e1, s_v0 + s_e2
    corners = torch.cat([torch.minimum(torch.minimum(s_v0, v1), v2),
                         -torch.maximum(torch.maximum(s_v0, v1), v2)], dim=1)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    leaf_box = torch.where(pad, big, corners).view(L, block, 6).amin(dim=1)
    b = torch.cat([big.expand(L - 1, 6), leaf_box])
    internal = (left >= 0).unsqueeze(1)
    li, ri = left.clamp(min=0), right.clamp(min=0)
    for _ in range(passes):
        b = torch.where(internal, torch.minimum(b[li], b[ri]), b)
    bmin_build, bmax_build = b[:, :3].contiguous(), (-b[:, 3:]).contiguous()
    step("aabb")

    # Octant preorders: each leaf's rank in the bit-flipped stable order,
    # each subtree's first rank, then (start asc, size desc).
    masks = torch.tensor([sum(bits for a, bits in enumerate(AXIS_BITS)
                              if o >> a & 1) for o in range(8)],
                         dtype=torch.int64, device=dev)
    forder = torch.argsort(cb[None, :] ^ masks[:, None], dim=1, stable=True)
    ranks = torch.empty_like(forder)
    ranks.scatter_(1, forder, torch.arange(L, device=dev).expand(8, L))
    start = bottom_up_min(left, right, ranks.T.contiguous(), passes).T
    sizes = last - first + 1
    perm = torch.argsort(start * (L + 1) + (L - sizes), dim=1, stable=True)
    sz = sizes[perm]
    skip_local = torch.arange(n_nodes, device=dev) + 2 * sz - 1
    is_leaf = perm >= leaf_base
    leaf_id = (perm - leaf_base).clamp(min=0)
    lf = torch.where(is_leaf, leaf_first_slots[leaf_id], -1)
    lc = torch.where(is_leaf, leaf_counts[leaf_id], 0)
    perm = perm.reshape(-1)
    step("octants")
    none = torch.full((L - 1,), -1, dtype=torch.int64, device=dev)
    return dict(
        bmin=bmin_build[perm], bmax=bmax_build[perm],
        skip_local=skip_local.reshape(-1), leaf_first=lf.reshape(-1),
        leaf_count=lc.reshape(-1), perm=perm, left=left, right=right,
        leaf_first_build=torch.cat([none, leaf_first_slots]),
        leaf_count_build=torch.cat([0 * none, leaf_counts]),
        bmin_build=bmin_build, bmax_build=bmax_build, leaf_counts=leaf_counts,
        tri_order=tri_order, tri_v0=s_v0, tri_e1=s_e1, tri_e2=s_e2,
        n_nodes=n_nodes, depth=passes)


def nary_maps(left, right, leaf_first, block: int, width: int = 4):
    """(src, link) (Nn, width) int64 / int32 collapse maps over a
    build-order tree (nary_maps_device in the port's layout): one row
    per node, internal nodes first in id order (callers keep the first
    Ni); each row's slots expand log2(width) levels left to right, a
    leaf reached early fills its slot and leaves an empty one (src -1,
    link EMPTY) beside it, mid-row.  A link is a child's row, or
    -(leaf block + 1)."""
    internal = left >= 0
    row_of = torch.cumsum(internal.to(torch.int64), 0) - 1
    slots = [left, right]
    for _ in range(width.bit_length() - 2):
        nxt = []
        for s in slots:
            sv = s.clamp(min=0)
            s_int = (s >= 0) & internal[sv]
            nxt.append(torch.where(s_int, left[sv], s))
            nxt.append(torch.where(s_int, right[sv], torch.full_like(s, -1)))
        slots = nxt
    src = torch.stack(slots, dim=1)
    sv = src.clamp(min=0)
    link = torch.where(src < 0, EMPTY,
                       torch.where(internal[sv], row_of[sv],
                                   -(leaf_first[sv] // block + 1)))
    order = torch.argsort((~internal).to(torch.int8), stable=True)
    return src[order], link[order].to(torch.int32)


def skip_records(bmin, bmax, skip_local, leaf_first) -> torch.Tensor:
    """(M, 8) f32 records bmin | bmax | skip | leaf, the last two int32
    bit patterns (models/device_scene.skip_records on the device)."""
    tail = torch.stack([skip_local.to(torch.int32),
                        leaf_first.to(torch.int32)], dim=1)
    return torch.cat([bmin, bmax, tail.view(torch.float32)], dim=1)


def device_rebuild_scene(template, tri_v0, tri_e1, tri_e2, tri_gn, tri_attr,
                         on_step=None, coefs: bool = None,
                         mxu_precision: str = None):
    """A copy of a flat scene with a tree rebuilt on the device from
    canonical-order triangles (the first ``template.num_triangles``
    rows of ``tri_*``) and their shading rows (device_rebuild_scene):
    slot-ordered triangles, ``tri_material`` from the template's
    canonical rows, new TreeMaps, pair and quad tables, skip records,
    leaf blocks and coefficient rows (``coefs``; default: iff the
    template has them, as JAX) in ``mxu_precision``'s dtype (default:
    the template table's, else f32); no oct, frontier or 8-wide tables.
    Every per-triangle table keeps at least the template's rows.
    ``on_step`` as device_build_bvh's, and called once more after the
    tables ("tables")."""
    if coefs is None:
        coefs = template.tri_coefs is not None
    if mxu_precision is None:
        mxu_precision = ("highest" if template.tri_coefs is None
                         else table_precision(template.tri_coefs))
    t = template.num_triangles
    block = template.max_leaf_size
    L = max((t + block - 1) // block, 1)
    check_stack(L)
    built = device_build_bvh(tri_v0, tri_e1, tri_e2, t, block, on_step)
    n_slots = L * block
    dev = tri_v0.device
    idx = torch.cat([built["tri_order"],
                     torch.zeros(n_slots - t, dtype=torch.int64,
                                 device=dev)])
    pad = (torch.arange(n_slots, device=dev) >= t)

    def slot_gather(arr):
        out = arr[:t][idx]
        return torch.where(pad.view((-1,) + (1,) * (out.ndim - 1)),
                           torch.zeros_like(out), out)

    def fit(arr, like):
        rows = max(like.shape[0], n_slots)
        if arr.shape[0] < rows:
            arr = torch.cat([arr, arr.new_zeros((rows - arr.shape[0],)
                                                + arr.shape[1:])])
        return arr.contiguous()

    left, right = built["left"], built["right"]
    lf_build = built["leaf_first_build"]
    bmin, bmax = built["bmin_build"], built["bmax_build"]
    if L > 1:
        ni = L - 1
        pair_src = torch.stack([left[:ni], right[:ni]], dim=1)
        quad_src, quad_link = (m[:ni] for m in nary_maps(
            left, right, lf_build, block, 4))
    else:   # a root leaf: one row holding it (as the host bake)
        pair_src = torch.zeros((1, 2), dtype=torch.int64, device=dev)
        quad_src = torch.tensor([[0, -1, -1, -1]], device=dev)
        quad_link = torch.tensor([[-1, EMPTY, EMPTY, EMPTY]],
                                 dtype=torch.int32, device=dev)
    internal = left >= 0
    pair_link = torch.where(internal[pair_src], pair_src,
                            -(lf_build[pair_src] // block + 1)).to(torch.int32)
    s_v0, s_e1, s_e2 = built["tri_v0"], built["tri_e1"], built["tri_e2"]
    leaves = torch.cat([s_v0, s_e1, s_e2], dim=1).view(L, block, 9)
    tree = TreeMaps(left=left, right=right, leaf_first=lf_build,
                    leaf_count=built["leaf_count_build"],
                    block_count=built["leaf_counts"], perm=built["perm"],
                    pair_src=pair_src, quad_src=quad_src)
    out = dataclasses.replace(
        template,
        tri_v0=fit(s_v0, template.tri_v0), tri_e1=fit(s_e1, template.tri_e1),
        tri_e2=fit(s_e2, template.tri_e2),
        tri_gn=fit(slot_gather(tri_gn), template.tri_gn),
        tri_attr=fit(slot_gather(tri_attr), template.tri_attr),
        tri_material=fit(slot_gather(template.tri_material),
                         template.tri_material),
        leaves=leaves, root_lo=bmin[0].clone(), root_hi=bmax[0].clone(),
        pair_box=boxes_from_src(bmin, bmax, pair_src), pair_link=pair_link,
        quad_box=boxes_from_src(bmin, bmax, quad_src), quad_link=quad_link,
        oct_box=None, oct_link=None, frontier_box=None, frontier_link=None,
        skip_nodes=skip_records(built["bmin"], built["bmax"],
                                built["skip_local"], built["leaf_first"]),
        wide_nodes=None,
        tri_coefs=(coef_table(coef_rows(leaves), mxu_precision) if coefs
                   else None),
        tree=tree, bvh_depth=built["depth"])
    if on_step is not None:
        on_step("tables")
    return out
