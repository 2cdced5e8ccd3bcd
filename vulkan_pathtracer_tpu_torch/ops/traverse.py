"""Stackless per-ray traversal of the skip-pointer preorders, in plain
PyTorch.

Port of ``vulkan_pathtracer_tpu/ops/traverse.py`` (``bvh_closest_hit``,
the JAX package's XLA traversal, ``--traversal bvh``), and the walk
that the skip kernel's plain version shares (ops/skip_traverse.py).

    state      = one node cursor per ray, in its direction octant's
                 preorder (octant = (dx<0) + 2(dy<0) + 4(dz<0))
    box hit    -> cursor + 1          (preorder: first child)
    miss/leaf  -> skip[cursor]        (escape the subtree)
    done       <=> cursor == Nn

A leaf whose box is hit runs Möller–Trumbore over its block; flat leaf
values are the block's first triangle, two-level ones the packed
``inst << mb_bits | block`` with the object-space decode of
ops/stack_traverse._object_rays.  Every iteration advances each live
ray by one node; finished rays leave the working set.

The two slab forms: ``"sub"`` is the XLA traversal's ``(b - o) * inv``
(traverse.py:196-215); ``"hoisted"`` is the Pallas kernels'
``b * inv - o * inv`` with ``o * inv`` computed once per ray
(pallas_traverse.py:158-174), which the CUDA skip kernel uses.

Deviation kept from the JAX XLA traversal: inside a flat leaf it
accepts a triangle against the limit as of the leaf's entry, so a
later, farther triangle of the same leaf can replace a nearer one
(traverse.py:261-272); here each triangle must beat the best so far,
as the Pallas kernels and the instanced XLA branch do.  The JAX
chunking (``_ROW_GATHER_BUDGET``) guards a TPU worker fault; here only
the rays at a leaf gather its block, and a 1080p frame's working set
fits the card, so nothing is chunked.
"""

from __future__ import annotations

import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import Hit, MISS_T, TMIN
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    BIG,
    _leaf_mt,
    _object_rays,
    _safe_inv,
    lane_limits,
)


def octant_of(direction: torch.Tensor) -> torch.Tensor:
    """(N,) int64 direction octant: bit a set where component a < 0."""
    neg = (direction < 0).to(torch.int64)
    return neg[:, 0] + 2 * neg[:, 1] + 4 * neg[:, 2]


def slab_hit(lo, hi, origin, inv, oxi, t_lim, form: str):
    """Slab test of boxes (M, ..., 3) against rays (M, 3) broadcast over
    the middle axes: the hit mask.  tn = max(max(min x, min y),
    max(min z, TMIN)), tf = min(min(max x, max y), min(max z, t_lim)),
    in the kernels' order (csrc/traverse.cuh)."""
    shape = (lo.shape[0],) + (1,) * (lo.dim() - 2) + (3,)
    if form == "hoisted":
        t0 = lo * inv.view(shape) - oxi.view(shape)
        t1 = hi * inv.view(shape) - oxi.view(shape)
    else:
        t0 = (lo - origin.view(shape)) * inv.view(shape)
        t1 = (hi - origin.view(shape)) * inv.view(shape)
    mn = torch.minimum(t0, t1)
    mx = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                       torch.clamp(mn[..., 2], min=TMIN))
    t_lim = t_lim.view(shape[:-1])
    tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]),
                       torch.minimum(mx[..., 2], t_lim))
    return tn <= tf


def leaf_visit(leaves, origin, direction, rays, leaf, t_lane, best,
               inst_inv=None, mb_bits: int = 0, exits=None):
    """Möller–Trumbore of rays ``rays`` (M,) against the blocks of leaf
    values ``leaf`` (M,) int64, updating ``best`` = [t, tri, u, v] in
    place: the nearest accepted triangle below min(t_best, t_lane), the
    first of equal t (a kernel's in-order strict-< accept).  A flat leaf
    value is its block's first triangle, a two-level one the packed
    ``inst << mb_bits | block`` (triangle ids value * block + k).
    ``exits``, a dict, counts the early-exit test's exits (_leaf_mt)."""
    t_best, tri_best, u_best, v_best = best
    block = leaves.shape[1]
    o_r, d_r = origin[rays], direction[rays]
    det_sign = None
    if inst_inv is not None:
        row, o_r, d_r, det_sign = _object_rays(inst_inv, mb_bits, leaf, o_r,
                                               d_r)
        det_sign = det_sign[:, None]
        first = leaf * block
    else:
        row = leaf // block
        first = leaf
    ok, t, u, v = _leaf_mt(leaves[row], o_r[:, None, :], d_r[:, None, :],
                           det_sign, exits)
    lim = torch.minimum(t_best[rays], t_lane[rays])
    acc = ok & (t < lim[:, None])
    found = acc.any(dim=1)
    k = torch.argmin(torch.where(acc, t, torch.full_like(t, BIG)), dim=1)
    sel = torch.nonzero(found).squeeze(1)
    ks = k[sel]
    rs = rays[sel]
    t_best[rs] = t[sel, ks]
    u_best[rs] = u[sel, ks]
    v_best[rs] = v[sel, ks]
    tri_best[rs] = (first[sel] + ks).to(torch.int32)


def skip_walk(nodes, leaves, origin, direction, t_lane, form: str,
              inst_inv=None, mb_bits: int = 0, stats=None) -> Hit:
    """Closest hit of a per-ray walk over the 8 octant preorders of a
    skip record table ``nodes`` (8*Nn, 8) f32 (bmin | bmax | skip bits
    | leaf bits).  Lanes with t_lane < 0 return a miss without walking.
    ``stats``, a dict, accumulates node visits, leaf-block visits and
    the early exits of their triangle tests (_leaf_mt)."""
    dev = origin.device
    n = origin.shape[0]
    n_nodes = nodes.shape[0] // 8
    meta = nodes.view(torch.int32)[:, 6:8].to(torch.int64)
    inv = _safe_inv(direction)
    oxi = origin * inv
    base = octant_of(direction) * n_nodes
    best = [torch.full((n,), MISS_T, dtype=torch.float32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev)]
    cur = torch.where(t_lane >= 0, 0, n_nodes).to(torch.int64)
    if stats is not None:
        for key in ("node_visits", "leaf_visits", "tri_back", "tri_u",
                    "tri_v"):
            stats.setdefault(key, 0)
    idx = torch.nonzero(cur < n_nodes).squeeze(1)
    while idx.numel():
        rec = base[idx] + cur[idx]
        box = nodes[rec]
        skip, leaf = meta[rec, 0], meta[rec, 1]
        t_lim = torch.minimum(best[0][idx], t_lane[idx])
        hit = slab_hit(box[:, 0:3], box[:, 3:6], origin[idx], inv[idx],
                          oxi[idx], t_lim, form)
        is_leaf = leaf >= 0
        j = torch.nonzero(hit & is_leaf).squeeze(1)
        if stats is not None:
            stats["node_visits"] += idx.numel()
            stats["leaf_visits"] += j.numel()
        if j.numel():
            leaf_visit(leaves, origin, direction, idx[j], leaf[j], t_lane,
                       best, inst_inv, mb_bits, stats)
        cur[idx] = torch.where(hit & ~is_leaf, cur[idx] + 1, skip)
        idx = idx[cur[idx] < n_nodes]
    return Hit(*best)


def bvh_closest_hit(scene, origin, direction, active=None) -> Hit:
    """Closest hit of the XLA-traversal port (``--traversal bvh``) over
    the scene's skip record, flat or two-level, on any device.
    Inactive lanes return t = MISS_T, tri = -1, u = v = 0."""
    t_lane = lane_limits(origin.shape[0], active, origin.device)
    inst_inv, mb_bits = ((scene.inst_inv, scene.mb_bits) if scene.instanced
                         else (None, 0))
    return skip_walk(scene.skip_nodes, scene.leaves, origin, direction,
                     t_lane, "sub", inst_inv, mb_bits)
