"""Ray-triangle intersection (Möller–Trumbore), the leaf-block seed
pre-pass and the brute-force closest hit.

Port of ``vulkan_pathtracer_tpu/ops/intersect.py``.  Same semantics:
tmin = 0.001, tmax = 10000 (ray_gen.rgen:38-39), miss sentinel
t = 1e32, backface culling by the determinant sign (det <= 0 culls),
barycentrics (u, v) weighting vertices 1 and 2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MISS_T = float(np.float32(1e32))
TMIN = 0.001
TMAX = 10000.0


class Hit(NamedTuple):
    t: torch.Tensor    # (N,) f32 — MISS_T where missed
    tri: torch.Tensor  # (N,) int32 — -1 where missed
    u: torch.Tensor    # (N,) f32
    v: torch.Tensor    # (N,) f32


def moller_trumbore(origin, direction, v0, e1, e2, tmin, t_limit):
    """Batched MT with backface culling; inputs broadcast over (..., 3).
    Returns (hit_mask, t, u, v) with shapes (...,)."""
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


def leaf_seed_hit(scene, origin, direction, block_idx, active=None,
                  tmin=TMIN, tmax=TMAX) -> Hit:
    """A local pre-pass (JAX intersect.py:89-126): each ray against ONE
    leaf block of ``scene.leaves`` (n_leaves, block, 9), ``block_idx``
    (N,) clipped to the table; the nearest accepted triangle, in slot
    order with a strict ``t < t_best`` update (the first of equal t),
    with id ``block * max_leaf_size + k``.  Lanes where ``active`` is
    False return a miss.  The result seeds a closest hit's best hit
    (``seed=``).  On a flat bake it is a hit of the scene, so the
    traversal's result does not change beyond ties at the seed's t; a
    two-level scene's blocks are in object space, so there it is not
    (render/wavefront.check_seed_secondary)."""
    n = origin.shape[0]
    block = scene.max_leaf_size
    rows = torch.clamp(block_idx.to(torch.int64), 0,
                       scene.leaves.shape[0] - 1)
    t_best = torch.full((n,), MISS_T, dtype=torch.float32,
                        device=origin.device)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    u_best = torch.zeros(n, dtype=torch.float32, device=origin.device)
    v_best = torch.zeros_like(u_best)
    base = rows * block
    for k in range(block):
        tri9 = scene.leaves[rows, k]
        t_lim = torch.clamp(t_best, max=tmax)
        hit, t, u, v = moller_trumbore(origin, direction, tri9[:, 0:3],
                                       tri9[:, 3:6], tri9[:, 6:9], tmin,
                                       t_lim)
        if active is not None:
            hit = hit & active
        t_best = torch.where(hit, t, t_best)
        tri_best = torch.where(hit, (base + k).to(torch.int32), tri_best)
        u_best = torch.where(hit, u, u_best)
        v_best = torch.where(hit, v, v_best)
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)


def brute_force_closest_hit(scene, origin, direction, active=None,
                            tmin=TMIN, tmax=TMAX, chunk: int = 256) -> Hit:
    """O(rays x tris) closest hit over ``scene.tri_v0/e1/e2``, in
    triangle chunks of ``chunk``; the oracle for small scenes."""
    n = origin.shape[0]
    total = scene.tri_v0.shape[0]
    t_best = torch.full((n,), MISS_T, dtype=torch.float32,
                        device=origin.device)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    u_best = torch.zeros(n, dtype=torch.float32, device=origin.device)
    v_best = torch.zeros_like(u_best)
    o = origin[:, None, :]
    d = direction[:, None, :]
    rows = torch.arange(n, device=origin.device)
    for start in range(0, total, chunk):
        stop = min(start + chunk, total)
        t_limit = torch.clamp(t_best, max=tmax)[:, None]
        hit, t, u, v = moller_trumbore(
            o, d, scene.tri_v0[None, start:stop],
            scene.tri_e1[None, start:stop], scene.tri_e2[None, start:stop],
            tmin, t_limit)
        t = torch.where(hit, t, torch.full_like(t, MISS_T))
        best = torch.argmin(t, dim=1)
        t_new = t[rows, best]
        improved = t_new < t_best
        t_best = torch.where(improved, t_new, t_best)
        tri_best = torch.where(improved, (best + start).to(torch.int32),
                               tri_best)
        u_best = torch.where(improved, u[rows, best], u_best)
        v_best = torch.where(improved, v[rows, best], v_best)
    if active is not None:
        t_best = torch.where(active, t_best, torch.full_like(t_best, MISS_T))
        tri_best = torch.where(active, tri_best, torch.full_like(tri_best, -1))
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)
