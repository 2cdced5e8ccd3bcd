"""Skip-pointer closest hit: the plain PyTorch versions of the two CUDA
kernels of ``csrc/skip_traverse.cu`` and their wrappers
(``--traversal pallas_packet`` and ``--traversal pallas8``).

Counterpart of the Pallas kernels of
``vulkan_pathtracer_tpu/ops/pallas_traverse.py`` that return the
closest hit of a skip-pointer walk:

- ``skip_closest_hit`` stands for kernels 5, 6, 7 and 9 — the packet
  kernel ``pallas_closest_hit`` (flat, and with the instanced leaf
  decode), its ``pipe`` and ``group_mt`` scheduling variants, and the
  dense-row ``pallas_dense_closest_hit``.  All walk the 8
  direction-octant preorders of ``scene.skip_nodes`` with the slab
  ``b * inv - o * inv``; they differ only in how the TPU stages and
  schedules the walk.  On two-level scenes the JAX package gets these
  hits through its XLA traversal (the packet kernel is behind a VMEM
  gate there); the port has no VMEM ceiling and runs the kernel.
- ``wide_closest_hit`` stands for kernel 8, ``pallas_wide_closest_hit``,
  over the 8-wide slot tiles ``scene.wide_nodes`` (ops/bvh_wide.py):
  slab ``(b - o) * inv``, all 8 slot hits against t_best as it was at
  node entry, then the leaf slots in slot order, each masked by its own
  slot hit, then node + 1 if any internal slot was hit, else the skip
  pointer of slot 0 (pallas_traverse.py:1346-1427).

Each plain version performs its kernel's float operations in the same
order, so the two agree bitwise on the card.  The per-ray walk is
ops/traverse.skip_walk, which also serves ``--traversal bvh``.  Unlike
a TPU packet, which descends when any lane hits and intersects every
lane of a visited leaf, each ray descends on its own box test and runs
a leaf only when its own box is hit: the hits are the same up to ties
of equal t and slab-versus-MT rounding.

The kernel-5 seed channels (7-10) and ``t_near`` window (channel 11)
are set on no default path and are not ported.

The wrappers dispatch on the device of the rays: CPU tensors run the
plain version, CUDA tensors launch the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import Hit, MISS_T
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import (
    _dispatch,
    _safe_inv,
    lane_limits,
)
from vulkan_pathtracer_tpu_torch.ops.traverse import (
    leaf_visit,
    octant_of,
    skip_walk,
    slab_hit,
)


def skip_closest_hit_plain(nodes, leaves, origin, direction, t_lane,
                           inst_inv=None, mb_bits: int = 0,
                           stats=None) -> Hit:
    """Plain version of the skip kernel (any device); ``inst_inv`` set
    = the instanced leaf decode.  ``stats``, a dict, accumulates node
    visits, leaf-block visits and the early exits of the kernel's
    triangle test (ops/traverse.skip_walk)."""
    return skip_walk(nodes, leaves, origin, direction, t_lane, "hoisted",
                     inst_inv, mb_bits, stats)


def wide_closest_hit_plain(tiles, leaves, origin, direction, t_lane,
                           stats=None) -> Hit:
    """Plain version of the wide kernel (any device) over (8*Nw, 8, 8)
    slot tiles; ``stats``, a dict, accumulates tile visits, leaf-block
    visits and the early exits of their triangle tests (_leaf_mt)."""
    dev = origin.device
    n = origin.shape[0]
    n_wide = tiles.shape[0] // 8
    inv = _safe_inv(direction)
    base = octant_of(direction) * n_wide
    best = [torch.full((n,), MISS_T, dtype=torch.float32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev)]
    cur = torch.where(t_lane >= 0, 0, n_wide).to(torch.int64)
    if stats is not None:
        for key in ("node_visits", "leaf_visits", "tri_back", "tri_u",
                    "tri_v"):
            stats.setdefault(key, 0)
    idx = torch.nonzero(cur < n_wide).squeeze(1)
    while idx.numel():
        tile = tiles[base[idx] + cur[idx]]            # (M, 8, 8)
        t_lim = torch.minimum(best[0][idx], t_lane[idx])
        hit = slab_hit(tile[..., 0:3], tile[..., 3:6], origin[idx],
                       inv[idx], None, t_lim, "sub")  # (M, 8)
        word = tile[..., 6]
        if stats is not None:
            stats["node_visits"] += idx.numel()
        for s in range(8):
            j = torch.nonzero(hit[:, s] & (word[:, s] >= 0)).squeeze(1)
            if j.numel():
                if stats is not None:
                    stats["leaf_visits"] += j.numel()
                leaf_visit(leaves, origin, direction, idx[j],
                           word[j, s].to(torch.int64), t_lane, best,
                           exits=stats)
        descend = (hit & (word == -1.0)).any(dim=1)
        skip = tile[:, 0, 7].to(torch.int64)
        cur[idx] = torch.where(descend, cur[idx] + 1, skip)
        idx = idx[cur[idx] < n_wide]
    return Hit(*best)


# -- wrappers ---------------------------------------------------------------

def skip_args(scene, origin, direction, active):
    """The skip kernel's arguments: records, leaves, rays, t_lane and
    the instance table (None for a flat scene) with its mb_bits."""
    t_lane = lane_limits(origin.shape[0], active, origin.device)
    inst_inv, mb_bits = ((scene.inst_inv, scene.mb_bits) if scene.instanced
                         else (None, 0))
    return (scene.skip_nodes, scene.leaves, origin, direction, t_lane,
            inst_inv, mb_bits)


def wide_args(scene, origin, direction, active):
    """The wide kernel's arguments; the scene must carry wide tiles."""
    if scene.wide_nodes is None:
        raise ValueError("wide_closest_hit: the scene has no wide tiles "
                         "(bake it with build_device_scene(..., wide=True))")
    return (scene.wide_nodes, scene.leaves, origin, direction,
            lane_limits(origin.shape[0], active, origin.device))


def skip_closest_hit(scene, origin, direction, active=None) -> Hit:
    """Closest hit of the skip walk over the scene's 8 octant preorders
    (pallas_closest_hit and its variants), flat or instanced.  Inactive
    lanes return t = MISS_T, tri = -1, u = v = 0."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = skip_args(scene, origin, direction, active)
    return _dispatch("skip_closest_hit", origin,
                     lambda: skip_closest_hit_plain(*args),
                     lambda: Hit(*kernels.skip_closest_hit(*args)))


def wide_closest_hit(scene, origin, direction, active=None) -> Hit:
    """Closest hit of the 8-wide tile walk (pallas_wide_closest_hit),
    flat scenes.  Inactive lanes return t = MISS_T, tri = -1,
    u = v = 0."""
    from vulkan_pathtracer_tpu_torch.ops import kernels

    args = wide_args(scene, origin, direction, active)
    return _dispatch("wide_closest_hit", origin,
                     lambda: wide_closest_hit_plain(*args),
                     lambda: Hit(*kernels.wide_closest_hit(*args)))
