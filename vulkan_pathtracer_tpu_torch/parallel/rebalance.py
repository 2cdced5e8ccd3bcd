"""The pooled wavefront across ranks, rebalanced every bounce (port of
``parallel/rebalance.py``).

Under framebuffer tiles every rank traces the bounce rays of its own
tile: enclosed regions keep bouncing while sky tiles go idle, so the
ranks' live counts diverge.  ``_balanced_exchange`` evens them out
before each bounce after bounce 0, with two local sorts and one
``all_to_all``:

1. sort the rank's lanes by the 6d bounce key (dead lanes last);
2. deal the sorted rows round-robin into ``world`` strips (row i to
   strip i % world), so each strip is a sample of the whole shard;
   contiguous strips would send every live lane to the low ranks;
3. send strip r to rank r (one packed buffer of the eight lane
   tensors' raw bytes): every rank ends with the same live share, +-1
   strip;
4. the bounce loop sorts the rank's lanes again.

The bounce loop is the single-device one (render/wavefront._trace_lanes,
with the exchange as its hook), so each lane runs the per-lane
operations of ``trace_wavefront_pooled``, and its color goes home by its
lane id: each rank scatters its lanes' colors into a zero (M, 3) buffer
and the buffers are summed over the ranks (each entry has one non-zero
term, so the sum is exact in any order).
"""

from __future__ import annotations

import math

import torch

from vulkan_pathtracer_tpu_torch.ops.sort import state_sort_order
from vulkan_pathtracer_tpu_torch.parallel.mesh import RenderGroup
from vulkan_pathtracer_tpu_torch.render.wavefront import (
    JOINT_CHUNK,
    _bounce_sort_key,
    _trace_lanes,
    pooled_state,
)


def _pack(state):
    """The lane tensors' raw bytes as one (m, bytes per lane) uint8
    tensor, and the (dtype, row shape) of each."""
    m = state[0].shape[0]
    parts = [t.contiguous().view(torch.uint8).reshape(m, -1) for t in state]
    return torch.cat(parts, dim=1), [(t.dtype, t.shape[1:]) for t in state]


def _unpack(packed, layout):
    m = packed.shape[0]
    state = []
    col = 0
    for dtype, row in layout:
        width = dtype.itemsize * math.prod(row)
        state.append(packed[:, col:col + width].contiguous().view(dtype)
                     .reshape(m, *row))
        col += width
    return state


def _balanced_exchange(state, key, group: RenderGroup):
    """Steps 1-3 of the module docstring: the rank's lanes sorted by
    ``key`` (int64, dead lanes 0xFFFFFFFF), dealt round-robin into
    ``world`` strips, strip r sent to rank r.  Returns the lane state
    the rank received: its strip of every rank's lanes, by source
    rank."""
    _, order = state_sort_order(key, 1)
    packed, layout = _pack([t[order] for t in state])
    m = packed.shape[0]
    world = group.world
    strips = packed.view(m // world, world, -1).transpose(0, 1)
    return _unpack(group.all_to_all(strips.reshape(m, -1)), layout)


def make_pooled_sharded_render(group: RenderGroup, scene, *,
                               num_bounces: int, tiers="auto",
                               russian_roulette: bool = False,
                               rr_start_bounce: int = 2,
                               sort_secondary: bool = True,
                               rebalance: bool = True,
                               chunk: int = JOINT_CHUNK):
    """Returns fn(scene, origin (M, 3), direction (M, 3), seed_x (M,),
    seed_y (M,)) -> (color (M, 3) in lane order on every rank, rays
    traced summed over the ranks, int64 0-d).  Every rank passes the
    same M rays; rank r traces lanes [r M / world, (r + 1) M / world)
    from bounce 0, with global lane ids.  With ``rebalance`` the ranks
    trade lanes before each bounce after bounce 0
    (``_balanced_exchange``).  M must be divisible by world squared
    (pad with dead lanes).  ``scene`` is the layout the returned fn is
    called with, as in the JAX package; fn takes the scene to render."""
    rank, world = group.rank, group.world

    def fn(scene, origin, direction, seed_x, seed_y):
        m = origin.shape[0]
        if m % (world * world):
            raise ValueError(f"{m} lanes: the pooled sharded wavefront "
                             f"needs a multiple of {world * world} (the "
                             f"number of ranks squared); pad with dead "
                             f"lanes")
        m_local = m // world
        lanes = slice(rank * m_local, (rank + 1) * m_local)

        def exchange(state):
            key = _bounce_sort_key(scene, state[0], state[1], state[6])
            return _balanced_exchange(state, key, group)

        state, rays = _trace_lanes(
            scene, pooled_state(origin[lanes], direction[lanes],
                                seed_x[lanes], seed_y[lanes],
                                rank * m_local), 0,
            num_bounces=num_bounces, tiers=tiers,
            russian_roulette=russian_roulette,
            rr_start_bounce=rr_start_bounce, sort_secondary=sort_secondary,
            chunk=chunk, exchange=exchange if rebalance else None)
        color = torch.zeros((m, 3), dtype=torch.float32, device=origin.device)
        color[state[7]] = state[3]
        return group.sum(color), group.sum(rays)

    return fn
