"""Wavefront reordering (port of ``state_sort_order`` in ops/sort.py).

Sorting bounce rays by a spatial key before traversal is scheduling
only: per-ray results are the same under any order.  The port keeps
the exact lane sort (c = 1, a stable argsort); the JAX package's
group-granular sort (c > 1) and its ``lax.sort`` permute mode are TPU
tuning knobs that the port does not carry.
"""

from __future__ import annotations

import torch


def state_sort_order(key: torch.Tensor, c: int = 1):
    """(group_order, lane_order): lanes grouped by ascending key, ties
    in lane order.  Only c = 1 (exact lane sort) is ported, so
    group_order is always None."""
    if c != 1:
        raise ValueError("only the exact lane sort (c = 1) is ported")
    return None, torch.argsort(key, stable=True)
