"""The traversal kernels' work, counted by the benchmark itself.

The count is what the rays need, not what a program does: each sampled
ray is walked through the reference's own tree (``reference.tree``,
built from the scene's glTF) and its box tests and triangle tests are
counted; a call's count is the mean over its sampled rays times its
live rays.  So the same rays give the same count whatever tree, walk or
bake (flat or two-level) the program uses.

- Operations: ``BOX_OPS`` per box test and ``TRIANGLE_OPS`` per
  triangle test, the arithmetic and comparisons of ``tree._slab`` and
  ``tree.moller_trumbore`` as written.
- Bytes: each live ray read once (origin and direction in f32 and its
  live flag), each result written once (closest hit: t, triangle, u, v;
  any hit: one flag), and the scene's triangles (v0, e1, e2 in f32) and
  the reference tree's boxes read once per call.
- The least time of a call is the larger of its operations over the
  peak f32 rate and its bytes over the peak bandwidth (``peaks.json``,
  by the card's name).
"""

from __future__ import annotations

import json
import os

import torch

from ptbench.reference import tree as walk_tree

BOX_OPS = 25          # 12 sub/mul, 6 min/max, 4 reductions, 3 compares
TRIANGLE_OPS = 52     # 2 crosses, 3 dots, 1 divide, 3 subs, 6 compares
RAY_BYTES = 25        # origin, direction (f32) and the live flag
HIT_BYTES = {"closest": 16, "any": 1}
TRIANGLE_BYTES = 36
NODE_BYTES = 24

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peak(card: str):
    """(f32 FLOP/s, bytes/s) of the card, or None for an unknown card."""
    with open(PEAKS) as f:
        table = json.load(f)
    entry = table.get(card)
    return None if entry is None else (entry["flops_f32"],
                                       entry["bytes_per_s"])


def ops_per_ray(tree, sample, kind: str):
    """Mean operations of the reference walk over the sampled live
    rays, or None where the sample holds none."""
    origin, direction, live = sample
    origin = origin[live].to(tree.lo.device, torch.float32)
    direction = direction[live].to(tree.lo.device, torch.float32)
    if origin.shape[0] == 0:
        return None
    _, boxes, tris = walk_tree.walk(tree, origin, direction,
                                    any_hit=kind == "any", count=True)
    return float((boxes * BOX_OPS + tris * TRIANGLE_OPS).double().mean())


def call_work(tree, rays: dict):
    """[(kind, live rays, operations, bytes)] of every traversal call:
    each call's operations from the mean over the samples of its kind."""
    out = []
    scene_bytes = (tree.triangles * TRIANGLE_BYTES
                   + tree.nodes * NODE_BYTES)
    for kind, calls in rays.items():
        means = [m for m in (ops_per_ray(tree, s, kind)
                             for _, s in calls if s is not None)
                 if m is not None]
        if not means:
            continue
        mean = sum(means) / len(means)
        for count, _ in calls:
            live = int(count)
            out.append((kind, live, live * mean,
                        live * (RAY_BYTES + HIT_BYTES[kind]) + scene_bytes))
    return out


def least_seconds(work, card: str):
    """The least time of the calls ``work`` on ``card``, or None."""
    rates = peak(card)
    if rates is None or not work:
        return None
    flops, bandwidth = rates
    return sum(max(ops / flops, nbytes / bandwidth)
               for _, _, ops, nbytes in work)
