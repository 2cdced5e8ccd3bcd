"""A small run of a cell on four gloo ranks on the CPU, with a fault
planted in every rank first, as the tests run it in a process of its
own:

    python -m ptbench.tests.rank_faults <workload> <seed> <fault> \
        [--trace] [--dump PATH] [--bench PATH]

It skips the harness's look for cards and drives the rest of the run
(``ranks.run_ranks`` on the tiny atrium of ``conftest.SIZES``, a 0.5 s
window), prints what the run prints, and exits with its code.
``--dump``: rank 0 also saves the outputs it kept (index, frame
counter, values) to PATH before they are checked; ``--bench``: the
cell is found in PATH in place of ``BENCHMARK.json``.  The faults are functions of the rank's group, found
by name in ``FAULTS``; the ranks import this module to run them.
"""

from __future__ import annotations

import argparse
import functools
import sys
import types

import torch


def sound(group) -> None:
    """Nothing planted: the sound path."""


def state_unchanged(group) -> None:
    """The bounce step returns the path's state as it came in."""
    from vulkan_pathtracer_tpu_torch.render import wavefront

    def unchanged(shading, hit_point, origin, direction, atten, seed_x,
                  seed_y, did_hit, rr):
        return origin, direction, atten, seed_x, seed_y, did_hit
    wavefront._next_segment = unchanged


def half_left_out(group) -> None:
    """Half of the ranks' tiles left out: each odd rank's rows in the
    gathered frame are the even rank's before it."""
    from vulkan_pathtracer_tpu_torch.parallel import sharding

    render = sharding.ShardedRenderPipeline.render

    def half_tiles(self, camera, frame, present_order=True):
        image, rays = render(self, camera, frame, present_order)
        tiles = image.clone().reshape(group.world, -1, *image.shape[1:])
        tiles[1::2] = tiles[0::2]
        return tiles.reshape(image.shape), rays
    sharding.ShardedRenderPipeline.render = half_tiles


def exchange_left_out(group) -> None:
    """The frame's exchange between ranks left out: the tiles' gather
    gives each rank its own tile in every place, the rays' sum its own
    rays."""
    from vulkan_pathtracer_tpu_torch.parallel import mesh, sharding

    render = sharding.ShardedRenderPipeline.render
    cls = mesh.RenderGroup

    def no_exchange(self, camera, frame, present_order=True):
        gather, total = cls.all_gather, cls.sum
        cls.all_gather = lambda g, t: [t] * g.world
        cls.sum = lambda g, t: t
        try:
            return render(self, camera, frame, present_order)
        finally:
            cls.all_gather, cls.sum = gather, total
    sharding.ShardedRenderPipeline.render = no_exchange


def answer_altered(group) -> None:
    """The sky's radiance altered where it is produced, by 2^-8."""
    from vulkan_pathtracer_tpu_torch.render import wavefront

    sky = wavefront.sky_color
    wavefront.sky_color = lambda direction: sky(direction) * (1.0 + 2.0**-8)


def rank_raises(group) -> None:
    """Rank 2 raises at its third frame, while the others wait for its
    tile in the all-gather."""
    from vulkan_pathtracer_tpu_torch.parallel import sharding

    if group.rank != 2:
        return
    render = sharding.ShardedRenderPipeline.render
    calls = []

    def failing(self, camera, frame, present_order=True):
        calls.append(frame)
        if len(calls) == 3:
            raise RuntimeError("rank 2 fails at its third frame")
        return render(self, camera, frame, present_order)
    sharding.ShardedRenderPipeline.render = failing


def jax_in_rank(group) -> None:
    """Rank 1 holds a module named ``jax``."""
    if group.rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")


FAULTS = {f.__name__: f for f in (sound, state_unchanged, half_left_out,
                                  exchange_left_out, answer_altered,
                                  rank_raises, jax_in_rank)}


def dumping(fault, path: str, group) -> None:
    """``fault``, and on rank 0 the kept outputs saved to ``path`` as
    the check is handed them."""
    fault(group)
    if not group.primary:
        return
    from ptbench import check

    compare = check.compare

    def saving(kept, *args, **kwargs):
        torch.save([(k["index"], k["frame"], k["values"]) for k in kept],
                   path)
        return compare(kept, *args, **kwargs)
    check.compare = saving


def main(argv=None) -> int:
    from ptbench import ranks
    from ptbench.cell import Cell
    from ptbench.tests import rank_faults   # by name, for the ranks
    from ptbench.tests.conftest import SIZES, small_mix

    ap = argparse.ArgumentParser(prog="python -m ptbench.tests.rank_faults")
    ap.add_argument("workload")
    ap.add_argument("seed", type=int)
    ap.add_argument("fault", choices=sorted(FAULTS))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--dump")
    ap.add_argument("--bench")
    args = ap.parse_args(argv)
    prepare = rank_faults.FAULTS[args.fault]
    if args.dump:
        prepare = functools.partial(rank_faults.dumping, prepare, args.dump)
    cell = Cell(args.workload, args.bench)
    return ranks.run_ranks(cell, args.seed, 0.5, args.trace, "cpu",
                           sizes=SIZES, mix=small_mix(cell), prepare=prepare)


if __name__ == "__main__":
    raise SystemExit(main())
