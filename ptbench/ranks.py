"""A cell on several cards: one rank per card, through the program's own
multi-device path, as the CLI's ``--devices N`` runs it.

A traffic mix with ``"ranks": N`` (N > 1) and ``"split"`` runs on N
ranks that ``parallel.distributed.spawn`` starts, one process each, in
a group it forms (NCCL between cards, gloo on the CPU).  Each rank does
what ``app.main.render_main`` does for a rank: it loads and bakes the
scene on its own card (``app.main.load_pipeline``) and renders through
``ShardedRenderPipeline(scene, config, group, mode=<split>)``; under
``"tiles"`` rank r renders rows [r H / N, (r + 1) H / N) and the tiles
are all-gathered to every rank.  The parent generates the scene's glTF
before it starts the ranks, and prints the line.

The ranks run in lockstep with no collective of the harness inside a
timed frame: after the warm-up each runs the mix's ``calibration``
frames, rank 0 broadcasts its frame rate once, and each window then runs
the number of frames that rate gives for its seconds, the same on every
rank.  Rank 0 reports its window (``fps``, frame times by its CUDA
events, which span the all-gather and so the slowest rank), its traced
window and breakdown, and the check of its gathered frames.
``setup_s`` runs from the parent's start to rank 0's first timed frame.
After the windows the ranks' peak memory, device busy time and span
totals go to rank 0: the line gives the largest peak, the mean busy
time, and the spans by rank (``Reading.rank_span_ms``).

A rank that raises or dies ends the run: ``spawn`` ends the other ranks
(SIGTERM, SIGKILL after 30 s) and raises, and the parent exits 5 with no
result line.  A rank also ends itself by SIGALRM once its set-up or its
windows outlast a bound, so that a rank stuck in a collective cannot
hold the run.  Every rank reports the forbidden modules it loaded
(exit 4).
"""

from __future__ import annotations

import math
import signal
import sys
import time
import traceback

import torch

from ptbench import run

# Seconds a rank may take to its first timed frame (the first run in a
# checkout builds the kernels), then from there to its end.
SETUP_LIMIT_S = 1100
WINDOWS_LIMIT_S = 240


class Rank:
    """This process as one rank of several: what ``run.run_cell`` does
    differently there."""

    def __init__(self, group, origin: float, split: str, limit_s: int):
        self.group = group
        self.primary = group.primary
        self.world = group.world
        self.origin = origin     # the parent's start, by time.monotonic
        self.split = split
        self.limit_s = limit_s   # from the first timed frame to the end
        self.rate = None         # frames a second, agreed by lockstep

    def shard(self, pipe, render_config):
        """The loaded pipeline's scene split over the ranks."""
        from vulkan_pathtracer_tpu_torch.parallel.sharding import (
            ShardedRenderPipeline,
        )

        return ShardedRenderPipeline(pipe.scene, render_config, self.group,
                                     mode=self.split)

    def lockstep(self, client, frames: int) -> None:
        """The end of set-up: runs ``frames`` frames and agrees rank 0's
        frame rate over them, the one collective of the harness before
        the windows."""
        window = client.run(0.0, units=frames)
        mine = torch.tensor([window.units / window.seconds],
                            dtype=torch.float64, device=self.group.device)
        self.rate = float(self.group.broadcast(mine)[0])
        signal.alarm(self.limit_s)

    def window(self, client, seconds: float):
        """A window of the frames that the agreed rate gives for
        ``seconds``, the same count on every rank."""
        return client.run(seconds, units=max(1, round(seconds * self.rate)))

    def since_start(self) -> float:
        return time.monotonic() - self.origin

    def gather(self, peak: int, busy, recorder):
        """After the windows: (the ranks' largest peak, their mean busy
        seconds or None, {metric: each rank's span total} of the
        metrics every rank has)."""
        names = sorted(recorder.spans)
        spans = [recorder.span_ms(m) for m in names]
        mine = torch.tensor(
            [peak, math.nan if busy is None else busy]
            + [math.nan if v is None else v for v in spans],
            dtype=torch.float64, device=self.group.device)
        rows = torch.stack(self.group.all_gather(mine)).cpu()
        busy = None if busy is None else float(rows[:, 1].mean())
        by_rank = {m: rows[:, 2 + k].tolist() for k, m in enumerate(names)
                   if not rows[:, 2 + k].isnan().any()}
        return int(rows[:, 0].max()), busy, by_rank


def rank_main(group, bench_path: str, workload: str, seed: int,
              seconds: float, trace: bool, origin: float, sizes, mix,
              prepare):
    """One rank's run (``spawn``'s ``fn``): its result line (rank 0's;
    None on the others) and the forbidden modules it loaded."""
    signal.alarm(SETUP_LIMIT_S)
    if prepare is not None:
        prepare(group)
    from ptbench.cell import Cell

    cell = Cell(workload, bench_path)
    split = {**cell.mix, **(mix or {})}["split"]
    rank = Rank(group, origin, split,
                WINDOWS_LIMIT_S + 3 * math.ceil(seconds))
    line = run.run_cell(cell, seed, seconds, trace, group.device, sizes, mix,
                        rank=rank)
    return {"line": line, "forbidden": run.forbidden_modules()}


def run_ranks(cell, seed: int, seconds: float, trace: bool, device,
              sizes: dict = None, mix: dict = None, prepare=None) -> int:
    """Runs ``cell`` on its ranks and prints rank 0's result
    (``run.report``); returns the exit code.  ``sizes`` and ``mix`` as
    in ``run.run_cell``; ``prepare(group)``, where given, runs first in
    every rank (the CPU tests' faults)."""
    from vulkan_pathtracer_tpu_torch.parallel import distributed

    origin = time.monotonic() - run.since_start()
    config = {**cell.config, **(sizes or {})}
    ranks = int({**cell.mix, **(mix or {})}["ranks"])
    run.scene_file(config["scene"])
    try:
        results = distributed.spawn(rank_main, ranks, device,
                                    cell.bench_path, cell.name, seed, seconds,
                                    trace, origin, sizes, mix, prepare)
    except Exception:  # a rank raised or died; the others are ended
        traceback.print_exc()
        sys.stderr.write(f"ptbench: a rank of {cell.name} failed\n")
        return 5
    return run.report(results[0]["line"],
                      [m for r in results for m in r["forbidden"]])
