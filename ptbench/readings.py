"""The readings that the check's limits are set from, for one cell, in
one process: the program's ``pixels_off`` on many seeds and the
control's on the same outputs.

    python3 -m ptbench.readings --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--control 3]

The scene is loaded and baked once; then, for each seed, the cell's
traffic runs for ``--seconds`` as in a benchmark run, and the kept
outputs are compared with the float32 reference (the program's
reading) and, for the first ``--control`` seeds, the bfloat16
reference is compared on the same pixels in the program's place (the
control's reading).  One JSON line per seed.  The benchmark's own runs
do not run this.  A cell on several cards runs on its ranks as in a
benchmark run (``ranks.py``: the windows in lockstep, after one
calibration), and rank 0 checks its gathered frames and prints.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def read_seeds(cell, seeds: list, seconds: float, control: int, device,
               rank=None) -> None:
    """One JSON line a seed, on ``device`` or as ``rank`` (``ranks.Rank``,
    which prints on rank 0 alone)."""
    from ptbench import check, run
    from ptbench.traffic import Traffic

    config, mix = cell.config, cell.mix
    program = run.Program(config, device, rank)
    for k, seed in enumerate(seeds):
        traffic = Traffic(mix, seed, config["width"], config["height"],
                          device)
        client = program.client(traffic)
        if k == 0:
            client.warm_up()
            if rank is not None:
                rank.lockstep(client, int(mix["calibration"]))
        window = (client.run(seconds) if rank is None
                  else rank.window(client, seconds))
        if rank is not None and not rank.primary:
            continue
        t0 = time.perf_counter()
        out = check.compare(window.kept, traffic, config,
                            program.scene_path, device,
                            control=k < control)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "units": window.units, "kept": len(window.kept),
            "compared": out["compared"],
            "pixels_off": out["numbers"]["pixels_off"]["value"],
            "control_pixels_off": out["control"],
            "check_s": time.perf_counter() - t0}), flush=True)


def _rank_seeds(group, workload: str, seeds: list, seconds: float,
                control: int) -> None:
    from ptbench import ranks
    from ptbench.cell import Cell

    cell = Cell(workload)
    limit = ranks.WINDOWS_LIMIT_S + len(seeds) * 3 * math.ceil(seconds)
    rank = ranks.Rank(group, time.monotonic(), cell.mix["split"], limit)
    read_seeds(cell, seeds, seconds, control, group.device, rank)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ptbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    from ptbench import run

    run.cache_environment()
    import torch

    from ptbench.cell import Cell

    if not torch.cuda.is_available():
        sys.stderr.write("ptbench.readings: needs a CUDA device\n")
        return 3
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ranks = int(cell.mix.get("ranks", 1))
    if ranks > 1:
        from vulkan_pathtracer_tpu_torch.parallel import distributed

        run.scene_file(cell.config["scene"])
        distributed.spawn(_rank_seeds, ranks, "cuda", args.workload, seeds,
                          args.seconds, args.control)
    else:
        read_seeds(cell, seeds, args.seconds, args.control,
                   torch.device("cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
