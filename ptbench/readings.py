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
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


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

    from ptbench import check
    from ptbench.cell import Cell
    from ptbench.traffic import Traffic

    if not torch.cuda.is_available():
        sys.stderr.write("ptbench.readings: needs a CUDA device\n")
        return 3
    device = torch.device("cuda")
    cell = Cell(args.workload)
    config, mix = cell.config, cell.mix
    program = run.Program(config, device)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        traffic = Traffic(mix, seed, config["width"], config["height"],
                          device)
        client = program.client(traffic)
        if k == 0:
            client.warm_up()
        window = client.run(args.seconds)
        t0 = time.perf_counter()
        out = check.compare(window.kept, traffic, config,
                            program.scene_path, device,
                            control=k < args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "units": window.units, "kept": len(window.kept),
            "compared": out["compared"],
            "pixels_off": out["numbers"]["pixels_off"]["value"],
            "control_pixels_off": out["control"],
            "check_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
