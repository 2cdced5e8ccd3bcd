"""Small runs of the benchmark on the CPU: the tiny atrium (detail 0.02,
10,260 triangles) at 64 x 36, the program's plain PyTorch versions in
place of its CUDA kernels.  ``small_run`` skips the harness's look for
a card and drives the rest of a run."""

from __future__ import annotations

import importlib

import pytest
import torch

from ptbench.cell import Cell
from ptbench.run import run_cell

SIZES = {"width": 64, "height": 36,
         "scene": {"generator": "atrium", "detail": 0.02, "n_materials": 32}}
MIXES = {"frames": {"calibration": 2},
         "joint": {"batch": 4, "target_spp": 8},
         "pooled": {"group": 3}}
SEED = 2**31 + 12345


def small_mix(cell: Cell) -> dict:
    """The small run's mix entries: a built-in kind's from ``MIXES``, a
    kind module's from its ``SMALL`` (``ptbench/kinds``)."""
    kind = cell.mix["kind"]
    small = (MIXES[kind] if kind in MIXES else
             importlib.import_module(f"ptbench.kinds.{kind}").SMALL)
    return {**small, "trace_seconds": 0.5,
            "check": {**cell.mix["check"], "pixels": 768}}


@pytest.fixture
def small_run():
    def run(workload: str, seconds: float = 0.5, trace: bool = False,
            seed: int = SEED):
        cell = Cell(workload)
        return run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                        sizes=SIZES, mix=small_mix(cell))
    return run
