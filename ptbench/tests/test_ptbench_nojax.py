"""The benchmark and what it runs load no JAX: the check compares whole
top-level module names, since the program's package name begins with
the JAX package's."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from ptbench.cell import ROOT
from ptbench.run import forbidden_modules


@pytest.mark.parametrize("names, found", [
    (["vulkan_pathtracer_tpu_torch", "vulkan_pathtracer_tpu_torch.ops"], []),
    (["vulkan_pathtracer_tpu.ops.rng"], ["vulkan_pathtracer_tpu.ops.rng"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["jaxtyping", "flaxen", "vulkan_pathtracer_tpux"], []),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def test_a_run_loads_no_jax():
    """A small run of every mix in a fresh process leaves none of the
    forbidden modules in sys.modules."""
    code = (
        "import torch\n"
        "from ptbench.cell import Cell\n"
        "from ptbench.run import run_cell, forbidden_modules\n"
        "from ptbench.tests.conftest import SIZES, small_mix\n"
        "for w in ('atrium-flat.orbit', 'atrium-tlas.orbit',\n"
        "          'atrium-flat.still', 'atrium-flat.flythrough'):\n"
        "    cell = Cell(w)\n"
        "    run_cell(cell, 7, 0.2, w.endswith('orbit'),\n"
        "             torch.device('cpu'), sizes=SIZES, mix=small_mix(cell))\n"
        "print('FOUND', forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
