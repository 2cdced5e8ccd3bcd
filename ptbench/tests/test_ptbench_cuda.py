"""The benchmark on the card, at the cells' own sizes (marked ``cuda``;
each test skips without a CUDA device, decided in the fixture):

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        ptbench/tests/test_ptbench_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from ptbench.cell import Cell
from ptbench.run import run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_orbit_run_is_correct(card):
    line = run_cell(Cell("atrium-flat.orbit"), 2**31 + 5, 2.0, False, card)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert {"fps", "frame_ms_p95", "setup_s"} <= set(line["metrics"])


def test_traced_run_reads_every_layer(card):
    cell = Cell("atrium-flat.orbit")
    line = run_cell(cell, 2**31 + 6, 2.0, True, card)
    assert line["correct"] is True
    names = {m["name"] for m, _ in cell.per_layer}
    assert set(line["metrics"]) == names
    roofline = line["metrics"]["traverse_roofline.frame"]["value"]
    assert 0.0 < roofline <= 100.0
    assert 0.0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
