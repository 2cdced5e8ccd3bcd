"""``ptbench.program_spans`` in small runs on the CPU: the program's
tracer over each kind of traffic.  The CPU has no device trace, so the
metrics that read one are left out; ``host_syncs`` and
``traverse_live_share`` read the program alone, and the live lanes the
tracer counted equal the rays the window's calls returned."""

from __future__ import annotations

import io

import pytest
import torch

from ptbench import program_spans
from ptbench.cell import Cell
from ptbench.tests.conftest import SEED, SIZES, small_mix


@pytest.mark.parametrize("workload", ["atrium-flat.orbit",
                                      "atrium-tlas.orbit",
                                      "atrium-flat.still",
                                      "atrium-flat.flythrough"])
def test_a_traced_small_run_reads_the_program(workload):
    cell = Cell(workload)
    out = io.StringIO()
    [line] = program_spans.run(workload, [SEED], 0.5, torch.device("cpu"),
                               sizes=SIZES, mix=small_mix(cell), out=out)
    suffix = ".still" if cell.mix["unit"] == "spp" else ".frame"
    assert set(line["metrics"]) == {"host_syncs" + suffix,
                                    "traverse_live_share" + suffix}
    assert line["metrics"]["host_syncs" + suffix]["value"] == 0.0
    share = line["metrics"]["traverse_live_share" + suffix]["value"]
    assert 0.0 < share <= 100.0
    assert line["live_lanes"] == line["rays_returned"] > 0
    assert line["lanes_launched"] >= line["live_lanes"]
    assert line["units"] > 0 and "clock" not in line
    assert out.getvalue().count("\n") == 1


def test_readings_per_unit():
    """Every metric from a record and an attribution, per output unit."""
    from vulkan_pathtracer_tpu_torch.utils import profiling

    spans = [{"name": "frame", "id": 0, "parent": -1, "root": 0,
              "start_ns": 0, "end_ns": 10, "j": None, "lanes": 0,
              "key": None, "live": None},
             {"name": "bounce", "id": 1, "parent": 0, "root": 0,
              "start_ns": 1, "end_ns": 9, "j": 0, "lanes": 0, "key": None,
              "live": 90},
             {"name": "traverse", "id": 2, "parent": 1, "root": 0,
              "start_ns": 2, "end_ns": 3, "j": None, "lanes": 100,
              "key": "quad_closest_hit", "live": None},
             {"name": "shade", "id": 3, "parent": 1, "root": 0,
              "start_ns": 4, "end_ns": 5, "j": None, "lanes": 0,
              "key": None, "live": None}]
    record = profiling.Record(spans=spans,
                              syncs=[(3, "a.py:1", 4), (3, "a.py:1", 5),
                                     (-1, "b.py:2", 11)])
    clock = profiling.Clock(0.0, 0.0, 0.0, 1, "launches")
    at = profiling.Attribution(
        clock=clock, window_us=1000.0, busy_us=600.0,
        device_us={2: 200.0, 3: 300.0}, unattributed_us=0.0,
        idle_by_span={}, idle_in_roots={"frame": 100.0}, host_us=800.0,
        wait_us=300.0, wait_by_site={}, spans=spans)
    values = program_spans.readings(record, at, units=2)
    assert values == pytest.approx({
        "host_enqueue_ms": 0.25, "host_wait_ms": 0.15, "host_syncs": 1.0,
        "idle_in_program": 10.0, "shade_span_ms": 0.15,
        "sort_span_ms": 0.0, "traverse_live_share": 90.0})
    assert set(values) == set(program_spans.METRICS)
