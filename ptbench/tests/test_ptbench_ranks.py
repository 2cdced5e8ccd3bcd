"""A cell on several cards (``ranks.py``), on four gloo ranks on the CPU:
``atrium-flat.tiles4`` at the tiny atrium's 64 x 36 (9 rows a rank).
The cell is not among ``BENCHMARK.json``'s: the tests find it in a copy
of that file that adds it as ``TILES4`` shows, with the metrics it
would join (``tiles4_bench``).  Each run is a process of its own (``rank_faults.py``) under a time limit
of its own, so that a run that hangs fails its test and holds no other.
Rank 0's frames are the one-process run's bit for bit; a run with the
split path broken underneath is not correct, once for each fault the
cell can have; a rank that raises ends the run, and one that loads JAX
fails it.  Also: a traffic kind beyond the three built in is found as a
module file, and the two readers of the multi-device layer."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from ptbench.cell import ROOT, Cell
from ptbench.metrics import exchange_ms, tile_wait_ms
from ptbench.run import Program, run_cell
from ptbench.tests.conftest import SEED, SIZES, small_mix
from ptbench.traffic import Traffic

WORKLOAD = "atrium-flat.tiles4"
RUN_TIMEOUT_S = 240

# The four-card cell as BENCHMARK.json would hold it: its entry, the
# metrics that it joins, and the two of the multi-device layer.
TILES4 = {
    "workload": {"name": WORKLOAD, "config": "atrium-flat",
                 "traffic": "tiles4", "chips": 4,
                 "why": "a four-GPU viewer: each 1080p orbit frame split "
                        "into four 270-row tiles, one per card, "
                        "all-gathered"},
    "joins": ("fps", "frame_ms_p95", "traverse_ms.frame",
              "traverse_roofline.frame", "shade_ms.frame", "sort_ms.frame",
              "device_idle.frame", "bake_s"),
    "per_layer": [
        {"name": "exchange_ms.frame", "unit": "ms/frame", "better": "lower",
         "source": "device_trace", "layer": "multi-device", "moves": "fps",
         "workloads": [WORKLOAD]},
        {"name": "tile_wait_ms.frame", "unit": "ms/frame",
         "better": "lower", "source": "program_span",
         "layer": "multi-device", "moves": "fps", "workloads": [WORKLOAD]}],
}


def with_tiles4(bench: dict) -> dict:
    """``bench`` (BENCHMARK.json's contents) with ``TILES4`` added, where
    the cell is not there already."""
    if all(w["name"] != WORKLOAD for w in bench["workloads"]):
        bench["workloads"].append(TILES4["workload"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in TILES4["joins"] and "workloads" in m:
                m["workloads"].append(WORKLOAD)
        bench["per_layer"] += TILES4["per_layer"]
    return bench


@pytest.fixture(scope="module")
def tiles4_bench(tmp_path_factory) -> str:
    """The path of a copy of BENCHMARK.json that holds the cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = with_tiles4(json.load(f))
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench, indent=1))
    return str(path)


def spawn_run(bench: str, fault: str, *extra, seed: int = SEED):
    """The small run with ``fault`` planted in every rank."""
    return subprocess.run(
        [sys.executable, "-m", "ptbench.tests.rank_faults", WORKLOAD,
         str(seed), fault, "--bench", bench, *extra], cwd=ROOT,
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": ROOT})


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_rank0_frames_are_the_one_process_run(tmp_path, tiles4_bench):
    dump = tmp_path / "kept.pt"
    line = last_line(spawn_run(tiles4_bench, "sound", "--dump", str(dump)))
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert line["checks"]["pixels_off"]["value"] == 0.0
    # The CPU has no CUDA events to read frame_ms_p95 from.
    assert set(line["metrics"]) == {"fps", "setup_s"}
    kept = torch.load(dump)

    cell = Cell(WORKLOAD, tiles4_bench)
    config = {**cell.config, **SIZES}
    mix = {**cell.mix, **small_mix(cell)}
    cpu = torch.device("cpu")
    program = Program(config, cpu)
    client = program.client(Traffic(mix, SEED, config["width"],
                                    config["height"], cpu))
    client.warm_up()
    window = client.run(0.0, units=line["attempted"])
    assert [(k["index"], k["frame"]) for k in window.kept] == \
        [(index, frame) for index, frame, _ in kept]
    for k, (_, _, values) in zip(window.kept, kept):
        assert torch.equal(k["values"], values)


def test_a_traced_run_on_ranks_reports_rank0(tiles4_bench):
    line = last_line(spawn_run(tiles4_bench, "sound", "--trace",
                               seed=SEED + 1))
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    # The CPU has no device trace and no CUDA events: bake_s alone.
    assert set(line["metrics"]) == {"bake_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "exchange_left_out", "answer_altered"])
def test_a_broken_split_is_not_correct(fault, tiles4_bench):
    line = last_line(spawn_run(tiles4_bench, fault))
    assert line["correct"] is False
    off = line["checks"]["pixels_off"]
    assert off["value"] > off["limit"]


def test_a_failing_rank_ends_the_run(tiles4_bench):
    proc = spawn_run(tiles4_bench, "rank_raises")
    assert proc.returncode == 5
    assert proc.stdout.strip() == ""
    # The traceback shown is of the first rank to exit: rank 2's own, or
    # a peer's whose collective it left.
    assert f"ptbench: a rank of {WORKLOAD} failed" in proc.stderr


def test_jax_in_any_rank_fails_the_run(tiles4_bench):
    proc = spawn_run(tiles4_bench, "jax_in_rank")
    assert proc.returncode == 4
    assert proc.stdout.strip() == ""
    assert "JAX was loaded: jax" in proc.stderr


KIND = '''
SMALL = {"calibration": 3}


def warm_up(client):
    tr = client.tr
    client.pipe.render(tr.camera(0, client.cam_type, client.aspect), tr.base)


def loop(client, win, more):
    client._frames(win, more)
'''


def test_an_unknown_kind_is_found_as_a_module_file(tmp_path, monkeypatch):
    import ptbench.kinds

    (tmp_path / "replay.py").write_text(KIND)
    monkeypatch.setattr(ptbench.kinds, "__path__",
                        [*ptbench.kinds.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "ptbench.kinds.replay", raising=False)
    cell = Cell("atrium-flat.orbit")
    cell.mix = {**cell.mix, "kind": "replay"}
    try:
        mix = small_mix(cell)
        line = run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                        sizes=SIZES, mix=mix)
        found = sys.modules["ptbench.kinds.replay"].__file__
    finally:
        sys.modules.pop("ptbench.kinds.replay", None)
    assert found == str(tmp_path / "replay.py")
    assert mix["calibration"] == 3      # the module's SMALL
    assert line["correct"] is True and line["attempted"] > 0
    with pytest.raises(ModuleNotFoundError):
        Traffic({**cell.mix, "kind": "no_such_kind"}, SEED, 64, 36,
                torch.device("cpu"))


def test_tile_wait_is_the_slowest_rank_over_the_mean():
    def ctx(totals):
        return types.SimpleNamespace(rank_span_ms=lambda m: totals,
                                     span_units=2)
    assert tile_wait_ms.read(ctx([10.0, 14.0, 12.0, 12.0])) == 1.0
    assert tile_wait_ms.read(ctx([5.0])) is None
    assert tile_wait_ms.read(ctx(None)) is None


def test_exchange_is_the_nccl_kernels_per_frame():
    from ptbench.devtrace import DeviceTrace

    trace = DeviceTrace(ops=[("ncclDevKernel_AllGather_RING_LL", 0, 300),
                             ("stack_kernel", 300, 900),
                             ("ncclDevKernel_AllReduce_Sum_i64", 900, 1000)],
                        window_s=0.01)
    ctx = types.SimpleNamespace(
        kernel_seconds=trace.seconds_of, trace_units=4)
    assert exchange_ms.read(ctx) == pytest.approx(0.1)
    none = types.SimpleNamespace(kernel_seconds=lambda p: None,
                                 trace_units=4)
    assert exchange_ms.read(none) is None
