"""The benchmark's files are found by name, BENCHMARK.json keeps to its
format, and a run's last line has the result's keys."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from ptbench.cell import ROOT, Cell

BENCH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(BENCH) as f:
        return json.load(f)


def workloads():
    return [w["name"] for w in bench()["workloads"]]


def test_top_level_keys():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["ptbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(BENCH) <= 64 * 1024


def test_entries_have_only_the_known_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ptbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in b[k])


@pytest.mark.parametrize("workload", workloads())
def test_every_file_is_found_by_name(workload):
    cell = Cell(workload)
    assert cell.mix["kind"] in ("frames", "joint", "pooled")
    assert cell.config["width"] == 1920 and cell.config["height"] == 1080
    assert any(m["name"] == "setup_s" for m, _ in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for _, reader in cell.end_to_end + cell.per_layer:
        assert callable(reader.read)


def test_layer_metrics_move_a_metric_of_their_cells():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", workloads()):
            assert w in moved.get("workloads", [w])


def test_last_line_has_the_result_keys(small_run):
    line = small_run("atrium-flat.orbit")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert {"fps", "setup_s"} <= set(line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)


def test_no_card_means_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    proc = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload",
         "atrium-flat.orbit", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
