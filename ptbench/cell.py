"""A cell of ``BENCHMARK.json`` and the files it is made of, found by
name:

- the configuration: ``configs/<config>.json`` (the entry's ``file``);
- the traffic mix: ``traffic/<traffic>.json``;
- each end-to-end metric: ``end_to_end/<name>.py``;
- each per-layer metric: ``metrics/<name up to its first dot>.py``.

A metric belongs to the cell when it has no ``workloads`` key or its
``workloads`` name the cell.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(package: str, name: str):
    return importlib.import_module(f"ptbench.{package}.{name.split('.')[0]}")


class Cell:
    def __init__(self, workload: str, bench_path: str = None):
        self.bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
        bench = _load_json(self.bench_path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                           f"{', '.join(cells)}")
        entry = cells[workload]
        self.name = workload
        self.chips = int(entry["chips"])
        config = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
        self.config = _load_json(os.path.join(ROOT, config["file"]))
        self.traffic_name = entry["traffic"]
        self.mix = _load_json(os.path.join(HERE, "traffic",
                                           f"{entry['traffic']}.json"))

        def mine(metrics):
            return [m for m in metrics
                    if workload in m.get("workloads", [workload])]

        self.end_to_end = [(m, _reader("end_to_end", m["name"]))
                           for m in mine(bench["end_to_end"])]
        self.per_layer = [(m, _reader("metrics", m["name"]))
                          for m in mine(bench["per_layer"])]
