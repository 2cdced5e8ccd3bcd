"""The animated cell, ``columns-tlas.animated``, on the CPU: a small run
of its mix end to end (the kind's ``SMALL`` on a 3 x 3 columns scene at
64 x 36), the control (the animated reference in bfloat16) failing the
check, the clock carried by the scene's file, a program that cannot
pose refused at the warm-up, the update's least bytes, and a reference
that loads neither JAX nor the program."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from ptbench import check, update_work
from ptbench.cell import ROOT, Cell
from ptbench.kinds import animated
from ptbench.orbit import camera_vectors
from ptbench.reference_animated import render
from ptbench.run import Program, run_cell, scene_file
from ptbench.tests.conftest import SEED, small_mix
from ptbench.traffic import Traffic

CELL = "columns-tlas.animated"
SIZES = {"width": 64, "height": 36,
         "scene": {"generator": "columns", "grid": 3, "segments": 2,
                   "n_materials": 4, "period_frames": 128,
                   "frames_per_second": 32}}


def test_clock_travels_with_the_scene():
    """The configuration's scene writes its clock into the file, where
    the reference reads it; the mix states the same rule for the kind."""
    cell = Cell(CELL)
    spec = cell.config["scene"]
    rule = (spec["period_frames"], spec["frames_per_second"])
    assert rule == (cell.mix["clock"]["period_frames"],
                    cell.mix["clock"]["frames_per_second"]) == (128, 32)
    doc = render.load_scene(scene_file(SIZES["scene"])).doc
    assert doc.clock == rule
    frame = 2**31 + 130
    assert doc.seconds(frame) == animated.seconds(frame, rule) == 2.0 / 32


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_small_run(trace):
    cell = Cell(CELL)
    line = run_cell(cell, SEED, 0.5, trace, torch.device("cpu"),
                    sizes=SIZES, mix=small_mix(cell))
    assert line["correct"] is True and line["attempted"] > 0
    assert line["checks"]["pixels_off"]["value"] <= 0.5
    want = {"bake_s"} if trace else {"fps", "setup_s"}
    assert want <= set(line["metrics"])
    # CUDA events alone time the update: nothing on the CPU.
    assert "update_ms.frame" not in line["metrics"]


def test_control_fails_the_check():
    cell = Cell(CELL)
    mix = {**cell.mix, "check": {**cell.mix["check"], "pixels": 1024}}
    w, h = SIZES["width"], SIZES["height"]
    path = scene_file(SIZES["scene"])
    traffic = Traffic(mix, 99, w, h, torch.device("cpu"))
    scene = render.load_scene(path)
    kept = []
    for i, frame in enumerate((5, 70)):
        vectors = camera_vectors(*traffic.pose(i), aspect=w / h)
        kept.append({"index": i, "frame": frame, "values": render.render_views(
            scene, [(vectors, frame)], traffic.px, traffic.py, w, h, 2)[0]})
    config = {**cell.config, **SIZES}
    out = check.compare(kept, traffic, config, path, torch.device("cpu"),
                        control=True)
    assert out["numbers"]["pixels_off"]["value"] == 0.0
    assert out["control"] > mix["check"]["limit"]


def test_a_static_program_is_refused():
    cell = Cell(CELL)
    program = Program({**cell.config, **SIZES}, torch.device("cpu"))
    program.pipe.animation = None
    traffic = Traffic({**cell.mix, **small_mix(cell)}, 1, 64, 36,
                      torch.device("cpu"))
    with pytest.raises(RuntimeError, match="does not pose"):
        animated.warm_up(program.client(traffic))


def test_least_bytes_of_an_update():
    path = scene_file(SIZES["scene"])
    n, columns = 10, 9
    keys = columns * 2 * (4 + 12) + columns * 2 * (4 + 16)
    assert update_work.least_bytes(path) == (
        keys + n * 48 + n * 24 + (2 * n - 1) * 24)
    assert update_work.least_seconds(path, "cpu") is None


def test_the_reference_imports_no_jax_and_no_program():
    """The animated reference, and the scene and clock it reads, load
    neither JAX nor any module of the program."""
    code = ("import sys\n"
            "import ptbench.reference_animated.render, ptbench.scenes.columns\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'vulkan_pathtracer_tpu',\n"
            "        'vulkan_pathtracer_tpu_torch')]\n"
            "print('FOUND', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
