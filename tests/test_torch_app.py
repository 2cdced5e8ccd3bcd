"""PyTorch port vs JAX: the app surface on the CPU — ``-v``, the viewer,
``--gltf-quirk-mode``, ``resize``, ``--profile`` and ``app/bench.py``'s
flags.

The cases mirror the JAX package's own tests of each flag
(tests/test_app_cli.py:75, :132, :168, :195; tests/test_parity_extras.py
:32, :101):

- ``checked_render`` (utils/validation.py) runs clean on the box, its
  image allclose (1e-5) to the JAX package's checkified render and
  bitwise the port's plain ``bvh`` render; it raises ValidationError on
  a material row or texture past its table and on NaN; ``validate_bvh``
  accepts a sound tree and rejects a broken one, as JAX's does; the CLI
  under ``-v`` validates, and stops (exit 1) at a non-finite frame.
- The terminal viewer with scripted keys and at EOF; quirk mode moves a
  nested mesh; ``resize`` drops the divider; ``FrameProfiler``; a
  ``--profile`` run writes a Chrome trace.
- ``app/bench.py`` at a tiny size: ``VKPT_MT=mxu`` records ``"mt":
  "mxu"`` and runs the coefficient kernels' plain versions,
  ``VKPT_PRESPLIT=x`` (not a number) exits 2, and ``--spp``, ``--leaf`` (with
  ``VKPT_LEAF``), ``--traversal``, ``--headline joint``, ``--scene``
  as a path, ``atrium_mixed --detail``, ``--mode pooled`` and ``--mode
  animated`` (two-level and ``--flat``).
"""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.ops.bvh import validate_bvh as jax_validate_bvh
from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
from vulkan_pathtracer_tpu.utils.validation import (
    checked_render as jax_checked_render,
)
from vulkan_pathtracer_tpu_torch.app import bench
from vulkan_pathtracer_tpu_torch.app.main import main as port_main
from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.bvh import build_bvh_host, validate_bvh
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig, read_png
from vulkan_pathtracer_tpu_torch.utils.profiling import FrameProfiler
from vulkan_pathtracer_tpu_torch.utils.validation import (
    ValidationError,
    check_finite,
    checked_render,
)

from tests.native_guard import native_libraries  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_libraries")


def _box_camera():
    return Camera(aspect_ratio=1.0,
                  position=np.array([0, 0, -3], np.float32))


@pytest.fixture(scope="module")
def box_scene(box_glb):
    return build_device_scene(gltf.load(box_glb), max_leaf_size=4,
                              device="cpu")


def test_checked_render_validation(box_glb, box_scene):
    """The checked frame runs clean on a healthy scene: finite, the JAX
    package's checkified frame within 1e-5, the port's plain ``bvh``
    frame bit for bit."""
    img = checked_render(box_scene, _box_camera(), RenderConfig(), width=24,
                         height=24)
    assert img.shape == (24, 24, 3) and bool(torch.isfinite(img).all())
    jd = jax_build(jgltf.load(box_glb), build_bvh=True, max_leaf_size=4)
    ref = jax_checked_render(jd, _box_camera(), JaxConfig(), width=24,
                             height=24)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    plain, _ = RenderPipeline(box_scene, RenderConfig(
        resolution_x=24, resolution_y=24, traversal="bvh")).render(
            _box_camera(), 0)
    assert torch.equal(img, plain)


@pytest.mark.parametrize("fault", ["material", "texture", "nan"])
def test_checked_render_catches_faults(box_glb, fault):
    """An index past its table, or a NaN, is a ValidationError, not a
    silent clamp (on the card: a device-side assert)."""
    scene = build_device_scene(gltf.load(box_glb), max_leaf_size=4,
                               device="cpu")
    if fault == "material":
        ids = scene.tri_attr[:, 30].contiguous().view(torch.int32)
        ids += scene.mat_packed.shape[0]
        scene.tri_attr[:, 30] = ids.view(torch.float32)
        match = "material row out of range"
    elif fault == "texture":
        scene.tex_offset[0] = scene.tex_texels.shape[0]
        match = "texels outside the pool"
    else:
        image = torch.zeros((4, 4, 3))
        image[1, 2, 0] = float("nan")
        with pytest.raises(ValidationError, match="1 non-finite"):
            check_finite(image)
        scene.tri_attr[:, 0:9] = float("nan")   # vertex normals
        match = "non-finite"
    with pytest.raises(ValidationError, match=match):
        checked_render(scene, _box_camera(), RenderConfig(), width=24,
                       height=24)


def test_validate_bvh_matches_jax(box_scene):
    """``validate_bvh`` accepts the box's tree and rejects a broken skip
    pointer, as the JAX package's does."""
    n = box_scene.num_triangles
    v0, e1, e2 = (t[:n].numpy() for t in (box_scene.tri_v0, box_scene.tri_e1,
                                          box_scene.tri_e2))
    bvh = build_bvh_host(v0, e1, e2)
    args = (v0[bvh.tri_order], e1[bvh.tri_order], e2[bvh.tri_order])
    for check in (validate_bvh, jax_validate_bvh):
        check(bvh, *args)
    bvh.skip[0] = 0
    for check in (validate_bvh, jax_validate_bvh):
        with pytest.raises(AssertionError):
            check(bvh, *args)


def test_cli_validation(box_glb, tmp_path, capsys, monkeypatch):
    """``-v``: the BVH invariants and the checked frame pass, the frame
    renders; a non-finite frame ends the run with exit 1."""
    out = str(tmp_path / "v.png")
    base = ["-s", box_glb, "-x", "32", "-y", "24", "-v", "--device", "cpu"]
    assert port_main(base + ["-o", out]) == 0
    err = capsys.readouterr().err
    assert "BVH invariants validated" in err
    assert "render validation passed" in err
    assert read_png(out).shape == (24, 32, 3)
    real_render = RenderPipeline.render

    def nan_render(self, *args, **kwargs):
        image, rays = real_render(self, *args, **kwargs)
        return image * float("nan"), rays

    monkeypatch.setattr(RenderPipeline, "render", nan_render)
    assert port_main(base + ["-o", str(tmp_path / "nan.png")]) == 1
    assert "validation failed: frame 0" in capsys.readouterr().err
    assert not (tmp_path / "nan.png").exists()


def test_interactive_viewer_scripted(box_scene):
    """Terminal viewer with scripted keys: frames render as ANSI
    half-blocks, WASD/look keys drive the camera, 'q' quits."""
    pipeline = RenderPipeline(box_scene, RenderConfig(
        resolution_x=16, resolution_y=16, traversal="bvh"))
    cam = _box_camera()
    pos0 = cam.position.copy()
    yaw0 = cam.yaw
    out = io.StringIO()
    frames = run_viewer(pipeline, cam, out=out, keys=io.StringIO("wjq"))
    assert frames == 3   # w, j, then q quits after the 3rd present
    text = out.getvalue()
    assert "▀" in text and "\x1b[38;2;" in text
    assert cam.position[2] > pos0[2]
    assert cam.yaw != yaw0


def test_interactive_viewer_eof_quits(box_scene, tmp_path, capsys):
    pipeline = RenderPipeline(box_scene, RenderConfig(
        resolution_x=8, resolution_y=8, traversal="bvh"))
    frames = run_viewer(pipeline, _box_camera(), out=io.StringIO(),
                        keys=io.StringIO(""))
    assert frames == 1


def _nested_box(box_glb, path):
    """The box under a non-mesh node with its own translation."""
    raw = open(box_glb, "rb").read()
    json_len, _ = struct.unpack_from("<II", raw, 12)
    doc = json.loads(raw[20:20 + json_len])
    doc["nodes"] = [{"children": [1], "translation": [0.0, 0.0, 4.0]},
                    {"mesh": 0}]
    doc["scenes"] = [{"nodes": [0]}]
    new_json = json.dumps(doc, separators=(",", ":")).encode()
    new_json += b" " * ((-len(new_json)) % 4)
    rest = raw[20 + json_len:]
    total = 12 + 8 + len(new_json) + len(rest)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(new_json), 0x4E4F534A) + new_json + rest
    with open(path, "wb") as f:
        f.write(out)


def test_gltf_quirk_mode_flag(box_glb, tmp_path):
    """--gltf-quirk-mode reaches gltf.load end to end: quirk mode moves
    the nested mesh, so the two renders differ while both exit 0."""
    scene_path = str(tmp_path / "nested.glb")
    _nested_box(box_glb, scene_path)
    pngs = [str(tmp_path / "plain.png"), str(tmp_path / "quirk.png")]
    base = ["-s", scene_path, "-x", "24", "-y", "24", "--frames", "1",
            "--device", "cpu", "--stats-interval", "0.5"]
    assert port_main(base + ["-o", pngs[0]]) == 0
    assert port_main(base + ["-o", pngs[1], "--gltf-quirk-mode"]) == 0
    a, b = read_png(pngs[0]), read_png(pngs[1])
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_resize_drops_divider_like_reference(box_scene):
    """RaytracingPass.zig:677-704: resize recreates the target at the
    FULL new extent, not reapplying the divider."""
    pipe = RenderPipeline(box_scene, RenderConfig(
        resolution_x=64, resolution_y=64, render_resolution_divider=2))
    assert pipe.width == 32
    pipe2 = pipe.resize(48, 40)
    assert (pipe2.width, pipe2.height) == (48, 40)
    assert pipe2.config.render_resolution_divider == 1
    image, _ = pipe2.render(_box_camera(), 0)
    assert image.shape == (40, 48, 3)


def test_frame_profiler():
    import time

    prof = FrameProfiler()
    for _ in range(3):
        with prof.phase("render"):
            time.sleep(0.001)
    summary = prof.summary()
    assert summary["render"]["count"] == 3
    assert summary["render"]["mean_ms"] >= 1.0


def test_cli_profile_writes_trace(box_glb, tmp_path, capsys):
    """``--profile DIR``: the frame loop runs inside a torch.profiler
    trace, written to DIR/trace.json with the frames' operators."""
    trace_dir = tmp_path / "trace"
    assert port_main(["-s", box_glb, "-x", "24", "-y", "16", "--frames",
                      "2", "--profile", str(trace_dir), "-o",
                      str(tmp_path / "p.png"), "--device", "cpu"]) == 0
    assert f"profiling to {trace_dir}" in capsys.readouterr().err
    events = json.loads((trace_dir / "trace.json").read_text())[
        "traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def _bench(args, capsys, monkeypatch=None, env=None):
    """app/bench.py at 40x32 on the CPU: (exit code, its JSON lines)."""
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    rc = bench.main(["--device", "cpu", "--width", "40", "--height", "32",
                     "--frames", "2", *args])
    out = capsys.readouterr().out
    return rc, [json.loads(ln) for ln in out.splitlines()]


def test_bench_tiers_from_env(capsys, monkeypatch):
    """VKPT_MT=mxu reaches the bake and the render: the line records
    ``"mt": "mxu"`` and every launch is a coefficient kernel's."""
    names = []
    real_dispatch = st._dispatch

    def spy(name, origin, plain, launch):
        names.append(name)
        return real_dispatch(name, origin, plain, launch)

    monkeypatch.setattr(st, "_dispatch", spy)
    rc, lines = _bench(["--scene", "cornell", "--mode", "headline"], capsys,
                       monkeypatch, {"VKPT_MT": "mxu"})
    assert rc == 0 and lines[0]["detail"]["mt"] == "mxu"
    # Cornell (leaf 14, emissive): pair primaries, quad later bounces.
    assert names and set(names) == {"pair_closest_hit_coef",
                                    "quad_closest_hit_coef"}


@pytest.mark.parametrize("env,args", [
    ({"VKPT_PRESPLIT": "x"}, []),
    ({"VKPT_MXU_PRECISION": "default"}, []),
    ({}, ["--mode", "spp", "--spp", "2"])])
def test_bench_refuses(env, args, capsys, monkeypatch):
    """What the port refuses exits 2 before anything renders."""
    rc, lines = _bench(["--scene", "cornell", *args], capsys, monkeypatch,
                       env)
    assert rc == 2 and lines == []


@pytest.mark.parametrize("flat", [False, True],
                         ids=["instanced", "flat"])
def test_bench_animated(flat, capsys, monkeypatch):
    """--mode animated (experiments/animated_bench.py): the Cornell box's
    instance moved every frame, two-level through
    update_instance_transforms or, with --flat, the AnimatedScene's
    rebake and refit; one line with ms/frame and Mrays/s."""
    args = ["--scene", "cornell", "--mode", "animated"]
    rc, lines = _bench(args + (["--flat"] if flat else []), capsys,
                       monkeypatch)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    kind = "flat" if flat else "instanced"
    assert line["metric"] == f"animated_{kind}_ms_per_frame"
    assert line["value"] > 0 and line["detail"]["mrays_per_sec"] > 0
    assert line["detail"]["rays"] > 2 * 40 * 32 and line["device"] == "cpu"
    assert line["detail"]["leaf"] == 8


def test_bench_missing_scene_file(capsys, tmp_path):
    rc, lines = _bench(["--scene", str(tmp_path / "missing.glb")], capsys)
    assert rc == 1 and lines == []


@pytest.mark.parametrize("case", ["spp", "leaf_env", "leaf_flag",
                                  "traversal", "joint", "path", "mixed"])
def test_bench_headline_flags(case, capsys, monkeypatch, cornell_glb):
    """Each headline flag reaches the line's detail; ``--headline joint``
    traces the frame path's rays."""
    args = {"spp": ["--spp", "2"], "leaf_env": [],
            "leaf_flag": ["--leaf", "8"], "traversal": ["--traversal", "bvh"],
            "joint": ["--headline", "joint"], "path": ["--scene", cornell_glb],
            "mixed": ["--scene", "atrium_mixed", "--detail", "0.5"]}[case]
    if "--scene" not in args:
        args = ["--scene", "cornell", *args]
    env = {"VKPT_LEAF": "4"} if case.startswith("leaf") else {}
    rc, lines = _bench(["--mode", "headline", *args], capsys, monkeypatch,
                       env)
    assert rc == 0 and len(lines) == 1
    detail = lines[0]["detail"]
    assert lines[0]["value"] > 0 and detail["rays"] > 2 * 40 * 32
    want = {"spp": ("spp", 2), "leaf_env": ("leaf", 4),
            "leaf_flag": ("leaf", 8), "traversal": ("traversal", "bvh"),
            "joint": ("headline", "joint"), "path": ("scene", cornell_glb),
            "mixed": ("triangles", 14448)}[case]
    assert detail[want[0]] == want[1]
    if case == "joint":
        rc, frame_lines = _bench(["--mode", "headline", "--scene",
                                  "cornell"], capsys)
        assert frame_lines[0]["detail"]["rays"] == detail["rays"]


def test_bench_pooled(capsys):
    """``--mode pooled``: sequential and pooled lines over the same
    frames, with the same rays."""
    rc, lines = _bench(["--scene", "cornell", "--mode", "pooled",
                        "--pool-frames", "3"], capsys)
    assert rc == 0
    assert [ln["metric"] for ln in lines] == [
        "flythrough_sequential_mrays_per_sec",
        "flythrough_pooled_mrays_per_sec"]
    seq, pooled = (ln["detail"] for ln in lines)
    assert seq["rays"] == pooled["rays"] > 3 * 40 * 32
    assert seq["frames"] == 3 and pooled["ms_per_frame"] > 0
    assert pooled["pooled_over_sequential"] == pytest.approx(
        seq["seconds"] / pooled["seconds"])
    assert all(ln["device"] == "cpu" for ln in lines)
