"""PyTorch port vs JAX: the fly-through path (pooled frames) on the CPU.

``RenderPipeline.render_pooled`` traces F frames of F cameras at 1 spp
as one wavefront (``wavefront.trace_wavefront_pooled``): bounce 0 on
the frames' tile-ordered primaries frame after frame, each later bounce
sorted by the 6d key across the frames, the colors put back by lane id.

- Against the JAX package's ``render_pooled`` on the Cornell box with
  the three cameras and frames [5, 6, 9] of tests/test_pooled.py (48x40,
  3 bounces): rays equal, images allclose at rtol = atol = 1e-5 (the
  tolerance of test_torch_render.py).
- Against the port's own single frames (``render``) on the CPU: bitwise
  equal images and rays equal to their sum, in shading chunks small
  enough for several launches per bounce, on the Cornell box
  and the ``--instanced`` columns (emissive: closest hits on every
  bounce, unsorted) and an emissive-free atrium of 24,456 triangles
  (sorted bounces, an any hit on the last).  Every lane runs the same per-lane
  operations as its single frame, so no 2^-18 slack (PARITY.md:60) is
  needed.
- A group of one frame equals ``render``; ``num_samples=2`` raises.
- The CLI with ``--pool-frames 2 --frames 3`` along a camera path writes
  the PNG of the per-frame CLI, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.render.pipeline import (
    RenderPipeline as JaxPipeline,
)
from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
from vulkan_pathtracer_tpu_torch.app.main import main as port_main
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.render import pipeline as pl
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig, read_png

from tests.native_guard import native_libraries  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_libraries")

RTOL = ATOL = 1e-5
# tests/test_pooled.py:38-53: three cameras in the Cornell box.
COR_VIEWS = [((0.0, 1.0, 2.5), 180.0), ((0.3, 1.0, 2.4), 175.0),
             ((-0.3, 1.1, 2.6), 185.0)]
COR_FRAMES = [5, 6, 9]


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    from assets.procedural import make_atrium

    path = tmp_path_factory.mktemp("scenes") / "atrium.glb"
    make_atrium(str(path), detail=0.3)
    return str(path)


def _cornell_cams(cls=Camera, aspect=48 / 40):
    cams = []
    for pos, yaw in COR_VIEWS:
        cam = cls(aspect_ratio=aspect, position=np.asarray(pos, np.float32))
        cam.set_orientation(yaw=yaw, pitch=0.0)
        cams.append(cam)
    return cams


def _orbit_cams(aspect, count):
    path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                      center=(0.0, 1.2, 0.0))
    cams = []
    for k in range(count):
        cams.append(Camera(aspect_ratio=aspect))
        path.apply(cams[-1], 4.0 * k / count)
    return cams


@pytest.fixture(scope="module")
def cornell_pipeline(cornell_glb):
    td = build_device_scene(gltf.load(cornell_glb), max_leaf_size=14,
                            device="cpu")
    return RenderPipeline(td, RenderConfig(
        num_samples=1, num_bounces=3, resolution_x=48, resolution_y=40))


def test_pooled_matches_jax(cornell_glb, cornell_pipeline):
    """Three frames, three cameras: the port's pooled group against the
    JAX package's."""
    jd = jax_build(jgltf.load(cornell_glb), build_bvh=True, max_leaf_size=14)
    jpipe = JaxPipeline(jd, JaxConfig(num_samples=1, num_bounces=3,
                                      resolution_x=48, resolution_y=40))
    ref, ref_rays = jpipe.render_pooled(_cornell_cams(JaxCamera), COR_FRAMES)
    got, rays = cornell_pipeline.render_pooled(_cornell_cams(), COR_FRAMES)
    assert got.shape == (3, 40, 48, 3)
    assert bool(torch.isfinite(got).all()) and got.mean() > 0
    assert int(rays) == float(ref_rays) > 3 * 48 * 40
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _scene(name, request):
    if name == "cornell":
        return build_device_scene(gltf.load(request.getfixturevalue(
            "cornell_glb")), max_leaf_size=14, device="cpu")
    if name == "atrium":
        return build_device_scene(gltf.load(request.getfixturevalue(
            "atrium_glb")), max_leaf_size=28, device="cpu")
    return build_instanced_scene(gltf.load(request.getfixturevalue(
        "columns_glb")), max_leaf_size=14, device="cpu")


# name -> (bounces, width, height, frames, shading chunk)
SOLO_CASES = {"cornell": (3, 48, 40, COR_FRAMES, 1000),
              "atrium": (2, 96, 72, [1, 2, 3], 5000),
              "columns_instanced": (2, 64, 48, [4, 7], 2000)}


@pytest.mark.parametrize("name", list(SOLO_CASES))
def test_pooled_equals_single_frames(name, request, monkeypatch):
    """The pooled group against each frame rendered alone: images
    bitwise equal, rays the sum of the frames'; every launch at most one
    chunk, bounce 0 in ceil(M / chunk) launches."""
    bounces, width, height, frames, chunk = SOLO_CASES[name]
    scene = _scene(name, request)
    pipe = RenderPipeline(scene, RenderConfig(
        num_samples=1, num_bounces=bounces, resolution_x=width,
        resolution_y=height))
    cams = (_cornell_cams() if name == "cornell" else
            _orbit_cams(pipe.config.aspect_ratio, len(frames)))
    if name == "columns_instanced":
        lo, hi = scene.root_lo.numpy(), scene.root_hi.numpy()
        path = orbit_path(radius=0.75 * float((hi - lo).max()),
                          height=0.35 * float((hi - lo).max()), duration=4.0,
                          center=tuple((lo + hi) * 0.5))
        for k, cam in enumerate(cams):
            path.apply(cam, 2.0 * k)
    launches = {"closest": [], "any": []}
    real_closest, real_any = wavefront._closest_hit, wavefront._any_hit

    def closest_spy(scene_, origin, *args):
        launches["closest"].append(origin.shape[0])
        return real_closest(scene_, origin, *args)

    def any_spy(scene_, origin, *args):
        launches["any"].append(origin.shape[0])
        return real_any(scene_, origin, *args)

    monkeypatch.setattr(wavefront, "_closest_hit", closest_spy)
    monkeypatch.setattr(wavefront, "_any_hit", any_spy)
    pos, hor, ver, fwd = (torch.stack(v) for v in zip(
        *[pl.camera_tensors(cam, "cpu") for cam in cams]))
    images, rays = pl.render_frames_pooled(
        scene, pos, hor, ver, fwd, frames, num_bounces=bounces, width=width,
        height=height, sort_secondary=pipe._sort_secondary,
        tiles=pipe._tiles, chunk=chunk)
    pooled_launches = dict(launches)
    m = len(frames) * width * height
    assert pooled_launches["closest"][:-(-m // chunk)] == (
        [chunk] * (m // chunk) + ([m % chunk] if m % chunk else []))
    assert max(pooled_launches["closest"] + pooled_launches["any"]) <= chunk
    assert (name == "atrium") == pipe._sort_secondary == scene.emissive_free
    if not scene.emissive_free:
        assert not pooled_launches["any"]
    else:
        live = int(rays) - m
        assert sum(pooled_launches["any"]) == live
        assert len(pooled_launches["any"]) == -(-live // chunk)
    total = 0
    for k, (cam, frame) in enumerate(zip(cams, frames)):
        image, traced = pipe.render(cam, frame)
        total += int(traced)
        assert torch.equal(images[k], image), f"frame {frame}"
    assert int(rays) == total > m
    assert bool(torch.isfinite(images).all()) and images.mean() > 0


def test_pooled_single_frame(cornell_pipeline):
    """A group of one frame is ``render``."""
    cam = _cornell_cams()[0]
    images, rays = cornell_pipeline.render_pooled([cam], [3])
    ref, ref_rays = cornell_pipeline.render(cam, 3)
    assert images.shape == (1, 40, 48, 3) and int(rays) == int(ref_rays)
    assert torch.equal(images[0], ref)


def test_pooled_rejects_multisample(cornell_pipeline):
    import dataclasses

    config = dataclasses.replace(cornell_pipeline.config, num_samples=2)
    pipe = RenderPipeline(cornell_pipeline.scene, config)
    with pytest.raises(ValueError, match="requires 1 spp"):
        pipe.render_pooled(_cornell_cams()[:1], [0])


def test_cli_pooled_matches_per_frame(cornell_glb, tmp_path, capsys):
    """``--pool-frames 2 --frames 3`` along a camera path (a group of 2,
    then of 1) writes the per-frame CLI's PNG; Stats count 3 frames."""
    path = tmp_path / "path.json"
    path.write_text(json.dumps([
        {"time": 0.0, "position": [0.0, 1.0, 0.9], "yaw": 180.0,
         "pitch": 0.0},
        {"time": 1.0, "position": [0.1, 1.0, 0.8], "yaw": 170.0,
         "pitch": 5.0}]))
    base = ["-s", cornell_glb, "-x", "80", "-y", "48", "-b", "3",
            "--frames", "3", "--camera-path", str(path), "--device", "cpu"]
    outs = [str(tmp_path / "frames.png"), str(tmp_path / "pooled.png")]
    assert port_main(base + ["-o", outs[0]]) == 0
    capsys.readouterr()
    assert port_main(base + ["-o", outs[1], "--pool-frames", "2"]) == 0
    err = capsys.readouterr().err
    assert f"wrote {outs[1]}" in err and "3 frame(s) on cpu" in err
    stats = [json.loads(ln[6:]) for ln in err.splitlines()
             if ln.startswith("STATS ")]
    assert stats[-1]["frames"] == 3
    a, b = read_png(outs[0]), read_png(outs[1])
    assert a.shape == (48, 80, 3) and 0 < a.mean() < 255
    assert np.array_equal(a, b)
