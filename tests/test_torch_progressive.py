"""PyTorch port vs JAX: the convergence path on the CPU.

The same scenes and cameras go through the JAX package (``traversal=
"auto"``, XLA on the CPU) and the port (plain traversal versions on the
CPU); both bake with the native SAH.  Ray counts and RNG streams are
exact contracts; radiance is allclose at rtol 1e-5 / atol 1e-5, the
tolerance of tests/test_render.py:160 and test_torch_render.py.

- The joint progressive batch (``render_frames_joint`` through
  ``RenderPipeline.render_batch_sum``): the Cornell box at 40x40, B=3,
  3 bounces with Russian roulette (emissive: closest hit on the middle
  and last bounces, unsorted below the 16,384-triangle gate); the
  atrium at detail 0.3 (24,456 triangles, leaf 28) at 96x72, B=2, 2
  bounces, where the sorted any hit decides the last bounce; the
  ``--instanced`` columns, B=2.  Each also against the sum of the
  port's own B single frames, with rays = their sum - (B - 1) * N.
- The sequential batch at 2 spp, Russian roulette on one frame, the
  shading chunk, the accumulator and its checkpoints (read by either
  package), the progressive CLI against the JAX CLI, and the port's
  benchmark (``app/bench.py``) at a tiny size on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.app.camera_path import orbit_path
from vulkan_pathtracer_tpu.app.main import main as jax_main
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene as jax_build_instanced,
)
from vulkan_pathtracer_tpu.render import wavefront as jwf
from vulkan_pathtracer_tpu.render.output import Accumulator as JaxAccumulator
from vulkan_pathtracer_tpu.render.pipeline import (
    RenderPipeline as JaxPipeline,
)
from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
from vulkan_pathtracer_tpu_torch.app import bench
from vulkan_pathtracer_tpu_torch.app.main import main as port_main
from vulkan_pathtracer_tpu_torch.app.main import parse_args
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.render import pipeline as pl
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.render.output import Accumulator
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig, read_png

from tests.native_guard import native_libraries  # noqa: F401

pytestmark = pytest.mark.usefixtures("native_libraries")

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    from assets.procedural import make_atrium

    path = tmp_path_factory.mktemp("scenes") / "atrium.glb"
    make_atrium(str(path), detail=0.3)
    return str(path)


def _cornell_camera(aspect):
    cam = Camera(aspect_ratio=aspect,
                 position=np.asarray([0.0, 1.0, 0.9], np.float32))
    cam.set_orientation(yaw=180.0, pitch=0.0)
    return cam


def _orbit_camera(aspect):
    cam = Camera(aspect_ratio=aspect)
    orbit_path(radius=4.5, height=2.2, duration=4.0,
               center=(0.0, 1.2, 0.0)).apply(cam, 0.0)
    return cam


# name -> (scene fixture, bake, leaf, config fields, camera, batch)
CASES = {
    "cornell_rr": ("cornell_glb", "flat", 14,
                   dict(num_bounces=3, resolution_x=40, resolution_y=40,
                        russian_roulette=True), _cornell_camera, 3),
    "atrium_anyhit": ("atrium_glb", "flat", 28,
                      dict(num_bounces=2, resolution_x=96, resolution_y=72),
                      _orbit_camera, 2),
    "columns_instanced": ("columns_glb", "instanced", 14,
                          dict(num_bounces=2, resolution_x=48,
                               resolution_y=32), None, 2),
}


@pytest.fixture(scope="module")
def case_scenes(request):
    """Bakes of each case's scene, by (fixture, bake, leaf), both packages
    (built on first use, kept for the module)."""
    return {}


def _scenes(request, cache, fixture, bake, leaf):
    key = (fixture, bake, leaf)
    if key not in cache:
        path = request.getfixturevalue(fixture)
        if bake == "instanced":
            cache[key] = (
                jax_build_instanced(jgltf.load(path), max_leaf_size=leaf),
                build_instanced_scene(gltf.load(path), max_leaf_size=leaf,
                                      device="cpu"))
        else:
            cache[key] = (
                jax_build(jgltf.load(path), build_bvh=True,
                          max_leaf_size=leaf),
                build_device_scene(gltf.load(path), max_leaf_size=leaf,
                                   device="cpu"))
    return cache[key]


def _case(name, request, case_scenes):
    fixture, bake, leaf, fields, camera_of, batch = CASES[name]
    jd, td = _scenes(request, case_scenes, fixture, bake, leaf)
    kw = dict(num_samples=1, **fields)
    jcfg, tcfg = JaxConfig(**kw), RenderConfig(**kw)
    aspect = tcfg.aspect_ratio
    cam = Camera(aspect_ratio=aspect) if camera_of is None else \
        camera_of(aspect)
    return jd, td, jcfg, tcfg, cam, batch


@pytest.mark.parametrize("name", list(CASES))
def test_joint_matches_jax(name, request, case_scenes, monkeypatch):
    jd, td, jcfg, tcfg, cam, batch = _case(name, request, case_scenes)
    any_hits = []
    real_any_hit = wavefront._any_hit

    def spy(scene, origin, *args):
        any_hits.append(origin.shape[0])
        return real_any_hit(scene, origin, *args)

    monkeypatch.setattr(wavefront, "_any_hit", spy)
    ref, ref_rays = JaxPipeline(jd, jcfg).render_batch_sum(cam, 5, batch)
    pipe = RenderPipeline(td, tcfg)
    got, rays = pipe.render_batch_sum(cam, 5, batch)
    n = tcfg.render_width * tcfg.render_height
    assert got.shape == (tcfg.render_height, tcfg.render_width, 3)
    assert torch.isfinite(got).all() and got.mean() > 0
    assert int(rays) == float(ref_rays) and int(rays) > n
    if name == "atrium_anyhit":
        # Sorted joint state, any hit on the live prefix only.
        assert td.num_triangles == 24456 and pipe._sort_secondary
        assert td.emissive_free and any_hits == [int(rays) - n]
    if name == "cornell_rr":
        assert not td.emissive_free and not pipe._sort_secondary
        assert any_hits == []
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_joint_equals_single_frames(name, request, case_scenes):
    """The joint batch against the port's own B single frames: radiance
    allclose, rays = their sum - (B - 1) * N exactly."""
    _, td, _, tcfg, cam, batch = _case(name, request, case_scenes)
    pipe = RenderPipeline(td, tcfg)
    got, rays = pipe.render_batch_sum(cam, 9, batch)
    singles = [pipe.render(cam, 9 + k) for k in range(batch)]
    want = sum(image for image, _ in singles)
    n = tcfg.render_width * tcfg.render_height
    assert int(rays) == sum(int(r) for _, r in singles) - (batch - 1) * n
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    # joint=True at B = 1 is the joint structure of one frame.
    one, one_rays = pipe.render_batch_sum(cam, 9, 1, joint=True)
    assert int(one_rays) == int(singles[0][1])
    np.testing.assert_allclose(one.numpy(), singles[0][0].numpy(), rtol=RTOL,
                               atol=ATOL)


def test_sequential_batch_matches_jax(cornell_glb):
    """``render_frames_batch`` at 2 spp (render_batch_sum's sequential
    branch) against JAX's ``lax.scan``."""
    kw = dict(num_samples=2, num_bounces=2, resolution_x=40,
              resolution_y=40)
    cam = _cornell_camera(1.0)
    jd = jax_build(jgltf.load(cornell_glb), build_bvh=True, max_leaf_size=14)
    td = build_device_scene(gltf.load(cornell_glb), max_leaf_size=14,
                            device="cpu")
    ref, ref_rays = JaxPipeline(jd, JaxConfig(**kw)).render_batch_sum(
        cam, 2, 3)
    pipe = RenderPipeline(td, RenderConfig(**kw))
    got, rays = pipe.render_batch_sum(cam, 2, 3)
    assert int(rays) == float(ref_rays) > 3 * 2 * 40 * 40
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    singles = [pipe.render(cam, 2 + k) for k in range(3)]
    assert int(rays) == sum(int(r) for _, r in singles)
    assert torch.equal(got, singles[0][0] + singles[1][0] + singles[2][0])


@pytest.mark.parametrize("rr_start", [1, 2])
def test_russian_roulette_frame_matches_jax(cornell_glb, rr_start):
    """One frame with Russian roulette: ``render_frame`` against JAX's
    sample, rays exact, and the RNG streams after the sample exact
    (``trace_sample`` of both packages on the same primaries)."""
    width = height = 40
    bounces = 3
    cam = _cornell_camera(1.0)
    jd = jax_build(jgltf.load(cornell_glb), build_bvh=True, max_leaf_size=14)
    td = build_device_scene(gltf.load(cornell_glb), max_leaf_size=14,
                            device="cpu")
    pos, hor, ver, fwd = pl.camera_tensors(cam, "cpu")
    origin, direction, sx, sy, tile_inv = pl.primary_rays(
        pos, hor, ver, fwd, 4, width, height)
    assert tile_inv is None    # scanline order, as JAX's at this size
    sample = jax.jit(lambda *a: jwf.trace_sample(
        jd, *a, num_bounces=bounces, russian_roulette=True,
        rr_start_bounce=rr_start))
    ref, ref_sx, ref_sy, ref_rays = sample(
        origin.numpy(), direction.numpy(), sx.numpy().astype(np.uint32),
        sy.numpy().astype(np.uint32))
    rr = dict(russian_roulette=True, rr_start_bounce=rr_start)
    image, rays = pl.render_frame(
        td, pos, hor, ver, fwd, 4, num_samples=1, num_bounces=bounces,
        width=width, height=height, **rr)
    _, got_sx, got_sy, got_rays = wavefront.trace_sample(
        td, origin, direction, sx, sy, num_bounces=bounces, **rr)
    plain_rays = wavefront.trace_sample(
        td, origin, direction, sx, sy, num_bounces=bounces)[3]
    assert int(rays) == int(got_rays) == float(ref_rays)
    assert int(rays) < int(plain_rays)    # roulette ended some paths
    np.testing.assert_array_equal(got_sx.numpy(),
                                  np.asarray(ref_sx).astype(np.int64))
    np.testing.assert_array_equal(got_sy.numpy(),
                                  np.asarray(ref_sy).astype(np.int64))
    np.testing.assert_allclose(image.reshape(-1, 3).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk_of", [lambda n: 1234, lambda n: 2 * n + 5],
                         ids=["pixel_ranges", "two_frames"])
@pytest.mark.parametrize("name", ["cornell_rr", "atrium_anyhit"])
def test_chunking(name, chunk_of, request, case_scenes, monkeypatch):
    """A small shading chunk with a remainder: the same rays, radiance
    allclose at 1e-6, and no launch larger than the chunk.  Bounce 0
    shades pixel ranges of one frame (1,234 lanes) or two whole frames
    at a time (2N + 5)."""
    _, td, _, tcfg, cam, batch = _case(name, request, case_scenes)
    pipe = RenderPipeline(td, tcfg)
    pos, hor, ver, fwd = pl.camera_tensors(cam, "cpu")
    kw = dict(batch=batch, num_bounces=tcfg.num_bounces,
              width=tcfg.render_width, height=tcfg.render_height,
              sort_secondary=pipe._sort_secondary, tiers=pipe.tiers,
              russian_roulette=tcfg.russian_roulette)
    whole, rays = pl.render_frames_joint(td, pos, hor, ver, fwd, 3, **kw)
    sizes = []

    def spy(real):
        def tier(*args):
            fn = real(*args)

            def run(scene, origin, *rest, **kwargs):
                sizes.append(origin.shape[0])
                return fn(scene, origin, *rest, **kwargs)
            return None if fn is None else run
        return tier

    for name_ in ("_closest_tier", "_any_tier"):
        monkeypatch.setattr(wavefront, name_,
                            spy(getattr(wavefront, name_)))
    n = tcfg.render_width * tcfg.render_height
    chunk = chunk_of(n)
    parts, parts_rays = pl.render_frames_joint(td, pos, hor, ver, fwd, 3,
                                               chunk=chunk, **kw)
    assert int(parts_rays) == int(rays)
    # The shared primary, then each later bounce's launches: the
    # atrium's any hit on its sorted live prefix, the Cornell box's
    # closest hits on every lane (unsorted), twice.
    if name == "atrium_anyhit":
        lanes, bounces = int(rays) - n, 1
    else:
        lanes, bounces = batch * n, 2
    want = [min(chunk, lanes - s) for s in range(0, lanes, chunk)]
    assert sizes == [n] + want * bounces
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def _accumulate(cls, frames, sums):
    acc = cls(5, 4, spp_per_frame=2)
    for image in frames:
        acc.add_frame(image)
    for image, k in sums:
        acc.add_frames_sum(image, k)
    return acc


def test_accumulator_matches_jax():
    gen = np.random.default_rng(3)
    frames = [gen.random((4, 5, 3), dtype=np.float32) for _ in range(3)]
    sums = [(gen.random((4, 5, 3), dtype=np.float32) * 4, 4)]
    port = _accumulate(Accumulator, frames, sums)
    ref = _accumulate(JaxAccumulator, frames, sums)
    assert (port.frame, port.spp) == (ref.frame, ref.spp) == (7, 14)
    assert port.sum.dtype == np.float64
    np.testing.assert_array_equal(port.sum, ref.sum)
    np.testing.assert_array_equal(port.mean, ref.mean)


@pytest.mark.parametrize("writer,reader", [(Accumulator, JaxAccumulator),
                                           (JaxAccumulator, Accumulator)])
def test_checkpoint_read_by_other_package(writer, reader, tmp_path):
    gen = np.random.default_rng(4)
    acc = _accumulate(writer, [gen.random((4, 5, 3), dtype=np.float32)],
                      [(gen.random((4, 5, 3), dtype=np.float32), 3)])
    path = str(tmp_path / "acc.npz")
    acc.save(path)
    back = reader.load(path)
    assert (back.frame, back.spp, back.spp_per_frame) == (4, 8, 2)
    assert (back.width, back.height) == (5, 4)
    np.testing.assert_array_equal(back.sum, acc.sum)


def test_accumulator_checkpoint_roundtrip(tmp_path):
    """tests/test_parity_extras.py's case on the port."""
    acc = Accumulator(4, 4, spp_per_frame=2)
    img = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    acc.add_frame(img)
    acc.add_frame(img * 0.5)
    path = str(tmp_path / "acc.npz")
    acc.save(path)
    acc2 = Accumulator.load(path)
    assert acc2.spp == 4 and acc2.frame == 2
    np.testing.assert_allclose(acc2.mean, acc.mean)


def _cli_args(scene, out, ckpt, frames):
    return ["-s", scene, "-x", "40", "-y", "40", "-o", out, "--progressive",
            "--batch-frames", "2", "--frames", str(frames), "--checkpoint",
            ckpt, "--checkpoint-interval", "2"]


def test_cli_progressive_batch_resume_matches_jax(cornell_glb, tmp_path,
                                                  capsys, monkeypatch):
    """``--progressive --batch-frames 2 --frames 4 --checkpoint`` then a
    resume to 6 frames, through both CLIs: the port's checkpoint keeps
    frame and spp, stderr shows the resume, and the PNG is within one
    unorm8 level of the JAX CLI's."""
    monkeypatch.setenv("VKPT_COMPILE_CACHE", "")
    pngs = {}
    for tag, run, extra in (("port", port_main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        out = str(tmp_path / f"{tag}.png")
        ckpt = str(tmp_path / f"{tag}.npz")
        assert run(_cli_args(cornell_glb, out, ckpt, 4) + extra) == 0
        meta = json.loads(str(np.load(ckpt)["meta"]))
        assert (meta["frame"], meta["spp"]) == (4, 4)
        capsys.readouterr()
        assert run(_cli_args(cornell_glb, out, ckpt, 6) + extra) == 0
        err = capsys.readouterr().err
        assert "resumed checkpoint at frame 4 (4 spp)" in err
        assert f"wrote {out} (6 spp)" in err
        meta = json.loads(str(np.load(ckpt)["meta"]))
        assert (meta["frame"], meta["spp"]) == (6, 6)
        pngs[tag] = read_png(out).astype(np.int16)
    assert pngs["port"].shape == (40, 40, 3) and pngs["port"].mean() > 0
    assert np.abs(pngs["port"] - pngs["jax"]).max() <= 1


@pytest.mark.parametrize("extra", [["--save-every", "2"],
                                   ["--batch-frames", "2", "--camera-path"]])
def test_cli_progressive_frames(cornell_glb, tmp_path, capsys, extra):
    """The per-frame branch: ``--progressive`` without a batch and with
    previews, or along a camera path (which takes it even with
    ``--batch-frames``); a ``STATS`` line for the 3 frames."""
    if extra[-1] == "--camera-path":
        path = tmp_path / "path.json"
        path.write_text(json.dumps([
            {"time": 0.0, "position": [0.0, 1.0, 0.9], "yaw": 180.0,
             "pitch": 0.0},
            {"time": 1.0, "position": [0.1, 1.0, 0.8], "yaw": 170.0,
             "pitch": 5.0}]))
        extra = extra + [str(path)]
    out = str(tmp_path / "out.png")
    assert port_main(["-s", cornell_glb, "-x", "24", "-y", "16", "-o", out,
                      "--progressive", "--frames", "3", "--device", "cpu",
                      *extra]) == 0
    err = capsys.readouterr().err
    assert f"wrote {out}" in err and "3 frame(s) on cpu" in err
    stats = [json.loads(ln[6:]) for ln in err.splitlines()
             if ln.startswith("STATS ")]
    assert stats and stats[-1]["frames"] == 3
    image = read_png(out)
    assert image.shape == (16, 24, 3) and 0 < image.mean() < 255


def test_still_refused(box_glb, monkeypatch, capsys):
    """What was refused is ported: ``--devices`` parses (multi-device,
    tests/test_torch_multidevice.py) and so does ``--interactive
    --devices 2`` (the multi-rank viewer), the progressive flags parse,
    and RenderPipeline builds and renders with ``seed_secondary`` on a
    flat bake (tests/test_torch_channels.py holds it to JAX, and the
    refusal on two-level scenes) as it takes ``enable_validation``, which
    ``-v`` sets.  The last CLI refusal, ``VKPT_MXU_PRECISION=default``
    (the bf16 product), is ported too: it parses with JAX's warning, and
    a bf16 bake renders through the joint batch (tests/test_torch_bf16.py
    holds the product to JAX)."""
    config, args = parse_args(["-s", "scene.glb", "--devices", "2",
                               "--progressive"])
    assert args.devices == 2 and config.progressive
    config, args = parse_args(["-s", "scene.glb", "--interactive",
                               "--devices", "2"])
    assert args.interactive and args.devices == 2
    config, args = parse_args(["-s", "scene.glb", "--progressive",
                               "--batch-frames", "4", "--russian-roulette"])
    assert config.progressive and config.russian_roulette
    assert args.batch_frames == 4
    scene = build_device_scene(gltf.load(box_glb), max_leaf_size=4,
                               device="cpu")
    pipe = RenderPipeline(scene, RenderConfig(
        seed_secondary=True, num_bounces=3, resolution_x=8, resolution_y=8))
    image, rays = pipe.render_numpy(Camera(aspect_ratio=1.0), 1)
    assert image.shape == (8, 8, 3) and rays >= 64
    config, _ = parse_args(["-s", "scene.glb", "-v"])
    assert config.enable_validation
    monkeypatch.setenv("VKPT_MT", "mxu")
    monkeypatch.setenv("VKPT_MXU_PRECISION", "default")
    with pytest.warns(UserWarning, match="VKPT_MXU_PRECISION=default"):
        config, _ = parse_args(["-s", "scene.glb", "--progressive"])
    assert config.mxu_precision == "default" and config.progressive
    scene = build_device_scene(gltf.load(box_glb), max_leaf_size=4,
                               device="cpu", mt="mxu",
                               mxu_precision="default")
    assert scene.tri_coefs.dtype == torch.bfloat16
    pipe = RenderPipeline(scene, RenderConfig(
        mt="mxu", mxu_precision="default", progressive=True,
        resolution_x=8, resolution_y=8))
    image, rays = pipe.render_batch_sum(Camera(aspect_ratio=1.0), 0, 2,
                                        joint=True)
    assert image.shape == (8, 8, 3) and bool(torch.isfinite(image).all())
    assert int(rays) >= 64


def test_bench_prints_one_line_per_metric(capsys):
    """``app/bench.py`` on the CPU at a tiny size: the headline and the
    convergence metrics, one JSON line each, with the device and the
    rays of the joint batches."""
    assert bench.main(["--device", "cpu", "--scene", "cornell", "--width",
                       "40", "--height", "32", "--frames", "2",
                       "--target-spp", "6", "--batch", "4"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == [
        "mrays_per_sec_per_chip", "spp_per_sec_1080p", "seconds_to_6_spp"]
    assert all(ln["device"] == "cpu" and ln["value"] > 0 for ln in lines)
    spp = lines[1]["detail"]
    assert spp["joint"] and spp["target_spp"] == 6 and spp["rays"] > 6 * 1280
    assert lines[2]["value"] == spp["seconds_to_target"]
