"""PyTorch port vs JAX: multi-device rendering on gloo ranks on the CPU.

The ranks are processes of a gloo group started by the port's own
``parallel.distributed.spawn`` (``device="cpu"``), one 4-rank group for
the module that computes every case (tests/multidevice_ranks.py) and
hands NumPy arrays back; the JAX references (its 8-device virtual CPU
mesh, tests/conftest.py) and the port's single-device references are
computed here, in the parent.

- Framebuffer tiles, 4 ranks, the box at 32x32 (``bvh``): allclose to
  JAX ``make_sharded_render(mode="tiles")`` at rtol 1e-5 / atol 1e-5
  (the single-frame tolerance of test_torch_render.py), and bitwise the
  port's single-device frame with the rays exact (as JAX asserts of
  itself, test_multichip.py:49-51).  A height not divisible by the
  ranks raises ValueError.
- Sample shards, 4 ranks: allclose to JAX ``mode="spp"`` (1e-5 / 1e-5),
  and bitwise the rank-order mean of the port's single frames at frame
  seeds 4 f + r.
- Tiles under the kernel tiers of test_multichip.py:70-165 (the
  ``pallas`` default, the frontier kernels, coefficient leaves), each
  through the plain versions: allclose to JAX's sharded frame of the
  same tier (1e-5 / 1e-5, rays exact) and bitwise the port's single
  frame; the instanced columns likewise (test_multichip.py:317-349).
- The pooled wavefront across 4 ranks, rebalanced every bounce and not
  (the Cornell box, 2 frames of 32x16 = 1,024 lanes, 3 bounces):
  allclose to JAX ``trace_wavefront_pooled`` at rtol 1e-5 / atol 1e-6
  (test_rebalance.py:65-67), bitwise the port's own, rays exact; lanes
  not divisible by 16 raise ValueError.
- ``_balanced_exchange`` leaves the ranks' live counts within one strip
  of each other (test_rebalance.py:70-141).
- The animated step on 2 ranks of a group formed by
  ``distributed.initialize`` with explicit arguments:
  ``AnimatedScene.with_transforms``, then sharded tiles of the columns,
  bitwise the port's single frame of the same refitted scene, frames
  differing as camera and geometry move (test_animated_multichip.py).
- ``distributed.initialize``: no group for one process, the argument
  and torchrun-environment plumbing (test_parity_extras.py:54-100).
- The CLI: ``--devices 2`` tiles and spp on ``--device cpu`` exit 0,
  and the tiles PNG equals the single-device CLI's; more CUDA ranks than
  cards and a ``WORLD_SIZE`` other than ``--devices`` exit non-zero.
- The multi-rank viewer on 2 and 4 ranks, tiles and spp: under
  scripted look keys (``jlik``, then ``q``) rank 0's ANSI text is byte
  for byte the single-device viewer's (spp: over the rank-order mean of
  the ranks' frames, the sharded frame); EOF and ``max_frames`` end
  every rank after the same frame count; the other ranks write nothing;
  ``--interactive --devices 2 --device cpu`` with piped keys exits 0,
  prints the single-device viewer's text and "viewer closed after N
  frames" once.
"""

import io
import subprocess
import sys


import pickle

import numpy as np
import pytest
import torch

from tests import multidevice_ranks as ranks
from vulkan_pathtracer_tpu_torch.app.main import main as port_main
from vulkan_pathtracer_tpu_torch.parallel import distributed
from vulkan_pathtracer_tpu_torch.parallel.mesh import (
    RenderGroup,
    make_render_group,
)
from vulkan_pathtracer_tpu_torch.parallel.rebalance import (
    make_pooled_sharded_render,
)
from vulkan_pathtracer_tpu_torch.parallel.sharding import make_sharded_render
from vulkan_pathtracer_tpu_torch.render.pipeline import (
    camera_tensors,
    render_frame,
)
from vulkan_pathtracer_tpu_torch.render.wavefront import (
    trace_wavefront_pooled,
)
from vulkan_pathtracer_tpu_torch.utils import read_png

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

WORLD = 4
RTOL = ATOL = 1e-5
POOLED_ATOL = 1e-6
POOLED_W, POOLED_H, POOLED_FRAMES = 32, 16, 2
PACKET_VARS = ("VKPT_PACKET", "VKPT_PAIR_PACKET", "VKPT_QUAD_PACKET")
JAX_TIER_VARS = {"pallas": {},
                 "frontier": {"VKPT_KERNEL_PRIMARY": "frontier",
                              "VKPT_KERNEL_SECONDARY": "frontier",
                              "VKPT_FRONTIER_PACKET": "256"},
                 "mxu": {"VKPT_MT": "mxu"}}


@pytest.fixture(scope="module")
def paths(box_glb, columns_glb, cornell_glb):
    return {"box": box_glb, "columns": columns_glb, "cornell": cornell_glb}


def _pooled_inputs():
    """test_rebalance.py's pooled rays (JAX ``generate_rays`` and
    ``_pixel_seeds`` of two cameras in the Cornell box) as NumPy."""
    import jax.numpy as jnp

    from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
    from vulkan_pathtracer_tpu.render.pipeline import (
        _pixel_seeds,
        generate_rays,
    )

    parts = []
    for k in range(POOLED_FRAMES):
        cam = JaxCamera(aspect_ratio=POOLED_W / POOLED_H,
                        position=np.array([0.1 * k, 1.0, 2.5], np.float32))
        cam.set_orientation(yaw=180.0 + 3.0 * k, pitch=0.0)
        vectors = (jnp.asarray(v) for v in cam.push_constants())
        o, d = generate_rays(*vectors, POOLED_W, POOLED_H)
        sx, sy = _pixel_seeds(POOLED_W, POOLED_H, jnp.uint32(10 + k))
        parts.append([np.asarray(o), np.asarray(d),
                      np.asarray(sx).astype(np.int64),
                      np.asarray(sy).astype(np.int64)])
    return [np.concatenate([p[i] for p in parts]) for i in range(4)]


@pytest.fixture(scope="module")
def pooled_inputs():
    return _pooled_inputs()


@pytest.fixture(scope="module")
def four(paths, pooled_inputs):
    """The 4-rank group's results: rank 0's dict, and every rank's
    exchange counts."""
    out = distributed.spawn(ranks.four_ranks, WORLD, "cpu", paths,
                            pooled_inputs)
    return (out[0], [r["exchange"] for r in out],
            [r["viewer"] for r in out])


def _single(scene, camera, size, frame=0, tiers="bvh", width=None):
    image, rays = render_frame(
        scene, *camera_tensors(camera, "cpu"), frame, num_samples=1,
        num_bounces=2, width=width or size, height=size, tiers=tiers)
    return image.numpy(), int(rays)


def _jax_sharded(path, mode, size, traversal="bvh", width=None,
                 instanced=False, mt=False, camera=ranks.BOX_CAMERA):
    """JAX ``make_sharded_render`` on a 4-device mesh: (image, rays)."""
    import jax.numpy as jnp

    from vulkan_pathtracer_tpu.models import gltf as jgltf
    from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
    from vulkan_pathtracer_tpu.models.instanced_scene import (
        build_instanced_scene,
    )
    from vulkan_pathtracer_tpu.ops.mxu_mt import ensure_mt_coefs
    from vulkan_pathtracer_tpu.parallel.mesh import make_render_mesh
    from vulkan_pathtracer_tpu.parallel.sharding import (
        make_sharded_render as jax_sharded,
        replicate_scene as jax_replicate,
    )

    host = jgltf.load(path)
    scene = (build_instanced_scene(host, max_leaf_size=8) if instanced
             else build_device_scene(host, build_bvh=True))
    if mt:
        scene = ensure_mt_coefs(scene)
    mesh = make_render_mesh(WORLD)
    scene = jax_replicate(scene, mesh)
    cam = JaxCamera(aspect_ratio=(width or size) / size,
                    position=np.asarray(camera, np.float32))
    vectors = [jnp.asarray(v) for v in cam.push_constants()]
    fn = jax_sharded(mesh, scene, num_samples=1, num_bounces=2,
                     width=width or size, height=size, traversal=traversal,
                     mode=mode)
    image, rays = fn(scene, *vectors, jnp.uint32(0))
    return np.asarray(image), float(rays)


def test_tiles_match_jax_and_single_frame(four, paths):
    image, rays = four[0]["tiles"]
    ref, ref_rays = _jax_sharded(paths["box"], "tiles", ranks.BOX_SIZE)
    assert image.shape == (32, 32, 3) and np.isfinite(image).all()
    assert rays == ref_rays > 32 * 32
    np.testing.assert_allclose(image, ref, rtol=RTOL, atol=ATOL)
    single, single_rays = _single(ranks.box_scene(paths["box"]),
                                  ranks.box_camera(), ranks.BOX_SIZE)
    np.testing.assert_array_equal(image, single)
    assert rays == single_rays


def test_height_not_divisible_raises(paths):
    group = RenderGroup(rank=0, world=8, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_render(group, ranks.box_scene(paths["box"]),
                            num_samples=1, num_bounces=2, width=16,
                            height=17)


def test_spp_matches_jax_and_rank_order_mean(four, paths):
    image, rays = four[0]["spp"]
    ref, ref_rays = _jax_sharded(paths["box"], "spp", ranks.BOX_SIZE)
    assert rays == ref_rays >= WORLD * 32 * 32
    np.testing.assert_allclose(image, ref, rtol=RTOL, atol=ATOL)
    scene = ranks.box_scene(paths["box"])
    frames = [_single(scene, ranks.box_camera(), ranks.BOX_SIZE,
                      frame=0 * WORLD + r) for r in range(WORLD)]
    total = frames[0][0]
    for frame, _ in frames[1:]:
        total = total + frame
    np.testing.assert_array_equal(image, total / np.float32(WORLD))
    assert rays == sum(r for _, r in frames)


@pytest.mark.parametrize("tier", list(ranks.TIERS))
def test_tier_tiles_match_jax(four, paths, tier, monkeypatch):
    import jax

    image, rays = four[0]["tier_" + tier]
    for var in PACKET_VARS:   # test_multichip.py's packets
        monkeypatch.setenv(var + "_PRIMARY", "256")
        monkeypatch.setenv(var + "_SECONDARY", "256")
    for var, value in JAX_TIER_VARS[tier].items():
        monkeypatch.setenv(var, value)
    jax.clear_caches()   # the variables are read while JAX traces
    ref, ref_rays = _jax_sharded(paths["box"], "tiles", ranks.TIER_SIZE,
                                 traversal="pallas", mt=tier == "mxu")
    jax.clear_caches()
    assert rays == ref_rays > 16 * 16
    np.testing.assert_allclose(image, ref, rtol=RTOL, atol=ATOL)
    single, single_rays = _single(
        ranks.box_scene(paths["box"], "mxu" if tier == "mxu" else "exact"),
        ranks.box_camera(), ranks.TIER_SIZE, tiers=ranks.tier_of(tier))
    np.testing.assert_array_equal(image, single)
    assert rays == single_rays


def test_instanced_tiles_match_jax(four, paths):
    image, rays = four[0]["columns"]
    ref, ref_rays = _jax_sharded(paths["columns"], "tiles", ranks.COLUMNS_H,
                                 width=ranks.COLUMNS_W, instanced=True,
                                 camera=ranks.COLUMNS_CAMERA)
    assert rays == ref_rays
    np.testing.assert_allclose(image, ref, rtol=RTOL, atol=ATOL)
    single, single_rays = _single(ranks.columns_scene(paths["columns"]),
                                  ranks.columns_camera(), ranks.COLUMNS_H,
                                  width=ranks.COLUMNS_W)
    np.testing.assert_array_equal(image, single)
    assert rays == single_rays


@pytest.fixture(scope="module")
def pooled_refs(paths, pooled_inputs):
    """(JAX trace_wavefront_pooled, the port's) on the pooled rays."""
    import jax.numpy as jnp

    from vulkan_pathtracer_tpu.models import gltf as jgltf
    from vulkan_pathtracer_tpu.models.device_scene import (
        build_device_scene as jax_build,
    )
    from vulkan_pathtracer_tpu.render.wavefront import (
        trace_wavefront_pooled as jax_pooled,
    )
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )

    o, d, sx, sy = pooled_inputs
    jd = jax_build(jgltf.load(paths["cornell"]), build_bvh=True)
    ref, ref_rays = jax_pooled(
        jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(sx, jnp.uint32),
        jnp.asarray(sy, jnp.uint32), num_bounces=ranks.POOLED_BOUNCES,
        traversal="bvh", sort_secondary=True)
    td = build_device_scene(gltf.load(paths["cornell"]), max_leaf_size=4,
                            device="cpu")
    own, own_rays = trace_wavefront_pooled(
        td, *(torch.from_numpy(a) for a in pooled_inputs),
        num_bounces=ranks.POOLED_BOUNCES, tiers="bvh", sort_secondary=True)
    return (np.asarray(ref), float(ref_rays)), (own.numpy(), int(own_rays))


@pytest.mark.parametrize("rebalance", [True, False])
def test_pooled_sharded_matches_jax_and_single(four, pooled_refs,
                                               rebalance):
    color, rays = four[0][f"pooled_{rebalance}"]
    (ref, ref_rays), (own, own_rays) = pooled_refs
    assert color.shape == (POOLED_FRAMES * POOLED_W * POOLED_H, 3)
    np.testing.assert_allclose(color, ref, rtol=RTOL, atol=POOLED_ATOL)
    assert rays == ref_rays
    np.testing.assert_array_equal(color, own)
    assert rays == own_rays


def test_pooled_lanes_not_divisible_raise(paths, pooled_inputs):
    group = RenderGroup(rank=0, world=WORLD, device=torch.device("cpu"))
    scene = ranks.box_scene(paths["box"])
    fn = make_pooled_sharded_render(group, scene, num_bounces=2)
    rays = [torch.from_numpy(a[:1000]) for a in pooled_inputs]
    with pytest.raises(ValueError, match="multiple of 16"):
        fn(scene, *rays)


@pytest.mark.parametrize("case,spread", [(0, ranks.EXCHANGE_M_LOCAL // 4),
                                         (1, 4)])
def test_exchange_balances_alive_counts(four, case, spread):
    """Case 0: two ranks' shards alive, the rest dead; case 1: every
    shard half alive (contiguous strips would leave ranks 0-1 all alive
    and 2-3 all dead)."""
    counts = [c[case] for c in four[1]]
    assert sum(counts) == 2 * ranks.EXCHANGE_M_LOCAL
    assert max(counts) - min(counts) <= spread


def test_animated_step_two_ranks(paths, tmp_path):
    """A real 2-rank group from ``initialize`` with explicit arguments,
    then the animated step on it."""
    import torch.multiprocessing as mp

    address = f"127.0.0.1:{distributed.free_port()}"
    mp.spawn(ranks.explicit_group, args=(address, 2, paths, str(tmp_path)),
             nprocs=2, join=True)
    results = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    # (formed, is_primary, rank, world, the ranks' sum of rank + 1)
    assert [r[0] for r in results] == [(True, True, 0, 2, 3),
                                       (True, False, 1, 2, 3)]
    anim, t0 = ranks.build_animated(paths["columns"])
    images = []
    for frame, (image, rays) in enumerate(results[0][1]):
        scene = anim.with_transforms(ranks.animated_transforms(t0, frame))
        single, single_rays = _single(
            scene, ranks.animated_camera(frame), ranks.ANIM_H,
            frame=frame, width=ranks.ANIM_W)
        assert image.shape == (ranks.ANIM_H, ranks.ANIM_W, 3)
        np.testing.assert_array_equal(image, single)
        np.testing.assert_array_equal(results[1][1][frame][0], image)
        assert rays == single_rays >= ranks.ANIM_W * ranks.ANIM_H
        images.append(image)
    assert np.abs(images[0] - images[1]).max() > 1e-4
    assert np.abs(images[1] - images[2]).max() > 1e-4


def test_initialize_single_process_forms_no_group(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_primary()
    group = make_render_group("cpu")
    assert (group.rank, group.world, group.group) == (0, 1, None)
    assert group.device == torch.device("cpu") and group.primary


def test_initialize_arguments_and_environment(monkeypatch):
    """A stand-in for the group formation records what reaches it:
    explicit arguments, torchrun's variables, arguments over variables,
    and no group for one process."""
    calls = []
    monkeypatch.setattr(distributed, "form_group",
                        lambda *a: calls.append(a))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize("10.0.0.1:8476", 4, 2) is True
    assert calls[-1] == ("10.0.0.1:8476", 4, 2, "cuda")
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert distributed.initialize(device="cpu") is True
    assert calls[-1] == ("host0:1234", 8, 5, "cpu")
    assert distributed.initialize(process_id=0) is True
    assert calls[-1] == ("host0:1234", 8, 0, "cuda")
    n_calls = len(calls)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert len(calls) == n_calls
    assert distributed.backend_for("cuda:1") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"


@pytest.mark.parametrize("mode", ["tiles", "spp"])
def test_cli_devices_on_cpu(box_glb, tmp_path, mode, capfd):
    """The ranks are processes: their stderr is read at the descriptor."""
    out = tmp_path / f"{mode}.png"
    assert port_main(["-s", box_glb, "-x", "32", "-y", "32", "--device",
                      "cpu", "--devices", "2", "--shard-mode", mode, "-o",
                      str(out)]) == 0
    err = capfd.readouterr().err
    assert err.count("loading scene:") == 1   # rank 0's reports only
    assert f"sharding framebuffer across 2 devices (mode={mode})" in err
    assert f"wrote {out}" in err
    image = read_png(str(out))
    assert image.shape == (32, 32, 3) and 0 < image.mean() < 255
    if mode == "tiles":
        single = tmp_path / "single.png"
        assert port_main(["-s", box_glb, "-x", "32", "-y", "32", "--device",
                          "cpu", "-o", str(single)]) == 0
        np.testing.assert_array_equal(image, read_png(str(single)))


def test_cli_refuses_more_cuda_ranks_than_cards(box_glb, tmp_path,
                                                monkeypatch, capsys):
    """No fallback to fewer ranks or to the CPU: two CUDA ranks on a
    host with one card exit 1, naming both counts, before any rank
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = tmp_path / "x.png"
    assert port_main(["-s", box_glb, "-x", "8", "-y", "8", "--devices",
                      "2", "-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert "2 CUDA ranks asked for" in err and "1 CUDA device(s)" in err
    assert not out.exists()


def test_cli_devices_must_match_torchrun(box_glb, monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert port_main(["-s", box_glb, "--device", "cpu", "--devices",
                      "2"]) == 2
    assert "--devices 2, but torchrun started 3 ranks" in \
        capsys.readouterr().err


# -- the multi-rank viewer ------------------------------------------------------

class _SppMean:
    """The sharded spp frame on one device: the rank-order mean of
    ``world`` frames at seeds frame * world + r."""

    def __init__(self, scene, world):
        from vulkan_pathtracer_tpu_torch.parallel.sharding import (
            render_spp_shard,
            spp_mean,
        )

        self.world = world
        self.frame = lambda camera, frame: spp_mean([render_spp_shard(
            scene, *camera_tensors(camera, "cpu"), frame, rank=r,
            world=world, num_samples=1, num_bounces=2,
            width=ranks.VIEWER_SIZE, height=ranks.VIEWER_SIZE)[0]
            for r in range(world)])

    def render(self, camera, frame):
        return self.frame(camera, frame), None


def _single_viewer(paths, case, world):
    """(frames, text) of the single-device viewer on VIEWER_CASES[case]."""
    from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline

    mode, keys, max_frames = ranks.VIEWER_CASES[case]
    scene = ranks.box_scene(paths["box"])
    pipe = (RenderPipeline(scene, ranks.viewer_config()) if mode == "tiles"
            else _SppMean(scene, world))
    text = io.StringIO()
    frames = run_viewer(pipe, ranks.box_camera(), out=text,
                        keys=io.StringIO(keys), max_frames=max_frames)
    return frames, text.getvalue()


@pytest.fixture(scope="module")
def two_viewers(paths):
    """The viewer cases on a 2-rank group, by rank."""
    return distributed.spawn(ranks.viewer_ranks, 2, "cpu", paths)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(ranks.VIEWER_CASES))
def test_viewer_on_ranks(paths, four, two_viewers, world, case):
    """Rank 0 presents the single-device viewer's text byte for byte;
    every rank renders the same number of frames (quit, EOF, or
    max_frames), and the others write nothing."""
    by_rank = [r[case] for r in (four[2] if world == 4 else two_viewers)]
    frames, text = _single_viewer(paths, case, world)
    assert frames == {"eof": 3, "max_frames": 3}.get(case, 5)
    assert by_rank[0] == (frames, text)
    assert f"frame {frames - 1}" in text
    assert [r[0] for r in by_rank] == [frames] * world
    assert all(r[1] == "" for r in by_rank[1:])


def test_cli_interactive_devices_on_cpu(box_glb):
    """``--interactive --devices 2``: rank 0 reads the CLI's piped
    stdin; the text equals the single-device viewer's, the run exits 0
    and says once how many frames it showed."""
    cmd = [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s", box_glb,
           "-x", "16", "-y", "16", "--interactive", "--device", "cpu"]
    runs = [subprocess.run(cmd + extra, input="jlikq", capture_output=True,
                           text=True, timeout=300)
            for extra in ([], ["--devices", "2"])]
    for proc in runs:
        assert proc.returncode == 0, proc.stderr
        assert proc.stderr.count("viewer closed after 5 frames") == 1
    assert runs[1].stdout == runs[0].stdout and "frame 4" in runs[1].stdout
    assert "sharding framebuffer across 2 devices" in runs[1].stderr
