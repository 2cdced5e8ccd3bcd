"""Animated glTF scenes on the port's normal path, on the CPU.

Held to the benchmark's plain animated reference
(``ptbench/reference_animated``: the channels evaluated by its own code
in float64, the world triangles flattened, its own tree and path
tracer), on a tiny columns scene (3 x 3 columns of 2 boxes, one floor
and light node) with seeded random keyframes: translation, rotation
about random axes and positive scale, ``LINEAR`` and ``STEP``:

- whole 64 x 36 frames, 2 bounces, at three seeded frame counters (each
  at its clock's time), two-level and flat: pixels off by more than the
  benchmark's tolerance (2^-16 + 2^-10 |reference|) at most the
  benchmark's limit, 0.5%;
- the device evaluator against the reference's float64 evaluation:
  each instance's world transform within one f32 rounding (2^-24
  relative, as the evaluator works in float64 and rounds once) plus
  float64 noise (1e-12), before the first key, after the last, between
  keys, ``STEP``, and under a chain of two animated parent nodes;
- ``update_instance_transforms`` at the moved transforms against a
  fresh two-level bake of the moved scene: the same hits;
- the refusals (``CUBICSPLINE``, morph ``weights``, skins, quirk mode:
  the file loads at rest and refuses a pose; the pooled wavefront,
  several devices, batches: ``--animation-step 0`` renders at rest),
  the CLI's clock (``--animation-step``), the spans and counters of a
  posed frame against a static one's, and a graphed frame's inner spans
  read as absent.

The card tests (marked ``cuda``) pose the scene under PyTorch's sync
debug mode ``error`` (the pose and its update read nothing back), and
hold the graphed pose and the graphed frame, posed or static, to the
eager ones bitwise.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import struct

import numpy as np
import pytest
import torch

from ptbench import check
from ptbench.orbit import Orbit, camera_vectors
from ptbench.reference_animated import gltf as ref_gltf
from ptbench.reference_animated import render as ref_render
from ptbench.scenes import columns
from vulkan_pathtracer_tpu_torch.app import main as cli
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu_torch.models.node_animation import NodeAnimator
from vulkan_pathtracer_tpu_torch.ops import shade
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T
from vulkan_pathtracer_tpu_torch.render import pipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig, profiling

GRID, SEGMENTS, MATERIALS = 3, 2, 4
W, H = 64, 36
CHECK = {"rtol": 2.0 ** -10, "atol": 2.0 ** -16}
LIMIT = 0.5                     # percent of pixels, the benchmark's
FRAMES = (2**31 + 5, 2**31 + 1000, 77)   # three seeded counters
# The benchmark's clock, carried by the scene file for the reference.
CLOCK = {"period_frames": 128, "frames_per_second": 32.0}


def seconds(frame: int) -> float:
    return (frame % CLOCK["period_frames"]) / CLOCK["frames_per_second"]


def _axis_turn(rng, n):
    """(n, 4) xyzw quaternions about one random axis, random angles."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    half = 0.5 * rng.uniform(-np.pi, np.pi, size=n)
    return np.concatenate([np.sin(half)[:, None] * axis,
                           np.cos(half)[:, None]], axis=1)


def random_channels(seed: int, grid: int = GRID, groups: int = 0) -> list:
    """Seeded keyframes for every column (and each group node): a
    translation, a rotation about a random axis and a positive scale,
    each LINEAR or STEP at its own sorted key times in [0.3, 3.7]."""
    rng = np.random.default_rng(seed)
    out = []
    nodes = list(range(grid * grid)) + [grid * grid + 1 + g
                                        for g in range(groups)]
    rest = dict(enumerate(columns.column_positions(grid)))
    for node in nodes:
        x, z = rest.get(node, (0.0, 0.0))
        for path in ("translation", "rotation", "scale"):
            k = int(rng.integers(1, 6))
            times = np.sort(rng.uniform(0.3, 3.7, size=k))
            if path == "translation":
                values = np.array([x, 0.0, z]) + rng.uniform(-0.6, 0.6,
                                                             (k, 3))
            elif path == "rotation":
                values = _axis_turn(rng, k)
            else:
                values = rng.uniform(0.6, 1.4, (k, 3))
            out.append({"node": node, "path": path, "times": times,
                        "values": values,
                        "interpolation": ("STEP" if rng.uniform() < 0.3
                                          else "LINEAR")})
    return out


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("anim") / "columns.glb")
    columns.make_columns(path, GRID, SEGMENTS, MATERIALS,
                         channels=random_channels(11),
                         extras={"clock": CLOCK})
    return path


@pytest.fixture(scope="module")
def chain_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("chain") / "chain.glb")
    columns.make_columns(path, GRID, SEGMENTS, MATERIALS,
                         channels=random_channels(12, groups=2), groups=2)
    return path


def _camera(aspect):
    position, yaw, pitch = Orbit(9.0, 6.0, 4.0, (0.0, 1.0, 0.0)).pose(1.1)
    cam = Camera(aspect_ratio=aspect)
    cam.position = np.asarray(position, dtype=np.float32)
    cam.set_orientation(yaw=yaw, pitch=pitch)
    return cam, camera_vectors(position, yaw, pitch, aspect=aspect)


def _pipe(path, instanced, **kw):
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=W,
                          resolution_y=H, **kw)
    return cli.load_pipeline(path, config, torch.device("cpu"),
                             instanced=instanced)


@pytest.fixture(scope="module")
def pipes(scene_path):
    return {inst: _pipe(scene_path, inst) for inst in (True, False)}


@pytest.fixture(scope="module")
def reference(scene_path):
    return ref_render.load_scene(scene_path)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("instanced", [True, False],
                         ids=["two-level", "flat"])
def test_frame_against_reference(pipes, reference, instanced, frame):
    pipe = pipes[instanced]
    cam, vectors = _camera(pipe.config.aspect_ratio)
    image, _ = pipe.render(cam, frame, time=seconds(frame))
    pix = torch.arange(W * H)
    ref = ref_render.render_views(reference, [(vectors, frame)], pix % W,
                                  pix // W, W, H, 2)[0]
    off = check.off_mask(image.reshape(-1, 3), ref, CHECK)
    assert 100.0 * float(off.float().mean()) <= LIMIT
    assert float(ref.amax()) > 0.0 and not reference.posed[
        seconds(frame)].emissive_free


def _rel_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got - want) - (2.0 ** -24 * np.abs(want) + 1e-12)


@pytest.mark.parametrize("case", ["before", "after", "between", "step",
                                  "chain"])
def test_evaluator_against_reference(scene_path, chain_path, case):
    path = chain_path if case == "chain" else scene_path
    host = gltf.load(path)
    doc = ref_gltf.load(path)
    chans = host.animation.channels
    first = min(float(c.times[0]) for c in chans)
    last = max(float(c.times[-1]) for c in chans)
    if case == "step":
        # The middle of a STEP channel's first two keys.
        c = next(c for c in chans if c.interpolation == "STEP"
                 and len(c.times) > 1)
        t = 0.5 * float(c.times[0] + c.times[1])
    else:
        t = {"before": first - 0.25, "after": last + 0.5,
             "between": 0.5 * (first + last), "chain": 1.9}[case]
    got = NodeAnimator(host.animation, "cpu").transforms(t).double().numpy()
    worlds = ref_gltf.world_matrices(doc, t)
    want = np.stack([worlds[inst.node] for inst in host.instances])
    assert (_rel_gap(got, want) <= 0).all(), float(_rel_gap(got, want).max())
    if case == "chain":
        assert host.animation.parents[0] == GRID * GRID + 2
    if case in ("before", "after"):
        # Clamped: the same transforms a second further out.
        t2 = t - 1.0 if case == "before" else t + 1.0
        again = NodeAnimator(host.animation, "cpu").transforms(t2)
        assert np.array_equal(again.double().numpy(), got)


def test_evaluator_takes_device_time(scene_path):
    """A 0-d tensor time (what a captured pose reads) gives the float
    time's transforms bitwise."""
    anim = NodeAnimator(gltf.load(scene_path).animation, "cpu")
    for t in (0.1, 1.9, 5.0):
        want = anim.transforms(t)
        got = anim.transforms(torch.tensor(t, dtype=torch.float64))
        assert torch.equal(got, want)


def test_update_against_fresh_bake(scene_path):
    host = gltf.load(scene_path)
    scene = build_instanced_scene(host, max_leaf_size=4, device="cpu")
    moved_tf = NodeAnimator(host.animation, "cpu").transforms(2.2)
    moved = update_instance_transforms(scene, moved_tf)
    fresh_host = copy.deepcopy(host)
    for inst, m in zip(fresh_host.instances, moved_tf.numpy()):
        inst.transform = m
    fresh = build_instanced_scene(fresh_host, max_leaf_size=4, device="cpu")
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.uniform([-5, 0.2, -5], [5, 4, 5], (2048, 3)),
                     dtype=torch.float32)
    d = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(2048, 3)), dtype=torch.float32), dim=1)
    got = st.pair_closest_hit(moved, o, d)
    want = st.pair_closest_hit(fresh, o, d)
    assert torch.equal(got.t < MISS_T, want.t < MISS_T)
    assert int((got.t < MISS_T).sum()) > 200
    assert torch.equal(got.tri, want.tri)
    torch.testing.assert_close(got.t, want.t, rtol=1e-5, atol=1e-5)


def _glb_doc(path):
    with open(path, "rb") as f:
        data = f.read()
    n = struct.unpack_from("<I", data, 12)[0]
    return data, json.loads(data[20:20 + n]), n


def _rewrite(src, dst, edit):
    """A copy of the GLB ``src`` at ``dst`` with its JSON edited."""
    data, doc, n = _glb_doc(src)
    edit(doc)
    body = json.dumps(doc).encode()
    body += b" " * ((-len(body)) % 4)
    rest = data[20 + n:]
    with open(dst, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 20 + len(body)
                            + len(rest)))
        f.write(struct.pack("<II", len(body), 0x4E4F534A))
        f.write(body)
        f.write(rest)


@pytest.mark.parametrize("what", ["CUBICSPLINE", "weights", "skins",
                                  "quirk"])
def test_loader_refusals(scene_path, tmp_path, what):
    path = str(tmp_path / "bad.glb")

    def edit(doc):
        anim = doc["animations"][0]
        if what == "CUBICSPLINE":
            anim["samplers"][0]["interpolation"] = "CUBICSPLINE"
        elif what == "weights":
            anim["channels"][1]["target"]["path"] = "weights"
        elif what == "skins":
            doc["nodes"][0]["skin"] = 0
            doc["skins"] = [{"joints": [1]}]

    _rewrite(scene_path, path, edit)
    quirk = what == "quirk"
    # The file loads at rest, its reason kept.
    host = gltf.load(path, quirk_mode=quirk)
    assert host.animation is None and what in host.animation_refused
    config = RenderConfig(num_samples=1, num_bounces=1, resolution_x=16,
                          resolution_y=9)
    # A pose asked for is refused by name; at rest the file renders.
    with pytest.raises(ValueError, match=what):
        cli.load_pipeline(path, config, "cpu", quirk_mode=quirk)
    pipe = cli.load_pipeline(path, config, "cpu", quirk_mode=quirk,
                             animate=False)
    assert pipe.animation is None
    out = tmp_path / "o.png"
    argv = ["-s", path, "-x", "16", "-y", "9", "--device", "cpu",
            "-o", str(out)] + (["--gltf-quirk-mode"] if quirk else [])
    assert cli.main(argv) == 2 and not out.exists()
    assert cli.main(argv + ["--animation-step", "0"]) == 0 and out.exists()


def test_pooled_refuses(pipes):
    pipe = pipes[True]
    cam, _ = _camera(pipe.config.aspect_ratio)
    with pytest.raises(ValueError, match="animations"):
        pipe.render_pooled([cam, cam], [0, 1])


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--pool-frames", "2", "--frames", "2"],
                                   ["--progressive", "--batch-frames", "2",
                                    "--frames", "2"]],
                         ids=["devices", "pooled", "batches"])
def test_cli_refuses(scene_path, tmp_path, capsys, flags):
    argv = ["-s", scene_path, "-x", "16", "-y", "9", "--device", "cpu",
            "-o", str(tmp_path / "o.png"), *flags]
    config, args = cli.parse_args(argv)
    group = None
    if "--devices" in flags:
        # One rank's view: the refusal comes before any collective.
        group = type("Group", (), {"primary": True, "world": 2,
                                   "device": torch.device("cpu")})()
    assert cli.render_main(config, args, torch.device("cpu"), group) == 2
    err = capsys.readouterr().err
    named = next(f for f in flags if f in ("--devices", "--pool-frames",
                                           "--batch-frames"))
    assert "animations" in err and named in err
    assert "--animation-step 0" in err
    assert not os.path.exists(tmp_path / "o.png")
    if group is None:
        # At rest the same flags render the file.
        config, args = cli.parse_args(argv + ["--animation-step", "0"])
        assert cli.render_main(config, args, torch.device("cpu")) == 0
        assert os.path.exists(tmp_path / "o.png")


def test_cli_animation_step(scene_path, tmp_path, monkeypatch):
    times = []
    render = pipeline.RenderPipeline.render

    def spy(self, camera, frame, present_order=True, time=None):
        times.append((frame, time))
        return render(self, camera, frame, present_order, time)

    monkeypatch.setattr(pipeline.RenderPipeline, "render", spy)
    out = tmp_path / "o.png"
    rc = cli.main(["-s", scene_path, "-x", "16", "-y", "9", "--device",
                   "cpu", "--frames", "3", "--animation-step", "0.5",
                   "-o", str(out), "--instanced"])
    assert rc == 0 and out.exists()
    assert times == [(0, 0.0), (1, 0.5), (2, 1.0)]


def _names(record):
    return [s["name"] for s in record.spans]


def test_spans_and_counters(pipes, scene_path):
    pipe = pipes[True]
    cam, _ = _camera(pipe.config.aspect_ratio)
    with profiling.tracing() as tracer:
        pipe.render(cam, 3, time=1.25)
        pipe.render(cam, 4)
    record = tracer.collect()
    frames = record.named("frame")
    assert len(frames) == 2
    for name in ("animate", "update"):
        (s,) = record.named(name)
        assert s["root"] == frames[0]["id"] == s["parent"]
    assert record.counted("instances_moved") == GRID * GRID
    scene = pipe.scene
    assert record.counted("update_records") == (
        scene.skip_nodes.shape[0] + scene.pair_box.shape[0]
        + scene.inst_inv.shape[0])
    # Without a time, the animated scene's frame is a static frame's.
    static = cli.load_pipeline(
        scene_path, dataclasses.replace(pipe.config), torch.device("cpu"),
        instanced=True)
    static.animation = None
    with profiling.tracing() as tracer:
        static.render(cam, 4, time=1.25)
    spans = [s for s in record.spans if s["root"] == frames[1]["id"]]
    assert _names(tracer.collect()) == [s["name"] for s in spans]


def test_graphed_frame_spans_read_absent():
    """A window whose frames replayed a graph (``GRAPH_KEY``): a span it
    never entered reads as absent (NaN), not 0; the spans it entered
    read their device time; an eager window reads 0 as before."""
    def span(i, name, parent, key=None):
        return {"name": name, "id": i, "parent": parent,
                "root": 0, "start_ns": i, "end_ns": 10, "j": None,
                "lanes": 0, "key": key, "live": None}

    clock = profiling.Clock(0.0, 0.0, 0.0, 1, "launches")
    for key in (profiling.GRAPH_KEY, None):
        spans = [span(0, "frame", -1, key), span(1, "animate", 0),
                 span(2, "update", 0)]
        at = profiling.Attribution(
            clock=clock, window_us=1000.0, busy_us=600.0,
            device_us={0: 300.0, 1: 50.0, 2: 25.0}, unattributed_us=0.0,
            idle_by_span={}, idle_in_roots={}, host_us=800.0, wait_us=0.0,
            wait_by_site={}, spans=spans)
        assert at.device_us_under("frame") == 375.0
        assert at.device_us_under("animate") == 50.0
        shade = at.device_us_under("shade")
        assert math.isnan(shade) if key else shade == 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("instanced", [True, False],
                         ids=["two-level", "flat"])
def test_pose_reads_nothing_back(cuda, scene_path, instanced):
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=W,
                          resolution_y=H)
    pipe = cli.load_pipeline(scene_path, config, cuda, instanced=instanced)
    cam, _ = _camera(config.aspect_ratio)
    pipe.render(cam, 0, time=0.5)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scene = pipeline.pose_scene(pipe.animation, 1.75)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    pipe.scene = scene
    image, _ = pipe.render(cam, 1)
    cpu = _pipe(scene_path, instanced)
    want, _ = cpu.render(cam, 1, time=1.75)
    off = check.off_mask(image.cpu().reshape(-1, 3), want.reshape(-1, 3),
                         CHECK)
    assert 100.0 * float(off.float().mean()) <= LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("time", [0.0, 0.4, 1.75, 3.9])
def test_graphed_pose_matches_eager(cuda, scene_path, time):
    """The two-level pose on the card replays its captured graphs: the
    posed tables are an eager update's at every time, bitwise."""
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=W,
                          resolution_y=H)
    pipe = cli.load_pipeline(scene_path, config, cuda, instanced=True)
    anim = pipe.animation
    assert anim.graphed
    first = pipeline.pose_scene(anim, 2.5)
    got = pipeline.pose_scene(anim, time)
    assert got is first
    want = update_instance_transforms(anim.rest,
                                      anim.motion.transforms(time))
    for f in ("inst_inv", "inst_nrm", "pair_box", "skip_nodes", "root_lo",
              "root_hi"):
        # Bits: the skip records hold integers viewed as floats.
        a, b = getattr(got, f).view(torch.int32), getattr(want, f).view(
            torch.int32)
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("frame", FRAMES)
def test_graphed_frame_matches_eager(cuda, scene_path, frame):
    """A posed frame on the card replays its FrameGraph (at a size in
    tile order): the eager frame of the same posed scene, bitwise, for
    another camera and counter than the captured ones."""
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=160,
                          resolution_y=90)
    pipe = cli.load_pipeline(scene_path, config, cuda, instanced=True)
    assert pipe.graphs_frames
    cam, _ = _camera(config.aspect_ratio)
    pipe.render(Camera(aspect_ratio=config.aspect_ratio), frame + 7,
                present_order=False, time=0.3)
    image, rays = pipe.render(cam, frame, present_order=False,
                              time=seconds(frame))
    want, want_rays = pipe._frame(pipeline.camera_tensors(cam, cuda),
                                  frame, False)
    assert len(pipe._graphs) == 1
    assert torch.equal(image, want), float((image - want).abs().max())
    assert int(rays) == int(want_rays) > 0


@pytest.mark.cuda
def test_static_frame_is_graphed(cuda, scene_path, monkeypatch):
    """A static frame of the same tier (the file baked at rest) replays
    a FrameGraph too, the eager frame bitwise, and is captured anew for
    a new scene; roulette, a kernel choice, the flat bake and the plain
    shading chain run eagerly."""
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=160,
                          resolution_y=90)
    pipe = cli.load_pipeline(scene_path, config, cuda, instanced=True,
                             animate=False)
    assert pipe.graphs_frames and pipe.animation is None
    cam, _ = _camera(config.aspect_ratio)
    pipe.render(Camera(aspect_ratio=config.aspect_ratio), 9)
    image, rays = pipe.render(cam, 5, present_order=False)
    want, want_rays = pipe._frame(pipeline.camera_tensors(cam, cuda), 5,
                                  False)
    assert torch.equal(image, want) and int(rays) == int(want_rays) > 0
    first = pipe._graphs[False]
    pipe.scene = dataclasses.replace(pipe.scene)
    again, _ = pipe.render(cam, 5, present_order=False)
    assert pipe._graphs[False] is not first and torch.equal(again, want)
    assert not pipeline.RenderPipeline(pipe.scene, dataclasses.replace(
        config, russian_roulette=True)).graphs_frames
    assert not pipeline.RenderPipeline(pipe.scene, dataclasses.replace(
        config, kernel_secondary="pair")).graphs_frames
    flat = cli.load_pipeline(scene_path, config, cuda, animate=False)
    assert not flat.graphs_frames
    monkeypatch.setattr(shade, "fused", lambda x: False)
    assert not pipe.graphs_frames
