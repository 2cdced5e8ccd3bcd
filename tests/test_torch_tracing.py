"""The port's tracer (``utils/profiling.py``) on the CPU, and one card
test.

- Off, a render records nothing (the tracer's hooks are not reached),
  and its image and rays are bitwise those of a traced render.
- The span tree of one ``render``, ``render_batch_sum`` and
  ``render_pooled`` call: one root, the children at their sites.
- The live lanes counted in the bounce spans sum to the rays the call
  returns; the traversal spans launched at least as many lanes.
- Attribution on a synthetic trace: the clock offset from launch pairs,
  each operation to its launch's span, each gap to the innermost span
  open at its start, the waits and the idle time inside the program.
- The synchronising calls' bookkeeping, with sync warnings faked on the
  CPU: counted against the innermost span, at the program's line.
- On the card (marker ``cuda``; this file imports no JAX):

      python -m pytest --noconftest -p no:cacheprovider -m cuda \\
          tests/test_torch_tracing.py

  one ``.item()`` added inside a span reads as one more sync.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.render import pipeline
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig, profiling

SIZE = 16


def _camera(z: float = -3.0):
    return Camera(aspect_ratio=1.0, position=np.array([0, 0, z], np.float32))


def _pipe(scene):
    pipe = RenderPipeline(scene, RenderConfig(
        resolution_x=SIZE, resolution_y=SIZE, num_bounces=3))
    pipe._sort_secondary = True    # the sort's sites on a small scene too
    return pipe


@pytest.fixture(scope="module")
def box_scene(box_glb):
    return build_device_scene(gltf.load(box_glb), max_leaf_size=4,
                              device="cpu")


CALLS = {
    "render": ("frame", lambda p: p.render(_camera(), 3)),
    "render_batch_sum": ("batch", lambda p: p.render_batch_sum(_camera(), 3,
                                                               2)),
    "render_pooled": ("group", lambda p: p.render_pooled(
        [_camera(), _camera(-2.5)], [3, 4])),
}


def _traced(pipe, call):
    with profiling.tracing() as tracer:
        out = call(pipe)
    return out, tracer.collect()


def test_off_records_nothing_and_on_is_bitwise(box_scene, monkeypatch):
    pipe = _pipe(box_scene)
    (image_on, rays_on), record = _traced(pipe, CALLS["render"][1])
    assert record.spans and profiling._tracer is None

    def reached(*args, **kwargs):
        raise AssertionError("a tracer hook ran with the tracer off")

    for hook in ("open", "launched", "count_live"):
        monkeypatch.setattr(profiling.Tracer, hook, reached)
    assert profiling.span("frame") is profiling._OFF
    image_off, rays_off = pipe.render(_camera(), 3)
    assert torch.equal(image_on, image_off)
    assert int(rays_on) == int(rays_off)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_span_tree(box_scene, call):
    root_name, fn = CALLS[call]
    _, record = _traced(_pipe(box_scene), fn)
    roots = record.roots()
    assert [s["name"] for s in roots] == [root_name]
    root = roots[0]["id"]
    by_id = {s["id"]: s for s in record.spans}
    for s in record.spans:
        assert s["root"] == root
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    children = {s["name"] for s in record.spans if s["parent"] == root}
    assert {"primaries", "finish"} <= children
    bounces = record.named("bounce")
    assert sorted({s["j"] for s in bounces}) == [0, 1, 2]
    for name in ("traverse", "shade"):
        assert {by_id[s["parent"]]["name"] for s in record.named(name)} \
            == {"bounce"}
    assert all(by_id[s["parent"]]["name"] == "bounce"
               for s in record.named("sort"))
    assert {by_id[s["parent"]]["j"] for s in record.named("sort")} == {1, 2}
    assert all(s["key"] for s in record.named("traverse"))


@pytest.mark.parametrize("call", sorted(CALLS))
def test_live_lanes_equal_rays(box_scene, call):
    (_, rays), record = _traced(_pipe(box_scene), CALLS[call][1])
    bounces = record.named("bounce")
    assert all(s["live"] is not None for s in bounces)
    assert sum(s["live"] for s in bounces) == int(rays)
    by_id = {s["id"]: s for s in record.spans}
    for b in bounces:
        lanes = sum(s["lanes"] for s in record.named("traverse")
                    if s["parent"] == b["id"])
        assert lanes >= b["live"]
    assert bounces[0]["live"] > 0
    assert sum(lanes for _, _, lanes in record.launches) == sum(
        s["lanes"] for s in record.named("traverse"))
    assert all(by_id[s["parent"]]["name"] == "bounce"
               for s in record.named("traverse"))


def test_shading_launches_counted_apart(box_scene, monkeypatch):
    """On the CPU the shading chain is plain: no shading kernel key
    counts it.  A shading launch reported inside
    each ``shade`` span (as ``ops.shade`` reports its kernels on a card)
    gives those spans its lanes and leaves ``traverse_live_share``, which
    reads the traversal spans alone, unchanged."""
    from ptbench import program_spans
    from vulkan_pathtracer_tpu_torch.ops import shade
    from vulkan_pathtracer_tpu_torch.render import wavefront

    pipe = _pipe(box_scene)
    before = dict(shade.LAUNCHES)
    (_, rays), plain = _traced(pipe, CALLS["render"][1])
    assert shade.LAUNCHES == before
    shade_and_extend = wavefront._shade_and_extend

    def reporting(scene, hit, origin, *args, **kwargs):
        out = shade_and_extend(scene, hit, origin, *args, **kwargs)
        profiling.launched("shade_extend", origin)
        return out

    monkeypatch.setattr(wavefront, "_shade_and_extend", reporting)
    (_, rays_on), reported = _traced(pipe, CALLS["render"][1])
    assert int(rays_on) == int(rays)
    shades = reported.named("shade")
    assert all(s["key"] == "shade_extend" and s["lanes"] == SIZE * SIZE
               for s in shades if s["lanes"])
    assert sum(s["lanes"] for s in shades) > 0
    assert sum(s["lanes"] for s in plain.named("shade")) == 0
    share = [program_spans.readings(r, None, 1)["traverse_live_share"]
             for r in (plain, reported)]
    assert share[0] == share[1] is not None


def test_every_reported_kernel_pairs_the_clock():
    """Each kernel of ``csrc/shade.cu``, all of whose launches
    ``ops.shade`` reports to ``launched``, is one the clock pairs by name
    (``LAUNCHED_KERNELS``), and so is the kernel of each ``LAUNCHES``
    key: a reported launch whose kernel the clock does not pair leaves
    the host's and the trace's counts unequal, and the window with no
    clock."""
    import re

    from vulkan_pathtracer_tpu_torch.ops import shade

    with open(os.path.join(profiling.PACKAGE, "csrc", "shade.cu")) as f:
        kernels = set(re.findall(
            r"__global__ void __launch_bounds__\(\w+\)\s+(\w+_kernel)\(",
            f.read()))
    assert len(kernels) == 4
    assert kernels <= set(profiling.LAUNCHED_KERNELS)
    for key in shade.LAUNCHES:
        assert any(key.startswith(k.removesuffix("_kernel"))
                   for k in kernels), key


def _span(i, name, start_us, end_us, parent, root, lanes=0):
    return {"name": name, "id": i, "parent": parent, "root": root,
            "start_ns": int(start_us * 1000), "end_ns": int(end_us * 1000),
            "j": None, "lanes": lanes, "key": None, "live": None}


def _x(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_attribution_on_a_synthetic_trace():
    """Host µs h lie at trace µs h + 500 (+ 2 at the second pair)."""
    spans = [_span(0, "frame", 1000, 2000, -1, 0),
             _span(1, "bounce", 1100, 1800, 0, 0),
             _span(2, "traverse", 1200, 1300, 1, 0, lanes=10),
             _span(3, "shade", 1400, 1700, 1, 0),
             _span(4, "frame", 3000, 4000, -1, 4),
             _span(5, "traverse", 3200, 3300, 4, 4, lanes=10)]
    record = profiling.Record(
        spans=spans, syncs=[(1, "render/wavefront.py:10", 1_795_000),
                            (-1, "run.py:1", 2_900_000)],
        launches=[(1_250_000, "quad_closest_hit", 10),
                  (3_250_000, "quad_closest_hit", 10)])
    walk = "void (anonymous namespace)::stack_kernel<4, false>(Tables)"
    events = [
        _x("cuda_runtime", "cudaLaunchKernel", 1745, 5, 1),
        _x("kernel", walk, 1800, 100, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 2001, 3, 3),
        _x("kernel", "void at::native::elementwise_kernel", 2010, 200, 3),
        _x("cuda_runtime", "cudaStreamSynchronize", 2251, 40, -1),
        _x("cuda_runtime", "cudaLaunchKernel", 3001, 3, 4),
        _x("kernel", "void at::native::elementwise_kernel", 3010, 10, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 3747, 5, 2),
        _x("kernel", walk, 3800, 50, 2),
        {"ph": "i", "cat": "cuda_runtime", "name": "marker", "ts": 0}]
    timeline = profiling.Timeline.of(events)
    clock = profiling.clock_offset(record, timeline)
    assert (clock.source, clock.pairs) == ("launches", 2)
    assert clock.offset_us == pytest.approx(501.0)
    assert clock.range_us == pytest.approx(2.0)
    at = profiling.attribute(record, timeline, clock,
                             window_ns=(900_000, 4_100_000))
    assert at.device_us == pytest.approx({2: 100.0, 3: 200.0, 5: 50.0})
    assert at.unattributed_us == pytest.approx(10.0)
    assert at.attributed_share == pytest.approx(350 / 360)
    assert at.device_us_under("bounce") == pytest.approx(300.0)
    assert at.device_us_under("frame") == pytest.approx(350.0)
    assert at.busy_us == pytest.approx(360.0)
    assert at.window_us == pytest.approx(3200.0)
    assert at.idle_by_span == pytest.approx(
        {profiling.OUTSIDE: 399.0 + 780.0, "bounce": 110.0 + 800.0,
         "frame": 751.0})
    assert at.host_us == pytest.approx(2000.0)
    assert at.wait_us == pytest.approx(40.0)
    assert at.wait_by_site == pytest.approx({"render/wavefront.py:10": 40.0})
    assert at.idle_in_roots == pytest.approx({"frame": 700.0 + 950.0 - 40.0})
    assert at.idle_in_program_us == pytest.approx(700.0 + 950.0 - 40.0)
    # Where no walk kernel ran, the root spans' annotations pair.
    marks = [{"ph": "X", "cat": "user_annotation", "name": "frame",
              "ts": 900 + 700, "dur": 1100},
             {"ph": "X", "cat": "user_annotation", "name": "frame",
              "ts": 3000 + 704, "dur": 1000}]
    clock = profiling.clock_offset(
        profiling.Record(spans=spans), profiling.Timeline.of(marks))
    assert (clock.source, clock.offset_us, clock.range_us) == (
        "annotations", 702.0, 4.0)


def test_sync_bookkeeping(box_scene, monkeypatch):
    """Sync warnings faked at ``_scalar`` (two in the primaries, one in
    the finish) count against their spans at the program's line; a
    warning outside every span counts outside; other warnings pass
    through."""
    scalar = pipeline._scalar

    def syncing_scalar(x, device):
        warnings.warn(profiling.SYNC_WARNING + " (faked)", UserWarning)
        return scalar(x, device)

    monkeypatch.setattr(pipeline, "_scalar", syncing_scalar)
    pipe = _pipe(box_scene)
    with profiling.tracing() as tracer:
        pipe.render(_camera(), 3)
        with pytest.warns(UserWarning, match="another warning"):
            warnings.warn("another warning", UserWarning)
        pipeline._scalar(1.0, "cpu")
    record = tracer.collect()
    by_id = {s["id"]: s for s in record.spans}
    inside = record.program_syncs()
    assert sorted(by_id[i]["name"] for i, _, _ in inside) == [
        "finish", "primaries", "primaries"]
    assert all(site.startswith("render/pipeline.py:") for _, site, _ in
               inside)
    assert len({site for _, site, _ in inside}) == 3
    assert [(i, site.split(":")[0]) for i, site, _ in record.syncs
            if i < 0] == [(-1, "test_torch_tracing.py")]
    # A second frame repeats the count exactly.
    with profiling.tracing() as tracer:
        pipe.render(_camera(), 4)
    assert len(tracer.collect().program_syncs()) == 3
    with pytest.raises(RuntimeError, match="already on"):
        with profiling.tracing():
            with profiling.tracing():
                pass


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_item_reads_as_one_more_sync(cuda, tmp_path, monkeypatch):
    from assets.procedural import make_box

    path = tmp_path / "box.glb"
    make_box(str(path))
    scene = build_device_scene(gltf.load(str(path)), max_leaf_size=4,
                               device=cuda)
    pipe = RenderPipeline(scene, RenderConfig(
        resolution_x=SIZE, resolution_y=SIZE, traversal="brute"))
    pipe.render(_camera(), 0)
    torch.cuda.synchronize()

    def frame_syncs():
        with profiling.tracing() as tracer:
            pipe.render(_camera(), 1)
        record = tracer.collect()
        return len(record.program_syncs())

    before = frame_syncs()
    assert before == frame_syncs() > 0
    render_frame = pipeline.render_frame

    def with_item(*args, **kwargs):
        image, rays = render_frame(*args, **kwargs)
        rays.item()
        return image, rays

    monkeypatch.setattr(pipeline, "render_frame", with_item)
    assert frame_syncs() == before + 1
