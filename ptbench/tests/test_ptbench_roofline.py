"""The traversal roofline's work count depends on the rays alone: the
flat and the two-level bakes of one scene, given the same frames, give
the same count, and the count does not depend on the order of the
rays."""

from __future__ import annotations

import numpy as np
import torch

from ptbench import spans, work
from ptbench.metrics import traverse_roofline
from ptbench.orbit import Orbit
from ptbench.reference import tree
from ptbench.reference.gltf import load_triangles
from ptbench.run import scene_file
from ptbench.tests.conftest import SIZES


def _work(instanced: bool, path: str, ref):
    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    w, h = SIZES["width"], SIZES["height"]
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=w,
                          resolution_y=h)
    pipe = load_pipeline(path, config, torch.device("cpu"),
                         instanced=instanced)
    recorder = spans.Recorder(torch.device("cpu"), seed=41)
    recorder.sample("traverse_roofline", *traverse_roofline.SAMPLE)
    orbit = Orbit(4.5, 2.2, 4.0, (0.0, 1.2, 0.0))
    try:
        for f in range(spans.SAMPLE_EVERY + 1):
            position, yaw, pitch = orbit.pose(0.5 * f)
            cam = Camera(aspect_ratio=config.aspect_ratio)
            cam.position = np.asarray(position, dtype=np.float32)
            cam.set_orientation(yaw=yaw, pitch=pitch)
            pipe.render(cam, 1000 + f)
    finally:
        recorder.restore()
    assert not recorder.missing
    return work.call_work(ref, recorder.rays)


def test_flat_and_two_level_bakes_count_the_same_work():
    path = scene_file(SIZES["scene"])
    tri = load_triangles(path)
    ref = tree.build_tree(tri.v0, tri.e1, tri.e2)
    flat, two_level = _work(False, path, ref), _work(True, path, ref)
    assert [c[0] for c in flat] == ["closest"] * 9 + ["any"] * 9
    assert flat == two_level
    assert all(ops > 0 and nbytes > 0 for _, _, ops, nbytes in flat)


def test_the_sample_does_not_depend_on_ray_order():
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.normal(size=(5000, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(5000, 3)), dtype=torch.float32)
    perm = torch.as_tensor(rng.permutation(5000))
    h = spans.ray_hash(o, d, 17)
    assert torch.equal(h[perm], spans.ray_hash(o[perm], d[perm], 17))
    a, b = spans.Recorder(torch.device("cpu"), 17), spans.Recorder(
        torch.device("cpu"), 17)
    a._take("any", o, d, None)
    b._take("any", o[perm], d[perm], None)
    (_, (oa, da, _)), (_, (ob, db, _)) = a.rays["any"][0], b.rays["any"][0]
    assert torch.equal(oa, ob) and torch.equal(da, db)
