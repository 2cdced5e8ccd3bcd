"""The plain reference against the program on the tiny atrium, and the
control: the reference in bfloat16 in the program's place fails the
check."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ptbench import check
from ptbench.orbit import Orbit, camera_vectors
from ptbench.reference import render, tree
from ptbench.reference.gltf import load_triangles
from ptbench.run import scene_file
from ptbench.tests.conftest import SIZES
from ptbench.traffic import Traffic


@pytest.fixture(scope="module")
def scene_path():
    return scene_file(SIZES["scene"])


def test_walk_is_the_brute_force_closest_hit(scene_path):
    tri = load_triangles(scene_path)
    ref = tree.build_tree(tri.v0, tri.e1, tri.e2)
    rng = np.random.default_rng(5)
    n = 1500
    o = torch.tensor(rng.uniform([-9, 0.3, -5], [9, 9, 5], (n, 3)),
                     dtype=torch.float32)
    d = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32), dim=1)
    t, hit_tri, _, _ = tree.walk(ref, o, d)
    v0, e1, e2 = (torch.tensor(a) for a in (tri.v0, tri.e1, tri.e2))
    best = torch.full((n,), tree.MISS_T)
    best_tri = torch.full((n,), -1, dtype=torch.int64)
    for s in range(0, tri.count, 512):
        hit, tt, _, _ = tree.moller_trumbore(
            o[:, None], d[:, None], v0[None, s:s + 512], e1[None, s:s + 512],
            e2[None, s:s + 512], tree.TMIN,
            torch.clamp(best, max=tree.TMAX)[:, None])
        tt = torch.where(hit, tt, torch.full_like(tt, tree.MISS_T))
        m, arg = tt.min(dim=1)
        better = m < best
        best = torch.where(better, m, best)
        best_tri = torch.where(better, arg + s, best_tri)
    assert torch.equal(t, best) and torch.equal(hit_tri, best_tri)
    any_hit = tree.walk(ref, o, d, any_hit=True)
    assert torch.equal(any_hit, best < tree.MISS_T)


@pytest.mark.parametrize("instanced", [False, True])
def test_reference_is_the_program_frame(scene_path, instanced):
    """Every pixel of a frame: the program (flat or two-level bake)
    and the reference agree bit for bit on this scene."""
    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    w, h = SIZES["width"], SIZES["height"]
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=w,
                          resolution_y=h)
    pipe = load_pipeline(scene_path, config, torch.device("cpu"),
                         instanced=instanced)
    position, yaw, pitch = Orbit(4.5, 2.2, 4.0, (0.0, 1.2, 0.0)).pose(2.7)
    cam = Camera(aspect_ratio=config.aspect_ratio)
    cam.position = np.asarray(position, dtype=np.float32)
    cam.set_orientation(yaw=yaw, pitch=pitch)
    image, _ = pipe.render(cam, 2**31 + 3)
    vectors = camera_vectors(position, yaw, pitch, aspect=w / h)
    for mine, theirs in zip(vectors, cam.push_constants()):
        assert np.array_equal(mine, theirs)
    scene = render.load_scene(scene_path)
    pix = torch.arange(w * h)
    ref = render.render_views(scene, [(vectors, 2**31 + 3)], pix % w,
                              pix // w, w, h, 2)[0]
    assert torch.equal(image.reshape(-1, 3), ref)
    assert float(ref.amax()) > 0.0


@pytest.mark.parametrize("mix_name", ["orbit", "still"])
def test_control_fails_the_check(scene_path, mix_name):
    """The reference in bfloat16 in the program's place reads above the
    limit, on frames and on a converged still."""
    import json
    import os

    from ptbench.cell import HERE

    with open(os.path.join(HERE, "traffic", f"{mix_name}.json")) as f:
        mix = json.load(f)
    mix = {**mix, "batch": 4, "target_spp": 8,
           "check": {**mix["check"], "pixels": 1024}}
    w, h = SIZES["width"], SIZES["height"]
    traffic = Traffic(mix, 99, w, h, torch.device("cpu"))
    scene = render.load_scene(scene_path)
    vectors = camera_vectors(*traffic.pose(0), aspect=w / h)
    if traffic.kind == "joint":
        values = (render.accumulate_pixels(scene, vectors, 5, 8, traffic.px,
                                           traffic.py, w, h, 2) / 8).float()
        item = {"index": 0, "frame0": 5, "spp": 8, "values": values}
    else:
        values = render.render_views(scene, [(vectors, 5)], traffic.px,
                                     traffic.py, w, h, 2)[0]
        item = {"index": 0, "frame": 5, "values": values}
    config = {"width": w, "height": h, "bounces": 2}
    out = check.compare([item], traffic, config, scene_path,
                        torch.device("cpu"), control=True)
    assert out["numbers"]["pixels_off"]["value"] == 0.0
    assert out["control"] > mix["check"]["limit"]
