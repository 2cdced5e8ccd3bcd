"""PyTorch port vs JAX: the whole single-frame render on the CPU.

The port (plain traversal versions on the CPU) renders the same frame
as the JAX ``RenderPipeline`` with ``traversal="auto"`` (the XLA
traversal on the CPU).  Ray counts and RNG streams are exact
contracts; radiance is allclose at rtol 1e-5 / atol 1e-5: the JAX
package's own program shapes already differ by ~2^-18 on a few
permille of lanes (PARITY.md:60), and the shading chain's sin/cos/
rsqrt need not round alike in XLA and PyTorch.

Cases: cornell (emissive, closest hit on every bounce) at 96x72 with
2 and 3 bounces — larger than one 32x64 tile, so the 2D tile order is
on; an emissive-free atrium of 24,456 triangles at leaf 28 — past the
16,384-triangle sort gate, so the last bounce takes the SORTED ANY-HIT
path; and the four goldens through golden_utils' strict comparison.
"""

import numpy as np
import pytest
import torch

from tests.golden_utils import GOLDEN_CONFIGS, compare_to_golden
from vulkan_pathtracer_tpu.app.camera_path import orbit_path
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.camera import Camera
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.render.pipeline import (
    RenderPipeline as JaxPipeline,
)
from vulkan_pathtracer_tpu.utils.config import RenderConfig
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    from assets.procedural import make_atrium

    path = tmp_path_factory.mktemp("scenes") / "atrium.glb"
    make_atrium(str(path), detail=0.3)
    return str(path)


def _render_both(path, leaf, config, camera, frame=3):
    jd = jax_build(jgltf.load(path), build_bvh=True, max_leaf_size=leaf)
    td = build_device_scene(gltf.load(path), max_leaf_size=leaf,
                            device="cpu")
    ref, ref_rays = JaxPipeline(jd, config).render_numpy(camera, frame)
    pipe = RenderPipeline(td, config)
    got, rays = pipe.render_numpy(camera, frame)
    return ref, ref_rays, got, rays, pipe


def _cornell_camera(config):
    cam = Camera(aspect_ratio=config.aspect_ratio,
                 position=np.asarray([0.0, 1.0, 0.9], np.float32))
    cam.set_orientation(yaw=180.0, pitch=0.0)
    return cam


@pytest.mark.parametrize("bounces", [2, 3])
def test_cornell_matches_jax(cornell_glb, bounces):
    config = RenderConfig(num_samples=1, num_bounces=bounces,
                          resolution_x=96, resolution_y=72)
    ref, ref_rays, got, rays, pipe = _render_both(
        cornell_glb, 14, config, _cornell_camera(config))
    assert not pipe.scene.emissive_free
    assert rays == ref_rays and rays > 96 * 72
    assert np.isfinite(got).all() and got.shape == (72, 96, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_atrium_sorted_anyhit_matches_jax(atrium_glb, monkeypatch):
    calls = []
    sorted_anyhit = wavefront._any_hit_sorted

    def spy(*args):
        calls.append(args[1].shape[0])
        return sorted_anyhit(*args)

    monkeypatch.setattr(wavefront, "_any_hit_sorted", spy)
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=96,
                          resolution_y=72)
    cam = Camera(aspect_ratio=config.aspect_ratio)
    orbit_path(radius=4.5, height=2.2, duration=4.0,
               center=(0.0, 1.2, 0.0)).apply(cam, 0.0)
    ref, ref_rays, got, rays, pipe = _render_both(atrium_glb, 28, config, cam)
    assert pipe.scene.num_triangles == 24456
    assert pipe.scene.emissive_free and pipe._sort_secondary
    assert calls == [96 * 72]
    assert rays == ref_rays and 96 * 72 < rays < 2 * 96 * 72
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,fixture", [("box", "box_glb"),
                                          ("sphere", "sphere_glb"),
                                          ("textured", "sphere_glb"),
                                          ("cornell", "cornell_glb")])
def test_golden(name, fixture, request):
    """The JAX package's four goldens (leaf-4 bake, as golden_utils
    renders them) through golden_utils' strict comparison: sphere the
    textured sphere at 2 spp, textured its close-up at 4 spp (the
    texture + normal-map path), cornell 4 spp x 4 bounces the sample
    loop and middle bounces."""
    spec = GOLDEN_CONFIGS[name]
    config = RenderConfig(**spec["config"])
    td = build_device_scene(gltf.load(request.getfixturevalue(fixture)),
                            max_leaf_size=4, device="cpu")
    cam = Camera(aspect_ratio=config.aspect_ratio,
                 position=np.asarray(spec["camera"]["position"], np.float32))
    cam.set_orientation(yaw=spec["camera"]["yaw"],
                        pitch=spec["camera"]["pitch"])
    image, _ = RenderPipeline(td, config).render_numpy(cam, spec["frame"])
    compare_to_golden(name, image)


def test_present_order_roundtrip(cornell_glb):
    """Tile-order radiance + to_present == scanline radiance."""
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=96,
                          resolution_y=72)
    td = build_device_scene(gltf.load(cornell_glb), max_leaf_size=14,
                            device="cpu")
    pipe = RenderPipeline(td, config)
    cam = _cornell_camera(config)
    scan, _ = pipe.render(cam, 1)
    tiled, _ = pipe.render(cam, 1, present_order=False)
    assert torch.equal(torch.from_numpy(pipe.to_present(tiled.numpy())),
                       scan)
