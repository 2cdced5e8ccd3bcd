"""PyTorch port vs JAX: the coefficient leaf test (``VKPT_MT=mxu``).

- The bake, bitwise: ``tri_coefs`` against ``build_mt_coef_rows`` of
  the JAX package (float64 cross products rounded once, in the port's
  (n_leaves, block, 40) layout), flat and two-level; ``inst_feat``
  against ``instance_feature_maps``, also after
  ``update_instance_transforms`` moved (and mirrored) instances.
- The plain versions with coefficient leaves against the Pallas
  kernels under ``VKPT_MT=mxu`` (set only around the JAX calls), in
  interpret mode: quad closest and any hit, pair flat, pair two-level
  (with a mirrored instance).  RELAXED parity: the coefficient
  arithmetic rounds otherwise than the exact kernels, so hits within
  about an ulp of an edge or of the t window may flip — the budget of
  tests/test_mxu_mt.py:100-117 (at most 0.2% of rays flip hit/miss or
  triangle; t within 2e-4, u and v within 5e-3 where the triangle
  agrees).
- The any-hit bit against the port's own coefficient closest hit,
  within the same budget (the any hit compares det-scaled, the closest
  hit divided).
- 64x48 frames with coefficient leaves (the default tier flat, the
  frontier kernels, two-level) against the JAX pipeline under
  ``VKPT_MT=mxu``: equal ray counts up to the budget, and a bounded
  share of differing pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene as jax_inst,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    update_instance_transforms as jax_update,
)
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu.ops.mxu_mt import (
    build_mt_coef_rows as jax_coef_rows,
)
from vulkan_pathtracer_tpu.ops.mxu_mt import (
    ensure_mt_coefs,
    instance_feature_maps,
)
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu_torch.ops import mxu_mt
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

BUDGET = 0.002   # tests/test_mxu_mt.py:100-117


def assert_relaxed_parity(ref, got, budget=BUDGET):
    """tests/test_mxu_mt.py's _assert_relaxed_parity: a JAX Hit against
    a port Hit."""
    ref_t, got_t = np.asarray(ref.t), got.t.numpy()
    flips = (ref_t < MISS_T) != (got_t < MISS_T)
    assert flips.mean() <= budget, flips.mean()
    both = (ref_t < MISS_T) & (got_t < MISS_T)
    assert both.sum() > 100
    np.testing.assert_allclose(got_t[both], ref_t[both], rtol=2e-4,
                               atol=2e-4)
    same = np.asarray(ref.tri)[both] == got.tri.numpy()[both]
    assert (~same).mean() <= budget
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[both][same],
                                   np.asarray(b)[both][same], rtol=5e-3,
                                   atol=5e-3)


def _rays(n, seed, lo=-10.0, hi=10.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(lo / 5, hi / 5, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


@pytest.fixture(scope="module")
def flat(columns_glb):
    jd = jax_build(jgltf.load(columns_glb), build_bvh=True, max_leaf_size=14)
    ensure_mt_coefs(jd)
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                            device="cpu", mt="mxu")
    return jd, td


def _mirrored(host):
    """The columns' instance transforms with instance 0 mirrored in x and
    instance 1 moved."""
    xf = np.stack([inst.transform for inst in host.instances]).astype(
        np.float32)
    xf[0, :3, 0] *= -1.0
    xf[1, :3, 3] += np.float32(0.25)
    return xf


@pytest.fixture(scope="module")
def instanced(columns_glb):
    """(JAX, port) two-level bakes at leaf 8 with coefficient leaves,
    both moved by _mirrored."""
    jd = ensure_mt_coefs(jax_inst(jgltf.load(columns_glb), max_leaf_size=8))
    host = gltf.load(columns_glb)
    td = build_instanced_scene(host, max_leaf_size=8, device="cpu", mt="mxu")
    xf = _mirrored(host)
    return (jd, td, jax_update(jd, jnp.asarray(xf)),
            update_instance_transforms(td, xf))


def test_coefficient_table_matches_jax(flat, instanced):
    for jd, td in (flat, instanced[:2]):
        block = td.max_leaf_size
        ref = jax_coef_rows(np.asarray(jd.tri_blocks), block)
        assert td.tri_coefs.shape == (ref.shape[0], block, mxu_mt.COLS)
        assert np.array_equal(td.tri_coefs.numpy(),
                              mxu_mt.coef_rows_from_jax(ref, block))
        assert np.array_equal(td.tri_coefs.numpy(),
                              mxu_mt.coef_rows_from_jax(
                                  np.asarray(jd.tri_coefs), block))


def test_padded_slots_have_zero_coefficients():
    leaves = np.zeros((2, 3, 9), np.float32)
    leaves[0, 0] = [0, 0, 0, 1, 0, 0, 0, 1, 0]
    c = mxu_mt.build_mt_coef_rows(leaves)
    assert c[0, 0].any() and not c[0, 1:].any() and not c[1].any()


def test_instance_feature_maps_match_jax(instanced):
    jd, td, jd2, td2 = instanced
    assert np.array_equal(td.inst_feat.numpy(), np.asarray(jd.inst_feat))
    assert np.array_equal(td.inst_feat.numpy(),
                          instance_feature_maps(td.inst_inv.numpy()))
    # After the update: the port's device-side maps against the JAX
    # function on the same rows, and JAX's own update.
    assert np.array_equal(td2.inst_feat.numpy(),
                          instance_feature_maps(td2.inst_inv.numpy()))
    np.testing.assert_allclose(td2.inst_feat.numpy(),
                               np.asarray(jd2.inst_feat), rtol=1e-6,
                               atol=1e-6)
    assert float(td2.inst_inv[0, 12]) == -1.0


def test_feature_transform_is_the_object_space_ray(instanced):
    """A @ features(o, d) equals features(W o + w, W d) to f32 rounding,
    so the object-space coefficient table sees the object-space ray."""
    _, _, _, td = instanced
    o, d = map(torch.from_numpy, _rays(64, seed=5))
    inst = torch.arange(64) % td.inst_inv.shape[0]
    feats = mxu_mt.object_features(td.inst_feat[inst],
                                   mxu_mt.ray_features(o, d))
    m = td.inst_inv[inst].double()
    W = m[:, 0:9].reshape(-1, 3, 3)
    oo = (W @ o.double()[:, :, None])[:, :, 0] + m[:, 9:12]
    dd = (W @ d.double()[:, :, None])[:, :, 0]
    ref = mxu_mt.ray_features(oo, dd)
    np.testing.assert_allclose(feats.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_quad_matches_pallas_mxu(flat, monkeypatch):
    jd, td = flat
    o, d = _rays(1500, seed=3)
    monkeypatch.setenv("VKPT_MT", "mxu")
    ref = pp.pallas_quad_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     interpret=True, packet=512)
    ref_any = pp.pallas_quad_any_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     interpret=True, packet=512)
    monkeypatch.delenv("VKPT_MT")
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = st.quad_closest_hit(td, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    occ = st.quad_any_hit(td, o_t, d_t, coef=True)
    assert (occ.numpy() != np.asarray(ref_any)).mean() <= BUDGET
    assert (occ != (got.t < MISS_T)).float().mean() <= BUDGET
    # Against the port's own exact kernel, the same budget.
    exact = st.quad_closest_hit(td, o_t, d_t)
    assert ((exact.t < MISS_T) != (got.t < MISS_T)).float().mean() <= BUDGET


def test_pair_flat_matches_pallas_mxu(flat, monkeypatch):
    jd, td = flat
    o, d = _rays(1500, seed=4)
    active = np.random.default_rng(8).random(1500) < 0.8
    monkeypatch.setenv("VKPT_MT", "mxu")
    ref = pp.pallas_pair_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(active), interpret=True,
                                     packet=512)
    monkeypatch.delenv("VKPT_MT")
    act = torch.from_numpy(active)
    got = st.pair_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d),
                              act, coef=True)
    assert_relaxed_parity(ref, got)
    assert (got.t[~act] == MISS_T).all() and (got.tri[~act] == -1).all()


def test_pair_two_level_matches_pallas_mxu(instanced, monkeypatch):
    """Two-level coefficient leaves on the moved scene (instance 0
    mirrored: its det_sign culls by the world winding)."""
    _, _, jd2, td2 = instanced
    o, d = _rays(1500, seed=6)
    monkeypatch.setenv("VKPT_MT", "mxu")
    ref = pp.pallas_pair_closest_hit(jd2, jnp.asarray(o), jnp.asarray(d),
                                     interpret=True, packet=512)
    ref_any = pp.pallas_pair_any_hit(jd2, jnp.asarray(o), jnp.asarray(d),
                                     interpret=True, packet=512)
    monkeypatch.delenv("VKPT_MT")
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = st.pair_closest_hit(td2, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    occ = st.pair_any_hit(td2, o_t, d_t, coef=True)
    assert (occ.numpy() != np.asarray(ref_any)).mean() <= BUDGET
    exact = st.pair_closest_hit(td2, o_t, d_t)
    assert ((exact.t < MISS_T) != (got.t < MISS_T)).float().mean() <= BUDGET
    inst0 = (got.tri >= 0) & ((got.tri // td2.max_leaf_size)
                              >> td2.mb_bits == 0)
    assert inst0.sum() > 0   # rays do reach the mirrored instance


def _assert_close_frames(ref, ref_rays, got, rays):
    """Coefficient frames: ray counts within the budget, at most 1% of
    pixels off 1e-5 (a flipped hit changes its pixel's whole path)."""
    assert abs(rays - ref_rays) <= BUDGET * 64 * 48
    off = np.abs(got - ref).max(axis=-1) > 1e-5 + 1e-5 * np.abs(ref).max(
        axis=-1)
    assert off.mean() <= 0.01, off.mean()


@pytest.mark.parametrize("leaf,tiers", [
    (14, {"mt": "mxu"}),
    (4, {"mt": "mxu", "kernel_primary": "frontier",
         "kernel_secondary": "frontier", "anyhit_kernel": "frontier"})])
def test_coefficient_frame_matches_jax(columns_glb, monkeypatch, leaf,
                                       tiers):
    from tests.test_torch_tiers import frame_pair

    _assert_close_frames(*frame_pair(columns_glb, leaf, tiers, monkeypatch))


def test_two_level_coefficient_frame_matches_jax(columns_glb, monkeypatch):
    import jax

    from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
    from vulkan_pathtracer_tpu.render.pipeline import (
        RenderPipeline as JaxPipeline,
    )
    from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    kw = dict(num_samples=1, num_bounces=2, resolution_x=64,
              resolution_y=48)
    cam = JaxCamera(aspect_ratio=64 / 48,
                    position=np.asarray([0.0, 3.0, -9.0], np.float32))
    jax.clear_caches()   # JAX reads VKPT_MT while it traces
    with monkeypatch.context() as m:
        m.setenv("VKPT_MT", "mxu")
        jd = jax_inst(jgltf.load(columns_glb), max_leaf_size=14)
        assert jd.inst_feat is not None
        ref, ref_rays = JaxPipeline(jd, JaxConfig(traversal="pallas", **kw)) \
            .render_numpy(cam, 2)
    td = build_instanced_scene(gltf.load(columns_glb), max_leaf_size=14,
                               device="cpu", mt="mxu")
    got, rays = RenderPipeline(td, RenderConfig(mt="mxu", **kw)) \
        .render_numpy(cam, 2)
    assert np.isfinite(got).all()
    _assert_close_frames(ref, ref_rays, got, rays)
