"""PyTorch port vs JAX: the coefficient leaf test (``VKPT_MT=mxu``).

- The bake, bitwise: ``tri_coefs`` against ``build_mt_coef_rows`` of
  the JAX package (float64 cross products rounded once): the port's
  zero-free (n_leaves, block, 20) rows hold JAX's 19 non-zero entries
  per triangle, and every other entry of JAX's rows is exactly zero,
  flat and two-level; ``inst_feat`` (I, 40) against the non-zero
  entries of ``instance_feature_maps`` (the rest exactly zero), also
  after ``update_instance_transforms`` moved (and mirrored) instances.
- The zero-free sums against the 40-term sums of JAX's full rows (the
  same features, every product added in feature order) on seeded rays
  and through the columns scene's traversals: t, tri and the hit masks
  bitwise, u and v up to the sign of a zero; the plain versions'
  counts of the test's exits add up to the triangles tested.
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


def _full_rows(tri_coefs, block):
    """JAX's (n_leaves, 10, >= 4 * block) rows as (n_leaves, block, 40):
    sum s, feature j at column 10 * s + j."""
    n = tri_coefs.shape[0]
    c = np.asarray(tri_coefs)[:, :, : 4 * block].reshape(n, 10, 4, block)
    return np.ascontiguousarray(c.transpose(0, 3, 2, 1)).reshape(n, block,
                                                                 40)


def test_coefficient_table_matches_jax(flat, instanced):
    """The zero-free rows are bitwise JAX's non-zero entries, in the order
    det, u', v', t', then a zero; every entry JAX has outside them is
    exactly zero (in JAX's bake and in the scene's table)."""
    for jd, td in (flat, instanced[:2]):
        block = td.max_leaf_size
        got = td.tri_coefs.numpy()
        assert got.shape == (jd.tri_blocks.shape[0], block, mxu_mt.COLS)
        for src in (jax_coef_rows(np.asarray(jd.tri_blocks), block),
                    jd.tri_coefs):
            full = _full_rows(src, block)
            assert np.array_equal(got[:, :, :19],
                                  full[:, :, mxu_mt.COEF_INDEX])
            assert not np.delete(full, mxu_mt.COEF_INDEX, axis=2).any()
            assert np.array_equal(got, mxu_mt.coef_rows_from_jax(
                np.asarray(src), block))
        assert not got[:, :, 19].any()
        assert got[:, :, :19].any(axis=(0, 1)).all()
    bad = np.zeros((1, 10, 4), np.float32)
    bad[0, 6, 0] = 1.0   # det on o: outside the 19
    with pytest.raises(ValueError, match="outside the 19"):
        mxu_mt.coef_rows_from_jax(bad, 1)


def test_padded_slots_have_zero_coefficients():
    """A padded (zero-edge) slot's row is all zero: det = 0, never a
    hit."""
    leaves = np.zeros((2, 3, 9), np.float32)
    leaves[0, 0] = [0, 0, 0, 1, 0, 0, 0, 1, 0]
    c = mxu_mt.build_mt_coef_rows(leaves)
    assert c[0, 0].any() and not c[0, 1:].any() and not c[1].any()


def _feature_entries(inst_feat):
    """(I, 10, 16) JAX transforms -> (their 40 entries of FEAT_TERMS,
    whether every other entry is exactly zero)."""
    flat = np.asarray(inst_feat).reshape(-1, 160)
    return (flat[:, mxu_mt.FEAT_INDEX],
            not np.delete(flat, mxu_mt.FEAT_INDEX, axis=1).any())


def test_instance_feature_maps_match_jax(instanced):
    """The compact transforms are bitwise the non-zero entries of JAX's
    (I, 10, 16) maps, and JAX's other entries are exactly zero."""
    jd, td, jd2, td2 = instanced
    assert td.inst_feat.shape == (td.inst_inv.shape[0], mxu_mt.FEAT_COLS)
    for ref in (jd.inst_feat, instance_feature_maps(td.inst_inv.numpy())):
        entries, rest_zero = _feature_entries(ref)
        assert rest_zero
        assert np.array_equal(td.inst_feat.numpy(), entries)
        assert np.array_equal(td.inst_feat.numpy(),
                              mxu_mt.feature_maps_from_jax(np.asarray(ref)))
    # After the update: the port's device-side maps against the JAX
    # function on the same rows, and JAX's own update.
    entries, rest_zero = _feature_entries(
        instance_feature_maps(td2.inst_inv.numpy()))
    assert rest_zero and np.array_equal(td2.inst_feat.numpy(), entries)
    entries, rest_zero = _feature_entries(jd2.inst_feat)
    assert rest_zero
    np.testing.assert_allclose(td2.inst_feat.numpy(), entries, rtol=1e-6,
                               atol=1e-6)
    assert float(td2.inst_inv[0, 12]) == -1.0


def _sums40(coefs, feats, det_sign=None):
    """The 40-term sums of the JAX package's full rows: each zero-free
    row expanded to (4, 10) with its zeros, every product added in
    feature order 0..9."""
    m, block = coefs.shape[:2]
    full = torch.zeros((m, block, 40), dtype=torch.float32)
    full[..., mxu_mt.COEF_INDEX] = coefs[..., :19]
    full = full.reshape(m, block, 4, 10)
    acc = full[..., 0] * feats[:, None, None, 0]
    for j in range(1, 10):
        acc = acc + full[..., j] * feats[:, None, None, j]
    if det_sign is not None:
        acc = acc * det_sign[:, None, None]
    return acc[..., 0], acc[..., 1], acc[..., 2], acc[..., 3]


def _object_features40(inst_feat, feats):
    """A @ feats over all of A's (10, 10) features in order, A expanded
    from its 40 entries with its zeros."""
    full = torch.zeros((inst_feat.shape[0], 160), dtype=torch.float32)
    full[:, mxu_mt.FEAT_INDEX] = inst_feat
    full = full.reshape(-1, 10, 16)
    acc = full[..., 0] * feats[:, None, 0]
    for j in range(1, 10):
        acc = acc + full[..., j] * feats[:, None, j]
    return acc


def _same_up_to_zero_sign(a, b):
    """Bitwise equal, but where both are zeros of either sign."""
    return torch.equal(a == 0, b == 0) and torch.equal(
        torch.where(a == 0, 0.0, a), torch.where(b == 0, 0.0, b))


def test_zero_free_sums_match_40_term_sums(flat, instanced):
    """On seeded random rays against every leaf block of the columns
    scene (flat, and two-level with a mirrored instance's det_sign and
    the feature transform): the closest-hit test's mask and t bitwise
    the 40-term sums', u and v up to the sign of a zero; the any-hit
    bit bitwise."""
    cases = (("flat", flat[1], None), ("two-level", instanced[3], True))
    for name, td, two_level in cases:
        n_leaves = td.tri_coefs.shape[0]
        g = np.random.default_rng(17)
        o, d = map(torch.from_numpy, _rays(16384, seed=11))
        rows = torch.from_numpy(g.integers(0, n_leaves, 16384))
        feats = mxu_mt.ray_features(o, d)
        det_sign = None
        feats40 = feats
        if two_level:
            inst = torch.from_numpy(g.integers(0, td.inst_inv.shape[0],
                                               16384))
            feats40 = _object_features40(td.inst_feat[inst], feats)
            feats = mxu_mt.object_features(td.inst_feat[inst], feats)
            assert _same_up_to_zero_sign(feats, feats40), name
            det_sign = td.inst_inv[inst, 12]
        coefs = td.tri_coefs[rows]
        zf = mxu_mt.coef_sums(coefs, feats, det_sign)
        full = _sums40(coefs, feats40, det_sign)
        for a, b in zip(zf, full):
            assert _same_up_to_zero_sign(a, b), name
        t_lane = torch.full((16384,), 1e30)
        ok, t, u, v = mxu_mt.coef_leaf_mt(coefs, feats, det_sign)
        acc = ok.any(dim=1)
        assert 100 < int(acc.sum()) < 16384, name
        ref_any = mxu_mt.coef_leaf_any(coefs, feats, t_lane, det_sign)
        orig = mxu_mt.coef_sums
        mxu_mt.coef_sums = lambda c, f, s=None: _sums40(c, feats40, s)
        try:
            ok4, t4, u4, v4 = mxu_mt.coef_leaf_mt(coefs, feats, det_sign)
            any4 = mxu_mt.coef_leaf_any(coefs, feats, t_lane, det_sign)
        finally:
            mxu_mt.coef_sums = orig
        assert torch.equal(ok, ok4) and torch.equal(ref_any, any4), name
        assert torch.equal(t[ok], t4[ok4]), name
        assert _same_up_to_zero_sign(u[ok], u4[ok4]), name
        assert _same_up_to_zero_sign(v[ok], v4[ok4]), name


@pytest.mark.parametrize("kind", ["quad", "pair", "pair_two_level"])
def test_zero_free_traversal_matches_40_term_sums(flat, instanced,
                                                  monkeypatch, kind):
    """The columns scene's coefficient traversals (closest and any hit)
    with the zero-free sums against the same walks with the 40-term
    sums and the full feature transform: t, tri, the hit masks and the
    any-hit bit bitwise, u and v up to the sign of a zero."""
    td = instanced[3] if kind == "pair_two_level" else flat[1]
    o, d = map(torch.from_numpy, _rays(1200, seed=21))
    fam = kind.split("_")[0]
    args = getattr(st, f"{fam}_args")(td, o, d, None, True)
    closest = getattr(st, f"{fam}_closest_hit_plain")
    any_hit = getattr(st, f"{fam}_any_hit_plain")
    ref, ref_any = closest(*args), any_hit(*args)
    assert int((ref.t < MISS_T).sum()) > 100
    monkeypatch.setattr(mxu_mt, "object_features", _object_features40)
    monkeypatch.setattr(mxu_mt, "coef_sums", _sums40)
    got, got_any = closest(*args), any_hit(*args)
    assert torch.equal(got.t, ref.t) and torch.equal(got.tri, ref.tri)
    assert torch.equal(got_any, ref_any)
    assert _same_up_to_zero_sign(got.u, ref.u)
    assert _same_up_to_zero_sign(got.v, ref.v)


@pytest.mark.parametrize("kind", ["quad", "pair", "pair_two_level"])
def test_plain_exit_counts_add_up(flat, instanced, kind):
    """The plain versions' counts of the coefficient test's exits: every
    triangle tested exits once at most (det, u', v' window), the closest
    hit tests every triangle of every leaf visit and the any hit stops
    at its first accepted one; each hit passed all three tests once at
    least; two-level instance changes no more than leaf visits; the
    outputs as without statistics."""
    td = instanced[3] if kind == "pair_two_level" else flat[1]
    o, d = map(torch.from_numpy, _rays(900, seed=23))
    fam = kind.split("_")[0]
    args = getattr(st, f"{fam}_args")(td, o, d, None, True)
    block = td.max_leaf_size
    for which in ("closest", "any"):
        plain = getattr(st, f"{fam}_{which}_hit_plain")
        stats = {}
        out = plain(*args, stats=stats)
        ref = plain(*args)
        exits = stats["tri_back"] + stats["tri_u"] + stats["tri_v"]
        assert min(stats["tri_back"], stats["tri_u"], stats["tri_v"]) > 0
        if which == "closest":
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
            assert stats["tri_tested"] == stats["leaf_visits"] * block
            assert stats["tri_tested"] - exits >= int((ref.t < MISS_T).sum())
        else:
            assert torch.equal(out, ref)
            assert stats["tri_tested"] < stats["leaf_visits"] * block
            assert stats["tri_tested"] - exits >= int(ref.sum()) > 0
        if kind == "pair_two_level":
            assert 0 < stats["instance_changes"] <= stats["leaf_visits"]


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
