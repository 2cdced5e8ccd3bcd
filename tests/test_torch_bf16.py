"""PyTorch port vs JAX: the frontier guard band.

- Under each setting of ``VKPT_FRONTIER_PRECISION`` and
  ``VKPT_FRONTIER_GUARD``, the port's frontier boxes, baked at the
  guard the CLI reads (app/main.tier_fields_from_env), are bitwise the
  JAX bake's tiles under the same variables (``tables_from_jax``), and
  after a refit of moved triangles bitwise JAX's host
  ``build_frontier_rows`` of the refitted tree under those variables:
  the scene keeps the guard it was baked with.
- The frontier plain versions on a 2^-12 bake against the 2^-7 bake of
  the same tree: the node test is f32, so a band only adds visits; the
  closest t and the any-hit bit are equal, and a triangle differs only
  at a tie of equal t.

PyTorch port vs JAX: the one-pass bf16 product of the coefficient
leaves (``VKPT_MXU_PRECISION=default``, mxu_mt.py:58-80).

JAX's DEFAULT precision cannot be compared directly on the CPU: XLA's
CPU dot ignores ``Precision.DEFAULT`` and sums in f32, so a JAX run at
DEFAULT equals one at HIGHEST.  The one bf16 pass of the TPU's MXU is
emulated instead: both operands rounded to bf16 (round to nearest
even), then the product at HIGHEST, whose bf16 x bf16 products are
exact in f32.  That is the one-pass semantics up to the order of the
f32 sums.

- The tables: a bf16 bake is bitwise the f32 rows (``coef_rows``, JAX's
  ``build_mt_coef_rows`` converted) rounded once, flat and two-level
  (the feature transforms stay f32); the refit and the device rebuild
  keep the dtype and are bitwise a fresh bf16 bake of the moved leaves.
- Per visit: the plain versions' bf16 leaf test against JAX's
  ``mt_coef_visit`` / ``mt_coef_visit_anyhit`` on the rounded operands,
  flat and two-level (a mirrored instance among them): hit and
  triangle within the relaxed budget of 0.2%, t allclose 1e-5; and the
  bf16 sums differ from the f32 sums on most triangles.
- Whole kernels: the port's quad, pair (flat and two-level) and
  frontier closest and any hits on a bf16 bake against the Pallas
  kernels in interpret mode under ``VKPT_MT=mxu`` and
  ``VKPT_MXU_PRECISION=default``, with JAX's ``mt_coef_visit`` and
  ``mt_coef_visit_anyhit`` wrapped in this test process to round their
  operands at DEFAULT (the kernels look them up while they trace);
  and a 64x48 coefficient frame within the budget of
  tests/test_torch_mxu.py::test_coefficient_frame_matches_jax.
"""

import dataclasses

import jax
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
from vulkan_pathtracer_tpu.ops import mxu_mt as jmxu
from vulkan_pathtracer_tpu.ops import pallas_frontier as pf
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops.mxu_mt import ensure_mt_coefs
from vulkan_pathtracer_tpu_torch.app.main import tier_fields_from_env
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    bvh_with_leaf_blocks,
)
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import mxu_mt
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.device_build import (
    device_rebuild_scene,
)
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T, TMIN
from vulkan_pathtracer_tpu_torch.ops.refit import refit_boxes, refit_scene

from tests.test_torch_mxu import (
    BUDGET,
    _assert_close_frames,
    _mirrored,
    _rays,
    assert_relaxed_parity,
)

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

LEAF = 4
GUARD_ENVS = [
    {},
    {"VKPT_FRONTIER_PRECISION": "high"},
    {"VKPT_FRONTIER_PRECISION": "highest"},
    {"VKPT_FRONTIER_PRECISION": "default", "VKPT_FRONTIER_GUARD": "0.001"},
    {"VKPT_FRONTIER_PRECISION": "highest", "VKPT_FRONTIER_GUARD": "0"}]


def _frontier_env(monkeypatch, env):
    for k in ("VKPT_FRONTIER_PRECISION", "VKPT_FRONTIER_GUARD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", GUARD_ENVS,
                         ids=lambda e: "-".join(e.values()) or "unset")
def test_frontier_boxes_match_jax_under_guard(columns_glb, monkeypatch,
                                              env):
    _frontier_env(monkeypatch, env)
    guard = tier_fields_from_env()["frontier_guard"]
    jd = jax_build(jgltf.load(columns_glb), build_bvh=True,
                   max_leaf_size=LEAF)
    host = gltf.load(columns_glb)
    td = build_device_scene(host, max_leaf_size=LEAF, device="cpu",
                            frontier_guard=guard)
    assert td.frontier_guard == guard
    box, link = fr.tables_from_jax(np.asarray(jd.bvh_frontier), 16)
    assert np.array_equal(td.frontier_box.numpy(), box)
    assert np.array_equal(td.frontier_link.numpy(), link)
    # After a refit of moved triangles: JAX's host bake of the refitted
    # tree under the same variables, bitwise.
    n = td.num_triangles
    shift = torch.zeros_like(td.tri_v0)
    shift[:n, 1] = torch.linspace(0.0, 0.75, n)
    moved = dataclasses.replace(td, tri_v0=td.tri_v0 + shift)
    r = refit_scene(moved)
    assert r.frontier_guard == guard
    bvh, _ = bvh_with_leaf_blocks(*(getattr(td, k)[:n].numpy() for k in (
        "tri_v0", "tri_e1", "tri_e2")), LEAF)
    bmin, bmax = refit_boxes(moved)
    bvh.bmin, bvh.bmax = bmin.numpy(), bmax.numpy()
    want, _ = fr.tables_from_jax(pf.build_frontier_rows(bvh, LEAF,
                                                        width=16), 16)
    assert np.array_equal(r.frontier_box.numpy(), want)
    assert not np.array_equal(r.frontier_box.numpy(), box)


def test_tight_guard_hits_equal_up_to_ties(columns_glb):
    """The frontier plain versions on a 2^-12 bake against the 2^-7 bake
    of the same tree (links equal, every box inside the wider one): t
    and the any-hit bit bitwise, the triangle otherwise only where the
    other one lies at the same t."""
    host = gltf.load(columns_glb)
    wide, tight = (build_device_scene(host, max_leaf_size=LEAF, device="cpu",
                                      frontier_guard=g)
                   for g in (2.0 ** -7, 2.0 ** -12))
    assert torch.equal(wide.frontier_link, tight.frontier_link)
    live = wide.frontier_link != fr.EMPTY
    assert (tight.frontier_box[..., :3][live]
            > wide.frontier_box[..., :3][live]).any()
    o, d = map(torch.from_numpy, _rays(3000, seed=31))
    a = fr.frontier_closest_hit(wide, o, d)
    b = fr.frontier_closest_hit(tight, o, d)
    assert int((a.t < MISS_T).sum()) > 500
    assert torch.equal(a.t, b.t)
    ties = a.tri != b.tri
    assert ties.float().mean() <= 0.001
    assert torch.equal(fr.frontier_any_hit(wide, o, d),
                       fr.frontier_any_hit(tight, o, d))
    # Fewer node visits in the tighter band.
    sw, stt = {}, {}
    fr.frontier_closest_hit_plain(*fr.frontier_args(wide, o, d, None),
                                  stats=sw)
    fr.frontier_closest_hit_plain(*fr.frontier_args(tight, o, d, None),
                                  stats=stt)
    assert stt["node_visits"] <= sw["node_visits"]
    assert stt["leaf_visits"] < sw["leaf_visits"]


# -- the one-pass bf16 product ----------------------------------------------

HIGHEST = jax.lax.Precision.HIGHEST


def _bits(x):
    return x.contiguous().view(torch.int16)


def _rounded(x):
    """JAX's operand of the one bf16 pass (round to nearest even)."""
    return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture(scope="module")
def bf16_flat(columns_glb):
    """(JAX bake with coefficient rows, the port's bf16 bake, its f32
    bake) of the columns at leaf 14."""
    jd = ensure_mt_coefs(jax_build(jgltf.load(columns_glb), build_bvh=True,
                                   max_leaf_size=14))
    host = gltf.load(columns_glb)
    tb = build_device_scene(host, max_leaf_size=14, device="cpu", mt="mxu",
                            mxu_precision="default")
    tf = build_device_scene(host, max_leaf_size=14, device="cpu", mt="mxu")
    return jd, tb, tf


@pytest.fixture(scope="module")
def bf16_instanced(columns_glb):
    """(JAX, port bf16) two-level bakes at leaf 8 with coefficient leaves,
    both moved by test_torch_mxu._mirrored (instance 0 mirrored)."""
    jd = ensure_mt_coefs(jax_inst(jgltf.load(columns_glb), max_leaf_size=8))
    host = gltf.load(columns_glb)
    td = build_instanced_scene(host, max_leaf_size=8, device="cpu", mt="mxu",
                               mxu_precision="default")
    xf = _mirrored(host)
    return jax_update(jd, jnp.asarray(xf)), update_instance_transforms(td, xf)


def test_bf16_tables_are_the_rounded_rows(bf16_flat, bf16_instanced,
                                          columns_glb):
    """A bf16 bake is the f32 rows rounded once (round to nearest even),
    bitwise: the port's own f32 bake, its device twin ``coef_rows`` and
    JAX's rows converted; two-level the same, with f32 feature
    transforms; the bake in the dtype the config names, and a
    RenderPipeline refuses a config that names the other one."""
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    jd, tb, tf = bf16_flat
    assert tb.tri_coefs.dtype == torch.bfloat16
    assert tb.tri_coefs.shape == tf.tri_coefs.shape
    want = tf.tri_coefs.to(torch.bfloat16)
    assert torch.equal(_bits(tb.tri_coefs), _bits(want))
    assert torch.equal(_bits(tb.tri_coefs), _bits(mxu_mt.coef_table(
        mxu_mt.coef_rows(tb.leaves), "default")))
    conv = torch.from_numpy(mxu_mt.coef_rows_from_jax(np.asarray(
        jd.tri_coefs), 14))
    assert torch.equal(_bits(tb.tri_coefs), _bits(conv.to(torch.bfloat16)))
    assert mxu_mt.table_precision(tb.tri_coefs) == "default"
    assert mxu_mt.table_precision(tf.tri_coefs) == "highest"
    # Rounding changes most non-zero coefficients.
    nz = tf.tri_coefs != 0
    assert (tb.tri_coefs.float() != tf.tri_coefs)[nz].float().mean() > 0.5
    _, ti = bf16_instanced
    ref = build_instanced_scene(gltf.load(columns_glb), max_leaf_size=8,
                                device="cpu", mt="mxu")
    assert ti.tri_coefs.dtype == torch.bfloat16
    assert ti.inst_feat.dtype == torch.float32
    assert torch.equal(_bits(ti.tri_coefs),
                       _bits(ref.tri_coefs.to(torch.bfloat16)))
    RenderPipeline(tb, RenderConfig(mt="mxu", mxu_precision="default"))
    with pytest.raises(ValueError, match="mxu_precision"):
        RenderPipeline(tb, RenderConfig(mt="mxu"))
    with pytest.raises(ValueError, match="highest | default"):
        RenderPipeline(tf, RenderConfig(mt="mxu", mxu_precision="bf16"))


def test_bf16_refit_and_rebuild_keep_the_dtype(bf16_flat):
    """The refit of moved triangles and the device rebuild regenerate
    the table in the dtype the scene holds, bitwise a fresh bf16 bake of
    the moved leaves; an f32 scene stays f32."""
    _, tb, tf = bf16_flat
    n = tb.num_triangles
    shift = torch.zeros_like(tb.tri_v0)
    shift[:n, 0] = torch.linspace(0.0, 0.5, n)
    for scene, dtype in ((tb, torch.bfloat16), (tf, torch.float32)):
        r = refit_scene(dataclasses.replace(scene,
                                            tri_v0=scene.tri_v0 + shift))
        assert r.tri_coefs.dtype == dtype
        fresh = mxu_mt.coef_table(mxu_mt.coef_rows(r.leaves),
                                  mxu_mt.table_precision(scene.tri_coefs))
        assert torch.equal(r.tri_coefs.view(torch.uint8),
                           fresh.view(torch.uint8))
        assert not torch.equal(r.tri_coefs, scene.tri_coefs)
    t = tb.num_triangles
    rebuilt = device_rebuild_scene(tb, tb.tri_v0[:t] + shift[:t],
                                   tb.tri_e1[:t], tb.tri_e2[:t],
                                   tb.tri_gn[:t], tb.tri_attr[:t])
    assert rebuilt.tri_coefs.dtype == torch.bfloat16
    assert torch.equal(_bits(rebuilt.tri_coefs), _bits(mxu_mt.coef_table(
        mxu_mt.coef_rows(rebuilt.leaves), "default")))
    as_f32 = device_rebuild_scene(tb, tb.tri_v0[:t], tb.tri_e1[:t],
                                  tb.tri_e2[:t], tb.tri_gn[:t],
                                  tb.tri_attr[:t], mxu_precision="highest")
    assert as_f32.tri_coefs.dtype == torch.float32


def _aimed_rays(leaves, rows, per_row, rng):
    """Object-space rays aimed at the triangles of each leaf block row
    (barycentric targets a little beyond the edges, so some miss),
    ``per_row`` per row: (o, d) (len(rows) * per_row, 3) f32."""
    o_all, d_all = [], []
    for row in rows:
        tri = leaves[row]
        live = np.nonzero(np.abs(tri[:, 3:9]).sum(axis=1) > 0)[0]
        k = rng.choice(live, per_row)
        u = rng.uniform(-0.1, 1.0, per_row)
        v = rng.uniform(-0.1, 1.1, per_row) * (1.0 - np.clip(u, 0, 1))
        p = tri[k, 0:3] + u[:, None] * tri[k, 3:6] + v[:, None] * tri[k, 6:9]
        d = rng.normal(size=(per_row, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o_all.append(p - rng.uniform(0.3, 4.0, (per_row, 1)) * d)
        d_all.append(d)
    return (np.concatenate(o_all).astype(np.float32),
            np.concatenate(d_all).astype(np.float32))


def _port_best(ok, t, tri_base):
    """The closest candidate of a leaf visit as the kernels pick it: the
    smallest t, the first triangle on a tie."""
    tc = torch.where(ok, t, torch.full_like(t, 3e38))
    k = torch.argmin(tc, dim=1)
    tb = tc.gather(1, k[:, None])[:, 0]
    return tb, tri_base + k


@pytest.mark.parametrize("two_level", [False, True],
                         ids=["flat", "two-level"])
def test_bf16_visit_matches_jax_functions(bf16_flat, bf16_instanced,
                                          two_level):
    """Per leaf visit: the plain versions' bf16 test against JAX's
    mt_coef_visit and mt_coef_visit_anyhit at HIGHEST on operands
    rounded through jnp.bfloat16 (the one pass up to the order of the
    f32 sums), on rays aimed at each visited block; two-level in the
    instance's object space (the features made at HIGHEST, then
    rounded; det_sign after the sums), a mirrored instance among them.
    The bf16 sums differ from the f32 ones on most triangles."""
    rng = np.random.default_rng(29 + two_level)
    if two_level:
        jd, td = bf16_instanced
        visits = [(int(i), int(r)) for i, r in zip(
            [0, 0, 1, 2] + list(rng.integers(0, td.inst_inv.shape[0], 20)),
            rng.integers(0, td.tri_coefs.shape[0], 24))]
    else:
        jd, td, _ = bf16_flat
        visits = [(None, int(r)) for r in rng.choice(
            td.tri_coefs.shape[0], 24, replace=False)]
    block = td.max_leaf_size
    per = 128
    leaves = td.leaves.numpy()
    f32_table = td.tri_coefs.float()
    flips = tri_diff = both = total = sums_differ = 0
    any_diff = 0
    for inst, row in visits:
        o, d = _aimed_rays(leaves, [row], per, rng)
        det_sign = None
        if inst is not None:   # the object-space rays as world rays
            m = td.inst_inv[inst].double().numpy()
            Winv = np.linalg.inv(m[0:9].reshape(3, 3))
            o = ((o - m[9:12]) @ Winv.T).astype(np.float32)
            d = (d @ Winv.T).astype(np.float32)
        o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
        feats = mxu_mt.ray_features(o_t, d_t)
        jfeats = jnp.asarray(feats.numpy().T)
        if inst is not None:
            A = jnp.asarray(np.asarray(jd.inst_feat)[inst])
            jfeats = jnp.dot(A, jmxu.pad_features16(jfeats),
                             precision=HIGHEST)
            feats = mxu_mt.object_features(
                td.inst_feat[inst].expand(per, -1), feats)
            det_sign = td.inst_inv[inst, 12].expand(per)
        coef = td.tri_coefs[row].expand(per, -1, -1)
        ok, t, _, _ = mxu_mt.coef_leaf_mt(coef, feats, det_sign)
        t_port, tri_port = _port_best(ok, t, row * block)
        occ_port = mxu_mt.coef_leaf_any(coef, feats,
                                        torch.full((per,), 1e30), det_sign)
        jcoef = _rounded(np.asarray(jd.tri_coefs)[row])
        jsign = None if inst is None else jnp.float32(
            np.asarray(jd.inst_inv)[inst, 12])
        lane = jnp.zeros((1, per), jnp.float32)
        tj, trij, _, _ = jmxu.mt_coef_visit(
            jcoef, _rounded(jfeats), lane, lane + 1e30, row * block, block,
            TMIN, HIGHEST, det_sign=jsign)
        occ_j = jmxu.mt_coef_visit_anyhit(
            jcoef, _rounded(jfeats), lane, lane + 1e30, block, TMIN, HIGHEST,
            det_sign=jsign)
        tj = np.asarray(tj)[0]
        trij = np.asarray(trij)[0]
        hit_j = tj < 1e30
        hit_p = t_port.numpy() < 1e30
        flips += int((hit_j != hit_p).sum())
        sel = hit_j & hit_p
        both += int(sel.sum())
        tri_diff += int((trij[sel] != tri_port.numpy()[sel]).sum())
        np.testing.assert_allclose(t_port.numpy()[sel], tj[sel], rtol=1e-5,
                                   atol=1e-5)
        any_diff += int(((np.asarray(occ_j)[0] > 0.5)
                         != occ_port.numpy()).sum())
        total += per
        bf = mxu_mt.coef_sums(coef, feats, det_sign)
        f32 = mxu_mt.coef_sums(f32_table[row].expand(per, -1, -1), feats,
                               det_sign)
        live = coef.float().abs().sum(dim=2) > 0
        differ = torch.zeros_like(live)
        for a, b in zip(bf, f32):
            differ |= a != b
        sums_differ += float((differ & live).sum()) / float(live.sum())
    assert both > total // 3
    assert flips <= BUDGET * total and any_diff <= BUDGET * total
    assert tri_diff <= BUDGET * both
    assert sums_differ / len(visits) > 0.9


@pytest.fixture
def jax_default(monkeypatch):
    """VKPT_MT=mxu and VKPT_MXU_PRECISION=default for the JAX calls, with
    its coefficient visits rounding their operands to bf16 at DEFAULT
    (XLA's CPU dot would ignore it) and then running at HIGHEST; JAX's
    caches cleared around them (it reads the variables and looks the
    functions up while it traces).  Yields a callable that checks that
    the kernels traced the rounding visit and undoes the variables
    before the port runs."""
    visit, visit_any = jmxu.mt_coef_visit, jmxu.mt_coef_visit_anyhit
    default = jax.lax.Precision.DEFAULT
    rounded = []   # the traced visits that took the one-pass operands

    def rounded_visit(coef, feats, tnear_f, tlim_f, tri_base, block, tmin,
                      precision, det_sign=None):
        if precision == default:
            rounded.append("closest")
            coef, feats, precision = _rounded(coef), _rounded(feats), HIGHEST
        return visit(coef, feats, tnear_f, tlim_f, tri_base, block, tmin,
                     precision, det_sign=det_sign)

    def rounded_any(coef, feats, tnear_f, tl_f, block, tmin, precision,
                    det_sign=None):
        if precision == default:
            rounded.append("any")
            coef, feats, precision = _rounded(coef), _rounded(feats), HIGHEST
        return visit_any(coef, feats, tnear_f, tl_f, block, tmin, precision,
                         det_sign=det_sign)

    monkeypatch.setattr(jmxu, "mt_coef_visit", rounded_visit)
    monkeypatch.setattr(jmxu, "mt_coef_visit_anyhit", rounded_any)
    monkeypatch.setenv("VKPT_MT", "mxu")
    monkeypatch.setenv("VKPT_MXU_PRECISION", "default")
    jax.clear_caches()

    def done():
        assert "closest" in rounded   # the kernels traced the wrapper
        monkeypatch.delenv("VKPT_MT")
        monkeypatch.delenv("VKPT_MXU_PRECISION")
        jax.clear_caches()
    yield done
    jax.clear_caches()


def _check_any(ref_any, occ, closest):
    assert (occ.numpy() != np.asarray(ref_any)).mean() <= BUDGET
    assert (occ != (closest.t < MISS_T)).float().mean() <= BUDGET


@pytest.mark.filterwarnings("ignore:VKPT_MXU_PRECISION=default")
def test_bf16_quad_and_pair_match_pallas_default(bf16_flat, jax_default):
    """The quad kernels and the flat pair closest hit on the bf16 bake
    against the Pallas kernels at (emulated) DEFAULT, interpret mode."""
    jd, tb, _ = bf16_flat
    o, d = _aimed(tb, 1500, seed=3)
    jo, jdir = jnp.asarray(o), jnp.asarray(d)
    ref = pp.pallas_quad_closest_hit(jd, jo, jdir, interpret=True,
                                     packet=512)
    ref_any = pp.pallas_quad_any_hit(jd, jo, jdir, interpret=True,
                                     packet=512)
    ref_pair = pp.pallas_pair_closest_hit(jd, jo, jdir, interpret=True,
                                          packet=512)
    jax_default()
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = st.quad_closest_hit(tb, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    _check_any(ref_any, st.quad_any_hit(tb, o_t, d_t, coef=True), got)
    assert_relaxed_parity(ref_pair, st.pair_closest_hit(tb, o_t, d_t,
                                                        coef=True))


@pytest.mark.filterwarnings("ignore:VKPT_MXU_PRECISION=default")
def test_bf16_pair_two_level_matches_pallas_default(bf16_instanced,
                                                    jax_default):
    """Two-level pair kernels on the moved bf16 bake (instance 0
    mirrored) against the Pallas kernels at (emulated) DEFAULT."""
    jd, td = bf16_instanced
    o, d = _aimed(td, 1500, seed=6)
    jo, jdir = jnp.asarray(o), jnp.asarray(d)
    ref = pp.pallas_pair_closest_hit(jd, jo, jdir, interpret=True,
                                     packet=512)
    ref_any = pp.pallas_pair_any_hit(jd, jo, jdir, interpret=True,
                                     packet=512)
    jax_default()
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = st.pair_closest_hit(td, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    _check_any(ref_any, st.pair_any_hit(td, o_t, d_t, coef=True), got)
    inst0 = (got.tri >= 0) & ((got.tri // td.max_leaf_size)
                              >> td.mb_bits == 0)
    assert inst0.sum() > 0   # rays reach the mirrored instance


@pytest.mark.filterwarnings("ignore:VKPT_MXU_PRECISION=default")
def test_bf16_frontier_matches_pallas_default(columns_glb, jax_default):
    """Both frontier kernels on a bf16 bake at leaf 4 against the Pallas
    frontier kernels at (emulated) DEFAULT."""
    jd = ensure_mt_coefs(jax_build(jgltf.load(columns_glb), build_bvh=True,
                                   max_leaf_size=LEAF))
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=LEAF,
                            device="cpu", mt="mxu", mxu_precision="default")
    o, d = _aimed(td, 1024, seed=11)
    jo, jdir = jnp.asarray(o), jnp.asarray(d)
    ref = pf.pallas_frontier_closest_hit(jd, jo, jdir, interpret=True,
                                         packet=512)
    ref_any = pf.pallas_frontier_any_hit(jd, jo, jdir, interpret=True,
                                         packet=512)
    jax_default()
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = fr.frontier_closest_hit(td, o_t, d_t, coef=True)
    assert_relaxed_parity(ref, got)
    _check_any(ref_any, fr.frontier_any_hit(td, o_t, d_t, coef=True), got)


@pytest.mark.filterwarnings("ignore:VKPT_MXU_PRECISION=default")
def test_bf16_frame_matches_jax_default(columns_glb, jax_default):
    """A 64x48 frame of the default tier with bf16 coefficient leaves
    against the JAX pipeline at (emulated) DEFAULT: rays and pixels
    within test_coefficient_frame_matches_jax's budget."""
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
    jd = jax_build(jgltf.load(columns_glb), build_bvh=True,
                   max_leaf_size=14)
    assert jd.tri_coefs is not None
    ref, ref_rays = JaxPipeline(jd, JaxConfig(traversal="pallas", **kw)) \
        .render_numpy(cam, 2)
    jax_default()
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                            device="cpu", mt="mxu", mxu_precision="default")
    got, rays = RenderPipeline(td, RenderConfig(
        traversal="pallas", mt="mxu", mxu_precision="default", **kw)) \
        .render_numpy(cam, 2)
    assert np.isfinite(got).all() and got.shape == (48, 64, 3)
    _assert_close_frames(ref, ref_rays, got, rays)
    f32 = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                             device="cpu", mt="mxu")
    img32, _ = RenderPipeline(f32, RenderConfig(
        traversal="pallas", mt="mxu", **kw)).render_numpy(cam, 2)
    assert not np.array_equal(img32, got)   # the product changed hits


def _aimed(scene, n, seed):
    """World rays of a scene aimed at its root box's interior, from
    outside and inside it."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.numpy(), scene.root_hi.numpy()
    c, r = (lo + hi) / 2, (hi - lo) / 2
    o = c + rng.uniform(-1.5, 1.5, (n, 3)) * r
    target = c + rng.uniform(-0.6, 0.6, (n, 3)) * r
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_bf16_table_reaches_every_path(bf16_flat):
    """The bf16 table needs no branch of the dispatch: the pooled
    wavefront's images are bitwise the single frames', the joint batch
    sums them within the reference's chunking tolerance (PARITY.md:60),
    and the refitted scene renders, each through the bf16 builds' plain
    versions (every launch a ``_bf16`` name)."""
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    _, tb, _ = bf16_flat
    names = []
    real = st._dispatch

    def spy(name, origin, plain, launch):
        names.append(name)
        return real(name, origin, plain, launch)

    cfg = RenderConfig(mt="mxu", mxu_precision="default", resolution_x=24,
                       resolution_y=16)
    pipe = RenderPipeline(tb, cfg)
    cams = [Camera(aspect_ratio=1.5,
                   position=np.asarray([x, 3.0, -9.0], np.float32))
            for x in (0.0, 1.5)]
    st._dispatch = spy
    try:
        pooled, _ = pipe.render_pooled(cams, [4, 5])
        singles = [pipe.render(c, f)[0] for c, f in zip(cams, [4, 5])]
        joint, _ = pipe.render_batch_sum(cams[0], 4, 2, joint=True)
        steps, _ = pipe.render_batch_sum(cams[0], 4, 2, joint=False)
        n = tb.num_triangles
        moved = refit_scene(dataclasses.replace(
            tb, tri_v0=tb.tri_v0 + torch.tensor([0.0, 0.25, 0.0])))
        image, _ = RenderPipeline(moved, cfg).render(cams[0], 1)
    finally:
        st._dispatch = real
    for got, want in zip(pooled, singles):
        assert torch.equal(got, want)
    np.testing.assert_allclose(joint.numpy(), steps.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isfinite(image).all()) and n > 0
    assert names and all(k.endswith("_bf16") for k in names)
