"""PyTorch port vs JAX: vector math, texture sampling, Möller–Trumbore
and the BRDF on random inputs made with NumPy.

Tolerances: both sides evaluate the same f32 formulas in the same
order, but XLA may fuse or reassociate elementwise chains on the CPU
(and its rsqrt/sin/cos need not round like PyTorch's), so values are
held to rtol 1e-5 / atol 1e-6 unless noted; masks derived from
comparisons must agree on all but boundary-grazing lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.ops import brdf as jbrdf
from vulkan_pathtracer_tpu.ops import intersect as jint
from vulkan_pathtracer_tpu.ops import texture as jtex
from vulkan_pathtracer_tpu.ops import vecmath as jvec
from vulkan_pathtracer_tpu_torch.ops import brdf as tbrdf
from vulkan_pathtracer_tpu_torch.ops import intersect as tint
from vulkan_pathtracer_tpu_torch.ops import texture as ttex
from vulkan_pathtracer_tpu_torch.ops import vecmath as tvec

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["dot", "cross", "normalize", "reflect",
                                "mix"])
def test_vecmath(fn):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(512, 3)).astype(np.float32)
    b = rng.normal(size=(512, 3)).astype(np.float32)
    t = rng.uniform(size=(512, 1)).astype(np.float32)
    args = {"dot": (a, b), "cross": (a, b), "normalize": (a,),
            "reflect": (a, _unit(rng, 512)), "mix": (a, b, t)}[fn]
    ref = getattr(jvec, fn)(*map(jnp.asarray, args))
    got = getattr(tvec, fn)(*map(torch.from_numpy, args))
    _close(got, ref)


def test_sample_bilinear():
    rng = np.random.default_rng(1)
    sizes = [(1, 1), (5, 3), (8, 8), (16, 4)]
    texels = [np.full((1, 4), 255, np.uint8)]
    offsets, widths, heights, cursor = [], [], [], 0
    for w, h in sizes:
        offsets.append(cursor)
        widths.append(w)
        heights.append(h)
        texels.append(rng.integers(0, 256, size=(w * h, 4), dtype=np.uint8))
        cursor += texels[-1].shape[0]
    pool = np.concatenate(texels)[1:]
    off, wid, hei = (np.asarray(x, np.int32) for x in (offsets, widths,
                                                        heights))
    idx = rng.integers(0, len(sizes), size=2048).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, size=(2048, 2)).astype(np.float32)
    ref = jtex.sample_bilinear(*map(jnp.asarray, (pool, off, wid, hei, idx,
                                                   uv)))
    got = ttex.sample_bilinear(*map(torch.from_numpy, (pool, off, wid, hei,
                                                        idx, uv)))
    _close(got, ref)


def test_moller_trumbore():
    rng = np.random.default_rng(2)
    n = 4096
    o = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = _unit(rng, n)
    v0 = (o + 2.0 * d + rng.normal(scale=0.5, size=(n, 3))).astype(
        np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    lim = rng.uniform(0.5, 5.0, size=n).astype(np.float32)
    jh, jt, ju, jv = jint.moller_trumbore(*map(jnp.asarray, (o, d, v0, e1,
                                                             e2)),
                                          jint.TMIN, jnp.asarray(lim))
    th, tt, tu, tv = tint.moller_trumbore(*map(torch.from_numpy, (o, d, v0,
                                                                e1, e2)),
                                          tint.TMIN, torch.from_numpy(lim))
    assert (th.numpy() == np.asarray(jh)).mean() > 0.999
    both = th.numpy() & np.asarray(jh)
    assert both.sum() > 100
    for got, ref in ((tt, jt), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[both], np.asarray(ref)[both],
                                   rtol=1e-5, atol=1e-5)


def _shading(rng, n, lib, conv):
    normal = _unit(rng, n)
    out_dir = _unit(rng, n)
    out_dir = np.where((normal * out_dir).sum(1, keepdims=True) < 0,
                       -out_dir, out_dir).astype(np.float32)
    albedo = rng.uniform(size=(n, 3)).astype(np.float32)
    metallic = rng.uniform(size=(n, 1)).astype(np.float32)
    # Roughness from 0.1 (the procedural scenes use 0.3-0.95): below
    # that the GGX pdf divides by (1 - (1-r^2) h^2)^2 -> r^4 and turns
    # last-ulp differences into percent-level ones on both sides.
    rough = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    lam = (normal * out_dir).sum(1).astype(np.float32)
    return lib.ShadingInfo(
        normal=conv(normal), out_dir=conv(out_dir), lambert_out=conv(lam),
        diffuse_albedo=conv((albedo * (1 - metallic)).astype(np.float32)),
        fresnel_0=conv((0.02 * (1 - metallic) + albedo * metallic).astype(
            np.float32)),
        roughness=conv(rough))


@pytest.mark.parametrize("seed", [3, 4])
def test_brdf_sample_density_eval(seed):
    """sample_brdf / get_brdf_density / brdf on random shading inputs.
    Tolerance rtol 1e-4 / atol 1e-5: GGX terms divide by small
    denominators near grazing angles, which amplifies the last-ulp
    differences of sin/cos/sqrt between XLA and PyTorch."""
    n = 2048
    js = _shading(np.random.default_rng(seed), n, jbrdf, jnp.asarray)
    ts = _shading(np.random.default_rng(seed), n, tbrdf, torch.from_numpy)
    r = np.random.default_rng(seed + 100).uniform(size=(2, n)).astype(
        np.float32)
    jdir = jbrdf.sample_brdf(js, jnp.asarray(r[0]), jnp.asarray(r[1]))
    tdir = tbrdf.sample_brdf(ts, torch.from_numpy(r[0]),
                             torch.from_numpy(r[1]))
    _close(tdir, jdir, rtol=1e-4, atol=1e-5)
    # Evaluate both at the SAME direction so the pdf/brdf comparison
    # does not inherit the sampling differences.
    light = jdir / jnp.linalg.norm(jdir, axis=1, keepdims=True)
    light_t = torch.from_numpy(np.array(light))
    jd = np.asarray(jbrdf.get_brdf_density(js, light))
    td = tbrdf.get_brdf_density(ts, light_t).numpy()
    jb = np.asarray(jbrdf.brdf(js, light))
    tb = tbrdf.brdf(ts, light_t).numpy()
    finite = np.isfinite(jd) & (np.abs(jd) < 1e6)
    np.testing.assert_allclose(td[finite], jd[finite], rtol=1e-4, atol=1e-5)
    ok = np.isfinite(jb).all(1) & (np.abs(jb) < 1e6).all(1)
    np.testing.assert_allclose(tb[ok], jb[ok], rtol=1e-4, atol=1e-5)
    assert finite.mean() > 0.99 and ok.mean() > 0.99
