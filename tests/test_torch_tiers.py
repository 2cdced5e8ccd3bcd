"""PyTorch port vs JAX: the oct kernel and the kernel-tier dispatch.

- The oct tables (the 8-wide collapse) equal the JAX bake's
  ``bvh_oct`` rows bitwise (NaN-box empty slots -> EMPTY links).
- The oct kernel's plain version against ``pallas_oct_closest_hit`` in
  interpret mode, with the JAX suite's tolerances (test_leaf28.py:72-82:
  hit masks equal, t allclose 1e-5, tri agreement >= 0.999; ties of
  equal t may resolve to another triangle under another visit order).
- The dispatch: for each setting of the JAX package's ``VKPT_*`` tier
  variables, the port's RenderConfig tier fields pick the kernel that
  the JAX ``_closest_hit`` / ``_any_hit`` (traversal="pallas") launch,
  recorded by stand-ins for the Pallas launchers: the leaf-keyed
  default primary, the named kernels and their TPU-placement aliases,
  the fall-through where a table is missing and on two-level scenes;
  and the refusals (exact frontier leaves above 14, unknown names and
  precisions; ``VKPT_MXU_PRECISION=default`` parses, with JAX's
  warning); the frontier guard band read from
  ``VKPT_FRONTIER_PRECISION`` and ``VKPT_FRONTIER_GUARD``.
- Frames: 64x48 frames under tier settings against the JAX
  ``RenderPipeline(traversal="pallas")`` with the same variables (its
  Pallas kernels in interpret mode): ray counts equal, radiance
  allclose 1e-5.
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
from vulkan_pathtracer_tpu.ops import pallas_frontier as pf
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops import pallas_traverse as pt
from vulkan_pathtracer_tpu.ops.intersect import Hit as JaxHit
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu.ops.mxu_mt import ensure_mt_coefs
from vulkan_pathtracer_tpu.render import wavefront as jwf
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

ENV = {"kernel_primary": "VKPT_KERNEL_PRIMARY",
       "kernel_secondary": "VKPT_KERNEL_SECONDARY",
       "anyhit_kernel": "VKPT_ANYHIT_KERNEL", "mt": "VKPT_MT"}


@pytest.fixture(scope="module")
def scenes(request):
    """(leaf, mt) -> (JAX flat bake, port flat bake) of the columns
    scene; coefficient tables on both under mxu."""
    cache = {}

    def get(leaf, mt="exact"):
        if (leaf, mt) not in cache:
            path = request.getfixturevalue("columns_glb")
            jd = jax_build(jgltf.load(path), build_bvh=True,
                           max_leaf_size=leaf)
            if mt == "mxu":
                ensure_mt_coefs(jd)
            cache[leaf, mt] = (jd, build_device_scene(
                gltf.load(path), max_leaf_size=leaf, device="cpu", mt=mt))
        return cache[leaf, mt]
    return get


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_oct_tables_match_jax_rows(scenes, leaf):
    jd, td = scenes(leaf)
    rows = np.asarray(jd.bvh_oct)
    assert td.oct_box.shape == (rows.shape[0], 8, 6)
    box, link = st.nary_tables_from_jax(rows, 8)
    assert np.array_equal(td.oct_box.numpy(), box)
    assert np.array_equal(td.oct_link.numpy(), link)
    empty = np.isnan(rows[:, :48].reshape(-1, 8, 6)[:, :, 0])
    assert np.array_equal(td.oct_link.numpy() == st.EMPTY, empty)
    assert empty.any() and (~empty).sum() > rows.shape[0]


@pytest.mark.parametrize("leaf", [14, 28])
def test_scene_from_jax_arrays_converts_tier_tables(scenes, leaf):
    """The JAX bake's oct rows, frontier tiles and coefficient rows,
    converted, equal the port's own bake bitwise."""
    from tests.test_torch_scene import jax_scene_arrays
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        scene_from_jax_arrays,
    )

    jd, td = scenes(leaf, "mxu")
    conv = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    for f in ("oct_box", "oct_link", "frontier_box", "frontier_link",
              "tri_coefs"):
        assert np.array_equal(getattr(conv, f).numpy(),
                              getattr(td, f).numpy()), f


def test_oct_plain_matches_pallas_interpret(scenes):
    jd, td = scenes(4)
    o, d = _rays(1024, seed=21)
    ref = pp.pallas_oct_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                    interpret=True, packet=512)
    active = torch.from_numpy(np.random.default_rng(2).random(1024) < 0.9)
    got = st.oct_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(ref.t) < MISS_T
    assert 100 < hit.sum() < 1024
    assert np.array_equal(got.t.numpy() < MISS_T, hit)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-5)
    assert (got.tri.numpy() == np.asarray(ref.tri)).mean() >= 0.999
    masked = st.oct_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d),
                                active)
    assert torch.equal(masked.t[active], got.t[active])
    assert (masked.t[~active] == MISS_T).all()


def test_oct_tables_reject_stack_overflow():
    """The bake refuses a tree whose collapse could overflow a kernel
    stack: here the oct capacity is cut to below a chain's need."""
    from tests.test_torch_traverse import _chain_bvh

    box, link, _ = st.build_oct_tables(_chain_bvh(30), 4)
    assert box.shape[1] == 8 and link.dtype == np.int32
    slots = dict(st.STACK_SLOTS)
    try:
        st.STACK_SLOTS[8] = 7
        with pytest.raises(ValueError, match="stack entries"):
            st.build_oct_tables(_chain_bvh(30), 4)
    finally:
        st.STACK_SLOTS.update(slots)


# -- dispatch against the JAX package's ---------------------------------------

JAX_CLOSEST = {"pallas_quad_closest_hit": (pp, "quad"),
               "pallas_pair_closest_hit": (pp, "pair"),
               "pallas_oct_closest_hit": (pp, "oct"),
               "pallas_frontier_closest_hit": (pf, "frontier"),
               "pallas_closest_hit": (pt, "packet")}
JAX_ANY = {"pallas_quad_any_hit": (pp, "quad"),
           "pallas_pair_any_hit": (pp, "pair"),
           "pallas_frontier_any_hit": (pf, "frontier")}


def _port_name(fn):
    """(kernel name, coefficient leaves) of a wavefront tier function."""
    coef = bool(getattr(fn, "keywords", {}).get("coef", False))
    fn = getattr(fn, "func", fn)
    names = {st.quad_closest_hit: "quad", st.pair_closest_hit: "pair",
             st.oct_closest_hit: "oct", fr.frontier_closest_hit: "frontier",
             sk.skip_closest_hit: "packet", st.quad_any_hit: "quad",
             st.pair_any_hit: "pair", fr.frontier_any_hit: "frontier"}
    return names[fn], coef


def _jax_choice(monkeypatch, jd, tiers, any_hit=False, phase="primary"):
    """The Pallas launcher JAX's dispatch calls under the variables of
    ``tiers`` (stand-ins record it and return misses)."""
    calls = []
    for name, (mod, kern) in (JAX_ANY if any_hit else JAX_CLOSEST).items():
        def rec(scene, origin, direction, active=None, _k=kern, **kw):
            calls.append(_k)
            n = origin.shape[0]
            if any_hit:
                return jnp.zeros((n,), bool)
            return JaxHit(t=jnp.full((n,), MISS_T, jnp.float32),
                          tri=jnp.full((n,), -1, jnp.int32),
                          u=jnp.zeros((n,), jnp.float32),
                          v=jnp.zeros((n,), jnp.float32))
        monkeypatch.setattr(mod, name, rec)
    with monkeypatch.context() as m:
        for field, var in ENV.items():
            if tiers.get(field) is not None:
                m.setenv(var, tiers[field])
        o = jnp.zeros((8, 3), jnp.float32)
        d = jnp.ones((8, 3), jnp.float32)
        if any_hit:
            jwf._any_hit(jd, o, d, None, "pallas")
        else:
            jwf._closest_hit(jd, o, d, None, "pallas", phase=phase)
    return calls


CLOSEST_CASES = [
    (14, "exact", {}), (28, "exact", {}),
    (14, "exact", {"kernel_primary": "quad"}),
    (28, "exact", {"kernel_primary": "pair"}),
    (28, "exact", {"kernel_primary": "oct"}),
    (14, "exact", {"kernel_primary": "oct_hbm"}),
    (14, "exact", {"kernel_primary": "frontier"}),
    (14, "exact", {"kernel_primary": "frontier_hbm"}),
    (14, "exact", {"kernel_primary": "quad_hbm"}),
    (14, "exact", {"kernel_primary": "vgate"}),
    (28, "exact", {"kernel_primary": "vgate_hbm"}),
    (14, "exact", {"kernel_primary": "packet"}),
    (14, "exact", {"kernel_secondary": "oct"}),
    (28, "exact", {"kernel_secondary": "pair"}),
    (14, "exact", {"kernel_secondary": "frontier"}),
    (28, "mxu", {"mt": "mxu"}),
    (14, "mxu", {"mt": "mxu"}),
    (28, "mxu", {"mt": "mxu", "kernel_primary": "frontier"}),
    (28, "mxu", {"mt": "mxu", "kernel_primary": "oct"}),
]


@pytest.mark.parametrize("phase", ["primary", "secondary"])
@pytest.mark.parametrize("leaf,mt,tiers", CLOSEST_CASES)
def test_closest_dispatch_matches_jax(scenes, monkeypatch, leaf, mt, tiers,
                                      phase):
    jd, td = scenes(leaf, mt)
    want = _jax_choice(monkeypatch, jd, tiers, phase=phase)
    got, coef = _port_name(wavefront._closest_tier(
        td, RenderConfig(**tiers).tiers, phase))
    assert [got] == want
    # Coefficient leaves wherever JAX's launcher would take them: the
    # quad, pair and frontier kernels under mxu, never the oct kernel.
    assert coef == (mt == "mxu" and got != "oct")


@pytest.mark.parametrize("leaf,mt,tiers", [
    (28, "exact", {}), (14, "exact", {"anyhit_kernel": "frontier"}),
    (28, "mxu", {"mt": "mxu", "anyhit_kernel": "frontier"}),
    (28, "mxu", {"mt": "mxu"}), (14, "exact", {"kernel_primary": "oct"})])
def test_any_dispatch_matches_jax(scenes, monkeypatch, leaf, mt, tiers):
    jd, td = scenes(leaf, mt)
    want = _jax_choice(monkeypatch, jd, tiers, any_hit=True)
    got, coef = _port_name(wavefront._any_tier(td, RenderConfig(**tiers)
                                               .tiers))
    assert [got] == want and coef == (mt == "mxu")


def test_missing_tables_fall_through(scenes):
    """A named kernel whose table the scene lacks falls through JAX's
    order: primary pair, quad, oct; secondary quad, oct, pair."""
    _, td = scenes(14)
    no_oct = dataclasses.replace(td, oct_box=None, oct_link=None,
                                 frontier_box=None, frontier_link=None)
    for name in ("oct", "frontier"):
        tiers = RenderConfig(kernel_primary=name,
                             kernel_secondary=name).tiers
        assert wavefront._closest_tier(no_oct, tiers, "primary") is \
            st.pair_closest_hit
        assert wavefront._closest_tier(no_oct, tiers, "secondary") is \
            st.quad_closest_hit
    tiers = RenderConfig(anyhit_kernel="frontier").tiers
    assert wavefront._any_tier(no_oct, tiers) is st.quad_any_hit


@pytest.mark.parametrize("tiers", [{}, {"kernel_primary": "oct"},
                                   {"kernel_primary": "frontier",
                                    "anyhit_kernel": "frontier"},
                                   {"mt": "mxu"}])
def test_two_level_scenes_take_the_pair_kernels(columns_glb, monkeypatch,
                                                tiers):
    jd = jax_inst(jgltf.load(columns_glb), max_leaf_size=8)
    mt = tiers.get("mt", "exact")
    if mt == "mxu":
        ensure_mt_coefs(jd)
    td = build_instanced_scene(gltf.load(columns_glb), max_leaf_size=8,
                               device="cpu", mt=mt)
    assert td.oct_box is None and td.frontier_box is None
    config = RenderConfig(**tiers)
    for phase in ("primary", "secondary"):
        want = _jax_choice(monkeypatch, jd, tiers, phase=phase)
        got, coef = _port_name(wavefront._closest_tier(td, config.tiers,
                                                       phase))
        assert [got] == want == ["pair"] and coef == (mt == "mxu")
    want = _jax_choice(monkeypatch, jd, tiers, any_hit=True)
    assert [_port_name(wavefront._any_tier(td, config.tiers))[0]] == want


def test_refusals(scenes, monkeypatch):
    from vulkan_pathtracer_tpu_torch.app.main import (
        parse_args,
        tier_fields_from_env,
    )
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline

    from vulkan_pathtracer_tpu_torch.models.camera import Camera

    _, td28 = scenes(28)
    # Exact frontier leaves above 14 triangles: JAX's ValueError.
    for tiers in ({"kernel_primary": "frontier"},
                  {"kernel_secondary": "frontier_hbm"}):
        pipe = RenderPipeline(td28, RenderConfig(
            resolution_x=8, resolution_y=8, num_bounces=3, **tiers))
        with pytest.raises(ValueError, match="leaf <= 14"):
            pipe.render(Camera(aspect_ratio=1.0), 0)
    o, d = map(torch.from_numpy, _rays(16, seed=1))
    with pytest.raises(ValueError, match="VKPT_MT=mxu"):
        fr.frontier_closest_hit(td28, o, d)
    with pytest.raises(ValueError, match="leaf <= 14"):
        wavefront._any_hit(td28, o, d, None,
                           RenderConfig(anyhit_kernel="frontier").tiers)
    with pytest.raises(ValueError, match="unknown kernel"):
        RenderPipeline(td28, RenderConfig(kernel_primary="bvh8"))
    with pytest.raises(ValueError, match="exact | mxu"):
        RenderPipeline(td28, RenderConfig(mt="bf16"))
    with pytest.warns(UserWarning, match="VKPT_MXU_PRECISION=default"):
        fields = tier_fields_from_env({"VKPT_MXU_PRECISION": "default",
                                       "VKPT_MT": "mxu"})
    assert fields["mxu_precision"] == "default"
    assert tier_fields_from_env({"VKPT_MXU_PRECISION": "high"})[
        "mxu_precision"] == "highest"
    with pytest.raises(ValueError, match="highest | high | default"):
        tier_fields_from_env({"VKPT_MXU_PRECISION": "bf16"})
    monkeypatch.setenv("VKPT_KERNEL_PRIMARY", "nine")
    with pytest.raises(SystemExit) as exc:
        parse_args(["-s", "scene.glb"])
    assert exc.value.code == 2


@pytest.mark.parametrize("env,guard", [
    ({}, 2.0 ** -7),
    ({"VKPT_FRONTIER_PRECISION": "default"}, 2.0 ** -7),
    ({"VKPT_FRONTIER_PRECISION": "high"}, 2.0 ** -12),
    ({"VKPT_FRONTIER_PRECISION": "HIGHEST"}, 2.0 ** -12),
    ({"VKPT_FRONTIER_GUARD": "0.001"}, 0.001),
    ({"VKPT_FRONTIER_PRECISION": "highest", "VKPT_FRONTIER_GUARD": "0"},
     0.0),
    ({"VKPT_FRONTIER_GUARD": "x"}, None),
    ({"VKPT_FRONTIER_GUARD": "-0.5"}, None),
    ({"VKPT_FRONTIER_GUARD": "nan"}, None),
    ({"VKPT_FRONTIER_PRECISION": "fast"}, None)])
def test_frontier_guard_from_env(env, guard, monkeypatch, capsys):
    """The frontier bake's guard band as pallas_frontier._guard reads
    it: VKPT_FRONTIER_GUARD when set, else 2^-7 under
    VKPT_FRONTIER_PRECISION=default (or unset) and 2^-12 under high or
    highest, into RenderConfig.frontier_guard; a guard that is not a
    number or below 0 (it would drop geometry) and an unknown precision
    exit 2 (``guard`` None)."""
    from vulkan_pathtracer_tpu_torch.app.main import (
        parse_args,
        tier_fields_from_env,
    )

    for k in ("VKPT_FRONTIER_PRECISION", "VKPT_FRONTIER_GUARD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if guard is None:
        with pytest.raises(ValueError, match="VKPT_FRONTIER_"):
            tier_fields_from_env()
        with pytest.raises(SystemExit) as exc:
            parse_args(["-s", "scene.glb"])
        assert exc.value.code == 2
        assert "VKPT_FRONTIER_" in capsys.readouterr().err
        return
    assert tier_fields_from_env()["frontier_guard"] == guard
    config, _ = parse_args(["-s", "scene.glb"])
    assert config.frontier_guard == guard
    if "VKPT_FRONTIER_GUARD" not in env:
        assert guard == pf._guard()


@pytest.mark.parametrize("value", ["1.5", "0.0"])
def test_presplit_refused(monkeypatch, value, columns_glb):
    """VKPT_PRESPLIT, which JAX's bake reads as a float
    (device_scene.py:410), reaches the flat bake through the CLI's
    RenderConfig: 0.0 bakes as unset, 1.5 pre-splits (a scene of 1024
    or more triangles; the two-level bake ignores it).  A value that is
    not a number is still refused (exit 2)."""
    from vulkan_pathtracer_tpu_torch.app import main as main_mod
    from vulkan_pathtracer_tpu_torch.app.main import (
        load_pipeline,
        parse_args,
        tier_fields_from_env,
    )

    monkeypatch.setenv("VKPT_PRESPLIT", value)
    config, _ = parse_args(["-s", "scene.glb"])
    assert config.presplit == float(value)
    assert tier_fields_from_env({"VKPT_PRESPLIT": value})["presplit"] == \
        float(value)
    # The columns fixture has 580 triangles: below the 1024 of
    # bvh_with_leaf_blocks, so the bake equals the unsplit one; the
    # budget reaches build_device_scene all the same.
    seen = []
    real = main_mod.build_device_scene

    def spy(*args, **kw):
        seen.append(kw["presplit"])
        return real(*args, **kw)

    monkeypatch.setattr(main_mod, "build_device_scene", spy)
    pipe = load_pipeline(columns_glb, config, "cpu")
    assert seen == [float(value)]
    assert pipe.scene.num_triangles == int(pipe.scene.tree.block_count.sum())
    monkeypatch.setenv("VKPT_PRESPLIT", "x")
    with pytest.raises(SystemExit) as exc:
        parse_args(["-s", "scene.glb"])
    assert exc.value.code == 2
    with pytest.raises(ValueError, match="VKPT_PRESPLIT"):
        tier_fields_from_env({"VKPT_PRESPLIT": "x"})


def test_tier_fields_from_env():
    from vulkan_pathtracer_tpu_torch.app.main import tier_fields_from_env

    assert tier_fields_from_env({}) == dict(
        kernel_primary=None, kernel_secondary=None, anyhit_kernel=None,
        mt="exact", max_leaf=None, frontier_width=16,
        frontier_guard=2.0 ** -7, mxu_precision="highest")
    got = tier_fields_from_env({
        "VKPT_KERNEL_PRIMARY": "oct", "VKPT_KERNEL_SECONDARY": "frontier",
        "VKPT_ANYHIT_KERNEL": "frontier", "VKPT_MT": "MXU",
        "VKPT_LEAF": "28", "VKPT_FRONTIER_WIDTH": "32",
        "VKPT_FRONTIER_LEAF": "cond", "VKPT_MXU_PRECISION": "high"})
    assert got == dict(kernel_primary="oct", kernel_secondary="frontier",
                       anyhit_kernel="frontier", mt="mxu", max_leaf=28,
                       frontier_width=32, frontier_guard=2.0 ** -7,
                       mxu_precision="highest")


# -- frames -------------------------------------------------------------------

def frame_pair(path, leaf, tiers, monkeypatch, bounces=2):
    """A 64x48 frame of the port under ``tiers`` and of the JAX pipeline
    (traversal="pallas", interpret mode) under the same variables."""
    from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
    from vulkan_pathtracer_tpu.render.pipeline import (
        RenderPipeline as JaxPipeline,
    )
    from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
    from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline

    kw = dict(num_samples=1, num_bounces=bounces, resolution_x=64,
              resolution_y=48)
    mt = tiers.get("mt", "exact")
    jax.clear_caches()   # the variables are read while JAX traces
    with monkeypatch.context() as m:
        for field, var in ENV.items():
            if tiers.get(field) is not None:
                m.setenv(var, tiers[field])
        jd = jax_build(jgltf.load(path), build_bvh=True, max_leaf_size=leaf)
        cam = JaxCamera(aspect_ratio=64 / 48,
                        position=np.asarray([0.0, 3.0, -9.0], np.float32))
        ref, ref_rays = JaxPipeline(jd, JaxConfig(traversal="pallas", **kw)) \
            .render_numpy(cam, 2)
    td = build_device_scene(gltf.load(path), max_leaf_size=leaf,
                            device="cpu", mt=mt)
    got, rays = RenderPipeline(td, RenderConfig(traversal="pallas", **tiers,
                                                **kw)).render_numpy(cam, 2)
    assert np.isfinite(got).all() and got.shape == (48, 64, 3)
    return ref, ref_rays, got, rays


@pytest.mark.parametrize("leaf,tiers", [
    (14, {}), (4, {"kernel_primary": "oct"})])
def test_tier_frame_matches_jax(columns_glb, monkeypatch, leaf, tiers):
    ref, ref_rays, got, rays = frame_pair(columns_glb, leaf, tiers,
                                          monkeypatch)
    assert rays == ref_rays > 64 * 48
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
