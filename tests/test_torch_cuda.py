"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: every test skips without a CUDA device (decided in
the fixture, never at import).  The file imports no JAX and defines
its own fixtures, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none for the kernels — they are built with -fmad=false and
perform the plain versions' float operations in the same order, so
t, tri, u, v and the any-hit bit are bitwise equal.  Leaf sizes 4 and
14 exercise the kernel's scalar leaf loads (block % 4 != 0 for 14),
28 the float4 path of the headline frame.  The skip kernel (flat and
instanced) and the wide kernel are held to their plain versions the
same way, as are the oct kernel, the frontier kernels (width 16 and
32) and every kernel built with coefficient leaves (``mt="mxu"``: quad,
pair flat and two-level, with a mirrored instance, and frontier), f32
or their bf16 product's builds (a bf16 table, with their statistics
and channel builds).
The persistent quad and oct kernels are also launched on ray counts
that are no multiple of 32, with inactive lanes, twice in a row (the
batch counter zeroed before each launch), and the quad kernels'
statistics build is held to the plain versions with its counters
checked (exact and coefficient leaves, with the coefficient test's
exit counts); so are the pair kernels' (flat and two-level, exact and
coefficient leaves), the skip kernel's (flat and two-level), the wide
kernel's and both frontier kernels' (widths 16 and 32, exact and
coefficient leaves), and walk kernels launched on two side streams at
once, each with its own batch counter.  The joint progressive batch
(``render_frames_joint``, in small shading chunks) through the kernels
equals it through the plain versions on the card bitwise, and two runs
are bitwise equal; so is a pooled group of 3 frames of 3 cameras
(``render_frames_pooled``, the fly-through) against the same group on
the CPU (equal rays, radiance allclose 1e-5), from run to run; the
quad kernels index rays in 64 bits (a launch whose float offsets pass
2^31).  Every channel build (a seeded or windowed closest hit) through
its wrapper is bitwise its plain version, and the terminal viewer on a
world-1 NCCL group prints the single-device viewer's text.  The textured golden configuration (tests/golden_utils.py:
the textured sphere at 4 spp, 2 bounces, 64x64) renders on the card as
on the CPU: textures, normal maps and the multi-sample loop.  Frames,
joint batches and pooled groups through the shading kernels
(``ops/shade.py``) are bitwise the plain shading chain on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import kernels, shade
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T
from vulkan_pathtracer_tpu_torch.render import pipeline as pl
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_paths(tmp_path_factory):
    from assets.procedural import (
        make_columns,
        make_cornell,
        make_textured_sphere,
    )

    root = tmp_path_factory.mktemp("cuda_scenes")
    paths = {"columns": str(root / "columns.glb"),
             "cornell": str(root / "cornell.glb"),
             "sphere": str(root / "sphere.glb")}
    make_columns(paths["columns"], grid=4, segments=3, n_materials=4)
    make_cornell(paths["cornell"])
    make_textured_sphere(paths["sphere"], lat=16, lon=32)
    return paths


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = torch.from_numpy(rng.random(n) < 0.8).to(device)
    return (torch.from_numpy(origins).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device), active)


@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_kernels_match_plain(cuda, scene_paths, leaf):
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=leaf, device=cuda)
    o, d, active = _rays(8192, seed=leaf, device=cuda)
    t_lane = st.lane_limits(o.shape[0], active, cuda)
    args = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
    got = kernels.quad_closest_hit(*args)
    ref = st.quad_closest_hit_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    hits = ref.t < MISS_T
    assert 500 < int(hits.sum()) < 8192
    occ = kernels.quad_any_hit(*args)
    assert torch.equal(occ, st.quad_any_hit_plain(*args))
    assert torch.equal(occ, hits)
    assert not occ[~active].any()


@pytest.mark.parametrize("leaf", [4, 14, 28])
@pytest.mark.parametrize("instanced", [False, True])
def test_pair_kernels_match_plain(cuda, scene_paths, leaf, instanced):
    """The pair kernels, flat and two-level, bitwise equal to their
    plain versions; any hit equal to the closest-hit mask."""
    host = gltf.load(scene_paths["columns"])
    scene = (build_instanced_scene(host, max_leaf_size=leaf, device=cuda)
             if instanced else
             build_device_scene(host, max_leaf_size=leaf, device=cuda))
    o, d, active = _rays(8192, seed=leaf + 7, device=cuda)
    args = st.pair_args(scene, o, d, active)
    got = kernels.pair_closest_hit(*args)
    ref = st.pair_closest_hit_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    hits = ref.t < MISS_T
    assert 500 < int(hits.sum()) < 8192
    occ = kernels.pair_any_hit(*args)
    assert torch.equal(occ, st.pair_any_hit_plain(*args))
    assert torch.equal(occ, hits)
    before = dict(st.LAUNCHES)
    st.pair_closest_hit(scene, o, d, active)
    st.pair_any_hit(scene, o, d, active)
    assert st.LAUNCHES["pair_closest_hit"] == before["pair_closest_hit"] + 1
    assert st.LAUNCHES["pair_any_hit"] == before["pair_any_hit"] + 1


@pytest.mark.parametrize("leaf", [4, 14, 28])
@pytest.mark.parametrize("instanced", [False, True])
def test_skip_kernel_matches_plain(cuda, scene_paths, leaf, instanced):
    """The skip kernel, flat and two-level, bitwise equal to its plain
    version, and one launch counted per wrapper call."""
    host = gltf.load(scene_paths["columns"])
    scene = (build_instanced_scene(host, max_leaf_size=leaf, device=cuda)
             if instanced else
             build_device_scene(host, max_leaf_size=leaf, device=cuda))
    o, d, active = _rays(8192, seed=leaf + 11, device=cuda)
    args = sk.skip_args(scene, o, d, active)
    got = kernels.skip_closest_hit(*args)
    ref = sk.skip_closest_hit_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    before = st.LAUNCHES["skip_closest_hit"]
    sk.skip_closest_hit(scene, o, d, active)
    assert st.LAUNCHES["skip_closest_hit"] == before + 1


@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_wide_kernel_matches_plain(cuda, scene_paths, leaf):
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=leaf, device=cuda, wide=True)
    o, d, active = _rays(8192, seed=leaf + 13, device=cuda)
    args = sk.wide_args(scene, o, d, active)
    got = kernels.wide_closest_hit(*args)
    ref = sk.wide_closest_hit_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    before = st.LAUNCHES["wide_closest_hit"]
    sk.wide_closest_hit(scene, o, d, active)
    assert st.LAUNCHES["wide_closest_hit"] == before + 1
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.wide_closest_hit(scene.wide_nodes, scene.leaves, o.cpu(), d,
                                 args[4])


def _assert_equal(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_oct_kernel_matches_plain(cuda, scene_paths, leaf):
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=leaf, device=cuda)
    o, d, active = _rays(8192, seed=leaf + 17, device=cuda)
    args = (scene.oct_box, scene.oct_link, scene.leaves, o, d,
            st.lane_limits(o.shape[0], active, cuda))
    ref = st.oct_closest_hit_plain(*args)
    _assert_equal(kernels.oct_closest_hit(*args), ref)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    before = st.LAUNCHES["oct_closest_hit"]
    st.oct_closest_hit(scene, o, d, active)
    assert st.LAUNCHES["oct_closest_hit"] == before + 1


@pytest.mark.parametrize("width,leaf,mt", [(16, 4, "exact"),
                                           (16, 14, "exact"),
                                           (32, 14, "exact"),
                                           (16, 28, "mxu"), (32, 14, "mxu")])
def test_frontier_kernels_match_plain(cuda, scene_paths, width, leaf, mt):
    """Both frontier kernels bitwise equal to their plain versions; the
    any-hit bit equal to the closest-hit mask with exact leaves."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=leaf, device=cuda, mt=mt,
                               frontier_width=width)
    coef = mt == "mxu"
    o, d, active = _rays(8192, seed=leaf + width, device=cuda)
    args = fr.frontier_args(scene, o, d, active, coef)
    ref = fr.frontier_closest_hit_plain(*args)
    _assert_equal(kernels.frontier_closest_hit(*args), ref)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    occ = kernels.frontier_any_hit(*args)
    assert torch.equal(occ, fr.frontier_any_hit_plain(*args))
    if not coef:
        assert torch.equal(occ, ref.t < MISS_T)
    name = "frontier_any_hit" + ("_coef" if coef else "")
    before = st.LAUNCHES[name]
    fr.frontier_any_hit(scene, o, d, active, coef=coef)
    assert st.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_quad_coef_kernels_match_plain(cuda, scene_paths, leaf):
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=leaf, device=cuda, mt="mxu")
    o, d, active = _rays(8192, seed=leaf + 19, device=cuda)
    args = st.quad_args(scene, o, d, active, coef=True)
    ref = st.quad_closest_hit_plain(*args)
    _assert_equal(kernels.quad_closest_hit(*args), ref)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    assert torch.equal(kernels.quad_any_hit(*args),
                       st.quad_any_hit_plain(*args))
    before = st.LAUNCHES["quad_closest_hit_coef"]
    st.quad_closest_hit(scene, o, d, active, coef=True)
    assert st.LAUNCHES["quad_closest_hit_coef"] == before + 1


@pytest.mark.parametrize("instanced", [False, True])
def test_pair_coef_kernels_match_plain(cuda, scene_paths, instanced):
    """Coefficient leaves of the pair kernels, flat and two-level (with
    the first instance mirrored, so its det_sign is -1)."""
    from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
        update_instance_transforms,
    )

    host = gltf.load(scene_paths["columns"])
    if instanced:
        scene = build_instanced_scene(host, max_leaf_size=14, device=cuda,
                                      mt="mxu")
        xf = np.stack([inst.transform for inst in host.instances])
        xf[0, :3, 0] *= -1.0
        scene = update_instance_transforms(scene, xf)
        assert float(scene.inst_inv[0, 12]) == -1.0
    else:
        scene = build_device_scene(host, max_leaf_size=14, device=cuda,
                                   mt="mxu")
    o, d, active = _rays(8192, seed=23, device=cuda)
    args = st.pair_args(scene, o, d, active, coef=True)
    ref = st.pair_closest_hit_plain(*args)
    _assert_equal(kernels.pair_closest_hit(*args), ref)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    assert torch.equal(kernels.pair_any_hit(*args),
                       st.pair_any_hit_plain(*args))


@pytest.mark.parametrize("kind", ["quad", "pair", "pair_two_level",
                                  "frontier", "frontier32"])
def test_bf16_kernels_match_plain(cuda, scene_paths, kind):
    """The bf16 builds (the one-pass product, a bf16 coefficient table)
    of both kernels of each family, their statistics builds and their
    closest hit's channel build (seeded; windowed but on quad), bitwise
    their plain versions; each wrapper counts its ``_bf16`` launch."""
    from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
        update_instance_transforms,
    )

    host = gltf.load(scene_paths["columns"])
    fam = kind.removesuffix("_two_level").removesuffix("32")
    if kind == "pair_two_level":
        scene = build_instanced_scene(host, max_leaf_size=14, device=cuda,
                                      mt="mxu", mxu_precision="default")
        xf = np.stack([inst.transform for inst in host.instances])
        xf[0, :3, 0] *= -1.0
        scene = update_instance_transforms(scene, xf)
    else:
        scene = build_device_scene(
            host, max_leaf_size=14 if kind == "pair" else 28, device=cuda,
            mt="mxu", mxu_precision="default",
            frontier_width=32 if kind == "frontier32" else 16)
    assert scene.tri_coefs.dtype == torch.bfloat16
    mod = fr if fam == "frontier" else st
    o, d, active = _rays(8192, seed=29, device=cuda)
    args = getattr(mod, f"{fam}_args")(scene, o, d, active, True)
    ref = getattr(mod, f"{fam}_closest_hit_plain")(*args)
    _assert_equal(getattr(kernels, f"{fam}_closest_hit")(*args), ref)
    assert 500 < int((ref.t < MISS_T).sum()) < 8192
    ref_any = getattr(mod, f"{fam}_any_hit_plain")(*args)
    assert torch.equal(getattr(kernels, f"{fam}_any_hit")(*args), ref_any)
    stats = getattr(kernels, f"{fam}_stats")
    _assert_equal(stats(False, *args)[0], ref)
    assert torch.equal(stats(True, *args)[0], ref_any)
    chan = st.channel_args(o, seed=ref, t_near=None if fam == "quad"
                           else ref.t * 0.5)
    _assert_equal(getattr(kernels, f"{fam}_closest_hit")(*args, **chan),
                  getattr(mod, f"{fam}_closest_hit_plain")(*args, **chan))
    for name in (f"{fam}_closest_hit", f"{fam}_any_hit"):
        before = st.LAUNCHES[name + "_bf16"]
        getattr(mod, name)(scene, o, d, active, coef=True)
        assert st.LAUNCHES[name + "_bf16"] == before + 1


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
def test_quad_kernels_ragged_inactive_and_relaunched(cuda, scene_paths, n):
    """The persistent quad kernels on a ray count that is no multiple of
    32, with a third of the lanes inactive, launched twice: the launcher
    zeroes the batch counter before each launch, so the second traces
    every ray again (a counter left at n would return the outputs
    unwritten)."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=28, device=cuda)
    o, d, active = _rays(n, seed=n, device=cuda)
    active[::3] = False
    t_lane = st.lane_limits(n, active, cuda)
    args = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
    oargs = (scene.oct_box, scene.oct_link, scene.leaves, o, d, t_lane)
    ref = st.quad_closest_hit_plain(*args)
    ref_any = st.quad_any_hit_plain(*args)
    ref_oct = st.oct_closest_hit_plain(*oargs)
    for _ in range(2):
        _assert_equal(kernels.quad_closest_hit(*args), ref)
        _assert_equal(kernels.oct_closest_hit(*oargs), ref_oct)
        occ = kernels.quad_any_hit(*args)
        assert torch.equal(occ, ref_any)
        assert torch.equal(occ, ref.t < MISS_T)
    assert not occ[~active].any()
    assert (ref.t[~active] == MISS_T).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_quad_statistics_build(cuda, scene_paths, any_hit):
    """The statistics build: the plain versions' outputs, one traced ray
    per active lane, a histogram of every ray's deepest stack."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=28, device=cuda)
    o, d, active = _rays(3000, seed=8, device=cuda)
    t_lane = st.lane_limits(3000, active, cuda)
    args = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
    out, counters = kernels.quad_stats(any_hit, *args)
    if any_hit:
        assert torch.equal(out, st.quad_any_hit_plain(*args))
    else:
        _assert_equal(out, st.quad_closest_hit_plain(*args))
    c = dict(zip(kernels.STACK_STATS, counters))
    hist = counters[len(kernels.STACK_STATS):]
    assert c["rays"] == int(active.sum()) == sum(hist)
    assert 0 < c["deepest"] <= st.STACK_SLOTS[4]
    summary = kernels.summarize_stack_stats(counters)
    assert 0.0 < summary["simt_node"] <= 1.0
    assert 0.0 < summary["simt_leaf"] <= 1.0


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["quad", "pair", "pair_instanced"])
def test_coefficient_statistics_build(cuda, scene_paths, kind, any_hit):
    """The statistics builds of the quad and pair kernels with
    coefficient leaves (leaf 28 flat, 14 two-level): the plain versions'
    outputs, leaf visits and counts of the coefficient test's exits and
    of instance changes, and one shared-row count per leaf visit."""
    host = gltf.load(scene_paths["columns"])
    scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda,
                                   mt="mxu")
             if kind == "pair_instanced" else
             build_device_scene(host, max_leaf_size=28, device=cuda,
                                mt="mxu"))
    o, d, active = _rays(3000, seed=12, device=cuda)
    fam = kind.split("_")[0]
    args = (st.pair_args if fam == "pair" else st.quad_args)(
        scene, o, d, active, True)
    out, counters = getattr(kernels, f"{fam}_stats")(any_hit, *args)
    plain = getattr(st, f"{fam}_{'any' if any_hit else 'closest'}_hit_plain")
    stats = {}
    ref = plain(*args, stats=stats)
    if any_hit:
        assert torch.equal(out, ref)
    else:
        _assert_equal(out, ref)
    c = dict(zip(kernels.STACK_STATS, counters))
    assert c["rays"] == int(active.sum())
    assert c["leaf_visits"] == stats["leaf_visits"] > 0
    for key in ("tri_tested", "tri_back", "tri_u", "tri_v"):
        assert c[key] == stats[key], key
    assert c["instance_changes"] == stats["instance_changes"]
    assert sum(c[f"share_{k}"] for k in range(1, 33)) == c["leaf_visits"]
    summary = kernels.summarize_stack_stats(counters)
    assert 0.0 < summary["simt_leaf"] <= 1.0


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
@pytest.mark.parametrize("mt", ["exact", "mxu"])
def test_pair_kernels_ragged_inactive_and_relaunched(cuda, scene_paths, n,
                                                     mt):
    """The persistent pair kernels (two-level, exact and coefficient
    leaves) on a ray count that is no multiple of 32, with a third of
    the lanes inactive, launched twice: the launcher zeroes the batch
    counter before each launch, and each lane's instance cache starts
    afresh with every ray it takes."""
    scene = build_instanced_scene(gltf.load(scene_paths["columns"]),
                                  max_leaf_size=14, device=cuda, mt=mt)
    o, d, active = _rays(n, seed=n + 1, device=cuda)
    active[::3] = False
    args = st.pair_args(scene, o, d, active, mt == "mxu")
    ref = st.pair_closest_hit_plain(*args)
    ref_any = st.pair_any_hit_plain(*args)
    for _ in range(2):
        _assert_equal(kernels.pair_closest_hit(*args), ref)
        occ = kernels.pair_any_hit(*args)
        assert torch.equal(occ, ref_any)
        if mt == "exact":
            assert torch.equal(occ, ref.t < MISS_T)
    assert not occ[~active].any()
    assert (ref.t[~active] == MISS_T).all()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("instanced", [False, True])
def test_pair_statistics_build(cuda, scene_paths, any_hit, instanced):
    """The pair kernels' statistics build: the plain versions' outputs
    and leaf visits, one traced ray per active lane, instance changes
    counted on the two-level scene only."""
    host = gltf.load(scene_paths["columns"])
    scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda)
             if instanced else
             build_device_scene(host, max_leaf_size=14, device=cuda))
    o, d, active = _rays(3000, seed=9, device=cuda)
    args = st.pair_args(scene, o, d, active)
    out, counters = kernels.pair_stats(any_hit, *args[:8])
    stats = {}
    if any_hit:
        assert torch.equal(out, st.pair_any_hit_plain(*args, stats=stats))
    else:
        _assert_equal(out, st.pair_closest_hit_plain(*args, stats=stats))
    c = dict(zip(kernels.STACK_STATS, counters))
    hist = counters[len(kernels.STACK_STATS):]
    assert c["rays"] == int(active.sum()) == sum(hist)
    assert 0 < c["deepest"] <= st.STACK_SLOTS[2]
    assert c["leaf_visits"] == stats["leaf_visits"]
    assert (0 < c["instance_changes"] <= c["leaf_visits"]) == instanced
    summary = kernels.summarize_stack_stats(counters)
    assert 0.0 < summary["simt_node"] <= 1.0
    assert 0.0 < summary["simt_leaf"] <= 1.0


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
@pytest.mark.parametrize("instanced", [False, True])
def test_skip_kernel_ragged_inactive_and_relaunched(cuda, scene_paths, n,
                                                    instanced):
    """The skip kernel (flat, and two-level with its instance cache) on a
    ray count that is no multiple of 32, with a third of the lanes
    inactive, launched twice with fresh batch counters: bitwise its plain
    version each time."""
    host = gltf.load(scene_paths["columns"])
    scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda)
             if instanced else
             build_device_scene(host, max_leaf_size=28, device=cuda))
    o, d, active = _rays(n, seed=n + 5, device=cuda)
    active[::3] = False
    args = sk.skip_args(scene, o, d, active)
    ref = sk.skip_closest_hit_plain(*args)
    for _ in range(2):
        _assert_equal(kernels.skip_closest_hit(*args), ref)
    assert (ref.t[~active] == MISS_T).all()


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
@pytest.mark.parametrize("width,mt", [(16, "exact"), (32, "exact"),
                                      (16, "mxu"), (32, "mxu")])
def test_frontier_any_hit_ragged_inactive_and_relaunched(cuda, scene_paths,
                                                         n, width, mt):
    """The frontier any hit on the shared walk (refill, leaf entries) on a
    ray count that is no multiple of 32, with a third of the lanes
    inactive, launched twice with fresh batch counters: its plain
    version's bit each time, with exact leaves the closest hit's mask."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=14, device=cuda, mt=mt,
                               frontier_width=width)
    o, d, active = _rays(n, seed=n + 7, device=cuda)
    active[::3] = False
    args = fr.frontier_args(scene, o, d, active, mt == "mxu")
    ref = fr.frontier_any_hit_plain(*args)
    for _ in range(2):
        occ = kernels.frontier_any_hit(*args)
        assert torch.equal(occ, ref)
    if mt == "exact":
        assert torch.equal(occ, fr.frontier_closest_hit_plain(*args).t
                           < MISS_T)
    assert not occ[~active].any()


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
@pytest.mark.parametrize("width,mt", [(16, "exact"), (32, "exact"),
                                      (16, "mxu"), (32, "mxu")])
def test_frontier_closest_hit_ragged_inactive_and_relaunched(
        cuda, scene_paths, n, width, mt):
    """The frontier closest hit on the shared walk (leaf entries, the
    Batcher network) on a ray count that is no multiple of 32, with a
    third of the lanes inactive, launched twice with fresh batch
    counters: bitwise its plain version each time."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=14, device=cuda, mt=mt,
                               frontier_width=width)
    o, d, active = _rays(n, seed=n + 9, device=cuda)
    active[::3] = False
    args = fr.frontier_args(scene, o, d, active, mt == "mxu")
    ref = fr.frontier_closest_hit_plain(*args)
    for _ in range(2):
        _assert_equal(kernels.frontier_closest_hit(*args), ref)
    assert (ref.t[~active] == MISS_T).all()


@pytest.mark.parametrize("n", [1, 33, 1000, 4099])
def test_wide_kernel_ragged_inactive_and_relaunched(cuda, scene_paths, n):
    """The wide kernel on a ray count that is no multiple of 32, with a
    third of the lanes inactive, launched twice with fresh batch
    counters: bitwise its plain version each time."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=28, device=cuda, wide=True)
    o, d, active = _rays(n, seed=n + 11, device=cuda)
    active[::3] = False
    args = sk.wide_args(scene, o, d, active)
    ref = sk.wide_closest_hit_plain(*args)
    for _ in range(2):
        _assert_equal(kernels.wide_closest_hit(*args), ref)
    assert (ref.t[~active] == MISS_T).all()


@pytest.mark.parametrize("kind", ["flat", "instanced", "frontier",
                                  "frontier_mxu", "frontier_closest",
                                  "frontier_closest_mxu", "wide"])
def test_skip_and_frontier_statistics_build(cuda, scene_paths, kind):
    """The statistics builds of the skip and wide kernels and of both
    frontier kernels: the plain versions' outputs and leaf visits, one
    traced ray per active lane, instance changes on the two-level scene
    only, no stack in the skip and wide walks; the frontier closest
    hit's count of visited nodes by hit internal children, the plain
    version's."""
    host = gltf.load(scene_paths["columns"])
    o, d, active = _rays(3000, seed=10, device=cuda)
    stats = {}
    if kind.startswith("frontier"):
        mxu = kind.endswith("mxu")
        scene = build_device_scene(host, max_leaf_size=14, device=cuda,
                                   mt="mxu" if mxu else "exact")
        args = fr.frontier_args(scene, o, d, active, mxu)
        if "closest" in kind:
            out, counters = kernels.frontier_stats(False, *args)
            _assert_equal(out, fr.frontier_closest_hit_plain(*args,
                                                             stats=stats))
        else:
            out, counters = kernels.frontier_stats(True, *args)
            assert torch.equal(out, fr.frontier_any_hit_plain(*args,
                                                              stats=stats))
    elif kind == "wide":
        scene = build_device_scene(host, max_leaf_size=28, device=cuda,
                                   wide=True)
        args = sk.wide_args(scene, o, d, active)
        out, counters = kernels.wide_stats(*args)
        _assert_equal(out, sk.wide_closest_hit_plain(*args, stats=stats))
    else:
        scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda)
                 if kind == "instanced" else
                 build_device_scene(host, max_leaf_size=28, device=cuda))
        args = sk.skip_args(scene, o, d, active)
        out, counters = kernels.skip_stats(*args)
        _assert_equal(out, sk.skip_closest_hit_plain(*args, stats=stats))
    c = dict(zip(kernels.STACK_STATS, counters))
    hist = counters[len(kernels.STACK_STATS):]
    assert c["rays"] == int(active.sum()) == sum(hist)
    assert c["leaf_visits"] == stats["leaf_visits"] > 0
    assert (c["instance_changes"] > 0) == (kind == "instanced")
    if kind.startswith("frontier"):
        assert 0 < c["deepest"] <= st.STACK_SLOTS[16]
    else:
        assert c["deepest"] == 0 and c["node_lanes"] == stats["node_visits"]
    if "closest" in kind:
        assert [c[f"inner_{k}"] for k in range(3)] == [
            stats[f"inner_{k}"] for k in range(3)]
    summary = kernels.summarize_stack_stats(counters)
    assert 0.0 < summary["simt_node"] <= 1.0
    assert 0.0 < summary["simt_leaf"] <= 1.0


@pytest.mark.parametrize("pair", ["pair+quad", "frontier+wide"])
def test_kernels_on_side_streams(cuda, scene_paths, pair):
    """Walk kernels launched on two streams that are not the default
    one, at once: each (device, stream) has its own batch counter, and
    both launches equal the plain versions."""
    host = gltf.load(scene_paths["columns"])
    o, d, active = _rays(20000, seed=31, device=cuda)
    if pair == "pair+quad":
        scene = build_instanced_scene(host, max_leaf_size=14, device=cuda)
        flat = build_device_scene(host, max_leaf_size=28, device=cuda)
        runs = ((kernels.pair_closest_hit, st.pair_closest_hit_plain,
                 st.pair_args(scene, o, d, active)),
                (kernels.quad_closest_hit, st.quad_closest_hit_plain,
                 st.quad_args(flat, o, d, active)))
    else:
        flat = build_device_scene(host, max_leaf_size=14, device=cuda,
                                  wide=True)
        runs = ((kernels.frontier_closest_hit, fr.frontier_closest_hit_plain,
                 fr.frontier_args(flat, o, d, active)),
                (kernels.wide_closest_hit, sk.wide_closest_hit_plain,
                 sk.wide_args(flat, o, d, active)))
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs = []
    for s, (fn, _, args) in zip(streams, runs):
        with torch.cuda.stream(s):
            outs.append(fn(*args))
    torch.cuda.synchronize()
    for out, (_, plain, args) in zip(outs, runs):
        _assert_equal(out, plain(*args))
    keys = {(o.device, s.cuda_stream) for s in streams}
    assert keys <= set(kernels._BATCHES)
    assert len({kernels._BATCHES[k].data_ptr() for k in keys}) == 2


def test_kernel_skips_empty_slots(cuda):
    """Empty slots whose boxes every ray hits: the kernel must not read
    them as leaf 0 (which holds a nearer triangle)."""
    def tri(z):
        return [-1.0, -1.0, z, 0.0, 4.0, 0.0, 4.0, 0.0, 0.0]

    leaves = torch.zeros((2, 4, 9))
    leaves[0, 0] = torch.tensor(tri(2.0))
    leaves[1, 0] = torch.tensor(tri(5.0))
    box = torch.zeros((1, 4, 6))
    box[0, 0] = torch.tensor([-1.0, -1.0, 5.0, 3.0, 3.0, 5.0])
    box[0, 1:] = torch.tensor([-1e3, -1e3, -1e3, 1e3, 1e3, 1e3])
    link = torch.tensor([[-2, st.EMPTY, st.EMPTY, st.EMPTY]],
                        dtype=torch.int32)
    n = 256
    o = torch.zeros((n, 3))
    o[:, :2] = torch.linspace(-0.5, 0.5, n)[:, None]
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    tabs = [x.to(cuda) for x in (box, link, leaves, o, d)]
    t_lane = st.lane_limits(n, None, cuda)
    t, tri_id, _, _ = kernels.quad_closest_hit(*tabs, t_lane)
    assert torch.allclose(t.cpu(), torch.full((n,), 5.0))
    assert (tri_id == 4).all()
    assert kernels.quad_any_hit(*tabs, t_lane).all()


def test_wrappers_count_launches_and_check_devices(cuda, scene_paths):
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=28, device=cuda)
    o, d, active = _rays(1024, seed=3, device=cuda)
    before = dict(st.LAUNCHES)
    st.quad_closest_hit(scene, o, d, active)
    st.quad_any_hit(scene, o, d, active)
    assert st.LAUNCHES["quad_closest_hit"] == before["quad_closest_hit"] + 1
    assert st.LAUNCHES["quad_any_hit"] == before["quad_any_hit"] + 1
    t_lane = st.lane_limits(1024, active, cuda)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kernels.quad_closest_hit(scene.quad_box, scene.quad_link,
                                 scene.leaves, o.cpu(), d, t_lane)
    with pytest.raises(ValueError, match="expected shape"):
        kernels.quad_any_hit(scene.quad_box, scene.quad_link, scene.leaves,
                             o, d[:10], t_lane)


@pytest.mark.parametrize("bounces", [2, 3])
def test_render_cuda_matches_cpu(cuda, scene_paths, bounces):
    _render_both(cuda, scene_paths, bounces, "auto")


@pytest.mark.parametrize("traversal", ["pallas_packet", "pallas8", "bvh"])
def test_traversal_render_cuda_matches_cpu(cuda, scene_paths, traversal):
    """The --traversal tiers on the card (skip / wide kernel, the per-ray
    walk in plain PyTorch) against the same tier on the CPU."""
    _render_both(cuda, scene_paths, 2, traversal)


@pytest.mark.parametrize("tiers", [
    dict(kernel_primary="oct", kernel_secondary="oct"),
    dict(kernel_primary="frontier", kernel_secondary="frontier",
         anyhit_kernel="frontier"),
    dict(kernel_primary="frontier", kernel_secondary="quad", mt="mxu"),
    dict(mt="mxu")])
def test_tier_render_cuda_matches_cpu(cuda, scene_paths, tiers):
    """The kernel tiers on the card against the same tiers on the CPU."""
    _render_both(cuda, scene_paths, 3, "auto", **tiers)


def _render_both(cuda, scene_paths, bounces, traversal, **tiers):
    """A whole frame on the card (kernels) vs on the CPU (plain
    versions): equal ray counts; radiance allclose 1e-5, since PyTorch's
    CUDA and CPU elementwise ops need not round alike (a CUDA division
    by a Python scalar is a reciprocal multiply)."""
    config = RenderConfig(num_samples=1, num_bounces=bounces,
                          resolution_x=96, resolution_y=72,
                          traversal=traversal, **tiers)
    cam = Camera(aspect_ratio=config.aspect_ratio,
                 position=np.asarray([0.0, 1.0, 0.9], np.float32))
    cam.set_orientation(yaw=180.0, pitch=0.0)
    images, rays = [], []
    for device in (cuda, torch.device("cpu")):
        scene = build_device_scene(gltf.load(scene_paths["cornell"]),
                                   max_leaf_size=14, device=device,
                                   wide=traversal == "pallas8",
                                   mt=config.mt)
        image, traced = RenderPipeline(scene, config).render_numpy(cam, 5)
        images.append(image)
        rays.append(traced)
    assert rays[0] == rays[1]
    np.testing.assert_allclose(images[0], images[1], rtol=1e-5, atol=1e-5)


def test_textured_golden_cuda_matches_cpu(cuda, scene_paths):
    """The ``textured`` golden configuration (tests/golden_utils.py:58-65:
    the textured sphere's close-up at 4 spp, 2 bounces, 64x64, leaf-4
    bake) on the card against the CPU: equal rays, radiance allclose
    1e-5, as ``_render_both``.  Textures, normal maps and the sample
    loop run on the card."""
    config = RenderConfig(num_samples=4, num_bounces=2, resolution_x=64,
                          resolution_y=64)
    cam = Camera(aspect_ratio=config.aspect_ratio,
                 position=np.asarray([0.55, 0.35, -1.75], np.float32))
    cam.set_orientation(yaw=-8.0, pitch=-10.0)
    images, rays = [], []
    for device in (cuda, torch.device("cpu")):
        scene = build_device_scene(gltf.load(scene_paths["sphere"]),
                                   max_leaf_size=4, device=device)
        assert scene.has_textures
        image, traced = RenderPipeline(scene, config).render_numpy(cam, 0)
        images.append(image)
        rays.append(traced)
    assert rays[0] == rays[1] > 4 * 64 * 64
    assert np.isfinite(images[0]).all() and images[0].std() > 0
    np.testing.assert_allclose(images[0], images[1], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def atrium_path(tmp_path_factory):
    from assets.procedural import make_atrium

    path = str(tmp_path_factory.mktemp("cuda_atrium") / "atrium.glb")
    make_atrium(path, detail=0.1)
    return path


JOINT_CASES = ("cornell_rr", "atrium_sorted", "atrium_instanced")


def _joint_batch(cuda, scene_paths, atrium_path, case):
    """A joint batch of 3 frames of ``case`` on the card in shading
    chunks of 3,000 lanes, and the launches it should make; returns
    run() -> (sum image, rays, launches made) and the expected launches
    as a function of the rays."""
    if case == "cornell_rr":
        scene = build_device_scene(gltf.load(scene_paths["cornell"]),
                                   max_leaf_size=14, device=cuda)
        cam = Camera(aspect_ratio=96 / 72,
                     position=np.asarray([0.0, 1.0, 0.9], np.float32))
        cam.set_orientation(yaw=180.0, pitch=0.0)
    else:
        host = gltf.load(atrium_path)
        scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda)
                 if case == "atrium_instanced" else
                 build_device_scene(host, max_leaf_size=28, device=cuda))
        assert scene.emissive_free
        cam = Camera(aspect_ratio=96 / 72)
        orbit_path(radius=4.5, height=2.2, duration=4.0,
                   center=(0.0, 1.2, 0.0)).apply(cam, 0.0)
    pos, hor, ver, fwd = pl.camera_tensors(cam, cuda)
    n, chunk = 96 * 72, 3000

    def run():
        before = dict(st.LAUNCHES)
        image, rays = pl.render_frames_joint(
            scene, pos, hor, ver, fwd, 2, batch=3,
            num_bounces=3 if case == "cornell_rr" else 2, width=96,
            height=72, sort_secondary=case != "cornell_rr",
            russian_roulette=case == "cornell_rr", chunk=chunk)
        return image, int(rays), {k: v - before[k]
                                  for k, v in st.LAUNCHES.items()
                                  if v != before[k]}

    def expect(rays):
        if case == "cornell_rr":    # unsorted: every lane, two bounces
            return {"pair_closest_hit": 1,
                    "quad_closest_hit": 2 * -(-3 * n // chunk)}
        kind = "pair" if case == "atrium_instanced" else "quad"
        return {f"{kind}_closest_hit": 1,
                f"{kind}_any_hit": -(-(rays - n) // chunk)}
    return run, expect


@pytest.mark.parametrize("case", JOINT_CASES)
def test_joint_batch_kernels_match_plain(cuda, scene_paths, atrium_path,
                                         case, monkeypatch):
    """The joint batch through the kernels (launched as its chunks say)
    against the same batch through the plain versions on the card:
    image and rays equal."""
    run, expect = _joint_batch(cuda, scene_paths, atrium_path, case)
    image_k, rays_k, launches = run()
    assert launches == expect(rays_k)

    def plain_dispatch(name, origin, plain, launch):
        return plain()

    for mod in (st, sk, fr):
        monkeypatch.setattr(mod, "_dispatch", plain_dispatch)
    image_p, rays_p, plain_launches = run()
    assert plain_launches == {}
    assert rays_k == rays_p > 96 * 72
    assert bool(torch.isfinite(image_k).all()) and image_k.mean() > 0
    assert torch.equal(image_k, image_p)


@pytest.mark.parametrize("case", JOINT_CASES)
def test_joint_batch_deterministic(cuda, scene_paths, atrium_path, case):
    """Two runs of the joint batch are bitwise equal (each lane's color
    goes back by its lane id, no atomics)."""
    run, _ = _joint_batch(cuda, scene_paths, atrium_path, case)
    first, rays, _ = run()
    second, rays2, _ = run()
    assert rays == rays2 and torch.equal(first, second)


def test_quad_launch_past_int32_offsets(cuda, scene_paths):
    """The quad kernels index rays in 64 bits: a launch of 2^31 / 3 +
    4,096 rays, where ``3 * ray`` passes 2^31, whose last 4,096 rays are
    live (the others inactive) gives on those the plain versions'
    results, and misses elsewhere."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=28, device=cuda)
    live = 4096
    n = 2 ** 31 // 3 + live
    o = torch.zeros((n, 3), dtype=torch.float32, device=cuda)
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    o_live, d_live, _ = _rays(live, seed=11, device=cuda)
    o[n - live:] = o_live
    d[n - live:] = d_live
    active = torch.zeros(n, dtype=torch.bool, device=cuda)
    active[n - live:] = True
    want = st.quad_closest_hit_plain(
        *st.quad_args(scene, o_live, d_live, None))
    assert bool((want.t < MISS_T).any())
    hit = st.quad_closest_hit(scene, o, d, active)
    for got, ref in zip(hit, want):
        assert torch.equal(got[n - live:], ref)
    assert bool((hit.t[:n - live] == MISS_T).all())
    assert bool((hit.tri[:n - live] == -1).all())
    del hit
    any_hit = st.quad_any_hit(scene, o, d, active)
    assert torch.equal(any_hit[n - live:], want.t < MISS_T)
    assert not bool(any_hit[:n - live].any())


def _pooled_group(device, scene_paths, atrium_path, case):
    """run() -> (images, rays) of a pooled group of 3 frames of 3
    cameras of ``case`` on ``device``, in shading chunks of 3,000 lanes
    (the scenes and settings of ``_joint_batch``)."""
    if case == "cornell_rr":
        scene = build_device_scene(gltf.load(scene_paths["cornell"]),
                                   max_leaf_size=14, device=device)
        cams = []
        for yaw in (180.0, 175.0, 185.0):
            cams.append(Camera(aspect_ratio=96 / 72, position=np.asarray(
                [0.0, 1.0, 0.9], np.float32)))
            cams[-1].set_orientation(yaw=yaw, pitch=0.0)
    else:
        host = gltf.load(atrium_path)
        scene = (build_instanced_scene(host, max_leaf_size=14, device=device)
                 if case == "atrium_instanced" else
                 build_device_scene(host, max_leaf_size=28, device=device))
        cams = []
        for t in (0.0, 1.3, 2.6):
            cams.append(Camera(aspect_ratio=96 / 72))
            orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0)).apply(cams[-1], t)
    pos, hor, ver, fwd = (torch.stack(v) for v in zip(
        *[pl.camera_tensors(cam, device) for cam in cams]))

    def run():
        images, rays = pl.render_frames_pooled(
            scene, pos, hor, ver, fwd, [2, 3, 5],
            num_bounces=3 if case == "cornell_rr" else 2, width=96,
            height=72, sort_secondary=case != "cornell_rr",
            russian_roulette=case == "cornell_rr", chunk=3000)
        return images, int(rays)
    return run


@pytest.mark.parametrize("case", JOINT_CASES)
def test_pooled_group_cuda_matches_cpu(cuda, scene_paths, atrium_path,
                                       case):
    """A pooled group through the kernels against the same group through
    the plain versions on the CPU: equal rays, radiance allclose 1e-5;
    two runs on the card are bitwise equal; every launch is at most one
    chunk (bounce 0's closest hits ceil(3N / 3,000))."""
    run = _pooled_group(cuda, scene_paths, atrium_path, case)
    before = dict(st.LAUNCHES)
    images, rays = run()
    launches = {k: v - before[k] for k, v in st.LAUNCHES.items()
                if v != before[k]}
    first_kind = "quad" if case == "atrium_sorted" else "pair"
    assert launches[f"{first_kind}_closest_hit"] == -(-3 * 96 * 72 // 3000)
    again, rays2 = run()
    assert rays == rays2 and torch.equal(images, again)
    ref, ref_rays = _pooled_group(torch.device("cpu"), scene_paths,
                                  atrium_path, case)()
    assert rays == ref_rays > 3 * 96 * 72
    assert bool(torch.isfinite(images).all()) and images.mean() > 0
    np.testing.assert_allclose(images.cpu().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


# -- dynamic geometry: refit, rebuild, mid-row empty slots ---------------------

def _moved_columns(path, device):
    """The columns' AnimatedScene (leaf 8, coefficient rows) at a pose
    with every instance lifted and turned, on ``device``."""
    from vulkan_pathtracer_tpu_torch.models.animation import (
        build_animated_scene,
    )

    anim = build_animated_scene(gltf.load(path), max_leaf_size=8,
                                device=device, mt="mxu")
    tf = anim.initial_transforms(gltf.load(path)).cpu()
    n = tf.shape[0]
    tf[:, 1, 3] += torch.linspace(-1.0, 1.0, n)
    c, s = float(np.cos(0.3)), float(np.sin(0.3))
    rot = torch.tensor([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                        [0, 0, 0, 1]], dtype=torch.float32)
    return anim, anim.with_transforms((rot @ tf).to(device))


def test_refit_on_card_kernels_match_plain(cuda, scene_paths):
    """with_transforms on the card: the refitted boxes hold their
    triangles and children, the coefficient rows are bitwise a host bake
    of the moved leaves, and the quad, oct, frontier and skip kernels on
    the regenerated tables equal their plain versions bitwise (exact and
    coefficient leaves)."""
    from vulkan_pathtracer_tpu_torch.ops.mxu_mt import build_mt_coef_rows
    from vulkan_pathtracer_tpu_torch.ops.refit import tree_violations

    _, moved = _moved_columns(scene_paths["columns"], cuda)
    assert tree_violations(moved) == (0, 0)
    fresh = build_mt_coef_rows(moved.leaves.cpu().numpy())
    assert np.array_equal(moved.tri_coefs.cpu().numpy().view(np.uint32),
                          fresh.view(np.uint32))
    assert moved.wide_nodes is None
    o, d, active = _rays(8192, seed=41, device=cuda)
    t_lane = st.lane_limits(o.shape[0], active, cuda)
    runs = [(kernels.quad_closest_hit, st.quad_closest_hit_plain,
             (moved.quad_box, moved.quad_link, moved.leaves, o, d, t_lane)),
            (kernels.quad_closest_hit, st.quad_closest_hit_plain,
             (moved.quad_box, moved.quad_link, moved.tri_coefs, o, d,
              t_lane)),
            (kernels.oct_closest_hit, st.oct_closest_hit_plain,
             (moved.oct_box, moved.oct_link, moved.leaves, o, d, t_lane)),
            (kernels.skip_closest_hit, sk.skip_closest_hit_plain,
             sk.skip_args(moved, o, d, active)),
            (kernels.frontier_closest_hit, fr.frontier_closest_hit_plain,
             fr.frontier_args(moved, o, d, active, True))]
    for launch, plain, args in runs:
        _assert_equal(launch(*args), plain(*args))
    args = st.quad_args(moved, o, d, active)
    assert torch.equal(kernels.quad_any_hit(*args),
                       st.quad_any_hit_plain(*args))


def test_rebuild_on_card_equals_cpu(cuda, scene_paths):
    """device_rebuild_scene on the card: the tree and tables bitwise the
    same rebuild on the CPU; the quad and pair kernels on the rebuilt
    rows (empty slots mid-row) bitwise their plain versions."""
    from vulkan_pathtracer_tpu_torch.ops.device_build import (
        device_rebuild_scene,
    )

    host = gltf.load(scene_paths["columns"])
    scenes = [build_device_scene(host, max_leaf_size=8, device=dev,
                                 build_bvh=False, mt="exact")
              for dev in ("cpu", cuda)]
    out = []
    for sc in scenes:
        v0 = sc.tri_v0 + torch.tensor([0.7, -0.3, 0.4], device=sc.device)
        out.append(device_rebuild_scene(sc, v0, sc.tri_e1, sc.tri_e2,
                                        sc.tri_gn, sc.tri_attr))
    cpu, card = out
    for f in ("tri_v0", "leaves", "pair_box", "pair_link", "quad_box",
              "quad_link", "root_lo", "root_hi"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert torch.equal(card.skip_nodes.cpu().view(torch.int32),
                       cpu.skip_nodes.view(torch.int32))
    for f in ("left", "right", "perm", "quad_src"):
        assert torch.equal(getattr(card.tree, f).cpu(),
                           getattr(cpu.tree, f)), f
    empty = card.quad_link == st.EMPTY
    assert (empty[:, :-1] & ~empty[:, 1:]).any()
    o, d, active = _rays(8192, seed=43, device=cuda)
    for fam in ("quad", "pair"):
        args = getattr(st, f"{fam}_args")(card, o, d, active)
        _assert_equal(getattr(kernels, f"{fam}_closest_hit")(*args),
                      getattr(st, f"{fam}_closest_hit_plain")(*args))
        assert torch.equal(getattr(kernels, f"{fam}_any_hit")(*args),
                           getattr(st, f"{fam}_any_hit_plain")(*args))


@pytest.mark.parametrize("table", ["quad", "frontier"])
def test_kernels_skip_mid_row_empty_slots(cuda, scene_paths, table):
    """Each row's slots rotated so empty slots sit before live ones, and
    a spare leaf block 0 that no live link names: the kernels never
    reach it (t and the any-hit bit those of the unrotated tables)."""
    scene = build_device_scene(gltf.load(scene_paths["columns"]),
                               max_leaf_size=4, device=cuda)
    box, link = getattr(scene, f"{table}_box"), getattr(scene, f"{table}_link")
    leaf = (link < 0) & (link != st.EMPTY)
    rlink = torch.roll(torch.where(leaf, link - 1, link), 1, dims=1)
    rbox = torch.roll(box, 1, dims=1).contiguous()
    rleaves = torch.cat([torch.zeros_like(scene.leaves[:1]), scene.leaves])
    o, d, active = _rays(8192, seed=47, device=cuda)
    t_lane = st.lane_limits(o.shape[0], active, cuda)
    closest = {"quad": kernels.quad_closest_hit,
               "frontier": kernels.frontier_closest_hit}[table]
    anyhit = {"quad": kernels.quad_any_hit,
              "frontier": kernels.frontier_any_hit}[table]
    want = closest(box, link, scene.leaves, o, d, t_lane)
    got = closest(rbox, rlink.contiguous(), rleaves, o, d, t_lane)
    assert torch.equal(got[0], want[0])
    assert torch.equal(anyhit(rbox, rlink.contiguous(), rleaves, o, d,
                              t_lane),
                       anyhit(box, link, scene.leaves, o, d, t_lane))


@pytest.mark.parametrize("mode", ["tiles", "spp"])
def test_nccl_world_one_matches_render_pipeline(cuda, scene_paths,
                                                atrium_path, mode):
    """A real NCCL group of one rank, formed in this process: the
    sharded frame (the atrium at 128x96, leaf 28, 2 bounces; spp at one
    rank has frame seed frame * 1 + 0) is bitwise RenderPipeline's, the
    rays equal; the pooled sharded wavefront of 2 cameras, rebalanced
    (the exchange's all_to_all on one rank), bitwise
    ``trace_wavefront_pooled``."""
    from vulkan_pathtracer_tpu_torch.parallel import distributed
    from vulkan_pathtracer_tpu_torch.parallel.mesh import make_render_group
    from vulkan_pathtracer_tpu_torch.parallel.rebalance import (
        make_pooled_sharded_render,
    )
    from vulkan_pathtracer_tpu_torch.parallel.sharding import (
        ShardedRenderPipeline,
    )
    from vulkan_pathtracer_tpu_torch.render.wavefront import (
        trace_wavefront_pooled,
    )

    distributed.form_group(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           "cuda")
    try:
        group = make_render_group("cuda")
        assert group.world == 1 and group.group is not None
        scene = build_device_scene(gltf.load(atrium_path), max_leaf_size=28,
                                   device=group.device)
        config = RenderConfig(num_samples=1, num_bounces=2,
                              resolution_x=128, resolution_y=96)
        cams = []
        for t in (0.0, 1.3):
            cams.append(Camera(aspect_ratio=config.aspect_ratio))
            orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0)).apply(cams[-1], t)
        ref, ref_rays = RenderPipeline(scene, config).render(cams[0], 3)
        got, rays = ShardedRenderPipeline(scene, config, group,
                                          mode).render(cams[0], 3)
        assert torch.equal(got, ref) and int(rays) == int(ref_rays)
        prims = [pl.primary_rays(*pl.camera_tensors(cam, group.device), 4,
                                 128, 96)[:4] for cam in cams]
        lanes = [torch.cat([p[i] for p in prims]) for i in range(4)]
        ref, ref_rays = trace_wavefront_pooled(scene, *lanes, num_bounces=2)
        got, rays = make_pooled_sharded_render(
            group, scene, num_bounces=2, rebalance=True)(scene, *lanes)
        assert torch.equal(got, ref) and int(rays) == int(ref_rays)
    finally:
        torch.distributed.destroy_process_group()


# The channel builds (a seeded or windowed closest hit): (kernel family,
# scene kind, coefficient leaves, t-window).
CHANNEL_CASES = [("quad", "flat", False, False), ("quad", "flat", True, False),
                 ("oct", "flat", False, False), ("pair", "flat", False, True),
                 ("pair", "flat", True, True),
                 ("pair", "instanced", False, True),
                 ("pair", "instanced", True, True),
                 ("frontier", "flat", False, True),
                 ("frontier", "flat", True, True),
                 ("skip", "flat", False, True),
                 ("skip", "instanced", False, True),
                 ("wide", "flat", False, False)]


@pytest.fixture(scope="module")
def channel_scenes(cuda, scene_paths):
    host = gltf.load(scene_paths["columns"])
    return {"flat": build_device_scene(host, max_leaf_size=14, device=cuda,
                                       mt="mxu", wide=True),
            "instanced": build_instanced_scene(host, max_leaf_size=14,
                                               device=cuda, mt="mxu")}


def _channel_plain(kernel, scene, o, d, active, coef, seed=None,
                   t_near=None, t_far=None):
    """The plain version of closest hit ``kernel`` on the rays' device,
    with the arguments its wrapper gives the kernel (``t_far`` folded
    into t_lane)."""
    t_lane = st.lane_limits(o.shape[0], active, o.device, t_far)
    if kernel in ("skip", "wide"):
        args = list((sk.skip_args if kernel == "skip" else sk.wide_args)(
            scene, o, d, active))
        args[4] = t_lane
    else:
        args = list({"quad": st.quad_args, "pair": st.pair_args,
                     "frontier": fr.frontier_args,
                     "oct": lambda s_, o_, d_, a_, c_: (
                         s_.oct_box, s_.oct_link, s_.leaves, o_, d_, None)}[
                             kernel](scene, o, d, active, coef))
        args[5] = t_lane
    plain = getattr({"skip": sk, "wide": sk, "frontier": fr}.get(kernel, st),
                    f"{kernel}_closest_hit_plain")
    return plain(*args, **st.channel_args(o, seed, t_near))


@pytest.mark.parametrize("kernel,kind,coef,window", CHANNEL_CASES)
def test_channel_builds_match_plain(cuda, channel_scenes, kernel, kind, coef,
                                    window):
    """Each channel build through its wrapper, bitwise its plain version
    on the card: seeded with the unseeded hit (then bitwise the unseeded
    launch), seeded with ``leaf_seed_hit`` of it, and (pair, frontier,
    skip) windowed to [median t, 2 x median t); an inactive lane returns
    its seed."""
    from vulkan_pathtracer_tpu_torch.ops.intersect import leaf_seed_hit

    scene = channel_scenes[kind]
    wrapper = getattr({"skip": sk, "wide": sk, "frontier": fr}.get(
        kernel, st), f"{kernel}_closest_hit")
    kw = {"coef": True} if coef else {}
    o, d, active = _rays(8192, seed=77, device=cuda)
    before = st.LAUNCHES[f"{kernel}_closest_hit{'_coef' if coef else ''}"
                         "_chan"]
    ref = wrapper(scene, o, d, active, **kw)
    _assert_equal(ref, _channel_plain(kernel, scene, o, d, active, coef))
    _assert_equal(wrapper(scene, o, d, active, seed=ref, **kw), ref)
    blocks = torch.clamp(ref.tri, min=0) // scene.max_leaf_size
    seed = leaf_seed_hit(scene, o, d, blocks, active)
    seed = type(seed)(*(torch.where(active, x, torch.full_like(x, f))
                        for x, f in zip(seed, (5.0, 123, 0.25, 0.5))))
    got = wrapper(scene, o, d, active, seed=seed, **kw)
    _assert_equal(got, _channel_plain(kernel, scene, o, d, active, coef,
                                      seed=seed))
    assert torch.equal(got.tri[~active], seed.tri[~active])
    launched = 2
    if window:
        t_near = float(ref.t[ref.t < MISS_T].median())
        got = wrapper(scene, o, d, active, t_near=t_near, t_far=2 * t_near,
                      **kw)
        _assert_equal(got, _channel_plain(kernel, scene, o, d, active, coef,
                                          t_near=t_near, t_far=2 * t_near))
        hit = got.t < MISS_T
        assert int(hit.sum()) > 0
        assert ((got.t[hit] >= t_near) & (got.t[hit] < 2 * t_near)).all()
        launched += 1
    assert st.LAUNCHES[f"{kernel}_closest_hit{'_coef' if coef else ''}"
                       "_chan"] == before + launched


def test_nccl_world_one_viewer(cuda, scene_paths):
    """The multi-rank viewer on a real NCCL group of one rank: under the
    scripted look keys its text is byte for byte the single-device
    viewer's, after the same number of frames."""
    import io

    from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
    from vulkan_pathtracer_tpu_torch.parallel import distributed
    from vulkan_pathtracer_tpu_torch.parallel.mesh import make_render_group
    from vulkan_pathtracer_tpu_torch.parallel.sharding import (
        ShardedRenderPipeline,
    )

    distributed.form_group(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           "cuda")
    try:
        group = make_render_group("cuda")
        scene = build_device_scene(gltf.load(scene_paths["cornell"]),
                                   max_leaf_size=4, device=group.device)
        config = RenderConfig(num_samples=1, num_bounces=2,
                              resolution_x=24, resolution_y=16)
        texts, counts = [], []
        for pipe, grp in ((RenderPipeline(scene, config), None),
                          (ShardedRenderPipeline(scene, config, group),
                           group)):
            out = io.StringIO()
            counts.append(run_viewer(
                pipe, Camera(aspect_ratio=config.aspect_ratio,
                             position=np.asarray([0.0, 1.0, 2.5],
                                                 np.float32)),
                out=out, keys=io.StringIO("jlikq"), group=grp))
            texts.append(out.getvalue())
        assert counts == [5, 5] and texts[0] == texts[1]
    finally:
        torch.distributed.destroy_process_group()


def _scene_camera(scene, aspect):
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    extent = float((hi - lo).max())
    cam = Camera(aspect_ratio=aspect)
    orbit_path(radius=0.75 * extent, height=0.35 * extent, duration=4.0,
               center=tuple((lo + hi) * 0.5)).apply(cam, 0.5)
    return cam


@pytest.mark.parametrize("path", ["frame", "joint", "pooled"])
@pytest.mark.parametrize("scene_name,instanced", [
    ("columns", False), ("columns", True), ("cornell", False),
    ("cornell", True), ("sphere", False), ("sphere", True)])
def test_shading_kernels_match_plain_chain(cuda, scene_paths, monkeypatch,
                                           scene_name, instanced, path):
    """Frames, joint batches and pooled groups through the shading
    kernels (``ops/shade.py``) bitwise the plain chain run on the card
    (``shade.fused`` off), with the scene's own builds counted: the
    columns, taken as emissive-free, the any-hit sky; the Cornell box
    and the textured sphere (its textures and normal map, through the
    textured builds) Russian roulette from bounce 1 and the emissive
    last bounce."""

    host = gltf.load(scene_paths[scene_name])
    scene = (build_instanced_scene(host, max_leaf_size=14, device=cuda)
             if instanced else
             build_device_scene(host, max_leaf_size=14, device=cuda))
    emissive = scene_name != "columns"
    if not emissive:
        scene = dataclasses.replace(scene, emissive_free=True)
    config = RenderConfig(num_samples=1, num_bounces=3 if emissive else 2,
                          resolution_x=96, resolution_y=72,
                          russian_roulette=emissive, rr_start_bounce=1)
    pipe = RenderPipeline(scene, config)
    cams = [_scene_camera(scene, config.aspect_ratio) for _ in range(2)]
    cams[1].position = cams[1].position * np.float32(0.9)
    run = {"frame": lambda: pipe.render(cams[0], 5),
           "joint": lambda: pipe.render_batch_sum(cams[0], 5, 3),
           "pooled": lambda: pipe.render_pooled(cams, [5, 6])}[path]
    before = dict(shade.LAUNCHES)
    image, rays = run()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in shade.LAUNCHES.items()
                if v != before[k]}
    monkeypatch.setattr(shade, "fused", lambda x: False)
    plain_image, plain_rays = run()
    assert shade.LAUNCHES == {k: before[k] + launched.get(k, 0)
                              for k in before}
    assert int(rays) == int(plain_rays) > image.shape[0] * image.shape[1]
    assert torch.equal(image.view(torch.int32),
                       plain_image.view(torch.int32))
    suffix = ("_instanced" if instanced else "") + (
        "_textured" if scene_name == "sphere" else "")
    builds = {k.removesuffix("_rr").removesuffix("_last") for k in launched
              if k.startswith(("shade_extend", "pixel_shade"))}
    assert f"shade_extend{suffix}" in builds or path == "joint"
    assert builds <= {f"shade_extend{suffix}", f"pixel_shade{suffix}"}
    assert ("pixel_shade" + suffix in launched) == (path == "joint")
    assert ("anyhit_sky" in launched) != emissive
