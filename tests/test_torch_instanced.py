"""PyTorch port vs JAX: the two-level (``--instanced``) path on the CPU.

Held to the JAX package:

- the bake (models/instanced_scene.build_instanced_scene) against JAX
  ``build_instanced_scene``: pair tables, ``inst_inv``, ``inst_nrm``,
  ``mb_bits``, leaves and ``tri_attr`` bitwise equal after the layout
  conversion, on the columns fixture (17 instances sharing meshes), a
  mirrored two-instance box and an emissive-free atrium;
- the plain pair closest hit against ``pallas_pair_closest_hit`` in
  interpret mode (as tests/test_instanced.py:216-246 runs it) on a flat
  and an instanced scene: t within 1e-5, tri agreement > 0.999 — the
  JAX suite's own tolerances, since the packet kernel visits in union
  order and equal-t ties may resolve to another triangle;
- the plain pair any hit against ``pallas_pair_any_hit`` (interpret)
  and against the port's closest-hit mask: exactly, with an active mask;
- the instanced hit decode of ``get_triangle_data`` against JAX's on
  the same hits: ids equal, normals within 1e-5 (XLA sums the normal
  matrix product in its own order);
- ``update_instance_transforms`` against JAX's and against a fresh
  bake of the moved scene;
- a 48x27 instanced atrium frame against JAX ``render_frame(traversal=
  "pallas")``: ray counts equal, image allclose 1e-5 (the bound of
  tests/test_torch_render.py: XLA and PyTorch need not round the
  shading chain's sin/cos/rsqrt alike).
"""

import copy
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_scene import jax_scene_arrays
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_flat,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene as jax_inst,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    update_instance_transforms as jax_update,
)
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops.intersect import Hit as JaxHit
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
    update_instance_transforms,
)
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import brute_force_closest_hit
from vulkan_pathtracer_tpu_torch.render import wavefront

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

LEAF = 8


@pytest.fixture(scope="module")
def mirrored_glb():
    """One box mesh, two instances: identity-scaled and X-mirrored
    (tests/test_instanced.py:188-213)."""
    from assets import procedural as pr

    prim = pr.box_prim((0, 0, 0), (1, 1, 1), 0)
    mats = [pr.MaterialDesc(base_color=(1, 0, 0, 1))]
    nodes = [pr.NodeDesc(mesh=0, translation=(-1.5, 0, 0)),
             pr.NodeDesc(mesh=0, translation=(1.5, 0, 0),
                         scale=(-1.0, 1.0, 1.0))]
    path = tempfile.mktemp(suffix=".glb")
    pr.write_glb(path, meshes=[[prim]], materials=mats, nodes=nodes)
    return path


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    """Small emissive-free atrium: one mesh per material, 32 instances."""
    from assets.procedural import make_atrium

    path = tmp_path_factory.mktemp("inst") / "atrium.glb"
    make_atrium(str(path), detail=0.08)
    return str(path)


SCENES = {"columns": "columns_glb", "mirrored": "mirrored_glb",
          "atrium": "atrium_glb"}


@pytest.fixture(scope="module")
def bakes(request):
    """name -> (JAX instanced bake, port instanced bake) of a fixture
    scene, each baked once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            path = request.getfixturevalue(SCENES[name])
            cache[name] = (
                jax_inst(jgltf.load(path), max_leaf_size=LEAF),
                build_instanced_scene(gltf.load(path), max_leaf_size=LEAF,
                                      device="cpu"))
        return cache[name]
    return get


def _rays(n, seed, lo=-10.0, hi=10.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(lo / 5, hi / 5, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


def _assert_hits_close(got, ref, keep=slice(None)):
    assert np.array_equal(got.t.numpy()[keep] < MISS_T,
                          np.asarray(ref.t)[keep] < MISS_T)
    np.testing.assert_allclose(got.t.numpy()[keep], np.asarray(ref.t)[keep],
                               rtol=1e-5, atol=1e-5)
    assert (got.tri.numpy()[keep] == np.asarray(ref.tri)[keep]).mean() > 0.999


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bake_matches_jax(bakes, name, request):
    jd, td = bakes(name)
    rows = np.asarray(jd.bvh_pair)
    assert np.array_equal(td.pair_box.numpy(),
                          rows[:, :12].reshape(-1, 2, 6))
    assert np.array_equal(td.pair_link.numpy(),
                          rows[:, 12:14].astype(np.int64))
    for f in ("inst_inv", "inst_nrm", "tri_attr", "tri_v0", "tri_gn"):
        assert np.array_equal(getattr(td, f).numpy().view(np.uint8),
                              np.asarray(getattr(jd, f)).view(np.uint8)), f
    assert np.array_equal(td.leaves.numpy().reshape(td.leaves.shape[0], -1),
                          np.asarray(jd.tri_blocks))
    assert td.mb_bits == jd.mb_bits and td.instanced
    assert td.bvh_depth == jd.bvh_depth
    assert td.emissive_free == jd.emissive_free
    assert td.num_triangles == jd.num_triangles
    packed = np.asarray(jd.bvh_packed)
    assert np.array_equal(td.root_lo.numpy(), packed[0, 0:3])
    assert np.array_equal(td.root_hi.numpy(), packed[0, 3:6])
    # The bridge carries a JAX instanced scene across unchanged.
    arrays, meta = jax_scene_arrays(jd)
    meta.update(instanced=True, mb_bits=jd.mb_bits)
    bridged = scene_from_jax_arrays(arrays, meta, "cpu")
    for f in ("pair_box", "pair_link", "leaves", "inst_inv", "inst_nrm",
              "tri_attr", "root_lo", "root_hi"):
        assert torch.equal(getattr(bridged, f), getattr(td, f)), f
    assert bridged.quad_box is None and bridged.mb_bits == td.mb_bits


def test_flat_pair_tables_match_jax(columns_glb):
    """The flat bake's pair table (build_pair_tables) equals the JAX
    flat bake's bvh_pair, and the bridge converts it to the same."""
    jd = jax_flat(jgltf.load(columns_glb), build_bvh=True,
                  max_leaf_size=14)
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=14,
                            device="cpu")
    rows = np.asarray(jd.bvh_pair)
    assert np.array_equal(td.pair_box.numpy(),
                          rows[:, :12].reshape(-1, 2, 6))
    assert np.array_equal(td.pair_link.numpy(),
                          rows[:, 12:14].astype(np.int64))
    bridged = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    assert torch.equal(bridged.pair_box, td.pair_box)
    assert torch.equal(bridged.pair_link, td.pair_link)
    assert not bridged.instanced


@pytest.fixture(scope="module")
def flat_pair(columns_glb):
    jd = jax_flat(jgltf.load(columns_glb), build_bvh=True,
                  max_leaf_size=LEAF)
    return jd, build_device_scene(gltf.load(columns_glb),
                                  max_leaf_size=LEAF, device="cpu")


def _scene(kind, request):
    if kind == "flat":
        return request.getfixturevalue("flat_pair")
    return request.getfixturevalue("bakes")("columns")


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_pair_closest_matches_pallas(kind, request):
    jd, td = _scene(kind, request)
    o, d = _rays(1024, seed=21)
    active = np.random.default_rng(2).random(1024) < 0.8
    ref = pp.pallas_pair_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(active), interpret=True,
                                     packet=512)
    got = st.pair_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(active))
    assert 100 < int((got.t < MISS_T).sum()) < 1024
    _assert_hits_close(got, ref)
    assert (got.tri.numpy()[~active] == -1).all()


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_pair_anyhit_matches_pallas(kind, request):
    jd, td = _scene(kind, request)
    o, d = _rays(1024, seed=23)
    active = np.arange(1024) % 4 != 0
    ref = pp.pallas_pair_any_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(active), interpret=True,
                                 packet=512)
    o_t, d_t, a_t = map(torch.from_numpy, (o, d, active))
    got = st.pair_any_hit(td, o_t, d_t, a_t)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    closest = st.pair_closest_hit(td, o_t, d_t, a_t)
    assert torch.equal(got, closest.t < MISS_T)
    assert not got[~a_t].any()


def test_instanced_matches_flat_bake(bakes, request):
    """The two-level traversal finds the flat bake's hits (the flat
    bake holds every instance's triangles in world space)."""
    path = request.getfixturevalue("columns_glb")
    _, td = bakes("columns")
    flat = build_device_scene(gltf.load(path), max_leaf_size=LEAF,
                              device="cpu")
    o, d = map(torch.from_numpy, _rays(1024, seed=25))
    got = st.pair_closest_hit(td, o, d)
    ref = st.quad_closest_hit(flat, o, d)
    assert torch.equal(got.t < MISS_T, ref.t < MISS_T)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mirrored_instance_culling(bakes, request):
    """A negative-determinant instance keeps world-space backface
    culling (det_sign): hits equal the flat bake's, on both boxes."""
    path = request.getfixturevalue("mirrored_glb")
    _, td = bakes("mirrored")
    assert td.inst_inv[:, 12].tolist() == [1.0, -1.0]
    flat = build_device_scene(gltf.load(path), max_leaf_size=LEAF,
                              device="cpu")
    o, d = map(torch.from_numpy, _rays(800, seed=27, lo=-4.0, hi=4.0))
    got = st.pair_closest_hit(td, o, d)
    ref = brute_force_closest_hit(flat, o, d)
    hit = ref.t < MISS_T
    assert torch.equal(got.t < MISS_T, hit)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    inst = (got.tri[hit] // LEAF) >> td.mb_bits
    assert set(inst.tolist()) == {0, 1}
    occ = st.pair_any_hit(td, o, d)
    assert torch.equal(occ, hit)


def test_triangle_data_matches_jax(bakes, request):
    from vulkan_pathtracer_tpu.render.shading import (
        get_triangle_data as jax_tri_data,
    )
    from vulkan_pathtracer_tpu_torch.render.shading import get_triangle_data

    jd, td = bakes("columns")
    o, d = map(torch.from_numpy, _rays(900, seed=29))
    hit = st.pair_closest_hit(td, o, d)
    mask = (hit.t < MISS_T).numpy()
    assert mask.sum() > 100
    got = get_triangle_data(td, hit)
    ref = jax_tri_data(jd, JaxHit(*(jnp.asarray(x.numpy()) for x in hit)))
    for f in ("material_index", "primitive_index", "triangle_index"):
        assert np.array_equal(getattr(got, f).numpy()[mask],
                              np.asarray(getattr(ref, f))[mask]), f
    for f in ("normal", "tangent", "geometry_normal", "uv"):
        np.testing.assert_allclose(getattr(got, f).numpy()[mask],
                                   np.asarray(getattr(ref, f))[mask],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_update_instance_transforms(bakes, request):
    """Moving instances on the device: the tables equal JAX's update,
    and the hits equal a fresh bake of the moved scene."""
    path = request.getfixturevalue("columns_glb")
    jd, td = bakes("columns")
    host = gltf.load(path)
    transforms = np.stack([i.transform for i in host.instances]).astype(
        np.float64)
    transforms[:, :3, 3] += np.random.default_rng(5).uniform(
        -1.5, 1.5, size=(len(host.instances), 3))
    moved = update_instance_transforms(td, transforms)
    assert not torch.equal(moved.pair_box, td.pair_box)

    ref = jax_update(jd, transforms)
    rows = np.asarray(ref.bvh_pair)
    np.testing.assert_allclose(moved.pair_box.numpy(),
                               rows[:, :12].reshape(-1, 2, 6), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(moved.inst_inv.numpy(),
                               np.asarray(ref.inst_inv), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(moved.pair_link, td.pair_link)

    host2 = copy.deepcopy(host)
    for inst, m in zip(host2.instances, transforms):
        inst.transform = m.astype(np.float32)
    fresh = build_instanced_scene(host2, max_leaf_size=LEAF, device="cpu")
    o, d = map(torch.from_numpy, _rays(1024, seed=31))
    got = st.pair_closest_hit(moved, o, d)
    want = st.pair_closest_hit(fresh, o, d)
    assert torch.equal(got.t < MISS_T, want.t < MISS_T)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (got.tri == want.tri).float().mean() > 0.999
    # Unchanged transforms give back the bake's boxes.
    same = update_instance_transforms(
        td, np.stack([i.transform for i in host.instances]))
    np.testing.assert_allclose(same.pair_box.numpy(), td.pair_box.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_root_leaf_scene(box_glb):
    """One instance of a 12-triangle box at leaf 14: TLAS and BLAS are
    single leaves, JAX has no pair rows; the port stores one row with
    the leaf in both slots and traces it exactly."""
    td = build_instanced_scene(gltf.load(box_glb), max_leaf_size=14,
                               device="cpu")
    assert td.pair_box.shape == (1, 2, 6)
    assert (td.pair_link == td.pair_link[0, 0]).all()
    flat = build_device_scene(gltf.load(box_glb), max_leaf_size=14,
                              device="cpu")
    o, d = map(torch.from_numpy, _rays(256, seed=33))
    o = o * 0.1  # inside the box
    got = st.pair_closest_hit(td, o, d)
    ref = brute_force_closest_hit(flat, o, d)
    assert torch.equal(got.t, ref.t)
    assert (got.t < MISS_T).sum() > 128


def test_pair_tables_reject_deep_trees():
    """A preorder chain deeper than STACK_CAP is refused."""
    n = 2 * 100 + 1
    leaf_value = np.full(n, -1, np.int64)
    skip = np.zeros(n, np.int64)
    for i in range(100):
        leaf_value[2 * i + 1] = i          # left child: a leaf
        skip[2 * i + 1] = 2 * i + 2        # its right sibling
    leaf_value[n - 1] = 100
    box = np.zeros((n, 3), np.float32)
    with pytest.raises(ValueError, match="exceeds the per-ray stack"):
        st.build_pair_tables_preorder(box, box + 1, skip, leaf_value)
    box_t, link, src = st.build_pair_tables_preorder(
        box[:41], box[:41] + 1, skip[:41], np.r_[leaf_value[:40], 20])
    assert link.dtype == np.int32 and box_t.shape == (20, 2, 6)
    assert (src[:, 0] == np.arange(20) * 2 + 1).all()


def test_dispatch_takes_pair_kernels(bakes, request, monkeypatch):
    """Two-level scenes dispatch to the pair wrappers, flat ones to the
    quad wrappers (sorted and unsorted)."""
    _, td = bakes("columns")
    calls = []
    for name in ("pair_closest_hit", "pair_any_hit", "quad_closest_hit",
                 "quad_any_hit"):
        fn = getattr(st, name)
        monkeypatch.setattr(st, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    o, d = map(torch.from_numpy, _rays(256, seed=35))
    act = torch.ones(256, dtype=torch.bool)
    wavefront._closest_hit(td, o, d, act)
    wavefront._any_hit_sorted(td, o, d, act)
    assert calls == ["pair_closest_hit", "pair_any_hit"]


def test_instanced_frame_matches_jax(bakes, request):
    from vulkan_pathtracer_tpu.app.camera_path import orbit_path
    from vulkan_pathtracer_tpu.render.pipeline import render_frame as jrf
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.render.pipeline import (
        camera_tensors,
        render_frame,
    )

    jd, td = bakes("atrium")
    assert td.emissive_free
    cam = Camera(aspect_ratio=48 / 27)
    orbit_path(radius=4.5, height=2.2, duration=4.0,
               center=(0.0, 1.2, 0.0)).apply(cam, 0.0)
    kw = dict(num_samples=1, num_bounces=2, width=48, height=27)
    ref, ref_rays = jrf(jd, *(jnp.asarray(v) for v in cam.push_constants()),
                        jnp.uint32(3), traversal="pallas", **kw)
    got, rays = render_frame(td, *camera_tensors(cam, "cpu"), 3,
                             sort_secondary=True, **kw)
    assert int(rays) == int(ref_rays) > 48 * 27
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
