"""PyTorch port vs JAX: the plain versions of the quad-BVH kernels.

On the CPU the traversal wrappers run their plain PyTorch versions
(ops/stack_traverse.py), which perform the CUDA kernels' float
operations in the same order.  Held here to the JAX package:

- closest hit vs the XLA traversal ``bvh_closest_hit`` with the
  tolerances the JAX suite holds its own kernels to
  (test_leaf28.py:72-82): traversal order differs, so ties between
  equal-t triangles on shared edges may resolve to another triangle —
  t allclose 1e-5, tri agreement > 0.999, u allclose 1e-4 / 1e-5;
- any hit vs the Pallas any-hit kernel in interpret mode
  (``pallas_quad_any_hit(interpret=True, packet=512,
  hbm_leaves=True)``, as test_leaf28.py:94-99 runs it): exactly, on
  the columns and on a small atrium (primary and bounce rays), though
  the port's any hit visits hit children in slot order and JAX's
  near-first;
- an active mask, a root-leaf tree, and a hand-made tree whose empty
  slots have boxes every ray would hit: EMPTY must keep the ray out
  (the JAX rows' empty enc -1 means "leaf 0").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_scene import jax_scene_arrays
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops.intersect import MISS_T
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import brute_force_closest_hit

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")


@pytest.fixture(scope="module")
def scenes28(request):
    jd = jax_build(jgltf.load(request.getfixturevalue("columns_glb")),
                   build_bvh=True, max_leaf_size=28)
    return jd, scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


def _assert_hits_close(got, ref, keep=None):
    keep = slice(None) if keep is None else keep
    np.testing.assert_allclose(got.t.numpy()[keep], np.asarray(ref.t)[keep],
                               rtol=1e-5, atol=1e-5)
    assert (got.tri.numpy()[keep] == np.asarray(ref.tri)[keep]).mean() > 0.999
    np.testing.assert_allclose(got.u.numpy()[keep], np.asarray(ref.u)[keep],
                               rtol=1e-4, atol=1e-5)


def test_closest_matches_xla(scenes28):
    jd, td = scenes28
    o, d = _rays(1024, seed=3)
    ref = bvh_closest_hit(jd, jnp.asarray(o), jnp.asarray(d))
    got = st.quad_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(ref.t) < MISS_T
    assert 100 < hit.sum() < 1024
    assert np.array_equal(got.t.numpy() < MISS_T, hit)
    _assert_hits_close(got, ref)


def test_anyhit_matches_pallas_interpret(scenes28):
    jd, td = scenes28
    o, d = _rays(1024, seed=9)
    ref = pp.pallas_quad_any_hit(jd, jnp.asarray(o), jnp.asarray(d),
                                 interpret=True, packet=512,
                                 hbm_leaves=True)
    got = st.quad_any_hit(td, torch.from_numpy(o), torch.from_numpy(d))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    closest = st.quad_closest_hit(td, torch.from_numpy(o),
                                  torch.from_numpy(d))
    assert np.array_equal(got.numpy(), closest.t.numpy() < MISS_T)


@pytest.fixture(scope="module")
def atrium28(tmp_path_factory):
    from assets.procedural import make_atrium

    path = str(tmp_path_factory.mktemp("atrium") / "atrium.glb")
    make_atrium(path, detail=0.1)
    jd = jax_build(jgltf.load(path), build_bvh=True, max_leaf_size=28)
    return jd, scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")


def _atrium_rays(td, kind, n=768, seed=21):
    """Rays inside the atrium (bench.py's interior orbit region):
    ``primary`` from one eye point, ``bounce`` from the primaries' hit
    points in random directions of the upper hemisphere."""
    rng = np.random.default_rng(seed)
    eye = np.array([3.0, 2.2, 1.5], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(eye, (n, 3)).copy()
    if kind == "bounce":
        hit = st.quad_closest_hit(td, torch.from_numpy(o),
                                  torch.from_numpy(d))
        t = np.minimum(hit.t.numpy(), 50.0)[:, None]
        o = (o + d * (t * 0.999)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("kind", ["primary", "bounce"])
def test_anyhit_slot_order_matches_pallas_atrium(atrium28, kind):
    # The quad any hit walks hit children in slot order (the kernel's
    # order since the Hopper redesign); its bit is JAX's near-first one.
    jd, td = atrium28
    o, d = _atrium_rays(td, kind)
    ref = np.asarray(pp.pallas_quad_any_hit(
        jd, jnp.asarray(o), jnp.asarray(d), interpret=True, packet=512,
        hbm_leaves=True))
    got = st.quad_any_hit(td, torch.from_numpy(o), torch.from_numpy(d))
    closest = st.quad_closest_hit_plain(*st.quad_args(
        td, torch.from_numpy(o), torch.from_numpy(d), None))
    assert 0 < ref.sum() < len(ref)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), closest.t.numpy() < MISS_T)


def test_active_mask(scenes28):
    jd, td = scenes28
    o, d = _rays(512, seed=5)
    active = np.random.default_rng(1).random(512) < 0.5
    ref = bvh_closest_hit(jd, jnp.asarray(o), jnp.asarray(d),
                          active=jnp.asarray(active))
    act = torch.from_numpy(active)
    got = st.quad_closest_hit(td, torch.from_numpy(o), torch.from_numpy(d),
                              active=act)
    _assert_hits_close(got, ref, keep=active)
    off = ~active
    assert np.all(got.t.numpy()[off] == MISS_T)
    assert np.all(got.tri.numpy()[off] == -1)
    assert np.all(got.u.numpy()[off] == 0) and np.all(got.v.numpy()[off] == 0)
    occ = st.quad_any_hit(td, torch.from_numpy(o), torch.from_numpy(d),
                          active=act).numpy()
    assert not occ[off].any()
    assert np.array_equal(occ[active], (np.asarray(ref.t) < MISS_T)[active])


def test_root_leaf_tree_matches_brute_force(box_glb):
    """Box (12 triangles) at leaf 14: the root is a leaf, which the JAX
    package has no quad rows for; the port stores one row."""
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )

    td = build_device_scene(gltf.load(box_glb), max_leaf_size=14,
                            device="cpu")
    assert td.quad_box.shape[0] == 1 and (td.quad_link[0, 1:] == st.EMPTY).all()
    o, d = _rays(256, seed=11)
    o = o * 0.1  # inside the box
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = st.quad_closest_hit(td, o_t, d_t)
    ref = brute_force_closest_hit(td, o_t, d_t)
    assert torch.equal(got.t, ref.t) and torch.equal(got.tri, ref.tri)
    assert (got.t < MISS_T).sum() > 128


def _tables_with_empty_slots():
    """One row: slot 0 = leaf 1 (a triangle at z = 5), slots 1-3 EMPTY
    but with boxes that contain every test ray.  Leaf 0 holds a nearer
    triangle at z = 2 that no slot references."""
    def tri(z):
        # v0, e1, e2 with det > 0 for rays along +z.
        return [-1.0, -1.0, z, 0.0, 4.0, 0.0, 4.0, 0.0, 0.0]

    leaves = torch.zeros((2, 4, 9))
    leaves[0, 0] = torch.tensor(tri(2.0))
    leaves[1, 0] = torch.tensor(tri(5.0))
    box = torch.zeros((1, 4, 6))
    box[0, 0] = torch.tensor([-1.0, -1.0, 5.0, 3.0, 3.0, 5.0])
    box[0, 1:] = torch.tensor([-1e3, -1e3, -1e3, 1e3, 1e3, 1e3])
    link = torch.tensor([[-2, st.EMPTY, st.EMPTY, st.EMPTY]],
                        dtype=torch.int32)
    return box, link, leaves


@pytest.mark.parametrize("any_hit", [False, True])
def test_empty_slots_never_visit_leaf0(any_hit):
    box, link, leaves = _tables_with_empty_slots()
    n = 64
    rng = np.random.default_rng(2)
    o = torch.from_numpy(np.c_[rng.uniform(-0.5, 0.5, size=(n, 2)),
                               np.zeros(n)].astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    t_lane = st.lane_limits(n, None, o.device)
    visits = torch.zeros(2, dtype=torch.int64)
    if any_hit:
        hit = st.quad_any_hit_plain(box, link, leaves, o, d, t_lane,
                                    leaf_visits=visits)
        assert hit.all()
    else:
        h = st.quad_closest_hit_plain(box, link, leaves, o, d, t_lane,
                                      leaf_visits=visits)
        assert torch.allclose(h.t, torch.full((n,), 5.0))
        assert (h.tri == 4).all()
    assert visits[0] == 0 and visits[1] == n


def test_quad_tables_match_jax_rows(scenes28):
    jd, td = scenes28
    rows = np.asarray(jd.bvh_quad)
    assert td.quad_box.shape[0] == rows.shape[0]
    nan = np.isnan(rows[:, :24].reshape(-1, 4, 6)[:, :, 0])
    assert np.array_equal(td.quad_link.numpy() == st.EMPTY, nan)


def test_bounce_sort_key_matches_jax(scenes28):
    """The 6d endpoint Morton key, dead lanes last: exactly the JAX key."""
    from vulkan_pathtracer_tpu.render.wavefront import (
        _bounce_sort_key as jax_key,
    )
    from vulkan_pathtracer_tpu_torch.render.wavefront import _bounce_sort_key

    jd, td = scenes28
    o, d = _rays(2048, seed=13)
    alive = np.random.default_rng(4).random(2048) < 0.8
    ref = jax_key(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive))
    got = _bounce_sort_key(td, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(alive))
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert (got.numpy()[~alive] == 0xFFFFFFFF).all()


def test_sorted_dispatch_matches_unsorted(scenes28):
    """Sorting is scheduling only: per-ray results are identical."""
    from vulkan_pathtracer_tpu_torch.render import wavefront

    _, td = scenes28
    o, d = map(torch.from_numpy, _rays(768, seed=17))
    act = torch.from_numpy(np.random.default_rng(6).random(768) < 0.7)
    plain = wavefront._closest_hit(td, o, d, act)
    srt = wavefront._closest_hit_sorted(td, o, d, act)
    for a, b in zip(plain, srt):
        assert torch.equal(a, b)
    assert torch.equal(wavefront._any_hit_sorted(td, o, d, act),
                       wavefront._any_hit(td, o, d, act))


def _chain_bvh(internal: int):
    """A degenerate tree: internal node 2i has a leaf on the left and
    the next internal node on the right; depth = internal + 1."""
    from vulkan_pathtracer_tpu.ops.bvh import HostBVH

    n = 2 * internal + 1
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    leaf_first = np.full(n, -1, np.int32)
    for i in range(internal):
        left[2 * i], right[2 * i] = 2 * i + 1, 2 * i + 2
        leaf_first[2 * i + 1] = 4 * i
    leaf_first[n - 1] = 4 * internal
    box = np.zeros((n, 3), np.float32)
    return HostBVH(bmin=box, bmax=box + 1, skip=np.zeros(n, np.int32),
                   leaf_first=leaf_first,
                   leaf_count=(leaf_first >= 0).astype(np.int32),
                   tri_order=np.arange(internal + 1), left_child=left,
                   right_child=right)


def test_quad_tables_reject_trees_deeper_than_the_stack():
    """Depth 101 > STACK_CAP = 96 is refused, so the 288-entry per-ray
    stack can never overflow; depth 21 builds, with int32 links."""
    with pytest.raises(ValueError, match="exceeds the per-ray stack"):
        st.build_quad_tables(_chain_bvh(100), 4)
    box, link = st.build_quad_tables(_chain_bvh(20), 4)
    assert link.dtype == np.int32 and box.dtype == np.float32
    assert box.shape == (10, 4, 6)
