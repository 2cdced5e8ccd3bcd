"""PyTorch port vs JAX: the closest hits' seed and t-window channels,
``leaf_seed_hit`` and ``seed_secondary`` on the CPU.

- ``leaf_seed_hit`` bitwise JAX's (``ops/intersect.py:89-126``), with
  inactive lanes and block ids past both ends of the table.
- Each seeded tier against JAX's seeded launcher (Pallas kernels in
  interpret mode, as tests/test_pallas.py runs them; the XLA walk for
  ``bvh_closest_hit``) at the traversal tolerance (hit masks equal, t
  within 1e-5, tri agreement > 0.999; coefficient leaves at the relaxed
  parity of tests/test_torch_mxu.py), in one launch of two halves: the
  rays seeded with the port's unseeded hit (then also bitwise the port's
  unseeded result) and seeded with ``leaf_seed_hit`` of its blocks.
- The t-window on pair, skip and frontier: JAX's three-window cascade
  (test_pallas.py:263-292) tiles [TMIN, inf) exactly, and ``t_near`` at
  the median matches JAX's windowed launch.
- ``seed_secondary``: Cornell at 2 bounces (emissive, so its last
  bounce is a seeded closest hit) through ``RenderPipeline`` and the
  atrium at 3 bounces through ``render_frame`` against JAX's seeded
  frames (allclose 1e-5), and against the port's unseeded frames: rays
  equal, and every seeded closest hit differs from the unseeded one
  only at a tie of equal t (or, held to brute force, where one walk's
  slab test rounded the nearer hit's box out), so pixels differ at most
  where such a hit did.  Sorted and
  unsorted seeded closest hits are equal per ray.
- Two-level scenes: JAX seeds them from object-space leaf blocks at the
  packed (instance, block) value, so its seed is no hit of the scene:
  with the columns moved down, JAX's seeded frame differs from its
  unseeded one in pixels and rays traced, and on the columns as baked
  the seeded bounce hits name instance 0 where the unseeded ones hit
  the floor.  The port refuses ``seed_secondary`` there (ValueError).
  Pre-split bakes: a leaf slot's id is its triangle's row in every
  per-triangle table, so ``leaf_seed_hit``'s ids are the kernels'.
- Brute force drops the seed, as JAX's does; a tier without a channel
  refuses one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mxu import BUDGET, assert_relaxed_parity
from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_flat,
)
from vulkan_pathtracer_tpu.models.instanced_scene import (
    build_instanced_scene as jax_inst,
)
from vulkan_pathtracer_tpu.ops import pallas_frontier as pf
from vulkan_pathtracer_tpu.ops import pallas_pair as pp
from vulkan_pathtracer_tpu.ops import pallas_traverse as pt
from vulkan_pathtracer_tpu.ops.intersect import Hit as JaxHit
from vulkan_pathtracer_tpu.ops.intersect import leaf_seed_hit as jax_seed
from vulkan_pathtracer_tpu.ops.mxu_mt import ensure_mt_coefs
from vulkan_pathtracer_tpu.ops.traverse import bvh_closest_hit as jax_bvh
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.ops import frontier as fr
from vulkan_pathtracer_tpu_torch.ops import intersect
from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T, Hit
from vulkan_pathtracer_tpu_torch.ops.traverse import bvh_closest_hit
from vulkan_pathtracer_tpu_torch.render import pipeline as pl
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

LEAF, INST_LEAF = 4, 8   # interpret mode's compile time grows with the block
PACKET = 512
N = 512


@pytest.fixture(scope="module")
def bakes(columns_glb):
    """kind -> (JAX bake, port bake) of the columns: flat at LEAF with
    both leaf tables and wide tiles, two-level at INST_LEAF."""
    return {
        "flat": (ensure_mt_coefs(jax_flat(jgltf.load(columns_glb),
                                          build_bvh=True, max_leaf_size=LEAF)),
                 build_device_scene(gltf.load(columns_glb),
                                    max_leaf_size=LEAF, device="cpu",
                                    mt="mxu", wide=True)),
        "instanced": (jax_inst(jgltf.load(columns_glb),
                               max_leaf_size=INST_LEAF),
                      build_instanced_scene(gltf.load(columns_glb),
                                            max_leaf_size=INST_LEAF,
                                            device="cpu"))}


def _rays(n=N, seed=3):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    targets = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) < 0.8
    return origins, d.astype(np.float32), active


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax_hit(hit):
    return JaxHit(*(jnp.asarray(x.numpy()) for x in hit))


def _assert_close(got, ref):
    ref_t = np.asarray(ref.t)
    assert np.array_equal(got.t.numpy() < MISS_T, ref_t < MISS_T)
    np.testing.assert_allclose(got.t.numpy(), ref_t, rtol=1e-5, atol=1e-5)
    assert (got.tri.numpy() == np.asarray(ref.tri)).mean() > 0.999


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- leaf_seed_hit ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_leaf_seed_hit_matches_jax(bakes, kind):
    """Bitwise JAX's, inactive lanes and clipped block ids included."""
    jd, td = bakes[kind]
    o, d, active = _rays(1024, seed=5)
    n_blocks = td.leaves.shape[0]
    assert n_blocks == jd.tri_blocks.shape[0]
    # The blocks of the rays' hits; elsewhere ids past both ends.
    hit = bvh_closest_hit(td, *_t(o, d))
    blocks = np.where(hit.tri.numpy() >= 0,
                      hit.tri.numpy() // td.max_leaf_size,
                      np.random.default_rng(6).integers(-3, n_blocks + 3,
                                                        1024))
    blocks = blocks.astype(np.int32)
    ref = jax_seed(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(blocks),
                   active=jnp.asarray(active))
    got = intersect.leaf_seed_hit(td, *_t(o, d, blocks, active))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert (got.tri[~torch.from_numpy(active)] == -1).all()
    assert ((blocks < 0) | (blocks >= n_blocks)).any()
    if kind == "flat":
        assert int((got.t < MISS_T).sum()) > 100


# -- the seeded tiers -----------------------------------------------------------

def _port_fn(name, coef=False):
    fn = {"quad": st.quad_closest_hit, "oct": st.oct_closest_hit,
          "pair": st.pair_closest_hit, "frontier": fr.frontier_closest_hit,
          "skip": sk.skip_closest_hit, "wide": sk.wide_closest_hit,
          "bvh": bvh_closest_hit}[name]
    return (lambda *a, **k: fn(*a, coef=True, **k)) if coef else fn


def _jax_fn(name):
    kw = dict(interpret=True, packet=PACKET)
    return {"quad": lambda *a, **k: pp.pallas_quad_closest_hit(*a, **kw, **k),
            "oct": lambda *a, **k: pp.pallas_oct_closest_hit(*a, **kw, **k),
            "pair": lambda *a, **k: pp.pallas_pair_closest_hit(*a, **kw, **k),
            "frontier": lambda *a, **k: pf.pallas_frontier_closest_hit(
                *a, **kw, **k),
            "skip": lambda *a, **k: pt.pallas_closest_hit(*a, **kw, **k),
            "wide": lambda *a, **k: pt.pallas_wide_closest_hit(
                *a, interpret=True, **k),
            "bvh": jax_bvh}[name]


SEEDED = [("quad", "flat", False), ("oct", "flat", False),
          ("pair", "flat", False), ("pair", "instanced", False),
          ("skip", "flat", False), ("skip", "instanced", False),
          ("wide", "flat", False), ("frontier", "flat", False),
          ("frontier", "flat", True), ("bvh", "flat", False)]


@pytest.mark.parametrize("name,kind,coef", SEEDED)
def test_seeded_tier_matches_jax(bakes, name, kind, coef, monkeypatch):
    """One launch of 2 x N rays: the first half seeded with the port's
    unseeded hit (the result bitwise that hit), the second with
    ``leaf_seed_hit`` of its blocks (the same seeds in both packages)."""
    jd, td = bakes[kind]
    fn = _port_fn(name, coef)
    o, d, active = _rays()
    ot, dt, at = _t(o, d, active)
    unseeded = fn(td, ot, dt, at)
    blocks = torch.clamp(unseeded.tri, min=0) // td.max_leaf_size
    local = intersect.leaf_seed_hit(td, ot, dt, blocks, at)
    assert int((local.t < MISS_T).sum()) > 10
    o2, d2, a2 = (torch.cat([x, x]) for x in (ot, dt, at))
    seed = Hit(*(torch.cat([x, y]) for x, y in zip(unseeded, local)))
    got = fn(td, o2, d2, a2, seed=seed)
    _bitwise((x[:N] for x in got), unseeded)
    if coef:
        # JAX reads VKPT_MT while it traces.
        monkeypatch.setenv("VKPT_MT", "mxu")
        jax.clear_caches()
    ref = _jax_fn(name)(jd, jnp.asarray(o2.numpy()), jnp.asarray(d2.numpy()),
                        jnp.asarray(a2.numpy()), seed=_jax_hit(seed))
    if coef:
        monkeypatch.delenv("VKPT_MT")
        jax.clear_caches()
        assert_relaxed_parity(ref, got, budget=BUDGET)
    else:
        _assert_close(got, ref)
    # Inactive lanes return their seed in both packages.
    idle = ~a2.numpy()
    assert np.array_equal(np.asarray(ref.tri)[idle], seed.tri.numpy()[idle])
    assert torch.equal(got.tri[~a2], seed.tri[~a2])


@pytest.mark.parametrize("name", ["quad", "oct", "wide"])
def test_tier_without_window_refuses_it(bakes, name):
    """Only pair, frontier and skip (pallas_pair_closest_hit,
    pallas_frontier_closest_hit, pallas_closest_hit) have a t-window."""
    _, td = bakes["flat"]
    ot, dt, at = _t(*_rays(8))
    with pytest.raises(TypeError):
        _port_fn(name)(td, ot, dt, at, t_near=1.0)


# -- the t-window -------------------------------------------------------------

WINDOWED = [("pair", "flat"), ("pair", "instanced"), ("skip", "flat"),
            ("skip", "instanced"), ("frontier", "flat")]


@pytest.mark.parametrize("name,kind", WINDOWED)
def test_window_cascade_is_exact(bakes, name, kind):
    """test_pallas.py:263-292: windows [TMIN, t1), [t1, t2), [t2, inf)
    at the 33rd and 66th percentiles; each ray's first window with a hit
    gives tri and t bitwise the unwindowed launch."""
    _, td = bakes[kind]
    fn = _port_fn(name)
    ot, dt, at = _t(*_rays(seed=11))
    ref = fn(td, ot, dt, at)
    hit = ref.t < MISS_T
    t1, t2 = np.percentile(ref.t[hit].numpy(), [33, 66])
    parts = [fn(td, ot, dt, at, t_far=t1),
             fn(td, ot, dt, at, t_near=t1, t_far=t2),
             fn(td, ot, dt, at, t_near=t2)]
    t, tri = parts[2].t, parts[2].tri
    for part in parts[1::-1]:
        m = part.t < MISS_T
        t, tri = torch.where(m, part.t, t), torch.where(m, part.tri, tri)
    assert torch.equal(t, ref.t) and torch.equal(tri, ref.tri)
    assert all(int((p.t < MISS_T).sum()) > 20 for p in parts)


@pytest.mark.parametrize("name,kind", WINDOWED)
def test_t_near_matches_jax(bakes, name, kind):
    """``t_near`` at the median t against JAX's windowed launch."""
    jd, td = bakes[kind]
    o, d, active = _rays(seed=13)
    ot, dt, at = _t(o, d, active)
    full = _port_fn(name)(td, ot, dt, at)
    t_near = float(np.median(full.t[full.t < MISS_T].numpy()))
    got = _port_fn(name)(td, ot, dt, at, t_near=t_near)
    ref = _jax_fn(name)(jd, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(active), t_near=t_near)
    _assert_close(got, ref)
    hit = got.t < MISS_T
    assert 20 < int(hit.sum()) < int((full.t < MISS_T).sum())
    assert (got.t[hit] >= np.float32(t_near)).all()


# -- seed_secondary -------------------------------------------------------------

class _TieRecorder:
    """Wraps wavefront._closest_hit: every seeded call is compared with
    an unseeded one on the same rays, and may differ only at a tie of
    equal t or where one walk's slab test rounded the nearer hit's box
    out (the nearer t held to brute force)."""

    def __init__(self, monkeypatch):
        self.real = wavefront._closest_hit
        self.ties = self.seeded_calls = 0
        monkeypatch.setattr(wavefront, "_closest_hit", self)

    def __call__(self, scene, o, d, active, tiers="auto", phase="primary",
                 seed=None):
        hit = self.real(scene, o, d, active, tiers, phase, seed)
        if seed is not None:
            self.seeded_calls += 1
            ref = self.real(scene, o, d, active, tiers, phase)
            differ = ((hit.t != ref.t) | (hit.tri != ref.tri)
                      | (hit.u != ref.u) | (hit.v != ref.v))
            face = differ & (hit.t != ref.t)
            if face.any():
                bf = intersect.brute_force_closest_hit(
                    scene, o[face], d[face], active[face])
                assert torch.equal(bf.t, torch.minimum(hit.t[face],
                                                       ref.t[face]))
            self.ties += int(differ.sum())
        return hit


def _cornell_camera(aspect):
    cam = JaxCamera(aspect_ratio=aspect,
                    position=np.asarray([0.0, 1.0, 0.9], np.float32))
    cam.set_orientation(yaw=180.0, pitch=0.0)
    return cam


def test_seeded_cornell_matches_jax(cornell_glb, monkeypatch):
    """Cornell at 2 bounces, 48x32: the last bounce is a seeded closest
    hit (an emissive scene)."""
    from vulkan_pathtracer_tpu.render.pipeline import (
        RenderPipeline as JaxPipeline,
    )
    from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig

    kw = dict(num_samples=1, num_bounces=2, resolution_x=48, resolution_y=32)
    jd = jax_flat(jgltf.load(cornell_glb), build_bvh=True, max_leaf_size=LEAF)
    td = build_device_scene(gltf.load(cornell_glb), max_leaf_size=LEAF,
                            device="cpu")
    assert not td.emissive_free
    cam = _cornell_camera(48 / 32)
    ref, ref_rays = JaxPipeline(jd, JaxConfig(seed_secondary=True, **kw)) \
        .render_numpy(cam, 3)
    plain, plain_rays = pl.RenderPipeline(td, RenderConfig(**kw)) \
        .render_numpy(cam, 3)
    rec = _TieRecorder(monkeypatch)
    got, rays = pl.RenderPipeline(td, RenderConfig(seed_secondary=True,
                                                   **kw)).render_numpy(cam, 3)
    assert rec.seeded_calls == 1
    assert rays == ref_rays == plain_rays > 48 * 32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert int((got != plain).any(axis=-1).sum()) <= rec.ties


@pytest.fixture(scope="module")
def atrium_glb(tmp_path_factory):
    from assets.procedural import make_atrium

    path = tmp_path_factory.mktemp("channels") / "atrium.glb"
    make_atrium(str(path), detail=0.3)
    return str(path)


def test_seeded_atrium_matches_jax(atrium_glb, monkeypatch):
    """The emissive-free atrium at 3 bounces, 48x27, leaf 8: bounce 1 is
    the seeded closest hit (sorted: more than 16,384 triangles), bounce
    2 the any hit."""
    from vulkan_pathtracer_tpu.app.camera_path import orbit_path
    from vulkan_pathtracer_tpu.render.pipeline import render_frame as jrf

    jd = jax_flat(jgltf.load(atrium_glb), build_bvh=True, max_leaf_size=8)
    td = build_device_scene(gltf.load(atrium_glb), max_leaf_size=8,
                            device="cpu")
    assert td.emissive_free and td.num_triangles >= pl.SORT_MIN_TRIANGLES
    cam = Camera(aspect_ratio=48 / 27)
    orbit_path(radius=4.5, height=2.2, duration=4.0,
               center=(0.0, 1.2, 0.0)).apply(cam, 1.0)
    kw = dict(num_samples=1, num_bounces=3, width=48, height=27)
    ref, ref_rays = jrf(jd, *(jnp.asarray(v) for v in cam.push_constants()),
                        jnp.uint32(2), sort_secondary=True,
                        seed_secondary=True, **kw)
    vectors = pl.camera_tensors(cam, "cpu")
    plain, plain_rays = pl.render_frame(td, *vectors, 2, sort_secondary=True,
                                        **kw)
    rec = _TieRecorder(monkeypatch)
    got, rays = pl.render_frame(td, *vectors, 2, sort_secondary=True,
                                seed_secondary=True, **kw)
    assert rec.seeded_calls == 1
    assert int(rays) == int(ref_rays) == int(plain_rays) > 48 * 27
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert int((got != plain).any(dim=-1).sum()) <= rec.ties


def test_sorted_and_unsorted_seeded_hits_are_equal(bakes):
    _, td = bakes["flat"]
    ot, dt, at = _t(*_rays(seed=17))
    unseeded = wavefront._closest_hit(td, ot, dt, at, "auto", "secondary")
    seed = wavefront.bounce_seed(td, unseeded, ot, dt, at)
    a = wavefront._closest_hit(td, ot, dt, at, "auto", "secondary", seed)
    b = wavefront._closest_hit_sorted(td, ot, dt, at, "auto", "secondary",
                                      seed)
    _bitwise(a, b)
    assert int((seed.t < MISS_T).sum()) > 10


def test_batch_of_seeded_frames(bakes):
    """render_batch_sum without the joint wavefront (2 spp) sums the
    seeded frames; the joint batch ignores seed_secondary, as JAX's
    render_frames_joint does."""
    _, td = bakes["flat"]
    cam = Camera(aspect_ratio=1.0, position=np.asarray([0.0, 3.0, -9.0],
                                                        np.float32))
    kw = dict(num_bounces=3, resolution_x=16, resolution_y=16)
    seeded = pl.RenderPipeline(td, RenderConfig(num_samples=2,
                                                seed_secondary=True, **kw))
    total, rays = seeded.render_batch_sum(cam, 4, 2)
    frames = [seeded.render(cam, f) for f in (4, 5)]
    assert torch.equal(total, frames[0][0] + frames[1][0])
    assert int(rays) == int(frames[0][1] + frames[1][1])
    one = RenderConfig(num_samples=1, **kw)
    joint = pl.RenderPipeline(td, RenderConfig(seed_secondary=True, **kw))
    _bitwise(joint.render_batch_sum(cam, 4, 2),
             pl.RenderPipeline(td, one).render_batch_sum(cam, 4, 2))


# -- two-level and pre-split bakes ------------------------------------------------

def test_two_level_seeding_as_jax(bakes):
    """How JAX seeds two-level scenes (wavefront.py:731-732): the block of
    a hit is its packed (instance, block) value, the raw row for instance
    0 and clipped to the last row (the floor's) for every other, and
    ``leaf_seed_hit`` tests the world-space ray against that object-space
    block.  With every instance moved down by 0.25 (the two-level scene's
    own update_instance_transforms) JAX's seeded frame differs from its
    unseeded one in pixels and in rays traced.  As baked, the floor's
    instance has the identity transform, so the seed's t is a hit's t,
    but its id names instance 0 (a column) where the unseeded hit names
    the floor's instance: the seeded hits differ from the unseeded ones
    by more than ties.  Hence test_two_level_seed_refused."""
    from vulkan_pathtracer_tpu.models.instanced_scene import (
        update_instance_transforms as jax_update,
    )
    from vulkan_pathtracer_tpu.render.pipeline import render_frame as jrf
    from vulkan_pathtracer_tpu_torch.render.shading import (
        get_material_data,
        get_triangle_data,
    )

    jd, td = bakes["instanced"]
    inv = np.asarray(jd.inst_inv, np.float64)
    a = np.linalg.inv(inv[:, :9].reshape(-1, 3, 3))
    tf = np.tile(np.eye(4), (a.shape[0], 1, 1))
    tf[:, :3, :3] = a
    tf[:, :3, 3] = -np.einsum("ijk,ik->ij", a, inv[:, 9:12])
    tf[:, 1, 3] -= 0.25
    moved = jax_update(jd, jnp.asarray(tf, jnp.float32))
    cam = Camera(aspect_ratio=32 / 24,
                 position=np.asarray([0.3, 1.0, -3.0], np.float32))
    kw = dict(num_samples=1, num_bounces=3, width=32, height=24)
    vectors = [jnp.asarray(v) for v in cam.push_constants()]
    seeded, seeded_rays = jrf(moved, *vectors, jnp.uint32(1),
                              seed_secondary=True, **kw)
    plain, plain_rays = jrf(moved, *vectors, jnp.uint32(1), **kw)
    assert int(seeded_rays) != int(plain_rays)
    assert int((np.asarray(seeded) != np.asarray(plain)).any(-1).sum()) > 5

    # The columns as baked: the bounce rays of a 32x24 frame.
    o, d, sx, sy, _ = pl.primary_rays(*pl.camera_tensors(cam, "cpu"), 1,
                                      32, 24)
    hit = wavefront._closest_hit(td, o, d, None)
    tri_data = get_triangle_data(td, hit)
    o1, d1, _, _, _, alive = wavefront.extend_paths(
        td, hit, o, d, torch.ones_like(o), sx, sy, hit.t < MISS_T, tri_data,
        get_material_data(td, tri_data))
    seed = wavefront.bounce_seed(td, hit, o1, d1, alive)
    ref = wavefront._closest_hit(td, o1, d1, alive, "auto", "secondary")
    got = wavefront._closest_hit(td, o1, d1, alive, "auto", "secondary",
                                 seed)
    differ = got.tri != ref.tri
    assert int(differ.sum()) > 20
    inst = (lambda tri: (tri // td.max_leaf_size) >> td.mb_bits)
    assert torch.equal(got.t, ref.t)
    assert bool((inst(got.tri[differ]) == 0).all())
    assert bool((inst(ref.tri[differ]) == td.inst_inv.shape[0] - 1).all())


@pytest.mark.parametrize("entry", ["RenderPipeline", "render_frame",
                                   "trace_sample"])
def test_two_level_seed_refused(bakes, entry):
    """``seed_secondary`` on a two-level scene raises ValueError at each
    entry point that takes it (test_two_level_seeding_as_jax says why);
    without it the scene renders."""
    _, td = bakes["instanced"]
    cam = Camera(aspect_ratio=1.0, position=np.asarray([0.3, 1.0, -3.0],
                                                        np.float32))
    kw = dict(num_samples=1, num_bounces=2, width=8, height=8)
    vectors = pl.camera_tensors(cam, "cpu")
    o, d, sx, sy, _ = pl.primary_rays(*vectors, 1, 8, 8)
    calls = {
        "RenderPipeline": lambda **k: pl.RenderPipeline(td, RenderConfig(
            num_bounces=2, resolution_x=8, resolution_y=8, **k)).render(cam, 1),
        "render_frame": lambda **k: pl.render_frame(td, *vectors, 1, **kw,
                                                    **k),
        "trace_sample": lambda **k: wavefront.trace_sample(
            td, o, d, sx, sy, num_bounces=2, **k)}
    with pytest.raises(ValueError, match="two-level"):
        calls[entry](seed_secondary=True)
    assert int(calls[entry]()[-1]) >= 64


def test_presplit_slot_is_the_triangle_id(atrium_glb, monkeypatch):
    """Pre-split bakes: leaf slot s holds the triangle of row s of every
    per-triangle table (the slot map applied to all of them), so
    ``leaf_seed_hit``'s id block * leaf + k is the id the kernels report
    and shading reads; the seeded frame differs from the unseeded one
    only at ties."""
    td = build_device_scene(gltf.load(atrium_glb), max_leaf_size=8,
                            device="cpu", presplit=0.3)
    refs = int(td.tree.block_count.sum())
    assert refs > td.num_triangles
    n = td.leaves.shape[0] * td.max_leaf_size
    slots = td.leaves.reshape(n, 9)
    assert torch.equal(slots, torch.cat([td.tri_v0[:n], td.tri_e1[:n],
                                         td.tri_e2[:n]], dim=1))
    cam = Camera(aspect_ratio=1.0, position=np.asarray([0.0, 1.5, 0.0],
                                                        np.float32))
    kw = dict(num_samples=1, num_bounces=3, width=24, height=24)
    vectors = pl.camera_tensors(cam, "cpu")
    plain, plain_rays = pl.render_frame(td, *vectors, 1, **kw)
    rec = _TieRecorder(monkeypatch)
    got, rays = pl.render_frame(td, *vectors, 1, seed_secondary=True, **kw)
    assert rec.seeded_calls == 1 and int(rays) == int(plain_rays)
    assert int((got != plain).any(dim=-1).sum()) <= rec.ties


def test_brute_force_drops_the_seed(bakes, columns_glb):
    """JAX's brute-force tier takes no seed (wavefront.py:215): the
    port's drops it too, with and without a BVH in the bake."""
    _, td = bakes["flat"]
    nobvh = build_device_scene(gltf.load(columns_glb), max_leaf_size=LEAF,
                               device="cpu", build_bvh=False)
    ot, dt, at = _t(*_rays(seed=19))
    bogus = Hit(torch.full((N,), 0.5), torch.full((N,), 7, dtype=torch.int32),
                torch.zeros(N), torch.zeros(N))
    for scene in (td, nobvh):
        ref = wavefront._closest_hit(scene, ot, dt, at, "brute")
        got = wavefront._closest_hit(scene, ot, dt, at, "brute", seed=bogus)
        _bitwise(got, ref)
        assert int((ref.t < MISS_T).sum()) > 20
