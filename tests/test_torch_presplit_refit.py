"""PyTorch port vs JAX: triangle pre-splitting, the refit and the
animated flat scene.

- Pre-splitting: ``presplit_triangle_refs`` bitwise JAX's; the
  pre-split bake's tables bitwise JAX's pre-split bake, converted
  (``scene_from_jax_arrays``); a 64x48 frame of the pre-split scene
  identical to the unsplit one (tests/test_presplit.py:45).
- Refit: of an unmoved bake, every table bitwise the bake's (JAX's own
  test allows 1e-6, tests/test_refit.py:15-27; the port's refit is
  bitwise); on JAX's rebaked triangles the boxes, the pair, quad and oct
  tables, the skip records and the leaf blocks bitwise JAX's
  ``refit_scene``; the frontier boxes within one ulp of max(|coordinate|,
  |root|) of JAX's f32 dilation (the port dilates in float64, as its host
  bake) and containing the undilated boxes; the coefficient rows bitwise
  a fresh host bake of the moved leaves, while JAX's refit leaves its
  table stale.
- ``with_transforms``: the object-space sources bitwise JAX's; the
  rebaked triangles within 2e-7 absolute (1e-6 for the unit normals and
  shading rows) of JAX's einsum rebake; a frame of the moved scene
  against JAX's frame of the same scene.
Tolerances are stated per assertion.  Module-scoped bakes keep the file
under a minute on one worker.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.animation import (
    build_animated_scene as jax_animated,
)
from vulkan_pathtracer_tpu.models.camera import Camera as JaxCamera
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu.ops.bvh import (
    presplit_triangle_refs as jax_presplit,
)
from vulkan_pathtracer_tpu.ops.mxu_mt import (
    build_mt_coef_rows,
    ensure_mt_coefs,
)
from vulkan_pathtracer_tpu.render.pipeline import (
    RenderPipeline as JaxPipeline,
)
from vulkan_pathtracer_tpu.utils.config import RenderConfig as JaxConfig
from vulkan_pathtracer_tpu_torch.app.dynamic import REFIT_STEPS
from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.animation import build_animated_scene
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.ops.bvh import presplit_triangle_refs
from vulkan_pathtracer_tpu_torch.ops.mxu_mt import coef_rows_from_jax
from vulkan_pathtracer_tpu_torch.ops.refit import (
    refit_boxes,
    refit_scene,
    tree_violations,
)
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import boxes_from_src
from vulkan_pathtracer_tpu_torch.render.pipeline import RenderPipeline
from vulkan_pathtracer_tpu_torch.utils import RenderConfig

from tests.native_guard import native_libraries  # noqa: F401
from tests.test_torch_scene import jax_scene_arrays

pytestmark = pytest.mark.usefixtures("native_libraries")

TABLES = ("pair_box", "pair_link", "quad_box", "quad_link", "oct_box",
          "oct_link", "frontier_box", "frontier_link", "leaves", "root_lo",
          "root_hi", "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_attr",
          "tri_material")
TREE = ("left", "right", "leaf_first", "leaf_count", "block_count", "perm",
        "pair_src", "quad_src", "oct_src", "frontier_src")


def _bits(t):
    return t.numpy().view(np.uint8)


def assert_tables_equal(a, b, fields=TABLES):
    """Every table of ``fields``, the skip records and the TreeMaps
    bitwise equal (f32 by their bits)."""
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and np.array_equal(_bits(x), _bits(y)), f
    assert np.array_equal(_bits(a.skip_nodes), _bits(b.skip_nodes))
    for f in TREE:
        x, y = getattr(a.tree, f), getattr(b.tree, f)
        assert (x is None) == (y is None), f
        assert x is None or torch.equal(x, y), f


@pytest.fixture(scope="module")
def big_columns(tmp_path_factory):
    """A columns scene of 1,804 triangles: above the 1024 of
    pre-splitting, its floor quads the largest triangles."""
    from assets.procedural import make_columns

    path = str(tmp_path_factory.mktemp("presplit") / "columns_5_6.glb")
    make_columns(path, grid=5, segments=6, n_materials=4)
    return path


def _camera(cls):
    cam = cls(aspect_ratio=64 / 48,
              position=np.array([4, 3, -8], np.float32))
    cam.set_orientation(yaw=150.0, pitch=-10.0)
    return cam


# -- pre-splitting -------------------------------------------------------------

@pytest.mark.parametrize("budget", [0.0, 0.25, 0.3])
def test_presplit_refs_match_jax(budget):
    """Reference boxes and triangles bitwise JAX's (host NumPy, copied)."""
    rng = np.random.default_rng(3)
    n = 2000
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    e1[:5] *= 50.0
    e2[:5] *= 50.0
    want = jax_presplit(v0, e1, e2, budget_factor=budget)
    got = presplit_triangle_refs(v0, e1, e2, budget_factor=budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got[2].shape[0] > n) == (budget > 0)


@pytest.fixture(scope="module")
def presplit_bakes(big_columns):
    """(JAX pre-split bake converted, the port's pre-split bake, the
    port's unsplit bake), leaf 8, coefficient rows on all."""
    jd = jax_build(jgltf.load(big_columns), build_bvh=True, max_leaf_size=8,
                   presplit=0.3)
    ensure_mt_coefs(jd)
    conv = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    host = gltf.load(big_columns)
    split = build_device_scene(host, max_leaf_size=8, device="cpu",
                               mt="mxu", presplit=0.3)
    plain = build_device_scene(host, max_leaf_size=8, device="cpu",
                               mt="mxu")
    return conv, split, plain


def test_presplit_bake_matches_jax(presplit_bakes):
    conv, split, plain = presplit_bakes
    assert_tables_equal(split, conv, TABLES + ("tri_coefs",))
    refs = int(split.tree.block_count.sum())
    assert refs > split.num_triangles == plain.num_triangles == 1804
    assert int(plain.tree.block_count.sum()) == plain.num_triangles
    # Child boxes nest; a split triangle overhangs its clipped leaf box
    # by design (each slot's box bounds only its part of the triangle).
    tri_out, child_out = tree_violations(split)
    assert child_out == 0 and tri_out > 0 == tree_violations(plain)[0]


def test_presplit_frame_identical(presplit_bakes):
    """A split triangle's slots carry the same triangle and attributes,
    so the frame equals the unsplit one (tests/test_presplit.py:45)."""
    _, split, plain = presplit_bakes
    cfg = RenderConfig(num_samples=1, num_bounces=3, resolution_x=64,
                       resolution_y=48)
    i0, r0 = RenderPipeline(plain, cfg).render_numpy(_camera(Camera), 3)
    i1, r1 = RenderPipeline(split, cfg).render_numpy(_camera(Camera), 3)
    assert r0 == r1
    np.testing.assert_array_equal(i0, i1)


# -- refit -------------------------------------------------------------------

@pytest.mark.parametrize("leaf", [4, 14, 28])
def test_refit_of_unmoved_bake_is_the_bake(columns_glb, leaf):
    """Bitwise every table, the skip records (skips and leaves kept) and
    the coefficient rows; the 8-wide tiles are dropped."""
    td = build_device_scene(gltf.load(columns_glb), max_leaf_size=leaf,
                            device="cpu", mt="mxu", wide=True)
    r = refit_scene(td)
    assert_tables_equal(r, td, TABLES + ("tri_coefs",))
    assert td.wide_nodes is not None and r.wide_nodes is None
    assert tree_violations(r) == (0, 0)


def _motion(transforms, seed):
    """Per-instance lift and a 0.3 rad turn about y of all instances."""
    rng = np.random.default_rng(seed)
    tf = transforms.copy()
    tf[:, 1, 3] += rng.uniform(-1, 1, tf.shape[0]).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                 np.float32)
    return np.einsum("ij,njk->nik", R, tf).astype(np.float32)


@pytest.fixture(scope="module")
def animated(columns_glb):
    """(JAX AnimatedScene with coefficient rows, the port's, the moved
    transforms, JAX's moved scene, the port's moved scene), leaf 8."""
    ja = jax_animated(jgltf.load(columns_glb), max_leaf_size=8)
    ensure_mt_coefs(ja.base)
    ta = build_animated_scene(gltf.load(columns_glb), max_leaf_size=8,
                              device="cpu", mt="mxu")
    tf = _motion(np.asarray(ja.initial_transforms(jgltf.load(columns_glb))),
                 0)
    return ja, ta, tf, ja.with_transforms(jnp.asarray(tf)), \
        ta.with_transforms(torch.from_numpy(tf))


def test_animated_sources_match_jax(animated):
    ja, ta, _, _, _ = animated
    for f in ("obj_v0", "obj_e1", "obj_e2", "obj_gn", "tri_instance",
              "obj_normal", "obj_tangent", "vert_instance"):
        assert np.array_equal(np.asarray(getattr(ja, f)),
                              getattr(ta, f).numpy()), f
    assert np.array_equal(np.asarray(ja.base.tri_index),
                          ta.tri_index.numpy())
    assert_tables_equal(ta.base, scene_from_jax_arrays(
        *jax_scene_arrays(ja.base), "cpu"), TABLES + ("tri_coefs",))


def test_refit_matches_jax(animated):
    """The port's refit of JAX's rebaked triangles: bitwise JAX's
    refit_scene but for the frontier (one ulp of the scale, containing
    the undilated boxes) and the coefficient rows (a fresh bake of the
    moved leaves; JAX's are stale)."""
    ja, _, _, jd, _ = animated
    conv = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    base = scene_from_jax_arrays(*jax_scene_arrays(ja.base), "cpu")
    moved = dataclasses.replace(base, tri_v0=conv.tri_v0, tri_e1=conv.tri_e1,
                                tri_e2=conv.tri_e2)
    r = refit_scene(moved)
    assert_tables_equal(r, conv, ("pair_box", "pair_link", "quad_box",
                                  "quad_link", "oct_box", "oct_link",
                                  "frontier_link", "leaves", "root_lo",
                                  "root_hi"))
    assert tree_violations(r) == (0, 0)
    # Frontier: float64 dilation against JAX's f32 one.
    bmin, bmax = refit_boxes(moved)
    src = moved.tree.frontier_src
    undilated = boxes_from_src(bmin, bmax, src).numpy()
    root = np.maximum(np.abs(bmin[0].numpy()), np.abs(bmax[0].numpy()))
    scale = np.maximum(np.abs(undilated), np.tile(root, 2))
    got, want = r.frontier_box.numpy(), conv.frontier_box.numpy()
    assert (np.abs(got - want) <= np.spacing(scale)).all()
    live = src.numpy() >= 0
    assert (got[..., :3][live] <= undilated[..., :3][live]).all()
    assert (got[..., 3:][live] >= undilated[..., 3:][live]).all()
    # Coefficient rows: a fresh host bake of the moved leaves (JAX's
    # build_mt_coef_rows, converted), bitwise; JAX's refit kept the
    # rows of the unmoved pose.
    fresh = coef_rows_from_jax(build_mt_coef_rows(
        np.asarray(jd.tri_blocks), 8), 8)
    assert np.array_equal(_bits(r.tri_coefs), fresh.view(np.uint8))
    assert np.array_equal(np.asarray(jd.tri_coefs),
                          np.asarray(ja.base.tri_coefs))
    assert not np.array_equal(conv.tri_coefs.numpy(), fresh)


def test_with_transforms_matches_jax(animated):
    """The f32 rebake (fixed-order 3-term sums) against JAX's einsum:
    positions and edges within 2e-7 absolute, unit normals and shading
    rows within 1e-6; the tables of the port's own refit are those of a
    fresh refit of its triangles (boxes hold them)."""
    _, ta, tf, jd, td = animated
    for f, tol in (("tri_v0", 2e-7), ("tri_e1", 2e-7), ("tri_e2", 2e-7),
                   ("tri_gn", 1e-6), ("tri_attr", 1e-6)):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=0,
                                   atol=tol, err_msg=f)
    assert tree_violations(td) == (0, 0)
    assert td.wide_nodes is None
    same = refit_scene(ta.rebake(torch.from_numpy(tf)))
    assert_tables_equal(td, same, TABLES + ("tri_coefs",))


def test_with_transforms_marks_its_steps(animated):
    """with_transforms(on_step=) calls the hook after the rebake, the
    refit and the regeneration, in that order (the steps the card's
    timers read), and its scene is bitwise the one without the hook."""
    _, ta, tf, _, td = animated
    marks = []
    timed = ta.with_transforms(torch.from_numpy(tf), on_step=marks.append)
    assert tuple(marks) == REFIT_STEPS == ("rebake", "refit", "regenerate")
    assert_tables_equal(timed, td, TABLES + ("tri_coefs",))


def test_animated_identity_matches_static(animated, columns_glb):
    """At the loaded transforms the rebake is the bake's triangles within
    1e-5 (tests/test_refit.py:30's tolerance), and so are the boxes.
    Padded slots are compared apart: as in JAX, a padded slot rebakes to
    instance 0's translation with zero edges (degenerate, never hit,
    outside every box)."""
    _, ta, _, _, _ = animated
    dev = ta.with_transforms(ta.initial_transforms(gltf.load(columns_glb)))
    block = ta.base.max_leaf_size
    real = (torch.arange(block)[None, :]
            < ta.base.tree.block_count[:, None]).reshape(-1)
    n = real.shape[0]
    for f in ("tri_v0", "tri_e1", "tri_e2"):
        np.testing.assert_allclose(getattr(dev, f)[:n][real].numpy(),
                                   getattr(ta.base, f)[:n][real].numpy(),
                                   atol=1e-5, err_msg=f)
    assert not dev.tri_e1[:n][~real].any() and not dev.tri_e2[:n][~real].any()
    for f in ("root_lo", "root_hi", "quad_box", "pair_box"):
        np.testing.assert_allclose(getattr(dev, f).numpy(),
                                   getattr(ta.base, f).numpy(), atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("leaf", [4, 14])
def test_moved_frame_matches_jax(columns_glb, leaf):
    """A 64x48 frame of the moved scene: the port's kernels' plain
    versions on its refit of JAX's rebaked triangles against JAX's
    frame (traversal="pallas", interpret mode) of the same scene, rays
    exact and radiance allclose 1e-5; the port's own with_transforms
    frame within 1e-4 of it on all but 0.5% of the pixels (the rebakes
    round differently, so an edge pixel may flip)."""
    ja = jax_animated(jgltf.load(columns_glb), max_leaf_size=leaf)
    ta = build_animated_scene(gltf.load(columns_glb), max_leaf_size=leaf,
                              device="cpu")
    tf = _motion(np.asarray(ja.initial_transforms(jgltf.load(columns_glb))),
                 1)
    jd = ja.with_transforms(jnp.asarray(tf))
    kw = dict(num_samples=1, num_bounces=2, resolution_x=64,
              resolution_y=48)
    ref, ref_rays = JaxPipeline(jd, JaxConfig(traversal="pallas", **kw)) \
        .render_numpy(_camera(JaxCamera), 2)
    conv = scene_from_jax_arrays(*jax_scene_arrays(jd), "cpu")
    base = scene_from_jax_arrays(*jax_scene_arrays(ja.base), "cpu")
    moved = refit_scene(dataclasses.replace(
        base, tri_v0=conv.tri_v0, tri_e1=conv.tri_e1, tri_e2=conv.tri_e2,
        tri_gn=conv.tri_gn, tri_attr=conv.tri_attr))
    cfg = RenderConfig(traversal="pallas", **kw)
    got, rays = RenderPipeline(moved, cfg).render_numpy(_camera(Camera), 2)
    assert rays == ref_rays > 64 * 48
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    own, _ = RenderPipeline(ta.with_transforms(torch.from_numpy(tf)),
                            cfg).render_numpy(_camera(Camera), 2)
    off = (np.abs(own - ref) > 1e-4).any(axis=2)
    assert off.mean() <= 0.005
