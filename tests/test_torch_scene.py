"""PyTorch port vs JAX: glTF load and the flat device-scene bake.

The port's loader and bake must reproduce the JAX package's
``build_device_scene`` exactly (same native SAH tree, same leaf-block
order, same packed rows), and ``scene_from_jax_arrays`` — the bridge
the other port tests use to trace one scene in both packages — must
equal the port's own bake, including the quad-table re-layout (JAX
NaN-box empty slots -> EMPTY links).  Tolerance: none.
"""

import ctypes

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.models import gltf as jgltf
from vulkan_pathtracer_tpu.models.device_scene import (
    build_device_scene as jax_build,
)
from vulkan_pathtracer_tpu_torch.models import gltf as tgltf
from vulkan_pathtracer_tpu_torch.models.device_scene import (
    build_device_scene,
    scene_from_jax_arrays,
)
from vulkan_pathtracer_tpu_torch.ops import native
from vulkan_pathtracer_tpu_torch.ops.stack_traverse import EMPTY

from tests.native_guard import native_libraries  # noqa: F401

# Both packages bake with the native SAH (tests/native_guard.py).
pytestmark = pytest.mark.usefixtures("native_libraries")

FIXTURES = {"box": "box_glb", "cornell": "cornell_glb",
            "sphere": "sphere_glb", "columns": "columns_glb"}
TENSOR_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_material",
                 "tri_attr", "mat_packed", "tex_texels", "tex_offset",
                 "tex_width", "tex_height", "quad_box", "quad_link",
                 "leaves", "root_lo", "root_hi")
META_FIELDS = ("num_triangles", "max_leaf_size", "bvh_depth",
               "has_textures", "emissive_free")


def jax_scene_arrays(jd):
    """(arrays, meta) of a JAX DeviceScene, as scene_from_jax_arrays
    takes them."""
    arrays = {f: None if getattr(jd, f) is None else np.asarray(
        getattr(jd, f)) for f in jd._ARRAY_FIELDS}
    meta = {f: getattr(jd, f) for f in META_FIELDS}
    return arrays, meta


def assert_scenes_equal(a, b):
    for f in TENSOR_FIELDS:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def test_native_sah_library_loaded():
    # The SAH build the bakes call (a failed build or load raises).
    assert native.get_lib().sah_build.restype is ctypes.c_int64


def test_loader_matches(columns_glb):
    js = jgltf.load(columns_glb)
    ts = tgltf.load(columns_glb)
    assert js.triangle_count == ts.triangle_count
    assert np.array_equal(js.materials, ts.materials)
    for a, b in zip(js.primitives, ts.primitives):
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.positions, b.positions)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bake_matches_jax(name, request):
    path = request.getfixturevalue(FIXTURES[name])
    jd = jax_build(jgltf.load(path), build_bvh=True, max_leaf_size=28)
    td = build_device_scene(tgltf.load(path), max_leaf_size=28,
                            device="cpu")
    arrays, meta = jax_scene_arrays(jd)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_attr",
              "tex_texels", "tex_offset", "tex_width", "tex_height"):
        assert np.array_equal(getattr(td, f).numpy().view(np.uint8),
                              arrays[f].view(np.uint8)), f
    assert np.array_equal(td.tri_material.numpy(), arrays["tri_material"])
    assert np.array_equal(td.mat_packed.numpy(),
                          arrays["mat_packed"].astype(np.int64))
    assert np.array_equal(td.leaves.numpy().reshape(td.leaves.shape[0], -1),
                          arrays["tri_blocks"])
    assert np.array_equal(td.root_lo.numpy(), arrays["bvh_packed"][0, 0:3])
    assert np.array_equal(td.root_hi.numpy(), arrays["bvh_packed"][0, 3:6])
    for f in META_FIELDS:
        assert getattr(td, f) == meta[f], f
    # The bridge re-lays the JAX quad rows out; it must give the port's
    # own tables (root-leaf trees have no JAX quad rows at all).
    assert_scenes_equal(scene_from_jax_arrays(arrays, meta, "cpu"), td)


def test_quad_tables_layout(columns_glb):
    td = build_device_scene(tgltf.load(columns_glb), max_leaf_size=28,
                            device="cpu")
    link = td.quad_link.numpy()
    box = td.quad_box.numpy()
    n_leaves = td.leaves.shape[0]
    empty = link == EMPTY
    assert empty.any(), "columns at leaf 28 has empty quad slots"
    assert np.all(box[empty] == 0.0)
    inner = link[(link >= 0)]
    assert inner.max() < link.shape[0] and (inner > 0).all()
    leaf_ids = -link[(link < 0) & ~empty] - 1
    # Every leaf block is referenced exactly once.
    assert np.array_equal(np.sort(leaf_ids), np.arange(n_leaves))
    assert np.isfinite(box).all()


def test_bake_places_tables_on_device(box_glb):
    """The bake puts every table on the requested device."""
    td = build_device_scene(tgltf.load(box_glb), max_leaf_size=4,
                            device="cpu")
    assert all(getattr(td, f).device == torch.device("cpu")
               for f in TENSOR_FIELDS)
    assert td.device == torch.device("cpu")
