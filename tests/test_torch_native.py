"""The port's build of the native host library (ops/native.py).

Four processes that load the library at once from a fresh copy of
``native/`` build it once, under the lock, and all get the same SAH
tree as this process; a failed build raises with the compiler's output;
a scene bake never falls back to the NumPy LBVH when the library is
missing; ``transform_points_native`` is bitwise JAX's.  Tolerance: none
(the trees and points are compared bitwise).
"""

import glob
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from vulkan_pathtracer_tpu_torch.models import device_scene
from vulkan_pathtracer_tpu_torch.ops import native
from vulkan_pathtracer_tpu_torch.ops.bvh import build_bvh_host

from tests.native_guard import native_libraries  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TREE = """
import hashlib, sys
import numpy as np
from vulkan_pathtracer_tpu_torch.ops import native
from vulkan_pathtracer_tpu_torch.ops.bvh import build_bvh_host
t = np.load(sys.argv[1])
b = build_bvh_host(t["v0"], t["e1"], t["e2"], max_leaf_size=4)
h = hashlib.sha256()
for a in (b.tri_order, b.skip, b.leaf_first, b.leaf_count, b.bmin, b.bmax):
    h.update(np.ascontiguousarray(a).tobytes())
print(native.build(), h.hexdigest())
"""


def _tree_digest(bvh) -> str:
    h = hashlib.sha256()
    for a in (bvh.tri_order, bvh.skip, bvh.leaf_first, bvh.leaf_count,
              bvh.bmin, bvh.bmax):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _triangles(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    return v0, e1, e2


def _fresh_checkout(dst):
    """The port package and native/'s sources, no library anywhere."""
    shutil.copytree(os.path.join(ROOT, "vulkan_pathtracer_tpu_torch"),
                    os.path.join(dst, "vulkan_pathtracer_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "native"))
    for src in glob.glob(os.path.join(ROOT, "native", "*.cpp")) + [
            os.path.join(ROOT, "native", "Makefile")]:
        shutil.copy(src, os.path.join(dst, "native"))


def test_native_build_lock_four_processes(tmp_path):
    _fresh_checkout(tmp_path)
    v0, e1, e2 = _triangles()
    tris = str(tmp_path / "tris.npz")
    np.savez(tris, v0=v0, e1=e1, e2=e2)
    procs = [subprocess.Popen([sys.executable, "-c", _TREE, tris],
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs, digests = zip(*(out.split() for out, _ in outs))
    # One build, in the copy's own build directory, no temporaries.
    assert len(set(libs)) == 1
    lib_dir = os.path.dirname(libs[0])
    assert lib_dir.startswith(str(tmp_path / "build" / "native"))
    assert os.listdir(lib_dir) == [native.LIB_NAME]
    assert not glob.glob(str(tmp_path / "native" / "*.so*"))
    # Every process got this process's SAH tree, not the NumPy LBVH.
    sah = _tree_digest(build_bvh_host(v0, e1, e2, max_leaf_size=4))
    lbvh = _tree_digest(build_bvh_host(v0, e1, e2, max_leaf_size=4,
                                       use_native=False))
    assert sah != lbvh
    assert set(digests) == {sah}


def test_native_build_failure_raises_compiler_output(tmp_path, monkeypatch):
    _fresh_checkout(tmp_path)
    with open(tmp_path / "native" / "sah.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native build failed") as e:
        native.get_lib()
    assert "sah.cpp" in str(e.value) and "error" in str(e.value)
    # Nothing half built is left where the next loader would look.
    assert not glob.glob(str(tmp_path / "build" / "*" / "*.so*"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.get_lib()


def test_bake_without_library_raises(monkeypatch):
    def broken():
        raise RuntimeError("native build failed (test)")

    monkeypatch.setattr(native, "get_lib", broken)
    v0, e1, e2 = _triangles(64)
    with pytest.raises(RuntimeError, match="native build failed"):
        build_bvh_host(v0, e1, e2, max_leaf_size=4)
    with pytest.raises(RuntimeError, match="native build failed"):
        device_scene.transform_dirs_native(v0, np.eye(3))
    # The NumPy LBVH stays, asked for by name.
    assert build_bvh_host(v0, e1, e2, max_leaf_size=4,
                          use_native=False).node_count > 0


def test_transform_points_matches_jax(native_libraries):
    """``transform_points_native`` bitwise JAX's on the same inputs: a
    non-orthogonal affine transform of random f32 points (the pattern of
    tests/test_native.py:113-150), and both the f64 product rounded
    once to f32."""
    from vulkan_pathtracer_tpu.ops.native import (
        transform_points_native as jax_transform_points,
    )

    rng = np.random.default_rng(7)
    points = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    M = rng.normal(size=(3, 3)) + np.eye(3) * 2.0
    t = rng.normal(size=3) * 3.0
    got = native.transform_points_native(points, M, t)
    assert got.dtype == np.float32 and got.shape == (500, 3)
    np.testing.assert_array_equal(got, jax_transform_points(points, M, t))
    np.testing.assert_array_equal(
        got, (points.astype(np.float64) @ M.T + t).astype(np.float32))
