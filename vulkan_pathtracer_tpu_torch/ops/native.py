"""ctypes bindings for the native (C++) host runtime.

The port's own copy of ``vulkan_pathtracer_tpu/ops/native.py`` (the
callers the port has: SAH/LBVH build, instance triangle bake, normal
transform, octant orders).  It loads the repo's ``native/`` library,
which belongs to neither package.

The reference's host side is entirely native (Zig + vendored C); our
host-side hot loops — LBVH build and instance triangle bake — live in
``native/*.cpp`` compiled to ``libvkpt_native.so``.  This module loads
it lazily, attempts a one-shot ``make`` if it's missing, and every
caller has a pure-NumPy fallback so the framework keeps working
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libvkpt_native.so")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    lib.lbvh_build.restype = ctypes.c_int64
    lib.lbvh_build.argtypes = [
        _f32p, _f32p, _f32p,
        ctypes.c_int64, ctypes.c_int,
        _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i64p,
    ]
    try:
        lib.sah_build.restype = ctypes.c_int64
        lib.sah_build.argtypes = lib.lbvh_build.argtypes
    except AttributeError:
        pass
    lib.bake_triangles.restype = None
    lib.bake_triangles.argtypes = [
        _f32p, ctypes.c_int64, _u32p, ctypes.c_int64,
        _f64p, _f64p, _f64p,
        _f32p, _f32p, _f32p, _f32p,
    ]
    lib.transform_points.restype = None
    lib.transform_points.argtypes = [_f32p, ctypes.c_int64, _f64p, _f64p, _f32p]
    lib.transform_dirs.restype = None
    lib.transform_dirs.argtypes = [_f32p, ctypes.c_int64, _f64p, _f32p]
    lib.lbvh_octant_orders.restype = ctypes.c_int
    lib.lbvh_octant_orders.argtypes = [
        ctypes.c_int64, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
        _i32p, _i32p, _i32p, _i32p,
    ]
    _LIB = lib
    return _LIB


def lbvh_build_native(tri_v0: np.ndarray, tri_e1: np.ndarray,
                      tri_e2: np.ndarray, max_leaf_size: int,
                      builder: str = "lbvh"):
    """Returns the same tuple layout ops.bvh.HostBVH uses, or None if
    the native library is unavailable.  builder: "lbvh" (Morton) or
    "sah" (binned SAH — better trees, slower builds)."""
    lib = get_lib()
    if lib is None:
        return None
    build_fn = lib.lbvh_build
    if builder == "sah":
        build_fn = getattr(lib, "sah_build", None)
        if build_fn is None:
            return None
    n = tri_v0.shape[0]
    cap = max(2 * n, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    leaf_first = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    tri_order = np.empty(n, np.int64)
    count = build_fn(
        np.ascontiguousarray(tri_v0, np.float32),
        np.ascontiguousarray(tri_e1, np.float32),
        np.ascontiguousarray(tri_e2, np.float32),
        n, max_leaf_size,
        bmin.reshape(-1), bmax.reshape(-1), skip, leaf_first, leaf_count,
        left, right, tri_order,
    )
    if count <= 0:
        return None
    return (
        bmin[:count].copy(), bmax[:count].copy(), skip[:count].copy(),
        leaf_first[:count].copy(), leaf_count[:count].copy(),
        left[:count].copy(), right[:count].copy(), tri_order,
    )


def bake_triangles_native(positions: np.ndarray, indices: np.ndarray,
                          A: np.ndarray, t: np.ndarray, N: np.ndarray):
    """World-space triangle bake (v0, e1, e2, geometric normal) for one
    instance — the native fast path of device_scene._bake_instance.
    Bit-identical to the NumPy bake (see native/ingest.cpp rounding
    notes). Returns (v0, e1, e2, gn) each (T, 3) f32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices.reshape(-1), np.uint32)
    n_tris = idx.shape[0] // 3
    v0 = np.empty((n_tris, 3), np.float32)
    e1 = np.empty((n_tris, 3), np.float32)
    e2 = np.empty((n_tris, 3), np.float32)
    gn = np.empty((n_tris, 3), np.float32)
    lib.bake_triangles(
        np.ascontiguousarray(positions, np.float32).reshape(-1),
        positions.shape[0], idx, n_tris,
        np.ascontiguousarray(A, np.float64).reshape(-1),
        np.ascontiguousarray(t, np.float64).reshape(-1),
        np.ascontiguousarray(N, np.float64).reshape(-1),
        v0.reshape(-1), e1.reshape(-1), e2.reshape(-1), gn.reshape(-1),
    )
    return v0, e1, e2, gn


def transform_dirs_native(dirs: np.ndarray, N: np.ndarray):
    """Direction transform by a 3x3 (normals/tangents), or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((dirs.shape[0], 3), np.float32)
    lib.transform_dirs(
        np.ascontiguousarray(dirs, np.float32).reshape(-1),
        dirs.shape[0],
        np.ascontiguousarray(N, np.float64).reshape(-1),
        out.reshape(-1),
    )
    return out


def octant_orders_native(bmin, bmax, left, right, leaf_first, leaf_count):
    """8 direction-octant DFS linearizations; returns
    (skip8, leaf_first8, leaf_count8, perm8) each (8, Nn), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = bmin.shape[0]
    skip8 = np.empty((8, n), np.int32)
    leaf_first8 = np.empty((8, n), np.int32)
    leaf_count8 = np.empty((8, n), np.int32)
    perm8 = np.empty((8, n), np.int32)
    rc = lib.lbvh_octant_orders(
        n,
        np.ascontiguousarray(bmin, np.float32).reshape(-1),
        np.ascontiguousarray(bmax, np.float32).reshape(-1),
        np.ascontiguousarray(left, np.int32),
        np.ascontiguousarray(right, np.int32),
        np.ascontiguousarray(leaf_first, np.int32),
        np.ascontiguousarray(leaf_count, np.int32),
        skip8.reshape(-1), leaf_first8.reshape(-1),
        leaf_count8.reshape(-1), perm8.reshape(-1),
    )
    if rc != 0:
        return None
    return skip8, leaf_first8, leaf_count8, perm8
