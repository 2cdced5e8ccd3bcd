"""ctypes bindings for the native (C++) host runtime.

The port's own copy of ``vulkan_pathtracer_tpu/ops/native.py`` (the
callers the port has: SAH/LBVH build, instance triangle bake, normal
transform, octant orders).  The host-side hot loops live in the repo's
``native/*.cpp``, which belong to neither package.

The port builds them itself, with the repo's ``native/Makefile`` and
its flags, into ``build/native/<hash>/libvkpt_native.so`` at the root
of the checkout (``build/`` is git-ignored), keyed by a hash of the
sources and the Makefile.  The build holds an exclusive ``flock`` on
``build/native/.lock`` and links into a temporary file that
``os.replace`` moves into place, so no process, however many start
together, loads a partly written library.  A failed build or load
raises with the compiler's or the loader's message; nothing falls back
to another tree builder behind the caller's back (ops/bvh.py's NumPy
LBVH is asked for explicitly, ``use_native=False``).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
LIB_NAME = "libvkpt_native.so"

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def build_lock():
    """An open file holding the exclusive build lock (close it to
    release); every builder of ``native/`` in this checkout takes it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    f = open(os.path.join(BUILD_DIR, ".lock"), "a")
    fcntl.flock(f, fcntl.LOCK_EX)
    return f


def make_into(path: str) -> None:
    """Link ``native/`` with its Makefile into a temporary file beside
    ``path`` and move it into place; raises with make's output."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["make", "-C", NATIVE_DIR, f"TARGET={tmp}"],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build (make -C {NATIVE_DIR}) could not "
                           f"run: {e}") from e
    if proc.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"native build failed (make -C {NATIVE_DIR}, rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def build() -> str:
    """Build native/ into its hashed directory (unless built) and return
    the library path."""
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp"))
                       + glob.glob(os.path.join(NATIVE_DIR, "*.h"))
                       + [os.path.join(NATIVE_DIR, "Makefile")]):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, digest.hexdigest()[:16], LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    with build_lock():
        if not os.path.exists(lib_path):   # another process may have won
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            make_into(lib_path)
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The native library, built at first call; raises if it cannot be
    built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"native library {path} failed to load: {e}") from e

    lib.lbvh_build.restype = ctypes.c_int64
    lib.lbvh_build.argtypes = [
        _f32p, _f32p, _f32p,
        ctypes.c_int64, ctypes.c_int,
        _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i64p,
    ]
    lib.sah_build.restype = ctypes.c_int64
    lib.sah_build.argtypes = lib.lbvh_build.argtypes
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
    """Returns the same tuple layout ops.bvh.HostBVH uses.  builder:
    "lbvh" (Morton) or "sah" (binned SAH — better trees, slower
    builds)."""
    lib = get_lib()
    build_fn = {"lbvh": lib.lbvh_build, "sah": lib.sah_build}[builder]
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
        raise RuntimeError(f"native {builder}_build failed ({count}) on "
                           f"{n} triangles")
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
    notes). Returns (v0, e1, e2, gn) each (T, 3) f32."""
    lib = get_lib()
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


def transform_points_native(points: np.ndarray, A: np.ndarray,
                            t: np.ndarray):
    """Point transform by a 3x3 ``A`` and a translation ``t`` (f32 in
    and out, the products in float64): world-space positions."""
    lib = get_lib()
    out = np.empty((points.shape[0], 3), np.float32)
    lib.transform_points(
        np.ascontiguousarray(points, np.float32).reshape(-1),
        points.shape[0],
        np.ascontiguousarray(A, np.float64).reshape(-1),
        np.ascontiguousarray(t, np.float64).reshape(-1),
        out.reshape(-1),
    )
    return out


def transform_dirs_native(dirs: np.ndarray, N: np.ndarray):
    """Direction transform by a 3x3 (normals/tangents)."""
    lib = get_lib()
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
    (skip8, leaf_first8, leaf_count8, perm8) each (8, Nn), or None
    where the native walk refuses the tree."""
    lib = get_lib()
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
