"""Both packages' native libraries, complete, before a parity test bakes.

The port builds ``native/`` into its own hashed directory under a lock
(vulkan_pathtracer_tpu_torch/ops/native.py).  The JAX package's loader
still runs ``make -C native`` into ``native/libvkpt_native.so`` in
place when the file is missing: a second loader that meets the file
half written fails in ``ctypes.CDLL``, caches "no library" for the rest
of its process, and that process then bakes its scenes with the NumPy
LBVH instead of the SAH.  The port's parity tests bake one scene through
both packages and compare them, so before they run, once per worker,
``ensure_native_libraries``:

- takes the port's build lock;
- loads ``native/libvkpt_native.so`` in a subprocess and, where that
  fails (missing or partly written), links it into a temporary file and
  moves it into place;
- resets the JAX loader's cached failure, if an earlier race left one;
- asserts that both packages hold a library.

A machine without a C++ toolchain then fails with one message.

Stress run (``python -m tests.native_guard --stress 6`` from the repo
root): deletes both builds, starts that many processes at once, each of
which takes the guard and bakes the columns scene through both
packages, and checks that every one of them got the SAH tree.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

from vulkan_pathtracer_tpu.ops import native as jax_native
from vulkan_pathtracer_tpu_torch.ops import native as port_native

JAX_LIB = os.path.join(port_native.NATIVE_DIR, port_native.LIB_NAME)
ATTEMPTS = 5   # a JAX loader in another worker may still be linking in place
_LOADS = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
          "lib.sah_build; lib.bake_triangles; lib.lbvh_octant_orders")


def _loads(path: str) -> bool:
    """Whether a fresh process loads the library at ``path``."""
    return subprocess.run([sys.executable, "-c", _LOADS, path],
                          capture_output=True).returncode == 0


def ensure_native_libraries(mp: pytest.MonkeyPatch) -> None:
    """Make native/libvkpt_native.so whole, reset the JAX loader's cached
    failure through ``mp``, and assert both packages hold a library."""
    for _ in range(ATTEMPTS):
        with port_native.build_lock():
            if not _loads(JAX_LIB):
                port_native.make_into(JAX_LIB)
            if jax_native._LIB is None and jax_native._TRIED:
                mp.setattr(jax_native, "_TRIED", False)
            if jax_native.get_lib() is not None:
                break
        time.sleep(1.0)
    assert jax_native.get_lib() is not None, (
        f"the JAX package could not load {JAX_LIB}, which a fresh process "
        f"loads: it bakes with the NumPy LBVH, not the SAH")
    assert port_native.get_lib() is not None


@pytest.fixture(scope="session")
def native_libraries():
    """Once per worker: both packages' native libraries loaded."""
    with pytest.MonkeyPatch.context() as mp:
        ensure_native_libraries(mp)
        yield


def _bake_columns(path: str) -> str:
    """Bake the columns scene through both packages (leaf 28); returns
    the digest of the port's triangle order after checking that the JAX
    bake has the same."""
    import numpy as np
    from vulkan_pathtracer_tpu.models import gltf as jgltf
    from vulkan_pathtracer_tpu.models.device_scene import (
        build_device_scene as jax_build,
    )
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )

    with pytest.MonkeyPatch.context() as mp:
        ensure_native_libraries(mp)
        jd = jax_build(jgltf.load(path), max_leaf_size=28)
        td = build_device_scene(gltf.load(path), max_leaf_size=28,
                                device="cpu")
    jv = np.asarray(jd.tri_v0)
    tv = td.tri_v0.numpy()
    assert np.array_equal(jv, tv), "JAX and port bakes differ"
    return hashlib.sha256(tv.tobytes()).hexdigest()[:16]


def _stress(n: int) -> int:
    from assets.procedural import make_columns

    work = tempfile.mkdtemp(prefix="native_stress_")
    path = os.path.join(work, "columns.glb")
    make_columns(path, grid=4, segments=3, n_materials=4)
    if os.path.exists(JAX_LIB):
        os.remove(JAX_LIB)
    shutil.rmtree(port_native.BUILD_DIR, ignore_errors=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.native_guard", "--bake", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(n)]
    outs = [p.communicate() for p in procs]
    digests = [o[0].strip().splitlines()[-1] if p.returncode == 0 else None
               for p, o in zip(procs, outs)]
    # The SAH reference: the port's bake in this process, whose library
    # one of the stressed processes built (the port has no other tree).
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )

    ref = hashlib.sha256(build_device_scene(
        gltf.load(path), max_leaf_size=28,
        device="cpu").tri_v0.numpy().tobytes()).hexdigest()[:16]
    shutil.rmtree(work, ignore_errors=True)
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        print(f"process {i}: rc {p.returncode} tree {digests[i]}"
              + ("" if p.returncode == 0 else f"\n{err}"))
    ok = all(d == ref for d in digests)
    builds = os.listdir(port_native.BUILD_DIR)
    print(f"SAH reference {ref}; {sum(d == ref for d in digests)} of {n} "
          f"processes got it; build dirs {sorted(builds)}")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--stress", type=int, default=0)
    ap.add_argument("--bake", default=None)
    a = ap.parse_args()
    if a.bake:
        import jax

        jax.config.update("jax_platforms", "cpu")
        print(_bake_columns(a.bake))
        sys.exit(0)
    sys.exit(_stress(a.stress or 6))
