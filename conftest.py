"""Repository-wide pytest hook: the JAX package's native library is
made whole before any test module is collected.

The JAX package's loader (vulkan_pathtracer_tpu/ops/native.py) runs
``make -C native`` in place when ``native/libvkpt_native.so`` is
missing, and caches a failed load for the rest of its process.  Under
pytest-xdist several workers would do that at once while they collect
(tests/test_native.py decides its skip at collection), and a worker
that loads the file half written skips or bakes with another tree.
``pytest_configure`` runs in the controller before the workers start
(and again in each worker, where it finds the library whole): it builds
the file under the port's lock (tests/native_guard.py).  It imports
neither JAX nor torch.
"""

import warnings


def pytest_configure(config):
    from tests.native_guard import make_jax_library_whole

    try:
        make_jax_library_whole()
    except RuntimeError as exc:   # no toolchain: the tests that need it say so
        warnings.warn(f"native/libvkpt_native.so not built: {exc}")
