"""PyTorch port vs JAX: RNG streams and unorm8 packing, bit for bit.

The port carries uint32 state as int64 masked to 32 bits (PyTorch has
no uint32 shifts on the CPU); every case here includes states and
pixel coordinates >= 2^31, where a signed or unmasked version would
diverge.  Tolerance: none — the RNG stream is an exact contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu.ops import packing as jpacking
from vulkan_pathtracer_tpu.ops import rng as jrng
from vulkan_pathtracer_tpu_torch.ops import packing as tpacking
from vulkan_pathtracer_tpu_torch.ops import rng as trng


def _u32(rng, n, lo=0):
    return rng.integers(lo, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prng_seed_bit_exact(seed):
    rng = np.random.default_rng(seed)
    px = _u32(rng, 4096)
    py = _u32(rng, 4096, lo=2 ** 31)  # the high half, where uint32 wraps
    frame = int(_u32(rng, 1)[0])
    jx, jy = jrng.prng_seed(jnp.asarray(px), jnp.asarray(py),
                            jnp.uint32(frame))
    tx, ty = trng.prng_seed(_t(px), _t(py), frame)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy).astype(np.int64))


def test_prng_seed_frame_tensor_and_pixel_grid():
    xs, ys = np.meshgrid(np.arange(97, dtype=np.uint32),
                         np.arange(33, dtype=np.uint32))
    for frame in (0, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        jx, jy = jrng.prng_seed(jnp.asarray(xs.ravel()),
                                jnp.asarray(ys.ravel()), jnp.uint32(frame))
        tx, ty = trng.prng_seed(_t(xs.ravel()), _t(ys.ravel()),
                                torch.tensor(frame, dtype=torch.int64))
        assert np.array_equal(tx.numpy(), np.asarray(jx).astype(np.int64))
        assert np.array_equal(ty.numpy(), np.asarray(jy).astype(np.int64))


@pytest.mark.parametrize("seed", [3, 4])
def test_pcg2d_stream_bit_exact(seed):
    """Eight chained draws: states equal as integers, uniforms equal
    bit for bit."""
    rng = np.random.default_rng(seed)
    sx_np = _u32(rng, 2048)
    sy_np = _u32(rng, 2048)
    sx_np[:4] = [0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1]
    jx, jy = jnp.asarray(sx_np), jnp.asarray(sy_np)
    tx, ty = _t(sx_np), _t(sy_np)
    for _ in range(8):
        jx, jy, jfx, jfy = jrng.pcg2d(jx, jy)
        tx, ty, tfx, tfy = trng.pcg2d(tx, ty)
        assert np.array_equal(tx.numpy(), np.asarray(jx).astype(np.int64))
        assert np.array_equal(ty.numpy(), np.asarray(jy).astype(np.int64))
        assert np.array_equal(tfx.numpy().view(np.uint32),
                              np.asarray(jfx).view(np.uint32))
        assert np.array_equal(tfy.numpy().view(np.uint32),
                              np.asarray(jfy).view(np.uint32))


def test_pcg2d_matches_python_model():
    for sx, sy in [(0, 0), (2 ** 31, 12345), (2 ** 32 - 1, 2 ** 32 - 2)]:
        nx, ny, _, _ = trng.pcg2d(torch.tensor([sx]), torch.tensor([sy]))
        assert (int(nx[0]), int(ny[0])) == jrng.pcg2d_reference_u32(sx, sy)


def test_unpack_unorm4x8_exact():
    rng = np.random.default_rng(5)
    words = _u32(rng, 4096)
    words[:3] = [0, 0xFFFFFFFF, 0x80FF0001]
    ref = jpacking.unpack_unorm4x8(jnp.asarray(words))
    got = tpacking.unpack_unorm4x8(_t(words))
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(r).view(np.uint32))


def test_pack_unorm4x8_matches():
    rng = np.random.default_rng(6)
    for vals in rng.uniform(-0.5, 1.5, size=(64, 4)):
        assert tpacking.pack_unorm4x8(*vals) == jpacking.pack_unorm4x8(*vals)
