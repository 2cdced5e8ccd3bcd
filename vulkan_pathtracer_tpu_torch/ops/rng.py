"""Counter-style PCG2D RNG, bit-exact to the reference's GLSL.

Port of ``vulkan_pathtracer_tpu/ops/rng.py`` (rand.glsl:76-94 of the
reference): ``prng_seed`` hashes (pixel, frame) into a 2-lane state and
``pcg2d`` advances it and returns two f32 uniforms in [0, 1).

PyTorch has no usable uint32 arithmetic (``>>`` on a UInt32 tensor is
not implemented on the CPU), so the state is carried as int64 tensors
holding values in [0, 2^32), and every product is reduced mod 2^32.
Products that could pass 2^63 (the golden-ratio multiply of the seed
hash) are split into 16-bit halves, so no step relies on signed
overflow.  All results are bit-exact with the uint32 reference.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223
_GOLDEN = 0x9E3779B9
# float(vec2(seed)) * 2.32830643654e-10 — the GLSL constant (not 2^-32).
_TO_FLOAT = 2.32830643654e-10


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c
    in [0, 2^32), without any intermediate above 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def prng_seed(px: torch.Tensor, py: torch.Tensor, frame):
    """Seed hash — rand.glsl:89-94.

    px, py: integer pixel coordinates (same shape); frame: int or a
    broadcastable integer tensor.  Returns (sx, sy) int64 states.
    """
    px = px.to(torch.int64) & _MASK
    py = py.to(torch.int64) & _MASK
    if isinstance(frame, torch.Tensor):
        frame = frame.to(torch.int64) & _MASK
    else:
        frame = int(frame) & _MASK
    sx = (_mul32(px, _GOLDEN) + frame) & _MASK
    sy = (_mul32(py, _GOLDEN) + frame) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return _mul32(sx, _GOLDEN), _mul32(sy, _GOLDEN)


def pcg2d(sx: torch.Tensor, sy: torch.Tensor):
    """One PCG2D step — rand.glsl:76-87.

    Returns ``(new_sx, new_sy, fx, fy)``; fx, fy are f32 uniforms from
    the updated state.  Callers commit the new state only where the
    lane drew (``torch.where``), as the reference's early breaks do.
    """
    sx = (sx * _MUL + _INC) & _MASK
    sy = (sy * _MUL + _INC) & _MASK
    sx = (sx + _MUL * sy) & _MASK
    sy = (sy + _MUL * sx) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    sx = (sx + _MUL * sy) & _MASK
    sy = (sy + _MUL * sx) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    fx = sx.to(torch.float32) * torch.tensor(_TO_FLOAT, dtype=torch.float32)
    fy = sy.to(torch.float32) * torch.tensor(_TO_FLOAT, dtype=torch.float32)
    return sx, sy, fx, fy
