"""unorm8 packing helpers (port of ops/packing.py).

Host-side quantization matches Zig's ``@intFromFloat(f * 255.0)``
(Scene.zig:457-475); the device-side unpack is GLSL ``unpackUnorm4x8``
(byte / 255).  Component x = bits 0..7, y = 8..15, z = 16..23,
w = 24..31.  Packed words ride as int64 tensors holding uint32 values
(PyTorch's uint32 lacks shifts on the CPU).
"""

from __future__ import annotations

import torch


def pack_unorm4x8(r: float, g: float, b: float, a: float) -> int:
    """Host-side factor quantization: trunc(clamp(f, 0, 1) * 255)."""
    def q(f: float) -> int:
        return int(min(max(f, 0.0), 1.0) * 255.0)  # trunc toward zero

    return q(r) | (q(g) << 8) | (q(b) << 16) | (q(a) << 24)


def unpack_unorm4x8(word: torch.Tensor):
    """Integer tensor of uint32 words -> 4 f32 tensors in [0, 1]."""
    word = word.to(torch.int64)
    return tuple(
        ((word >> shift) & 0xFF).to(torch.float32) / 255.0
        for shift in (0, 8, 16, 24)
    )
