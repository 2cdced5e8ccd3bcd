"""Small vec3 helpers over the trailing axis (port of ops/vecmath.py).

``normalize`` is v * rsqrt(dot(v, v)) with no epsilon, like GLSL's
normalize; callers mask degenerate lanes.  ``dot`` sums x, y, z in that
order, so each product rounds once and the sum associates left.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(dot(v, v))[..., None]


def mix(a, b, t):
    """GLSL mix: a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N."""
    return i - 2.0 * dot(n, i)[..., None] * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma, constants from brdf.glsl:120."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
