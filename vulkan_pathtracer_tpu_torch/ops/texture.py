"""Bilinear texture sampling over a flat texel pool (port of ops/texture.py).

Linear filter, repeat wrap, no mips, texels read linearly as byte/255
(RayTracingPipeline.zig:54-70, r8g8b8a8_unorm).  Texture 0 is a 1x1
white dummy so "no texture" lanes multiply by exactly 1.0.
"""

from __future__ import annotations

import torch


def sample_bilinear(tex_texels, tex_offset, tex_width, tex_height,
                    tex_index, uv):
    """Sample textures[tex_index] at uv with repeat wrap + bilinear.

    tex_texels: (P, 4) uint8; tex_offset/width/height: (NT,) int32;
    tex_index: (N,) integer; uv: (N, 2) f32.  Returns (N, 4) f32.
    """
    tex_index = tex_index.long()
    off = tex_offset[tex_index]
    w = tex_width[tex_index]
    h = tex_height[tex_index]
    x = uv[:, 0] * w.to(torch.float32) - 0.5
    y = uv[:, 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def wrap(i, extent):
        return torch.remainder(i.to(torch.int32), extent)

    x0i = wrap(x0, w)
    x1i = wrap(x0 + 1.0, w)
    y0i = wrap(y0, h)
    y1i = wrap(y0 + 1.0, h)

    def fetch(xi, yi):
        addr = (off + yi * w + xi).long()
        return tex_texels[addr].to(torch.float32) * (1.0 / 255.0)

    top = fetch(x0i, y0i) * (1.0 - fx) + fetch(x1i, y0i) * fx
    bot = fetch(x0i, y1i) * (1.0 - fx) + fetch(x1i, y1i) * fx
    return top * (1.0 - fy) + bot * fy
