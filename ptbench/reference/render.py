"""The plain reference path tracer: pixels of frames, from the scene's
glTF, the camera's pose and the frame counter alone.

It follows the reference renderer (antlilja/vulkan-pathtracer,
``ray_gen.rgen``, ``rand.glsl``, ``brdf.glsl``, ``triangle.glsl``,
``material.glsl``) formula for formula, lane by lane, with no sort, no
chunked wavefront and no kernel: per pixel, a primary ray through the
pixel centre, a PCG2D stream seeded from (pixel, frame), and up to
``bounces`` segments, each a closest hit in the reference's own tree
(``tree.walk``), the sky gradient on a miss, the emissive term on a
hit, and a mixture BRDF sample (Disney-style diffuse, GGX visible
normals) for the next segment.  The arithmetic runs in ``dtype``:
float32, the configuration's precision, or bfloat16 for the control.
Copies of the formulas, not imports: nothing of the program is used.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptbench.reference import tree as walk_tree
from ptbench.reference.gltf import load_triangles

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
EMISSIVE_SCALE = 10.0       # ray_gen.rgen:75
ORIGIN_OFFSET = 1e-5        # ray_gen.rgen:86
ROUGHNESS_FLOOR = 0.006     # ray_gen.rgen:84
F0_DIELECTRIC = 0.02        # ray_gen.rgen:82
M_PI = 3.141592653589793238462643
LANES = 1 << 20             # lanes traced together

_MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223
_GOLDEN = 0x9E3779B9
_TO_FLOAT = 2.32830643654e-10   # rand.glsl's constant


# -- rand.glsl ---------------------------------------------------------------
def _mul32(a, c: int):
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def prng_seed(px, py, frame):
    """rand.glsl:89-94 on int64 tensors holding uint32 values."""
    frame = frame & _MASK
    sx = (_mul32(px & _MASK, _GOLDEN) + frame) & _MASK
    sy = (_mul32(py & _MASK, _GOLDEN) + frame) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return _mul32(sx, _GOLDEN), _mul32(sy, _GOLDEN)


def pcg2d(sx, sy, dtype):
    """rand.glsl:76-87: the next state and two uniforms in [0, 1)."""
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
    scale = torch.tensor(_TO_FLOAT, dtype=torch.float32)
    return (sx, sy, (sx.to(torch.float32) * scale).to(dtype),
            (sy.to(torch.float32) * scale).to(dtype))


# -- vector helpers ----------------------------------------------------------
def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v * torch.rsqrt(dot(v, v))[..., None]


def mix(a, b, t):
    return a * (1.0 - t) + b * t


# -- brdf.glsl ---------------------------------------------------------------
@dataclass
class Shading:
    normal: torch.Tensor
    out_dir: torch.Tensor
    lambert_out: torch.Tensor
    diffuse_albedo: torch.Tensor
    fresnel_0: torch.Tensor
    roughness: torch.Tensor


def _fresnel(f0, f90, cosine):
    factor = 1.0 - cosine
    factor_sq = factor * factor
    fifth = factor_sq * factor_sq * factor
    if f0.ndim == fifth.ndim + 1:
        fifth = fifth[..., None]
    return mix(f0, f90, fifth)


def brdf(s: Shading, light):
    """brdf.glsl:22-50."""
    n_dot_light = dot(s.normal, light)
    n_dot_view = s.lambert_out
    half = normalize(light + s.out_dir)
    half_dot_view = dot(half, s.out_dir)
    f90 = (half_dot_view * half_dot_view) * (2.0 * s.roughness) + 0.5
    one = torch.ones_like(f90)
    diffuse = _fresnel(one, f90, n_dot_view) * _fresnel(one, f90, n_dot_light)
    result = diffuse[..., None] * s.diffuse_albedo
    half_dot_normal = dot(half, s.normal)
    r2 = s.roughness * s.roughness
    denom = half_dot_normal * (r2 - 1.0) + 1.0
    distribution = r2 / (denom * denom)
    masking = n_dot_light * torch.sqrt((n_dot_view - r2 * n_dot_view)
                                       * n_dot_view + r2)
    shadowing = n_dot_view * torch.sqrt((n_dot_light - r2 * n_dot_light)
                                        * n_dot_light + r2)
    geometry = 0.5 / (masking + shadowing)
    specular = _fresnel(s.fresnel_0, torch.ones_like(s.fresnel_0),
                        torch.clamp(half_dot_view, min=0.0))
    result = result + (distribution * geometry)[..., None] * specular
    result = result / M_PI
    below = torch.minimum(n_dot_light, n_dot_view) < 0.0
    return torch.where(below[..., None], torch.zeros_like(result), result)


def _ggx_vndf(view, roughness, rx, ry):
    r = roughness[..., None]
    tv = normalize(torch.cat([view[..., :2] * r, view[..., 2:3]], dim=-1))
    phi = (2.0 * M_PI) * rx
    z = 1.0 - ry * (1.0 + tv[..., 2])
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    hemi = torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), z], dim=-1)
    summed = hemi + tv
    return normalize(torch.cat([summed[..., :2] * r, summed[..., 2:3]],
                               dim=-1))


def _ggx_density(n_dot_view, view, light, normal, roughness):
    half = normalize(light + view)
    half_dot_view = dot(half, view)
    half_dot_normal = dot(half, normal)
    r2 = roughness * roughness
    inv_r2 = 1.0 - r2
    denom = n_dot_view + torch.sqrt(r2 + inv_r2 * n_dot_view * n_dot_view)
    d_vis = torch.clamp(half_dot_view, min=0.0) * (2.0 / M_PI) / denom
    m = 1.0 - inv_r2 * half_dot_normal * half_dot_normal
    density = d_vis * r2 / (m * m)
    density = torch.where(half_dot_normal < 0.0, torch.zeros_like(density),
                          density)
    return density / (4.0 * half_dot_view)


def _frame(normal):
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = torch.where(nz > 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    col0 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    col1 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return col0, col1, normal


def _diffuse_probability(s: Shading):
    a = s.diffuse_albedo
    return torch.clamp(a[..., 0] * 0.2126 + a[..., 1] * 0.7152
                       + a[..., 2] * 0.0722, max=0.5)


def sample_brdf(s: Shading, rx, ry):
    """brdf.glsl:124-139."""
    col0, col1, col2 = _frame(s.normal)
    p = _diffuse_probability(s)

    def to_world(v):
        return col0 * v[..., 0:1] + col1 * v[..., 1:2] + col2 * v[..., 2:3]

    rx_d = rx / torch.clamp(p, min=1e-30)
    phi = (2.0 * M_PI) * rx_d
    radius = torch.sqrt(ry)
    z = torch.sqrt(1.0 - radius * radius)
    diffuse = to_world(torch.stack([radius * torch.cos(phi),
                                    radius * torch.sin(phi), z], dim=-1))
    rx_s = (rx - p) / (1.0 - p)
    local_view = torch.stack([dot(col0, s.out_dir), dot(col1, s.out_dir),
                              dot(col2, s.out_dir)], dim=-1)
    half = _ggx_vndf(local_view, s.roughness, rx_s, ry)
    specular = to_world(2.0 * dot(local_view, half)[..., None] * half
                        - local_view)
    return torch.where((rx < p)[..., None], diffuse, specular)


def brdf_density(s: Shading, light):
    """brdf.glsl:142-150."""
    p = _diffuse_probability(s)
    specular = _ggx_density(s.lambert_out, s.out_dir, light, s.normal,
                            s.roughness)
    diffuse = torch.clamp(dot(s.normal, light), min=0.0) / M_PI
    return mix(specular, diffuse, p)


# -- the scene ---------------------------------------------------------------
@dataclass
class Scene:
    """The reference's scene on a device: its tree, and per triangle
    the vertex normals, the geometric normal and the material."""

    tree: walk_tree.Tree
    normals: torch.Tensor    # (T, 3, 3)
    gn: torch.Tensor         # (T, 3)
    albedo: torch.Tensor     # (T, 3)
    roughness: torch.Tensor  # (T,)
    metallic: torch.Tensor   # (T,)
    emissive: torch.Tensor   # (T, 3)
    dtype: torch.dtype
    emissive_free: bool      # no triangle emits: a last bounce is an any hit


def load_scene(path: str, device="cpu", dtype=torch.float32) -> Scene:
    tri = load_triangles(path)
    m = tri.material

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    return Scene(tree=walk_tree.build_tree(tri.v0, tri.e1, tri.e2, device,
                                           dtype),
                 normals=dev(tri.normals), gn=dev(tri.gn),
                 albedo=dev(tri.albedo[m]), roughness=dev(tri.roughness[m]),
                 metallic=dev(tri.metallic[m]), emissive=dev(tri.emissive[m]),
                 dtype=dtype, emissive_free=not tri.emissive[m].any())


def sky(direction):
    """ray_gen.rgen:65-70."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=direction.dtype,
                         device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=direction.dtype,
                        device=direction.device)
    return mix(white[None, :], blue[None, :], t[:, None])


def primary_rays(vectors, px, py, width: int, height: int, dtype):
    """ray_gen.rgen:34-48: rays through the centres of pixels (px, py)."""
    dev = px.device
    pos, hor, ver, fwd = (torch.as_tensor(v, device=dev).to(dtype)
                          for v in vectors)
    w = torch.tensor(float(width), dtype=dtype, device=dev)
    h = torch.tensor(float(height), dtype=dtype, device=dev)
    sx = (px.to(dtype) + 0.5) / w * 2.0 - 1.0
    sy = (py.to(dtype) + 0.5) / h * 2.0 - 1.0
    direction = normalize(fwd[None, :] + hor[None, :] * sx[:, None]
                          - ver[None, :] * sy[:, None])
    return pos[None, :].expand(direction.shape).contiguous(), direction


def trace(scene: Scene, origin, direction, seed_x, seed_y, bounces: int,
          first=None) -> torch.Tensor:
    """The radiance of each lane's path, (N, 3) in the scene's dtype;
    ``first``: the lanes' first hit (t, triangle, u, v) where it is
    known.  The last bounce of an emissive-free scene adds only the sky,
    so it asks whether anything is hit at all."""
    n, dev, dtype = origin.shape[0], origin.device, scene.dtype
    color = torch.zeros((n, 3), dtype=dtype, device=dev)
    atten = torch.ones((n, 3), dtype=dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(bounces):
        last = j == bounces - 1
        if last and scene.emissive_free:
            hit = walk_tree.walk(scene.tree, origin, direction, alive,
                                 any_hit=True)
            color = color + torch.where((alive & ~hit)[:, None],
                                        atten * sky(direction), zero)
            break
        t, tri, u, v = (first if j == 0 and first is not None else
                        walk_tree.walk(scene.tree, origin, direction, alive))
        did_hit = alive & (tri >= 0)
        missed = alive & ~did_hit
        color = color + torch.where(missed[:, None], atten * sky(direction),
                                    zero)
        k = torch.clamp(tri, min=0)
        color = color + torch.where(
            did_hit[:, None], scene.emissive[k] * EMISSIVE_SCALE * atten, zero)
        if last:
            break
        w0 = (1.0 - u - v)[:, None]
        nv = scene.normals[k]
        normal = normalize(nv[:, 0] * w0 + nv[:, 1] * u[:, None]
                           + nv[:, 2] * v[:, None])
        albedo, metallic = scene.albedo[k], scene.metallic[k][:, None]
        out_dir = -direction
        s = Shading(normal=normal, out_dir=out_dir,
                    lambert_out=dot(normal, out_dir),
                    fresnel_0=mix(F0_DIELECTRIC, albedo, metallic),
                    diffuse_albedo=albedo - metallic * albedo,
                    roughness=torch.clamp(scene.roughness[k],
                                          min=ROUGHNESS_FLOOR))
        hit_point = (origin + t[:, None] * direction
                     + scene.gn[k] * ORIGIN_OFFSET)
        nsx, nsy, rx, ry = pcg2d(seed_x, seed_y, dtype)
        seed_x = torch.where(did_hit, nsx, seed_x)
        seed_y = torch.where(did_hit, nsy, seed_y)
        new_dir = sample_brdf(s, rx, ry)
        density = brdf_density(s, new_dir)
        lambert_in = dot(normal, new_dir)
        weight = (brdf(s, new_dir) * lambert_in[:, None]
                  / torch.clamp(density, min=1e-30)[:, None])
        survive = did_hit & ~(lambert_in <= 0.0)
        atten = torch.where(survive[:, None], atten * weight, atten)
        origin = torch.where(did_hit[:, None], hit_point, origin)
        direction = torch.where(did_hit[:, None], new_dir, direction)
        alive = survive
    return color


def render_views(scene: Scene, views, px, py, width: int, height: int,
                 bounces: int) -> torch.Tensor:
    """Radiance (V, P, 3) f32 of the pixels (px, py) of each view
    ``(vectors, frame)``: the camera's vectors (orbit.camera_vectors)
    and the frame counter; all views' lanes traced together."""
    p = px.shape[0]
    rays = [primary_rays(vectors, px, py, width, height, scene.dtype)
            for vectors, _ in views]
    origin = torch.cat([r[0] for r in rays])
    direction = torch.cat([r[1] for r in rays])
    frames = torch.cat([torch.full_like(px, int(f)) for _, f in views])
    sx, sy = prng_seed(px.repeat(len(views)), py.repeat(len(views)), frames)
    out = [trace(scene, origin[s:s + LANES], direction[s:s + LANES],
                 sx[s:s + LANES], sy[s:s + LANES], bounces).float()
           for s in range(0, origin.shape[0], LANES)]
    return torch.cat(out).view(len(views), p, 3)


def accumulate_pixels(scene: Scene, vectors, frame0: int, frames: int, px,
                      py, width: int, height: int,
                      bounces: int) -> torch.Tensor:
    """The float64 SUM (P, 3) of ``frames`` frames from ``frame0`` of a
    static camera at the pixels (px, py): a converging still.  The
    camera does not move, so each pixel's first hit is found once."""
    p = px.shape[0]
    origin, direction = primary_rays(vectors, px, py, width, height,
                                     scene.dtype)
    first = walk_tree.walk(scene.tree, origin, direction)
    total = torch.zeros((p, 3), dtype=torch.float64, device=px.device)
    per = max(LANES // max(p, 1), 1)
    for f0 in range(frame0, frame0 + frames, per):
        k = min(per, frame0 + frames - f0)
        f = torch.arange(f0, f0 + k, device=px.device).repeat_interleave(p)
        sx, sy = prng_seed(px.repeat(k), py.repeat(k), f)
        color = trace(scene, origin.repeat(k, 1), direction.repeat(k, 1),
                      sx, sy, bounces,
                      first=tuple(x.repeat(k) for x in first)).float()
        total += color.view(k, p, 3).double().sum(dim=0)
    return total
