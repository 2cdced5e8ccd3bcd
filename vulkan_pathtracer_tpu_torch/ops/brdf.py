"""Mixture BRDF: Disney-style diffuse + GGX-VNDF specular.

Port of ``vulkan_pathtracer_tpu/ops/brdf.py`` (the reference's
``brdf.glsl``), formula for formula, including the reference's
idiosyncrasies (the GGX denominator uses ``half_dot_normal``
un-squared, brdf.glsl:39).  Inputs are (..., 3) or (...,) f32 tensors;
both sampling branches are evaluated and selected with ``where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vulkan_pathtracer_tpu_torch.ops.vecmath import (
    dot,
    luminance,
    mix,
    normalize,
)

M_PI = 3.141592653589793238462643


class ShadingInfo(NamedTuple):
    """Mirror of brdf.glsl:6-13 (SoA over rays)."""

    normal: torch.Tensor          # (..., 3)
    out_dir: torch.Tensor         # (..., 3) — towards the viewer
    lambert_out: torch.Tensor     # (...,)   — dot(normal, out_dir)
    diffuse_albedo: torch.Tensor  # (..., 3)
    fresnel_0: torch.Tensor       # (..., 3)
    roughness: torch.Tensor       # (...,)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def fresnel_schlick(f0, f90, cosine_theta):
    """brdf.glsl:15-20.  f0/f90 may be (..., 3) or (...,)."""
    factor = 1.0 - cosine_theta
    factor_sq = factor * factor
    factor_fifth = factor_sq * factor_sq * factor
    if f0.ndim == factor_fifth.ndim + 1:
        factor_fifth = factor_fifth[..., None]
    return mix(f0, f90, factor_fifth)


def brdf(shading: ShadingInfo, light_dir):
    """Full BRDF evaluation — brdf.glsl:22-50.  Returns (..., 3)."""
    n_dot_light = dot(shading.normal, light_dir)
    n_dot_view = shading.lambert_out

    half_vector = normalize(light_dir + shading.out_dir)
    half_dot_view = dot(half_vector, shading.out_dir)

    f90 = (half_dot_view * half_dot_view) * (2.0 * shading.roughness) + 0.5
    one = torch.ones_like(f90)
    diffuse_fresnel = (fresnel_schlick(one, f90, n_dot_view)
                       * fresnel_schlick(one, f90, n_dot_light))
    result = diffuse_fresnel[..., None] * shading.diffuse_albedo

    half_dot_normal = dot(half_vector, shading.normal)
    roughness_sq = shading.roughness * shading.roughness
    denominator = half_dot_normal * (roughness_sq - 1.0) + 1.0
    distribution = roughness_sq / (denominator * denominator)

    masking = n_dot_light * torch.sqrt(
        (n_dot_view - roughness_sq * n_dot_view) * n_dot_view + roughness_sq
    )
    shadowing = n_dot_view * torch.sqrt(
        (n_dot_light - roughness_sq * n_dot_light) * n_dot_light
        + roughness_sq
    )
    geometry = 0.5 / (masking + shadowing)

    specular_fresnel = fresnel_schlick(
        shading.fresnel_0, torch.ones_like(shading.fresnel_0),
        torch.clamp(half_dot_view, min=0.0),
    )
    result = result + (distribution * geometry)[..., None] * specular_fresnel
    result = result / M_PI

    below = torch.minimum(n_dot_light, n_dot_view) < 0.0
    return torch.where(below[..., None], _zero(result), result)


def sample_ggx_vndf(view_dir, roughness, rx, ry):
    """GGX visible-normal sampling — brdf.glsl:52-66 (tangent space)."""
    r = roughness[..., None]
    transformed_view = normalize(
        torch.cat([view_dir[..., :2] * r, view_dir[..., 2:3]], dim=-1))
    phi = (2.0 * M_PI) * rx
    z = 1.0 - ry * (1.0 + transformed_view[..., 2])
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    hemisphere = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), z], dim=-1)
    summed = hemisphere + transformed_view
    return normalize(
        torch.cat([summed[..., :2] * r, summed[..., 2:3]], dim=-1))


def get_ggx_vndf_density(n_dot_view, half_dot_normal, half_dot_view,
                         roughness):
    """brdf.glsl:68-79 (0 where half_dot_normal < 0)."""
    roughness_sq = roughness * roughness
    inv_roughness_sq = 1.0 - roughness_sq
    denominator = n_dot_view + torch.sqrt(
        roughness_sq + inv_roughness_sq * n_dot_view * n_dot_view)
    d_vis = torch.clamp(half_dot_view, min=0.0) * (2.0 / M_PI) / denominator
    m_sq_term = 1.0 - inv_roughness_sq * half_dot_normal * half_dot_normal
    density = d_vis * roughness_sq / (m_sq_term * m_sq_term)
    return torch.where(half_dot_normal < 0.0, _zero(density), density)


def sample_ggx_in_dir(view_dir, roughness, rx, ry):
    """brdf.glsl:81-84: -reflect(view, half) = 2*dot(v,h)*h - v."""
    half_vector = sample_ggx_vndf(view_dir, roughness, rx, ry)
    return (2.0 * dot(view_dir, half_vector)[..., None] * half_vector
            - view_dir)


def get_ggx_in_dir_density(n_dot_view, view_dir, light_dir, normal,
                           roughness):
    """brdf.glsl:86-93."""
    half_vector = normalize(light_dir + view_dir)
    half_dot_view = dot(half_vector, view_dir)
    half_dot_normal = dot(half_vector, normal)
    density = get_ggx_vndf_density(n_dot_view, half_dot_normal,
                                   half_dot_view, roughness)
    return density / (4.0 * half_dot_view)


def get_shading_space(normal):
    """Branchless tangent frame — brdf.glsl:95-105: the columns
    (tangent, bitangent, normal) of the tangent-to-world matrix."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = torch.where(nz > 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    col0 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx],
                       dim=-1)
    col1 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return col0, col1, normal


def _to_world(col0, col1, col2, v):
    return col0 * v[..., 0:1] + col1 * v[..., 1:2] + col2 * v[..., 2:3]


def _to_local(col0, col1, col2, v):
    return torch.stack([dot(col0, v), dot(col1, v), dot(col2, v)], dim=-1)


def sample_hemisphere_psa(rx, ry):
    """Cosine hemisphere sample — brdf.glsl:107-113."""
    phi = (2.0 * M_PI) * rx
    radius = torch.sqrt(ry)
    z = torch.sqrt(1.0 - radius * radius)
    return torch.stack(
        [radius * torch.cos(phi), radius * torch.sin(phi), z], dim=-1)


def get_hemisphere_psa_density(sampled_z):
    """brdf.glsl:115-117."""
    return torch.clamp(sampled_z, min=0.0) / M_PI


def get_diffuse_sampling_probability(shading: ShadingInfo):
    """brdf.glsl:119-122: min(0.5, luminance(diffuse_albedo))."""
    return torch.clamp(luminance(shading.diffuse_albedo), max=0.5)


def sample_brdf(shading: ShadingInfo, rx, ry):
    """Mixture sampling — brdf.glsl:124-139."""
    col0, col1, col2 = get_shading_space(shading.normal)
    diffuse_prob = get_diffuse_sampling_probability(shading)
    take_diffuse = rx < diffuse_prob

    rx_d = rx / torch.clamp(diffuse_prob, min=1e-30)
    diffuse_dir = _to_world(col0, col1, col2,
                            sample_hemisphere_psa(rx_d, ry))

    rx_s = (rx - diffuse_prob) / (1.0 - diffuse_prob)
    local_view = _to_local(col0, col1, col2, shading.out_dir)
    local_light = sample_ggx_in_dir(local_view, shading.roughness, rx_s, ry)
    specular_dir = _to_world(col0, col1, col2, local_light)
    return torch.where(take_diffuse[..., None], diffuse_dir, specular_dir)


def get_brdf_density(shading: ShadingInfo, sampled_dir):
    """Mixture pdf — brdf.glsl:142-150."""
    diffuse_prob = get_diffuse_sampling_probability(shading)
    specular_density = get_ggx_in_dir_density(
        shading.lambert_out, shading.out_dir, sampled_dir, shading.normal,
        shading.roughness)
    diffuse_density = get_hemisphere_psa_density(
        dot(shading.normal, sampled_dir))
    return mix(specular_density, diffuse_density, diffuse_prob)
