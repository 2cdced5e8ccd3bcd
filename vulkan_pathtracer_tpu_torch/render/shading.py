"""Hit-point attribute fetch + material evaluation.

Port of the packed-row path of
``vulkan_pathtracer_tpu/render/shading.py``:

- ``get_triangle_data`` == triangle.glsl:46-112: one (34,) row gather
  per hit (``scene.tri_attr``), barycentric interpolation, normalize.
  Two-level scenes (shading.py:58-99) decode the hit id first
  (``tri = (inst << mb_bits | mesh block) * block + k``), read the
  shared object-space row and transform the interpolated normal and
  tangent and the geometric normal by the instance normal matrix.
- ``get_material_data`` == material.glsl:31-68: one (8,) material-row
  gather, RGBA8 factor unpack, factor x texture, TBN normal mapping
  (not re-normalized, as in the reference).
- ``get_emissive_lean``: last-bounce fetch of the emissive factor only,
  for flat textureless scenes (same values as the full fetch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vulkan_pathtracer_tpu_torch.ops.packing import unpack_unorm4x8
from vulkan_pathtracer_tpu_torch.ops.texture import sample_bilinear
from vulkan_pathtracer_tpu_torch.ops.vecmath import cross, normalize


class TriangleData(NamedTuple):
    uv: torch.Tensor               # (N, 2)
    normal: torch.Tensor           # (N, 3) shading normal (world)
    tangent: torch.Tensor          # (N, 4) xyz world + w handedness
    geometry_normal: torch.Tensor  # (N, 3)
    material_index: torch.Tensor   # (N,) int32
    primitive_index: torch.Tensor  # (N,) int32
    triangle_index: torch.Tensor   # (N,) int32


class MaterialData(NamedTuple):
    albedo: torch.Tensor     # (N, 4)
    normal: torch.Tensor     # (N, 3)
    emissive: torch.Tensor   # (N, 3)
    roughness: torch.Tensor  # (N,)
    metallic: torch.Tensor   # (N,)


def _normal_xform(nrm, v: torch.Tensor) -> torch.Tensor:
    """N v per lane for (N, 9) row-major normal matrices ``nrm``; v
    itself when ``nrm`` is None (flat scenes)."""
    if nrm is None:
        return v
    return torch.stack(
        [nrm[:, 3 * j] * v[:, 0] + nrm[:, 3 * j + 1] * v[:, 1]
         + nrm[:, 3 * j + 2] * v[:, 2] for j in range(3)], dim=-1)


def get_triangle_data(scene, hit) -> TriangleData:
    """Gather + interpolate hit attributes.  Lanes with tri < 0 give
    finite garbage; callers mask on the hit flag."""
    tri = torch.clamp(hit.tri, min=0).long()
    w1 = hit.u[:, None]
    w2 = hit.v[:, None]
    w0 = 1.0 - hit.u - hit.v
    w0 = w0[:, None]
    nrm = None
    if scene.instanced:
        block = scene.max_leaf_size
        vblock = tri // block
        mesh_tri = ((vblock & ((1 << scene.mb_bits) - 1)) * block
                    + (tri - vblock * block))
        row = scene.tri_attr[mesh_tri]
        nrm = scene.inst_nrm[vblock >> scene.mb_bits]
        geometry_normal = normalize(_normal_xform(nrm, row[:, 27:30]))
    else:
        row = scene.tri_attr[tri]
        geometry_normal = row[:, 27:30]
    normal = normalize(_normal_xform(nrm, row[:, 0:3] * w0 + row[:, 3:6] * w1
                                     + row[:, 6:9] * w2))
    tangent4 = row[:, 9:13] * w0 + row[:, 13:17] * w1 + row[:, 17:21] * w2
    tangent = torch.cat([normalize(_normal_xform(nrm, tangent4[:, :3])),
                         tangent4[:, 3:4]], dim=-1)
    uv = row[:, 21:23] * w0 + row[:, 23:25] * w1 + row[:, 25:27] * w2
    ids = row[:, 30:33].contiguous().view(torch.int32)
    return TriangleData(
        uv=uv,
        normal=normal,
        tangent=tangent,
        geometry_normal=geometry_normal,
        material_index=ids[:, 0],
        primitive_index=ids[:, 1],
        triangle_index=ids[:, 2],
    )


def get_material_data(scene, tri_data: TriangleData) -> MaterialData:
    """material.glsl:31-68; texture sampling is skipped for textureless
    scenes (the dummy white texel multiplies by exactly 1.0)."""
    mrow = scene.mat_packed[tri_data.material_index.long()]

    def sample(col):
        return sample_bilinear(scene.tex_texels, scene.tex_offset,
                               scene.tex_width, scene.tex_height,
                               mrow[:, col], tri_data.uv)

    textured = bool(scene.has_textures)
    albedo = torch.stack(unpack_unorm4x8(mrow[:, 0]), dim=-1)
    if textured:
        albedo = albedo * sample(3)
    _, mr_g, mr_b, _ = unpack_unorm4x8(mrow[:, 1])
    if textured:
        mr_tex = sample(4)
        roughness = mr_g * mr_tex[:, 1]
        metallic = mr_b * mr_tex[:, 2]
    else:
        roughness = mr_g
        metallic = mr_b
    er, eg, eb, _ = unpack_unorm4x8(mrow[:, 2])
    emissive = torch.stack([er, eg, eb], dim=-1)
    if textured:
        emissive = emissive * sample(5)[:, :3]

    normal = tri_data.normal
    if textured:
        nrm_tex = sample(6)[:, :3]
        n_ts = normalize(2.0 * nrm_tex - 1.0)
        tangent_xyz = tri_data.tangent[:, :3]
        bitangent = (cross(tri_data.normal, tangent_xyz)
                     * tri_data.tangent[:, 3:4])
        mapped = (tangent_xyz * n_ts[:, 0:1] + bitangent * n_ts[:, 1:2]
                  + tri_data.normal * n_ts[:, 2:3])
        normal = torch.where((mrow[:, 7] != 0)[:, None], mapped,
                             tri_data.normal)
    return MaterialData(albedo=albedo, normal=normal, emissive=emissive,
                        roughness=roughness, metallic=metallic)


def get_emissive_lean(scene, hit):
    """Emissive factor only (flat textureless scenes); None when
    textured or instanced — callers then take the full fetch."""
    if scene.instanced or bool(scene.has_textures):
        return None
    tri = torch.clamp(hit.tri, min=0).long()
    m = scene.tri_material[tri].long()
    er, eg, eb, _ = unpack_unorm4x8(scene.mat_packed[m, 2])
    return torch.stack([er, eg, eb], dim=-1)
