"""Runtime validation (port of utils/validation.py) — the
Vulkan-validation-layer analog behind ``--enable-validation`` / ``-v``.

The JAX package runs one small frame under ``checkify`` (index, NaN and
division checks) and sets ``jax_debug_nans``.  PyTorch has neither, so
the port asserts the same conditions explicitly and raises
``ValidationError``:

- ``checked_render``: a 64x64 frame of up to 2 bounces through the
  plain per-ray ``bvh`` traversal (``brute`` without a BVH) on the
  scene's device, which checks after each bounce that the hit triangle
  ids lie in [0, num_triangles) (a two-level scene's instance and mesh
  triangle too), that the hit lanes' material rows and texture slots
  lie in their tables and every texture's texels in the texel pool
  (so every bilinear fetch stays inside it), and that every lane's
  attenuation and the image are finite.  An index past its table on
  the card would be a device-side assert that ends the process; here
  it is a typed error first.
- ``check_finite``: the per-frame NaN/Inf tripwire the CLI applies to
  every rendered image while ``-v`` is set.
- The host BVH invariants are ``ops/bvh.validate_bvh``.
"""

from __future__ import annotations

import torch

from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T
from vulkan_pathtracer_tpu_torch.render import wavefront
from vulkan_pathtracer_tpu_torch.render.pipeline import (
    camera_tensors,
    primary_rays,
)
from vulkan_pathtracer_tpu_torch.render.shading import get_triangle_data

TEXTURE_SLOTS = (3, 4, 5, 6)   # mat_packed columns of the texture indices


class ValidationError(RuntimeError):
    """A render invariant failed under --enable-validation."""


def _require(ok, what: str) -> None:
    if not bool(ok):
        raise ValidationError(what)


def check_finite(image: torch.Tensor, what: str = "image") -> None:
    """Raise ValidationError where ``image`` holds a NaN or an Inf."""
    bad = int((~torch.isfinite(image)).sum())
    _require(bad == 0, f"{what}: {bad} non-finite values")


def _in_range(x: torch.Tensor, n: int) -> bool:
    return bool(((x >= 0) & (x < n)).all())


def _check_textures(scene) -> None:
    """Every texture's texels lie in the pool: the wrapped bilinear
    fetch of ops/texture.py reads [offset, offset + w * h)."""
    off = scene.tex_offset.long()
    end = off + scene.tex_width.long() * scene.tex_height.long()
    _require((off >= 0).all() and (end <= scene.tex_texels.shape[0]).all()
             and (scene.tex_width > 0).all()
             and (scene.tex_height > 0).all(),
             "texture table: texels outside the pool")


def _check_hits(scene, hit, alive, bounce: int) -> None:
    """Triangle ids, material rows and texture slots of the hit lanes."""
    did_hit = alive & (hit.t < MISS_T)
    tri = hit.tri[did_hit].long()
    if scene.instanced:
        block = scene.max_leaf_size
        vblock = tri // block
        mesh_tri = ((vblock & ((1 << scene.mb_bits) - 1)) * block
                    + (tri - vblock * block))
        _require(_in_range(vblock >> scene.mb_bits, scene.inst_nrm.shape[0]),
                 f"bounce {bounce}: instance id out of range")
        _require(_in_range(mesh_tri, scene.num_triangles),
                 f"bounce {bounce}: mesh triangle id out of range")
    else:
        _require(_in_range(tri, scene.num_triangles),
                 f"bounce {bounce}: hit triangle id out of "
                 f"[0, {scene.num_triangles})")
    tri_data = get_triangle_data(scene, hit)
    material = tri_data.material_index[did_hit].long()
    _require(_in_range(material, scene.mat_packed.shape[0]),
             f"bounce {bounce}: material row out of range")
    slots = scene.mat_packed[material][:, list(TEXTURE_SLOTS)]
    _require(_in_range(slots, scene.tex_offset.shape[0]),
             f"bounce {bounce}: texture index out of range")


def checked_render(scene, camera, config, width: int = 64,
                   height: int = 64) -> torch.Tensor:
    """One small frame (frame 0, 1 spp, ``min(num_bounces, 2)``
    bounces) through the plain per-ray traversal, every bounce a
    closest hit, with the checks of the module docstring; raises
    ValidationError on a violation, returns the image (H, W, 3) otherwise."""
    dev = scene.device
    tiers = "bvh" if scene.has_bvh else "brute"
    position, horizontal, vertical, forward = camera_tensors(camera, dev)
    o, d, sx, sy, tile_inv = primary_rays(position, horizontal, vertical,
                                          forward, 0, width, height)
    n = o.shape[0]
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    atten = torch.ones_like(color)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    _check_textures(scene)
    bounces = min(config.num_bounces, 2)
    for j in range(bounces):
        hit = wavefront._closest_hit(scene, o, d, alive, tiers,
                                     "primary" if j == 0 else "secondary")
        _check_hits(scene, hit, alive, j)
        o, d, atten, color, sx, sy, alive = wavefront._shade_and_extend(
            scene, hit, o, d, atten, color, sx, sy, alive,
            last=j == bounces - 1,
            rr=config.russian_roulette and j + 1 >= config.rr_start_bounce)
        check_finite(atten, f"bounce {j}: attenuation")
    check_finite(color, "checked render")
    if tile_inv is not None:
        color = color[tile_inv]
    return color.reshape(height, width, 3)
