"""The wavefront's shading chain as hand-written CUDA kernels
(``csrc/shade.cu``): one launch per shading call where the plain chain of
``render/wavefront.py`` makes about 200 elementwise launches.

``render/wavefront.py`` calls these from inside ``_shade_and_extend``,
``_next_segment``, ``_anyhit_sky`` and ``_pixel_shading``, and keeps its
plain chain for CPU tensors.  The choice depends only on what the code
can see in its input, as ``stack_traverse._dispatch`` does for the
traversal: CPU tensors run the plain chain (which the CPU tests hold to
the JAX package), CUDA tensors run the kernels, on flat and two-level,
textureless and textured scenes alike (a build each).

Each kernel's outputs are bitwise the plain chain's on the same device
(``csrc/shade.cu``).  ``LAUNCHES`` counts the launches by build, and
each launch is reported to the tracer (``utils.profiling.launched``)
inside the caller's ``shade`` span.  The kernels write a lane set in
place where the caller hands over its own state as ``out``; otherwise
they write fresh tensors, never into a tensor the caller still reads.
"""

from __future__ import annotations

import ctypes

import torch

from vulkan_pathtracer_tpu_torch.ops import kernels
from vulkan_pathtracer_tpu_torch.utils import profiling

# The sky gradient's two colors (ray_gen.rgen:65-70; render/wavefront.py
# sky_color), handed to the kernels as launch arguments.
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

_SCENES = ("", "_instanced", "_textured", "_instanced_textured")
LAUNCHES = {k: 0 for k in (
    *(f"shade_extend{sc}{m}" for sc in _SCENES for m in ("", "_rr", "_last")),
    *(f"pixel_shade{sc}" for sc in _SCENES),
    "joint_draw", "joint_draw_rr", "anyhit_sky")}


def fused(x: torch.Tensor) -> bool:
    """Whether work on ``x`` takes the kernels: a CUDA tensor."""
    return x.device.type == "cuda"


def _build(scene) -> str:
    """The suffix of ``scene``'s builds in ``LAUNCHES``."""
    return ("_instanced" if scene.instanced else "") + (
        "_textured" if scene.has_textures else "")


def _scene_args(scene, device, tri_material: bool) -> list:
    """The launchers' scene arguments: tri_attr, mat_packed, tri_material
    (when asked for: the flat textureless last bounce), inst_nrm, block,
    mb_bits (two-level scenes), the texel pool and its three tables
    (textured scenes); null where the scene has none."""
    kernels._check("tri_attr", scene.tri_attr, torch.float32, (None, 34))
    kernels._check("mat_packed", scene.mat_packed, torch.int64, (None, 8))
    args = [scene.tri_attr.data_ptr(), scene.mat_packed.data_ptr()]
    if tri_material:
        kernels._check("tri_material", scene.tri_material, torch.int32,
                       (None,), align=4)
        args.append(scene.tri_material.data_ptr())
    else:
        args.append(None)
    if scene.instanced:
        kernels._check("inst_nrm", scene.inst_nrm, torch.float32, (None, 9),
                       align=4)
        args += [scene.inst_nrm.data_ptr(), scene.max_leaf_size,
                 scene.mb_bits]
    else:
        args += [None, 0, 0]
    if scene.has_textures:
        kernels._check("tex_texels", scene.tex_texels, torch.uint8,
                       (None, 4), align=4)
        args.append(scene.tex_texels.data_ptr())
        for name in ("tex_offset", "tex_width", "tex_height"):
            x = getattr(scene, name)
            kernels._check(name, x, torch.int32, (None,), align=4)
            args.append(x.data_ptr())
    else:
        args += [None] * 4
    for x in (scene.tri_attr, scene.mat_packed, scene.tex_texels):
        if x.device != device:
            raise ValueError(f"scene tables on {x.device}, lanes on {device}")
    return args


def _sky():
    return (ctypes.c_float * 6)(*SKY_WHITE, *SKY_BLUE)


def _f32(name, x, n, cols=3):
    kernels._check(name, x, torch.float32, (n, cols) if cols else (n,),
                   align=4)
    return x.data_ptr()


def _i64(name, x, n):
    kernels._check(name, x, torch.int64, (n,), align=8)
    return x.data_ptr()


def _bool(name, x, n):
    kernels._check(name, x, torch.bool, (n,), align=1)
    return x.data_ptr()


def _launched(key: str, lanes: torch.Tensor) -> None:
    LAUNCHES[key] += 1
    profiling.launched(key, lanes)


def shade_extend(scene, hit, origin, direction, atten, color, seed_x,
                 seed_y, alive, *, last: bool, rr: bool, out=None):
    """``_shade_and_extend`` in one launch; the same arguments and
    result: (origin, direction, atten, color, seed_x, seed_y, alive).
    ``out``: seven tensors to write the result into (they may be the
    inputs themselves, the state written in place), returned; else
    fresh tensors.  The ``last`` bounce writes color and alive alone:
    the rest of its result is the inputs, which ``out`` must hold."""
    n = origin.shape[0]
    dev = origin.device
    if last:
        kept = (origin, direction, atten, seed_x, seed_y)
        if out is None:
            out = (*kept[:3], torch.empty_like(color), *kept[3:],
                   torch.empty_like(alive))
        elif any(o.data_ptr() != x.data_ptr()
                 for o, x in zip(out[:3] + out[4:6], kept)):
            raise ValueError("shade_extend(last=True): out must hold the "
                             "inputs' origin, direction, atten and seeds")
        outs = (None, None, None, _f32("color_out", out[3], n), None, None,
                _bool("alive_out", out[6], n))
    else:
        if out is None:
            out = tuple(torch.empty_like(x) for x in (
                origin, direction, atten, color, seed_x, seed_y, alive))
        o_out, d_out, a_out, c_out, sx_out, sy_out, alive_out = out
        outs = (_f32("origin_out", o_out, n),
                _f32("direction_out", d_out, n),
                _f32("atten_out", a_out, n), _f32("color_out", c_out, n),
                _i64("sx_out", sx_out, n), _i64("sy_out", sy_out, n),
                _bool("alive_out", alive_out, n))
    t, tri, u, v = hit
    kernels._check("hit.tri", tri, torch.int32, (n,), align=4)
    scene_args = _scene_args(
        scene, dev, last and not scene.instanced and not scene.has_textures)
    for x in (t, color):
        if x.device != dev:
            raise ValueError(f"shade_extend: tensors on {x.device} and {dev}")
    mode = 2 if last else int(rr)
    sky = _sky()
    kernels._launch(
        "shade_extend", dev, kernels.lib().vkpt_shade_extend, mode,
        *scene_args, _f32("hit.t", t, n, None), tri.data_ptr(),
        _f32("hit.u", u, n, None), _f32("hit.v", v, n, None), _f32("origin", origin, n),
        _f32("direction", direction, n), _f32("atten", atten, n),
        _f32("color", color, n), _i64("seed_x", seed_x, n),
        _i64("seed_y", seed_y, n), _bool("alive", alive, n),
        ctypes.addressof(sky), n, *outs)
    _launched("shade_extend" + _build(scene)
              + ("_last" if last else "_rr" if rr else ""), origin)
    return out


def pixel_shading(scene, hit, origin, direction, frames: int):
    """A joint batch's bounce 0 in one launch (``wavefront._pixel_shading``:
    its arguments and result): ``frames`` times the bounce's color (the
    sky or the emissive term, attenuation 1), and the per-pixel inputs
    of its frames' draws, (normal, out_dir, lambert_out, diffuse_albedo,
    fresnel_0, roughness, hit_point, origin, direction, did_hit)."""
    n = origin.shape[0]
    dev = origin.device
    t, tri, u, v = hit
    kernels._check("hit.tri", tri, torch.int32, (n,), align=4)
    scene_args = _scene_args(scene, dev, False)
    del scene_args[2]     # no tri_material
    f3 = [torch.empty((n, 3), dtype=torch.float32, device=dev)
          for _ in range(6)]
    color, normal, out_dir, diffuse_albedo, fresnel_0, hit_point = f3
    lambert_out, roughness = (torch.empty(n, dtype=torch.float32, device=dev)
                              for _ in range(2))
    did_hit = torch.empty(n, dtype=torch.bool, device=dev)
    sky = _sky()
    kernels._launch(
        "pixel_shade", dev, kernels.lib().vkpt_pixel_shade, *scene_args,
        _f32("hit.t", t, n, None), tri.data_ptr(), _f32("hit.u", u, n, None),
        _f32("hit.v", v, n, None), _f32("origin", origin, n),
        _f32("direction", direction, n), ctypes.addressof(sky), frames, n,
        *(x.data_ptr() for x in (color, normal, out_dir, lambert_out,
                                 diffuse_albedo, fresnel_0, roughness,
                                 hit_point, did_hit)))
    _launched("pixel_shade" + _build(scene), origin)
    return color, (normal, out_dir, lambert_out, diffuse_albedo, fresnel_0,
                   roughness, hit_point, origin, direction, did_hit)


def next_segment(shading, hit_point, origin, direction, atten, seed_x,
                 seed_y, did_hit, rr: bool, out=None):
    """``_next_segment`` in one launch; the same arguments and result:
    (origin, direction, atten, seed_x, seed_y, alive).  The lanes are
    those of ``seed_x``; the shading inputs, ``hit_point``, ``origin``,
    ``direction`` and ``did_hit`` may instead hold P rows, read at lane
    mod P (the joint batch's per-pixel values under its frames' lanes),
    and ``atten`` may be None (1 on every lane).  ``out``: six tensors
    to write the result into, returned; else fresh tensors."""
    n = seed_x.shape[0]
    p = hit_point.shape[0]
    dev = seed_x.device
    if out is None:
        f3 = torch.empty((n, 3), dtype=torch.float32, device=dev)
        out = (f3, torch.empty_like(f3), torch.empty_like(f3),
               torch.empty_like(seed_x), torch.empty_like(seed_y),
               torch.empty(n, dtype=torch.bool, device=dev))
    pix = [x.contiguous() for x in (*shading, hit_point, origin, direction,
                                    did_hit)]
    normal, out_dir, lambert_out, diffuse_albedo, fresnel_0, roughness, \
        hit_point, origin, direction, did_hit = pix
    for x in pix:
        if x.device != dev:
            raise ValueError(f"next_segment: tensors on {x.device} and {dev}")
    o_out, d_out, a_out, sx_out, sy_out, alive_out = out
    kernels._launch(
        "joint_draw", dev, kernels.lib().vkpt_joint_draw, int(rr),
        _f32("normal", normal, p), _f32("out_dir", out_dir, p),
        _f32("lambert_out", lambert_out, p, None),
        _f32("diffuse_albedo", diffuse_albedo, p),
        _f32("fresnel_0", fresnel_0, p),
        _f32("roughness", roughness, p, None),
        _f32("hit_point", hit_point, p), _f32("origin", origin, p),
        _f32("direction", direction, p), _bool("did_hit", did_hit, p), p,
        None if atten is None else _f32("atten", atten, n),
        _i64("seed_x", seed_x, n), _i64("seed_y", seed_y, n), n,
        _f32("origin_out", o_out, n), _f32("direction_out", d_out, n),
        _f32("atten_out", a_out, n), _i64("sx_out", sx_out, n),
        _i64("sy_out", sy_out, n), _bool("alive_out", alive_out, n))
    _launched("joint_draw_rr" if rr else "joint_draw", seed_x)
    return out


def anyhit_sky(color, atten, direction, alive, hit_mask, out=None):
    """The emissive-free last bounce's shading in one launch: ``color``
    plus the sky through ``atten`` where a live lane's any hit missed,
    and every lane ended.  Returns (color, alive), written into ``out``
    (two tensors, which may be the inputs) when given, else fresh."""
    n = color.shape[0]
    if out is None:
        out = (torch.empty_like(color), torch.empty_like(alive))
    c_out, alive_out = out
    sky = _sky()
    kernels._launch(
        "anyhit_sky", color.device, kernels.lib().vkpt_anyhit_sky,
        _f32("color", color, n), _f32("atten", atten, n),
        _f32("direction", direction, n), _bool("alive", alive, n),
        _bool("hit", hit_mask, n), ctypes.addressof(sky), n,
        _f32("color_out", c_out, n), _bool("alive_out", alive_out, n))
    _launched("anyhit_sky", color)
    return out
