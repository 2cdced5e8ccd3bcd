"""The shading kernels' CUDA source on the CPU: ``csrc/shade.cu`` built
with g++ against ``csrc/host_mock.h`` (as ``test_torch_walk_host.py``
builds the walks) and held bitwise to the plain shading chain of
``render/wavefront.py``.

- ``shade_extend`` on the columns scene and the textured sphere (its
  albedo, metal-roughness, emissive and normal-map textures, and a floor
  with none), flat and two-level, ``last`` and not, Russian roulette on
  and off, with a third of the lanes dead, about a third missed and 333
  lanes (no multiple of 32); fresh outputs and the state written in
  place.
- A joint batch's per-pixel bounce 0 (``pixel_shade``) against the plain
  ``_pixel_shading``, every output on every pixel.
- The joint draws at lane mod N against ``_frame_lanes`` and the plain
  ``_next_segment``; the any-hit bounce's sky.
- Whole frames, joint batches and pooled groups with ``ops.shade``
  taking the kernels on CPU tensors, against the plain chain.

The comparison is exact: the source is built with
``-ffp-contract=off`` as nvcc builds it with ``-fmad=false``, and takes
PyTorch's CPU semantics in its host build (``csrc/shade.cu``).  sqrt,
sin and cos are PyTorch's own, handed to the build: its vectorized CPU
functions differ from glibc's by an ulp for some arguments (sqrt in
about 0.6% of them on an AVX512 build, sin and cos in 5%).  The
material rows are randomized so that every BRDF branch and the emissive
term are reached.  What the card's compiler accepts is not checked here.
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vulkan_pathtracer_tpu_torch.models import gltf
from vulkan_pathtracer_tpu_torch.models.camera import Camera
from vulkan_pathtracer_tpu_torch.models.device_scene import build_device_scene
from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
    build_instanced_scene,
)
from vulkan_pathtracer_tpu_torch.ops import kernels, shade
from vulkan_pathtracer_tpu_torch.ops.brdf import ShadingInfo
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T
from vulkan_pathtracer_tpu_torch.render import pipeline, wavefront
from vulkan_pathtracer_tpu_torch.render.shading import (
    get_material_data,
    get_triangle_data,
)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vulkan_pathtracer_tpu_torch", "csrc")
FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-fPIC",
         "-x", "c++"]
LAUNCH = re.compile(r"(\w+(?:<[^;{}]*?>)?)<<<(.*?)>>>\(", re.S)
MOCK_LAUNCH = r"vkpt_mock::launch(vkpt_mock::Cfg{\2}, \1, "
# The host build's sqrt, sin and cos: PyTorch's, through hooks.
HOST_MATH = """
#include "host_mock.h"
inline float (*vkpt_host_fn[3])(float) = {};
extern "C" void vkpt_host_math(float (*q)(float), float (*s)(float),
                               float (*c)(float)) {
  vkpt_host_fn[0] = q;
  vkpt_host_fn[1] = s;
  vkpt_host_fn[2] = c;
}
#define VKPT_HOST_SQRT vkpt_host_fn[0]
#define VKPT_HOST_SIN vkpt_host_fn[1]
#define VKPT_HOST_COS vkpt_host_fn[2]
"""
MATH_FN = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)
N = 333


def _torch_fn(fn):
    """``fn`` on one float, for the build's threads."""
    return MATH_FN(lambda x: fn(torch.tensor([x])).item())


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``shade.cu`` built for the CPU, with PyTorch's sqrt, sin and
    cos."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("shade_host")
    for name in ("shade.cu", "host_mock.h"):
        with open(os.path.join(CSRC, name)) as f:
            (out / name).write_text(LAUNCH.sub(MOCK_LAUNCH, f.read()))
    (out / "cuda_runtime.h").write_text(HOST_MATH)
    lib_path = out / "libshade_host.so"
    proc = subprocess.run(
        ["g++", *FLAGS, "-I", str(out), "-shared", "-o", str(lib_path),
         str(out / "shade.cu")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = kernels.bind(ctypes.CDLL(str(lib_path)))
    hooks = (_torch_fn(torch.sqrt), _torch_fn(torch.sin),
             _torch_fn(torch.cos))
    lib.vkpt_host_math(*hooks)
    lib.hooks = hooks     # kept alive with the library
    return lib


def _check(name, x, dtype, shape, align=16):
    """kernels._check without its device test."""
    assert x.dtype == dtype, name
    assert tuple(x.shape[1:]) == tuple(shape[1:]), name
    assert shape[0] is None or x.shape[0] == shape[0], name
    assert x.is_contiguous() and x.data_ptr() % align == 0, name


@pytest.fixture
def kernels_on_cpu(host_lib, monkeypatch):
    """``ops.shade``'s launches go to the host build."""
    def launch(name, device, fn, *args, batches=None):
        assert fn(*args, None) == 0, name

    monkeypatch.setattr(kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "_check", _check)
    before = dict(shade.LAUNCHES)
    yield lambda: {k: v - before[k] for k, v in shade.LAUNCHES.items()
                   if v != before[k]}


@pytest.fixture
def fused_on_cpu(kernels_on_cpu, monkeypatch):
    """The wavefront takes the kernels on CPU tensors."""
    monkeypatch.setattr(shade, "fused", lambda x: True)
    return kernels_on_cpu


def _random_materials(scene, seed):
    """``scene`` with random albedo, metallic-roughness and emissive
    words in its material rows."""
    rng = np.random.default_rng(seed)
    mat = scene.mat_packed.clone()
    words = rng.integers(0, 2 ** 32, size=(mat.shape[0], 3), dtype=np.int64)
    mat[:, :3] = torch.from_numpy(words)
    return dataclasses.replace(scene, mat_packed=mat, emissive_free=False)


@pytest.fixture(scope="module")
def scenes(columns_glb, sphere_glb):
    out = {}
    for name, path in (("", columns_glb), ("textured_", sphere_glb)):
        host = gltf.load(path)
        flat = build_device_scene(host, max_leaf_size=8, device="cpu")
        inst = build_instanced_scene(host, max_leaf_size=14, device="cpu")
        assert flat.has_textures == inst.has_textures == bool(name)
        out[name + "flat"] = _random_materials(flat, 1)
        out[name + "instanced"] = _random_materials(inst, 2)
    return out


KINDS = pytest.mark.parametrize(
    "kind", ["flat", "instanced", "textured_flat", "textured_instanced"])


def _key(base, kind):
    """``base``'s LAUNCHES key for a scene of ``kind``."""
    return base + ("_instanced" if kind.endswith("instanced") else "") + (
        "_textured" if kind.startswith("textured") else "")


def _lanes(scene, n=N, seed=0):
    """A lane set at one bounce: rays at and away from the scene, their
    closest hits, a third of the lanes dead, random attenuation, color
    and seeds."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32) - o
    away = rng.random(n) < 0.3
    d[away] = -d[away]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))
    alive = torch.from_numpy(rng.random(n) < 0.67)
    hit = wavefront._closest_hit(scene, o, d, alive, "bvh", "secondary")
    did = alive & (hit.t < MISS_T)
    assert 0.2 * n < int(did.sum()) < 0.6 * n
    assert int((alive & ~did).sum()) > 0.1 * n
    atten = torch.from_numpy(rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32))
    color = torch.from_numpy(rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32))
    seeds = [torch.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.int64))
             for _ in range(2)]
    return hit, [o, d, atten, color, *seeds, alive]


def _assert_bitwise(got, want, names):
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        diff = g.view(-1) != w.view(-1) if g.dtype != torch.float32 else (
            g.view(torch.int32) != w.view(torch.int32)).view(-1)
        assert not diff.any(), f"{name}: {int(diff.sum())} values differ"


STATE = ("origin", "direction", "atten", "color", "seed_x", "seed_y",
         "alive")
SHADE_CASES = pytest.mark.parametrize("last,rr", [
    (False, False), (False, True), (True, False)],
    ids=["extend", "extend_rr", "last"])


@SHADE_CASES
@KINDS
def test_shade_extend_matches_plain(kernels_on_cpu, scenes, kind, last, rr):
    scene = scenes[kind]
    hit, state = _lanes(scene, seed=3 + 2 * last + rr)
    want = wavefront._shade_and_extend(scene, hit, *state, last=last, rr=rr)
    assert kernels_on_cpu() == {}       # the CPU took the plain chain
    got = shade.shade_extend(scene, hit, *state, last=last, rr=rr)
    _assert_bitwise(got, want, STATE)
    key = _key("shade_extend", kind) + ("_last" if last else
                                        "_rr" if rr else "")
    assert kernels_on_cpu() == {key: 1}
    if last:
        assert all(g is s for g, s in zip(got[:3] + got[4:6],
                                          state[:3] + state[4:6]))
    else:
        assert not torch.equal(got[0], state[0])
        assert not torch.equal(got[4], state[4])
    # In place, as _trace_lanes hands over its state.
    inplace = [x.clone() for x in state]
    out = shade.shade_extend(scene, hit, *inplace, last=last, rr=rr,
                             out=inplace)
    assert all(o is x for o, x in zip(out, inplace))
    _assert_bitwise(inplace, want, STATE)


PIXELS = ("color", "normal", "out_dir", "lambert_out", "diffuse_albedo",
          "fresnel_0", "roughness", "hit_point", "origin", "direction",
          "did_hit")


@KINDS
def test_pixel_shading_matches_plain(kernels_on_cpu, scenes, kind):
    """A joint batch's bounce 0 of 5 frames on 333 pixels, about half of
    them missed: the summed color and every per-pixel input of the
    draws, on every pixel."""
    scene = scenes[kind]
    hit, (o, d, *_) = _lanes(scene, seed=31)
    color, per_pixel = wavefront._pixel_shading(scene, hit, o, d, 5)
    assert kernels_on_cpu() == {}
    got_color, got = shade.pixel_shading(scene, hit, o, d, 5)
    _assert_bitwise([got_color, *got], [color, *per_pixel], PIXELS)
    assert got[7] is o and got[8] is d
    assert kernels_on_cpu() == {_key("pixel_shade", kind): 1}


@pytest.mark.parametrize("rr", [False, True], ids=["draw", "draw_rr"])
def test_joint_draws_match_frame_lanes(kernels_on_cpu, scenes, rr):
    """The draws of 3 frames' lanes from one per-pixel copy (lane mod N)
    against ``_frame_lanes`` and the plain ``_next_segment``."""
    scene = scenes["flat"]
    hit, (o, d, _, _, sx, sy, _) = _lanes(scene, n=101, seed=11)
    frames = 3
    did = hit.t < MISS_T
    tri = get_triangle_data(scene, hit)
    mat = get_material_data(scene, tri)
    per_pixel = (*wavefront._shading_info(mat, d),
                 wavefront._hit_point(hit, o, d, tri), o, d, did)
    rng = np.random.default_rng(12)
    seed_x, seed_y = (torch.from_numpy(rng.integers(
        0, 2 ** 32, frames * 101, dtype=np.int64)) for _ in range(2))
    lanes = [wavefront._frame_lanes(x, 0, 101, frames) for x in per_pixel]
    want = wavefront._next_segment(
        ShadingInfo(*lanes[:6]), *lanes[6:9], torch.ones((frames * 101, 3)),
        seed_x, seed_y, lanes[9], rr)
    got = shade.next_segment(ShadingInfo(*per_pixel[:6]), *per_pixel[6:9],
                             None, seed_x, seed_y, per_pixel[9], rr)
    _assert_bitwise(got, want, STATE[:3] + STATE[4:])
    assert kernels_on_cpu() == {"joint_draw_rr" if rr else "joint_draw": 1}


def test_anyhit_sky_matches_plain(kernels_on_cpu, scenes):
    _, (_, d, atten, color, _, _, alive) = _lanes(scenes["flat"], seed=21)
    hit = torch.from_numpy(np.random.default_rng(22).random(N) < 0.5)
    want = wavefront._add_sky(color, atten, d, alive & ~hit)
    got, dead = shade.anyhit_sky(color, atten, d, alive, hit)
    _assert_bitwise([got], [want], ["color"])
    assert not dead.any()
    inplace = [color.clone(), alive.clone()]
    shade.anyhit_sky(inplace[0], atten, d, inplace[1], hit, out=inplace)
    _assert_bitwise(inplace, [want, torch.zeros_like(alive)],
                    ["color", "alive"])
    assert kernels_on_cpu() == {"anyhit_sky": 2}


W, H = 10, 8


def _cameras(scene):
    """Two cameras on the scene: the columns from further back, the
    sphere from above, tilted down to its floor."""
    y, pitch, zs = (1.5, 30.0, (-3.0, -2.7)) if scene.has_textures else (
        4.0, 0.0, (-14.0, -12.0))
    return [pipeline.camera_tensors(Camera(
        aspect_ratio=W / H, pitch=pitch,
        position=np.array([0.5, y, z], np.float32)), "cpu") for z in zs]


def _frame(scene, kw):
    return pipeline.render_frame(scene, *_cameras(scene)[0], 5, num_samples=1,
                                 width=W, height=H, sort_secondary=True,
                                 **kw)


def _joint(chunk):
    def run(scene, kw):
        return pipeline.render_frames_joint(scene, *_cameras(scene)[0], 5,
                                            batch=3, width=W, height=H,
                                            chunk=chunk, **kw)
    return run


def _pooled(scene, kw):
    vectors = [torch.stack(v) for v in zip(*_cameras(scene))]
    return pipeline.render_frames_pooled(scene, *vectors, [5, 6], width=W,
                                         height=H, chunk=64, **kw)


# 80 pixels a frame: a chunk of 64 lanes cuts the joint batch's frames
# into pixel ranges, one of 200 takes 2 whole frames; the pooled group
# traces in chunks of 64.
PATHS = {"frame": _frame, "joint_ranges": _joint(64),
         "joint_frames": _joint(200), "pooled": _pooled}
PRIMARIES = {"frame": W * H, "joint_ranges": W * H, "joint_frames": W * H,
             "pooled": 2 * W * H}


@pytest.mark.parametrize("bounces,rr", [(2, False), (3, True)],
                         ids=["anyhit", "emissive_rr"])
@pytest.mark.parametrize("path", sorted(PATHS))
@KINDS
def test_paths_with_kernels_match_plain(fused_on_cpu, scenes, monkeypatch,
                                        kind, path, bounces, rr):
    """Frames, joint batches (pixel-range and whole-frame chunks) and
    pooled groups through the kernels, bitwise the plain chain: the
    state written in place, the joint draws, and either the any-hit sky
    of an emissive-free scene or Russian roulette from bounce 1 and the
    last bounce's emissive fetch."""
    scene = scenes[kind]
    if bounces == 2:
        scene = dataclasses.replace(scene, emissive_free=True)
    kw = dict(num_bounces=bounces, russian_roulette=rr, rr_start_bounce=1)
    got = PATHS[path](scene, kw)
    launched = fused_on_cpu()
    monkeypatch.setattr(shade, "fused", lambda x: False)
    want = PATHS[path](scene, kw)
    assert fused_on_cpu() == launched
    assert int(got[1]) == int(want[1]) > 1.2 * PRIMARIES[path]
    _assert_bitwise([got[0]], [want[0]], ["image"])
    if bounces == 2:
        assert launched["anyhit_sky"] > 0
    else:
        assert "anyhit_sky" not in launched
    if path.startswith("joint"):
        assert launched["joint_draw_rr" if rr else "joint_draw"] > 0
        assert launched[_key("pixel_shade", kind)] == 1
    builds = {k.removesuffix("_rr").removesuffix("_last") for k in launched
              if k.startswith(("shade_extend", "pixel_shade"))}
    assert _key("shade_extend", kind) in builds or bounces == 2
    assert builds <= {_key("shade_extend", kind), _key("pixel_shade", kind)}
