#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero
before the result line):

1. device — CUDA present, compute capability 9.0, the card's name and
   power limit from nvidia-smi, the native SAH library loaded;
2. build — the kernels of vulkan_pathtracer_tpu_torch/csrc built with
   nvcc for sm_90a, one nvcc per source in parallel (seconds, ptxas
   register/spill report);
3. flat kernels — each quad kernel against its plain PyTorch version on
   the card: the columns scene (56k triangles, leaf 28) with a frame's
   primary and bounce rays, the 246,444-triangle atrium with 65,536
   primary and 65,536 bounce rays, and both kernels timed at the
   headline frame's shapes (2,073,600 primaries; the sorted last-bounce
   launch), t, tri, u, v and the any-hit bit bitwise; the statistics
   build of both quad kernels at the same shapes (SIMT efficiency of
   node steps and leaf entries, node-step rounds per warp against steps
   per ray, stack depth), its outputs bitwise the plain versions'; the
   flat variant of the pair kernels on the columns rays, bitwise;
4. flat main path — the headline frame (atrium, 1920x1080, 1 spp, 2
   bounces, leaf 28) through the same loader and pipeline as
   ``python -m vulkan_pathtracer_tpu_torch``: 1 warm-up + 4 timed frames
   on bench.py's interior orbit, the launch counters zeroed just before
   the 4 frames and read just after (quad 4 each, pair 0); then a
   320x180 frame through the kernels and through the plain versions,
   compared;
5. instanced kernels — the pair kernels against their plain versions,
   bitwise: the columns scene as 197 instances of 33 meshes (leaf 14)
   with a frame's primary and bounce rays, the instanced atrium (32
   instances, leaf 14) with 65,536 primary and 65,536 live bounce rays;
   both kernels timed at the instanced 1080p frame's shapes, where the
   closest hit equals its plain version bitwise (t, tri, u, v) on all
   2,073,600 primaries and the any hit on the whole bounce-1 launch
   (also against the closest-hit mask); the statistics build of both
   (as for the quad kernels, plus leaf visits and the share of them
   that change the lane's instance), its outputs bitwise the plain
   versions';
6. instanced main path — the atrium through ``load_pipeline(...,
   instanced=True)`` (``--instanced``): 1 warm-up + 4 timed frames, the
   counters read around them (pair 4 each, quad 0); a 320x180
   instanced frame through the kernels and the plain versions;
7. skip and wide kernels — each against its plain version on the card,
   t, tri, u, v bitwise: the columns scene flat (leaf 28, both kernels)
   and instanced (leaf 14, the skip kernel) with a frame's primary and
   bounce rays; the atrium flat (``load_pipeline`` with ``--traversal
   pallas8``, which bakes the wide tiles too) and instanced with 65,536
   primary and 65,536 live bounce rays; the skip kernel timed on both
   launches of a ``pallas_packet`` frame (the 2,073,600 primaries and
   the sorted bounce-1 launch, the rays and order that path gives it)
   flat and instanced, the wide kernel on both launches of a
   ``pallas8`` frame, each held bitwise (t, tri, u, v) to its plain
   version on each launch at full size, with its statistics build (as
   for the pair kernels, no stack);
8. ``--traversal`` main paths — flat ``pallas_packet``, flat
   ``pallas8`` and instanced ``pallas_packet`` at 1080p: 1 warm-up + 4
   timed frames each, the counters read around them (the path's kernel
   8 = bounce 0 and bounce 1 per frame, every other kernel 0); the rays
   of the 4 frames equal to the headline's on the same scene (flat or
   instanced) but for at most the primaries whose closest hit differs
   between the two tiers (a tie of equal t broken by another traversal
   order; counted on the same 4 cameras); a 320x180 frame of each
   through the kernel and through its plain version, image difference
   0.0; a 320x180 ``--traversal bvh`` frame (the per-ray walk in plain
   PyTorch) against the skip kernel's: allclose 1e-5 but on the pixels
   whose paths met a differing hit;
9. tier kernels — the oct kernel, both frontier kernels (width 16; 32
   on the columns) and every kernel built with coefficient leaves
   (quad, pair flat and two-level, frontier) against their plain
   versions, t, tri, u, v and the any-hit bit bitwise: the columns
   scene (frontier exact at leaf 14; oct and the coefficient modes at
   leaf 28; the two-level pair with coefficient leaves at leaf 14) with
   a frame's primary and bounce rays, the atrium with 65,536 primary
   and 65,536 live bounce rays; each timed at the headline's shapes
   (2,073,600 primaries; the sorted bounce-1 launch for any hits); the
   pair and frontier closest hits and every coefficient closest hit
   bitwise on all primaries; the frontier any hit also against the
   frontier closest hit's mask on the whole bounce-1 launch; the
   statistics builds of both frontier kernels and of the six kernels
   with coefficient leaves on their launches (for the frontier closest
   hit also the share of visited nodes with 0, 1 and 2 or more hit
   internal children; with coefficient leaves the triangles tested per
   leaf visit, the shares of them rejected at det <= 0, at u' < 0 and
   at the v' window, and the shares of leaf visits whose table row 1,
   2, 3-4, ... 17-32 of the warp's lanes test together);
10. tier main paths — 1080p, 1 warm-up + 4 timed frames each, the
   counters read around the 4 frames: (a) flat ``oct`` at leaf 28 (oct
   4, quad any hit 4), (b) flat frontier with coefficient leaves at
   leaf 28 (frontier 4 + 4, coefficient kernels), (c) flat frontier with
   exact leaves at leaf 14 (frontier 4 + 4; the default tier of the same
   bake is its ray reference), (d) the flat default tier with
   coefficient leaves at leaf 28 (quad 4 + 4), (e) ``--instanced`` with
   coefficient leaves at leaf 14 (pair 4 + 4); exact tiers' rays equal
   their reference's up to the primaries whose hit differs, coefficient
   tiers' within 0.2% of the exact tier's (tests/test_mxu_mt.py's
   budget); a 320x180 frame of each through the kernels and through the
   plain versions, image difference 0.0; 320x180 3-bounce frames with
   ``kernel_secondary`` oct and frontier (the middle bounces); and one
   ``python -m vulkan_pathtracer_tpu_torch`` run with the ``VKPT_*``
   variables set.

Each kernel's ``bound_ms`` is the larger of its operations over the
card's f32 peak and its bytes over the HBM rate, counted from this
run's inputs: node and leaf visits from the plain version (the same
algorithm) times the per-visit operations of the kernel source;
coefficient leaves by the essential work of their 19 non-zero
coefficients, counted to the exits of the plain version's counters.  The
skip kernel's entry carries its bounce-1 and instanced timings under
``*_bounce1``, ``*_instanced`` and ``*_instanced_bounce1`` keys, the
wide kernel's its bounce-1 timing under ``*_bounce1`` keys.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
PALLAS = "vulkan_pathtracer_tpu/ops/pallas_pair.py"
PACKET = "vulkan_pathtracer_tpu/ops/pallas_traverse.py"
FRONTIER = "vulkan_pathtracer_tpu/ops/pallas_frontier.py"
MXU = "vulkan_pathtracer_tpu/ops/mxu_mt.py"
CSRC = "vulkan_pathtracer_tpu_torch/csrc"
KERNELS = {  # name -> (CUDA source, the Pallas kernel bodies it replaces)
    "quad_closest_hit": (f"{CSRC}/stack_traverse.cu", f"{PALLAS}:886"),
    "quad_any_hit": (f"{CSRC}/stack_traverse.cu", f"{PALLAS}:1207"),
    "pair_closest_hit": (f"{CSRC}/pair_traverse.cu", f"{PALLAS}:598"),
    "pair_any_hit": (f"{CSRC}/pair_traverse.cu", f"{PALLAS}:1507"),
    # kernels 5 (packet), 6 (pipe), 7 (group MT, two bodies), 9 (dense)
    "skip_closest_hit": (f"{CSRC}/skip_traverse.cu", ", ".join(
        f"{PACKET}:{line}" for line in (87, 606, 820, 1029, 1588))),
    "wide_closest_hit": (f"{CSRC}/skip_traverse.cu", f"{PACKET}:1294"),
    "oct_closest_hit": (f"{CSRC}/stack_traverse.cu", f"{PALLAS}:886"),
    "frontier_closest_hit": (f"{CSRC}/frontier_traverse.cu",
                             f"{FRONTIER}:284"),
    "frontier_any_hit": (f"{CSRC}/frontier_traverse.cu", f"{FRONTIER}:642"),
    # The kernels built with coefficient leaves: their node walk's body
    # and mt_coef_visit (closest hit) / mt_coef_visit_anyhit (any hit),
    # which the Pallas bodies inline under VKPT_MT=mxu.
    "quad_closest_hit_coef": (f"{CSRC}/stack_traverse.cu",
                              f"{PALLAS}:886, {MXU}:254"),
    "quad_any_hit_coef": (f"{CSRC}/stack_traverse.cu",
                          f"{PALLAS}:1207, {MXU}:302"),
    "pair_closest_hit_coef": (f"{CSRC}/pair_traverse.cu",
                              f"{PALLAS}:598, {MXU}:254"),
    "pair_any_hit_coef": (f"{CSRC}/pair_traverse.cu",
                          f"{PALLAS}:1507, {MXU}:302"),
    "frontier_closest_hit_coef": (f"{CSRC}/frontier_traverse.cu",
                                  f"{FRONTIER}:284, {MXU}:254"),
    "frontier_any_hit_coef": (f"{CSRC}/frontier_traverse.cu",
                              f"{FRONTIER}:642, {MXU}:302"),
}
# The headline frame and the comparison sizes.
DEVICE = "cuda:0"
WIDTH, HEIGHT = 1920, 1080
ATRIUM_DETAIL, ATRIUM_TRIS = 4.1, 246444
STACK_KERNELS = ("quad_closest_hit", "quad_any_hit", "pair_closest_hit",
                 "pair_any_hit")
SKIP_KERNELS = ("skip_closest_hit", "wide_closest_hit")
N_SUB = 65536            # atrium rays per kernel-vs-plain check
COLS_W, COLS_H = 640, 360
COLS_INSTANCES = 197     # columns 14x24: 196 columns + the floor
SMALL_W, SMALL_H = 320, 180
# Bounds: H100 SXM f32 peak outside the tensor cores and HBM rate
# (NVIDIA data sheet).  Operations per step, read off csrc/: a slab test
# is 12 mul/sub + 12 min/max + 1 compare (traverse.cuh slab()); a quad
# row adds 4 EMPTY tests and a 4-key insertion sort (6 compares), a
# pair row 3 selects, a skip record its leaf test, a wide tile 8 slabs
# and 2 leafword tests per slot, an oct row 8 slabs, 8 EMPTY tests and
# an 8-key insertion sort (28 compares), a frontier row W slabs and W
# EMPTY tests;
# the frontier closest hit's Batcher network (63 comparators at W = 16,
# 191 at 32) orders a visited node's hit internal children: work only
# where two or more were hit (with one finite key every network puts it
# first), which the plain version counts (inner_2); the any hit walks
# in slot order and runs none;
# Möller–Trumbore is 54 per triangle (55 with det_sign); the
# object-space transform of an instanced leaf visit 33; the ray set-up
# (3 safe reciprocals, 3 products) 18.  Coefficient leaves: the
# essential work of the test on a triangle's 19 non-zero coefficients
# (ops/mxu_mt.py), whatever the kernel runs, counted to the exit that
# the plain version's counters give it: det (3 products, 2 sums) and
# det <= 0 cost 6; u' (6 products, 5 sums) and u' < 0 12 more; v' and
# its window (v' < 0, u' + v' > det) 14 more; a survivor's t' (4
# products, 3 sums) and the closest hit's division, t and its three
# compares 12 more (44 in all), the any hit's two det-scaled compares
# 11 (43); a two-level scene's det_sign product adds one per sum
# computed.  Per ray the features [d, o x d, o, 1] (9); two-level, per
# instance change of the ray's leaf visits (the plain version's count),
# their transform by the 40 non-zero entries of A (70).  Bytes: the 19
# non-zero coefficients per triangle slot and A's 40 per instance.
PEAK_F32, HBM_BPS = 67e12, 3.35e12
VISIT_OPS = {"quad": 4 * 25 + 4 + 6, "pair": 2 * 25 + 3, "skip": 25 + 1,
             "wide": 8 * (25 + 2), "oct": 8 * 25 + 8 + 28,
             "frontier": 16 * 25 + 16, "frontier32": 32 * 25 + 32}
NET_OPS = {"frontier": 63, "frontier32": 191}
MT_OPS, XFORM_OPS, RAY_OPS = 54, 33, 18
# The early-exit triangle test (traverse.cuh mt, EARLY; the quad, oct,
# exact pair, skip, wide and exact frontier closest hits) stops after
# 15 operations at a back face, 27 at u and 45 at v (one more each with
# det_sign); the plain version counts each kind.
MT_EXIT_OPS = (15, 27, 45)
EARLY_EXIT = ("quad_closest_hit", "oct_closest_hit", "pair_closest_hit",
              "skip_closest_hit", "wide_closest_hit", "frontier_closest_hit")
COEF_EXIT_OPS = (6, 18, 32)   # at det, u', the v' window
COEF_FULL_OPS = {False: 44, True: 43}   # by any hit
COEF_NONZERO, FEAT_OPS, FEAT_XFORM_OPS = 19, 9, 70


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, "vulkan_pathtracer_tpu_torch")):
        fail("vulkan_pathtracer_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()

    from vulkan_pathtracer_tpu_torch.ops.native import get_lib

    # -- 1. device ---------------------------------------------------------
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    card = smi[0].strip()
    print(card)
    phase("device", name=repr(name), capability=cap,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    check(cap == (9, 0), f"expected compute capability (9, 0), got {cap}")
    get_lib()  # the native SAH build (native/); raises if it fails
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    from vulkan_pathtracer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kernels.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    phase("build", seconds=f"{build_s:.2f}", nvcc_seconds=(
        f"{kernels.BUILD_INFO['seconds']:.2f}"), lib=kernels.BUILD_INFO["path"])
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")

    # -- 3. flat kernels vs plain versions -----------------------------------
    from assets.procedural import make_atrium, make_columns
    from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )
    from vulkan_pathtracer_tpu_torch.models.instanced_scene import (
        build_instanced_scene,
    )
    from vulkan_pathtracer_tpu_torch.ops import frontier as fr
    from vulkan_pathtracer_tpu_torch.ops import mxu_mt
    from vulkan_pathtracer_tpu_torch.ops import skip_traverse as sk
    from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
    from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T
    from vulkan_pathtracer_tpu_torch.render import pipeline as pl
    from vulkan_pathtracer_tpu_torch.render import wavefront as wf
    from vulkan_pathtracer_tpu_torch.render.shading import (
        get_material_data,
        get_triangle_data,
    )
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig, write_png

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, reps: int, warm: bool = True):
        """Mean device time of fn over reps launches (after a warm-up)."""
        if warm:
            fn()
            sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps, out

    quad_args = st.quad_args

    def oct_args(scene, o, d, active, coef=False):
        return (scene.oct_box, scene.oct_link, scene.leaves, o, d,
                st.lane_limits(o.shape[0], active, o.device))

    def compare_closest(label, scene, o, d, active=None):
        args = quad_args(scene, o, d, active)
        k = kernels.quad_closest_hit(*args)
        sync()
        p = st.quad_closest_hit_plain(*args)
        sync()
        check(torch.equal(k[0] < MISS_T, p.t < MISS_T),
              f"{label}: closest hit masks differ")
        for f, a, b in zip("t tri u v".split(), k, p):
            check(torch.equal(a, b), f"{label}: quad closest {f} differs "
                  f"on {int((a != b).sum())} rays")
        phase("kernels", check=label, rays=o.shape[0],
              hits=int((p.t < MISS_T).sum().item()), bit_equal=True)
        return k[0]

    def compare_any(label, scene, o, d, kt_closest, active=None):
        args = quad_args(scene, o, d, active)
        k = kernels.quad_any_hit(*args)
        sync()
        p = st.quad_any_hit_plain(*args)
        sync()
        want = kt_closest < MISS_T
        check(torch.equal(k, want), f"{label}: any-hit kernel != closest.t < "
              f"MISS_T on {int((k != want).sum())} rays")
        check(torch.equal(k, p), f"{label}: any-hit kernel != plain version")
        phase("kernels", check=label + "/any", rays=o.shape[0],
              occluded=int(k.sum().item()), equal_to_closest=True)

    def compare_pair(label, scene, o, d, active=None):
        """Both pair kernels against their plain versions: hit masks
        equal, t, tri, u, v and the any-hit bit bitwise equal."""
        args = st.pair_args(scene, o, d, active)
        k = kernels.pair_closest_hit(*args)
        sync()
        p = st.pair_closest_hit_plain(*args)
        sync()
        check(torch.equal(k[0] < MISS_T, p.t < MISS_T),
              f"{label}: pair closest hit masks differ")
        for f, a, b in zip("t tri u v".split(), k, p):
            check(torch.equal(a, b), f"{label}: pair closest {f} differs "
                  f"on {int((a != b).sum())} rays")
        ka = kernels.pair_any_hit(*args)
        sync()
        pa = st.pair_any_hit_plain(*args)
        sync()
        check(torch.equal(ka, pa), f"{label}: pair any hit != plain version")
        check(torch.equal(ka, p.t < MISS_T),
              f"{label}: pair any hit != closest.t < MISS_T")
        phase("kernels", check=label + "/pair", rays=o.shape[0],
              instanced=scene.instanced, hits=int((p.t < MISS_T).sum()),
              bit_equal=True, any_equal_to_closest=True)

    def bounce_rays(scene, cam, frame, width, height, tier="auto"):
        """Primary rays of a frame and the sorted bounce-1 rays that the
        main path of closest-hit tier ``tier`` hands its bounce-1 kernel
        (in that launch's order)."""
        pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
        o, d, sx, sy, _ = pl.primary_rays(pos, hor, ver, fwd, frame, width,
                                          height)
        hit = wf._closest_hit(scene, o, d, None, tier)
        did_hit = hit.t < MISS_T
        tri_data = get_triangle_data(scene, hit)
        mat = get_material_data(scene, tri_data)
        o1, d1, _, _, _, alive = wf.extend_paths(
            scene, hit, o, d, torch.ones_like(o), sx, sy, did_hit, tri_data,
            mat)
        order, _ = wf._sorted_order(scene, o1, d1, alive)
        return (o, d, o1[order].contiguous(), d1[order].contiguous(),
                alive[order], int(alive.sum().item()))

    def tier_differences(scene, cam, frame, width, height, tier_a, tier_b):
        """Where two closest-hit tiers part on a frame: (primaries whose
        t, tri, u or v differ, live bounce-1 rays whose hit/miss differs,
        the bounce-1 rays launched from tier_a's hits).  A path's rays and
        radiance can differ only there: different traversal orders may
        break a tie of equal t differently, and the slab forms round
        differently at box faces.  Launches here are outside the counted
        main paths."""
        pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
        o, d, sx, sy, _ = pl.primary_rays(pos, hor, ver, fwd, frame, width,
                                          height)
        a = wf._closest_hit(scene, o, d, None, tier_a)
        b = wf._closest_hit(scene, o, d, None, tier_b)
        same = (a.t == b.t) & (a.tri == b.tri) & (a.u == b.u) & (a.v == b.v)
        tri_data = get_triangle_data(scene, a)
        mat = get_material_data(scene, tri_data)
        o1, d1, _, _, _, alive = wf.extend_paths(
            scene, a, o, d, torch.ones_like(o), sx, sy, a.t < MISS_T,
            tri_data, mat)
        h1 = (wf._any_hit(scene, o1, d1, alive, tier_a)
              != wf._any_hit(scene, o1, d1, alive, tier_b))
        return int((~same).sum()), int(h1.sum())

    def frames_ray_bound(scene, tier):
        """How far ``tier`` may move the ray count of main_path's 4 timed
        frames from the auto tier's: the primaries whose hit differs,
        summed over the 4 cameras (a bounce-1 ray is launched from its
        primary's hit and its RNG state alone)."""
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
        cam = Camera(aspect_ratio=config.aspect_ratio)
        total = 0
        for f in range(4):
            path.apply(cam, float(f))
            total += tier_differences(scene, cam, f + 1, WIDTH, HEIGHT,
                                      "auto", tier)[0]
        return total

    def check_rays(label, rays4, ref_rays, scene, tier):
        """The 4 frames' rays against the auto tier's count on the same
        scene, exact up to the primaries whose hit differs."""
        slack = frames_ray_bound(scene, tier)
        check(abs(rays4 - ref_rays) <= slack, f"{label}: {rays4} rays in 4 "
              f"frames, auto {ref_rays}, {slack} primaries hit otherwise")
        phase("main", check=f"{label} rays vs auto", rays=rays4,
              auto_rays=ref_rays, primaries_hit_otherwise=slack)

    def subset(n_total, k, seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.sort(torch.randperm(n_total, generator=g)[:k])[0].to(dev)

    def orbit_camera(aspect, t=0.0):
        cam = Camera(aspect_ratio=aspect)
        orbit_path(radius=4.5, height=2.2, duration=4.0,
                   center=(0.0, 1.2, 0.0)).apply(cam, t)
        return cam

    def scene_camera(scene):
        lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
        extent = float((hi - lo).max())
        cam = Camera(aspect_ratio=16 / 9)
        orbit_path(radius=0.75 * extent, height=0.35 * extent, duration=4.0,
                   center=tuple((lo + hi) * 0.5)).apply(cam, 0.0)
        return cam

    def bound(tables, n_rays, out_bytes, stats, visit_ops, block, instanced,
              coefs=None, early=False, net_ops=0, any_hit=False):
        """(bound_ms, bound_by) of one traversal launch; ``early``: the
        kernel's triangle test stops at its first failed condition;
        ``net_ops``: the comparators of a node's sorting network, at the
        nodes where it has work; ``coefs``: the coefficient table of
        coefficient leaves (one of ``tables``), counted to the exits of
        the plain version's counters."""
        ops = (n_rays * RAY_OPS + stats["node_visits"] * visit_ops
               + stats.get("inner_2", 0) * net_ops)
        nbytes = (sum(t.numel() * t.element_size() for t in tables)
                  + n_rays * (12 + 12 + 4 + out_bytes))
        if coefs is not None:
            exits = [stats[k] for k in ("tri_back", "tri_u", "tri_v")]
            full = stats["tri_tested"] - sum(exits)
            ops += n_rays * FEAT_OPS + full * (
                COEF_FULL_OPS[any_hit] + 4 * instanced) + sum(
                    x * (e + (k + 1) * instanced)
                    for k, (x, e) in enumerate(zip(exits, COEF_EXIT_OPS)))
            if instanced:
                ops += stats["instance_changes"] * FEAT_XFORM_OPS
            # The essential bytes of the coefficient table: COEF_NONZERO
            # of each row's mxu_mt.COLS floats (A's are all essential).
            nbytes -= coefs.numel() * coefs.element_size() * (
                mxu_mt.COLS - COEF_NONZERO) // mxu_mt.COLS
        else:
            ops += stats["leaf_visits"] * block * (MT_OPS + instanced)
            if early:
                ops -= sum(stats[k] * (MT_OPS - e)
                           for k, e in zip(("tri_back", "tri_u", "tri_v"),
                                           MT_EXIT_OPS))
            if instanced:
                ops += stats["leaf_visits"] * XFORM_OPS
        ops_ms, bytes_ms = 1e3 * ops / PEAK_F32, 1e3 * nbytes / HBM_BPS
        phase("bound", ops=ops, bytes=nbytes, ops_ms=f"{ops_ms:.4f}",
              bytes_ms=f"{bytes_ms:.4f}", **stats)
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")

    results = {}
    plain_outputs = {}   # the timed plain runs' outputs, by kernel key

    def stack_stats(key, run, ref, tag=""):
        """The statistics build of a kernel on the stack walk or the skip
        walk (outside the counted main paths), its outputs bitwise the
        plain version's; ``tag`` as in time_kernel."""
        out, counters = run()
        sync()
        same = (torch.equal(out, ref) if "any_hit" in key else
                all(torch.equal(a, b) for a, b in zip(out, ref)))
        check(same, f"{key}{tag} statistics build != plain version")
        summary = kernels.summarize_stack_stats(counters)
        results[key]["stats" + tag] = summary
        phase("stats", kernel=key + tag, **{
            k: f"{v:.4f}" if isinstance(v, float) else v
            for k, v in summary.items()})

    def time_kernel(key, launch, plain, tables, n_rays, out_bytes, scene,
                    compare, tag=""):
        """Kernel ms (mean of 5), plain ms (1 run, which also counts the
        node and leaf visits of the bound), the comparison's max_abs_err
        and the bound, at the main path's shapes.  ``tag`` suffixes the
        result keys (a second shape of the same kernel)."""
        k_ms, k_out = cuda_ms(launch, 5)
        stats = {}
        p_ms, p_out = cuda_ms(lambda: plain(stats), 1, False)
        plain_outputs[key + tag] = p_out
        err = compare(k_out, p_out)
        kind = key.split("_")[0]
        if kind == "frontier" and scene.frontier_box.shape[1] == 32:
            kind = "frontier32"
        b_ms, b_by = bound(tables, n_rays, out_bytes, stats, VISIT_OPS[kind],
                           scene.max_leaf_size, int(scene.instanced),
                           coefs=(scene.tri_coefs if key.endswith("_coef")
                                  else None),
                           early=key in EARLY_EXIT,
                           net_ops=NET_OPS.get(kind, 0),
                           any_hit="any_hit" in key)
        results.setdefault(key, {}).update({
            f"ms{tag}": k_ms, f"plain_ms{tag}": p_ms,
            f"max_abs_err{tag}": err, f"bound_ms{tag}": b_ms,
            f"bound_by{tag}": b_by})
        phase("timing", kernel=key + tag, rays=n_rays,
              kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}",
              bound_ms=f"{b_ms:.4f}", bound_by=b_by, max_abs_err=err,
              card=repr(card))

    def closest_err(k, p):
        kt, pt = k[0], p.t
        check(torch.equal(kt < MISS_T, pt < MISS_T),
              "full-frame primaries: hit masks differ")
        both = (kt < MISS_T) & (pt < MISS_T)
        return (kt - pt)[both].abs().max().item()

    def any_err(k, p):
        check(torch.equal(k, p), "bounce-1 any hit: kernel != plain")
        return (k != p).float().max().item()

    def bitwise_err(k, p):
        """A full-size launch, t, tri, u, v bitwise (0.0 returned)."""
        for f, a, b in zip("t tri u v".split(), k, p):
            check(torch.equal(a, b), f"full-size launch: {f} differs on "
                  f"{int((a != b).sum())} rays")
        return 0.0

    def only(**counts):
        """The launch counters expected of a path: ``counts``, 0 else."""
        return {k: counts.get(k, 0) for k in st.LAUNCHES}

    def main_path(pipe, label, expect):
        """1 warm-up + 4 timed frames on the interior orbit, the launch
        counters zeroed just before the 4 frames and read just after.
        Returns (launches, rays of the 4 frames)."""
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
        cam = Camera(aspect_ratio=config.aspect_ratio)
        path.apply(cam, 0.0)
        image, rays = pipe.render(cam, 0, present_order=False)   # warm-up
        sync()
        frames = 4
        for key in st.LAUNCHES:
            st.LAUNCHES[key] = 0
        total_rays = 0
        t0 = time.perf_counter()
        for f in range(frames):
            path.apply(cam, 4.0 * f / frames)
            image, rays = pipe.render(cam, f + 1, present_order=False)
            total_rays += int(rays)   # syncs: rays is a device scalar
        sync()
        elapsed = time.perf_counter() - t0
        launches = dict(st.LAUNCHES)
        check(launches == expect, f"{label}: launch counts {launches}, "
              f"expected {expect}")
        check(bool(torch.isfinite(image).all()),
              f"{label}: non-finite radiance")
        check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image {image.shape}")
        n_pix = WIDTH * HEIGHT
        check(n_pix < int(rays) <= 2 * n_pix, f"rays per frame {int(rays)}")
        phase("main", path=label, frames=frames,
              ms_per_frame=f"{1000.0 * elapsed / frames:.2f}",
              mrays_per_s=f"{total_rays / elapsed / 1e6:.3f}",
              rays=total_rays, launches=launches,
              mean=f"{image.mean().item():.5f}", card=repr(card))
        write_png(os.path.join(WORK, f"{label}.png"),
                  pipe.to_present(image.cpu().numpy()))
        return launches, total_rays

    WRAPPERS = ((st, STACK_KERNELS + ("oct_closest_hit",)),
                (sk, SKIP_KERNELS),
                (fr, ("frontier_closest_hit", "frontier_any_hit")))

    def plain_wrapper(mod, name):
        """A wrapper with the signature of <mod>.<name> that runs the
        plain version on the card."""
        args_of = {"quad": quad_args, "pair": st.pair_args,
                   "skip": lambda *a: sk.skip_args(*a[:4]),
                   "wide": lambda *a: sk.wide_args(*a[:4]),
                   "oct": oct_args, "frontier": fr.frontier_args}[
                       name.split("_")[0]]
        plain = getattr(mod, name + "_plain")

        def run(scene_, o_, d_, active=None, coef=False):
            return plain(*args_of(scene_, o_, d_, active, coef))
        return run

    def small_frame(scene, label, traversal="auto", exact=False, bounces=2,
                    **tiers):
        """A 320x180 frame through the kernels and through the plain
        versions, compared (``exact``: image difference 0.0); ``tiers``
        are RenderConfig's tier fields.  Returns the kernels' image, its
        rays and the kernel launches of its render."""
        small = pl.RenderPipeline(scene, RenderConfig(
            num_samples=1, num_bounces=bounces, resolution_x=SMALL_W,
            resolution_y=SMALL_H, traversal=traversal, **tiers))
        cam = orbit_camera(16 / 9, 1.0)
        before = dict(st.LAUNCHES)
        img_k, rays_k = small.render(cam, 7)
        sync()
        launched = {k: v - before[k] for k, v in st.LAUNCHES.items()
                    if v != before[k]}
        kernel_fns = {(mod, n): getattr(mod, n) for mod, names in WRAPPERS
                      for n in names}
        for (mod, n) in kernel_fns:
            setattr(mod, n, plain_wrapper(mod, n))
        try:
            img_p, rays_p = small.render(cam, 7)
            sync()
        finally:
            for (mod, n), fn in kernel_fns.items():
                setattr(mod, n, fn)
        check(int(rays_k) == int(rays_p),
              f"{label} small frame: rays {int(rays_k)} (kernels) vs "
              f"{int(rays_p)} (plain)")
        diff = (img_k - img_p).abs().max().item()
        if exact:
            check(diff == 0.0, f"{label} small frame: image differs by "
                  f"{diff}")
        check(torch.allclose(img_k, img_p, rtol=1e-5, atol=1e-5),
              f"{label} small frame: image differs by {diff}")
        phase("main", check=f"{label} {SMALL_W}x{SMALL_H} kernels vs plain",
              rays=int(rays_k), max_abs_diff=diff, bounces=bounces,
              launches=launched)
        return img_k, int(rays_k), launched

    def compare_bitwise(label, launch, plain, args):
        """A closest-hit kernel against its plain version: hit masks
        equal, t, tri, u, v bitwise equal."""
        k = launch(*args)
        sync()
        p = plain(*args)
        sync()
        check(torch.equal(k[0] < MISS_T, p.t < MISS_T),
              f"{label}: hit masks differ")
        for f, a, b in zip("t tri u v".split(), k, p):
            check(torch.equal(a, b), f"{label}: {f} differs on "
                  f"{int((a != b).sum())} rays")
        phase("kernels", check=label, rays=args[3].shape[0],
              hits=int((p.t < MISS_T).sum()), bit_equal=True)
        return p

    def compare_skip(label, scene, o, d, active=None):
        compare_bitwise(label + "/skip", kernels.skip_closest_hit,
                        sk.skip_closest_hit_plain,
                        sk.skip_args(scene, o, d, active))
        if scene.wide_nodes is not None:
            compare_bitwise(label + "/wide", kernels.wide_closest_hit,
                            sk.wide_closest_hit_plain,
                            sk.wide_args(scene, o, d, active))

    def time_launches(key, args_of, kernel, plain, stats_fn, tables, scene,
                      prim, bounce1, tag=""):
        """A closest-hit kernel on both launches of a ``--traversal``
        frame (the 2,073,600 primaries; the sorted bounce-1 launch, the
        rays and order that path gives it), timed and held bitwise (t,
        tri, u, v) to its plain version at full size, and its
        statistics build on both."""
        for shape, rays in (("", prim), ("_bounce1", bounce1)):
            args = args_of(scene, *rays)
            time_kernel(key, lambda: kernel(*args),
                        lambda s=None: plain(*args, stats=s), tables,
                        n_prim, 16, scene, bitwise_err, tag=tag + shape)
            if shape:
                phase("timing", kernel=key + tag + shape,
                      live=int(bounce1[2].sum()))
            stack_stats(key, lambda: stats_fn(*args),
                        plain_outputs.pop(key + tag + shape), tag + shape)

    def time_skip(scene, prim, bounce1, tag):
        """The skip kernel on both launches of a ``pallas_packet``
        frame."""
        time_launches("skip_closest_hit", sk.skip_args,
                      kernels.skip_closest_hit, sk.skip_closest_hit_plain,
                      kernels.skip_stats, (scene.skip_nodes, scene.leaves) + (
                          (scene.inst_inv,) if scene.instanced else ()),
                      scene, prim, bounce1, tag)

    # Columns (bench.py's 56k sidecar) at leaf 28: all rays of a
    # COLS_W x COLS_H frame, primaries and their bounce rays; the flat
    # pair tables on the same rays.
    t0 = time.perf_counter()
    cols_path = os.path.join(WORK, "columns_14_24.glb")
    if not os.path.exists(cols_path):
        make_columns(cols_path, grid=14, segments=24, n_materials=32)
    cols_host = gltf.load(cols_path)
    cols = build_device_scene(cols_host, max_leaf_size=28, device=dev)
    o, d, o1, d1, a1, _ = bounce_rays(cols, scene_camera(cols), 0, COLS_W,
                                      COLS_H)
    kt = compare_closest("columns/primary", cols, o, d)
    compare_any("columns/primary", cols, o, d, kt)
    compare_pair("columns/primary", cols, o, d)
    kt = compare_closest("columns/bounce", cols, o1, d1, a1)
    compare_any("columns/bounce", cols, o1, d1, kt, a1)
    compare_pair("columns/bounce", cols, o1, d1, a1)
    del cols
    phase("phase", name="columns flat",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # The headline atrium: 65,536 primaries and 65,536 live bounce rays.
    t0 = time.perf_counter()
    atrium_path = os.path.join(WORK, f"atrium_{ATRIUM_DETAIL}.glb")
    if not os.path.exists(atrium_path):
        make_atrium(atrium_path, detail=ATRIUM_DETAIL)
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                          resolution_y=HEIGHT)
    pipe = load_pipeline(atrium_path, config, dev)
    scene = pipe.scene
    phase("scene", triangles=scene.num_triangles, leaf=scene.max_leaf_size,
          quad_rows=scene.quad_box.shape[0], leaves=scene.leaves.shape[0],
          depth=scene.bvh_depth, emissive_free=scene.emissive_free,
          sort_secondary=pipe._sort_secondary,
          seconds=f"{time.perf_counter() - t0:.1f}")
    check(scene.num_triangles == ATRIUM_TRIS,
          f"atrium is not {ATRIUM_TRIS} triangles")
    check(scene.max_leaf_size == 28, "atrium leaf size is not 28")
    check(scene.emissive_free and pipe._sort_secondary,
          "atrium must take the sorted any-hit last bounce")
    cam0 = orbit_camera(config.aspect_ratio, 0.0)
    o, d, o1, d1, a1, live1 = bounce_rays(scene, cam0, 0, WIDTH, HEIGHT)
    n_prim = o.shape[0]
    sel = subset(n_prim, N_SUB, 1)
    kt = compare_closest("atrium/primary", scene, o[sel], d[sel])
    compare_any("atrium/primary", scene, o[sel], d[sel], kt)
    live_idx = torch.nonzero(a1).squeeze(1)
    sel = live_idx[subset(live_idx.shape[0], N_SUB, 2)]
    kt = compare_closest("atrium/bounce", scene, o1[sel], d1[sel])
    compare_any("atrium/bounce", scene, o1[sel], d1[sel], kt)

    # Timing at the main path's shapes: closest hit on the 2,073,600
    # tile-ordered primaries; any hit on the sorted bounce-1 launch
    # (2,073,600 lanes, live1 active).  Kernel vs plain, same inputs.
    targs = quad_args(scene, o, d, None)
    tables = (scene.quad_box, scene.quad_link, scene.leaves)
    time_kernel("quad_closest_hit", lambda: kernels.quad_closest_hit(*targs),
                lambda s=None: st.quad_closest_hit_plain(*targs, stats=s),
                tables, n_prim, 16, scene, closest_err)
    aargs = quad_args(scene, o1, d1, a1)
    time_kernel("quad_any_hit", lambda: kernels.quad_any_hit(*aargs),
                lambda s=None: st.quad_any_hit_plain(*aargs, stats=s),
                tables, n_prim, 1, scene, any_err)
    phase("timing", kernel="quad_any_hit", live=live1)

    # The statistics build of both quad kernels at the same shapes.
    for key, args in (("quad_closest_hit", targs), ("quad_any_hit", aargs)):
        stack_stats(key, lambda: kernels.quad_stats(
            key == "quad_any_hit", *args), plain_outputs.pop(key))
    del o, d, o1, d1, a1, targs, aargs
    phase("phase", name="atrium flat kernels",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 4. flat main path ---------------------------------------------------
    t0 = time.perf_counter()
    n_pix = WIDTH * HEIGHT
    _, rays = pipe.render(cam0, 0, present_order=False)
    check(int(rays) == n_pix + live1,
          f"frame 0 traced {int(rays)} rays, expected {n_pix} + {live1}")
    flat_launches, flat_rays = main_path(pipe, "headline", only(
        quad_closest_hit=4, quad_any_hit=4))
    small_frame(scene, "flat")
    del pipe, scene
    torch.cuda.empty_cache()
    phase("phase", name="flat main path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 5. instanced kernels vs plain versions ------------------------------
    # Columns as 197 instances of 33 meshes at leaf 14.
    t0 = time.perf_counter()
    icols = build_instanced_scene(cols_host, max_leaf_size=14, device=dev)
    phase("scene", name="columns instanced",
          instances=icols.inst_inv.shape[0], triangles=icols.num_triangles,
          pair_rows=icols.pair_box.shape[0], mb_bits=icols.mb_bits,
          depth=icols.bvh_depth)
    check(icols.inst_inv.shape[0] == COLS_INSTANCES,
          f"columns 14x24 is not {COLS_INSTANCES} instances")
    o, d, o1, d1, a1, _ = bounce_rays(icols, scene_camera(icols), 0, COLS_W,
                                      COLS_H)
    compare_pair("columns-inst/primary", icols, o, d)
    compare_pair("columns-inst/bounce", icols, o1, d1, a1)
    del icols, o, d, o1, d1, a1

    t1 = time.perf_counter()
    ipipe = load_pipeline(atrium_path, config, dev, instanced=True)
    iscene = ipipe.scene
    phase("scene", name="atrium instanced",
          instances=iscene.inst_inv.shape[0],
          triangles=iscene.num_triangles, leaf=iscene.max_leaf_size,
          pair_rows=iscene.pair_box.shape[0],
          leaves=iscene.leaves.shape[0], depth=iscene.bvh_depth,
          mb_bits=iscene.mb_bits, emissive_free=iscene.emissive_free,
          sort_secondary=ipipe._sort_secondary,
          seconds=f"{time.perf_counter() - t1:.1f}")
    check(iscene.instanced and iscene.max_leaf_size == 14,
          "instanced atrium must be a two-level bake at leaf 14")
    check(iscene.emissive_free and ipipe._sort_secondary,
          "instanced atrium must take the sorted any-hit last bounce")
    o, d, o1, d1, a1, ilive1 = bounce_rays(iscene, cam0, 0, WIDTH, HEIGHT)
    sel = subset(n_prim, N_SUB, 3)
    compare_pair("atrium-inst/primary", iscene, o[sel], d[sel])
    live_idx = torch.nonzero(a1).squeeze(1)
    sel = live_idx[subset(live_idx.shape[0], N_SUB, 4)]
    compare_pair("atrium-inst/bounce", iscene, o1[sel], d1[sel])

    itables = (iscene.pair_box, iscene.pair_link, iscene.leaves,
               iscene.inst_inv)
    pargs = st.pair_args(iscene, o, d, None)
    time_kernel("pair_closest_hit", lambda: kernels.pair_closest_hit(*pargs),
                lambda s=None: st.pair_closest_hit_plain(*pargs, stats=s),
                itables, n_prim, 16, iscene, bitwise_err)
    paargs = st.pair_args(iscene, o1, d1, a1)
    time_kernel("pair_any_hit", lambda: kernels.pair_any_hit(*paargs),
                lambda s=None: st.pair_any_hit_plain(*paargs, stats=s),
                itables, n_prim, 1, iscene, any_err)
    phase("timing", kernel="pair_any_hit", live=ilive1)
    check(torch.equal(plain_outputs["pair_any_hit"],
                      kernels.pair_closest_hit(*paargs)[0] < MISS_T),
          "bounce-1 pair any hit != closest.t < MISS_T")
    # The statistics build of both pair kernels at the same shapes.
    for key, args in (("pair_closest_hit", pargs), ("pair_any_hit", paargs)):
        stack_stats(key, lambda: kernels.pair_stats(
            key == "pair_any_hit", *args[:8]), plain_outputs.pop(key))
    del o, d, o1, d1, a1, pargs, paargs
    phase("phase", name="instanced kernels",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 6. instanced main path ----------------------------------------------
    t0 = time.perf_counter()
    _, rays = ipipe.render(cam0, 0, present_order=False)
    check(int(rays) == n_pix + ilive1,
          f"instanced frame 0 traced {int(rays)} rays, expected {n_pix} + "
          f"{ilive1}")
    inst_launches, inst_rays = main_path(ipipe, "instanced", only(
        pair_closest_hit=4, pair_any_hit=4))
    small_frame(iscene, "instanced")
    phase("phase", name="instanced main path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 7. skip and wide kernels vs plain versions --------------------------
    # Columns flat at leaf 28 (both kernels) and instanced at leaf 14
    # (the skip kernel): all rays of a COLS_W x COLS_H frame.
    t0 = time.perf_counter()
    cols = build_device_scene(cols_host, max_leaf_size=28, device=dev,
                              wide=True)
    o, d, o1, d1, a1, _ = bounce_rays(cols, scene_camera(cols), 0, COLS_W,
                                      COLS_H)
    compare_skip("columns/primary", cols, o, d)
    compare_skip("columns/bounce", cols, o1, d1, a1)
    icols = build_instanced_scene(cols_host, max_leaf_size=14, device=dev)
    o, d, o1, d1, a1, _ = bounce_rays(icols, scene_camera(icols), 0, COLS_W,
                                      COLS_H)
    compare_skip("columns-inst/primary", icols, o, d)
    compare_skip("columns-inst/bounce", icols, o1, d1, a1)
    del cols, icols

    # The flat atrium as --traversal pallas8 bakes it (skip records and
    # wide tiles): 65,536 primaries and 65,536 live bounce rays, then
    # both kernels timed on the 2,073,600 primaries.
    t1 = time.perf_counter()
    wconfig = RenderConfig(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                           resolution_y=HEIGHT, traversal="pallas8")
    wpipe = load_pipeline(atrium_path, wconfig, dev)
    wscene = wpipe.scene
    phase("scene", name="atrium flat, wide tiles",
          skip_records=wscene.skip_nodes.shape[0],
          wide_tiles=wscene.wide_nodes.shape[0],
          wide_bake_seconds=f"{wscene.wide_seconds:.2f}",
          seconds=f"{time.perf_counter() - t1:.1f}")
    check(wscene.num_triangles == ATRIUM_TRIS and wscene.max_leaf_size == 28,
          "the pallas8 bake is not the headline atrium at leaf 28")
    o, d, o1, d1, a1, _ = bounce_rays(wscene, cam0, 0, WIDTH, HEIGHT,
                                      "pallas_packet")
    sel = subset(n_prim, N_SUB, 5)
    compare_skip("atrium/primary", wscene, o[sel], d[sel])
    live_idx = torch.nonzero(a1).squeeze(1)
    sel = live_idx[subset(live_idx.shape[0], N_SUB, 6)]
    compare_skip("atrium/bounce", wscene, o1[sel], d1[sel])
    time_skip(wscene, (o, d, None), (o1, d1, a1), "")
    # The wide kernel on both launches of a pallas8 frame: its bounce-1
    # rays come from its own primaries' hits.
    _, _, o1, d1, a1, _ = bounce_rays(wscene, cam0, 0, WIDTH, HEIGHT,
                                      "pallas8")
    time_launches("wide_closest_hit", sk.wide_args, kernels.wide_closest_hit,
                  sk.wide_closest_hit_plain, kernels.wide_stats,
                  (wscene.wide_nodes, wscene.leaves), wscene, (o, d, None),
                  (o1, d1, a1))
    del o, d, o1, d1, a1

    # The instanced atrium (phase 5's bake): the skip kernel with the
    # instanced leaf decode.
    o, d, o1, d1, a1, _ = bounce_rays(iscene, cam0, 0, WIDTH, HEIGHT,
                                      "pallas_packet")
    sel = subset(n_prim, N_SUB, 7)
    compare_skip("atrium-inst/primary", iscene, o[sel], d[sel])
    live_idx = torch.nonzero(a1).squeeze(1)
    sel = live_idx[subset(live_idx.shape[0], N_SUB, 8)]
    compare_skip("atrium-inst/bounce", iscene, o1[sel], d1[sel])
    time_skip(iscene, (o, d, None), (o1, d1, a1), "_instanced")
    del o, d, o1, d1, a1
    phase("phase", name="skip and wide kernels",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 8. --traversal main paths --------------------------------------------
    # Each 1080p path launches its one kernel twice a frame (bounce 0,
    # and bounce 1 as a sorted closest hit) and traces the headline's
    # rays.
    t0 = time.perf_counter()
    pconfig = RenderConfig(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                           resolution_y=HEIGHT, traversal="pallas_packet")
    ppipe = pl.RenderPipeline(wscene, pconfig)
    packet_launches, rays4 = main_path(ppipe, "packet", only(
        skip_closest_hit=8))
    check_rays("packet", rays4, flat_rays, wscene, "pallas_packet")
    img_skip, rays_skip, _ = small_frame(wscene, "packet", "pallas_packet",
                                         exact=True)
    # --traversal bvh (the per-ray walk, plain PyTorch) against the skip
    # kernel: equal but where the two tiers' hits part (tier_differences).
    bvh_small = pl.RenderPipeline(wscene, RenderConfig(
        num_samples=1, num_bounces=2, resolution_x=SMALL_W,
        resolution_y=SMALL_H, traversal="bvh"))
    small_cam = orbit_camera(16 / 9, 1.0)
    img_bvh, rays_bvh = bvh_small.render(small_cam, 7)
    d0, d1 = tier_differences(wscene, small_cam, 7, SMALL_W, SMALL_H, "bvh",
                              "pallas_packet")
    diff = (img_bvh - img_skip).abs()
    off = int((diff > 1e-5 + 1e-5 * img_skip.abs()).any(dim=-1).sum())
    check(abs(int(rays_bvh) - rays_skip) <= d0 and off <= d0 + d1,
          f"bvh frame vs skip kernel frame: rays {int(rays_bvh)} vs "
          f"{rays_skip}, {off} pixels off 1e-5, hits differ on {d0} "
          f"primaries and {d1} bounce rays")
    phase("main", check=f"bvh {SMALL_W}x{SMALL_H} vs pallas_packet",
          rays=int(rays_bvh), max_abs_diff=diff.max().item(),
          pixels_off=off, primaries_hit_otherwise=d0,
          bounce_rays_hit_otherwise=d1)

    wide_launches, rays4 = main_path(wpipe, "wide", only(
        wide_closest_hit=8))
    check_rays("wide", rays4, flat_rays, wscene, "pallas8")
    small_frame(wscene, "wide", "pallas8", exact=True)
    del wpipe, ppipe, bvh_small, wscene
    torch.cuda.empty_cache()

    ipacket = pl.RenderPipeline(iscene, pconfig)
    ipacket_launches, rays4 = main_path(ipacket, "instanced-packet", only(
        skip_closest_hit=8))
    check_rays("instanced-packet", rays4, inst_rays, iscene,
               "pallas_packet")
    small_frame(iscene, "instanced-packet", "pallas_packet", exact=True)
    phase("phase", name="traversal main paths",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 9. tier kernels vs plain versions ----------------------------------
    # Each chosen kernel against its plain version, bitwise; with exact
    # leaves the any-hit bit equals the closest-hit mask (coefficient
    # leaves compare det-scaled in the any hit: the agreement is
    # printed).
    t0 = time.perf_counter()
    from vulkan_pathtracer_tpu_torch.utils.config import Tiers

    FAMILIES = {
        "quad": (quad_args, kernels.quad_closest_hit,
                 st.quad_closest_hit_plain, kernels.quad_any_hit,
                 st.quad_any_hit_plain),
        "pair": (st.pair_args, kernels.pair_closest_hit,
                 st.pair_closest_hit_plain, kernels.pair_any_hit,
                 st.pair_any_hit_plain),
        "frontier": (fr.frontier_args, kernels.frontier_closest_hit,
                     fr.frontier_closest_hit_plain, kernels.frontier_any_hit,
                     fr.frontier_any_hit_plain)}

    def compare_tier(label, scene, o, d, active=None, families=(),
                     coef=False, oct_=False):
        if oct_:
            compare_bitwise(label + "/oct", kernels.oct_closest_hit,
                            st.oct_closest_hit_plain,
                            oct_args(scene, o, d, active))
        for fam in families:
            args_fn, ck, cp, ak, ap = FAMILIES[fam]
            args = args_fn(scene, o, d, active, coef)
            tag = f"{label}/{fam}" + ("_coef" if coef else "")
            p = compare_bitwise(tag, ck, cp, args)
            ka = ak(*args)
            sync()
            pa = ap(*args)
            sync()
            check(torch.equal(ka, pa), f"{tag}: any hit != plain version")
            agree = (ka == (p.t < MISS_T)).float().mean().item()
            check(agree == 1.0 or (coef and agree >= 0.998),
                  f"{tag}: any hit agrees with closest.t < MISS_T on "
                  f"{agree:.6f} of rays")
            phase("kernels", check=tag + "/any", rays=o.shape[0],
                  occluded=int(ka.sum().item()), bit_equal=True,
                  any_vs_closest=f"{agree:.6f}")

    def both_ray_sets(label, scene, cam, w, h, **kw):
        o, d, o1, d1, a1, live = bounce_rays(scene, cam, 0, w, h)
        compare_tier(f"{label}/primary", scene, o, d, None, **kw)
        compare_tier(f"{label}/bounce", scene, o1, d1, a1, **kw)
        return o, d, o1, d1, a1, live

    # Columns: frontier exact at leaf 14 (width 16 and 32), oct and the
    # coefficient modes at leaf 28, the two-level pair with coefficient
    # leaves at leaf 14.
    cols14 = build_device_scene(cols_host, max_leaf_size=14, device=dev)
    both_ray_sets("columns14", cols14, scene_camera(cols14), COLS_W, COLS_H,
                  families=("frontier",))
    cols32 = build_device_scene(cols_host, max_leaf_size=14, device=dev,
                                frontier_width=32)
    check(cols32.frontier_box.shape[1] == 32, "frontier width 32 not baked")
    both_ray_sets("columns14-w32", cols32, scene_camera(cols32), COLS_W,
                  COLS_H, families=("frontier",))
    cols28 = build_device_scene(cols_host, max_leaf_size=28, device=dev,
                                mt="mxu")
    both_ray_sets("columns28", cols28, scene_camera(cols28), COLS_W, COLS_H,
                  families=("quad", "pair", "frontier"), coef=True,
                  oct_=True)
    icols = build_instanced_scene(cols_host, max_leaf_size=14, device=dev,
                                  mt="mxu")
    both_ray_sets("columns-inst", icols, scene_camera(icols), COLS_W, COLS_H,
                  families=("pair",), coef=True)
    del cols14, cols32, cols28, icols
    phase("phase", name="columns tier kernels",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # The atrium bakes of the five tier paths, through load_pipeline with
    # the tier fields a user sets (the CLI reads them from VKPT_*).
    t1 = time.perf_counter()
    frame_kw = dict(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                    resolution_y=HEIGHT)
    tiers = {
        "a": dict(kernel_primary="oct"),
        "b": dict(kernel_primary="frontier", anyhit_kernel="frontier",
                  mt="mxu"),
        "c": dict(kernel_primary="frontier", anyhit_kernel="frontier",
                  max_leaf=14),
        "d": dict(mt="mxu"),
        "e": dict(mt="mxu")}
    apipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, **tiers["a"]),
                          dev)
    bpipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, **tiers["b"]),
                          dev)
    dpipe = pl.RenderPipeline(bpipe.scene,
                              RenderConfig(**frame_kw, **tiers["d"]))
    cpipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, **tiers["c"]),
                          dev)
    cref = pl.RenderPipeline(cpipe.scene, RenderConfig(**frame_kw,
                                                       max_leaf=14))
    epipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, **tiers["e"]),
                          dev, instanced=True)
    for lbl, p_ in (("a", apipe), ("b", bpipe), ("c", cpipe), ("e", epipe)):
        sc = p_.scene
        phase("scene", name=f"atrium path ({lbl})", leaf=sc.max_leaf_size,
              instanced=sc.instanced,
              oct_rows=None if sc.oct_box is None else sc.oct_box.shape[0],
              frontier_rows=(None if sc.frontier_box is None
                             else sc.frontier_box.shape[0]),
              coef_rows=(None if sc.tri_coefs is None
                         else sc.tri_coefs.shape[0]))
    check(apipe.scene.max_leaf_size == 28 and bpipe.scene.max_leaf_size == 28
          and cpipe.scene.max_leaf_size == 14
          and epipe.scene.max_leaf_size == 14, "tier bakes: wrong leaf sizes")
    check(bpipe.scene.tri_coefs is not None and
          epipe.scene.inst_feat is not None, "mxu bakes lack coefficients")
    phase("phase", name="tier bakes", seconds=f"{time.perf_counter() - t1:.1f}")

    def atrium_checks(label, scene, seed, **kw):
        o, d, o1, d1, a1, live = bounce_rays(scene, cam0, 0, WIDTH, HEIGHT)
        sel = subset(n_prim, N_SUB, seed)
        compare_tier(f"{label}/primary", scene, o[sel], d[sel], **kw)
        live_idx = torch.nonzero(a1).squeeze(1)
        sel = live_idx[subset(live_idx.shape[0], N_SUB, seed + 1)]
        compare_tier(f"{label}/bounce", scene, o1[sel], d1[sel], **kw)
        return o, d, o1, d1, a1, live

    def time_family(key, scene, rays, any_rays, coef):
        """Closest hit on the primaries and any hit on the sorted
        bounce-1 launch of ``key``'s family, kernel vs plain."""
        fam = key.split("_")[0]
        args_fn, ck, cp, ak, ap = FAMILIES[fam]
        table = {"quad": (scene.quad_box, scene.quad_link),
                 "pair": (scene.pair_box, scene.pair_link),
                 "frontier": (scene.frontier_box, scene.frontier_link)}[fam]
        tables = (*table, st.leaf_table(scene, coef)) + (
            (scene.inst_inv, scene.inst_feat) if scene.instanced else ())
        suffix = "_coef" if coef else ""
        cargs = args_fn(scene, *rays, None, coef)
        time_kernel(f"{fam}_closest_hit{suffix}", lambda: ck(*cargs),
                    lambda s=None: cp(*cargs, stats=s), tables, n_prim, 16,
                    scene, bitwise_err if coef or fam != "quad"
                    else closest_err)
        aargs = args_fn(scene, *any_rays, coef)
        time_kernel(f"{fam}_any_hit{suffix}", lambda: ak(*aargs),
                    lambda s=None: ap(*aargs, stats=s), tables, n_prim, 1,
                    scene, any_err)
        if fam != "frontier":
            # The statistics builds of both kernels on their launches.
            stats_fn = getattr(kernels, f"{fam}_stats")
            for any_hit, args in ((False, cargs), (True, aargs)):
                key = f"{fam}_{'any' if any_hit else 'closest'}_hit{suffix}"
                stack_stats(key, lambda: stats_fn(any_hit, *args),
                            plain_outputs.pop(key))
        if fam == "frontier":
            # The closest hit's statistics build on the primaries; the
            # whole bounce-1 launch: the any-hit bit against the frontier
            # closest hit's mask (exactly so with exact leaves), and the
            # any hit's statistics build.
            key = f"frontier_closest_hit{suffix}"
            stack_stats(key, lambda: kernels.frontier_stats(False, *cargs),
                        plain_outputs.pop(key))
            key = f"frontier_any_hit{suffix}"
            agree = (plain_outputs[key] == (ck(*aargs)[0] < MISS_T)).float()
            agree = agree.mean().item()
            check(agree == 1.0 or (coef and agree >= 0.998),
                  f"bounce-1 {key} agrees with the closest-hit mask on "
                  f"{agree:.6f} of rays")
            phase("kernels", check=f"bounce-1 {key} vs closest mask",
                  rays=n_prim, any_vs_closest=f"{agree:.6f}")
            stack_stats(key, lambda: kernels.frontier_stats(True, *aargs),
                        plain_outputs.pop(key))

    t1 = time.perf_counter()
    o, d, o1, d1, a1, _ = atrium_checks("atrium-a", apipe.scene, 11,
                                        oct_=True)
    targs = oct_args(apipe.scene, o, d, None)
    time_kernel("oct_closest_hit", lambda: kernels.oct_closest_hit(*targs),
                lambda s=None: st.oct_closest_hit_plain(*targs, stats=s),
                (apipe.scene.oct_box, apipe.scene.oct_link,
                 apipe.scene.leaves), n_prim, 16, apipe.scene, closest_err)
    o, d, o1, d1, a1, _ = atrium_checks(
        "atrium-b", bpipe.scene, 13, families=("quad", "pair", "frontier"),
        coef=True)
    time_family("quad", bpipe.scene, (o, d), (o1, d1, a1), True)
    time_family("frontier", bpipe.scene, (o, d), (o1, d1, a1), True)
    o, d, o1, d1, a1, _ = atrium_checks("atrium-c", cpipe.scene, 15,
                                        families=("frontier",))
    time_family("frontier", cpipe.scene, (o, d), (o1, d1, a1), False)
    o, d, o1, d1, a1, _ = atrium_checks("atrium-e", epipe.scene, 17,
                                        families=("pair",), coef=True)
    time_family("pair", epipe.scene, (o, d), (o1, d1, a1), True)
    del o, d, o1, d1, a1, targs
    torch.cuda.empty_cache()
    phase("phase", name="atrium tier kernels",
          seconds=f"{time.perf_counter() - t1:.1f}")
    phase("phase", name="tier kernels",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 10. tier main paths -------------------------------------------------
    t0 = time.perf_counter()

    def coef_differences(scene, tier):
        """Primaries of main_path's 4 cameras whose hit or triangle
        differs between the default exact tier and ``tier``."""
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
        cam = Camera(aspect_ratio=config.aspect_ratio)
        total = 0
        for f in range(4):
            path.apply(cam, float(f))
            pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
            o, d, _, _, _ = pl.primary_rays(pos, hor, ver, fwd, f + 1, WIDTH,
                                            HEIGHT)
            a = wf._closest_hit(scene, o, d, None)
            b = wf._closest_hit(scene, o, d, None, tier)
            total += int(((a.t < MISS_T) != (b.t < MISS_T))
                         .logical_or(a.tri != b.tri).sum())
        return total

    def coef_rays(label, rays4, ref_rays, scene, tier):
        differ = coef_differences(scene, tier)
        budget = 0.002 * 4 * n_pix
        check(differ <= budget and abs(rays4 - ref_rays) <= 0.002 * ref_rays,
              f"{label}: {differ} of {4 * n_pix} primaries hit otherwise than "
              f"the exact tier; rays {rays4} vs {ref_rays}")
        phase("main", check=f"{label} rays vs exact tier", rays=rays4,
              exact_rays=ref_rays, primaries_hit_otherwise=differ,
              share=f"{differ / (4 * n_pix):.6f}")

    def tier_of(key):
        return Tiers(**{k: v for k, v in tiers[key].items()
                        if k != "max_leaf"})

    tier_launches = {}
    tier_launches["a"], rays4 = main_path(apipe, "tier-a-oct", only(
        oct_closest_hit=4, quad_any_hit=4))
    check_rays("tier-a-oct", rays4, flat_rays, apipe.scene, tier_of("a"))
    small_frame(apipe.scene, "tier-a-oct", exact=True, **tiers["a"])
    _, _, mid = small_frame(apipe.scene, "secondary-oct", exact=True,
                            bounces=3, kernel_secondary="oct")
    check(mid.get("oct_closest_hit") == 1, f"3-bounce oct frame: {mid}")

    tier_launches["b"], rays4 = main_path(bpipe, "tier-b-frontier-coef", only(
        frontier_closest_hit_coef=4, frontier_any_hit_coef=4))
    coef_rays("tier-b-frontier-coef", rays4, flat_rays, bpipe.scene,
              tier_of("b"))
    small_frame(bpipe.scene, "tier-b-frontier-coef", exact=True,
                **tiers["b"])

    cref_launches, cref_rays = main_path(cref, "tier-c-reference", only(
        pair_closest_hit=4, quad_any_hit=4))
    tier_launches["c"], rays4 = main_path(cpipe, "tier-c-frontier", only(
        frontier_closest_hit=4, frontier_any_hit=4))
    check_rays("tier-c-frontier", rays4, cref_rays, cpipe.scene,
               tier_of("c"))
    small_frame(cpipe.scene, "tier-c-frontier", exact=True, **tiers["c"])
    _, _, mid = small_frame(cpipe.scene, "secondary-frontier", exact=True,
                            bounces=3, kernel_secondary="frontier")
    check(mid.get("frontier_closest_hit") == 1,
          f"3-bounce frontier frame: {mid}")

    tier_launches["d"], rays4 = main_path(dpipe, "tier-d-quad-coef", only(
        quad_closest_hit_coef=4, quad_any_hit_coef=4))
    coef_rays("tier-d-quad-coef", rays4, flat_rays, bpipe.scene,
              tier_of("d"))
    small_frame(bpipe.scene, "tier-d-quad-coef", exact=True, **tiers["d"])

    tier_launches["e"], rays4 = main_path(epipe, "tier-e-instanced-coef", only(
        pair_closest_hit_coef=4, pair_any_hit_coef=4))
    coef_rays("tier-e-instanced-coef", rays4, inst_rays, epipe.scene,
              tier_of("e"))
    small_frame(epipe.scene, "tier-e-instanced-coef", exact=True,
                **tiers["e"])
    del apipe, bpipe, cpipe, dpipe, epipe, cref
    torch.cuda.empty_cache()

    # The tiers from the environment: one CLI run with the JAX
    # package's variables, on the card.
    out_png = os.path.join(WORK, "cli_tiers.png")
    env = {**os.environ, "VKPT_KERNEL_PRIMARY": "frontier",
           "VKPT_KERNEL_SECONDARY": "frontier",
           "VKPT_ANYHIT_KERNEL": "frontier", "VKPT_MT": "mxu",
           "VKPT_LEAF": "28"}
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s", cols_path,
         "-x", str(SMALL_W), "-y", str(SMALL_H), "-b", "3", "-o", out_png],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    want = ("kernel tiers: primary=frontier secondary=frontier "
            "anyhit=frontier mt=mxu leaf=28")
    check(proc.returncode == 0 and want in proc.stderr
          and os.path.exists(out_png),
          f"CLI with VKPT_* variables: rc {proc.returncode}\n{proc.stderr}")
    phase("main", check="CLI with VKPT_* tier variables", rc=proc.returncode,
          tiers=repr(want), timing=repr(proc.stderr.strip().splitlines()[-1]))
    phase("phase", name="tier main paths",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 11. result ------------------------------------------------------------
    launches = {**{k: flat_launches[k] for k in ("quad_closest_hit",
                                                  "quad_any_hit")},
                **{k: inst_launches[k] for k in ("pair_closest_hit",
                                                  "pair_any_hit")},
                "skip_closest_hit": packet_launches["skip_closest_hit"],
                "wide_closest_hit": wide_launches["wide_closest_hit"],
                "oct_closest_hit": tier_launches["a"]["oct_closest_hit"],
                **{k: tier_launches["c"][k] for k in (
                    "frontier_closest_hit", "frontier_any_hit")},
                **{k: tier_launches["b"][k] for k in (
                    "frontier_closest_hit_coef", "frontier_any_hit_coef")},
                **{k: tier_launches["d"][k] for k in (
                    "quad_closest_hit_coef", "quad_any_hit_coef")},
                **{k: tier_launches["e"][k] for k in (
                    "pair_closest_hit_coef", "pair_any_hit_coef")}}
    results["skip_closest_hit"]["launches_instanced"] = \
        ipacket_launches["skip_closest_hit"]
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], "library_ms": None, **results[key]}
        for key, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
