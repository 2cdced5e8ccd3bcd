#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the
result line):

1. device — CUDA present, compute capability 9.0, the card's name and
   power limit from nvidia-smi, the native SAH library loaded;
2. build — the kernels of vulkan_pathtracer_tpu_torch/csrc built with
   nvcc for sm_90a (seconds, ptxas register/spill report);
3. kernels — each hand-written kernel against its plain PyTorch
   version on the card: the columns scene (56k triangles, leaf 28)
   with a frame's primary and bounce rays, the 246,444-triangle atrium
   with 65,536 primary and 65,536 bounce rays, and both kernels timed
   at the headline frame's shapes (2,073,600 primaries; the sorted
   last-bounce launch);
4. main path — the headline frame (atrium, 1920x1080, 1 spp, 2 bounces,
   leaf 28) through the same loader and pipeline as
   ``python -m vulkan_pathtracer_tpu_torch``: 1 warm-up + 4 timed frames
   on bench.py's interior orbit, both kernel launch counters checked;
   then a 320x180 frame through the kernels and through the plain
   versions, compared.

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
CLOSEST_SRC = "vulkan_pathtracer_tpu/ops/pallas_pair.py:886"
ANYHIT_SRC = "vulkan_pathtracer_tpu/ops/pallas_pair.py:1207"
CU_SRC = "vulkan_pathtracer_tpu_torch/csrc/stack_traverse.cu"
# The headline frame and the comparison sizes.
DEVICE = "cuda:0"
WIDTH, HEIGHT = 1920, 1080
ATRIUM_DETAIL, ATRIUM_TRIS = 4.1, 246444
N_SUB = 65536            # atrium rays per kernel-vs-plain check
COLS_W, COLS_H = 640, 360
SMALL_W, SMALL_H = 320, 180


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

    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        native_library_loaded,
    )

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
    check(native_library_loaded(), "native SAH library (native/) not loaded")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    from vulkan_pathtracer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kernels.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=f"{build_s:.2f}", nvcc_seconds=(
        f"{kernels.BUILD_INFO['seconds']:.2f}"), lib=kernels.BUILD_INFO["path"])
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")

    # -- 3. kernels vs plain versions ----------------------------------------
    from assets.procedural import make_atrium, make_columns
    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.models import gltf
    from vulkan_pathtracer_tpu_torch.models.camera import Camera, orbit_path
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        build_device_scene,
    )
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

    def closest_pair(scene, o, d, active):
        t_lane = st.lane_limits(o.shape[0], active, o.device)
        args = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
        k = kernels.quad_closest_hit(*args)
        sync()
        p = st.quad_closest_hit_plain(*args)
        sync()
        return k, p

    def compare_closest(label, scene, o, d, active=None):
        (kt, ktri, ku, kv), p = closest_pair(scene, o, d, active)
        kh, ph = kt < MISS_T, p.t < MISS_T
        check(torch.equal(kh, ph), f"{label}: closest hit masks differ")
        both = kh & ph
        ulp = (kt.view(torch.int32) - p.t.view(torch.int32)).abs()[both]
        tri_agree = (ktri == p.tri)[both].float().mean().item() \
            if both.any() else 1.0
        max_ulp = int(ulp.max().item()) if both.any() else 0
        check(max_ulp <= 1, f"{label}: t differs by {max_ulp} ulp")
        check(tri_agree >= 0.999, f"{label}: tri agreement {tri_agree}")
        err = (kt - p.t)[both].abs().max().item() if both.any() else 0.0
        phase("kernels", check=label, rays=o.shape[0],
              hits=int(both.sum().item()), t_max_ulp=max_ulp,
              t_bit_equal=bool(torch.equal(kt, p.t)),
              tri_agreement=f"{tri_agree:.6f}",
              uv_max_abs=f"{max((ku - p.u).abs().max().item(), (kv - p.v).abs().max().item()):.3g}")
        return kt, err

    def compare_any(label, scene, o, d, kt_closest, active=None):
        t_lane = st.lane_limits(o.shape[0], active, o.device)
        args = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
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
        return (k != p).float().max().item()

    def bounce_rays(scene, cam, frame, width, height):
        """Primary rays of a frame and the sorted bounce-1 rays that the
        main path hands the last-bounce kernel (closest hit by kernel)."""
        pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
        o, d, sx, sy, _ = pl.primary_rays(pos, hor, ver, fwd, frame, width,
                                          height)
        hit = st.quad_closest_hit(scene, o, d)
        did_hit = hit.t < MISS_T
        tri_data = get_triangle_data(scene, hit)
        mat = get_material_data(scene, tri_data)
        o1, d1, _, _, _, alive = wf.extend_paths(
            scene, hit, o, d, torch.ones_like(o), sx, sy, did_hit, tri_data,
            mat)
        order, _ = wf._sorted_order(scene, o1, d1, alive)
        return (o, d, o1[order].contiguous(), d1[order].contiguous(),
                alive[order], int(alive.sum().item()))

    def subset(n_total, k, seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.sort(torch.randperm(n_total, generator=g)[:k])[0].to(dev)

    def orbit_camera(aspect, t=0.0):
        cam = Camera(aspect_ratio=aspect)
        orbit_path(radius=4.5, height=2.2, duration=4.0,
                   center=(0.0, 1.2, 0.0)).apply(cam, t)
        return cam

    # Columns (bench.py's 56k sidecar) at leaf 28: all rays of a
    # COLS_W x COLS_H frame, primaries and their bounce rays.
    cols_path = os.path.join(WORK, "columns_14_24.glb")
    if not os.path.exists(cols_path):
        make_columns(cols_path, grid=14, segments=24, n_materials=32)
    cols = build_device_scene(gltf.load(cols_path), max_leaf_size=28,
                              device=dev)
    lo, hi = cols.root_lo.cpu().numpy(), cols.root_hi.cpu().numpy()
    extent = float((hi - lo).max())
    ccam = Camera(aspect_ratio=16 / 9)
    orbit_path(radius=0.75 * extent, height=0.35 * extent, duration=4.0,
               center=tuple((lo + hi) * 0.5)).apply(ccam, 0.0)
    o, d, o1, d1, a1, _ = bounce_rays(cols, ccam, 0, COLS_W, COLS_H)
    kt, _ = compare_closest("columns/primary", cols, o, d)
    compare_any("columns/primary", cols, o, d, kt)
    kt, _ = compare_closest("columns/bounce", cols, o1, d1, a1)
    compare_any("columns/bounce", cols, o1, d1, kt, a1)
    del cols

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
    kt, _ = compare_closest("atrium/primary", scene, o[sel], d[sel])
    compare_any("atrium/primary", scene, o[sel], d[sel], kt)
    live_idx = torch.nonzero(a1).squeeze(1)
    sel = live_idx[subset(live_idx.shape[0], N_SUB, 2)]
    kt, _ = compare_closest("atrium/bounce", scene, o1[sel], d1[sel])
    compare_any("atrium/bounce", scene, o1[sel], d1[sel], kt)

    # Timing at the main path's shapes: closest hit on the 2,073,600
    # tile-ordered primaries; any hit on the sorted bounce-1 launch
    # (2,073,600 lanes, live1 active).  Kernel vs plain, same inputs.
    t_lane = st.lane_limits(n_prim, None, dev)
    targs = (scene.quad_box, scene.quad_link, scene.leaves, o, d, t_lane)
    k_ms, (kt, _, _, _) = cuda_ms(lambda: kernels.quad_closest_hit(*targs), 5)
    p_ms, p = cuda_ms(lambda: st.quad_closest_hit_plain(*targs), 1, False)
    both = (kt < MISS_T) & (p.t < MISS_T)
    check(torch.equal(kt < MISS_T, p.t < MISS_T),
          "full-frame primaries: hit masks differ")
    closest_err = (kt - p.t)[both].abs().max().item()
    phase("timing", kernel="quad_closest_hit", rays=n_prim,
          kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}",
          max_abs_err=closest_err, card=repr(card))
    a_lane = st.lane_limits(n_prim, a1, dev)
    aargs = (scene.quad_box, scene.quad_link, scene.leaves, o1, d1, a_lane)
    ka_ms, ka = cuda_ms(lambda: kernels.quad_any_hit(*aargs), 5)
    pa_ms, pa = cuda_ms(lambda: st.quad_any_hit_plain(*aargs), 1, False)
    check(torch.equal(ka, pa), "bounce-1 any hit: kernel != plain")
    any_err = (ka != pa).float().max().item()
    phase("timing", kernel="quad_any_hit", rays=n_prim, live=live1,
          kernel_ms=f"{ka_ms:.3f}", plain_ms=f"{pa_ms:.1f}",
          max_abs_err=any_err, card=repr(card))
    del p, pa, o, d, o1, d1, a1

    # -- 4. main path --------------------------------------------------------
    path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                      center=(0.0, 1.2, 0.0))
    cam = Camera(aspect_ratio=config.aspect_ratio)
    path.apply(cam, 0.0)
    image, rays = pipe.render(cam, 0, present_order=False)   # warm-up
    sync()
    n_pix = WIDTH * HEIGHT
    check(int(rays) == n_pix + live1,
          f"warm-up frame traced {int(rays)} rays, expected {n_pix} + "
          f"{live1}")
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
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(bool(torch.isfinite(image).all()), "non-finite radiance")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image {image.shape}")
    check(n_pix < int(rays) <= 2 * n_pix, f"rays per frame {int(rays)}")
    ms_frame = 1000.0 * elapsed / frames
    mrays = total_rays / elapsed / 1e6
    phase("main", frames=frames, ms_per_frame=f"{ms_frame:.2f}",
          mrays_per_s=f"{mrays:.3f}", rays=total_rays, launches=launches,
          mean=f"{image.mean().item():.5f}", card=repr(card))
    write_png(os.path.join(WORK, "headline.png"),
              pipe.to_present(image.cpu().numpy()))

    # A small frame through the kernels and through the plain versions.
    small = pl.RenderPipeline(scene, RenderConfig(
        num_samples=1, num_bounces=2, resolution_x=SMALL_W,
        resolution_y=SMALL_H))
    cam = orbit_camera(16 / 9, 1.0)
    img_k, rays_k = small.render(cam, 7)
    sync()

    def plain_closest(scene_, o_, d_, active=None):
        return st.quad_closest_hit_plain(
            scene_.quad_box, scene_.quad_link, scene_.leaves, o_, d_,
            st.lane_limits(o_.shape[0], active, o_.device))

    def plain_any(scene_, o_, d_, active=None):
        return st.quad_any_hit_plain(
            scene_.quad_box, scene_.quad_link, scene_.leaves, o_, d_,
            st.lane_limits(o_.shape[0], active, o_.device))

    kernel_fns = (st.quad_closest_hit, st.quad_any_hit)
    st.quad_closest_hit, st.quad_any_hit = plain_closest, plain_any
    img_p, rays_p = small.render(cam, 7)
    sync()
    st.quad_closest_hit, st.quad_any_hit = kernel_fns
    check(int(rays_k) == int(rays_p),
          f"small frame: rays {int(rays_k)} (kernels) vs {int(rays_p)} "
          f"(plain)")
    diff = (img_k - img_p).abs().max().item()
    check(torch.allclose(img_k, img_p, rtol=1e-5, atol=1e-5),
          f"small frame: image differs by {diff}")
    phase("main", check=f"{SMALL_W}x{SMALL_H} kernels vs plain",
          rays=int(rays_k),
          max_abs_diff=diff)

    # -- 5. result -------------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "quad_closest_hit", "route": "cuda", "source": CU_SRC,
         "replaces": CLOSEST_SRC, "launches": launches["quad_closest_hit"],
         "max_abs_err": closest_err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "quad_any_hit", "route": "cuda", "source": CU_SRC,
         "replaces": ANYHIT_SRC, "launches": launches["quad_any_hit"],
         "max_abs_err": any_err, "ms": ka_ms, "plain_ms": pa_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
