"""The wavefront bounce loop — port of render/wavefront.py.

One sample = up to ``num_bounces`` segments per ray.  Each bounce:

    closest hit (the traversal tier below)
      -> sky / emissive accumulation
      -> attribute + material fetch
      -> BRDF sampling
      -> next-ray state update (masked)

Dead lanes are masked, and their RNG state is left untouched, so the
per-lane random stream stays bit-exact with the reference's early
breaks (ray_gen.rgen:44-102).  On an emissive-free scene the last
bounce only decides sky or not, so it runs an ANY-HIT kernel where the
tier has one, else closest hit and ``t < MISS_T`` (``_anyhit_enabled``).
With Russian roulette (an extension, off by default) a surviving path
ends after the segment of bounce ``j`` when ``j + 1 >= rr_start_bounce``
and one more draw says so (``extend_paths``).

``trace_sample`` traces one sample of a frame; ``trace_progressive_batch``
traces B frames of a static camera as one wavefront (the convergence
path): the primary hit once, every frame's bounce rays sorted together,
shaded in chunks of ``JOINT_CHUNK`` lanes; ``trace_wavefront_pooled``
traces F frames of F cameras the same way (frames in flight), each
frame's primaries its own.  The two share the lane state and its bounce
loop (``_trace_lanes``), and all three shade through the same
``_shade_and_extend`` / ``extend_paths`` body.

The closest-hit tier of ``--traversal`` (the JAX package's
render/wavefront.py:157-434 and :499-592, without its VMEM gates):

=================  =======================  ===========================
``--traversal``    flat scene               two-level scene
=================  =======================  ===========================
auto, pallas       the kernel tiers below   pair kernels
pallas_packet      skip kernel              skip kernel, instanced leaf
pallas8            wide kernel              ``bvh``
bvh                per-ray skip walk        per-ray skip walk, instanced
brute              brute force              ``bvh``
=================  =======================  ===========================

Under auto and pallas a flat scene takes the kernel of the config's
tier fields (utils/config.Tiers; the JAX package's
``VKPT_KERNEL_{PRIMARY,SECONDARY}``, ``VKPT_ANYHIT_KERNEL``,
``VKPT_MT``): bounce 0 is the primary phase, later bounces the
secondary one.  Unset, the primary kernel is pair at leaf <= 14 and
quad above (JAX wavefront.py:300-303), the secondary one quad.  A
named kernel runs first where the scene has its tables, then JAX's
fall-through order: primary pair, quad, oct; secondary quad, oct, pair
(``frontier`` only when named; ``packet`` is the skip kernel).  The
last bounce of an emissive-free scene runs an any-hit kernel: frontier
when ``anyhit_kernel`` names it, else quad.  ``mt="mxu"`` gives the
quad, pair and frontier kernels coefficient leaves when the scene
baked them (the oct kernel stays exact, as in JAX).  Two-level scenes
ignore the kernel names and take the pair kernels (with coefficient
leaves under mxu), as the JAX package does.  Only auto and pallas have
any-hit kernels.  A flat scene baked without a BVH (``--traversal
brute``) takes brute force under auto too.

With ``sort_secondary`` the bounce rays are sorted by the 6d endpoint
Morton key before traversal and the results scattered back; per-ray
results do not depend on the order.

With ``seed_secondary`` (``trace_sample`` only, as in JAX; the joint
batch and the pooled wavefront ignore it) every closest-hit bounce
after the first starts from a seed: the ``leaf_seed_hit`` pre-pass of
each live ray against the leaf block of its previous hit (JAX
wavefront.py:729-742).  Every tier but brute force takes the seed (its
channel build on the card); brute force drops it, as JAX's does.  On a
flat bake the seed is a hit of the scene, so the frame changes only
where another triangle lies at the seed's exact t.  Two-level scenes
refuse it (``check_seed_secondary``).

Deviation kept from the JAX package: the pdf divide is clamped with
``max(density, 1e-30)``; lanes where that matters are already dead.
"""

from __future__ import annotations

import functools

import torch

from vulkan_pathtracer_tpu_torch.ops import (
    frontier,
    intersect,
    rng,
    skip_traverse,
    stack_traverse,
    traverse,
)
from vulkan_pathtracer_tpu_torch.ops.brdf import (
    ShadingInfo,
    brdf,
    get_brdf_density,
    sample_brdf,
)
from vulkan_pathtracer_tpu_torch.ops.intersect import MISS_T, Hit
from vulkan_pathtracer_tpu_torch.ops.sort import state_sort_order
from vulkan_pathtracer_tpu_torch.ops.vecmath import dot, mix
from vulkan_pathtracer_tpu_torch.render.shading import (
    get_emissive_lean,
    get_material_data,
    get_triangle_data,
)
from vulkan_pathtracer_tpu_torch.utils.config import KERNEL_ALIASES, Tiers
from vulkan_pathtracer_tpu_torch.utils.profiling import count_live, span

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
EMISSIVE_SCALE = 10.0       # ray_gen.rgen:75
ORIGIN_OFFSET = 1e-5        # ray_gen.rgen:86
ROUGHNESS_FLOOR = 0.006     # ray_gen.rgen:84
F0_DIELECTRIC = 0.02        # ray_gen.rgen:82
SORT_L = 0.5                # 6d key: endpoint at 0.5 * scene diagonal


def as_tiers(tiers) -> Tiers:
    """A Tiers, or a ``--traversal`` name with the default tiers."""
    return Tiers(traversal=tiers) if isinstance(tiers, str) else tiers


def coef_leaves(scene, tiers: Tiers) -> bool:
    """Whether the kernels take coefficient leaves: ``mt="mxu"`` and the
    scene baked them (JAX pallas_pair._mxu_active)."""
    if tiers.mt != "mxu" or scene.tri_coefs is None:
        return False
    return not scene.instanced or scene.inst_feat is not None


def _leaf_mode(fn, coef: bool):
    """``fn`` with coefficient leaves when ``coef`` (the wrappers take
    ``coef=True``), else ``fn`` itself."""
    return functools.partial(fn, coef=True) if coef else fn


def _stack_kernel(scene, tiers: Tiers, phase: str):
    """The closest-hit kernel of a flat scene under auto / pallas (the
    module docstring; JAX wavefront.py:284-395)."""
    if phase == "secondary":
        kern = tiers.kernel_secondary or "quad"
        order = ["quad", "oct", "pair"]
    else:
        kern = tiers.kernel_primary or (
            "pair" if scene.max_leaf_size <= 14 else "quad")
        order = ["pair", "quad", "oct"]
    kern = KERNEL_ALIASES[kern]
    if kern == "packet":
        return skip_traverse.skip_closest_hit
    coef = coef_leaves(scene, tiers)
    tables = {"quad": (scene.quad_box, _leaf_mode(
                  stack_traverse.quad_closest_hit, coef)),
              "pair": (scene.pair_box, _leaf_mode(
                  stack_traverse.pair_closest_hit, coef)),
              "oct": (scene.oct_box, stack_traverse.oct_closest_hit),
              "frontier": (scene.frontier_box, _leaf_mode(
                  frontier.frontier_closest_hit, coef))}
    for k in [kern] + [k for k in order if k != kern]:
        table, fn = tables[k]
        if table is not None:
            return fn
    return traverse.bvh_closest_hit


def _closest_tier(scene, tiers, phase: str = "primary"):
    """The closest-hit function of ``tiers`` on this scene for a bounce
    of ``phase`` (the table in the module docstring)."""
    tiers = as_tiers(tiers)
    traversal = tiers.traversal
    if not scene.has_bvh:
        return intersect.brute_force_closest_hit
    if traversal in ("auto", "pallas"):
        if scene.instanced:
            return _leaf_mode(stack_traverse.pair_closest_hit,
                              coef_leaves(scene, tiers))
        return _stack_kernel(scene, tiers, phase)
    if traversal == "pallas_packet":
        return skip_traverse.skip_closest_hit
    if traversal == "pallas8" and not scene.instanced:
        return skip_traverse.wide_closest_hit
    if traversal == "brute" and not scene.instanced:
        return intersect.brute_force_closest_hit
    return traverse.bvh_closest_hit


def _any_tier(scene, tiers):
    """The any-hit kernel of ``tiers`` on this scene, or None where the
    tier has none (JAX wavefront.py:499-592)."""
    tiers = as_tiers(tiers)
    if tiers.traversal not in ("auto", "pallas") or not scene.has_bvh:
        return None
    coef = coef_leaves(scene, tiers)
    if scene.instanced:
        return _leaf_mode(stack_traverse.pair_any_hit, coef)
    if tiers.anyhit_kernel == "frontier" and scene.frontier_box is not None:
        return _leaf_mode(frontier.frontier_any_hit, coef)
    return _leaf_mode(stack_traverse.quad_any_hit, coef)


def _closest_hit(scene, origin, direction, active, tiers="auto",
                 phase: str = "primary", seed=None) -> Hit:
    """Closest hit through the tier of ``tiers`` (a Tiers or a
    ``--traversal`` name) for a bounce of ``phase``, from ``seed`` (a
    Hit) when given; brute force drops the seed (JAX wavefront.py:215)."""
    with span("traverse"):
        fn = _closest_tier(scene, tiers, phase)
        if seed is None or fn is intersect.brute_force_closest_hit:
            return fn(scene, origin.contiguous(), direction.contiguous(),
                      active)
        return fn(scene, origin.contiguous(), direction.contiguous(), active,
                  seed=seed)


def _any_hit(scene, origin, direction, active, tiers="auto") -> torch.Tensor:
    """(N,) bool, True where _closest_hit reports t < MISS_T (exactly so
    with exact leaves); inactive lanes False.  auto and pallas take the
    any-hit kernels (_any_tier); every other tier tests its secondary
    closest hit (JAX wavefront.py:587-592)."""
    with span("traverse"):
        fn = _any_tier(scene, tiers)
        if fn is not None:
            return fn(scene, origin.contiguous(), direction.contiguous(),
                      active)
        hit = _closest_hit(scene, origin, direction, active, tiers,
                           "secondary")
        return hit.t < MISS_T


def _anyhit_enabled(scene) -> bool:
    """The last bounce may use any hit iff the scene is emissive-free
    (hit lanes would add emissive x atten == 0)."""
    return bool(scene.emissive_free)


def _bounce_sort_key(scene, origin, direction, alive) -> torch.Tensor:
    """6d endpoint-pair Morton key (5 bits per axis of origin and of
    origin + L*direction, L = 0.5 * scene diagonal); dead lanes get
    0xFFFFFFFF and sort last.  int64 holding uint32 values.  The box is
    the root's world box (the TLAS root on two-level scenes,
    ``bvh_packed[0]`` in JAX); a scene without a BVH is keyed by the
    direction octant alone, as in JAX."""
    if not scene.has_bvh:
        key = traverse.octant_of(direction)
        return torch.where(alive, key, torch.full_like(key, 0xFFFFFFFF))
    lo = scene.root_lo
    ext = torch.clamp(scene.root_hi - lo, min=1e-9)
    length = SORT_L * torch.sqrt(dot(ext, ext))
    qo = torch.clamp((origin - lo) / ext * 31.0, 0.0, 31.0).to(torch.int64)
    qe = torch.clamp((origin + length * direction - lo) / ext * 31.0,
                     0.0, 31.0).to(torch.int64)
    key = torch.zeros(origin.shape[0], dtype=torch.int64,
                      device=origin.device)
    for b in range(4, -1, -1):
        for comp in (qo[:, 0], qo[:, 1], qo[:, 2],
                     qe[:, 0], qe[:, 1], qe[:, 2]):
            key = (key << 1) | ((comp >> b) & 1)
    return torch.where(alive, key, torch.full_like(key, 0xFFFFFFFF))


def _sorted_order(scene, origin, direction, active):
    key = _bounce_sort_key(
        scene, origin, direction,
        torch.ones(origin.shape[0], dtype=torch.bool, device=origin.device)
        if active is None else active)
    _, order = state_sort_order(key, 1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def _closest_hit_sorted(scene, origin, direction, active, tiers="auto",
                        phase: str = "secondary", seed=None) -> Hit:
    """Closest hit with rays sorted by the bounce key (the ``seed`` with
    them), results scattered back to lane order (identical per-ray
    results)."""
    with span("sort"):
        order, inv = _sorted_order(scene, origin, direction, active)
        act_s = None if active is None else active[order]
        seed_s = None if seed is None else Hit(*(x[order] for x in seed))
        origin_s, direction_s = origin[order], direction[order]
    hit = _closest_hit(scene, origin_s, direction_s, act_s, tiers, phase,
                       seed_s)
    del origin_s, direction_s    # freed before the scatter, as unsorted
    with span("sort"):
        return Hit(t=hit.t[inv], tri=hit.tri[inv], u=hit.u[inv],
                   v=hit.v[inv])


def _any_hit_sorted(scene, origin, direction, active,
                    tiers="auto") -> torch.Tensor:
    """Sorted-dispatch any hit (sorted rays resolve together)."""
    with span("sort"):
        order, inv = _sorted_order(scene, origin, direction, active)
        act_s = None if active is None else active[order]
        origin_s, direction_s = origin[order], direction[order]
    hit = _any_hit(scene, origin_s, direction_s, act_s, tiers)
    del origin_s, direction_s
    with span("sort"):
        return hit[inv]


def sky_color(direction: torch.Tensor) -> torch.Tensor:
    """ray_gen.rgen:65-70."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=torch.float32,
                         device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=torch.float32,
                        device=direction.device)
    return mix(white[None, :], blue[None, :], t[:, None])




def _add_sky(color, atten, direction, missed):
    """``color`` plus the sky seen through ``atten`` on the missed lanes."""
    zero = torch.zeros((), dtype=torch.float32, device=color.device)
    return color + torch.where(missed[:, None], atten * sky_color(direction),
                               zero)


def _shading_info(mat, direction) -> ShadingInfo:
    """The BRDF inputs of a hit (ray_gen.rgen:80-84)."""
    out_dir = -direction
    albedo = mat.albedo[:, :3]
    metallic = mat.metallic[:, None]
    return ShadingInfo(
        normal=mat.normal,
        out_dir=out_dir,
        lambert_out=dot(mat.normal, out_dir),
        fresnel_0=mix(F0_DIELECTRIC, albedo, metallic),
        diffuse_albedo=albedo - metallic * albedo,
        roughness=torch.clamp(mat.roughness, min=ROUGHNESS_FLOOR),
    )


def _hit_point(hit, origin, direction, tri_data):
    """The next segment's origin: the hit point off the surface
    (ray_gen.rgen:86)."""
    return (origin + hit.t[:, None] * direction
            + tri_data.geometry_normal * ORIGIN_OFFSET)


def _next_segment(shading, hit_point, origin, direction, atten, seed_x,
                  seed_y, did_hit, rr: bool):
    """Draw the hit lanes' next segment (ray_gen.rgen:87-101); with
    ``rr`` Russian roulette then ends some of the surviving paths (JAX
    wavefront.py:837-847).  Returns (origin, direction, atten, seed_x,
    seed_y, alive)."""
    # Draw exactly where the reference draws (hit and not last bounce).
    nsx, nsy, rx, ry = rng.pcg2d(seed_x, seed_y)
    seed_x = torch.where(did_hit, nsx, seed_x)
    seed_y = torch.where(did_hit, nsy, seed_y)
    new_direction = sample_brdf(shading, rx, ry)
    density = get_brdf_density(shading, new_direction)
    lambert_in = dot(shading.normal, new_direction)
    killed = lambert_in <= 0.0
    weight = (brdf(shading, new_direction) * lambert_in[:, None]
              / torch.clamp(density, min=1e-30)[:, None])
    survive = did_hit & ~killed
    hit_col = did_hit[:, None]
    atten = torch.where(survive[:, None], atten * weight, atten)
    origin = torch.where(hit_col, hit_point, origin)
    direction = torch.where(hit_col, new_direction, direction)
    if rr:
        # One more draw, on the surviving lanes only.
        p_survive = torch.clamp(atten.amax(dim=-1), 0.05, 1.0)
        nsx, nsy, rrx, _ = rng.pcg2d(seed_x, seed_y)
        seed_x = torch.where(survive, nsx, seed_x)
        seed_y = torch.where(survive, nsy, seed_y)
        keep = survive & ~(rrx >= p_survive)
        atten = torch.where(keep[:, None], atten / p_survive[:, None], atten)
        survive = keep
    return origin, direction, atten, seed_x, seed_y, survive


def extend_paths(scene, hit, origin, direction, atten, seed_x, seed_y,
                 did_hit, tri_data, mat, rr: bool = False):
    """Shade the hit lanes and draw the next segment (ray_gen.rgen:80-101;
    ``_next_segment``).  Returns (origin, direction, atten, seed_x,
    seed_y, alive)."""
    return _next_segment(_shading_info(mat, direction),
                         _hit_point(hit, origin, direction, tri_data),
                         origin, direction, atten, seed_x, seed_y, did_hit,
                         rr)


def _shade_and_extend(scene, hit, origin, direction, atten, color, seed_x,
                      seed_y, alive, *, last: bool, rr: bool):
    """One bounce's shading on a lane set (JAX wavefront.py:909-970):
    sky on the missed lanes and emissive on the hit lanes added into
    ``color``, then, unless ``last``, the hit lanes' next segment
    (``extend_paths``).  The last bounce fetches the emissive factor
    alone where the scene allows.  Returns (origin, direction, atten,
    color, seed_x, seed_y, alive)."""
    missed = alive & (hit.t >= MISS_T)
    did_hit = alive & ~missed
    color = _add_sky(color, atten, direction, missed)
    tri_data = mat = None
    emissive = get_emissive_lean(scene, hit) if last else None
    if emissive is None:
        tri_data = get_triangle_data(scene, hit)
        mat = get_material_data(scene, tri_data)
        emissive = mat.emissive
    zero = torch.zeros((), dtype=torch.float32, device=color.device)
    color = color + torch.where(did_hit[:, None],
                                emissive * EMISSIVE_SCALE * atten, zero)
    if last:
        return (origin, direction, atten, color, seed_x, seed_y,
                torch.zeros_like(alive))
    origin, direction, atten, seed_x, seed_y, alive = extend_paths(
        scene, hit, origin, direction, atten, seed_x, seed_y, did_hit,
        tri_data, mat, rr=rr)
    return origin, direction, atten, color, seed_x, seed_y, alive


def check_seed_secondary(scene) -> None:
    """Raise ValueError for ``seed_secondary`` on a two-level scene.  JAX
    seeds one (wavefront.py:731-732), but there ``bounce_seed`` tests
    world-space rays against object-space leaf blocks, and the block of a
    hit is the packed (instance, block) value, the raw row for instance 0
    and clipped to the last row for every other: the seed is no hit of
    the scene, and its id is not in the kernels' instanced encoding.  On
    the columns with every instance moved down by 0.25, JAX's seeded
    frame differs from its unseeded one in pixels and in rays traced
    (tests/test_torch_channels.py)."""
    if scene.instanced:
        raise ValueError(
            "seed_secondary is not supported on a two-level (instanced) "
            "scene: its leaf blocks are in object space, so the seed is "
            "no hit of the scene")


def bounce_seed(scene, prev_hit, origin, direction, alive) -> Hit:
    """The seed of a bounce after the first (JAX wavefront.py:729-742):
    ``leaf_seed_hit`` of the live rays against the leaf block of their
    previous hit, ``max(tri, 0) // max_leaf_size`` (clipped to the
    table).  A hit of the scene on a flat bake only; ``trace_sample``
    refuses two-level scenes (``check_seed_secondary``)."""
    block = torch.clamp(prev_hit.tri, min=0) // scene.max_leaf_size
    return intersect.leaf_seed_hit(scene, origin, direction, block,
                                   active=alive)


def trace_sample(scene, origin, direction, seed_x, seed_y, *,
                 num_bounces: int, sort_secondary: bool = False,
                 tiers="auto", russian_roulette: bool = False,
                 rr_start_bounce: int = 2, seed_secondary: bool = False):
    """Trace one sample for all rays through ``tiers`` (a Tiers or a
    ``--traversal`` name); with ``russian_roulette`` paths may end after
    the segment of bounce ``rr_start_bounce - 1`` and later ones; with
    ``seed_secondary`` each closest-hit bounce after the first starts
    from ``bounce_seed`` (not an any-hit last bounce, and not on a scene
    baked without a BVH, whose brute force would drop the seed; a
    two-level scene raises ValueError, ``check_seed_secondary``).
    Returns (color (N, 3), new_seed_x, new_seed_y, rays_traced) with
    rays_traced an int64 0-d tensor (the live lanes summed over
    bounces)."""
    if seed_secondary:
        check_seed_secondary(scene)
    n = origin.shape[0]
    dev = origin.device
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)

    hit = None
    for j in range(num_bounces):
        with span("bounce", j):
            count = alive.sum()
            rays_traced = rays_traced + count
            count_live(count)
            last = j == num_bounces - 1
            sorted_pass = sort_secondary and j > 0
            if last and _anyhit_enabled(scene):
                # Emissive-free last bounce: only the sky/miss decision
                # feeds radiance, and no RNG draws happen.
                hit_mask = (_any_hit_sorted if sorted_pass else _any_hit)(
                    scene, origin, direction, alive, tiers)
                with span("shade"):
                    color = _add_sky(color, atten, direction,
                                     alive & ~hit_mask)
                    alive = torch.zeros_like(alive)
                continue
            seed = (bounce_seed(scene, hit, origin, direction, alive)
                    if seed_secondary and j > 0 and scene.has_bvh else None)
            hit = (_closest_hit_sorted if sorted_pass else _closest_hit)(
                scene, origin, direction, alive, tiers,
                "primary" if j == 0 else "secondary", seed)
            with span("shade"):
                origin, direction, atten, color, seed_x, seed_y, alive = \
                    _shade_and_extend(
                        scene, hit, origin, direction, atten, color, seed_x,
                        seed_y, alive, last=last,
                        rr=russian_roulette and j + 1 >= rr_start_bounce)
    return color, seed_x, seed_y, rays_traced


# Lanes per shading chunk of the joint batch: the shading step makes
# some twenty (lanes, 3) f32 temporaries, 2 GB at this size, where the
# whole 1080p batch of 32 frames (66,355,200 lanes) would take 16 GB;
# that batch peaks at 13.3-13.6 GB allocated with it (H100, PERF.md).
# Every traversal launch of the batch is at most this size.
JOINT_CHUNK = 1 << 23


def _chunks(stop: int, chunk: int):
    """[start, end) ranges of at most ``chunk`` lanes covering [0, stop)."""
    return [(s, min(s + chunk, stop)) for s in range(0, stop, chunk)]


def _frame_chunks(batch: int, n: int, chunk: int):
    """(first lane, first pixel, end pixel, frames) of bounce 0's
    shading chunks: as many whole frames as fit in ``chunk`` lanes, or
    pixel ranges of one frame where a frame does not fit."""
    if n <= chunk:
        g = chunk // n
        return [(f * n, 0, n, min(g, batch - f)) for f in range(0, batch, g)]
    return [(f * n + p, p, min(p + chunk, n), 1)
            for f in range(batch) for p in range(0, n, chunk)]


def _frame_lanes(x, p0: int, p1: int, frames: int):
    """Per-pixel values ``x[p0:p1]`` on the lanes of ``frames``
    consecutive frames: a view for one frame, else copies."""
    x = x[p0:p1]
    return x if frames == 1 else x.repeat(frames, *([1] * (x.dim() - 1)))


def trace_progressive_batch(scene, origin, direction, seed_x, seed_y, *,
                            batch: int, num_bounces: int, tiers="auto",
                            russian_roulette: bool = False,
                            rr_start_bounce: int = 2,
                            sort_secondary: bool = True,
                            chunk: int = JOINT_CHUNK):
    """Trace ``batch`` frames of one camera at 1 spp as one wavefront
    (JAX wavefront.py:1146-1356, ``trace_progressive_batch``).

    - Bounce 0 is the same in every frame (the frame counter only seeds
      the RNG): one closest-hit launch on the N primaries, its sky and
      emissive counted ``batch`` times.
    - Its shading (``_shading_info``, the hit point) is computed once
      per pixel; each frame's draws of its next segment
      (``_next_segment``) fill the B*N lane state (origin, direction,
      attenuation, color, the two seeds as int64 holding uint32 values,
      alive, lane id: tensors gathered by one order), in chunks of at
      most ``chunk`` lanes, whole frames where they fit.
    - Each later bounce sorts the live lanes by the 6d key
      (``_bounce_sort_key``, dead lanes last) when ``sort_secondary``,
      then traces and shades them chunk by chunk: middle bounces a
      closest hit and ``_shade_and_extend``, the last one an any hit on
      an emissive-free scene, else a closest hit and the emissive fetch.
    - Each lane's color goes back to its lane id (a permutation, so no
      atomics), and the (B, N, 3) colors are summed over B in frame
      order: the result does not depend on the sort, and is bitwise the
      same from run to run.

    Per-lane results equal the single frames' (``trace_sample`` of
    frame k): each frame's RNG streams, hits and draws are the same;
    the sum differs from B single frames only in f32 rounding.  Rays
    traced (int64 0-d tensor) = N + the live lanes of bounces 1 and on
    = the sum of the B single frames' counts minus (B - 1) * N.

    ``seed_x``, ``seed_y``: (batch, N).  Returns (color_sum (N, 3),
    summed over the frames, rays traced).
    """
    n = origin.shape[0]
    m = batch * n
    dev = origin.device
    with span("bounce", 0):
        count_live(n)
        hit0 = _closest_hit(scene, origin, direction, None, tiers, "primary")
        with span("shade"):
            did0 = hit0.t < MISS_T
            tri0 = get_triangle_data(scene, hit0)
            mat0 = get_material_data(scene, tri0)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            base = torch.where(~did0[:, None], sky_color(direction), zero)
            base = base + torch.where(did0[:, None],
                                      mat0.emissive * EMISSIVE_SCALE, zero)
            color_sum = float(batch) * base    # atten == 1 at bounce 0
            rays = torch.full((), n, dtype=torch.int64, device=dev)
            if num_bounces == 1:
                return color_sum, rays

            # Bounce 0's next segment of every frame, lanes k*N + p for
            # frame k and pixel p: the per-pixel shading once, the draws
            # per lane.
            per_pixel = (*_shading_info(mat0, direction),
                         _hit_point(hit0, origin, direction, tri0), origin,
                         direction, did0)
            seed_x = seed_x.reshape(-1)
            seed_y = seed_y.reshape(-1)
            o = torch.empty((m, 3), dtype=torch.float32, device=dev)
            d = torch.empty_like(o)
            atten = torch.empty_like(o)
            sx = torch.empty_like(seed_x)
            sy = torch.empty_like(seed_y)
            alive = torch.empty(m, dtype=torch.bool, device=dev)
            for s, p0, p1, frames in _frame_chunks(batch, n, chunk):
                e = s + frames * (p1 - p0)
                lanes = [_frame_lanes(x, p0, p1, frames) for x in per_pixel]
                out = _next_segment(
                    ShadingInfo(*lanes[:6]), *lanes[6:9],
                    torch.ones((e - s, 3), dtype=torch.float32, device=dev),
                    seed_x[s:e], seed_y[s:e], lanes[9],
                    rr=russian_roulette and rr_start_bounce <= 1)
                for dst, src in zip((o, d, atten, sx, sy, alive), out):
                    dst[s:e] = src
            color = torch.zeros_like(o)
            lane = torch.arange(m, dtype=torch.int64, device=dev)
    state, traced = _trace_lanes(
        scene, [o, d, atten, color, sx, sy, alive, lane], 1,
        num_bounces=num_bounces, tiers=tiers,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce,
        sort_secondary=sort_secondary, chunk=chunk)
    with span("finish"):
        return (_sum_frames(color_sum, state[3], state[7], batch),
                rays + traced)


def trace_wavefront_pooled(scene, origin, direction, seed_x, seed_y, *,
                           num_bounces: int, tiers="auto",
                           russian_roulette: bool = False,
                           rr_start_bounce: int = 2,
                           sort_secondary: bool = True,
                           chunk: int = JOINT_CHUNK):
    """Trace M rays of several frames, possibly from different cameras,
    as one wavefront at 1 spp (JAX wavefront.py:1016-1143,
    ``trace_wavefront_pooled``: frames in flight).

    The lane state is the joint batch's (``_trace_lanes``), one lane per
    input ray.  Bounce 0 traces the rays in their input order (each
    frame's tile-ordered primaries, frame after frame), in launches of
    at most ``chunk`` lanes; each later bounce sorts the live lanes of
    every frame together by the 6d key when ``sort_secondary``.  The
    last bounce of an emissive-free scene is an any hit.

    Each lane runs the per-lane operations of ``trace_sample`` on its
    own RNG stream, and the traversal kernels' results do not depend on
    a ray's neighbours, so each frame's colors and rays are those of
    rendering it alone.  ``origin``, ``direction``: (M, 3); ``seed_x``,
    ``seed_y``: (M,).  Returns (color (M, 3) in input lane order, rays
    traced, an int64 0-d tensor)."""
    state, rays = _trace_lanes(
        scene, pooled_state(origin, direction, seed_x, seed_y), 0,
        num_bounces=num_bounces, tiers=tiers,
        russian_roulette=russian_roulette, rr_start_bounce=rr_start_bounce,
        sort_secondary=sort_secondary, chunk=chunk)
    with span("finish"):
        return _by_lane(state[3], state[7]), rays


def pooled_state(origin, direction, seed_x, seed_y, first_lane: int = 0):
    """The lane state of primary rays (``_trace_lanes``): attenuation 1,
    color 0, every lane alive, lane ids from ``first_lane``."""
    m = origin.shape[0]
    dev = origin.device
    return [origin.clone(), direction.clone(),
            torch.ones((m, 3), dtype=torch.float32, device=dev),
            torch.zeros((m, 3), dtype=torch.float32, device=dev),
            seed_x.clone(), seed_y.clone(),
            torch.ones(m, dtype=torch.bool, device=dev),
            torch.arange(first_lane, first_lane + m, dtype=torch.int64,
                         device=dev)]


def _trace_lanes(scene, state, first: int, *, num_bounces: int, tiers,
                 russian_roulette: bool, rr_start_bounce: int,
                 sort_secondary: bool, chunk: int, exchange=None):
    """Bounces ``first`` .. ``num_bounces - 1`` of a lane state: the
    tensors (origin, direction, attenuation, color, seed_x, seed_y,
    alive, lane id), gathered by one order.

    Each bounce after bounce 0 first runs ``exchange(state) -> state``
    when given (parallel/rebalance.py: lanes traded between ranks, so
    the live lanes are no longer a prefix and all lanes are counted and
    sorted), then sorts the live lanes by the 6d key
    (``_bounce_sort_key``, dead lanes last) when ``sort_secondary``,
    then traces and shades them in chunks of at most ``chunk`` lanes:
    bounce 0 and the middle bounces a closest hit and
    ``_shade_and_extend``, the last one an any hit on an emissive-free
    scene, else a closest hit and the emissive fetch.  Returns (state,
    rays traced: the live lanes summed over the bounces, int64 0-d)."""
    live = state[0].shape[0]    # lanes [live, m) are dead
    rays = torch.zeros((), dtype=torch.int64, device=state[0].device)
    for j in range(first, num_bounces):
        with span("bounce", j):
            if exchange is not None and j > 0:
                state = exchange(state)
                live = state[0].shape[0]
            count = state[6][:live].sum()
            rays = rays + count
            count_live(count)
            if sort_secondary and j > 0:
                # The live lanes go first: the chunks below trace only
                # them, at the cost of this host sync per bounce.
                with span("sort"):
                    key = _bounce_sort_key(scene, state[0][:live],
                                           state[1][:live], state[6][:live])
                    _, order = state_sort_order(key, 1)
                    del key
                    state = [_permute_prefix(t, order, live) for t in state]
                    del order
                    live = int(count)
            o, d, atten, color, sx, sy, alive, lane = state
            last = j == num_bounces - 1
            rr = russian_roulette and j + 1 >= rr_start_bounce
            for s, e in _chunks(live, chunk):
                if last and _anyhit_enabled(scene):
                    # Emissive-free last bounce: the sky/miss decision.
                    hit_mask = _any_hit(scene, o[s:e], d[s:e], alive[s:e],
                                        tiers)
                    with span("shade"):
                        color[s:e] = _add_sky(color[s:e], atten[s:e],
                                              d[s:e], alive[s:e] & ~hit_mask)
                        alive[s:e] = False
                    continue
                hit = _closest_hit(scene, o[s:e], d[s:e], alive[s:e], tiers,
                                   "primary" if j == 0 else "secondary")
                with span("shade"):
                    out = _shade_and_extend(
                        scene, hit, o[s:e], d[s:e], atten[s:e], color[s:e],
                        sx[s:e], sy[s:e], alive[s:e], last=last, rr=rr)
                    for dst, src in zip((o, d, atten, color, sx, sy, alive),
                                        out):
                        dst[s:e] = src
    return state, rays


def _by_lane(color, lane):
    """The lanes' colors put back by lane id (a permutation: no
    atomics)."""
    color_lane = torch.empty_like(color)
    color_lane[lane] = color
    return color_lane


def _sum_frames(color_sum, color, lane, batch: int):
    """``color_sum`` plus each frame's lane colors, put back by lane id
    (``_by_lane``) and added in frame order."""
    for frame_color in _by_lane(color, lane).view(batch, -1, 3):
        color_sum = color_sum + frame_color
    return color_sum


def _permute_prefix(t: torch.Tensor, order: torch.Tensor, live: int):
    """``t`` with its first ``live`` rows put in ``order``."""
    if live == t.shape[0]:
        return t[order]
    t[:live] = t[:live][order]
    return t
