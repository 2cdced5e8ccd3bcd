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
5. convergence path — the joint progressive batch
   (``RenderPipeline.render_batch_sum``) on the same atrium at bench.py's
   camera at t=0: 320x180 batches of 4 frames at 2 and 3 bounces through
   the kernels and through the plain versions (image difference 0.0),
   run twice (bitwise equal), against the 4 single frames (rays = their
   sum - 3 x N exactly, radiance allclose 1e-5), their launches (quad
   closest hit once per bounce but the last, quad any hit once); the
   1080p batch of 32 frames against the per-frame path's 32 frames (rays
   exactly, mean allclose 1e-5, and that path's seconds), then the time
   to 1024 spp in 32 batches: spp/s, physical and equivalent Mrays/s,
   peak allocated memory, the launch counters zeroed just before and
   read just after (per batch: quad closest hit 1, quad any hit one per
   ``wavefront.JOINT_CHUNK`` live lanes); both quad kernels timed again
   at this path's shapes (the shared primary; one batch's any-hit
   launches on the sorted live prefix) with their bounds, under
   ``*_convergence`` keys; one ``python -m vulkan_pathtracer_tpu_torch
   --progressive --batch-frames 4 --checkpoint`` run and its resume;
6. fly-through path — pooled groups of frames of different cameras
   (``RenderPipeline.render_pooled``, ``--pool-frames``) on the same
   atrium: a group of 4 orbit cameras at 320x180 through the kernels
   and through the plain versions (image difference 0.0, equal rays;
   the same group on ``--instanced`` at 160x90 in phase 8); the 1080p
   fly-through of 32 cameras at ``4.0 * f / 32`` on the orbit, frames
   1..32 (experiments/pooled_frames.py): its rays equal to the sum of
   the 32 single frames', frames 0, 15 and 31 equal to their single
   renders bitwise, two runs bitwise equal, the launch counters zeroed
   just before the group and read just after (quad closest hit
   ceil(32 N / ``wavefront.JOINT_CHUNK``), quad any hit ceil(live /
   ``JOINT_CHUNK``)); sequential and pooled timed, 1 warm-up and the
   best of 3 passes each (ms per frame, Mrays/s, their ratio, the peak
   allocated memory); both quad kernels timed on the group's first
   launch of each (bounce 0's first ``JOINT_CHUNK`` primaries; the
   any hit's first chunk of sorted live lanes) under ``*_pooled`` keys;
   one ``python -m vulkan_pathtracer_tpu_torch --pool-frames 8 --frames
   8`` run at 1080p along the orbit and one ``-v`` run on the Cornell
   box at 64x64;
7. instanced kernels — the pair kernels against their plain versions,
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
8. instanced main path — the atrium through ``load_pipeline(...,
   instanced=True)`` (``--instanced``): 1 warm-up + 4 timed frames, the
   counters read around them (pair 4 each, quad 0); a 320x180
   instanced frame through the kernels and the plain versions; the
   fly-through's pooled group of 4 cameras at 160x90 through both;
9. skip and wide kernels — each against its plain version on the card,
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
10. ``--traversal`` main paths — flat ``pallas_packet``, flat
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
11. tier kernels — the oct kernel, both frontier kernels (width 16; 32
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
12. tier main paths — 1080p, 1 warm-up + 4 timed frames each, the
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
   variables set;
13. dynamic geometry — the flat atrium at leaf 28: (i) pre-split
   (``presplit=0.3`` through ``load_pipeline``): the bake's seconds and
   references, 4 headline frames (quad 4 + 4) whose primaries' t equal
   the unsplit bake's but for ties (another triangle at the same t)
   and box-face misses (one tree's slab test rounds out the nearer hit,
   on a box face or at a coplanar triangle 1-2 ulps nearer; brute force
   confirms the nearer t; at most ``FACE_MISS_SHARE`` of the rays), and
   whose rays differ from the headline's by at most those primaries, a
   320x180 frame through the kernels and the plain versions (0.0); (ii) the
   AnimatedScene (32 instances, coefficient rows) moved by
   experiments/animated_bench.py's motion over 8 frames at ``4.0 * f /
   8`` on the orbit, each frame's rebake, refit and regeneration and
   its 1080p render timed with CUDA events (quad 8 + 8); on the last
   pose the quad closest and any hit and the skip kernel bitwise their
   plain versions on all 2,073,600 primaries, every triangle in its
   leaf box and every child box in its parent's, the closest t equal to
   a fresh host SAH bake's of the moved triangles but for ties and
   box-face misses, ``tri_coefs``
   bitwise a fresh bake of the moved leaves and unlike the unmoved
   table, and 320x180 frames of the oct tier, the frontier tier with
   coefficient leaves, the quad tier with coefficient leaves and
   ``pallas_packet`` kernels against plain versions (0.0); (iii) the
   device rebuild of the twisted atrium (app/dynamic.twist) at phases 0
   and 1, each step (Morton and sort, radix tree, AABB fit, octant
   preorders, tables) and the 1080p render timed (quad 2 + 2), the tree
   bitwise the same rebuild on the CPU, the full-size checks of (ii),
   oct and frontier tables absent and the tier dispatch falling
   through (``kernel_primary`` oct or frontier -> pair), coefficient
   leaves through the quad kernels.  Each kernel's entry carries the
   launches of this phase under ``launches_dynamic``;
14. multi-device — (a) a real NCCL group of one rank per card (at most
   4; one on a one-card machine), started by ``parallel.distributed.
   spawn``: the 1080p atrium (leaf 28, 1 spp, 2 bounces, the orbit at
   t=0) through ``ShardedRenderPipeline`` in ``tiles`` (bitwise
   ``RenderPipeline``'s frame, rays equal) and ``spp`` (bitwise the
   rank-order mean of ``RenderPipeline`` frames at seeds frame * ranks +
   r); (b) on rank 0, the 4-way split rank by rank with no group
   (``render_tile`` / ``render_spp_shard`` at world 4): the 4 tiles
   concatenated bitwise the full frame, the 4 shards' rank-order mean
   bitwise that of 4 single frames; (c) the pooled sharded wavefront of
   4 orbit cameras at 1080p, rebalanced every bounce, bitwise
   ``trace_wavefront_pooled``, rays exact; each of (a) and (c) run with
   the launch counters zeroed just before and read just after on every
   rank (quad closest and any hit, nothing else; under
   ``launches_multidevice``), then timed against its single-device
   counterpart on the same card (median of 5 frames, 3 groups); (d) the
   CLI at 320x180, its four processes started together: ``--devices
   <ranks>`` in tiles and spp (rc 0, the PNG written; the tiles PNG
   equal to the single-device CLI's), and ``--devices <cards + 1>``,
   which must exit non-zero naming the card count.
15. channels — the closest hits' channel builds (a seeded or windowed
   launch; stack_walk.cuh Chan) on the atrium (65,536 live seeded
   bounce rays of the 1080p frame) and the columns (all rays of a
   COLS_W x COLS_H frame), flat at leaf 28 and 14 and two-level at leaf
   14: quad, oct, pair flat and two-level, frontier (exact at leaf 14),
   skip flat and two-level and wide, and the quad, pair and frontier
   builds with coefficient leaves, each bitwise (t, tri, u, v) its
   plain version seeded with ``leaf_seed_hit`` of the rays' previous
   hits, and seeded with its own unseeded result (then bitwise the
   unseeded launch); on pair, frontier and skip the t-window cascade
   at the 33rd and 66th percentiles of the unwindowed t (the windows'
   first hits bitwise its tri and t, each windowed launch bitwise its
   plain version; two-level on the columns only); the atrium's flat
   builds timed with their bounds; the
   seeded path at 1080p (the atrium, leaf 28, 1 spp, 3 bounces, the
   orbit): 1 warm-up and 4 timed frames with ``seed_secondary`` off,
   then on (ms/frame, rays equal, the counters read around the 4
   frames: quad closest hit 8 and any hit 4, then 4 + 4 and the
   channel build 4), every differing pixel at a bounce-1 hit that
   differs by a tie or a box-face miss held to brute force, the seeded
   and unseeded bounce-1 launches and the ``leaf_seed_hit`` pre-pass
   timed; every other channel build launched on a seeded 320x180 flat
   frame of its tier (kernels vs plain versions 0.0), and
   ``seed_secondary`` refused on the two-level bake (ValueError: its
   seeds are no hits of the scene); the multi-rank viewer
   on a world-1 NCCL group under scripted look keys, its text byte for
   byte the single-device viewer's; and the default path unchanged:
   the headline's rays and the joint batch's rays and mean of phases 4
   and 5 equal the parent's.
16. the bf16 product and the frontier guard — the coefficient leaves'
   one-pass bf16 product (``VKPT_MXU_PRECISION=default``; stack_walk.cuh
   Bf16): the flat atrium at leaf 28 (frontier width 16 and 32) and the
   two-level atrium at leaf 14 baked with bf16 tables through
   ``load_pipeline`` (each the f32 rows rounded, bitwise); the quad,
   frontier and two-level pair builds, closest and any hit, bitwise
   their plain versions on their full 1080p launches and timed there
   beside the f32 builds on the same launches (``ms_f32``), with the
   statistics builds; the flat pair and width-32 frontier builds
   bitwise on 65,536 primaries and 65,536 live bounce rays; the quad,
   pair and frontier channel builds seeded (pair and frontier also
   windowed) on 65,536 live seeded bounce rays, timed, and the
   two-level pair channel build on 16,384 rays of the two-level
   columns; paths (b), (d) and (e) with bf16 tables at 1080p (1
   warm-up + 4 timed frames, the bf16 builds' launches) beside the
   same paths on the f32 table: rays, primaries whose hit, miss or
   triangle differs, mean radiance (records, not gates); the channel
   builds on seeded 320x180 frames; the CLI under ``VKPT_MT=mxu
   VKPT_MXU_PRECISION=default`` (JAX's warning once); and the exact
   frontier bake of path (c) at the guard bands 2^-7 and 2^-12, each
   timed: both frontier kernels bitwise their plain versions on the
   2^-12 tables, their hits on the full launches equal the 2^-7 bake's
   but for ties and brute-force-confirmed box-face misses, their times
   on both bakes (in turns) and the statistics builds' node steps and
   leaf visits.

Each kernel's ``bound_ms`` is the larger of its operations over the
card's f32 peak and its bytes over the HBM rate, counted from this
run's inputs: node and leaf visits from the plain version (the same
algorithm) times the per-visit operations of the kernel source;
coefficient leaves by the essential work of their 19 non-zero
coefficients, counted to the exits of the plain version's counters, and
their bytes at the table's element size (4, or 2 for a bf16 table).  The
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
    # The channel builds (stack_walk.cuh Chan): the closest hits' seed
    # channels 7-10 and (pair, frontier, skip) the t-window channel 11,
    # read where each Pallas body starts its best hit and clamps its slab.
    "quad_closest_hit_chan": (f"{CSRC}/stack_traverse.cu", f"{PALLAS}:886"),
    "quad_closest_hit_coef_chan": (f"{CSRC}/stack_traverse.cu",
                                   f"{PALLAS}:886, {MXU}:254"),
    "oct_closest_hit_chan": (f"{CSRC}/stack_traverse.cu", f"{PALLAS}:886"),
    "pair_closest_hit_chan": (f"{CSRC}/pair_traverse.cu", f"{PALLAS}:598"),
    "pair_closest_hit_coef_chan": (f"{CSRC}/pair_traverse.cu",
                                   f"{PALLAS}:598, {MXU}:254"),
    "frontier_closest_hit_chan": (f"{CSRC}/frontier_traverse.cu",
                                  f"{FRONTIER}:284"),
    "frontier_closest_hit_coef_chan": (f"{CSRC}/frontier_traverse.cu",
                                       f"{FRONTIER}:284, {MXU}:254"),
    "skip_closest_hit_chan": (f"{CSRC}/skip_traverse.cu", f"{PACKET}:87"),
    "wide_closest_hit_chan": (f"{CSRC}/skip_traverse.cu", f"{PACKET}:1294"),
    # The builds of the one-pass bf16 product (stack_walk.cuh Bf16;
    # VKPT_MXU_PRECISION=default): mt_coef_visit and mt_coef_visit_anyhit
    # at Precision.DEFAULT (mxu_mt.py:58-80), inlined as above.
    **{f"{fam}_{kind}_hit_bf16": (
        f"{CSRC}/{src}", f"{body}:{line}, {MXU}:{visit}")
       for fam, src, body, closest, anyl in (
           ("quad", "stack_traverse.cu", PALLAS, 886, 1207),
           ("pair", "pair_traverse.cu", PALLAS, 598, 1507),
           ("frontier", "frontier_traverse.cu", FRONTIER, 284, 642))
       for kind, line, visit in (("closest", closest, 254),
                                 ("any", anyl, 302))},
    **{f"{fam}_closest_hit_bf16_chan": (
        f"{CSRC}/{src}", f"{body}:{line}, {MXU}:254")
       for fam, src, body, line in (
           ("quad", "stack_traverse.cu", PALLAS, 886),
           ("pair", "pair_traverse.cu", PALLAS, 598),
           ("frontier", "frontier_traverse.cu", FRONTIER, 284))},
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
# The convergence path: frames per 1080p batch, the target, and the
# frames of the small joint batches held to the plain versions.
CONV_B, CONV_SPP, CONV_SMALL_B = 32, 1024, 4
# The fly-through: cameras per 1080p group (experiments/pooled_frames.py),
# cameras per small group, the instanced small group's size, and the
# CLI's group.
POOL_F, POOL_SMALL_F = 32, 4
POOL_INST_W, POOL_INST_H = 160, 90
POOL_CLI_F = 8
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
# Two trees over the same triangles (pre-split, refitted or rebuilt
# against a fresh SAH bake) may find another triangle at the same t:
# which one a walk keeps depends on its visit order.  Any other
# difference means one walk never tested the nearer hit, because its
# slab test rounded that triangle's box out at a box face (an edge on a
# leaf's face, or a coplanar triangle on it whose t lies 1-2 ulps under
# the face's rounded entry distance).  Each such box-face miss is held
# to brute force, and more than this share of a launch's rays is a
# fault of the tables.
FACE_MISS_SHARE = 1e-5


# Phase 14: at most this many ranks (one card each), the frame seed,
# the frames timed, and the pooled group's cameras and timed runs.
MD_MAX_RANKS, MD_FRAME, MD_REPS = 4, 3, 5
MD_POOL_F, MD_POOL_REPS = 4, 3

# Phase 15: the seeded frames' bounces (3: bounce 1 is the seeded
# closest hit of the emissive-free atrium), the multi-rank viewer's size
# and scripted keys, and the default path's figures this phase holds
# unchanged (phases 4 and 5 of the parent tree).
CH_BOUNCES = 3
VIEWER_W, VIEWER_H, VIEWER_KEYS = 64, 36, "jlikq"
HEADLINE_RAYS = 15510222
JOINT_RAYS, JOINT_MEAN = 1909050493, "0.0575113520"
# The channel builds checked, by (result key, kernel family, bake,
# coefficient leaves, t-window): the bakes are the flat one at leaf 28
# (coefficient rows and wide tiles too), the flat one at leaf 14 (exact
# frontier leaves) and the two-level one at leaf 14.
CHAN_BUILDS = (
    ("quad_closest_hit_chan", "quad", "flat", False, False),
    ("quad_closest_hit_coef_chan", "quad", "flat", True, False),
    ("oct_closest_hit_chan", "oct", "flat", False, False),
    ("pair_closest_hit_chan", "pair", "flat", False, True),
    ("pair_closest_hit_chan", "pair", "instanced", False, True),
    ("pair_closest_hit_coef_chan", "pair", "flat", True, True),
    ("pair_closest_hit_coef_chan", "pair", "instanced", True, True),
    ("frontier_closest_hit_chan", "frontier", "flat14", False, True),
    ("frontier_closest_hit_coef_chan", "frontier", "flat", True, True),
    ("skip_closest_hit_chan", "skip", "flat", False, True),
    ("skip_closest_hit_chan", "skip", "instanced", False, True),
    ("wide_closest_hit_chan", "wide", "flat", False, False))
# The seeded paths that launch each channel build: a 320x180 flat frame at
# CH_BOUNCES bounces with seed_secondary on the bake, under these
# RenderConfig fields (the headline's own build runs at 1080p).
CHAN_PATHS = (
    ("quad_closest_hit_coef_chan", "flat", dict(mt="mxu")),
    ("oct_closest_hit_chan", "flat", dict(kernel_secondary="oct")),
    ("pair_closest_hit_chan", "flat", dict(kernel_secondary="pair")),
    ("pair_closest_hit_coef_chan", "flat",
     dict(kernel_secondary="pair", mt="mxu")),
    ("frontier_closest_hit_chan", "flat14",
     dict(kernel_secondary="frontier")),
    ("frontier_closest_hit_coef_chan", "flat",
     dict(kernel_secondary="frontier", mt="mxu")),
    ("skip_closest_hit_chan", "flat", dict(traversal="pallas_packet")),
    ("wide_closest_hit_chan", "flat", dict(traversal="pallas8")))


def viewer_rank(group, atrium_path):
    """Phase 15 (d), on each rank of a group: the viewer on
    ``ShardedRenderPipeline`` (the atrium at VIEWER_W x VIEWER_H, tiles),
    rank 0 reading the scripted VIEWER_KEYS.  Returns the frames and
    (rank 0) the text presented."""
    import io

    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.parallel.sharding import (
        ShardedRenderPipeline,
    )
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    config = RenderConfig(num_samples=1, num_bounces=2,
                          resolution_x=VIEWER_W, resolution_y=VIEWER_H)
    scene = load_pipeline(atrium_path, config, group.device).scene
    pipe = ShardedRenderPipeline(scene, config, group)
    out = io.StringIO()
    frames = run_viewer(pipe, Camera(aspect_ratio=config.aspect_ratio),
                        out=out, keys=io.StringIO(VIEWER_KEYS), group=group)
    return {"frames": frames, "text": out.getvalue()}


def multidevice_rank(group, atrium_path):
    """Phase 14 (a)-(c) on one rank of the NCCL group (a
    mesh.RenderGroup; this process's card current): the 1080p atrium
    through ``ShardedRenderPipeline`` (tiles, spp) and the rebalanced
    pooled sharded wavefront of MD_POOL_F cameras, each run with the
    launch counters zeroed just before and read just after, then timed
    (host clock around synchronised runs, medians).  Rank 0 also renders
    the single-device references of the same work on the same card,
    times them, and (b) renders the 4-way split rank by rank with no
    group.  Returns a dict of plain values."""
    import statistics

    import torch

    from vulkan_pathtracer_tpu_torch.app.camera_path import orbit_path
    from vulkan_pathtracer_tpu_torch.app.main import load_pipeline
    from vulkan_pathtracer_tpu_torch.models.camera import Camera
    from vulkan_pathtracer_tpu_torch.ops import kernels
    from vulkan_pathtracer_tpu_torch.ops import stack_traverse as st
    from vulkan_pathtracer_tpu_torch.parallel.rebalance import (
        make_pooled_sharded_render,
    )
    from vulkan_pathtracer_tpu_torch.parallel.sharding import (
        ShardedRenderPipeline,
        render_spp_shard,
        render_tile,
        spp_mean,
    )
    from vulkan_pathtracer_tpu_torch.render import pipeline as pl
    from vulkan_pathtracer_tpu_torch.render.wavefront import (
        trace_wavefront_pooled,
    )
    from vulkan_pathtracer_tpu_torch.utils import RenderConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    config = RenderConfig(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                          resolution_y=HEIGHT)
    single = load_pipeline(atrium_path, config, group.device)
    scene = single.scene
    world = group.world

    def camera(t):
        cam = Camera(aspect_ratio=config.aspect_ratio)
        orbit_path(radius=4.5, height=2.2, duration=4.0,
                   center=(0.0, 1.2, 0.0)).apply(cam, t)
        return cam

    def sync():
        torch.cuda.synchronize(group.device)

    def counted(fn):
        for key in st.LAUNCHES:
            st.LAUNCHES[key] = 0
        out = fn()
        sync()
        return out, {k: v for k, v in st.LAUNCHES.items() if v}

    def median_ms(fn, reps):
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1000.0 * (time.perf_counter() - t0))
        return statistics.median(times)

    def result(image, rays, ref, ref_rays, **more):
        return dict(bitwise=ref is None or bool(torch.equal(image, ref)),
                    rays=int(rays), ref_rays=int(rays if ref is None
                                                 else ref_rays),
                    mean=image.float().mean().item(), **more)

    cam = camera(0.0)
    primary = group.primary
    out = {}
    # (a) tiles and spp through ShardedRenderPipeline.
    for mode in ("tiles", "spp"):
        pipe = ShardedRenderPipeline(scene, config, group, mode)
        pipe.render(cam, MD_FRAME)   # warm-up
        (image, rays), launches = counted(lambda: pipe.render(cam, MD_FRAME))
        ref = ref_rays = None
        if primary and mode == "tiles":
            ref, ref_rays = single.render(cam, MD_FRAME)
        elif primary:
            frames = [single.render(cam, MD_FRAME * world + r)
                      for r in range(world)]
            ref = spp_mean([f[0] for f in frames])
            ref_rays = sum(int(f[1]) for f in frames)
        out[mode] = result(image, rays, ref, ref_rays, launches=launches,
                           ms=median_ms(lambda: pipe.render(cam, MD_FRAME),
                                        MD_REPS))
    if primary:
        out["single_ms"] = median_ms(lambda: single.render(cam, MD_FRAME),
                                     MD_REPS)
        # (b) The 4-way split, rank by rank, no group.
        vectors = pl.camera_tensors(cam, group.device)
        kw = dict(world=4, num_samples=1, num_bounces=2, width=WIDTH,
                  height=HEIGHT, tiers=single.tiers,
                  sort_secondary=single._sort_secondary)
        tiles = [render_tile(scene, *vectors, MD_FRAME, rank=r, **kw)
                 for r in range(4)]
        ref, ref_rays = single.render(cam, MD_FRAME)
        out["split_tiles"] = result(torch.cat([t[0] for t in tiles]),
                                    sum(int(t[1]) for t in tiles), ref,
                                    ref_rays)
        shards = [render_spp_shard(scene, *vectors, MD_FRAME, rank=r, **kw)
                  for r in range(4)]
        frames = [single.render(cam, MD_FRAME * 4 + r) for r in range(4)]
        out["split_spp"] = result(spp_mean([s[0] for s in shards]),
                                  sum(int(s[1]) for s in shards),
                                  spp_mean([f[0] for f in frames]),
                                  sum(int(f[1]) for f in frames))
        del tiles, shards, frames
    # (c) The pooled sharded wavefront, rebalanced, MD_POOL_F cameras.
    prims = [pl.primary_rays(*pl.camera_tensors(camera(4.0 * k / MD_POOL_F),
                                                group.device),
                             1 + k, WIDTH, HEIGHT, tiles=single._tiles)[:4]
             for k in range(MD_POOL_F)]
    lanes = [torch.cat([p[i] for p in prims]) for i in range(4)]
    del prims
    kw = dict(num_bounces=2, tiers=single.tiers,
              sort_secondary=single._sort_secondary)
    fn = make_pooled_sharded_render(group, scene, rebalance=True, **kw)
    fn(scene, *lanes)   # warm-up
    (color, rays), launches = counted(lambda: fn(scene, *lanes))
    ref = ref_rays = None
    if primary:
        ref, ref_rays = trace_wavefront_pooled(scene, *lanes, **kw)
    out["pooled"] = result(color, rays, ref, ref_rays, launches=launches,
                           ms=median_ms(lambda: fn(scene, *lanes),
                                        MD_POOL_REPS))
    if primary:
        out["pooled_single_ms"] = median_ms(
            lambda: trace_wavefront_pooled(scene, *lanes, **kw),
            MD_POOL_REPS)
    return out


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
    import numpy as np
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
    from assets.procedural import make_atrium, make_columns, make_cornell
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
        base = key.removesuffix("_chan")   # a channel build: its design's
        b_ms, b_by = bound(tables, n_rays, out_bytes, stats, VISIT_OPS[kind],
                           scene.max_leaf_size, int(scene.instanced),
                           coefs=(scene.tri_coefs if base.endswith(
                               ("_coef", "_bf16")) else None),
                           early=base in EARLY_EXIT,
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

        def run(scene_, o_, d_, active=None, coef=False, seed=None):
            return plain(*args_of(scene_, o_, d_, active, coef),
                         **st.channel_args(o_, seed))
        return run

    def on_plain_versions(fn):
        """fn() with every kernel wrapper replaced by its plain version
        on the card (nothing launched, nothing counted)."""
        kernel_fns = {(mod, n): getattr(mod, n) for mod, names in WRAPPERS
                      for n in names}
        for (mod, n) in kernel_fns:
            setattr(mod, n, plain_wrapper(mod, n))
        try:
            out = fn()
            sync()
        finally:
            for (mod, n), fn_ in kernel_fns.items():
                setattr(mod, n, fn_)
        return out

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
        img_p, rays_p = on_plain_versions(lambda: small.render(cam, 7))
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

    # The closest hits' channel builds, for phases 15 and 16.
    from vulkan_pathtracer_tpu_torch.ops.intersect import Hit

    family = {"quad": (st, quad_args), "oct": (st, oct_args),
              "pair": (st, st.pair_args),
              "frontier": (fr, fr.frontier_args),
              "skip": (sk, lambda s_, o_, d_, a_, c_:
                       sk.skip_args(s_, o_, d_, a_)),
              "wide": (sk, lambda s_, o_, d_, a_, c_:
                       sk.wide_args(s_, o_, d_, a_))}

    def chan_fns(kernel, scene_, o_, d_, active_, coef, seed=None,
                 t_near=None, t_far=None):
        """(launch, plain(stats)) of closest hit ``kernel``'s build
        with these channels: its channel build when any is given,
        else the default build; ``t_far`` folded into t_lane as the
        wrappers do.  Outside the counted paths."""
        mod, args_of = family[kernel]
        args = list(args_of(scene_, o_, d_, active_, coef))
        if t_far is not None:
            args[4 if kernel in ("skip", "wide") else 5] = \
                st.lane_limits(o_.shape[0], active_, dev, t_far)
        chan = st.channel_args(o_, seed, t_near)
        launch = getattr(kernels, f"{kernel}_closest_hit")
        plain = getattr(mod, f"{kernel}_closest_hit_plain")
        return ((lambda: Hit(*launch(*args, **chan))),
                (lambda s=None: plain(*args, stats=s, **chan)))

    def same(label, a, b):
        for f, x, y in zip("t tri u v".split(), a, b):
            check(torch.equal(x, y), f"{label}: {f} differs on "
                  f"{int((x != y).sum())} rays")

    def seeded_bounce(scene_, cam, width, height, frame, tiers="auto"):
        """The sorted bounce-1 launch of a frame through ``tiers``
        (rays, live mask) and the seed the seeded path gives it
        (wavefront.bounce_seed of the primaries' hits)."""
        pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
        o, d, sx, sy, _ = pl.primary_rays(pos, hor, ver, fwd, frame,
                                          width, height)
        hit = wf._closest_hit(scene_, o, d, None, tiers)
        tri_data = get_triangle_data(scene_, hit)
        mat = get_material_data(scene_, tri_data)
        o1, d1, _, _, _, alive = wf.extend_paths(
            scene_, hit, o, d, torch.ones_like(o), sx, sy,
            hit.t < MISS_T, tri_data, mat)
        seed = wf.bounce_seed(scene_, hit, o1, d1, alive)
        order, _ = wf._sorted_order(scene_, o1, d1, alive)
        return (o1[order].contiguous(), d1[order].contiguous(),
                alive[order], Hit(*(x[order] for x in seed)))

    # -- 15. channels (the phase, run after phase 14) -------------------------
    def channels_phase(cols_host, atrium_path, figures):
        """Phase 15: the closest hits' channel builds (seed, t-window).
        ``figures``: the default path's (headline rays, joint batch rays,
        joint mean) from phases 4 and 5, held unchanged.  Returns the
        channel builds' launches on their seeded paths."""
        from vulkan_pathtracer_tpu_torch.ops import intersect
        from vulkan_pathtracer_tpu_torch.parallel import distributed

        t0 = time.perf_counter()
        # (e) The default path, unchanged: the headline and the joint
        # batch of phases 4 and 5 (this run's) against the parent's.
        parent = (HEADLINE_RAYS, JOINT_RAYS, JOINT_MEAN)
        check(figures == parent, f"default path moved: (headline rays, "
              f"joint rays, joint mean) {figures}, parent {parent}")
        phase("channels", check="default path unchanged",
              headline_rays=figures[0], joint_rays=figures[1],
              joint_mean=figures[2])

        # The bakes: the atrium (every channel build, 65,536 live seeded
        # bounce rays of the 1080p frame) and the columns (all rays of a
        # COLS_W x COLS_H frame).
        t1 = time.perf_counter()
        atrium_host = gltf.load(atrium_path)
        bakes = {}
        for label, host in (("atrium", atrium_host), ("columns", cols_host)):
            bakes[label] = {
                "flat": build_device_scene(host, max_leaf_size=28,
                                           device=dev, mt="mxu", wide=True),
                "flat14": build_device_scene(host, max_leaf_size=14,
                                             device=dev),
                "instanced": build_instanced_scene(host, max_leaf_size=14,
                                                   device=dev, mt="mxu")}
        phase("channels", bakes=sorted(bakes["atrium"]),
              seconds=f"{time.perf_counter() - t1:.1f}")

        # (a) Each channel build bitwise its plain version (t, tri, u,
        # v): seeded with leaf_seed_hit of the rays' previous hits, and
        # seeded with its own unseeded result (then bitwise the unseeded
        # launch too); (b) on pair, frontier and skip the t-window
        # cascade at the 33rd and 66th percentiles of the unwindowed t:
        # the three windows' first hits are tri and t bitwise the
        # unwindowed launch, each windowed launch bitwise its plain
        # version.  The atrium's flat channel builds timed at these
        # launches (the headline's own in (c) instead), with their bounds.
        for label, bake in bakes.items():
            rays = {}
            for kind, scene_ in bake.items():
                if label == "atrium":
                    o1, d1, a1, seed = seeded_bounce(
                        scene_, orbit_camera(16 / 9, 0.0), WIDTH, HEIGHT, 0)
                    live = torch.nonzero(a1).squeeze(1)
                    sel = live[subset(live.shape[0], N_SUB, 15)]
                    rays[kind] = (o1[sel].contiguous(), d1[sel].contiguous(),
                                  a1[sel], Hit(*(x[sel] for x in seed)))
                else:
                    rays[kind] = seeded_bounce(scene_, scene_camera(scene_),
                                               COLS_W, COLS_H, 0)
            for key, kernel, kind, coef, window in CHAN_BUILDS:
                scene_ = bake[kind]
                o1, d1, a1, seed = rays[kind]
                tag = f"{label}/{key}/{kind}"
                launch0, _ = chan_fns(kernel, scene_, o1, d1, a1, coef)
                ref = launch0()
                launch, plain = chan_fns(kernel, scene_, o1, d1, a1, coef,
                                         seed=ref)
                same(tag + " seeded with its own hit", launch(), ref)
                launch, plain = chan_fns(kernel, scene_, o1, d1, a1, coef,
                                         seed=seed)
                got = launch()
                same(tag + " seeded", got, plain())
                n_win = 0
                # The two-level atrium's plain walks take 8-11 s a launch
                # on the card: its windows are checked on the columns.
                two_level_atrium = label == "atrium" and kind == "instanced"
                if window and not two_level_atrium:
                    hit = ref.t < MISS_T
                    q1, q2 = torch.quantile(ref.t[hit], torch.tensor(
                        [0.33, 0.66], device=dev)).tolist()
                    parts = []
                    for w in (dict(t_far=q1), dict(t_near=q1, t_far=q2),
                              dict(t_near=q2)):
                        wl, wp = chan_fns(kernel, scene_, o1, d1, a1, coef,
                                          **w)
                        part = wl()
                        same(f"{tag} window {w}", part, wp())
                        parts.append(part)
                    t_u, tri_u = parts[-1].t, parts[-1].tri
                    for part in parts[-2::-1]:
                        m = part.t < MISS_T
                        t_u = torch.where(m, part.t, t_u)
                        tri_u = torch.where(m, part.tri, tri_u)
                    check(torch.equal(t_u, ref.t) and torch.equal(tri_u,
                                                                  ref.tri),
                          f"{tag}: the window cascade's union differs from "
                          f"the unwindowed launch on "
                          f"{int((tri_u != ref.tri).sum())} rays")
                    n_win = [int((p_.t < MISS_T).sum()) for p_ in parts]
                phase("channels", check=tag, rays=o1.shape[0],
                      hits=int((ref.t < MISS_T).sum()),
                      seed_hits=int((seed.t < MISS_T).sum()),
                      seeded_differs=int((got.tri != ref.tri).sum()),
                      seeded_t_differs=int((got.t != ref.t).sum()),
                      window_hits=n_win, bitwise=True)
                if (label == "atrium" and kind != "instanced"
                        and key != "quad_closest_hit_chan"):
                    tables = [x for x in (
                        getattr(scene_, "quad_box" if kernel == "quad"
                                else f"{kernel}_box", None),
                        getattr(scene_, f"{kernel}_link", None),
                        scene_.skip_nodes if kernel == "skip" else None,
                        scene_.wide_nodes if kernel == "wide" else None,
                        st.leaf_table(scene_, coef),
                        scene_.inst_inv if scene_.instanced else None)
                        if x is not None]
                    time_kernel(key, launch, plain, tables, o1.shape[0],
                                32, scene_, bitwise_err)
            del rays
        phase("channels", check="channel builds", seconds=(
            f"{time.perf_counter() - t0:.1f}"))

        # (c) The seeded path at full size: the 1080p atrium (leaf 28, 1
        # spp, CH_BOUNCES bounces, the orbit), 1 warm-up and 4 timed
        # frames with seed_secondary off, then on, the launch counters
        # zeroed just before the 4 frames and read just after.
        t1 = time.perf_counter()
        scene_ = bakes["atrium"]["flat"]
        cfg = dict(num_samples=1, num_bounces=CH_BOUNCES, resolution_x=WIDTH,
                   resolution_y=HEIGHT)
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
        runs = {}
        for on in (False, True):
            pipe_ = pl.RenderPipeline(scene_, RenderConfig(
                **cfg, seed_secondary=on))
            cam = Camera(aspect_ratio=16 / 9)
            path.apply(cam, 0.0)
            pipe_.render(cam, 0, present_order=False)
            sync()
            for k in st.LAUNCHES:
                st.LAUNCHES[k] = 0
            rays_, images = 0, []
            t2 = time.perf_counter()
            for f in range(4):
                path.apply(cam, float(f))
                image, r = pipe_.render(cam, f + 1, present_order=False)
                rays_ += int(r)
                images.append(image)
            sync()
            runs[on] = (1000.0 * (time.perf_counter() - t2) / 4, rays_,
                        dict(st.LAUNCHES), images, pipe_)
        check(runs[False][2] == only(quad_closest_hit=8, quad_any_hit=4),
              f"unseeded 3-bounce launches {runs[False][2]}")
        check(runs[True][2] == only(quad_closest_hit=4, quad_any_hit=4,
                                    quad_closest_hit_chan=4),
              f"seeded 3-bounce launches {runs[True][2]}")
        check(runs[True][1] == runs[False][1],
              f"seeded rays {runs[True][1]} != unseeded {runs[False][1]}")

        # Every pixel that differs must come from a bounce-1 hit that
        # differs: a tie (another triangle at the same t, which the
        # seed keeps) or a box-face miss of either walk (the nearer of
        # the two t held to brute force), at most FACE_MISS_SHARE of the
        # launch's rays.  The seeded frames are
        # rendered again with each seeded launch compared to an unseeded
        # one on the same rays (outside the counted run).
        real_sorted, real_seed = wf._closest_hit_sorted, wf.bounce_seed
        flagged, captured, counts = [], {}, {"ties": 0, "face_misses": 0}

        def recording(sc, o_, d_, a_, tiers="auto", phase_="secondary",
                      seed=None):
            hit = real_sorted(sc, o_, d_, a_, tiers, phase_, seed)
            if seed is not None:
                ref = real_sorted(sc, o_, d_, a_, tiers, phase_)
                differ = ((hit.t != ref.t) | (hit.tri != ref.tri)
                          | (hit.u != ref.u) | (hit.v != ref.v))
                tie = differ & (hit.t == ref.t)
                miss = torch.nonzero(differ & ~tie).squeeze(1)
                if miss.numel():
                    # One walk's slab test rounded the nearer hit's box
                    # out (its entry 1-2 ulps past the hit): the seeded
                    # walk's tighter limit, or the unseeded walk's order.
                    bf = intersect.brute_force_closest_hit(
                        sc, o_[miss], d_[miss], a_[miss])
                    check(torch.equal(bf.t, torch.minimum(hit.t[miss],
                                                          ref.t[miss])),
                          "seeded bounce 1: a differing hit whose nearer t "
                          "brute force does not confirm")
                counts["ties"] += int(tie.sum())
                counts["face_misses"] += int(miss.numel())
                flagged.append(differ)
                if "launch" not in captured:
                    order, _ = wf._sorted_order(sc, o_, d_, a_)
                    captured["launch"] = (
                        o_[order].contiguous(), d_[order].contiguous(),
                        a_[order], Hit(*(x[order] for x in seed)))
            return hit

        def capture_seed(sc, prev, o_, d_, alive):
            captured.setdefault("prepass", (sc, prev, o_, d_, alive))
            return real_seed(sc, prev, o_, d_, alive)

        wf._closest_hit_sorted, wf.bounce_seed = recording, capture_seed
        try:
            cam = Camera(aspect_ratio=16 / 9)
            differing, lanes = 0, 0
            for f in range(4):
                path.apply(cam, float(f))
                flagged.clear()
                image, _ = runs[True][4].render(cam, f + 1,
                                                present_order=False)
                check(torch.equal(image, runs[True][3][f]),
                      f"seeded frame {f + 1} differs from run to run")
                pix = (image != runs[False][3][f]).any(dim=-1).reshape(-1)
                check(not bool((pix & ~flagged[0]).any()),
                      f"seeded frame {f + 1}: a pixel differs where "
                      f"bounce 1's hits are equal")
                differing += int(pix.sum())
                lanes += pix.shape[0]
        finally:
            wf._closest_hit_sorted, wf.bounce_seed = real_sorted, real_seed
        check(counts["face_misses"] <= FACE_MISS_SHARE * lanes,
              f"seeded path: {counts['face_misses']} box-face misses")
        phase("channels", path=f"{WIDTH}x{HEIGHT} {CH_BOUNCES} bounces, "
              "seed_secondary off / on",
              ms_per_frame_off=f"{runs[False][0]:.3f}",
              ms_per_frame_on=f"{runs[True][0]:.3f}", rays=runs[True][1],
              launches_on=runs[True][2], pixels_differ=differing,
              ties=counts["ties"], face_misses=counts["face_misses"],
              card=repr(card))

        # Bounce 1 of frame 1 (the first seeded launch, sorted): the
        # seeded and unseeded launches and the pre-pass, timed.
        o1, d1, a1, seed = captured["launch"]
        pre = captured["prepass"]
        n1 = o1.shape[0]
        un_ms, _ = cuda_ms(lambda: kernels.quad_closest_hit(
            *quad_args(scene_, o1, d1, a1)), 5)
        pre_ms, _ = cuda_ms(lambda: wf.bounce_seed(*pre), 5)
        launch, plain = chan_fns("quad", scene_, o1, d1, a1, False,
                                 seed=seed)
        time_kernel("quad_closest_hit_chan", launch, plain,
                    (scene_.quad_box, scene_.quad_link, scene_.leaves), n1,
                    32, scene_, bitwise_err)
        results["quad_closest_hit_chan"].update(
            unseeded_ms=un_ms, prepass_ms=pre_ms, live=int(a1.sum()),
            seed_hits=int((seed.t < MISS_T).sum()))
        phase("channels", timing="seeded bounce-1 launch, frame 1",
              lanes=n1, live=int(a1.sum()),
              seed_hits=int((seed.t < MISS_T).sum()),
              seeded_ms=f"{results['quad_closest_hit_chan']['ms']:.3f}",
              unseeded_ms=f"{un_ms:.3f}", prepass_ms=f"{pre_ms:.3f}",
              bound_ms=f"{results['quad_closest_hit_chan']['bound_ms']:.4f}",
              card=repr(card))
        launches = {"quad_closest_hit_chan":
                    runs[True][2]["quad_closest_hit_chan"]}
        del runs, captured, flagged
        phase("channels", check="seeded 1080p path",
              seconds=f"{time.perf_counter() - t1:.1f}")

        # The other channel builds on their seeded paths: a small frame
        # through the kernels and through the plain versions (0.0), the
        # build launched (counters read around the frame).
        for key, kind, fields in CHAN_PATHS:
            _, _, got = small_frame(
                bakes["atrium"][kind], f"seeded {key} ({kind})",
                exact=True, bounces=CH_BOUNCES, seed_secondary=True,
                **fields)
            check(got.get(key, 0) >= 1, f"seeded path of {key} ({kind}): "
                  f"launches {got}")
            check(not any(k.endswith("_chan") and k != key for k in got),
                  f"seeded path of {key}: other channel builds {got}")
            launches[key] = launches.get(key, 0) + got[key]
        # Two-level scenes refuse seed_secondary (render/wavefront.
        # check_seed_secondary): (a)'s seeded_differs on them counts the
        # seeds that are no hits of the scene.
        try:
            pl.RenderPipeline(bakes["columns"]["instanced"],
                              RenderConfig(seed_secondary=True))
            refused = False
        except ValueError:
            refused = True
        check(refused, "seed_secondary on a two-level scene was accepted")
        phase("channels", check="seed_secondary refused on two-level",
              refused=True)
        del bakes
        torch.cuda.empty_cache()

        # (d) The multi-rank viewer on a world-1 NCCL group: rank 0's
        # text byte for byte the single-device viewer's under the same
        # scripted look keys, and the frame counts equal.
        import io

        from vulkan_pathtracer_tpu_torch.app.viewer import run_viewer

        t1 = time.perf_counter()
        ranks = distributed.spawn(viewer_rank, 1, "cuda", atrium_path)
        vconfig = RenderConfig(num_samples=1, num_bounces=2,
                               resolution_x=VIEWER_W, resolution_y=VIEWER_H)
        single = load_pipeline(atrium_path, vconfig, dev)
        text = io.StringIO()
        frames = run_viewer(single, Camera(aspect_ratio=vconfig.aspect_ratio),
                            out=text, keys=io.StringIO(VIEWER_KEYS))
        check(ranks[0]["text"] == text.getvalue(),
              "multi-rank viewer: rank 0's text differs from the "
              "single-device viewer's")
        check([r["frames"] for r in ranks] == [frames] * len(ranks),
              f"multi-rank viewer: frames {[r['frames'] for r in ranks]} "
              f"vs {frames}")
        phase("channels", check="multi-rank viewer", ranks=len(ranks),
              frames=frames, text_bytes=len(text.getvalue()),
              byte_equal=True, seconds=f"{time.perf_counter() - t1:.1f}")
        phase("phase", name="channels",
              seconds=f"{time.perf_counter() - t0:.1f}")
        return launches

    # -- 16. the bf16 product and the frontier guard (run after phase 15) ----
    def bf16_phase(atrium_path, cols_path, cols_host):
        """Phase 16: the bf16 builds of the coefficient leaves
        (VKPT_MXU_PRECISION=default) and the frontier guard band.
        Returns the bf16 builds' launches on their main paths."""
        import dataclasses

        t0 = time.perf_counter()
        frame_kw = dict(num_samples=1, num_bounces=2, resolution_x=WIDTH,
                        resolution_y=HEIGHT)
        bf = dict(mt="mxu", mxu_precision="default")
        front = dict(kernel_primary="frontier", anyhit_kernel="frontier")

        def f32_twin(sc):
            """The scene with the f32 table of the same leaves (bitwise
            its f32 bake, ops/mxu_mt.coef_rows)."""
            return dataclasses.replace(sc, tri_coefs=mxu_mt.coef_rows(
                sc.leaves))

        # (a) The bf16 bakes through load_pipeline, as the CLI makes them
        # from VKPT_MT=mxu VKPT_MXU_PRECISION=default: the flat atrium at
        # leaf 28 (frontier width 16, and 32) and the two-level atrium at
        # leaf 14; each table the f32 rows rounded once, bitwise.
        t1 = time.perf_counter()
        bpipe = load_pipeline(atrium_path, RenderConfig(
            **frame_kw, **front, **bf), dev)
        flat_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        epipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, **bf),
                              dev, instanced=True)
        inst_s = time.perf_counter() - t1
        bscene, escene = bpipe.scene, epipe.scene
        w32 = build_device_scene(gltf.load(atrium_path), max_leaf_size=28,
                                 device=dev, frontier_width=32, **bf)
        twins = {id(sc): f32_twin(sc) for sc in (bscene, escene, w32)}
        for sc in (bscene, escene, w32):
            check(sc.tri_coefs.dtype == torch.bfloat16
                  and torch.equal(sc.tri_coefs, mxu_mt.coef_table(
                      twins[id(sc)].tri_coefs, "default")),
                  "bf16 bake: not the f32 rows rounded")
        check(bscene.max_leaf_size == 28 and escene.max_leaf_size == 14
              and w32.frontier_box.shape[1] == 32, "bf16 bakes: shapes")
        phase("bf16", bakes="flat leaf 28 (w16, w32), two-level leaf 14",
              flat_seconds=f"{flat_s:.2f}", instanced_seconds=f"{inst_s:.2f}",
              table_bytes=bscene.tri_coefs.numel() * 2,
              f32_table_bytes=bscene.tri_coefs.numel() * 4)

        # (b) Every bf16 build bitwise its plain version: the quad,
        # frontier (width 16) and two-level pair kernels on their full
        # 1080p launches (timed, beside their f32 builds on the same
        # launches), the flat pair and the width-32 frontier kernels on
        # 65,536 primaries and 65,536 live bounce rays.
        o, d, o1, d1, a1, _ = bounce_rays(bscene, cam0, 0, WIDTH, HEIGHT)
        sel = subset(n_prim, N_SUB, 41)
        live_idx = torch.nonzero(a1).squeeze(1)
        sel1 = live_idx[subset(live_idx.shape[0], N_SUB, 42)]
        for lbl, sc, fam in (("bf16-flat", bscene, "pair"),
                             ("bf16-w32", w32, "frontier")):
            compare_tier(f"{lbl}/primary", sc, o[sel], d[sel],
                         families=(fam,), coef=True)
            compare_tier(f"{lbl}/bounce", sc, o1[sel1], d1[sel1],
                         families=(fam,), coef=True)
        eo, ed, eo1, ed1, ea1, _ = bounce_rays(escene, cam0, 0, WIDTH,
                                               HEIGHT)
        for fam, sc, rays, any_rays in (
                ("quad", bscene, (o, d), (o1, d1, a1)),
                ("frontier", bscene, (o, d), (o1, d1, a1)),
                ("pair", escene, (eo, ed), (eo1, ed1, ea1))):
            time_family(fam, sc, rays, any_rays, True)
            args_fn, ck, _, ak, _ = FAMILIES[fam]
            twin = twins[id(sc)]
            for key, fn, args in (
                    (f"{fam}_closest_hit_bf16", ck,
                     args_fn(twin, *rays, None, True)),
                    (f"{fam}_any_hit_bf16", ak,
                     args_fn(twin, *any_rays, True))):
                f32_ms, _ = cuda_ms(lambda: fn(*args), 5)
                results[key]["ms_f32"] = f32_ms
                phase("timing", kernel=key, f32_build_ms=f"{f32_ms:.3f}",
                      bf16_ms=f"{results[key]['ms']:.3f}", card=repr(card))
        del eo, ed, eo1, ed1, ea1
        phase("bf16", check="bf16 builds", seconds=(
            f"{time.perf_counter() - t0:.1f}"))

        # (c) The channel builds: the quad build seeded, the pair and
        # frontier builds seeded and windowed (t_near at the 33rd
        # percentile of the seeds' t), on 65,536 live seeded bounce rays
        # of the flat atrium, timed and bitwise their plain versions; the
        # two-level pair build on 16,384 rays of the two-level columns.
        so1, sd1, sa1, seed = seeded_bounce(bscene, cam0, WIDTH, HEIGHT, 0)
        live_idx = torch.nonzero(sa1).squeeze(1)
        sel = live_idx[subset(live_idx.shape[0], N_SUB, 43)]
        so1, sd1, sa1 = so1[sel].contiguous(), sd1[sel].contiguous(), sa1[sel]
        seed = Hit(*(x[sel] for x in seed))
        q1 = float(torch.quantile(seed.t[seed.t < MISS_T], 0.33))
        for kernel in ("quad", "pair", "frontier"):
            window = {} if kernel == "quad" else dict(t_near=q1)
            launch, plain = chan_fns(kernel, bscene, so1, sd1, sa1, True,
                                     seed=seed, **window)
            tables = (getattr(bscene, f"{kernel}_box"),
                      getattr(bscene, f"{kernel}_link"), bscene.tri_coefs)
            time_kernel(f"{kernel}_closest_hit_bf16_chan", launch, plain,
                        tables, so1.shape[0], 32, bscene, bitwise_err)
        icols = build_instanced_scene(cols_host, max_leaf_size=14, device=dev,
                                      **bf)
        co1, cd1, ca1, cseed = seeded_bounce(icols, scene_camera(icols),
                                             COLS_W, COLS_H, 0)
        sel = torch.nonzero(ca1).squeeze(1)[:16384]
        launch, plain = chan_fns("pair", icols, co1[sel], cd1[sel], ca1[sel],
                                 True, seed=Hit(*(x[sel] for x in cseed)),
                                 t_near=0.5)
        same("bf16 two-level columns pair channel build", launch(), plain())
        phase("bf16", check="channel builds bitwise", two_level_rays=int(
            sel.shape[0]), seconds=f"{time.perf_counter() - t0:.1f}")
        del so1, sd1, sa1, seed, co1, cd1, ca1, cseed, icols

        # (d) Paths (b), (d), (e) with bf16 tables at 1080p (1 warm-up +
        # 4 timed frames, the counters read around the 4 frames), each
        # beside the same path on the f32 table in this call: rays, the
        # primaries whose hit, miss or triangle differs (4 cameras), and
        # the mean radiance of frame 1.  Records, not gates.
        t1 = time.perf_counter()
        launches = {}
        paths = (
            ("b", bpipe, bscene, front,
             ("frontier_closest_hit", "frontier_any_hit")),
            ("d", pl.RenderPipeline(bscene, RenderConfig(**frame_kw, **bf)),
             bscene, {}, ("quad_closest_hit", "quad_any_hit")),
            ("e", epipe, escene, {}, ("pair_closest_hit", "pair_any_hit")))
        for lbl, pipe_, sc, tiers_, names in paths:
            ref_pipe = pl.RenderPipeline(twins[id(sc)], RenderConfig(
                **frame_kw, mt="mxu", **tiers_))
            got, rays_bf = main_path(pipe_, f"bf16-{lbl}", only(
                **{f"{n}_bf16": 4 for n in names}))
            _, rays_32 = main_path(ref_pipe, f"bf16-{lbl}-f32-reference",
                                   only(**{f"{n}_coef": 4 for n in names}))
            for n in names:
                launches[f"{n}_bf16"] = got[f"{n}_bf16"]
            t_bf = Tiers(mt="mxu", mxu_precision="default", **tiers_)
            t_32 = Tiers(mt="mxu", **tiers_)
            differ = 0
            for f in range(4):
                po, pd = orbit_rays(f)
                a = wf._closest_hit(sc, po, pd, None, t_bf)
                b = wf._closest_hit(twins[id(sc)], po, pd, None, t_32)
                differ += int(((a.t < MISS_T) != (b.t < MISS_T))
                              .logical_or(a.tri != b.tri).sum())
            cam = orbit_camera(config.aspect_ratio, 0.0)
            m_bf = float(pipe_.render(cam, 1)[0].mean())
            m_32 = float(ref_pipe.render(cam, 1)[0].mean())
            phase("bf16", path=f"({lbl}) bf16 vs f32 table", rays=rays_bf,
                  f32_rays=rays_32,
                  rays_change=f"{(rays_bf - rays_32) / rays_32:+.6f}",
                  primaries_differ=differ,
                  share=f"{differ / (4 * n_pix):.6f}",
                  mean=f"{m_bf:.7f}", f32_mean=f"{m_32:.7f}",
                  mean_change=f"{(m_bf - m_32) / m_32:+.6f}")
        del paths, bpipe, epipe

        # The bf16 channel builds on their seeded paths: a 320x180
        # 3-bounce flat frame through the kernels and through the plain
        # versions (0.0), the build launched.
        for key, fields in (("quad_closest_hit_bf16_chan", {}),
                            ("pair_closest_hit_bf16_chan",
                             dict(kernel_secondary="pair")),
                            ("frontier_closest_hit_bf16_chan",
                             dict(kernel_secondary="frontier"))):
            _, _, got = small_frame(bscene, f"seeded {key}", exact=True,
                                    bounces=CH_BOUNCES, seed_secondary=True,
                                    **bf, **fields)
            check(got.get(key, 0) >= 1, f"seeded path of {key}: {got}")
            launches[key] = got[key]

        # The CLI under the JAX package's variables, on the card.
        out_png = os.path.join(WORK, "cli_bf16.png")
        env = {**os.environ, "VKPT_MT": "mxu", "VKPT_LEAF": "28",
               "VKPT_MXU_PRECISION": "default"}
        proc = subprocess.run(
            [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s",
             cols_path, "-x", str(SMALL_W), "-y", str(SMALL_H), "-o",
             out_png], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        warned = proc.stderr.count("VKPT_MXU_PRECISION=default is "
                                   "quality-broken")
        check(proc.returncode == 0 and warned == 1
              and "mt=mxu leaf=28 mxu_precision=default" in proc.stderr
              and os.path.exists(out_png),
              f"CLI with VKPT_MXU_PRECISION=default: rc {proc.returncode}\n"
              f"{proc.stderr}")
        phase("bf16", check="CLI VKPT_MT=mxu VKPT_MXU_PRECISION=default",
              rc=proc.returncode, warnings=warned,
              timing=repr([ln for ln in proc.stderr.splitlines()
                           if "frame(s) on" in ln][-1]))
        phase("bf16", check="paths", seconds=f"{time.perf_counter() - t1:.1f}")
        del bscene, escene, w32, twins
        torch.cuda.empty_cache()

        # (e) The frontier guard: the exact frontier bake of path (c) (leaf
        # 14) at 2^-7 and at 2^-12, each bake timed; both frontier kernels
        # bitwise their plain versions on the 2^-12 tables (65,536 rays
        # each); on the full launches their hits against the 2^-7 bake's
        # (ties and brute-force-confirmed box-face misses, capped at
        # FACE_MISS_SHARE; the any-hit bit), their times on both bakes
        # in turns, and the statistics builds' node steps and leaf visits.
        t1 = time.perf_counter()
        host = gltf.load(atrium_path)
        guards, bake_s = {}, {}
        for g in (2.0 ** -7, 2.0 ** -12):
            t2 = time.perf_counter()
            guards[g] = build_device_scene(host, max_leaf_size=14, device=dev,
                                           frontier_guard=g)
            sync()
            bake_s[g] = time.perf_counter() - t2
        wide, tight = guards[2.0 ** -7], guards[2.0 ** -12]
        check(torch.equal(wide.frontier_link, tight.frontier_link)
              and tight.frontier_guard == 2.0 ** -12,
              "guard bakes: links differ")
        o, d, o1, d1, a1, _ = bounce_rays(wide, cam0, 0, WIDTH, HEIGHT)
        sel = subset(n_prim, N_SUB, 44)
        live_idx = torch.nonzero(a1).squeeze(1)
        sel1 = live_idx[subset(live_idx.shape[0], N_SUB, 45)]
        compare_tier("guard-2^-12/primary", tight, o[sel], d[sel],
                     families=("frontier",))
        compare_tier("guard-2^-12/bounce", tight, o1[sel1], d1[sel1],
                     families=("frontier",))
        cargs = {g: fr.frontier_args(sc, o, d, None)
                 for g, sc in guards.items()}
        aargs = {g: fr.frontier_args(sc, o1, d1, a1)
                 for g, sc in guards.items()}
        a = Hit(*kernels.frontier_closest_hit(*cargs[2.0 ** -7]))
        b = Hit(*kernels.frontier_closest_hit(*cargs[2.0 ** -12]))
        ties, misses = hit_differences("guard 2^-12 vs 2^-7 primaries", wide,
                                       o, d, a.t, physical(wide, a), b.t,
                                       physical(tight, b))
        ka = kernels.frontier_any_hit(*aargs[2.0 ** -7])
        kb = kernels.frontier_any_hit(*aargs[2.0 ** -12])
        flip = torch.nonzero(ka != kb).squeeze(1)
        if flip.numel():
            brute = intersect.brute_force_closest_hit(
                wide, o1[flip], d1[flip], chunk=1 << 16)
            check(torch.equal(brute.t < MISS_T, ka[flip] | kb[flip]),
                  "guard: an any-hit bit brute force does not confirm")
        check(flip.numel() <= FACE_MISS_SHARE * n_prim,
              f"guard: {flip.numel()} any-hit bits differ")
        times = {}
        for g in (2.0 ** -7, 2.0 ** -12, 2.0 ** -12, 2.0 ** -7):
            for key, fn, args in (
                    ("frontier_closest_hit", kernels.frontier_closest_hit,
                     cargs[g]),
                    ("frontier_any_hit", kernels.frontier_any_hit,
                     aargs[g])):
                times.setdefault((key, g), []).append(
                    cuda_ms(lambda: fn(*args), 5)[0])
        visits = {}
        for g in guards:
            for any_hit, args in ((False, cargs[g]), (True, aargs[g])):
                _, counters = kernels.frontier_stats(any_hit, *args)
                c = dict(zip(kernels.STACK_STATS, counters))
                visits[(any_hit, g)] = (c["node_lanes"], c["leaf_visits"])
        for key, any_hit in (("frontier_closest_hit", False),
                             ("frontier_any_hit", True)):
            ms7 = sum(times[(key, 2.0 ** -7)]) / 2
            ms12 = sum(times[(key, 2.0 ** -12)]) / 2
            results.setdefault(key, {}).update(
                ms_guard_2e7=ms7, ms_guard_2e12=ms12,
                leaf_visits_guard_2e7=visits[(any_hit, 2.0 ** -7)][1],
                leaf_visits_guard_2e12=visits[(any_hit, 2.0 ** -12)][1])
            phase("guard", kernel=key, ms_2e7=f"{ms7:.3f}",
                  ms_2e12=f"{ms12:.3f}",
                  node_steps_2e7=visits[(any_hit, 2.0 ** -7)][0],
                  node_steps_2e12=visits[(any_hit, 2.0 ** -12)][0],
                  leaf_visits_2e7=visits[(any_hit, 2.0 ** -7)][1],
                  leaf_visits_2e12=visits[(any_hit, 2.0 ** -12)][1],
                  card=repr(card))
        phase("guard", bake_seconds_2e7=f"{bake_s[2.0 ** -7]:.2f}",
              bake_seconds_2e12=f"{bake_s[2.0 ** -12]:.2f}", ties=ties,
              face_misses=misses, any_hit_flips=int(flip.numel()),
              seconds=f"{time.perf_counter() - t1:.1f}")
        del guards, wide, tight, cargs, aargs, o, d, o1, d1, a1
        torch.cuda.empty_cache()
        phase("phase", name="bf16 product and frontier guard",
              seconds=f"{time.perf_counter() - t0:.1f}")
        return launches

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
    t1 = time.perf_counter()
    pipe = load_pipeline(atrium_path, config, dev)
    scene = pipe.scene
    phase("scene", triangles=scene.num_triangles, leaf=scene.max_leaf_size,
          quad_rows=scene.quad_box.shape[0], leaves=scene.leaves.shape[0],
          depth=scene.bvh_depth, emissive_free=scene.emissive_free,
          sort_secondary=pipe._sort_secondary,
          load_bake_seconds=f"{time.perf_counter() - t1:.2f}",
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
    del o1, d1, a1, targs, aargs
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
    phase("phase", name="flat main path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 5. convergence path -------------------------------------------------
    # The joint progressive batch on the flat atrium at bench.py's camera
    # at t=0: small batches through the kernels and the plain versions,
    # twice, and against single frames; then the 1080p run to 1024 spp.
    t0 = time.perf_counter()
    n_small = SMALL_W * SMALL_H
    for bounces in (2, 3):
        spipe = pl.RenderPipeline(scene, RenderConfig(
            num_samples=1, num_bounces=bounces, resolution_x=SMALL_W,
            resolution_y=SMALL_H))
        before = dict(st.LAUNCHES)
        img_k, rays_k = spipe.render_batch_sum(cam0, 8, CONV_SMALL_B)
        sync()
        launched = {k: v - before[k] for k, v in st.LAUNCHES.items()
                    if v != before[k]}
        img_k2, rays_k2 = spipe.render_batch_sum(cam0, 8, CONV_SMALL_B)
        img_p, rays_p = on_plain_versions(
            lambda: spipe.render_batch_sum(cam0, 8, CONV_SMALL_B))
        singles = [spipe.render(cam0, 8 + k) for k in range(CONV_SMALL_B)]
        single_rays = sum(int(r) for _, r in singles)
        label = f"joint {SMALL_W}x{SMALL_H} B={CONV_SMALL_B} b={bounces}"
        check(int(rays_k) == int(rays_k2) == int(rays_p),
              f"{label}: rays {int(rays_k)}, {int(rays_k2)} (kernels), "
              f"{int(rays_p)} (plain)")
        diff = (img_k - img_p).abs().max().item()
        check(diff == 0.0, f"{label}: kernels vs plain differ by {diff}")
        check(torch.equal(img_k, img_k2), f"{label}: two runs differ")
        check(int(rays_k) == single_rays - (CONV_SMALL_B - 1) * n_small,
              f"{label}: rays {int(rays_k)}, single frames {single_rays}")
        want = sum(img for img, _ in singles)
        check(torch.allclose(img_k, want, rtol=1e-5, atol=1e-5),
              f"{label}: differs from the single frames' sum by "
              f"{(img_k - want).abs().max().item()}")
        check(launched.get("quad_closest_hit") == bounces - 1
              and launched.get("quad_any_hit") == 1 and len(launched) == 2,
              f"{label}: launches {launched}")
        phase("convergence", check=label, rays=int(rays_k),
              single_frames_rays=single_rays, max_abs_diff_plain=diff,
              bitwise_stable=True,
              max_abs_diff_singles=(img_k - want).abs().max().item(),
              launches=launched)
    del spipe, singles, img_k, img_k2, img_p, want

    # 1080p, 32 frames per batch: one warm-up batch (frames 0-31, held to
    # the 32 single frames of the per-frame path), then the time to 1024
    # spp, the counters zeroed just before and read just after.
    cpipe = pl.RenderPipeline(scene, RenderConfig(
        num_samples=1, num_bounces=2, resolution_x=WIDTH,
        resolution_y=HEIGHT))
    warm, warm_rays = cpipe.render_batch_sum(cam0, 0, CONV_B)
    sync()
    t1 = time.perf_counter()
    single_sum = torch.zeros_like(warm)
    single_rays = []
    for f in range(CONV_B):
        img, r = cpipe.render(cam0, f)
        single_sum += img
        single_rays.append(r)
    sync()
    single_s = time.perf_counter() - t1
    single_total = sum(int(r) for r in single_rays)
    check(int(warm_rays) == single_total - (CONV_B - 1) * n_pix,
          f"1080p joint batch: rays {int(warm_rays)}, single frames "
          f"{single_total}")
    check(torch.allclose(warm / CONV_B, single_sum / CONV_B, rtol=1e-5,
                         atol=1e-5), "1080p joint batch differs from the "
          "single frames' mean by "
          f"{((warm - single_sum) / CONV_B).abs().max().item()}")
    del warm, single_sum
    torch.cuda.reset_peak_memory_stats(dev)
    for key in st.LAUNCHES:
        st.LAUNCHES[key] = 0
    t1 = time.perf_counter()
    acc, spp, batch_rays = None, 0, []
    while spp < CONV_SPP:
        b = min(CONV_B, CONV_SPP - spp)
        sum_img, r = cpipe.render_batch_sum(cam0, spp, b)
        acc = sum_img if acc is None else acc + sum_img
        batch_rays.append(r)
        spp += b
    float(acc.sum())   # waits for the last batch
    conv_s = time.perf_counter() - t1
    conv_launches = dict(st.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    batch_rays = [int(r) for r in batch_rays]
    n_batches = len(batch_rays)
    any_launches = [-(-(r - n_pix) // wf.JOINT_CHUNK) for r in batch_rays]
    check(conv_launches == only(quad_closest_hit=n_batches,
                                quad_any_hit=sum(any_launches)),
          f"1080p convergence: launches {conv_launches}, expected quad "
          f"closest hit {n_batches}, any hit {sum(any_launches)}")
    mean = acc / CONV_SPP
    check(bool(torch.isfinite(mean).all())
          and tuple(mean.shape) == (HEIGHT, WIDTH, 3),
          "1080p convergence: non-finite or misshapen image")
    spp_s = CONV_SPP / conv_s
    phase("convergence", path=f"{WIDTH}x{HEIGHT} B={CONV_B} to {CONV_SPP} "
          "spp", seconds_to_target=f"{conv_s:.3f}", spp_per_s=f"{spp_s:.3f}",
          physical_mrays_per_s=f"{sum(batch_rays) / conv_s / 1e6:.3f}",
          equivalent_mrays_per_s=f"{spp_s * n_pix * 2 / 1e6:.3f}",
          peak_allocated_gb=f"{peak_gb:.3f}", batches=n_batches,
          rays=sum(batch_rays), launches=conv_launches,
          launches_per_batch={"quad_closest_hit": 1,
                              "quad_any_hit": sorted(set(any_launches))},
          chunk=wf.JOINT_CHUNK, mean=f"{mean.mean().item():.10f}",
          per_frame_path_frames=CONV_B,
          per_frame_path_seconds=f"{single_s:.3f}",
          per_frame_path_spp_per_s=f"{CONV_B / single_s:.3f}",
          card=repr(card))
    write_png(os.path.join(WORK, "convergence.png"), mean.cpu().numpy())
    conv_figures = (sum(batch_rays), f"{mean.mean().item():.10f}")
    del acc, mean

    # Rows 1-2 at this path's shapes: the shared primary (the launch
    # timed in phase 3, again) and one batch's any-hit launches on the
    # sorted live prefix, captured from a batch outside the counted run.
    captured = []
    real_any_hit = wf._any_hit

    def capture(scene_, o_, d_, active, tiers="auto"):
        captured.append((o_.clone(), d_.clone(), active.clone()))
        return real_any_hit(scene_, o_, d_, active, tiers)

    wf._any_hit = capture
    try:
        cpipe.render_batch_sum(cam0, 0, CONV_B)
        sync()
    finally:
        wf._any_hit = real_any_hit
    tables = (scene.quad_box, scene.quad_link, scene.leaves)
    targs = quad_args(scene, o, d, None)
    time_kernel("quad_closest_hit", lambda: kernels.quad_closest_hit(*targs),
                lambda s=None: st.quad_closest_hit_plain(*targs, stats=s),
                tables, n_prim, 16, scene, closest_err, tag="_convergence")
    chunks = [quad_args(scene, *c) for c in captured]
    n_any = sum(c[3].shape[0] for c in chunks)
    time_kernel("quad_any_hit",
                lambda: [kernels.quad_any_hit(*c) for c in chunks],
                lambda s=None: [st.quad_any_hit_plain(*c, stats=s)
                                for c in chunks],
                tables, n_any, 1, scene,
                lambda k, p: any_err(torch.cat(k), torch.cat(p)),
                tag="_convergence")
    phase("timing", kernel="quad_any_hit_convergence", launches=len(chunks),
          rays=n_any, live=int(sum(int(c[2].sum()) for c in captured)))
    for key in ("quad_closest_hit", "quad_any_hit"):
        plain_outputs.pop(key + "_convergence")
        results[key]["launches_convergence"] = conv_launches[key]
        results[key]["launches_convergence_batches"] = n_batches
    del captured, chunks, targs, cpipe, o, d

    # The CLI: a progressive run in batches of 4 with a checkpoint, then
    # its resume.
    ckpt = os.path.join(WORK, "cli_progressive.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    out_png = os.path.join(WORK, "cli_progressive.png")
    for frames, want in ((8, None), (12, "resumed checkpoint at frame 8 "
                                        "(8 spp)")):
        proc = subprocess.run(
            [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s",
             cols_path, "-x", str(SMALL_W), "-y", str(SMALL_H), "-o",
             out_png, "--progressive", "--batch-frames", "4", "--frames",
             str(frames), "--checkpoint", ckpt, "--checkpoint-interval",
             "4"], cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0 and (want is None or want in proc.stderr)
              and f"({frames} spp)" in proc.stderr,
              f"progressive CLI to {frames} frames: rc {proc.returncode}\n"
              f"{proc.stderr}")
    meta = json.loads(str(np.load(ckpt)["meta"]))
    check(meta["frame"] == 12 and meta["spp"] == 12,
          f"checkpoint after the resume: {meta}")
    phase("convergence", check="CLI --progressive --batch-frames 4 "
          "--checkpoint, resumed", rc=proc.returncode, checkpoint=meta,
          timing=repr([ln for ln in proc.stderr.splitlines()
                       if "frame(s) on" in ln][-1]))
    torch.cuda.empty_cache()
    phase("phase", name="convergence path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 6. fly-through path -------------------------------------------------
    # Pooled groups of frames of different cameras (render_pooled) on the
    # flat atrium: a small group through the kernels and the plain
    # versions, then the 1080p group of POOL_F cameras.
    t0 = time.perf_counter()

    def group_cameras(count, aspect):
        """``count`` cameras on the interior orbit at 4.0 * f / count."""
        path = orbit_path(radius=4.5, height=2.2, duration=4.0,
                          center=(0.0, 1.2, 0.0))
        cams = []
        for f in range(count):
            cams.append(Camera(aspect_ratio=aspect))
            path.apply(cams[-1], path.duration * f / count)
        return cams

    def small_group(scene_, label, width, height):
        """A pooled group of POOL_SMALL_F cameras through the kernels and
        through the plain versions: rays equal, image difference 0.0."""
        gpipe = pl.RenderPipeline(scene_, RenderConfig(
            num_samples=1, num_bounces=2, resolution_x=width,
            resolution_y=height))
        cams = group_cameras(POOL_SMALL_F, width / height)
        frames = list(range(1, POOL_SMALL_F + 1))
        before = dict(st.LAUNCHES)
        img_k, rays_k = gpipe.render_pooled(cams, frames)
        sync()
        launched = {k: v - before[k] for k, v in st.LAUNCHES.items()
                    if v != before[k]}
        img_p, rays_p = on_plain_versions(
            lambda: gpipe.render_pooled(cams, frames))
        diff = (img_k - img_p).abs().max().item()
        check(int(rays_k) == int(rays_p) and diff == 0.0,
              f"{label} pooled {width}x{height}: rays {int(rays_k)} "
              f"(kernels) vs {int(rays_p)} (plain), image differs by {diff}")
        check(bool(torch.isfinite(img_k).all()) and img_k.mean() > 0,
              f"{label} pooled {width}x{height}: non-finite or black")
        phase("flythrough", check=f"{label} {POOL_SMALL_F} cameras "
              f"{width}x{height} kernels vs plain", rays=int(rays_k),
              max_abs_diff=diff, launches=launched)

    small_group(scene, "flat", SMALL_W, SMALL_H)

    # The 1080p fly-through: the single frames first (the sequential
    # path's warm-up, which keeps frames 0, 15 and 31), then the pooled
    # group with the counters zeroed just before and read just after.
    cams = group_cameras(POOL_F, config.aspect_ratio)
    frames = list(range(1, POOL_F + 1))
    kept = (0, POOL_F // 2 - 1, POOL_F - 1)
    solo, solo_rays = {}, []
    for k, (cam, frame) in enumerate(zip(cams, frames)):
        img, r = pipe.render(cam, frame)
        solo_rays.append(int(r))
        if k in kept:
            solo[k] = img
    sync()
    for key in st.LAUNCHES:
        st.LAUNCHES[key] = 0
    images, pooled_rays = pipe.render_pooled(cams, frames)
    sync()
    pooled_launches = dict(st.LAUNCHES)
    pooled_rays = int(pooled_rays)
    check(pooled_rays == sum(solo_rays), f"fly-through: pooled rays "
          f"{pooled_rays}, single frames {sum(solo_rays)}")
    m_lanes = POOL_F * n_pix
    want = only(quad_closest_hit=-(-m_lanes // wf.JOINT_CHUNK),
                quad_any_hit=-(-(pooled_rays - m_lanes) // wf.JOINT_CHUNK))
    check(pooled_launches == want, f"fly-through: launches "
          f"{pooled_launches}, expected {want}")
    check(tuple(images.shape) == (POOL_F, HEIGHT, WIDTH, 3)
          and bool(torch.isfinite(images).all()),
          "fly-through: non-finite or misshapen images")
    solo_diff = {k: (images[k] - solo[k]).abs().max().item() for k in kept}
    check(all(torch.equal(images[k], solo[k]) for k in kept),
          f"fly-through: frames {kept} differ from their single renders "
          f"by {solo_diff}")
    again, again_rays = pipe.render_pooled(cams, frames)
    check(int(again_rays) == pooled_rays and torch.equal(images, again),
          "fly-through: two pooled runs differ")
    write_png(os.path.join(WORK, "flythrough_31.png"),
              images[POOL_F - 1].cpu().numpy())
    del again, images, solo

    def best_of(run):
        """Seconds of the best of 3 passes after 1 warm-up, the rays of
        a pass and the peak allocated memory of the passes."""
        run()
        torch.cuda.reset_peak_memory_stats(dev)
        best = float("inf")
        for _ in range(3):
            t1 = time.perf_counter()
            rays_ = run()
            best = min(best, time.perf_counter() - t1)
        return best, rays_, torch.cuda.max_memory_allocated(dev) / 1e9

    def sequential():
        total = 0
        for cam, frame in zip(cams, frames):
            img, r = pipe.render(cam, frame)
            total += int(r)   # syncs: r is a device scalar
        return total

    def pooled():
        imgs, r = pipe.render_pooled(cams, frames)
        return int(r)

    seq_s, seq_rays, seq_gb = best_of(sequential)
    pool_s, pool_rays, pool_gb = best_of(pooled)
    check(seq_rays == pool_rays == pooled_rays,
          f"fly-through timing: rays {seq_rays} / {pool_rays}")
    phase("flythrough", path=f"{WIDTH}x{HEIGHT} {POOL_F} cameras",
          rays=pooled_rays, launches=pooled_launches,
          frames_equal_to_single=list(kept), max_abs_diff_single=solo_diff,
          bitwise_stable=True,
          sequential_ms_per_frame=f"{1000.0 * seq_s / POOL_F:.3f}",
          pooled_ms_per_frame=f"{1000.0 * pool_s / POOL_F:.3f}",
          sequential_mrays_per_s=f"{seq_rays / seq_s / 1e6:.3f}",
          pooled_mrays_per_s=f"{pool_rays / pool_s / 1e6:.3f}",
          pooled_over_sequential=f"{seq_s / pool_s:.4f}",
          sequential_peak_allocated_gb=f"{seq_gb:.3f}",
          pooled_peak_allocated_gb=f"{pool_gb:.3f}",
          chunk=wf.JOINT_CHUNK, card=repr(card))

    # Rows 1-2 at this path's shapes: the group's first closest-hit
    # launch (bounce 0, the first JOINT_CHUNK primaries) and its first
    # any-hit launch (the first chunk of the sorted live lanes),
    # captured from a group outside the counted run.
    captured = {"closest": [], "any": []}
    real_closest, real_any = wf._closest_hit, wf._any_hit

    def capture_closest(scene_, o_, d_, active, tiers="auto", ph="primary"):
        if not captured["closest"]:
            captured["closest"].append((o_.clone(), d_.clone(),
                                        active.clone()))
        return real_closest(scene_, o_, d_, active, tiers, ph)

    def capture_any(scene_, o_, d_, active, tiers="auto"):
        if not captured["any"]:
            captured["any"].append((o_.clone(), d_.clone(), active.clone()))
        return real_any(scene_, o_, d_, active, tiers)

    wf._closest_hit, wf._any_hit = capture_closest, capture_any
    try:
        pipe.render_pooled(cams, frames)
        sync()
    finally:
        wf._closest_hit, wf._any_hit = real_closest, real_any
    tables = (scene.quad_box, scene.quad_link, scene.leaves)
    cargs = quad_args(scene, *captured["closest"][0])
    time_kernel("quad_closest_hit", lambda: kernels.quad_closest_hit(*cargs),
                lambda s=None: st.quad_closest_hit_plain(*cargs, stats=s),
                tables, cargs[3].shape[0], 16, scene, closest_err,
                tag="_pooled")
    pargs_ = quad_args(scene, *captured["any"][0])
    time_kernel("quad_any_hit", lambda: kernels.quad_any_hit(*pargs_),
                lambda s=None: st.quad_any_hit_plain(*pargs_, stats=s),
                tables, pargs_[3].shape[0], 1, scene, any_err, tag="_pooled")
    phase("timing", kernel="quad_any_hit_pooled", rays=pargs_[3].shape[0],
          live=int(captured["any"][0][2].sum()))
    for key in ("quad_closest_hit", "quad_any_hit"):
        plain_outputs.pop(key + "_pooled")
        results[key]["launches_pooled"] = pooled_launches[key]
        results[key]["launches_pooled_groups"] = 1
    del captured, cargs, pargs_

    # The CLI: a pooled fly-through at 1080p along the orbit, and -v.
    orbit_json = os.path.join(WORK, "orbit.json")
    with open(orbit_json, "w") as f:
        json.dump(orbit_path(radius=4.5, height=2.2, duration=4.0,
                             center=(0.0, 1.2, 0.0)).keyframes, f)
    out_png = os.path.join(WORK, "cli_pooled.png")
    if os.path.exists(out_png):
        os.remove(out_png)
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s",
         atrium_path, "-o", out_png, "--pool-frames", str(POOL_CLI_F),
         "--frames", str(POOL_CLI_F), "--camera-path", orbit_json],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and os.path.exists(out_png)
          and f"{POOL_CLI_F} frame(s) on cuda" in proc.stderr,
          f"pooled CLI: rc {proc.returncode}\n{proc.stderr}")
    phase("flythrough", check=f"CLI --pool-frames {POOL_CLI_F} --frames "
          f"{POOL_CLI_F} {WIDTH}x{HEIGHT}", rc=proc.returncode,
          timing=repr([ln for ln in proc.stderr.splitlines()
                       if "frame(s) on" in ln][-1]))
    cornell_path = os.path.join(WORK, "cornell.glb")
    if not os.path.exists(cornell_path):
        make_cornell(cornell_path)
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s",
         cornell_path, "-x", "64", "-y", "64", "-v", "-o",
         os.path.join(WORK, "cli_validation.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "validated" in proc.stderr
          and "render validation passed" in proc.stderr,
          f"CLI -v: rc {proc.returncode}\n{proc.stderr}")
    phase("flythrough", check="CLI -v", rc=proc.returncode,
          validation=repr([ln for ln in proc.stderr.splitlines()
                           if "valid" in ln]))
    del pipe, scene
    torch.cuda.empty_cache()
    phase("phase", name="fly-through path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 7. instanced kernels vs plain versions ------------------------------
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

    # -- 8. instanced main path ----------------------------------------------
    t0 = time.perf_counter()
    _, rays = ipipe.render(cam0, 0, present_order=False)
    check(int(rays) == n_pix + ilive1,
          f"instanced frame 0 traced {int(rays)} rays, expected {n_pix} + "
          f"{ilive1}")
    inst_launches, inst_rays = main_path(ipipe, "instanced", only(
        pair_closest_hit=4, pair_any_hit=4))
    small_frame(iscene, "instanced")
    small_group(iscene, "instanced", POOL_INST_W, POOL_INST_H)
    phase("phase", name="instanced main path",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 9. skip and wide kernels vs plain versions --------------------------
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

    # The instanced atrium (phase 7's bake): the skip kernel with the
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

    # -- 10. --traversal main paths --------------------------------------------
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

    # -- 11. tier kernels vs plain versions ----------------------------------
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
        suffix = st._launch_name("", st.leaf_table(scene, coef))
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

    # -- 12. tier main paths -------------------------------------------------
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
          tiers=repr(want), timing=repr([ln for ln in proc.stderr.splitlines()
                                         if "frame(s) on" in ln][-1]))
    phase("phase", name="tier main paths",
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 13. dynamic geometry --------------------------------------------------
    # Pre-splitting, the animated flat atrium (rebake, refit, every table
    # regenerated) and the deforming device rebuild, each rendered at
    # 1080p through the kernels; the kernels on the new tables held to
    # their plain versions.
    t0 = time.perf_counter()
    from vulkan_pathtracer_tpu_torch.app import dynamic
    from vulkan_pathtracer_tpu_torch.models.animation import (
        build_animated_scene,
    )
    from vulkan_pathtracer_tpu_torch.models.device_scene import (
        apply_slot_map,
        bvh_with_leaf_blocks,
    )
    from vulkan_pathtracer_tpu_torch.ops.device_build import (
        device_rebuild_scene,
    )
    from vulkan_pathtracer_tpu_torch.ops import intersect
    from vulkan_pathtracer_tpu_torch.ops.refit import tree_violations

    dyn_launches = {k: 0 for k in st.LAUNCHES}

    def count(launched):
        for k, v in launched.items():
            dyn_launches[k] += v

    def physical(scene_, hit):
        """(N, 2) primitive and local id of each hit's triangle: a
        pre-split or rebuilt bake numbers its slots otherwise."""
        ids = scene_.tri_attr[hit.tri.clamp(min=0), 31:33].contiguous()
        return ids.view(torch.int32)

    def hit_differences(label, scene_, o, d, t_a, ids_a, t_b, ids_b):
        """Where two walks over the same triangles of ``scene_`` part on
        rays (o, d): (ties, box-face misses).  A tie is another physical
        triangle at the same t.  Every other ray whose t differs is a
        box-face miss: brute force over every triangle must find the
        nearer of the two t exactly.  Fails on any ray brute force does
        not confirm and on more than FACE_MISS_SHARE of the rays."""
        both = (t_a < MISS_T) & (t_b < MISS_T)
        tie = both & (ids_a != ids_b).any(1) & (t_a == t_b)
        rest = torch.nonzero(t_a != t_b).squeeze(1)
        if rest.numel():
            brute = intersect.brute_force_closest_hit(
                scene_, o[rest], d[rest], chunk=1 << 16)
            near = torch.minimum(t_a[rest], t_b[rest])
            bad = int((brute.t != near).sum())
            check(bad == 0, f"{label}: {bad} rays whose nearer hit brute "
                  f"force does not confirm")
        check(rest.numel() <= FACE_MISS_SHARE * o.shape[0],
              f"{label}: {rest.numel()} box-face misses in {o.shape[0]} "
              f"rays")
        return int(tie.sum()), int(rest.numel())

    def orbit_rays(f):
        """Primaries of main_path's camera f (frame f + 1)."""
        cam = Camera(aspect_ratio=config.aspect_ratio)
        orbit_path(radius=4.5, height=2.2, duration=4.0,
                   center=(0.0, 1.2, 0.0)).apply(cam, float(f))
        pos, hor, ver, fwd = pl.camera_tensors(cam, dev)
        o, d, _, _, _ = pl.primary_rays(pos, hor, ver, fwd, f + 1, WIDTH,
                                        HEIGHT)
        return o, d

    def host_sah_hits(scene_, o, d):
        """Closest hits (the quad kernel) over a fresh host SAH bake of
        the scene's triangles (the slots its leaves fill), with the
        physical ids of their triangles."""
        block = scene_.max_leaf_size
        n = scene_.tree.block_count.shape[0] * block
        real = (torch.arange(block, device=dev)[None, :]
                < scene_.tree.block_count[:, None]).reshape(-1)
        slots = torch.nonzero(real).squeeze(1)
        tri = [a[:n][slots].cpu().numpy() for a in (
            scene_.tri_v0, scene_.tri_e1, scene_.tri_e2)]
        bvh, slot_map = bvh_with_leaf_blocks(*tri, block)
        flat = np.concatenate([apply_slot_map(a, slot_map) for a in tri],
                              axis=1)
        n_blocks = int(bvh.leaf_first.max()) // block + 1
        leaves = flat[:n_blocks * block].reshape(n_blocks, block, 9)
        box, link, _ = st.build_quad_tables(bvh, block)
        tabs = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (box, link, leaves)]
        hit = st.Hit(*kernels.quad_closest_hit(
            *tabs, o, d, st.lane_limits(o.shape[0], None, dev)))
        sm = torch.from_numpy(slot_map).to(dev)
        src = slots[sm.clamp(min=0)][hit.tri.clamp(min=0)]
        ids = scene_.tri_attr[src, 31:33].contiguous().view(torch.int32)
        return hit, ids

    def full_size_checks(label, scene_, skip=False):
        """The quad closest and any hit on all 2,073,600 primaries of
        camera 0 bitwise their plain versions (and the skip kernel's);
        the tables hold their triangles and children; the closest t
        equal to a fresh host SAH bake's of the same triangles but for
        ties of equal t.  Launches here are outside the counted main
        paths."""
        o, d = orbit_rays(0)
        args = quad_args(scene_, o, d, None)
        p = compare_bitwise(f"{label}/quad", kernels.quad_closest_hit,
                            st.quad_closest_hit_plain, args)
        k_any = kernels.quad_any_hit(*args)
        sync()
        check(torch.equal(k_any, st.quad_any_hit_plain(*args)),
              f"{label}: quad any hit != plain version")
        check(torch.equal(k_any, p.t < MISS_T),
              f"{label}: any hit != closest.t < MISS_T")
        if skip:
            compare_bitwise(f"{label}/skip", kernels.skip_closest_hit,
                            sk.skip_closest_hit_plain,
                            sk.skip_args(scene_, o, d, None))
        tri_out, child_out = tree_violations(scene_)
        check(tri_out == 0 and child_out == 0, f"{label}: {tri_out} "
              f"triangles outside their leaf box, {child_out} child boxes "
              f"outside their parent's")
        fresh, ids = host_sah_hits(scene_, o, d)
        ties, misses = hit_differences(f"{label} vs a fresh SAH bake",
                                       scene_, o, d, fresh.t, ids, p.t,
                                       physical(scene_, p))
        phase("dynamic", check=f"{label} full-size", rays=o.shape[0],
              hits=int((p.t < MISS_T).sum()), bit_equal=True,
              vs_host_bake_ties=ties, vs_host_bake_face_misses=misses,
              tree_violations=(tri_out, child_out))

    # The animated flat atrium: 32 instances, leaf 28, coefficient rows.
    host = gltf.load(atrium_path)
    t1 = time.perf_counter()
    anim = build_animated_scene(host, max_leaf_size=28, device=dev, mt="mxu")
    sync()
    phase("dynamic", check="AnimatedScene bake",
          seconds=f"{time.perf_counter() - t1:.2f}",
          instances=anim.num_instances, triangles=anim.base.num_triangles)
    check(anim.num_instances == 32 and
          anim.base.num_triangles == ATRIUM_TRIS, "animated atrium size")

    # (i) Pre-splitting: the bake, 4 headline frames, the ties.
    t1 = time.perf_counter()
    spipe = load_pipeline(atrium_path, RenderConfig(**frame_kw, presplit=0.3),
                          dev)
    split = spipe.scene
    refs = int(split.tree.block_count.sum())
    phase("dynamic", check="pre-split bake (budget 0.3)",
          seconds=f"{time.perf_counter() - t1:.2f}", triangles=ATRIUM_TRIS,
          references=refs, leaves=split.leaves.shape[0],
          quad_rows=split.quad_box.shape[0], depth=split.bvh_depth)
    check(refs > ATRIUM_TRIS and split.max_leaf_size == 28,
          f"pre-split bake: {refs} references")
    launched, split_rays = main_path(spipe, "presplit", only(
        quad_closest_hit=4, quad_any_hit=4))
    count(launched)
    ties = misses = 0
    for f in range(4):
        o, d = orbit_rays(f)
        a = wf._closest_hit(anim.base, o, d, None)
        b = wf._closest_hit(split, o, d, None)
        dn, dm = hit_differences(f"pre-split frame {f}", anim.base, o, d,
                                 a.t, physical(anim.base, a), b.t,
                                 physical(split, b))
        ties, misses = ties + dn, misses + dm
    check(abs(split_rays - flat_rays) <= ties + misses,
          f"pre-split: {split_rays} rays in 4 frames, unsplit {flat_rays}, "
          f"{ties} primaries tied, {misses} box-face misses")
    phase("dynamic", check="pre-split rays vs unsplit", rays=split_rays,
          unsplit_rays=flat_rays, ties=ties, face_misses=misses)
    _, _, launched = small_frame(split, "presplit", exact=True)
    count(launched)
    del spipe, split

    # (ii) The animated refit: 8 frames at t = 4 f / 8 on the orbit, each
    # rebake + refit + regeneration and a 1080p render, timed per step.
    base_tf = anim.initial_transforms(host)
    ext = dynamic.largest_extent(anim.base)
    timer = dynamic.StepTimer(dev)
    apipe_ = pl.RenderPipeline(anim.base, RenderConfig(**frame_kw))
    orbit = orbit_path(radius=4.5, height=2.2, duration=4.0,
                       center=(0.0, 1.2, 0.0))
    cam = Camera(aspect_ratio=config.aspect_ratio)

    def dynamic_frame(pipe_, f, t, make):
        """make(t) gives the frame's scene, timed by ``timer``; then the
        1080p render between CUDA events.  (steps ms, rays)."""
        orbit.apply(cam, t)
        pipe_.scene = make(t)
        steps = timer.ms()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        image, rays = pipe_.render(cam, f, present_order=False)
        end.record()
        rays = int(rays)
        steps["render"] = start.elapsed_time(end)
        check(bool(torch.isfinite(image).all()), "dynamic frame: non-finite")
        return steps, rays

    def moved_at(t):
        timer.start()
        return anim.with_transforms(dynamic.bob_transforms(base_tf, ext, t),
                                    on_step=timer.mark)

    dynamic_frame(apipe_, 0, 0.0, moved_at)   # warm-up
    for key in st.LAUNCHES:
        st.LAUNCHES[key] = 0
    walls, per, anim_rays = [], {}, 0
    for f in range(8):
        t = 4.0 * f / 8
        sync()
        t1 = time.perf_counter()
        steps, rays = dynamic_frame(apipe_, f + 1, t, moved_at)
        walls.append(1e3 * (time.perf_counter() - t1))
        anim_rays += rays
        for k, v in steps.items():
            per.setdefault(k, []).append(v)
        phase("dynamic", frame=f, t=t, rays=rays,
              wall_ms=f"{walls[-1]:.3f}",
              **{f"{k}_ms": f"{v:.3f}" for k, v in steps.items()})
    launched = dict(st.LAUNCHES)
    check(launched == only(quad_closest_hit=8, quad_any_hit=8),
          f"animated frames: launches {launched}")
    count(launched)
    phase("dynamic", path="animated refit 8 frames",
          ms_per_frame=f"{sum(walls) / 8:.3f}",
          mrays_per_s=f"{anim_rays / sum(walls) / 1e3:.3f}",
          rays=anim_rays, launches=launched, card=repr(card),
          **{f"{k}_ms_median": f"{sorted(v)[len(v) // 2]:.3f}"
             for k, v in per.items()})
    moved = apipe_.scene   # the pose at t = 3.5
    full_size_checks("refit", moved, skip=True)
    fresh_coefs = mxu_mt.build_mt_coef_rows(moved.leaves.cpu().numpy())
    check(np.array_equal(moved.tri_coefs.cpu().numpy().view(np.uint32),
                         fresh_coefs.view(np.uint32)),
          "refit: tri_coefs differ from a fresh bake of the moved leaves")
    check(not torch.equal(moved.tri_coefs, anim.base.tri_coefs),
          "refit: tri_coefs equal the unmoved table")
    phase("dynamic", check="refit tri_coefs bitwise a fresh bake",
          rows=moved.tri_coefs.shape[0], differ_from_unmoved=True)
    for label, traversal, kw in (
            ("refit-a-oct", "auto", dict(kernel_primary="oct")),
            ("refit-b-frontier-coef", "auto", dict(
                kernel_primary="frontier", anyhit_kernel="frontier",
                mt="mxu")),
            ("refit-d-quad-coef", "auto", dict(mt="mxu")),
            ("refit-packet", "pallas_packet", {})):
        _, _, launched = small_frame(moved, label, traversal, exact=True,
                                     **kw)
        count(launched)
    del apipe_, moved, anim

    # (iii) The deforming rebuild at phases 0 and 1: the twisted atrium
    # rebuilt on the card, each step timed, and a 1080p render.
    template = build_device_scene(host, max_leaf_size=28, device=dev,
                                  build_bvh=False)
    rpipe = pl.RenderPipeline(template, RenderConfig(**frame_kw))
    for key in st.LAUNCHES:
        st.LAUNCHES[key] = 0
    rebuilt = {}
    for ph in (0.0, 1.0):
        def rebuild_at(t, ph=ph):
            return dynamic.rebuild_frame(template, ph, timer, coefs=True)
        steps, rays = dynamic_frame(rpipe, 1, 0.0, rebuild_at)
        rebuilt[ph] = rpipe.scene
        phase("dynamic", path=f"rebuild phase {ph}", rays=rays,
              depth_bound=rpipe.scene.bvh_depth, card=repr(card),
              **{f"{k}_ms": f"{v:.3f}" for k, v in steps.items()})
    launched = dict(st.LAUNCHES)
    check(launched == only(quad_closest_hit=2, quad_any_hit=2),
          f"rebuild frames: launches {launched}")
    count(launched)
    # The same rebuild on the CPU from the card's twisted triangles.
    v0, e1, e2, gn = dynamic.twist(template.tri_v0, template.tri_e1,
                                   template.tri_e2, 1.0)
    ctemplate = build_device_scene(host, max_leaf_size=28, device="cpu",
                                   build_bvh=False)
    cpu = device_rebuild_scene(ctemplate, v0.cpu(), e1.cpu(), e2.cpu(),
                               gn.cpu(), template.tri_attr.cpu(), coefs=True)
    card_r = rebuilt[1.0]
    check(all(
        torch.equal(getattr(card_r.tree, f).cpu(), getattr(cpu.tree, f))
        for f in ("left", "right", "leaf_first", "leaf_count", "perm",
                  "pair_src", "quad_src", "block_count")) and all(
        torch.equal(getattr(card_r, f).cpu().view(torch.int32),
                    getattr(cpu, f).view(torch.int32))
        for f in ("tri_v0", "tri_e1", "tri_e2", "leaves", "pair_box",
                  "quad_box", "skip_nodes", "tri_coefs", "root_lo"))
        and torch.equal(card_r.quad_link.cpu(), cpu.quad_link)
        and torch.equal(card_r.pair_link.cpu(), cpu.pair_link),
        "rebuild: the card's tree differs from the CPU's")
    phase("dynamic", check="rebuild on the card == rebuild on the CPU",
          bitwise=True, nodes=card_r.tree.left.shape[0])
    check(card_r.oct_box is None and card_r.frontier_box is None
          and card_r.wide_nodes is None, "rebuild: stale tables kept")
    full_size_checks("rebuild", card_r)
    for label, kw, want in (
            ("rebuild-oct-falls-to-pair", dict(kernel_primary="oct"),
             dict(pair_closest_hit=1, quad_any_hit=1)),
            ("rebuild-frontier-falls-through", dict(
                kernel_primary="frontier", anyhit_kernel="frontier"),
             dict(pair_closest_hit=1, quad_any_hit=1)),
            ("rebuild-quad-coef", dict(mt="mxu"),
             dict(quad_closest_hit_coef=1, quad_any_hit_coef=1))):
        _, _, launched = small_frame(card_r, label, exact=True, **kw)
        check(launched == want, f"{label}: launches {launched}")
        count(launched)
    del rpipe, rebuilt, card_r, cpu, template, ctemplate
    torch.cuda.empty_cache()
    for key, n in dyn_launches.items():
        results.setdefault(key, {})["launches_dynamic"] = n
    phase("phase", name="dynamic geometry", launches=dyn_launches,
          seconds=f"{time.perf_counter() - t0:.1f}")

    # -- 14. multi-device ------------------------------------------------------
    # (a)-(c) on the ranks of a real NCCL group, one card each (at most
    # 4); (d) the CLI, its processes started together.
    t0 = time.perf_counter()
    from vulkan_pathtracer_tpu_torch.parallel import distributed
    from vulkan_pathtracer_tpu_torch.utils import read_png

    torch.cuda.empty_cache()
    world = min(torch.cuda.device_count(), MD_MAX_RANKS)
    ranks = distributed.spawn(multidevice_rank, world, "cuda", atrium_path)
    md = ranks[0]
    phase("multidevice", ranks=world, backend=distributed.backend_for("cuda"),
          spawn_seconds=f"{time.perf_counter() - t0:.1f}")
    for key in ("tiles", "spp", "pooled", "split_tiles", "split_spp"):
        check(md[key]["bitwise"], f"multidevice {key}: image differs from "
              f"its single-device reference")
        check(md[key]["rays"] == md[key]["ref_rays"],
              f"multidevice {key}: rays {md[key]['rays']} vs "
              f"{md[key]['ref_rays']}")
    for rank, out in enumerate(ranks):
        for key in ("tiles", "spp", "pooled"):
            got = out[key]["launches"]
            check(set(got) == {"quad_closest_hit", "quad_any_hit"},
                  f"multidevice {key} rank {rank}: launches {got}")
    for key in ("tiles", "spp", "pooled", "split_tiles", "split_spp"):
        phase("multidevice", check=key, bitwise=True, rays=md[key]["rays"],
              launches=md[key].get("launches"),
              mean=f"{md[key]['mean']:.7f}")
    phase("multidevice", timing=f"{WIDTH}x{HEIGHT} frame, median of "
          f"{MD_REPS}", sharded_tiles_ms=f"{md['tiles']['ms']:.3f}",
          sharded_spp_ms=f"{md['spp']['ms']:.3f}",
          single_ms=f"{md['single_ms']:.3f}", ranks=world, card=repr(card))
    phase("multidevice", timing=f"{MD_POOL_F} cameras pooled, median of "
          f"{MD_POOL_REPS}", sharded_pooled_ms=f"{md['pooled']['ms']:.3f}",
          single_pooled_ms=f"{md['pooled_single_ms']:.3f}", ranks=world,
          card=repr(card))
    for key in ("quad_closest_hit", "quad_any_hit"):
        results[key]["launches_multidevice"] = {
            k: md[k]["launches"].get(key, 0) for k in ("tiles", "spp",
                                                        "pooled")}
    # (d) The CLI at 320x180: --devices <ranks> in tiles and spp (the
    # tiles PNG equals the single-device CLI's), and one rank more than
    # the host has cards, which must exit non-zero naming the count.
    cli = {}
    for label, extra in (
            ("single", []),
            ("tiles", ["--devices", str(world), "--shard-mode", "tiles"]),
            ("spp", ["--devices", str(world), "--shard-mode", "spp"]),
            ("refused", ["--devices", str(torch.cuda.device_count() + 1)])):
        png = os.path.join(WORK, f"cli_md_{label}.png")
        if os.path.exists(png):
            os.remove(png)
        cli[label] = (png, subprocess.Popen(
            [sys.executable, "-m", "vulkan_pathtracer_tpu_torch", "-s",
             atrium_path, "-x", str(SMALL_W), "-y", str(SMALL_H), "-o", png,
             *extra], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for label, (png, proc) in cli.items():
        _, err = proc.communicate(timeout=300)
        ok = proc.returncode == 0 and os.path.exists(png)
        if label == "refused":
            ok = (proc.returncode != 0 and not os.path.exists(png)
                  and f"{torch.cuda.device_count()} CUDA device(s)" in err)
        check(ok, f"CLI {label}: rc {proc.returncode}\n{err}")
        phase("multidevice", check=f"CLI {label}", rc=proc.returncode,
              line=repr([ln for ln in err.splitlines()
                         if "frame(s) on" in ln or "error" in ln][-1:]))
    check(np.array_equal(read_png(cli["tiles"][0]), read_png(cli["single"][0])),
          "CLI --devices tiles: PNG differs from the single-device CLI's")
    phase("phase", name="multi-device", ranks=world,
          seconds=f"{time.perf_counter() - t0:.1f}")

    chan_launches = channels_phase(cols_host, atrium_path, (
        flat_rays, *conv_figures))
    bf16_launches = bf16_phase(atrium_path, cols_path, cols_host)

    # -- 16. result -----------------------------------------------------------
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
                    "pair_closest_hit_coef", "pair_any_hit_coef")},
                **chan_launches, **bf16_launches}
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
