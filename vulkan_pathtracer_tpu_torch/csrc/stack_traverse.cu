// Quad- and oct-BVH stack traversal on Hopper: closest hit and any hit.
//
// Replaces the Pallas TPU kernels of the n-ary stack tier:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_pair.py
//     _make_nary_kernel, launched by _nary_traverse via
//     pallas_quad_closest_hit (width 4) and pallas_oct_closest_hit
//     (width 8, exact leaves only, as JAX's oct launcher passes the
//     exact tri_blocks even under VKPT_MT=mxu);
//   - any hit: pallas_pair.py _make_nary_anyhit_kernel (width 4),
//     launched by _nary_anyhit via pallas_quad_any_hit;
//   - under VKPT_MT=mxu the quad kernels' inlined coefficient leaf test
//     (mxu_mt.mt_coef_visit / mt_coef_visit_anyhit; traverse.cuh
//     coef_block), f32 or the one-pass bf16 product
//     (VKPT_MXU_PRECISION=default; stack_walk.cuh Bf16).
// The plain PyTorch versions in ops/stack_traverse.py perform the same
// float operations in the same order (traverse.cuh: -fmad=false).
//
// What bounded the first, simple design of these kernels on this card
// (a thread per ray over a grid of the rays, near-first any hit, each
// node's leaves tested at once; measured with the statistics build
// below, PERF.md section 6) was not the stack, which stays
// shallow (4 entries on average, deepest 10 on the primaries and 15 on
// bounce 1 of 288), nor HBM (the atrium's tables, about 10 MB, sit in
// the 50 MB L2), but idle lanes.  On the
// incoherent bounce-1 rays of the any hit only 23% of a warp's lanes
// were active when it tested leaves (62% in node steps), because each
// lane tested its node's leaf children at once, while the others
// waited, and a warp ran 1.6x the node steps of its average ray.
//
// What the design does about it (stack_walk.cuh; each choice measured
// at the headline's shapes, PERF.md section 6):
//   - postponed leaves (Aila and Laine, "Understanding the Efficiency
//     of Ray Traversal on GPUs", HPG 2009, while-while): lanes step
//     through nodes until every unfinished lane holds the leaf children
//     of its last node, then the warp tests leaves together; each ray's
//     own sequence of node and leaf visits is unchanged (closest hit:
//     visit order, ties and results as before);
//   - persistent warps: a grid that fills the SMs once, each warp taking
//     32-ray batches from a counter that the wrapper zeroes (closest
//     hit), so a warp's tail does not hold a block's slot;
//   - the any hit refills: a lane whose ray is done stores it and takes
//     the next ray from the counter before the warp's next node phase,
//     so no lane idles behind the warp's longest ray (on tile-ordered
//     primaries that breaks the warps' coherence, so the closest hit
//     keeps its batches);
//   - the any hit walks hit children in slot order with a stack of node
//     ids alone: its bit does not depend on the order, and with the
//     fixed limit t_lane no popped node is ever culled;
//   - the closest hits' triangle test returns at the first failed test
//     (back face, u, v) before the division (traverse.cuh mt, EARLY);
//   - register caps through __launch_bounds__: 85 per thread for the
//     closest hit, 64 for the any hit (more warps in flight to hide
//     the L1/L2 latency of the leaf loads).
// Kept from the simple design: one ray per thread (Hopper has a program
// counter per thread, so no packet-shared stack as on the TPU), read-only
// __ldg vector loads of node rows and leaf blocks, rays that the caller sorts
// (2D tiles for primaries, the 6d Morton key for bounce rays).  Measured
// and not taken: a shared-memory window of the stack, refilling the
// closest hit (even from warp-owned chunks of consecutive rays), and
// prefetching the next four triangles (register spills).
// The coefficient builds (traverse.cuh coef_block: zero-free 80 B rows,
// the early-exit test) take the same walk, chosen among 22 candidates
// per kernel timed side by side (PERF.md section 6, PR 9): the closest
// hit issues a triangle's five row loads before its first test (1.48 ->
// 1.38 ms) and keeps persistent warps without a register cap; the any
// hit refills lanes and queues up to 6 leaves across nodes (2.83 ->
// 1.87 ms), each load issued before the sum that reads it.
// The oct kernel (width 8: three binary levels per row) keeps the
// simple design with the early-exit test: postponing its leaves or
// making its warps persistent made it slower (5.5-6.2 ms against 3.7 ms
// on the headline primaries).

#include "stack_walk.cuh"

namespace {

// Design<sort (any hit), postpone, persistent, min blocks per SM,
// refill, early-exit triangle test, leaf queue, leaf phase at, row loads
// ahead>.
using QuadClosestDesign = Design<true, true, true, 6, false, true>;
using QuadAnyDesign = Design<false, true, true, 8, true, false>;
using OctDesign = Design<true, false, false, 1, false, true>;
using CoefClosestDesign = Design<true, true, true, 1, false, true, 0, 0, true>;
using CoefAnyDesign = Design<false, true, true, 1, true, true, 6>;
// The bf16 product's builds (stack_walk.cuh Bf16) take the f32 builds'
// walks unchanged.
using BfClosestDesign = Bf16<CoefClosestDesign>;
using BfAnyDesign = Bf16<CoefAnyDesign>;

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  coef 1: `leaves` is the
// (n_leaves, block, 20) zero-free f32 coefficient table; coef 2: the
// same rows in bf16 (the one-pass product).  `batches`: one unsigned
// counter for the persistent warps, zeroed by the launcher on
// `stream`.
extern "C" int vkpt_quad_closest_hit(const float* box, const int* link,
                                     const float* leaves, int block, int coef,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, unsigned* batches,
                                     void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return (coef == 2 ? launch<4, false, true, false, BfClosestDesign>
          : coef    ? launch<4, false, true, false, CoefClosestDesign>
                    : launch<4, false, false, false, QuadClosestDesign>)(
      tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
      nullptr, batches, nullptr, stream);
}

extern "C" int vkpt_oct_closest_hit(const float* box, const int* link,
                                    const float* leaves, int block,
                                    const float* origin,
                                    const float* direction,
                                    const float* t_lane, int64_t n,
                                    float* t_out, int* tri_out, float* u_out,
                                    float* v_out, unsigned* batches,
                                    void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return launch<8, false, false, false, OctDesign>(
      tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
      nullptr, batches, nullptr, stream);
}

extern "C" int vkpt_quad_any_hit(const float* box, const int* link,
                                 const float* leaves, int block, int coef,
                                 const float* origin, const float* direction,
                                 const float* t_lane, int64_t n,
                                 uint8_t* hit_out, unsigned* batches,
                                 void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return (coef == 2 ? launch<4, true, true, false, BfAnyDesign>
          : coef    ? launch<4, true, true, false, CoefAnyDesign>
                    : launch<4, true, false, false, QuadAnyDesign>)(
      tab, origin, direction, t_lane, n, nullptr, nullptr, nullptr, nullptr,
      hit_out, batches, nullptr, stream);
}

// The statistics build of the quad kernels (the designs above, exact
// or, coef 1 and 2, coefficient leaves); `st` holds kStCount zeroed
// counters.  The hit outputs are those of the production kernels.
extern "C" int vkpt_quad_stats(int any, const float* box, const int* link,
                               const float* leaves, int block, int coef,
                               const float* origin, const float* direction,
                               const float* t_lane, int64_t n, float* t_out,
                               int* tri_out, float* u_out, float* v_out,
                               uint8_t* hit_out, unsigned long long* st,
                               unsigned* batches, void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  const auto run =
      any ? (coef == 2 ? launch<4, true, true, false, BfAnyDesign, true>
             : coef    ? launch<4, true, true, false, CoefAnyDesign, true>
                       : launch<4, true, false, false, QuadAnyDesign, true>)
          : (coef == 2
                 ? launch<4, false, true, false, BfClosestDesign, true>
             : coef ? launch<4, false, true, false, CoefClosestDesign, true>
                    : launch<4, false, false, false, QuadClosestDesign,
                             true>);
  return run(tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
             hit_out, batches, st, stream);
}

extern "C" int vkpt_stack_stats_count() { return kStCount; }

// The channel builds of the two closest hits (stack_walk.cuh Chan):
// t_near and the seed (t, tri, u, v) per ray, each pointer may be null
// (t_near 0, no seed).
extern "C" int vkpt_quad_closest_hit_chan(
    const float* box, const int* link, const float* leaves, int block,
    int coef, const float* origin, const float* direction,
    const float* t_lane, VKPT_CHANNEL_PARAMS, int64_t n, float* t_out,
    int* tri_out, float* u_out, float* v_out, unsigned* batches,
    void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return (coef == 2 ? launch_chan<4, true, false, BfClosestDesign>
          : coef    ? launch_chan<4, true, false, CoefClosestDesign>
                    : launch_chan<4, false, false, QuadClosestDesign>)(
      tab, VKPT_CHANNELS, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, batches, stream);
}

extern "C" int vkpt_oct_closest_hit_chan(
    const float* box, const int* link, const float* leaves, int block,
    const float* origin, const float* direction, const float* t_lane,
    VKPT_CHANNEL_PARAMS, int64_t n, float* t_out, int* tri_out,
    float* u_out, float* v_out, unsigned* batches, void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return launch_chan<8, false, false, OctDesign>(
      tab, VKPT_CHANNELS, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, batches, stream);
}
