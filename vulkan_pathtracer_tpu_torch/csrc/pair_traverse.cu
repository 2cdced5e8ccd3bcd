// Pair-BVH (BVH2) stack traversal on Hopper: closest hit and any hit,
// flat or two-level (instanced), as instances of the stack walk of the
// quad kernels (stack_walk.cuh at width 2).
//
// Replaces the two Pallas TPU kernels of the instanced path:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_pair.py
//     _make_pair_kernel, launched by _pair_traverse via
//     pallas_pair_closest_hit;
//   - any hit: pallas_pair.py _make_pair_anyhit_kernel, launched by
//     _pair_anyhit via pallas_pair_any_hit;
//   - under VKPT_MT=mxu their inlined coefficient leaf test, flat and
//     two-level (mxu_mt.mt_coef_visit / mt_coef_visit_anyhit with the
//     instance feature transform; traverse.cuh coef_block).
// The plain PyTorch versions in ops/stack_traverse.py
// (pair_closest_hit_plain, pair_any_hit_plain) perform the same float
// operations in the same order (traverse.cuh: -fmad=false).
//
// Row layout: pair_box (Ni, 2, 6) f32 = 48 B (three float4), pair_link
// (Ni, 2) int32 = one int2.  A link >= 0 is a child row, -(v+1) a leaf
// with value v: a leaf block (flat) or inst << mb_bits | mesh block
// (instanced), whose triangle ids are v * block + k.
//
// What bounds it on this card: as for the quad kernels, dependent loads
// and idle lanes, not HBM bandwidth (the instanced atrium's tables,
// about 6 MB at leaf 14, sit in the 50 MB L2).  A BVH2 visit is one
// 56 B row and two slab tests, so a ray makes about twice as many
// dependent row loads as in a quad table, and the instanced atrium's
// per-material meshes overlap (606 pair rows and 51 leaf blocks per
// primary).  Two-level scenes add, at each leaf visit, a 64 B instance
// row and 33 operations of object-space ray transform (70 over A's 40
// non-zero entries for the coefficient leaves' feature transform).
//
// What the design does about it (measured on the instanced atrium's
// 2,073,600 primaries and its sorted bounce-1 launch against the first
// design, which tested each row's leaves at once, PERF.md section 6;
// the walk's choices in stack_walk.cuh):
//   - postponed leaves (while-while): the first design tested a row's
//     leaf children at once and ran its leaf tests at 20% (closest) and
//     7% (any) SIMT efficiency; postponed, 90%, although node steps fall
//     to 48% / 24%;
//   - the any hit refills lanes from the counter and queues the leaf
//     children of several nodes, up to 8 entries, before the warp's
//     leaf tests: fewer, fuller leaf phases (node SIMT 0.24 -> 0.46);
//     it walks in slot order, as its plain version does (the bit does
//     not depend on the order);
//   - every lane keeps its last instance's object-space ray (features),
//     which half the leaf visits reuse;
//   - both closest hits take the early-exit triangle test and the
//     plain grid; register caps by __launch_bounds__: 6 blocks per SM
//     (at most 85 registers) for the exact kernels, 8 (64) for the
//     coefficient ones;
//   - coefficient leaves (traverse.cuh coef_block: zero-free 80 B rows,
//     the early-exit test; PR 9, 20 candidates per kernel timed side by
//     side): the closest hit's warp starts its leaf phase once 16 lanes
//     wait and issues a triangle's five row loads before its first
//     test (20.3 -> 16.5 ms against the parent's walk on the same
//     rows), the any hit queues 8 leaves (14.1 -> 12.2 ms).
// Each ray's sequence of leaf tests is that of the plain versions: the
// closest hit tests a row's leaf children nearer-first (postponed
// leaves keep that order, so ties at equal t resolve as before).

#include <type_traits>

#include "stack_walk.cuh"

namespace {

// Design<sort (any hit), postpone, persistent, min blocks per SM,
// refill, early-exit triangle test, leaf queue, leaf phase at, row loads
// ahead>; every design keeps the lane's last instance (stack_walk.cuh).
using PairClosestDesign = Design<true, true, false, 6, false, true>;
using PairAnyDesign = Design<false, true, true, 6, true, false, 8>;
using CoefPairClosestDesign =
    Design<true, true, false, 8, false, true, 0, 16, true>;
using CoefPairAnyDesign = Design<false, true, true, 8, true, true, 8>;

template <bool ANY, bool COEF>
using PairDesign =
    std::conditional_t<ANY,
                       std::conditional_t<COEF, CoefPairAnyDesign,
                                          PairAnyDesign>,
                       std::conditional_t<COEF, CoefPairClosestDesign,
                                          PairClosestDesign>>;

// The instantiation for the tables: flat or two-level, exact or
// coefficient leaves.
template <bool ANY, bool STATS = false>
int pair_launch(const Tables& tab, int coef, const float* origin,
                const float* direction, const float* t_lane, int64_t n,
                float* t_out, int* tri_out, float* u_out, float* v_out,
                uint8_t* hit_out, unsigned* batches, unsigned long long* st,
                void* stream) {
  using Exact = PairDesign<ANY, false>;
  using Coef = PairDesign<ANY, true>;
  using Bf = Bf16<Coef>;
  const bool inst = tab.inst_inv != nullptr;
  const auto run =
      coef == 2 ? (inst ? launch<2, ANY, true, true, Bf, STATS>
                        : launch<2, ANY, true, false, Bf, STATS>)
      : coef    ? (inst ? launch<2, ANY, true, true, Coef, STATS>
                        : launch<2, ANY, true, false, Coef, STATS>)
                : (inst ? launch<2, ANY, false, true, Exact, STATS>
                        : launch<2, ANY, false, false, Exact, STATS>);
  return run(tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
             hit_out, batches, st, stream);
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  inst_inv == nullptr selects the
// flat variant; coef 1 the coefficient leaves (`leaves` is then the
// (n_leaves, block, 20) zero-free f32 table, and a two-level scene
// passes inst_feat (I, 40)), coef 2 their bf16 product (the same rows
// in bf16; stack_walk.cuh Bf16).
// `batches`: one unsigned counter for the persistent warps, zeroed by
// the launcher on `stream`.
extern "C" int vkpt_pair_closest_hit(const float* box, const int* link,
                                     const float* leaves, int block, int coef,
                                     const float* inst_inv,
                                     const float* inst_feat, int mb_bits,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, unsigned* batches,
                                     void* stream) {
  const Tables tab{box, link, leaves, block, inst_inv, inst_feat, mb_bits};
  return pair_launch<false>(tab, coef, origin, direction, t_lane, n, t_out,
                            tri_out, u_out, v_out, nullptr, batches, nullptr,
                            stream);
}

extern "C" int vkpt_pair_any_hit(const float* box, const int* link,
                                 const float* leaves, int block, int coef,
                                 const float* inst_inv,
                                 const float* inst_feat, int mb_bits,
                                 const float* origin, const float* direction,
                                 const float* t_lane, int64_t n,
                                 uint8_t* hit_out, unsigned* batches,
                                 void* stream) {
  const Tables tab{box, link, leaves, block, inst_inv, inst_feat, mb_bits};
  return pair_launch<true>(tab, coef, origin, direction, t_lane, n, nullptr,
                           nullptr, nullptr, nullptr, hit_out, batches,
                           nullptr, stream);
}

// The statistics build of the pair kernels (the designs above, flat or
// two-level, exact or, coef != 0, coefficient leaves with inst_feat on a
// two-level scene); `st` holds kStCount zeroed counters.  The hit
// outputs are those of the production kernels.
extern "C" int vkpt_pair_stats(int any, const float* box, const int* link,
                               const float* leaves, int block, int coef,
                               const float* inst_inv,
                               const float* inst_feat, int mb_bits,
                               const float* origin,
                               const float* direction, const float* t_lane,
                               int64_t n, float* t_out, int* tri_out,
                               float* u_out, float* v_out, uint8_t* hit_out,
                               unsigned long long* st, unsigned* batches,
                               void* stream) {
  const Tables tab{box, link, leaves, block, inst_inv, inst_feat, mb_bits};
  return (any ? pair_launch<true, true> : pair_launch<false, true>)(
      tab, coef, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
      hit_out, batches, st, stream);
}

// The channel build of the closest hit (stack_walk.cuh Chan), flat or
// two-level, exact or coefficient leaves: t_near and the seed (t, tri,
// u, v) per ray, each pointer may be null (t_near 0, no seed).
extern "C" int vkpt_pair_closest_hit_chan(
    const float* box, const int* link, const float* leaves, int block,
    int coef, const float* inst_inv, const float* inst_feat, int mb_bits,
    const float* origin, const float* direction, const float* t_lane,
    VKPT_CHANNEL_PARAMS, int64_t n, float* t_out, int* tri_out,
    float* u_out, float* v_out, unsigned* batches, void* stream) {
  const Tables tab{box, link, leaves, block, inst_inv, inst_feat, mb_bits};
  using Exact = PairDesign<false, false>;
  using Coef = PairDesign<false, true>;
  using Bf = Bf16<Coef>;
  const bool inst = inst_inv != nullptr;
  const auto run = coef == 2 ? (inst ? launch_chan<2, true, true, Bf>
                                     : launch_chan<2, true, false, Bf>)
                   : coef    ? (inst ? launch_chan<2, true, true, Coef>
                                     : launch_chan<2, true, false, Coef>)
                             : (inst ? launch_chan<2, false, true, Exact>
                                     : launch_chan<2, false, false, Exact>);
  return run(tab, VKPT_CHANNELS, origin, direction, t_lane, n, t_out,
             tri_out, u_out, v_out, batches, stream);
}
