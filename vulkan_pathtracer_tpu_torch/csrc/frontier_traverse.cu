// Frontier (16- or 32-wide BVH) stack traversal on Hopper: closest hit
// and any hit.
//
// Replaces the two Pallas TPU kernels of the frontier tier:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_frontier.py
//     _make_frontier_kernel, launched by _frontier_traverse via
//     pallas_frontier_closest_hit (VKPT_KERNEL_*=frontier);
//   - any hit: pallas_frontier.py _make_frontier_anyhit_kernel, launched
//     by _frontier_anyhit via pallas_frontier_any_hit
//     (VKPT_ANYHIT_KERNEL=frontier);
//   - their exact or coefficient leaf test (VKPT_MT=mxu; traverse.cuh).
// The plain PyTorch versions in ops/frontier.py perform the same float
// operations in the same order (traverse.cuh: -fmad=false).
//
// On the TPU a frontier visit tests the 16 child boxes of a collapsed
// node with one slab-coefficient matmul over a packet, whose product
// gives each plane as lo * ix + 1 * (-(ox * ix)): in f32 that is the
// stack kernels' slab() with o * inv hoisted, which these kernels run,
// per ray, on CUDA cores.  The boxes are the bake's guard-dilated
// ones (ops/frontier.py): the dilation, sized for a one-pass bf16
// product, only adds visits here; the hits equal the quad kernel's up
// to ties of equal t.
//
// The closest hit, in the order of the Pallas body: every slot is
// slab-tested against min(t_best, t_lane) at node entry; hit leaf
// slots are visited in slot order (pallas_frontier.py:471-499);
// internal children are sorted by entry distance with the Batcher
// network swapping on `<=` (:503-518, sortnet.cuh), pushed far to near,
// and the walk descends to the nearest (:520-541); a popped node is
// culled by its entry distance.  The network is not stable, so the
// plain version runs the same comparator list.  The any hit's bit does
// not depend on the walk's order, so it walks hit children in slot
// order, with no network and no stack of entry distances, as its plain
// version does (slot_order).  Both run on the stack walk of the quad
// and pair kernels (stack_walk.cuh at width 16 or 32, waiting leaves
// as (node, slot mask) entries, read from the link row when their test
// comes), with W - 1 stack entries per collapsed level (STACK_SLOTS in
// ops/stack_traverse; the bake refuses deeper trees).
//
// What bounded the first designs (one ray per thread, each node's
// leaves tested at once; PERF.md section 6): idle lanes (leaf SIMT
// efficiency 0.26-0.35 in the any hit's bounce-1 launch, 0.52-0.64 in
// the closest hit's primaries), the 63-comparator network at every
// node of the closest hit although three visited nodes in four hit at
// most one internal child, and a 2.9 KB local int + float stack per
// thread.  The kept designs (24 candidates for each leaf kind timed
// side by side with the first design):
//   - closest hit: the network only where two or more internal
//     children were hit (with one finite key every network puts it
//     first, so the order is the same); a lane holds one node's leaf
//     entry, since its leaf tests tighten the limit that the next
//     node's slabs and pop culling read;
//   - closest hit, exact leaves: the leaves tested at once (postponing
//     them measured no faster: 14 triangles with the early-exit test
//     are a short leaf phase), persistent warps, the early-exit
//     triangle test, a register cap of 5 blocks per SM;
//   - closest hit, coefficient leaves (the zero-free rows and early-exit
//     test of traverse.cuh coef_block, PR 9): postponed leaves (leaf
//     SIMT 0.64 -> 0.85), persistent warps, a triangle's five row loads
//     issued before its first test, a cap of 6;
//   - any hit: postponed leaves, a lane queueing the leaf children of
//     up to 4 nodes, until 8 leaves wait (leaf SIMT 0.94-0.96; 4 with
//     coefficient leaves), lanes refilled from the batch counter (node
//     SIMT 0.60); a cap of 6 (8 with coefficient leaves: 4.47 against
//     5.06 ms at 6, PR 9).

#include <type_traits>

#include "stack_walk.cuh"

namespace {

// The any hit: the stack walk of stack_walk.cuh at width 16 or 32
// (slot order, leaves as node entries).
// Design<sort (no), postpone, persistent, min blocks per SM, refill,
// early-exit triangle test, leaf queue>.
using FrontierAnyDesign = Design<false, true, true, 6, true, false, 8>;
using CoefFrontierAnyDesign = Design<false, true, true, 8, true, true, 4>;

template <int W, bool COEF, bool STATS = false>
int any_launch(const Tables& tab, const float* origin,
               const float* direction, const float* t_lane, int64_t n,
               uint8_t* hit_out, unsigned* batches, unsigned long long* st,
               void* stream) {
  using D = std::conditional_t<COEF, CoefFrontierAnyDesign, FrontierAnyDesign>;
  return launch<W, true, COEF, false, D, STATS>(
      tab, origin, direction, t_lane, n, nullptr, nullptr, nullptr, nullptr,
      hit_out, batches, st, stream);
}

template <bool STATS>
int any_dispatch(int width, int coef, const Tables& tab, const float* origin,
                 const float* direction, const float* t_lane, int64_t n,
                 uint8_t* hit_out, unsigned* batches, unsigned long long* st,
                 void* stream) {
  if (width != 16 && width != 32) return (int)cudaErrorInvalidValue;
  const auto run = width == 16 ? (coef ? any_launch<16, true, STATS>
                                       : any_launch<16, false, STATS>)
                               : (coef ? any_launch<32, true, STATS>
                                       : any_launch<32, false, STATS>);
  return run(tab, origin, direction, t_lane, n, hit_out, batches, st, stream);
}

// The closest hit: the stack walk at width 16 or 32 (near-first, the
// Batcher network where two or more internal children were hit, one
// leaf entry per lane).  Design<sort, postpone, persistent, min blocks
// per SM, refill, early-exit triangle test, leaf queue, leaf phase at,
// row loads ahead>.
using FrontierClosestDesign = Design<true, false, true, 5, false, true>;
using CoefFrontierClosestDesign =
    Design<true, true, true, 6, false, true, 0, 0, true>;

template <bool STATS>
int closest_dispatch(int width, int coef, const Tables& tab,
                     const float* origin, const float* direction,
                     const float* t_lane, int64_t n, float* t_out,
                     int* tri_out, float* u_out, float* v_out,
                     unsigned* batches, unsigned long long* st, void* stream) {
  if (width != 16 && width != 32) return (int)cudaErrorInvalidValue;
  using D = FrontierClosestDesign;
  using C = CoefFrontierClosestDesign;
  const auto run =
      width == 16
          ? (coef ? launch<16, false, true, false, C, STATS>
                  : launch<16, false, false, false, D, STATS>)
          : (coef ? launch<32, false, true, false, C, STATS>
                  : launch<32, false, false, false, D, STATS>);
  return run(tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
             nullptr, batches, st, stream);
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted; cudaErrorInvalidValue for a width
// other than 16 or 32).  coef != 0: `leaves` is the (n_leaves, block,
// 20) zero-free coefficient table.  `batches`: one unsigned counter for the
// persistent warps, zeroed by the launcher on `stream`.
extern "C" int vkpt_frontier_closest_hit(const float* box, const int* link,
                                         int width, const float* leaves,
                                         int block, int coef,
                                         const float* origin,
                                         const float* direction,
                                         const float* t_lane, int64_t n,
                                         float* t_out, int* tri_out,
                                         float* u_out, float* v_out,
                                         unsigned* batches, void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return closest_dispatch<false>(width, coef, tab, origin, direction, t_lane,
                                 n, t_out, tri_out, u_out, v_out, batches,
                                 nullptr, stream);
}

extern "C" int vkpt_frontier_any_hit(const float* box, const int* link,
                                     int width, const float* leaves,
                                     int block, int coef,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     uint8_t* hit_out, unsigned* batches,
                                     void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return any_dispatch<false>(width, coef, tab, origin, direction, t_lane, n,
                             hit_out, batches, nullptr, stream);
}

// The statistics build of the frontier kernels (the designs above; any:
// the any hit, else the closest hit); `st` holds kStCount zeroed
// counters.  The outputs are those of the production kernels; the any
// hit writes hit_out, the closest hit t_out .. v_out.
extern "C" int vkpt_frontier_stats(int any, const float* box,
                                   const int* link, int width,
                                   const float* leaves, int block, int coef,
                                   const float* origin,
                                   const float* direction,
                                   const float* t_lane, int64_t n,
                                   float* t_out, int* tri_out, float* u_out,
                                   float* v_out, uint8_t* hit_out,
                                   unsigned long long* st, unsigned* batches,
                                   void* stream) {
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  if (any)
    return any_dispatch<true>(width, coef, tab, origin, direction, t_lane, n,
                              hit_out, batches, st, stream);
  return closest_dispatch<true>(width, coef, tab, origin, direction, t_lane,
                                n, t_out, tri_out, u_out, v_out, batches, st,
                                stream);
}
