// Skip-pointer (stackless) closest hit on Hopper: the binary preorder
// walk and the 8-wide tile walk, one ray per thread.
//
// skip_closest_hit_kernel<INST, D> replaces the Pallas TPU kernels that
// return the closest hit of a skip-pointer walk over the same 8
// direction-octant preorders (vulkan_pathtracer_tpu/ops/pallas_traverse.py):
//   - kernel 5, _make_kernel (pallas_closest_hit, the packet cursor,
//     flat and instanced leaf decode);
//   - kernel 6, _make_pipe_kernel (VKPT_PIPE: two interleaved chains);
//   - kernel 7, _make_gmt_kernel / _make_gmt2_kernel (VKPT_GROUP_MT:
//     sublane-group MT);
//   - kernel 9, _make_dense_kernel (pallas_dense_closest_hit: 16 nodes
//     per VMEM row, the VMEM-overflow and instanced fallback).
// They differ only in TPU staging and scheduling; all use the slab
// b * inv - o * inv with o * inv hoisted (pallas_traverse.py:158-174).
// wide_closest_hit_kernel<D, STATS> replaces kernel 8, _make_wide_kernel
// (pallas_wide_closest_hit): 8-wide slot tiles (ops/bvh_wide.py), slab
// (b - o) * inv, slot hits against t_best as it was at node entry, leaf
// slots intersected in slot order, each masked by its own slot hit
// (pallas_traverse.py:1346-1423).
// The plain PyTorch versions (ops/skip_traverse.py) perform the same
// float operations in the same order (traverse.cuh: -fmad=false).
//
// Layouts: skip records (8*Nn, 8) f32 = 32 B, two float4: bmin.xyz
// bmax.x | bmax.yz, skip, leaf (skip and leaf int32 bits; skip is local
// to the octant block, leaf the block's first triangle or the packed
// inst << mb_bits | block, -1 inside).  Wide tiles (8*Nw, 8, 8) f32 =
// 256 B: per slot bmin.xyz bmax.x | bmax.yz, leafword, pad (leafword
// >= 0 a leaf's first triangle, -1 internal, -2 empty; slot 0's pad is
// the skip pointer), all f32 values.
//
// Differences from the TPU packet kernels: a thread's cursor descends
// on its own box test where a packet descends when any lane hits, and a
// leaf runs Möller–Trumbore only when its own box is hit (the packet
// kernels intersect every lane of a visited leaf); the closest hit is
// the same up to ties of equal t and slab-versus-MT rounding.
//
// What bounds the skip kernel on this card: idle lanes and dependent
// loads.  Every visit is a dependent 32 B record load whose address
// comes from the previous visit, a skip walk visits more nodes than a
// near-first stack walk (no culling by entry distance), and the
// instanced atrium's per-material meshes overlap: 1,220 record visits
// and 50 leaf blocks per primary.  The first design (one ray per thread,
// each lane testing its leaf as soon as it met one) ran its leaf tests
// at 17% SIMT efficiency on the instanced primaries and 6% on the
// incoherent bounce-1 rays (PERF.md section 6), so the bounce-1 launch
// took 2.6x the primaries' time.  The tables (about 5 MB of records,
// 14 MB of leaves at 1080p) sit in the 50 MB L2.
//
// What the design does about it (the stack kernels' warp loops through
// SkipWalk; 30 candidates timed side by side on both launches of a
// pallas_packet frame, PERF.md section 6):
//   - postponed leaves: a lane whose record is a hit leaf holds it and
//     takes no node step until the warp's leaf phase, so each ray still
//     tests its records and leaves in its own preorder, each record
//     against the t_best its plain version sees (ties resolve as
//     before); leaf SIMT 0.17 -> 0.90 (instanced primaries);
//   - two-level: the leaf phase starts once 16 lanes wait, not all of
//     them (node steps of the others are not held back as long), and
//     each lane keeps its last instance's object-space ray, as the pair
//     kernels do (recomputing it at every leaf visit measured no
//     faster beyond the spread of repeated runs);
//   - flat: persistent warps;
//   - the early-exit triangle test (traverse.cuh mt, EARLY) and a
//     register cap of 6 blocks per SM (85 registers).
//
// The wide kernel (WideWalk): no stack (one cursor), sixteen 16 B __ldg
// loads per tile, rays sorted by the caller (2D tiles, the 6d Morton
// key).  Its first design tested a tile's hit leaf slots as soon as a
// lane met them, at a leaf SIMT efficiency of 0.69 on the primaries and
// 0.15 on the incoherent bounce-1 rays, whose launch took 3.1x the
// primaries' time; a warp also ran 1.44x the tile steps of its average
// ray there.  The kept design (24 candidates timed side by side on both
// launches of a pallas8 frame, chosen by their sum, PERF.md section 6):
// postponed leaf slots with a leaf phase once 16 lanes wait (the lane
// keeps the tile and a slot mask, and reads the leaf words from the
// tile again), persistent warps, the early-exit triangle test and a cap
// of 6 blocks per SM.  Refill and unpostponed walks were slower on the
// sum.  What holds it now is not measured (no profiler of the card's
// counters); its reads from L2 are about 256 B per tile step and 1 KB
// per leaf block, 42 steps and 6.6 blocks per bounce-1 ray.

#include "stack_walk.cuh"

namespace {

__device__ __forceinline__ int octant_of(const Ray& r) {
  return (r.dx < 0.0f ? 1 : 0) | (r.dy < 0.0f ? 2 : 0) |
         (r.dz < 0.0f ? 4 : 0);
}

// Slab test with the XLA / wide-kernel arithmetic (b - o) * inv
// (pallas_traverse.py:1347-1362), the entry clamped to LO (kTmin, or a
// ChanRay's r.tn), defined for both ray types as traverse.cuh's slab.
#define VKPT_DEFINE_SLAB_SUB(R, LO)                                     \
  __device__ __forceinline__ bool slab_sub(const R& r, const float* c,  \
                                           float t_lim) {               \
    const float t0x = (c[0] - r.ox) * r.ix;                             \
    const float t1x = (c[3] - r.ox) * r.ix;                             \
    const float t0y = (c[1] - r.oy) * r.iy;                             \
    const float t1y = (c[4] - r.oy) * r.iy;                             \
    const float t0z = (c[2] - r.oz) * r.iz;                             \
    const float t1z = (c[5] - r.oz) * r.iz;                             \
    const float n = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),      \
                          fmaxf(fminf(t0z, t1z), LO));                  \
    const float f = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),      \
                          fminf(fmaxf(t0z, t1z), t_lim));               \
    return n <= f;                                                      \
  }
VKPT_DEFINE_SLAB_SUB(Ray, kTmin)
VKPT_DEFINE_SLAB_SUB(ChanRay, r.tn)
#undef VKPT_DEFINE_SLAB_SUB

// The skip walk of one ray, with the interface of the stack walk
// (stack_walk.cuh Walk), so that the warp loops, the launcher and the
// statistics build are the stack kernels': the cursor in the ray's
// octant preorder, and the leaf whose box it hit, waiting for the
// warp's leaf phase.  A waiting lane takes no node step, so each ray
// tests its records and leaves in exactly its own preorder, each record
// against the t_best its plain version sees.
template <bool INST, class D, bool STATS>
struct SkipWalk {
  using RayT = typename D::RayT;
  static_assert(D::kPostpone && !D::kRefill,
                "the skip walk postpones its leaves, without refill");
  const float4* __restrict__ nodes;  // all 8 octant blocks
  int n_nodes;
  LeafTest<false, false, INST, D, STATS> lt;
  const float4* rec;  // the ray's octant block
  int cur, pend, deepest;
  unsigned long long* st;  // STATS: the launch's counters

  __device__ __forceinline__ void start(const RayT& r, bool active) {
    cur = active ? 0 : -1;
    pend = -1;
    deepest = 0;  // no stack
    lt.reset();
    if (active) rec = nodes + (size_t)octant_of(r) * n_nodes * 2;
  }

  __device__ __forceinline__ bool pending() const { return pend >= 0; }

  __device__ __forceinline__ bool can_step() const {
    return cur >= 0 && pend < 0;
  }

  // A flat leaf value is its block's first triangle (row = leaf /
  // block), a two-level one the packed instance and block.
  __device__ __forceinline__ void visit(const RayT& r, int leaf, Best& b) {
    lt.visit(r, INST ? leaf : leaf / lt.block, b);
  }

  // Record `cur`: box hit -> cur + 1 (internal) or its leaf (held for
  // the leaf phase) and the skip pointer; missed -> skip.
  __device__ __forceinline__ bool node_step(const RayT& r, Best& b) {
    const float4 a = __ldg(rec + 2 * cur);
    const float4 c = __ldg(rec + 2 * cur + 1);
    const float box[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
    const int skip = __float_as_int(c.z);
    const int leaf = __float_as_int(c.w);
    float tn;
    const bool hit = slab(r, box, fminf(b.t, r.tl), tn);
    int next = skip;
    if (leaf < 0) {
      if (hit) next = cur + 1;
    } else if (hit) {
      pend = leaf;
    }
    cur = next < n_nodes ? next : -1;
    return false;
  }

  __device__ __forceinline__ bool visit_pending(const RayT& r, Best& b) {
    if (STATS) count_active(st, kStLeafWarps);
    visit(r, pend, b);
    pend = -1;
    return false;
  }
};

struct SkipTables {
  const float* nodes;
  int n_nodes;
  const float* leaves;
  int block;
  const float* inst_inv;  // INST: (I, 16)
  int mb_bits;
};

// The skip walk of a launch over `tab`, its counters `ST` (the two
// entry points below; a macro, as a shared function moved the default
// kernels' SASS).
#define VKPT_SKIP_WALK(ST)                                 \
  Wk w;                                                    \
  w.nodes = reinterpret_cast<const float4*>(tab.nodes);    \
  w.n_nodes = tab.n_nodes;                                 \
  w.lt.leaves = tab.leaves;                                \
  w.lt.block = tab.block;                                  \
  w.lt.inst_inv = tab.inst_inv;                            \
  w.lt.inst_feat = nullptr;                                \
  w.lt.mb_bits = tab.mb_bits;                              \
  w.lt.st = ST;                                            \
  w.st = ST

template <bool INST, class D, bool STATS>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
skip_closest_hit_kernel(const SkipTables tab,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_lane, int64_t n,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        unsigned* batches, unsigned long long* st) {
  using Wk = SkipWalk<INST, D, STATS>;
  VKPT_SKIP_WALK(st);
  run_rays<Wk, false, D, STATS>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, nullptr, batches, st);
}

// The skip walk's channel build (D = Chan<design>): each ray's window
// and seed from `ch`.
template <bool INST, class D>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
skip_chan_kernel(const SkipTables tab, const Channels ch,
                 const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_lane, int64_t n,
                 float* __restrict__ t_out, int* __restrict__ tri_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 unsigned* batches) {
  using Wk = SkipWalk<INST, D, false>;
  VKPT_SKIP_WALK(nullptr);
  run_rays<Wk, false, D, false>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, nullptr, batches,
                                nullptr, ch);
}
#undef VKPT_SKIP_WALK

template <bool INST, class D>
int skip_chan_launch(const SkipTables& tab, const Channels& ch,
                     const float* origin, const float* direction,
                     const float* t_lane, int64_t n, float* t_out,
                     int* tri_out, float* u_out, float* v_out,
                     unsigned* batches, void* stream) {
  using C = Chan<D>;
  return launch_kernel<skip_chan_kernel<INST, C>, C>(
      n, batches, stream, tab, ch, origin, direction, t_lane, n, t_out,
      tri_out, u_out, v_out, batches);
}

template <bool INST, class D, bool STATS = false>
int skip_launch(const SkipTables& tab, const float* origin,
                const float* direction, const float* t_lane, int64_t n,
                float* t_out, int* tri_out, float* u_out, float* v_out,
                unsigned* batches, unsigned long long* st, void* stream) {
  return launch_kernel<skip_closest_hit_kernel<INST, D, STATS>, D>(
      n, batches, stream, tab, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, batches, st);
}

// Design<sort (unused), postpone, persistent, min blocks per SM,
// refill, early-exit triangle test, queue (unused), leaf phase at>.
using SkipFlatDesign = Design<true, true, true, 6, false, true>;
using SkipInstDesign = Design<true, true, false, 6, false, true, 0, 16>;
using WideDesign = Design<true, true, true, 6, false, true, 0, 16>;

// The 8-wide tile walk of one ray, with the interface of the stack walk
// (stack_walk.cuh Walk): the cursor in the ray's octant preorder of
// tiles, and the hit leaf slots of its last tile (the tile and a slot
// mask) waiting for the warp's leaf phase.  Every slot of a tile is
// tested against t_best as it was at the tile's entry; a waiting lane
// takes no node step, so its leaf slots are tested in slot order, each
// against the tightening t_best, before its next tile's slabs, as in
// the plain version (pallas_traverse.py:1346-1427).  The leaf words
// stay f32 values (exact below 2^24) and are read again from the tile
// in the leaf phase.
template <class D, bool STATS>
struct WideWalk {
  using RayT = typename D::RayT;
  static_assert(D::kPostpone && !D::kRefill,
                "the wide walk postpones its leaves, without refill");
  const float4* __restrict__ tiles;  // all 8 octant blocks
  int n_wide;
  LeafTest<false, false, false, D, STATS> lt;
  const float4* base;  // the ray's octant block
  int cur, tile, deepest;
  unsigned mask;  // the hit leaf slots of tile `tile`
  unsigned long long* st;  // STATS: the launch's counters

  __device__ __forceinline__ void start(const RayT& r, bool active) {
    cur = active ? 0 : -1;
    mask = 0;
    deepest = 0;  // no stack
    lt.reset();
    if (active) base = tiles + (size_t)octant_of(r) * n_wide * 16;
  }

  __device__ __forceinline__ bool pending() const { return mask != 0; }

  __device__ __forceinline__ bool can_step() const {
    return cur >= 0 && mask == 0;
  }

  // Tile `cur`: the 8 slabs against min(t_best, t_lane) at entry, the
  // hit leaf slots held, then cur + 1 when an internal slot was hit,
  // else slot 0's skip pointer.
  __device__ __forceinline__ bool node_step(const RayT& r, Best& b) {
    const float4* t = base + (size_t)cur * 16;
    const float t_lim = fminf(b.t, r.tl);
    unsigned leaf_hits = 0;
    bool descend = false;
    int skip = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float4 lo = __ldg(t + 2 * s);
      const float4 hi = __ldg(t + 2 * s + 1);
      const float box[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
      const bool hit = slab_sub(r, box, t_lim);
      if (hit && hi.z >= 0.0f) leaf_hits |= 1u << s;
      if (hit && hi.z == -1.0f) descend = true;
      if (s == 0) skip = (int)hi.w;
    }
    if (leaf_hits != 0) {
      tile = cur;
      mask = leaf_hits;
    }
    const int next = descend ? cur + 1 : skip;
    cur = next < n_wide ? next : -1;
    return false;
  }

  // The waiting leaf slots in slot order; a leaf word is the block's
  // first triangle (row = word / block).
  __device__ __forceinline__ bool visit_pending(const RayT& r, Best& b) {
    if (STATS) count_active(st, kStLeafWarps);
    const float* slots =
        reinterpret_cast<const float*>(base + (size_t)tile * 16);
    for (unsigned m = mask; m != 0; m &= m - 1) {
      const int s = __ffs(m) - 1;
      lt.visit(r, (int)__ldg(slots + 8 * s + 6) / lt.block, b);
    }
    mask = 0;
    return false;
  }
};

// The wide walk of a launch, its counters `ST` (as VKPT_SKIP_WALK).
#define VKPT_WIDE_WALK(ST)                           \
  Wk w;                                              \
  w.tiles = reinterpret_cast<const float4*>(tiles);  \
  w.n_wide = n_wide;                                 \
  w.lt.leaves = leaves;                              \
  w.lt.block = block;                                \
  w.lt.inst_inv = nullptr;                           \
  w.lt.inst_feat = nullptr;                          \
  w.lt.mb_bits = 0;                                  \
  w.lt.st = ST;                                      \
  w.st = ST

template <class D, bool STATS>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
wide_closest_hit_kernel(const float* __restrict__ tiles, int n_wide,
                        const float* __restrict__ leaves, int block,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_lane, int64_t n,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        unsigned* batches, unsigned long long* st) {
  using Wk = WideWalk<D, STATS>;
  VKPT_WIDE_WALK(st);
  run_rays<Wk, false, D, STATS>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, nullptr, batches, st);
}

// The wide walk's channel build (D = Chan<design>).
template <class D>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
wide_chan_kernel(const float* __restrict__ tiles, int n_wide,
                 const float* __restrict__ leaves, int block,
                 const Channels ch, const float* __restrict__ origin,
                 const float* __restrict__ direction,
                 const float* __restrict__ t_lane, int64_t n,
                 float* __restrict__ t_out, int* __restrict__ tri_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 unsigned* batches) {
  using Wk = WideWalk<D, false>;
  VKPT_WIDE_WALK(nullptr);
  run_rays<Wk, false, D, false>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, nullptr, batches,
                                nullptr, ch);
}
#undef VKPT_WIDE_WALK

template <class D, bool STATS = false>
int wide_launch(const float* tiles, int n_wide, const float* leaves,
                int block, const float* origin, const float* direction,
                const float* t_lane, int64_t n, float* t_out, int* tri_out,
                float* u_out, float* v_out, unsigned* batches,
                unsigned long long* st, void* stream) {
  return launch_kernel<wide_closest_hit_kernel<D, STATS>, D>(
      n, batches, stream, tiles, n_wide, leaves, block, origin, direction,
      t_lane, n, t_out, tri_out, u_out, v_out, batches, st);
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  inst_inv == nullptr selects the
// flat skip kernel.  `batches`: one unsigned counter for persistent
// warps, zeroed by the launcher on `stream`.
extern "C" int vkpt_skip_closest_hit(const float* nodes, int n_nodes,
                                     const float* leaves, int block,
                                     const float* inst_inv, int mb_bits,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, unsigned* batches,
                                     void* stream) {
  const SkipTables tab{nodes, n_nodes, leaves, block, inst_inv, mb_bits};
  return (inst_inv != nullptr ? skip_launch<true, SkipInstDesign>
                              : skip_launch<false, SkipFlatDesign>)(
      tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
      batches, nullptr, stream);
}

// The statistics build of the skip kernel (the designs above, flat or
// two-level; any must be 0: a closest hit); `st` holds kStCount zeroed
// counters.  The hit outputs are those of the production kernels.
extern "C" int vkpt_skip_stats(int any, const float* nodes, int n_nodes,
                               const float* leaves, int block,
                               const float* inst_inv, int mb_bits,
                               const float* origin, const float* direction,
                               const float* t_lane, int64_t n, float* t_out,
                               int* tri_out, float* u_out, float* v_out,
                               uint8_t* hit_out, unsigned long long* st,
                               unsigned* batches, void* stream) {
  if (any) return (int)cudaErrorInvalidValue;
  (void)hit_out;
  const SkipTables tab{nodes, n_nodes, leaves, block, inst_inv, mb_bits};
  return (inst_inv != nullptr ? skip_launch<true, SkipInstDesign, true>
                              : skip_launch<false, SkipFlatDesign, true>)(
      tab, origin, direction, t_lane, n, t_out, tri_out, u_out, v_out,
      batches, st, stream);
}

extern "C" int vkpt_wide_closest_hit(const float* tiles, int n_wide,
                                     const float* leaves, int block,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, unsigned* batches,
                                     void* stream) {
  return wide_launch<WideDesign>(tiles, n_wide, leaves, block, origin,
                                 direction, t_lane, n, t_out, tri_out, u_out,
                                 v_out, batches, nullptr, stream);
}

// The statistics build of the wide kernel (the design above; the walk's
// counters of vkpt_skip_stats, no stack).  The hit outputs are those of
// the production kernel.
extern "C" int vkpt_wide_stats(const float* tiles, int n_wide,
                               const float* leaves, int block,
                               const float* origin, const float* direction,
                               const float* t_lane, int64_t n, float* t_out,
                               int* tri_out, float* u_out, float* v_out,
                               unsigned long long* st, unsigned* batches,
                               void* stream) {
  return wide_launch<WideDesign, true>(tiles, n_wide, leaves, block, origin,
                                       direction, t_lane, n, t_out, tri_out,
                                       u_out, v_out, batches, st, stream);
}

// The channel build of the wide kernel: the seed (t, tri, u, v) per ray
// (and t_near, which the wrappers leave null); each pointer may be null.
extern "C" int vkpt_wide_closest_hit_chan(
    const float* tiles, int n_wide, const float* leaves, int block,
    const float* origin, const float* direction, const float* t_lane,
    VKPT_CHANNEL_PARAMS, int64_t n, float* t_out, int* tri_out,
    float* u_out, float* v_out, unsigned* batches, void* stream) {
  using C = Chan<WideDesign>;
  return launch_kernel<wide_chan_kernel<C>, C>(
      n, batches, stream, tiles, n_wide, leaves, block, VKPT_CHANNELS,
      origin, direction, t_lane, n, t_out, tri_out, u_out, v_out, batches);
}

// The channel build of the skip kernel (stack_walk.cuh Chan), flat or
// two-level: t_near and the seed (t, tri, u, v) per ray, each pointer
// may be null (t_near 0, no seed).
extern "C" int vkpt_skip_closest_hit_chan(
    const float* nodes, int n_nodes, const float* leaves, int block,
    const float* inst_inv, int mb_bits, const float* origin,
    const float* direction, const float* t_lane, VKPT_CHANNEL_PARAMS,
    int64_t n, float* t_out, int* tri_out, float* u_out, float* v_out,
    unsigned* batches, void* stream) {
  const SkipTables tab{nodes, n_nodes, leaves, block, inst_inv, mb_bits};
  return (inst_inv != nullptr ? skip_chan_launch<true, SkipInstDesign>
                              : skip_chan_launch<false, SkipFlatDesign>)(
      tab, VKPT_CHANNELS, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, batches, stream);
}
