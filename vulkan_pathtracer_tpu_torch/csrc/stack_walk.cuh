// The stack walk of the pair, quad, oct and frontier kernels
// (pair_traverse.cu, stack_traverse.cu, frontier_traverse.cu) as
// compile-time design choices (Design): the kernel template, the leaf
// phase with its instance cache, the warp loops (postponed leaves, ray
// refill, persistent batches), the persistent launcher and the
// statistics build's counters, which skip_traverse.cu's skip and wide
// walks share; and the closest hits' channel builds (Chan<D>: a seeded
// or windowed launch, with its own ray type and entry points).  The
// choices and what each does about this card are described in
// stack_traverse.cu (quad, oct), pair_traverse.cu (pair),
// frontier_traverse.cu (frontier) and skip_traverse.cu (skip, wide).

#pragma once

#include <algorithm>

#include "sortnet.cuh"
#include "traverse.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The walk's compile-time choices:
//   SORT      the any hit descends near-first and culls popped nodes by
//             entry distance (else slot order, a stack of node ids);
//             the closest hit always does;
//   POSTPONE  while-while: node steps until every unfinished lane holds
//             leaf children, then the warp's leaf tests together;
//   PERSIST   a grid that fills the SMs, warps taking 32-ray batches
//             from a counter;
//   MINB      __launch_bounds__ minimum blocks per SM (a register cap);
//   REFILL    a lane whose ray is done takes the next one from the
//             counter at once;
//   EARLY     the triangle test returns at its first failed condition
//             (exact leaves: traverse.cuh mt; the coefficient test,
//             coef_block, always does, and its designs set EARLY);
//   AHEAD     coefficient leaves: a triangle's five row loads issued
//             before its first test (else each before the sum it feeds);
//   QUEUE     any hit with POSTPONE: a lane queues the leaf children of
//             several nodes, up to QUEUE entries, before the warp's
//             leaf tests (0: one node's);
//   LEAF_AT   POSTPONE without REFILL: the warp's leaf phase starts once
//             LEAF_AT lanes wait at leaves (0: once every unfinished
//             lane does).
// On two-level scenes each lane keeps the object-space ray (or the
// transformed features of coefficient leaves) of its last instance, and
// recomputes them only when a leaf of another instance comes (the same
// operations on the same inputs: bitwise the values of a
// recomputation).
// Every design's ray is a Ray; Chan<D> is design D's channel build.
template <bool SORT, bool POSTPONE, bool PERSIST, int MINB,
          bool REFILL = false, bool EARLY = false, int QUEUE = 0,
          int LEAF_AT = 0, bool AHEAD = false>
struct Design {
  static_assert(!REFILL || POSTPONE, "refill runs the postponed loop");
  static_assert(LEAF_AT == 0 || (POSTPONE && !REFILL),
                "the leaf threshold is the postponed loop's without refill");
  static constexpr bool kSort = SORT;  // any hit only; the closest hit sorts
  static constexpr bool kPostpone = POSTPONE;
  static constexpr bool kPersist = PERSIST || REFILL;
  static constexpr int kMinBlocks = MINB;
  static constexpr bool kRefill = REFILL;
  static constexpr bool kEarly = EARLY;    // traverse.cuh mt<..., EARLY>
  static constexpr int kQueue = QUEUE;
  static constexpr int kLeafAt = LEAF_AT;
  static constexpr bool kAhead = AHEAD;  // traverse.cuh coef_block
  static constexpr bool kChan = false;
  static constexpr bool kBf16 = false;
  using RayT = Ray;
};

// Design D built for the bf16 table of the one-pass product
// (VKPT_MXU_PRECISION=default): coef_block reads 40 B rows and the
// leaf test rounds the features (traverse.cuh round_features), after
// the object transform on two-level scenes.  Its kernels are entry
// points of their own, so the f32 builds compile as before.
template <class D>
struct Bf16 : D {
  static_assert(D::kEarly, "a coefficient design");
  static constexpr bool kBf16 = true;
};

// The channel build of closest-hit design D: each ray is a ChanRay,
// whose window bound the slab and triangle tests read (traverse.cuh
// overloads), starting from its seed hit (run_rays).  Its kernels
// are entry points of their own (stack_chan_kernel, skip_traverse.cu's
// *_chan_kernel), so the default kernels compile as before.
template <class D>
struct Chan : D {
  static_assert(!D::kRefill, "a channel build is a closest hit");
  static constexpr bool kChan = true;
  using RayT = ChanRay;
};

// Statistics build (STATS): counters of one launch, in this order
// (mirrored in ops/kernels.STACK_STATS).
enum : int {
  kStNodeWarps,    // warp iterations of the node step
  kStNodeLanes,    // lanes active in them (= node steps of all rays)
  kStLeafWarps,    // warp entries into a node's leaf children
  kStLeafLanes,    // lanes active in them
  kStRays,         // rays traversed (t_lane >= 0)
  kStWarps,        // warp batches with at least one ray (not under REFILL)
  kStBatchIters,   // node-step rounds of each batch's warp (not under REFILL)
  kStDeepest,      // deepest stack of any ray
  kStLeafVisits,   // leaf blocks tested
  kStInstChanges,  // two-level: leaf visits whose instance differs from
                   // the lane's previous leaf visit of the same ray
  kStInner,        // widths 16 and 32, closest hit: visited nodes with 0,
                   // 1, 2 or more hit internal children (3 counters)
  kStTri = kStInner + 3,  // coefficient leaves: triangles tested, and
                          // those failing at det <= 0, at u' < 0 and at
                          // the v' window (4 counters)
  kStShare = kStTri + 4,  // leaf visits by the number of the warp's lanes
                          // (1..32) that test the same table row with
                          // them (__match_any_sync; 32 counters)
  kStHist = kStShare + 32,  // histogram of each ray's deepest stack:
                            // 0..63, 64+
  kStCount = kStHist + 65
};

__device__ __forceinline__ void count_active(unsigned long long* st,
                                             int which) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    atomicAdd(st + which, 1ull);
    atomicAdd(st + which + 1, (unsigned long long)__popc(m));
  }
}

// The leaf phase of one lane: leaf `leaf` tested against the ray, the
// flat block or the two-level decode, whose object-space ray (features)
// is kept while the instance stays, reset with every ray.
template <bool ANY, bool COEF, bool INST, class D, bool STATS>
struct LeafTest {
  static_assert(!COEF || D::kEarly,
                "the coefficient test always exits early (coef_block)");
  static_assert(COEF || !D::kAhead, "AHEAD is a coefficient-leaf option");
  const float* __restrict__ leaves;
  const float* __restrict__ inst_inv;   // INST: (I, 16)
  const float* __restrict__ inst_feat;  // INST and COEF: (I, 40)
  int block, mb_bits;
  unsigned long long* st;  // STATS: the launch's counters
  // INST: the instance of the lane's last leaf visit, its object-space
  // ray (exact leaves) or transformed features (COEF) and det_sign.
  int last_inst;
  typename D::RayT o;
  float fo[COEF ? 10 : 1];
  float sign;

  __device__ __forceinline__ void reset() { last_inst = -1; }

  __device__ __forceinline__ void visit(const typename D::RayT& r, int leaf,
                                        Best& b) {
    if (STATS) {
      atomicAdd(st + kStLeafVisits, 1ull);
      const int row = INST ? leaf & ((1 << mb_bits) - 1) : leaf;
      const unsigned peers = __match_any_sync(__activemask(), row);
      atomicAdd(st + kStShare + __popc(peers) - 1, 1ull);
    }
    if (!INST) {
      if (COEF) {
        float f[10];
        ray_features(r, f);
        if (D::kBf16) round_features(f);
        coef_block<ANY, false, D::kAhead, STATS, D::kChan, D::kBf16>(
            f, leaves, leaf, leaf, block, 1.0f, r.tl, b, st + kStTri, lo(r));
      } else {
        visit_leaf<ANY, false, D::kEarly>(r, leaves, block, nullptr, 0, leaf,
                                          b);
      }
      return;
    }
    const int inst = leaf >> mb_bits;
    if (inst != last_inst) {
      if (STATS) atomicAdd(st + kStInstChanges, 1ull);
      last_inst = inst;
      if (COEF) {
        float f[10];
        ray_features(r, f);
        sign = object_features(f, inst_inv, inst_feat, inst, fo);
        if (D::kBf16) round_features(fo);
      } else {
        sign = object_ray(r, inst_inv, inst, o);
      }
    }
    const int row = leaf & ((1 << mb_bits) - 1);
    if (COEF)
      coef_block<ANY, true, D::kAhead, STATS, D::kChan, D::kBf16>(
          fo, leaves, row, leaf, block, sign, r.tl, b, st + kStTri, lo(r));
    else
      leaf_block<ANY, true, D::kEarly>(o, leaves, row, leaf, block, sign, b);
  }
};

// One ray's walk state: the stack (in the kernel's local arrays), the
// current node, the leaf children waiting for the warp's leaf phase and
// the leaf phase itself (LeafTest).
// The stack arrays stay outside the struct: an array indexed at run
// time inside it would put every member in local memory.
// Widths 16 and 32 (the frontier kernels, flat tables) keep their
// waiting leaves as (node, slot mask) entries and read each leaf value
// from the node's link row when its test comes: W leaf values would
// take 16-32 registers per lane.  The any hit (slot order, postponed
// with a queue) holds up to 4 entries and QUEUE leaves; the closest hit
// (near-first, the Batcher network) holds one node's entry and steps
// only once it is drained, since its leaf tests tighten the limit that
// the next node's slabs and pop culling read.
template <int W, bool ANY, bool COEF, bool INST, class D, bool STATS>
struct Walk {
  using RayT = typename D::RayT;
  static constexpr bool kSort = !ANY || D::kSort;
  static constexpr bool kMask = W >= 16;
  static_assert(!kMask || (!INST && (!ANY || (!kSort && D::kPostpone &&
                                              D::kQueue > 0))),
                "widths 16 and 32: flat tables; the any hit in slot order, "
                "queued");
  // Per-ray stack entries: one push per level in a pair row, at most
  // W - 1 per collapsed level in an n-ary one
  // (ops/stack_traverse.STACK_SLOTS; the bakes refuse deeper trees).
  static constexpr int kStack = W == 2    ? 96
                                : W == 4  ? 288
                                : W == 8  ? 224
                                : W == 16 ? 360
                                          : 589;
  // QUEUE: pending leaves are appended in test order, up to kPend;
  // else pend[s] holds slot s's leaf (W == 2: nearer first).
  static constexpr bool kQueued = !kMask && D::kQueue > W;
  static constexpr int kPend = kQueued ? D::kQueue : W;
  static constexpr int kEntries = ANY ? 4 : 1;  // kMask

  const float* __restrict__ box;
  const int* __restrict__ link;
  LeafTest<ANY, COEF, INST, D, STATS> lt;
  int* stack;
  float* stack_tn;
  int sp, cur, deepest, npend;
  float cur_tn;
  int pend[kMask ? 1 : kPend];  // leaf values waiting for the leaf phase
  int qnode[kMask ? kEntries : 1];       // kMask: nodes with waiting
  unsigned qmask[kMask ? kEntries : 1];  // leaves, their slot masks
  int nq;
  unsigned long long* st;  // STATS: the launch's counters

  __device__ __forceinline__ void push(int node, float tn) {
    stack[sp] = node;
    if (kSort) stack_tn[sp] = tn;
    ++sp;
    if (STATS) deepest = max(deepest, sp);
  }

  __device__ __forceinline__ void pop(int& node, float& tn) {
    --sp;
    node = stack[sp];
    tn = kSort ? stack_tn[sp] : 0.0f;
  }

  __device__ __forceinline__ void start(const RayT&, bool active) {
    sp = 0;
    deepest = 0;
    npend = 0;
    nq = 0;
    lt.reset();
    cur = active ? 0 : -1;
    cur_tn = -INFINITY;
    if (!kMask) {
#pragma unroll
      for (int s = 0; s < kPend; ++s) pend[s] = -1;
    }
  }

  __device__ __forceinline__ bool pending() const {
    if (kMask) return nq > 0;
    if (kQueued) return npend > 0;
    bool any = false;
#pragma unroll
    for (int s = 0; s < (kMask ? 1 : W); ++s) any = any || pend[s] >= 0;
    return any;
  }

  // Whether the lane takes part in the warp's next node step: it has a
  // node to visit and room for that node's leaf children.
  __device__ __forceinline__ bool can_step() const {
    if (kMask)
      return cur >= 0 && nq < kEntries && (!ANY || npend < D::kQueue);
    return cur >= 0 && (kQueued ? npend <= kPend - W : !pending());
  }

  __device__ __forceinline__ void visit(const RayT& r, int leaf, Best& b) {
    lt.visit(r, leaf, b);
  }

  __device__ __forceinline__ bool node_step(const RayT& r, Best& b) {
    if constexpr (!kMask)
      return narrow_step(r, b);
    else if constexpr (ANY)
      return wide_step(r, b);
    else
      return sorted_step(r, b);
  }

  // POSTPONE: the pending leaf children in test order; true when an any
  // hit is resolved.
  __device__ __forceinline__ bool visit_pending(const RayT& r, Best& b) {
    if constexpr (kMask)
      return wide_pending(r, b);
    else
      return narrow_pending(r, b);
  }

  // Visit node `cur`: slab-test its W children against the current
  // limit, record its hit leaf children in pend (POSTPONE) or test them
  // at once (true when that resolves an any hit), push the hit
  // internal children (near-first order: far-to-near pushes, the
  // nearest descended; slot order without the sort), then move to the
  // next node, popping when no child was hit.  Leaf children are tested
  // in slot order, or nearer-first in a pair row that the walk sorts
  // (pallas_pair.py:807: near = e0 <= e1, a missed child counting as
  // kBig), so each ray's sequence of leaf tests is the kernel's plain
  // version's.
  __device__ __forceinline__ bool narrow_step(const RayT& r, Best& b) {
    const float t_lim = ANY ? r.tl : fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
    if (!kQueued) {
#pragma unroll
      for (int s = 0; s < W; ++s) pend[s] = -1;
    }
    if (!kSort || cur_tn <= t_lim) {
      const float4* brow =
          reinterpret_cast<const float4*>(box) + (size_t)cur * (W * 6 / 4);
      float bx[W * 6];
#pragma unroll
      for (int q = 0; q < W * 6 / 4; ++q) {
        const float4 f = __ldg(brow + q);
        bx[4 * q + 0] = f.x;
        bx[4 * q + 1] = f.y;
        bx[4 * q + 2] = f.z;
        bx[4 * q + 3] = f.w;
      }
      int lk[W];
      if constexpr (W == 2) {
        const int2 l2 = __ldg(reinterpret_cast<const int2*>(link) + cur);
        lk[0] = l2.x;
        lk[1] = l2.y;
      } else {
        const int4* lrow =
            reinterpret_cast<const int4*>(link) + (size_t)cur * (W / 4);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const int4 l4 = __ldg(lrow + q);
          lk[4 * q + 0] = l4.x;
          lk[4 * q + 1] = l4.y;
          lk[4 * q + 2] = l4.z;
          lk[4 * q + 3] = l4.w;
        }
      }
      float tn[W];
      bool hit[W];
#pragma unroll
      for (int s = 0; s < W; ++s)
        hit[s] = slab(r, bx + 6 * s, t_lim, tn[s]) && (lk[s] != kEmpty);
      int lf[W];  // the hit leaf children in test order, else -1
#pragma unroll
      for (int s = 0; s < W; ++s)
        lf[s] = hit[s] && lk[s] < 0 ? -lk[s] - 1 : -1;
      if (W == 2 && kSort) {
        const float e0 = hit[0] ? tn[0] : kBig;
        const float e1 = hit[1] ? tn[1] : kBig;
        if (e1 < e0) {
          const int l0 = lf[0];
          lf[0] = lf[W - 1];
          lf[W - 1] = l0;
        }
      }
      if (kQueued) {
#pragma unroll
        for (int s = 0; s < W; ++s) {
          if (lf[s] >= 0) {
#pragma unroll
            for (int q = 0; q < kPend; ++q)
              if (q == npend) pend[q] = lf[s];
            ++npend;
          }
        }
      } else if (D::kPostpone) {
#pragma unroll
        for (int s = 0; s < W; ++s) pend[s] = lf[s];
      } else {
        if (STATS) {
          bool any_leaf = false;
#pragma unroll
          for (int s = 0; s < W; ++s) any_leaf |= lf[s] >= 0;
          if (any_leaf) count_active(st, kStLeafWarps);
        }
        // In slot order the test stays hit[s] && lk[s] < 0 in place:
        // reading the leaf values from lf made the oct kernel slower.
#pragma unroll
        for (int s = 0; s < W; ++s) {
          if (W == 2 ? lf[s] >= 0 : hit[s] && lk[s] < 0) {
            visit(r, W == 2 ? lf[s] : -lk[s] - 1, b);
            if (ANY && b.any) return true;
          }
        }
      }
      if (kSort) {
        // Internal slots: stable sort by entry distance.
        float key[W];
        int ch[W];
#pragma unroll
        for (int s = 0; s < W; ++s) {
          key[s] = (hit[s] && lk[s] >= 0) ? tn[s] : kBig;
          ch[s] = lk[s];
        }
#pragma unroll
        for (int i = 1; i < W; ++i) {
#pragma unroll
          for (int j = i; j > 0; --j) {
            if (key[j] < key[j - 1]) {
              const float tk = key[j];
              key[j] = key[j - 1];
              key[j - 1] = tk;
              const int tc = ch[j];
              ch[j] = ch[j - 1];
              ch[j - 1] = tc;
            }
          }
        }
#pragma unroll
        for (int s = W - 1; s >= 1; --s) {
          if (key[s] < kBig) push(ch[s], key[s]);
        }
        if (key[0] < kBig) {
          next = ch[0];
          next_tn = key[0];
        }
      } else {
#pragma unroll
        for (int s = W - 1; s >= 0; --s) {
          if (hit[s] && lk[s] >= 0) {
            if (next >= 0) push(next, 0.0f);
            next = lk[s];
          }
        }
      }
    }
    if (next < 0 && sp > 0) pop(next, next_tn);
    cur = next;
    cur_tn = next_tn;
    return false;
  }

  __device__ __forceinline__ bool narrow_pending(const RayT& r, Best& b) {
    if (STATS) count_active(st, kStLeafWarps);
#pragma unroll
    for (int s = 0; s < kPend; ++s) {
      if (kQueued ? s < npend : pend[s] >= 0) {
        visit(r, pend[s], b);
        pend[s] = -1;
        if (ANY && b.any) {
          npend = 0;
          return true;
        }
      }
    }
    npend = 0;
    return false;
  }

  // Widths 16 and 32: slot order, each hit leaf child as a bit of the
  // node's queue entry, the hit internal children pushed so that the
  // lowest slot is descended and the next lowest popped first, as in the
  // plain version (slot_order).
  __device__ __forceinline__ bool wide_step(const RayT& r, Best& b) {
    const float4* brow =
        reinterpret_cast<const float4*>(box) + (size_t)cur * (W * 6 / 4);
    const int4* lrow =
        reinterpret_cast<const int4*>(link) + (size_t)cur * (W / 4);
    int lk[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const int4 l4 = __ldg(lrow + q);
      lk[4 * q + 0] = l4.x;
      lk[4 * q + 1] = l4.y;
      lk[4 * q + 2] = l4.z;
      lk[4 * q + 3] = l4.w;
    }
    unsigned leafm = 0, inner = 0;
#pragma unroll
    for (int p = 0; p < W / 2; ++p) {
      float bx[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 f = __ldg(brow + 3 * p + q);
        bx[4 * q + 0] = f.x;
        bx[4 * q + 1] = f.y;
        bx[4 * q + 2] = f.z;
        bx[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * p + h;
        float tn;
        if (slab(r, bx + 6 * h, r.tl, tn) && lk[s] != kEmpty) {
          if (lk[s] < 0)
            leafm |= 1u << s;
          else
            inner |= 1u << s;
        }
      }
    }
    if (leafm != 0) {
#pragma unroll
      for (int q = 0; q < kEntries; ++q) {
        if (q == nq) {
          qnode[q] = cur;
          qmask[q] = leafm;
        }
      }
      ++nq;
      npend += __popc(leafm);
    }
    int next = -1;
#pragma unroll
    for (int s = W - 1; s >= 0; --s) {
      if ((inner >> s) & 1u) {
        if (next >= 0) push(next, 0.0f);
        next = lk[s];
      }
    }
    if (next < 0 && sp > 0) {
      float tn;
      pop(next, tn);
    }
    cur = next;
    return false;
  }

  // Widths 16 and 32, closest hit: every slot tested against
  // min(t_best, t_lane) at node entry, a popped node culled by its
  // entry distance, the hit leaf children as the lane's one queue entry
  // (tested at once without POSTPONE), the hit internal children
  // ordered by the Batcher network swapping on `<=`
  // (pallas_frontier.py:503-541), pushed far to near, the nearest
  // descended.  The network runs only where two or more internal
  // children were hit: with one finite key every network puts it first.
  __device__ __forceinline__ bool sorted_step(const RayT& r, Best& b) {
    const float t_lim = fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
    if (cur_tn <= t_lim) {
      const float4* brow =
          reinterpret_cast<const float4*>(box) + (size_t)cur * (W * 6 / 4);
      const int4* lrow =
          reinterpret_cast<const int4*>(link) + (size_t)cur * (W / 4);
      int lk[W];
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int4 l4 = __ldg(lrow + q);
        lk[4 * q + 0] = l4.x;
        lk[4 * q + 1] = l4.y;
        lk[4 * q + 2] = l4.z;
        lk[4 * q + 3] = l4.w;
      }
      unsigned leafm = 0, inner = 0;
      float key[W];  // entry distance of a hit internal slot, else kBig
#pragma unroll
      for (int p = 0; p < W / 2; ++p) {
        float bx[12];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 f = __ldg(brow + 3 * p + q);
          bx[4 * q + 0] = f.x;
          bx[4 * q + 1] = f.y;
          bx[4 * q + 2] = f.z;
          bx[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = 2 * p + h;
          float tn;
          const bool hit = slab(r, bx + 6 * h, t_lim, tn) && lk[s] != kEmpty;
          if (hit && lk[s] < 0) leafm |= 1u << s;
          if (hit && lk[s] >= 0) inner |= 1u << s;
          key[s] = hit && lk[s] >= 0 ? tn : kBig;
        }
      }
      if (leafm != 0) {
        qnode[0] = cur;
        qmask[0] = leafm;
        nq = 1;
      }
      if (STATS) atomicAdd(st + kStInner + min(__popc(inner), 2), 1ull);
      if ((inner & (inner - 1u)) != 0u) {
        sort_push(key, lk);
        if (key[0] < kBig) {
          next = lk[0];
          next_tn = key[0];
        }
      } else if (inner != 0u) {
        const int s = __ffs(inner) - 1;
        next = lk[s];
        next_tn = key[s];
      }
      if (!D::kPostpone && nq > 0) wide_pending(r, b);
    }
    if (next < 0 && sp > 0) pop(next, next_tn);
    cur = next;
    cur_tn = next_tn;
    return false;
  }

  // The Batcher network over a node's keys and children (the
  // comparator indices are constants, so both stay in registers), then
  // the hit internal children but the nearest pushed far to near.
  __device__ __forceinline__ void sort_push(float* key, int* ch) {
#define VKPT_CSWAP(a, b)                     \
  {                                          \
    const bool lt = key[a] <= key[b];        \
    const float ka = lt ? key[a] : key[b];   \
    const float kb = lt ? key[b] : key[a];   \
    const int ca = lt ? ch[a] : ch[b];       \
    const int cb = lt ? ch[b] : ch[a];       \
    key[a] = ka;                             \
    key[b] = kb;                             \
    ch[a] = ca;                              \
    ch[b] = cb;                              \
  }
    if constexpr (W == 16) {
      VKPT_BATCHER16(VKPT_CSWAP)
    } else {
      VKPT_BATCHER32(VKPT_CSWAP)
    }
#undef VKPT_CSWAP
#pragma unroll
    for (int s = W - 1; s >= 1; --s) {
      if (key[s] < kBig) push(ch[s], key[s]);
    }
  }

  // The entries in queue order, one loop over all their leaves, so the
  // warp's lanes test their i-th leaves together.
  __device__ __forceinline__ bool wide_pending(const RayT& r, Best& b) {
    if (STATS) count_active(st, kStLeafWarps);
    int e = 0, node = qnode[0];
    unsigned m = qmask[0];
    bool hit = false;
#pragma unroll 1
    while (true) {
      while (m == 0 && ++e < nq) {
#pragma unroll
        for (int q = 1; q < kEntries; ++q) {
          if (q == e) {
            node = qnode[q];
            m = qmask[q];
          }
        }
      }
      if (m == 0) break;
      const int s = __ffs(m) - 1;
      m &= m - 1;
      visit(r, -__ldg(link + (size_t)node * W + s) - 1, b);
      if (ANY && b.any) {
        hit = true;
        break;
      }
    }
    nq = 0;
    npend = 0;
    return hit;
  }
};

// One ray per lane; every lane of the warp calls it (inactive lanes
// with active = false), as the postponed loop votes across the warp.
// Returns the node-step rounds the warp ran.
template <class Wk, class D, bool STATS>
__device__ __forceinline__ int trace(Wk& w, const typename D::RayT& r,
                                     Best& b, bool active,
                                     unsigned long long* st) {
  w.start(r, active);
  int rounds = 0;
  if (!D::kPostpone) {
    while (w.cur >= 0) {
      if (STATS) count_active(st, kStNodeWarps);
      ++rounds;
      if (w.node_step(r, b)) break;
    }
    if (STATS) rounds = __reduce_max_sync(kFull, rounds);
    return rounds;
  }
  bool done = w.cur < 0;
  while (__any_sync(kFull, !done)) {
    // Node steps until every unfinished lane holds leaf children (or,
    // QUEUE, has no room for more or no node left; LEAF_AT: until that
    // many lanes wait).
    while (true) {
      const bool step = !done && w.can_step();
      if (!__any_sync(kFull, step)) break;
      if (D::kLeafAt > 0 &&
          __popc(__ballot_sync(kFull, !done && w.pending())) >= D::kLeafAt)
        break;
      ++rounds;
      if (step) {
        if (STATS) count_active(st, kStNodeWarps);
        w.node_step(r, b);
        done = w.cur < 0 && !w.pending();
      }
    }
    if (!done && w.pending()) {
      done = w.visit_pending(r, b) || w.cur < 0;
    }
  }
  return rounds;
}

__device__ __forceinline__ int64_t next_batch(unsigned* batches,
                                              unsigned count = 32u) {
  unsigned base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(batches, count);
  return (int64_t)__shfl_sync(kFull, base, 0);
}

template <bool ANY>
__device__ __forceinline__ void store_hit(int64_t i, const Best& b,
                                          float* t_out, int* tri_out,
                                          float* u_out, float* v_out,
                                          uint8_t* hit_out) {
  if (ANY) {
    hit_out[i] = b.any ? 1 : 0;
  } else {
    t_out[i] = b.t;
    tri_out[i] = b.tri;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
}

// REFILL (Aila and Laine's replacement of terminated rays): the
// postponed loop of trace(), where every lane whose ray is done stores
// it and takes the next ray from `batches` before the warp's next node
// phase, so lanes are not left idle behind the warp's longest ray.  The
// rays taken together are consecutive in the caller's order.
template <class Wk, class D, bool ANY, bool STATS>
__device__ __forceinline__ void refill_loop(
    Wk& w, const float* origin, const float* direction, const float* t_lane,
    int64_t n, float* t_out, int* tri_out, float* u_out, float* v_out,
    uint8_t* hit_out, unsigned* batches, unsigned long long* st) {
  const unsigned lane = threadIdx.x & 31;
  int64_t i = -1;  // this lane's ray; -1: none yet or stored
  bool done = true, retired = false;
  Ray r;
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  w.start(r, false);
  while (true) {
    if (done && i >= 0) {
      store_hit<ANY>(i, b, t_out, tri_out, u_out, v_out, hit_out);
      if (STATS && r.tl >= 0.0f) {
        atomicAdd(st + kStHist + min(w.deepest, 64), 1ull);
        atomicMax(st + kStDeepest, (unsigned long long)w.deepest);
      }
      i = -1;
    }
    const bool want = done && !retired;
    const unsigned need = __ballot_sync(kFull, want);
    if (need) {
      const int k = __popc(need);
      const int rank = __popc(need & ((1u << lane) - 1u));
      const int64_t base = next_batch(batches, (unsigned)k);
      if (want) {
        i = base + rank;
        if (i < n) {
          r = load_ray(origin, direction, t_lane, i);
          b = Best{kMissT, 0.0f, 0.0f, -1, false};
          w.start(r, r.tl >= 0.0f);
          done = w.cur < 0;
          if (STATS && !done) atomicAdd(st + kStRays, 1ull);
        } else {
          i = -1;
          retired = true;
        }
      }
    }
    if (__all_sync(kFull, retired)) return;
    while (true) {
      const bool step = !done && w.can_step();
      if (!__any_sync(kFull, step)) break;
      if (step) {
        if (STATS) count_active(st, kStNodeWarps);
        w.node_step(r, b);
        done = w.cur < 0 && !w.pending();
      }
    }
    if (!done && w.pending()) {
      done = w.visit_pending(r, b) || w.cur < 0;
    }
  }
}

// The rays of a launch, for any walk Wk with the interface of Walk
// (start, can_step, node_step, pending, visit_pending, cur, deepest):
// REFILL's loop, or warps taking the 32 rays at their own position in
// the grid (without PERSIST) or batches of 32 from `batches` until none
// is left.  A channel build (D = Chan<design>) passes its Channels as
// `ch` and reads each ray's window bound and seed hit from it
// (traverse.cuh); the default builds pass none.
template <class Wk, bool ANY, class D, bool STATS, class... Ch>
__device__ __forceinline__ void run_rays(
    Wk& w, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_lane,
    int64_t n, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    uint8_t* __restrict__ hit_out, unsigned* batches,
    unsigned long long* st, const Ch&... ch) {
  if constexpr (D::kRefill) {
    refill_loop<Wk, D, ANY, STATS>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, hit_out, batches, st);
    return;
  }
  int64_t base = D::kPersist
                     ? next_batch(batches)
                     : (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31u);
  while (base < n) {
    const int64_t i = base + (threadIdx.x & 31);
    typename D::RayT r;
    r.tl = -1.0f;
    if (i < n) r = load_ray(origin, direction, t_lane, i);
    Best b{kMissT, 0.0f, 0.0f, -1, false};
    if constexpr (D::kChan) {
      static_assert(sizeof...(Ch) == 1, "a channel build reads its channels");
      const Channels& c = (ch, ...);
      r.tn = i < n ? lane_tnear(c, i) : kTmin;
      if (i < n) b = lane_seed(c, i);
    }
    const bool active = r.tl >= 0.0f;
    const int rounds = trace<Wk, D, STATS>(w, r, b, active, st);
    if (STATS) {
      const unsigned rays = __ballot_sync(kFull, active);
      if (active) {
        atomicAdd(st + kStRays, 1ull);
        atomicAdd(st + kStHist + min(w.deepest, 64), 1ull);
        atomicMax(st + kStDeepest, (unsigned long long)w.deepest);
      }
      if ((threadIdx.x & 31) == 0 && rays) {
        atomicAdd(st + kStWarps, 1ull);
        atomicAdd(st + kStBatchIters, (unsigned long long)rounds);
      }
    }
    if (i < n) store_hit<ANY>(i, b, t_out, tri_out, u_out, v_out, hit_out);
    if (!D::kPersist) break;
    base = next_batch(batches);
  }
}

// The tables a launch reads: node rows of W slots, leaf blocks (exact
// or coefficient) and, two-level, the instance records.
struct Tables {
  const float* box;
  const int* link;
  const float* leaves;
  int block;
  const float* inst_inv;   // INST: (I, 16)
  const float* inst_feat;  // INST and COEF: (I, 40)
  int mb_bits;
};

// The stack walk of a launch over `tab` (its stack in the kernel's
// local arrays), its counters `ST` (the two entry points below; a
// macro, as a shared function moved the default kernels' SASS).
#define VKPT_STACK_WALK(ST)                              \
  Wk w;                                                  \
  int stack[Wk::kStack];                                 \
  float stack_tn[Wk::kSort ? Wk::kStack : 1];            \
  w.stack = stack;                                       \
  w.stack_tn = stack_tn;                                 \
  w.box = tab.box;                                       \
  w.link = tab.link;                                     \
  w.lt.leaves = tab.leaves;                              \
  w.lt.block = tab.block;                                \
  w.lt.inst_inv = tab.inst_inv;                          \
  w.lt.inst_feat = tab.inst_feat;                        \
  w.lt.mb_bits = tab.mb_bits;                            \
  w.lt.st = ST;                                          \
  w.st = ST

// Closest hit (t, tri, u, v out) or any hit (hit out) of n rays.
template <int W, bool ANY, bool COEF, bool INST, class D, bool STATS>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
stack_kernel(const Tables tab, const float* __restrict__ origin,
             const float* __restrict__ direction,
             const float* __restrict__ t_lane, int64_t n,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             uint8_t* __restrict__ hit_out, unsigned* batches,
             unsigned long long* st) {
  using Wk = Walk<W, ANY, COEF, INST, D, STATS>;
  VKPT_STACK_WALK(st);
  run_rays<Wk, ANY, D, STATS>(w, origin, direction, t_lane, n, t_out,
                              tri_out, u_out, v_out, hit_out, batches, st);
}

// The closest hit of a channel build (D = Chan<design>) of n rays, each
// ray's window and seed from `ch`.
template <int W, bool COEF, bool INST, class D>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
stack_chan_kernel(const Tables tab, const Channels ch,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_lane, int64_t n,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  unsigned* batches) {
  using Wk = Walk<W, false, COEF, INST, D, false>;
  VKPT_STACK_WALK(nullptr);
  run_rays<Wk, false, D, false>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, nullptr, batches,
                                nullptr, ch);
}
#undef VKPT_STACK_WALK

// Blocks of kernel K that the device's SMs hold at once (a persistent
// grid): read once per device and kernel, as the occupancy does not
// change between launches.  The wrappers set the tensors' device
// current before the launch.
template <auto K>
int64_t resident_blocks() {
  constexpr int kMaxDevices = 64;
  static int64_t blocks[kMaxDevices] = {};  // 0: not read yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kThreads, 0);
    blocks[dev] = (int64_t)std::max(sms, 1) * std::max(per_sm, 1);
  }
  return blocks[dev];
}

// Launch kernel K of design D over n rays on `stream` with `args`; a
// persistent grid fills the SMs once, and `batches`, the persistent
// warps' counter, is zeroed on `stream` before the launch.
template <auto K, class D, class... A>
int launch_kernel(int64_t n, unsigned* batches, void* stream, A... args) {
  if (n <= 0) return (int)cudaGetLastError();
  int64_t grid = (n + kThreads - 1) / kThreads;
  if (D::kPersist) {
    grid = std::min(grid, resident_blocks<K>());
    cudaMemsetAsync(batches, 0, sizeof(unsigned), (cudaStream_t)stream);
  }
  const auto kernel = K;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int W, bool ANY, bool COEF, bool INST, class D, bool STATS = false>
int launch(const Tables& tab, const float* origin, const float* direction,
           const float* t_lane, int64_t n, float* t_out, int* tri_out,
           float* u_out, float* v_out, uint8_t* hit_out, unsigned* batches,
           unsigned long long* st, void* stream) {
  return launch_kernel<stack_kernel<W, ANY, COEF, INST, D, STATS>, D>(
      n, batches, stream, tab, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, hit_out, batches, st);
}

// The channel build of closest-hit design D.
template <int W, bool COEF, bool INST, class D>
int launch_chan(const Tables& tab, const Channels& ch, const float* origin,
                const float* direction, const float* t_lane, int64_t n,
                float* t_out, int* tri_out, float* u_out, float* v_out,
                unsigned* batches, void* stream) {
  using C = Chan<D>;
  return launch_kernel<stack_chan_kernel<W, COEF, INST, C>, C>(
      n, batches, stream, tab, ch, origin, direction, t_lane, n, t_out,
      tri_out, u_out, v_out, batches);
}

// The C launchers' channel arguments (t_near, seed t, tri, u, v; each
// may be null), and them as a Channels.
#define VKPT_CHANNEL_PARAMS                                          \
  const float *t_near, const float *seed_t, const int *seed_tri,    \
      const float *seed_u, const float *seed_v
#define VKPT_CHANNELS Channels{t_near, seed_t, seed_tri, seed_u, seed_v}

}  // namespace
