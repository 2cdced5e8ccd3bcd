// The stack walk of the quad and oct kernels (stack_traverse.cu) as
// compile-time design choices (Design): the kernel template, its
// launcher and the statistics build's counters.  The choices and what
// each does about this card are described in stack_traverse.cu.

#pragma once

#include <algorithm>

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
//   EARLY     the triangle test returns at its first failed condition.
template <bool SORT, bool POSTPONE, bool PERSIST, int MINB,
          bool REFILL = false, bool EARLY = false>
struct Design {
  static constexpr bool kSort = SORT;  // any hit only; the closest hit sorts
  static constexpr bool kPostpone = POSTPONE;
  static constexpr bool kPersist = PERSIST || REFILL;
  static constexpr int kMinBlocks = MINB;
  static constexpr bool kRefill = REFILL;  // implies PERSIST and POSTPONE
  static constexpr bool kEarly = EARLY;    // traverse.cuh mt<..., EARLY>
};

// Statistics build (STATS): counters of one launch, in this order
// (mirrored in ops/kernels.STACK_STATS).
enum : int {
  kStNodeWarps,   // warp iterations of the node step
  kStNodeLanes,   // lanes active in them (= node steps of all rays)
  kStLeafWarps,   // warp entries into a node's leaf children
  kStLeafLanes,   // lanes active in them
  kStRays,        // rays traversed (t_lane >= 0)
  kStWarps,       // warp batches with at least one ray (not under REFILL)
  kStBatchIters,  // node-step rounds of each batch's warp (not under REFILL)
  kStDeepest,     // deepest stack of any ray
  kStHist,        // histogram of each ray's deepest stack: 0..63, 64+
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

// One ray's walk state: the stack (in the kernel's local arrays), the
// current node and the leaf children of the last node visited.  The arrays stay
// outside the struct: an array indexed at run time inside it would put
// every member in local memory.
template <int W, bool ANY, bool COEF, class D, bool STATS>
struct Walk {
  static constexpr bool kSort = !ANY || D::kSort;
  // Per-ray stack entries: at most W - 1 pushes per collapsed level
  // (ops/stack_traverse.STACK_SLOTS; the bakes refuse deeper trees).
  static constexpr int kStack = W == 4 ? 288 : 224;

  const float* __restrict__ box;
  const int* __restrict__ link;
  const float* __restrict__ leaves;
  int block;
  int* stack;
  float* stack_tn;
  int sp, cur, deepest;
  float cur_tn;
  int pend[W];  // leaf block of each hit leaf slot of the last node, else -1
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

  __device__ __forceinline__ void start(bool active) {
    sp = 0;
    deepest = 0;
    cur = active ? 0 : -1;
    cur_tn = -INFINITY;
#pragma unroll
    for (int s = 0; s < W; ++s) pend[s] = -1;
  }

  __device__ __forceinline__ bool pending() const {
    bool any = false;
#pragma unroll
    for (int s = 0; s < W; ++s) any = any || pend[s] >= 0;
    return any;
  }

  // Visit node `cur`: slab-test its W children against the current
  // limit, record its hit leaf slots in pend (POSTPONE) or test them at
  // once (true when that resolves an any hit), push the hit
  // internal children (near-first order: far-to-near pushes, the
  // nearest descended; slot order without the sort), then move to the
  // next node, popping when no child was hit.
  __device__ __forceinline__ bool node_step(const Ray& r, Best& b) {
    const float t_lim = ANY ? r.tl : fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
#pragma unroll
    for (int s = 0; s < W; ++s) pend[s] = -1;
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
      float tn[W];
      bool hit[W];
#pragma unroll
      for (int s = 0; s < W; ++s) {
        hit[s] = slab(r, bx + 6 * s, t_lim, tn[s]) && (lk[s] != kEmpty);
        if (D::kPostpone && hit[s] && lk[s] < 0) pend[s] = -lk[s] - 1;
      }
      if (!D::kPostpone) {
        // Leaf slots first, in slot order.
        if (STATS) {
          bool any_leaf = false;
#pragma unroll
          for (int s = 0; s < W; ++s) any_leaf |= hit[s] && lk[s] < 0;
          if (any_leaf) count_active(st, kStLeafWarps);
        }
#pragma unroll
        for (int s = 0; s < W; ++s) {
          if (hit[s] && lk[s] < 0) {
            visit_leaf<ANY, false, COEF, D::kEarly>(
                r, leaves, block, nullptr, 0, -lk[s] - 1, b);
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

  // POSTPONE: the leaf children of the last node, in slot order; true
  // when an any hit is resolved.
  __device__ __forceinline__ bool visit_pending(const Ray& r, Best& b) {
    if (STATS) count_active(st, kStLeafWarps);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (pend[s] >= 0) {
        visit_leaf<ANY, false, COEF, D::kEarly>(
            r, leaves, block, nullptr, 0, pend[s], b);
        pend[s] = -1;
        if (ANY && b.any) return true;
      }
    }
    return false;
  }
};

// One ray per lane; every lane of the warp calls it (inactive lanes
// with active = false), as the postponed loop votes across the warp.
// Returns the node-step rounds the warp ran.
template <class Wk, class D, bool STATS>
__device__ __forceinline__ int trace(Wk& w, const Ray& r, Best& b,
                                     bool active, unsigned long long* st) {
  w.start(active);
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
    // Node steps until every unfinished lane holds leaf children.
    while (true) {
      const bool step = !done && !w.pending();
      if (!__any_sync(kFull, step)) break;
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
template <class Wk, bool ANY, bool STATS>
__device__ __forceinline__ void refill_loop(
    Wk& w, const float* origin, const float* direction, const float* t_lane,
    int64_t n, float* t_out, int* tri_out, float* u_out, float* v_out,
    uint8_t* hit_out, unsigned* batches, unsigned long long* st) {
  const unsigned lane = threadIdx.x & 31;
  int64_t i = -1;  // this lane's ray; -1: none yet or stored
  bool done = true, retired = false;
  Ray r;
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  w.start(false);
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
          w.start(r.tl >= 0.0f);
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
      const bool step = !done && !w.pending();
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

// Closest hit (t, tri, u, v out) or any hit (hit out) of n rays.
// Without PERSIST a warp takes the 32 rays at its own position in the
// grid; with it, batches of 32 from `batches` until none is left.
template <int W, bool ANY, bool COEF, class D, bool STATS>
__global__ void __launch_bounds__(kThreads, D::kMinBlocks)
stack_kernel(const float* __restrict__ box, const int* __restrict__ link,
             const float* __restrict__ leaves, int block,
             const float* __restrict__ origin,
             const float* __restrict__ direction,
             const float* __restrict__ t_lane, int64_t n,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             uint8_t* __restrict__ hit_out, unsigned* batches,
             unsigned long long* st) {
  using Wk = Walk<W, ANY, COEF, D, STATS>;
  Wk w;
  int stack[Wk::kStack];
  float stack_tn[Wk::kSort ? Wk::kStack : 1];
  w.stack = stack;
  w.stack_tn = stack_tn;
  w.box = box;
  w.link = link;
  w.leaves = leaves;
  w.block = block;
  w.st = st;
  if constexpr (D::kRefill) {
    refill_loop<Wk, ANY, STATS>(w, origin, direction, t_lane, n, t_out,
                                tri_out, u_out, v_out, hit_out, batches, st);
    return;
  }
  int64_t base = D::kPersist
                     ? next_batch(batches)
                     : (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31u);
  while (base < n) {
    const int64_t i = base + (threadIdx.x & 31);
    Ray r;
    r.tl = -1.0f;
    if (i < n) r = load_ray(origin, direction, t_lane, i);
    Best b{kMissT, 0.0f, 0.0f, -1, false};
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

// Blocks of one instantiation of stack_kernel that the device's SMs
// hold at once (a persistent grid): read once per device and
// instantiation, as the occupancy does not change between launches.
template <int W, bool ANY, bool COEF, class D, bool STATS>
int64_t resident_blocks() {
  constexpr int kMaxDevices = 64;
  static int64_t blocks[kMaxDevices] = {};  // 0: not read yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stack_kernel<W, ANY, COEF, D, STATS>, kThreads, 0);
    blocks[dev] = (int64_t)std::max(sms, 1) * std::max(per_sm, 1);
  }
  return blocks[dev];
}

// `batches`: the persistent warps' counter, zeroed here on `stream`
// before the launch.
template <int W, bool ANY, bool COEF, class D, bool STATS = false>
int launch(const float* box, const int* link, const float* leaves,
           int block, const float* origin, const float* direction,
           const float* t_lane, int64_t n, float* t_out, int* tri_out,
           float* u_out, float* v_out, uint8_t* hit_out, unsigned* batches,
           unsigned long long* st, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto kernel = stack_kernel<W, ANY, COEF, D, STATS>;
  int64_t grid = (n + kThreads - 1) / kThreads;
  if (D::kPersist) {
    grid = std::min(grid, resident_blocks<W, ANY, COEF, D, STATS>());
    cudaMemsetAsync(batches, 0, sizeof(unsigned), (cudaStream_t)stream);
  }
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      box, link, leaves, block, origin, direction, t_lane, n, t_out, tri_out,
      u_out, v_out, hit_out, batches, st);
  return (int)cudaGetLastError();
}

}  // namespace
