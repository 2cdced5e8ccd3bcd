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
// The closest hit, in the order of the Pallas body: hit leaf slots are
// visited in slot order (pallas_frontier.py:471-499); internal children
// are sorted by entry distance with the Batcher network swapping on
// `<=` (:503-518, sortnet.cuh), pushed far to near, and the walk
// descends to the nearest (:520-541).  The network is not stable, so
// the plain version runs the same comparator list.  Its design: one
// ray per thread with its own stack (W - 1 entries per collapsed
// level, STACK_SLOTS in ops/stack_traverse; the bake refuses deeper
// trees), float4 loads of two slots at a time, the keys and children
// of a node in registers (the network's indices are constants), a
// W-entry leaf queue drained by one loop, and pop culling as in the
// quad kernel.
//
// The any hit's bit does not depend on the walk's order, so it walks
// hit children in slot order, with no network and no stack of entry
// distances, as its plain version does (slot_order), on the stack walk
// of the quad and pair any hits (stack_walk.cuh at width 16 or 32,
// waiting leaves as (node, slot mask) entries).  What bounded the first,
// near-first design on the bounce-1 launch of paths (b) and (c): idle
// lanes, as for the quad and pair any hits (slot order without
// postponing: node / leaf SIMT efficiency 0.46 / 0.26 exact), the
// 63-comparator network per node, and a 2.9 KB local int + float stack
// per thread.  The kept designs (PERF.md section 6; 20 candidates
// timed side by side):
//   - postponed leaves: a lane queues the leaf children of up to 4
//     nodes, until 8 leaves wait, before the warp tests leaves together
//     (leaf SIMT 0.94-0.96);
//   - exact leaves refill lanes from the batch counter (node SIMT
//     0.60); coefficient leaves keep persistent warps without refill,
//     whose leaf phase is bound by the 160 B-per-triangle rows;
//   - a register cap of 6 blocks per SM (85 registers).

#include <type_traits>

#include "sortnet.cuh"
#include "stack_walk.cuh"

namespace {

#define VKPT_CSWAP(a, b)                              \
  {                                                   \
    const bool lt = key[a] <= key[b];                 \
    const float ka = lt ? key[a] : key[b];            \
    const float kb = lt ? key[b] : key[a];            \
    const int ca = lt ? ch[a] : ch[b];                \
    const int cb = lt ? ch[b] : ch[a];                \
    key[a] = ka;                                      \
    key[b] = kb;                                      \
    ch[a] = ca;                                       \
    ch[b] = cb;                                       \
  }

template <int W, bool COEF>
__device__ void frontier_traverse(const float* __restrict__ box,
                                  const int* __restrict__ link,
                                  const float* __restrict__ leaves, int block,
                                  const Ray& r, Best& b) {
  constexpr int kStack = W == 16 ? 360 : 589;  // STACK_SLOTS[W]
  int stack[kStack];
  float stack_tn[kStack];
  int sp = 0;
  int cur = 0;
  float cur_tn = -INFINITY;
  while (cur >= 0) {
    const float t_lim = fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
    if (cur_tn <= t_lim) {
      const float4* brow =
          reinterpret_cast<const float4*>(box) + (size_t)cur * (W * 6 / 4);
      const int4* lrow =
          reinterpret_cast<const int4*>(link) + (size_t)cur * (W / 4);
      int ch[W];
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int4 l4 = __ldg(lrow + q);
        ch[4 * q + 0] = l4.x;
        ch[4 * q + 1] = l4.y;
        ch[4 * q + 2] = l4.z;
        ch[4 * q + 3] = l4.w;
      }
      // Entry distance of each hit slot, kBig for a missed or empty one.
      float key[W];
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
          float tn;
          const bool hit = slab(r, bx + 6 * h, t_lim, tn);
          key[2 * p + h] = (hit && ch[2 * p + h] != kEmpty) ? tn : kBig;
        }
      }
      // Hit leaf slots are queued in slot order, then drained by one
      // (not unrolled) loop, so the leaf test is inlined once.
      int queue[W];
      int qn = 0;
#pragma unroll
      for (int s = 0; s < W; ++s) {
        if (key[s] < kBig && ch[s] < 0) {
          queue[qn++] = -ch[s] - 1;
          key[s] = kBig;
        }
      }
#pragma unroll 1
      for (int i = 0; i < qn; ++i)
        visit_leaf<false, false, COEF>(r, leaves, block, nullptr, 0,
                                       queue[i], b);
      // Internal children: the Batcher network, push far to near,
      // descend to the nearest.
      if constexpr (W == 16) {
        VKPT_BATCHER16(VKPT_CSWAP)
      } else {
        VKPT_BATCHER32(VKPT_CSWAP)
      }
#pragma unroll
      for (int s = W - 1; s >= 1; --s) {
        if (key[s] < kBig) {
          stack[sp] = ch[s];
          stack_tn[sp] = key[s];
          ++sp;
        }
      }
      if (key[0] < kBig) {
        next = ch[0];
        next_tn = key[0];
      }
    }
    if (next < 0 && sp > 0) {
      --sp;
      next = stack[sp];
      next_tn = stack_tn[sp];
    }
    cur = next;
    cur_tn = next_tn;
  }
}

#undef VKPT_CSWAP

template <int W, bool COEF>
__global__ void __launch_bounds__(kThreads)
frontier_closest_hit_kernel(const float* __restrict__ box,
                            const int* __restrict__ link,
                            const float* __restrict__ leaves, int block,
                            const float* __restrict__ origin,
                            const float* __restrict__ direction,
                            const float* __restrict__ t_lane, int64_t n,
                            float* __restrict__ t_out,
                            int* __restrict__ tri_out,
                            float* __restrict__ u_out,
                            float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f)
    frontier_traverse<W, COEF>(box, link, leaves, block, r, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

// The any hit: the stack walk of stack_walk.cuh at width 16 or 32
// (slot order, leaves as node entries).
// Design<sort (no), postpone, persistent, min blocks per SM, refill,
// early-exit triangle test, leaf queue>.
using FrontierAnyDesign = Design<false, true, true, 6, true, false, 8>;
using CoefFrontierAnyDesign = Design<false, true, true, 6, false, false, 8>;

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

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted; cudaErrorInvalidValue for a width
// other than 16 or 32).  coef != 0: `leaves` is the (n_leaves, block,
// 40) coefficient table.
extern "C" int vkpt_frontier_closest_hit(const float* box, const int* link,
                                         int width, const float* leaves,
                                         int block, int coef,
                                         const float* origin,
                                         const float* direction,
                                         const float* t_lane, int64_t n,
                                         float* t_out, int* tri_out,
                                         float* u_out, float* v_out,
                                         void* stream) {
  if (width != 16 && width != 32) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
#define VKPT_FRONTIER_CH(W, COEF)                                        \
  frontier_closest_hit_kernel<W, COEF><<<grid, kThreads, 0, s>>>(        \
      box, link, leaves, block, origin, direction, t_lane, n, t_out,     \
      tri_out, u_out, v_out)
    if (width == 16 && coef)
      VKPT_FRONTIER_CH(16, true);
    else if (width == 16)
      VKPT_FRONTIER_CH(16, false);
    else if (coef)
      VKPT_FRONTIER_CH(32, true);
    else
      VKPT_FRONTIER_CH(32, false);
#undef VKPT_FRONTIER_CH
  }
  return (int)cudaGetLastError();
}

// `batches`: one unsigned counter for the any hit's persistent warps,
// zeroed by the launcher on `stream`.
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

// The statistics build of the any hit (the designs above; any must be
// 1); `st` holds kStCount zeroed counters.  The hit output is that of
// the production kernel; t_out .. v_out are not written.
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
  if (!any) return (int)cudaErrorInvalidValue;
  (void)t_out, (void)tri_out, (void)u_out, (void)v_out;
  const Tables tab{box, link, leaves, block, nullptr, nullptr, 0};
  return any_dispatch<true>(width, coef, tab, origin, direction, t_lane, n,
                            hit_out, batches, st, stream);
}
