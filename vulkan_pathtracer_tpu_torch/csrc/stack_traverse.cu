// Quad-BVH stack traversal on Hopper: closest hit and any hit.
//
// Replaces the two Pallas TPU kernels of the headline frame:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_pair.py
//     _make_nary_kernel (width 4), launched by _nary_traverse via
//     pallas_quad_closest_hit;
//   - any hit: pallas_pair.py _make_nary_anyhit_kernel (width 4),
//     launched by _nary_anyhit via pallas_quad_any_hit.
// The plain PyTorch versions in ops/stack_traverse.py perform the same
// float operations in the same order (traverse.cuh: -fmad=false).
//
// What bounds it on this card: dependent loads (a 96 B box row plus a
// 16 B link row per node, 1,008 B per 28-triangle leaf block) and
// divergence between the rays of a warp.  The atrium's node and leaf
// tables together are about 10 MB, well inside the 50 MB L2, so the
// loads are L2 latency, not HBM bandwidth.
//
// What the design does about it: one ray per thread (Hopper has a
// program counter per thread, so no packet-shared stack as on the
// TPU), near-first descent by the ray's own entry distance, culling of
// popped nodes whose entry lies beyond the current hit, read-only
// __ldg float4 loads of node rows and leaf blocks, and rays that the
// caller sorts (2D tiles for primaries, the 6d Morton key for bounce
// rays) so that the threads of a warp walk similar paths.

#include "traverse.cuh"

namespace {

constexpr int kStackSize = 288;          // 3 * STACK_CAP (per-ray entries)
constexpr int kEmpty = -2147483647 - 1;  // INT32_MIN: empty slot

template <bool ANY>
__device__ void traverse(const float* __restrict__ box,
                         const int* __restrict__ link,
                         const float* __restrict__ leaves, int block,
                         const Ray& r, Best& b) {
  int stack[kStackSize];
  float stack_tn[kStackSize];
  int sp = 0;
  int cur = 0;
  float cur_tn = -INFINITY;
  while (cur >= 0) {
    const float t_lim = ANY ? r.tl : fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
    if (cur_tn <= t_lim) {
      const float4* brow = reinterpret_cast<const float4*>(box) + cur * 6;
      float bx[24];
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float4 f = __ldg(brow + q);
        bx[4 * q + 0] = f.x;
        bx[4 * q + 1] = f.y;
        bx[4 * q + 2] = f.z;
        bx[4 * q + 3] = f.w;
      }
      const int4 l4 = __ldg(reinterpret_cast<const int4*>(link) + cur);
      const int lk[4] = {l4.x, l4.y, l4.z, l4.w};
      float tn[4];
      bool hit[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        hit[s] = slab(r, bx + 6 * s, t_lim, tn[s]) && (lk[s] != kEmpty);
      }
      // Leaf slots first, in slot order.
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (hit[s] && lk[s] < 0) {
          const int leaf = -lk[s] - 1;
          leaf_block<ANY, false>(r, leaves, leaf, leaf, block, 1.0f, b);
          if (ANY && b.any) return;
        }
      }
      // Internal slots: stable sort by entry distance, push far-to-near.
      float key[4];
      int ch[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        key[s] = (hit[s] && lk[s] >= 0) ? tn[s] : kBig;
        ch[s] = lk[s];
      }
#pragma unroll
      for (int i = 1; i < 4; ++i) {
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
      for (int s = 3; s >= 1; --s) {
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

__global__ void __launch_bounds__(kThreads)
quad_closest_hit_kernel(const float* __restrict__ box,
                        const int* __restrict__ link,
                        const float* __restrict__ leaves, int block,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_lane, int64_t n,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f) traverse<false>(box, link, leaves, block, r, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

__global__ void __launch_bounds__(kThreads)
quad_any_hit_kernel(const float* __restrict__ box,
                    const int* __restrict__ link,
                    const float* __restrict__ leaves, int block,
                    const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_lane, int64_t n,
                    uint8_t* __restrict__ hit_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f) traverse<true>(box, link, leaves, block, r, b);
  hit_out[i] = b.any ? 1 : 0;
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).
extern "C" int vkpt_quad_closest_hit(const float* box, const int* link,
                                     const float* leaves, int block,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    quad_closest_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        box, link, leaves, block, origin, direction, t_lane, n, t_out,
        tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vkpt_quad_any_hit(const float* box, const int* link,
                                 const float* leaves, int block,
                                 const float* origin, const float* direction,
                                 const float* t_lane, int64_t n,
                                 uint8_t* hit_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    quad_any_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        box, link, leaves, block, origin, direction, t_lane, n, hit_out);
  }
  return (int)cudaGetLastError();
}
