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
//     coef_leaf).
// The plain PyTorch versions in ops/stack_traverse.py perform the same
// float operations in the same order (traverse.cuh: -fmad=false).
//
// What bounds it on this card: dependent loads (a 16 W B box row plus a
// 4 W B link row per node, 1,008 B per 28-triangle leaf block, 4,480 B
// as coefficients) and divergence between the rays of a warp.  The
// atrium's node and leaf tables together are about 10 MB (21 MB with
// coefficients), well inside the 50 MB L2, so the loads are L2
// latency, not HBM bandwidth.
//
// What the design does about it: one ray per thread (Hopper has a
// program counter per thread, so no packet-shared stack as on the
// TPU), near-first descent by the ray's own entry distance (a stable
// insertion sort of the W keys), culling of popped nodes whose entry
// lies beyond the current hit, read-only __ldg vector loads of node
// rows and leaf blocks, and rays that the caller sorts (2D tiles for
// primaries, the 6d Morton key for bounce rays) so that the threads of
// a warp walk similar paths.  The width-8 collapse folds three binary
// levels per row: fewer, larger rows.

#include "traverse.cuh"

namespace {

template <int W, bool ANY, bool COEF>
__device__ void traverse(const float* __restrict__ box,
                         const int* __restrict__ link,
                         const float* __restrict__ leaves, int block,
                         const Ray& r, Best& b) {
  // Per-ray stack entries: at most W - 1 pushes per collapsed level
  // (ops/stack_traverse.STACK_SLOTS; the bakes refuse deeper trees).
  constexpr int kStack = W == 4 ? 288 : 224;
  int stack[kStack];
  float stack_tn[kStack];
  int sp = 0;
  int cur = 0;
  float cur_tn = -INFINITY;
  while (cur >= 0) {
    const float t_lim = ANY ? r.tl : fminf(b.t, r.tl);
    int next = -1;
    float next_tn = 0.0f;
    if (cur_tn <= t_lim) {
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
      }
      // Leaf slots first, in slot order.
#pragma unroll
      for (int s = 0; s < W; ++s) {
        if (hit[s] && lk[s] < 0) {
          const int leaf = -lk[s] - 1;
          visit_leaf<ANY, false, COEF>(r, leaves, block, nullptr, 0, leaf, b);
          if (ANY && b.any) return;
        }
      }
      // Internal slots: stable sort by entry distance, push far-to-near.
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

template <int W, bool COEF>
__global__ void __launch_bounds__(kThreads)
nary_closest_hit_kernel(const float* __restrict__ box,
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
  if (r.tl >= 0.0f) traverse<W, false, COEF>(box, link, leaves, block, r, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

template <bool COEF>
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
  if (r.tl >= 0.0f) traverse<4, true, COEF>(box, link, leaves, block, r, b);
  hit_out[i] = b.any ? 1 : 0;
}

unsigned grid_of(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  coef != 0: `leaves` is the
// (n_leaves, block, 40) coefficient table.
extern "C" int vkpt_quad_closest_hit(const float* box, const int* link,
                                     const float* leaves, int block, int coef,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (coef)
      nary_closest_hit_kernel<4, true><<<grid_of(n), kThreads, 0, s>>>(
          box, link, leaves, block, origin, direction, t_lane, n, t_out,
          tri_out, u_out, v_out);
    else
      nary_closest_hit_kernel<4, false><<<grid_of(n), kThreads, 0, s>>>(
          box, link, leaves, block, origin, direction, t_lane, n, t_out,
          tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vkpt_oct_closest_hit(const float* box, const int* link,
                                    const float* leaves, int block,
                                    const float* origin,
                                    const float* direction,
                                    const float* t_lane, int64_t n,
                                    float* t_out, int* tri_out, float* u_out,
                                    float* v_out, void* stream) {
  if (n > 0) {
    nary_closest_hit_kernel<8, false>
        <<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
            box, link, leaves, block, origin, direction, t_lane, n, t_out,
            tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vkpt_quad_any_hit(const float* box, const int* link,
                                 const float* leaves, int block, int coef,
                                 const float* origin, const float* direction,
                                 const float* t_lane, int64_t n,
                                 uint8_t* hit_out, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (coef)
      quad_any_hit_kernel<true><<<grid_of(n), kThreads, 0, s>>>(
          box, link, leaves, block, origin, direction, t_lane, n, hit_out);
    else
      quad_any_hit_kernel<false><<<grid_of(n), kThreads, 0, s>>>(
          box, link, leaves, block, origin, direction, t_lane, n, hit_out);
  }
  return (int)cudaGetLastError();
}
