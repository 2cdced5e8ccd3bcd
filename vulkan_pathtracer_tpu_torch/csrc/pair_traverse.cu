// Pair-BVH (BVH2) stack traversal on Hopper: closest hit and any hit,
// flat or two-level (instanced).
//
// Replaces the two Pallas TPU kernels of the instanced path:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_pair.py
//     _make_pair_kernel, launched by _pair_traverse via
//     pallas_pair_closest_hit;
//   - any hit: pallas_pair.py _make_pair_anyhit_kernel, launched by
//     _pair_anyhit via pallas_pair_any_hit;
//   - under VKPT_MT=mxu their inlined coefficient leaf test, flat and
//     two-level (mxu_mt.mt_coef_visit / mt_coef_visit_anyhit with the
//     instance feature transform; traverse.cuh coef_leaf).
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
// and divergence, not HBM bandwidth — a BVH2 visit is one 56 B row and
// two slab tests, so a ray makes about twice as many dependent row
// loads as in a quad table.  Two-level scenes add, at each leaf visit,
// a 64 B instance row and 33 flops of object-space ray transform.
// The instanced atrium's tables (about 6 MB at leaf 14) sit in the
// 50 MB L2.
//
// What the design does about it: one ray per thread with its own stack
// of STACK_CAP entries (one push per tree level at most), near-first
// descent by the ray's own entry distance, leaf children tested
// nearer-first so the nearer hit tightens the farther block's window,
// culling of popped nodes whose entry lies beyond the current hit,
// __ldg vector loads of rows, instance records and leaf blocks, and
// rays sorted by the caller (2D tiles, the 6d Morton key).

#include "traverse.cuh"

namespace {

constexpr int kStackSize = 96;  // STACK_CAP: one push per tree level

template <bool ANY, bool INST, bool COEF>
__device__ void pair_traverse(const float* __restrict__ box,
                              const int* __restrict__ link,
                              const float* __restrict__ leaves, int block,
                              const float* __restrict__ inst_inv,
                              const float* __restrict__ inst_feat,
                              int mb_bits, const Ray& r, Best& b) {
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
      const float4* brow = reinterpret_cast<const float4*>(box) + cur * 3;
      float bx[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 f = __ldg(brow + q);
        bx[4 * q + 0] = f.x;
        bx[4 * q + 1] = f.y;
        bx[4 * q + 2] = f.z;
        bx[4 * q + 3] = f.w;
      }
      const int2 l2 = __ldg(reinterpret_cast<const int2*>(link) + cur);
      const int lk[2] = {l2.x, l2.y};
      float tn[2];
      bool hit[2];
      hit[0] = slab(r, bx, t_lim, tn[0]);
      hit[1] = slab(r, bx + 6, t_lim, tn[1]);
      // Nearer child first (pallas_pair.py:807: near0 = m0 <= m1, a
      // missed child counting as BIG).
      const float e0 = hit[0] ? tn[0] : kBig;
      const float e1 = hit[1] ? tn[1] : kBig;
      const int near = e0 <= e1 ? 0 : 1;
      const int far = 1 - near;
      // Leaf children nearer-first.
      if (hit[near] && lk[near] < 0) {
        visit_leaf<ANY, INST, COEF>(r, leaves, block, inst_inv, mb_bits,
                                    -lk[near] - 1, b, inst_feat);
        if (ANY && b.any) return;
      }
      if (hit[far] && lk[far] < 0) {
        visit_leaf<ANY, INST, COEF>(r, leaves, block, inst_inv, mb_bits,
                                    -lk[far] - 1, b, inst_feat);
        if (ANY && b.any) return;
      }
      // Internal children: descend the nearer, push the farther.
      const bool in_near = hit[near] && lk[near] >= 0;
      const bool in_far = hit[far] && lk[far] >= 0;
      if (in_near) {
        next = lk[near];
        next_tn = tn[near];
        if (in_far) {
          stack[sp] = lk[far];
          stack_tn[sp] = tn[far];
          ++sp;
        }
      } else if (in_far) {
        next = lk[far];
        next_tn = tn[far];
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

template <bool INST, bool COEF>
__global__ void __launch_bounds__(kThreads)
pair_closest_hit_kernel(const float* __restrict__ box,
                        const int* __restrict__ link,
                        const float* __restrict__ leaves, int block,
                        const float* __restrict__ inst_inv,
                        const float* __restrict__ inst_feat, int mb_bits,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_lane, int64_t n,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f)
    pair_traverse<false, INST, COEF>(box, link, leaves, block, inst_inv,
                                     inst_feat, mb_bits, r, b);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

template <bool INST, bool COEF>
__global__ void __launch_bounds__(kThreads)
pair_any_hit_kernel(const float* __restrict__ box,
                    const int* __restrict__ link,
                    const float* __restrict__ leaves, int block,
                    const float* __restrict__ inst_inv,
                    const float* __restrict__ inst_feat, int mb_bits,
                    const float* __restrict__ origin,
                    const float* __restrict__ direction,
                    const float* __restrict__ t_lane, int64_t n,
                    uint8_t* __restrict__ hit_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f)
    pair_traverse<true, INST, COEF>(box, link, leaves, block, inst_inv,
                                    inst_feat, mb_bits, r, b);
  hit_out[i] = b.any ? 1 : 0;
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  inst_inv == nullptr selects the
// flat variant; coef != 0 the coefficient leaves (`leaves` is then the
// (n_leaves, block, 40) table, and a two-level scene passes inst_feat).
extern "C" int vkpt_pair_closest_hit(const float* box, const int* link,
                                     const float* leaves, int block, int coef,
                                     const float* inst_inv,
                                     const float* inst_feat, int mb_bits,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
#define VKPT_PAIR_CH(INST, COEF)                                          \
  pair_closest_hit_kernel<INST, COEF><<<grid, kThreads, 0, s>>>(          \
      box, link, leaves, block, inst_inv, inst_feat, mb_bits, origin,     \
      direction, t_lane, n, t_out, tri_out, u_out, v_out)
    if (inst_inv != nullptr && coef)
      VKPT_PAIR_CH(true, true);
    else if (inst_inv != nullptr)
      VKPT_PAIR_CH(true, false);
    else if (coef)
      VKPT_PAIR_CH(false, true);
    else
      VKPT_PAIR_CH(false, false);
#undef VKPT_PAIR_CH
  }
  return (int)cudaGetLastError();
}

extern "C" int vkpt_pair_any_hit(const float* box, const int* link,
                                 const float* leaves, int block, int coef,
                                 const float* inst_inv,
                                 const float* inst_feat, int mb_bits,
                                 const float* origin, const float* direction,
                                 const float* t_lane, int64_t n,
                                 uint8_t* hit_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
#define VKPT_PAIR_AH(INST, COEF)                                         \
  pair_any_hit_kernel<INST, COEF><<<grid, kThreads, 0, s>>>(             \
      box, link, leaves, block, inst_inv, inst_feat, mb_bits, origin,    \
      direction, t_lane, n, hit_out)
    if (inst_inv != nullptr && coef)
      VKPT_PAIR_AH(true, true);
    else if (inst_inv != nullptr)
      VKPT_PAIR_AH(true, false);
    else if (coef)
      VKPT_PAIR_AH(false, true);
    else
      VKPT_PAIR_AH(false, false);
#undef VKPT_PAIR_AH
  }
  return (int)cudaGetLastError();
}
