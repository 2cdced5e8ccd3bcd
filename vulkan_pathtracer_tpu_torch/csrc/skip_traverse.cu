// Skip-pointer (stackless) closest hit on Hopper: the binary preorder
// walk and the 8-wide tile walk, one ray per thread.
//
// skip_closest_hit_kernel<INST> replaces the Pallas TPU kernels that
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
// wide_closest_hit_kernel replaces kernel 8, _make_wide_kernel
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
// What bounds it on this card: dependent loads and divergence, as for
// the stack kernels — every visit is a dependent 32 B (binary) or
// 256 B (wide) load whose address comes from the previous visit, and a
// skip walk visits more nodes than a near-first stack walk (no culling
// of far subtrees by entry distance, a fixed per-octant child order).
// The tables of the 1080p atrium (about 5 MB of records, 4 MB of
// tiles, 14 MB of leaves) sit in the 50 MB L2.
//
// What the design does about it: no stack and no shared memory (one
// cursor register), two 16 B __ldg loads per binary visit and sixteen
// per tile, one ray per thread so a thread never waits on another's
// branch, and rays sorted by the caller (2D tiles, the 6d Morton key).

#include "traverse.cuh"

namespace {

__device__ __forceinline__ int octant_of(const Ray& r) {
  return (r.dx < 0.0f ? 1 : 0) | (r.dy < 0.0f ? 2 : 0) |
         (r.dz < 0.0f ? 4 : 0);
}

// Slab test with the XLA / wide-kernel arithmetic (b - o) * inv
// (pallas_traverse.py:1347-1362).
__device__ __forceinline__ bool slab_sub(const Ray& r, const float* c,
                                         float t_lim) {
  const float t0x = (c[0] - r.ox) * r.ix;
  const float t1x = (c[3] - r.ox) * r.ix;
  const float t0y = (c[1] - r.oy) * r.iy;
  const float t1y = (c[4] - r.oy) * r.iy;
  const float t0z = (c[2] - r.oz) * r.iz;
  const float t1z = (c[5] - r.oz) * r.iz;
  const float n = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                        fmaxf(fminf(t0z, t1z), kTmin));
  const float f = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                        fminf(fmaxf(t0z, t1z), t_lim));
  return n <= f;
}

template <bool INST>
__global__ void __launch_bounds__(kThreads)
skip_closest_hit_kernel(const float* __restrict__ nodes, int n_nodes,
                        const float* __restrict__ leaves, int block,
                        const float* __restrict__ inst_inv, int mb_bits,
                        const float* __restrict__ origin,
                        const float* __restrict__ direction,
                        const float* __restrict__ t_lane, int64_t n,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(origin, direction, t_lane, i);
  Best b{kMissT, 0.0f, 0.0f, -1, false};
  if (r.tl >= 0.0f) {
    const float4* rec = reinterpret_cast<const float4*>(nodes) +
                        (size_t)octant_of(r) * n_nodes * 2;
    int cur = 0;
    while (cur < n_nodes) {
      const float4 a = __ldg(rec + 2 * cur);
      const float4 c = __ldg(rec + 2 * cur + 1);
      const float box[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
      const int skip = __float_as_int(c.z);
      const int leaf = __float_as_int(c.w);
      float tn;
      const bool hit = slab(r, box, fminf(b.t, r.tl), tn);
      if (leaf >= 0) {
        if (hit) {
          if (INST)
            visit_leaf<false, true>(r, leaves, block, inst_inv, mb_bits, leaf,
                                    b);
          else   // the block's first triangle: row leaf / block
            leaf_block<false, false>(r, leaves, leaf / block, leaf / block,
                                     block, 1.0f, b);
        }
        cur = skip;
      } else {
        cur = hit ? cur + 1 : skip;
      }
    }
  }
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

__global__ void __launch_bounds__(kThreads)
wide_closest_hit_kernel(const float* __restrict__ tiles, int n_wide,
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
  if (r.tl >= 0.0f) {
    const float4* base = reinterpret_cast<const float4*>(tiles) +
                         (size_t)octant_of(r) * n_wide * 16;
    int cur = 0;
    while (cur < n_wide) {
      const float4* tile = base + (size_t)cur * 16;
      // Every slot is tested against t_best as it was at node entry.
      const float t_lim = fminf(b.t, r.tl);
      unsigned leaf_hits = 0;
      bool descend = false;
      int first[8];
      int skip = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float4 lo = __ldg(tile + 2 * s);
        const float4 hi = __ldg(tile + 2 * s + 1);
        const float box[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
        const bool hit = slab_sub(r, box, t_lim);
        const float word = hi.z;
        if (hit && word >= 0.0f) leaf_hits |= 1u << s;
        if (hit && word == -1.0f) descend = true;
        first[s] = (int)word;
        if (s == 0) skip = (int)hi.w;
      }
      // Leaf slots in slot order; each tightens the next one's limit.
#pragma unroll 1
      for (unsigned m = leaf_hits; m != 0; m &= m - 1) {
        const int row = first[__ffs(m) - 1] / block;
        leaf_block<false, false>(r, leaves, row, row, block, 1.0f, b);
      }
      cur = descend ? cur + 1 : skip;
    }
  }
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

// C launchers: pointers, sizes and the stream in; cudaGetLastError()
// out (0 = the launch was accepted).  inst_inv == nullptr selects the
// flat skip kernel.
extern "C" int vkpt_skip_closest_hit(const float* nodes, int n_nodes,
                                     const float* leaves, int block,
                                     const float* inst_inv, int mb_bits,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
    if (inst_inv != nullptr)
      skip_closest_hit_kernel<true><<<grid, kThreads, 0, s>>>(
          nodes, n_nodes, leaves, block, inst_inv, mb_bits, origin,
          direction, t_lane, n, t_out, tri_out, u_out, v_out);
    else
      skip_closest_hit_kernel<false><<<grid, kThreads, 0, s>>>(
          nodes, n_nodes, leaves, block, inst_inv, mb_bits, origin,
          direction, t_lane, n, t_out, tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int vkpt_wide_closest_hit(const float* tiles, int n_wide,
                                     const float* leaves, int block,
                                     const float* origin,
                                     const float* direction,
                                     const float* t_lane, int64_t n,
                                     float* t_out, int* tri_out, float* u_out,
                                     float* v_out, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    wide_closest_hit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        tiles, n_wide, leaves, block, origin, direction, t_lane, n, t_out,
        tri_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
