// Quad-BVH stack traversal on Hopper: closest hit and any hit.
//
// Replaces the two Pallas TPU kernels of the headline frame:
//   - closest hit: vulkan_pathtracer_tpu/ops/pallas_pair.py
//     _make_nary_kernel (width 4), launched by _nary_traverse via
//     pallas_quad_closest_hit;
//   - any hit: pallas_pair.py _make_nary_anyhit_kernel (width 4),
//     launched by _nary_anyhit via pallas_quad_any_hit.
// The plain PyTorch versions in ops/stack_traverse.py perform the same
// float operations in the same order; this file is built with
// -fmad=false so no product is contracted into an FMA, which keeps t,
// u and v bitwise equal to them.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStackSize = 288;          // 3 * STACK_CAP (per-ray entries)
constexpr int kEmpty = -2147483647 - 1;  // INT32_MIN: empty slot
constexpr float kBig = 3e38f;
constexpr float kTmin = 0.001f;
constexpr float kMissT = 1e32f;
constexpr float kInvEps = 1e-20f;
constexpr int kThreads = 128;

__device__ __forceinline__ float safe_inv(float d) {
  float s = d >= 0.0f ? kInvEps : -kInvEps;
  return 1.0f / (fabsf(d) < kInvEps ? s : d);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oxi, oyi, ozi;
  float tl;
};

// Möller–Trumbore with backface culling, term for term as
// ops/intersect.py and pallas_pair.py:970-992.  Returns true when the
// triangle passes the accept window below `lim`.
__device__ __forceinline__ bool mt(const Ray& r, const float* tri, float lim,
                                   float& t, float& u, float& v) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool front = det > 0.0f;
  const float inv_det = 1.0f / (front ? det : 1.0f);
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  // The Pallas kernels also test t >= tnear, with tnear = TMIN here:
  // implied by t > TMIN.
  return front && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTmin &&
         t < lim;
}

// Closest-hit state; ANY stops at the first accepted triangle.
struct Best {
  float t, u, v;
  int tri;
  bool any;
};

// Intersect one leaf block in triangle order.  The limit tightens as
// hits are accepted (strict <: the first of equal-t triangles wins).
template <bool ANY>
__device__ __forceinline__ void leaf_block(const Ray& r,
                                           const float* __restrict__ leaves,
                                           int leaf, int block, Best& b) {
  const float* base = leaves + (size_t)leaf * block * 9;
  float t, u, v;
  if ((block & 3) == 0) {
    // Four triangles are 36 floats = nine float4 loads.
    const float4* p = reinterpret_cast<const float4*>(base);
    for (int g = 0; g < block / 4; ++g) {
      float w[36];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float4 f = __ldg(p + g * 9 + q);
        w[4 * q + 0] = f.x;
        w[4 * q + 1] = f.y;
        w[4 * q + 2] = f.z;
        w[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lim = ANY ? r.tl : fminf(b.t, r.tl);
        if (mt(r, w + 9 * k, lim, t, u, v)) {
          if (ANY) {
            b.any = true;
            return;
          }
          b.t = t;
          b.u = u;
          b.v = v;
          b.tri = leaf * block + g * 4 + k;
        }
      }
    }
  } else {
    for (int k = 0; k < block; ++k) {
      float w[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) w[q] = __ldg(base + 9 * k + q);
      const float lim = ANY ? r.tl : fminf(b.t, r.tl);
      if (mt(r, w, lim, t, u, v)) {
        if (ANY) {
          b.any = true;
          return;
        }
        b.t = t;
        b.u = u;
        b.v = v;
        b.tri = leaf * block + k;
      }
    }
  }
}

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
        const float* c = bx + 6 * s;
        const float t0x = c[0] * r.ix - r.oxi;
        const float t1x = c[3] * r.ix - r.oxi;
        const float t0y = c[1] * r.iy - r.oyi;
        const float t1y = c[4] * r.iy - r.oyi;
        const float t0z = c[2] * r.iz - r.ozi;
        const float t1z = c[5] * r.iz - r.ozi;
        const float n = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), kTmin));
        const float f = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), t_lim));
        tn[s] = n;
        hit[s] = (n <= f) && (lk[s] != kEmpty);
      }
      // Leaf slots first, in slot order.
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (hit[s] && lk[s] < 0) {
          leaf_block<ANY>(r, leaves, -lk[s] - 1, block, b);
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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        const float* __restrict__ t_lane,
                                        int64_t i) {
  Ray r;
  r.ox = origin[3 * i + 0];
  r.oy = origin[3 * i + 1];
  r.oz = origin[3 * i + 2];
  r.dx = direction[3 * i + 0];
  r.dy = direction[3 * i + 1];
  r.dz = direction[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.oxi = r.ox * r.ix;
  r.oyi = r.oy * r.iy;
  r.ozi = r.oz * r.iz;
  r.tl = t_lane[i];
  return r;
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
