// Shared pieces of the traversal kernels (stack_traverse.cu,
// pair_traverse.cu, skip_traverse.cu): constants, the ray record,
// Möller–Trumbore, the leaf-block loop, the instanced leaf decode and
// the slab test.  The plain PyTorch versions in ops/stack_traverse.py,
// ops/traverse.py and ops/skip_traverse.py perform the same float
// operations in the same order; the sources are built with -fmad=false
// so no product is contracted into an FMA, which keeps t, u and v
// bitwise equal to them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// triangle passes the accept window below `lim`.  SIGNED (instanced
// leaves, pallas_pair.py:697-700): the front test is det * det_sign > 0,
// world winding under a mirroring instance transform.
template <bool SIGNED>
__device__ __forceinline__ bool mt(const Ray& r, const float* tri, float lim,
                                   float det_sign, float& t, float& u,
                                   float& v) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool front = SIGNED ? det * det_sign > 0.0f : det > 0.0f;
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

// Intersect leaf block `row` in triangle order; accepted triangles get
// id leaf * block + k (leaf = row for flat tables, the packed
// instance | block value for instanced ones).  The limit tightens as
// hits are accepted (strict <: the first of equal-t triangles wins).
template <bool ANY, bool SIGNED>
__device__ __forceinline__ void leaf_block(const Ray& r,
                                           const float* __restrict__ leaves,
                                           int row, int leaf, int block,
                                           float det_sign, Best& b) {
  const float* base = leaves + (size_t)row * block * 9;
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
        if (mt<SIGNED>(r, w + 9 * k, lim, det_sign, t, u, v)) {
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
      if (mt<SIGNED>(r, w, lim, det_sign, t, u, v)) {
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

// One leaf child: the flat block, or (INST) the instanced decode —
// block row, object-space ray (pallas_pair.py:661-673 and
// pallas_traverse.py:219-227, the same order of operations) and det_sign.
template <bool ANY, bool INST>
__device__ __forceinline__ void visit_leaf(const Ray& r,
                                           const float* __restrict__ leaves,
                                           int block,
                                           const float* __restrict__ inst_inv,
                                           int mb_bits, int leaf, Best& b) {
  if (!INST) {
    leaf_block<ANY, false>(r, leaves, leaf, leaf, block, 1.0f, b);
    return;
  }
  const int inst = leaf >> mb_bits;
  const int row = leaf & ((1 << mb_bits) - 1);
  const float4* mp = reinterpret_cast<const float4*>(inst_inv) + inst * 4;
  float m[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = __ldg(mp + q);
    m[4 * q + 0] = f.x;
    m[4 * q + 1] = f.y;
    m[4 * q + 2] = f.z;
    m[4 * q + 3] = f.w;
  }
  Ray o = r;
  o.ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[9];
  o.oy = m[3] * r.ox + m[4] * r.oy + m[5] * r.oz + m[10];
  o.oz = m[6] * r.ox + m[7] * r.oy + m[8] * r.oz + m[11];
  o.dx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  o.dy = m[3] * r.dx + m[4] * r.dy + m[5] * r.dz;
  o.dz = m[6] * r.dx + m[7] * r.dy + m[8] * r.dz;
  leaf_block<ANY, true>(o, leaves, row, leaf, block, m[12], b);
}

// Slab test of one child box (lo.xyz, hi.xyz) against t_lim
// (pallas_pair.py:644-651, :779-790).  Returns the entry distance and
// whether the box is hit.
__device__ __forceinline__ bool slab(const Ray& r, const float* c,
                                     float t_lim, float& tn) {
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
  tn = n;
  return n <= f;
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

}  // namespace
