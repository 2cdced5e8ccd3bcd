// Shared pieces of the traversal kernels (stack_walk.cuh for
// stack_traverse.cu and pair_traverse.cu, skip_traverse.cu,
// frontier_traverse.cu): constants,
// the ray record (and a channel build's, ChanRay), Möller–Trumbore, the
// leaf-block loop, the coefficient leaf test, the instanced leaf decode,
// the slab test and a channel build's channels.  The plain
// PyTorch versions in ops/stack_traverse.py, ops/frontier.py,
// ops/mxu_mt.py, ops/traverse.py and ops/skip_traverse.py perform the
// same float operations in the same order; the sources are built with
// -fmad=false so no product is contracted into an FMA, which keeps t, u
// and v bitwise equal to them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBig = 3e38f;
constexpr float kTmin = 0.001f;
constexpr float kMissT = 1e32f;
constexpr float kInvEps = 1e-20f;
constexpr int kThreads = 128;
constexpr int kEmpty = -2147483647 - 1;  // INT32_MIN: an empty n-ary slot

__device__ __forceinline__ float safe_inv(float d) {
  float s = d >= 0.0f ? kInvEps : -kInvEps;
  return 1.0f / (fabsf(d) < kInvEps ? s : d);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oxi, oyi, ozi;
  float tl;
};

// The ray of a channel build (stack_walk.cuh Chan): a Ray and the closed
// lower bound tn = max(t_near, kTmin) of its t-window (channel 11).  The
// functions below take it through overloads and deduced ray types, so
// the default builds compile from Ray alone.
struct ChanRay : Ray {
  float tn;
  // run_rays loads a lane's Ray into it and sets tn after.
  __device__ __forceinline__ ChanRay& operator=(const Ray& x) {
    static_cast<Ray&>(*this) = x;
    return *this;
  }
};

// The closed lower bound of a ray's t-window: kTmin, or a channel
// build's r.tn.  The coefficient test reads it, so one body serves both
// rays and the default builds fold it to the constant.
__device__ __forceinline__ float lo(const Ray&) { return kTmin; }
__device__ __forceinline__ float lo(const ChanRay& r) { return r.tn; }

// Möller–Trumbore with backface culling, term for term as
// ops/intersect.py and pallas_pair.py:970-992.  Returns true when the
// triangle passes the accept window below `lim`.  SIGNED (instanced
// leaves, pallas_pair.py:697-700): the front test is det * det_sign > 0,
// world winding under a mirroring instance transform.
// EARLY returns at the first failed test (back face, then u, then v),
// before the division and the later products; t, u, v are then
// undefined.  The outcome is the same: u > 1 fails u + v <= 1 whenever
// v >= 0 (rounding is monotonic).
template <bool SIGNED, bool EARLY = false>
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
  if (EARLY && !front) return false;
  const float inv_det = 1.0f / (front ? det : 1.0f);
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  if (EARLY && !(u >= 0.0f && u <= 1.0f)) return false;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  if (EARLY && !(v >= 0.0f && u + v <= 1.0f)) return false;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  // The Pallas kernels also test t >= tnear, with tnear = TMIN here:
  // implied by t > TMIN.
  return front && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTmin &&
         t < lim;
}

// mt of a channel build: the window's lower bound t >= r.tn too
// (pallas_pair.py:713).
template <bool SIGNED, bool EARLY = false>
__device__ __forceinline__ bool mt(const ChanRay& r, const float* tri,
                                   float lim, float det_sign, float& t,
                                   float& u, float& v) {
  return mt<SIGNED, EARLY>(static_cast<const Ray&>(r), tri, lim, det_sign, t,
                           u, v) &&
         t >= r.tn;
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
// R: Ray, or a channel build's ChanRay.
template <bool ANY, bool SIGNED, bool EARLY = false, class R = Ray>
__device__ __forceinline__ void leaf_block(const R& r,
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
        if (mt<SIGNED, EARLY>(r, w + 9 * k, lim, det_sign, t, u, v)) {
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
      if (mt<SIGNED, EARLY>(r, w, lim, det_sign, t, u, v)) {
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

// -- Coefficient leaves (VKPT_MT=mxu; ops/mxu_mt.py) ---------------------
//
// Replaces mxu_mt.mt_coef_visit and mt_coef_visit_anyhit
// (vulkan_pathtracer_tpu/ops/mxu_mt.py:254, :302), which the Pallas quad,
// pair and frontier kernels inline: Möller–Trumbore as dot products of a
// triangle's coefficients with the ray features [d, m, o, 1], m = o x d.
// Of JAX's 40 coefficients per triangle (det, u', v', t' on 10 features)
// 19 can be non-zero, and the zero-free row holds only those, in the
// order of the test: det on d (3), u' on d and m (6), v' on d and m (6),
// t' on o and 1 (4), then a zero — 80 B, five float4.  The sums run in
// f32 on CUDA cores in one order (feature by feature, each product
// rounded; -fmad=false), as the plain versions in ops/mxu_mt.py do.
// The test stops at the first failed condition — det <= 0 (det scaled
// by det_sign on two-level scenes), then u' < 0, then the v' window
// (v' < 0 or u' + v' > det) — reading only the front of the row, and
// computes t' and divides only for a survivor; the outcome is the
// conjunction of the full test, so t, tri and the hit masks are those
// of the plain versions, which compute every sum.

__device__ __forceinline__ void ray_features(const Ray& r, float* f) {
  f[0] = r.dx;
  f[1] = r.dy;
  f[2] = r.dz;
  f[3] = r.oy * r.dz - r.oz * r.dy;
  f[4] = r.oz * r.dx - r.ox * r.dz;
  f[5] = r.ox * r.dy - r.oy * r.dx;
  f[6] = r.ox;
  f[7] = r.oy;
  f[8] = r.oz;
  f[9] = 1.0f;
}

// sum_j c[j] * f[j], j = 0..N-1 in order, each product rounded.
template <int N>
__device__ __forceinline__ float dotn(const float* c, const float* f) {
  float acc = c[0] * f[0];
#pragma unroll
  for (int j = 1; j < N; ++j) acc = acc + c[j] * f[j];
  return acc;
}

// Quad j (0..4) of a zero-free row `q` into c[4j .. 4j + 3].
__device__ __forceinline__ void coef_quad(const float4* __restrict__ q, int j,
                                          float* c) {
  const float4 x = __ldg(q + j);
  c[4 * j + 0] = x.x;
  c[4 * j + 1] = x.y;
  c[4 * j + 2] = x.z;
  c[4 * j + 3] = x.w;
}

// The one-pass bf16 product (VKPT_MXU_PRECISION=default, mxu_mt.py:58-80;
// ops/mxu_mt.py): a bf16 table of the same zero-free rows, 40 B, whose
// quad j is one 8-byte load of four bf16, widened exactly to f32; the
// features rounded to bf16 (round to nearest even) before the sums.  A
// product of two bf16 values is exact in f32, so the sums below are the
// one pass's f32 accumulation, in the f32 tier's order.  The builds run
// on CUDA cores, like the f32 ones; bound: the 40 B rows where the leaf
// loads dominate, else the same operations as the f32 test.  A
// tensor-core design (mma.sync bf16) would not round each add and is a
// candidate for a later redesign.
__device__ __forceinline__ void coef_quad(const uint2* __restrict__ q, int j,
                                          float* c) {
  const uint2 x = __ldg(q + j);
  c[4 * j + 0] = __uint_as_float(x.x << 16);
  c[4 * j + 1] = __uint_as_float(x.x & 0xffff0000u);
  c[4 * j + 2] = __uint_as_float(x.y << 16);
  c[4 * j + 3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ void round_features(float* f) {
#pragma unroll
  for (int j = 0; j < 10; ++j)
    f[j] = __bfloat162float(__float2bfloat16_rn(f[j]));
}

// Leaf block `row` of the coefficient table against features f.
// Closest hit: the candidate with the smallest t inside (TMIN, lim),
// lim = min(t_best, t_lane) at the visit's start, the first triangle on
// a tie (mxu_mt.py:285-291); it replaces the best hit, which it beats by
// construction (pallas_frontier.py:358).  Any hit: det-scaled, no
// division (mxu_mt.py:318-322).  SIGNED scales all four sums by
// det_sign.  AHEAD issues a triangle's five loads before its first test
// (else each before the sum that reads it).  STATS (the statistics
// build): tri_st[0..3] count the triangles tested and those that fail at
// det <= 0, at u' < 0 and at the v' window.  CHAN (a channel build's
// closest hit): a candidate also needs t >= tn, the window's lower bound
// on the divided t, as mt_coef_visit's tnear_f (mxu_mt.py:288).  BF16:
// `coefs` is the bf16 table (rows of five 8-byte quads) and f the
// rounded features (round_features).
template <bool ANY, bool SIGNED, bool AHEAD, bool STATS = false,
          bool CHAN = false, bool BF16 = false>
__device__ __forceinline__ void coef_block(const float* f,
                                           const float* __restrict__ coefs,
                                           int row, int leaf, int block,
                                           float det_sign, float tl, Best& b,
                                           unsigned long long* tri_st =
                                               nullptr,
                                           float tn = kTmin) {
  using Quad = std::conditional_t<BF16, uint2, float4>;
  const Quad* p =
      reinterpret_cast<const Quad*>(coefs) + (size_t)row * block * 5;
  const float lim = ANY ? tl : fminf(b.t, tl);
  float ct = kBig, cu = 0.0f, cv = 0.0f;
  int ck = -1;
  unsigned n_tri = 0, n_back = 0, n_u = 0, n_v = 0;
  for (int k = 0; k < block; ++k) {
    if (STATS) ++n_tri;
    const Quad* q = p + 5 * k;
    float c[20];
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (AHEAD || j == 0) coef_quad(q, j, c);
    float det = dotn<3>(c, f);
    if (SIGNED) det = det * det_sign;
    if (!(det > 0.0f)) {
      if (STATS) ++n_back;
      continue;
    }
    if (!AHEAD) {
      coef_quad(q, 1, c);
      coef_quad(q, 2, c);
    }
    float up = dotn<6>(c + 3, f);
    if (SIGNED) up = up * det_sign;
    if (!(up >= 0.0f)) {
      if (STATS) ++n_u;
      continue;
    }
    if (!AHEAD) coef_quad(q, 3, c);
    float vp = dotn<6>(c + 9, f);
    if (SIGNED) vp = vp * det_sign;
    if (!(vp >= 0.0f && up + vp <= det)) {
      if (STATS) ++n_v;
      continue;
    }
    if (!AHEAD) coef_quad(q, 4, c);
    float tp = dotn<4>(c + 15, f + 6);
    if (SIGNED) tp = tp * det_sign;
    if (ANY) {
      if (tp > kTmin * det && tp < tl * det) {
        b.any = true;
        break;
      }
    } else {
      const float inv = 1.0f / det;
      const float t = tp * inv;
      if (t > kTmin && (!CHAN || t >= tn) && t < lim && t < ct) {
        ct = t;
        ck = k;
        cu = up * inv;
        cv = vp * inv;
      }
    }
  }
  if (STATS) {
    atomicAdd(tri_st + 0, (unsigned long long)n_tri);
    atomicAdd(tri_st + 1, (unsigned long long)n_back);
    atomicAdd(tri_st + 2, (unsigned long long)n_u);
    atomicAdd(tri_st + 3, (unsigned long long)n_v);
  }
  if (!ANY && ck >= 0) {
    b.t = ct;
    b.u = cu;
    b.v = cv;
    b.tri = leaf * block + ck;
  }
}

// The instance's feature transform A applied to the world features f
// (feats_obj = A @ pad16(feats), pallas_pair.py:736-747) into fo, over
// A's 40 entries that can be non-zero (ops/mxu_mt.FEAT_TERMS, ten
// float4): rows 0-2 on d, 3-5 on d and m, 6-8 on o and 1, row 9 on 1;
// returns det_sign (inst_inv[12]), so mirrored instances cull as the
// exact kernels do.
__device__ __forceinline__ float object_features(
    const float* f, const float* __restrict__ inst_inv,
    const float* __restrict__ inst_feat, int inst, float* fo) {
  const float4* A4 = reinterpret_cast<const float4*>(inst_feat) + inst * 10;
  float a[40];
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    const float4 x = __ldg(A4 + q);
    a[4 * q + 0] = x.x;
    a[4 * q + 1] = x.y;
    a[4 * q + 2] = x.z;
    a[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fo[i] = dotn<3>(a + 3 * i, f);
    fo[3 + i] = dotn<6>(a + 9 + 6 * i, f);
    fo[6 + i] = dotn<4>(a + 27 + 4 * i, f + 6);
  }
  fo[9] = a[39] * f[9];
  return __ldg(inst_inv + (size_t)inst * 16 + 12);
}

// The ray in instance `inst`'s object space (pallas_pair.py:661-673 and
// pallas_traverse.py:219-227, the same order of operations) into o;
// returns the instance's det_sign.  R: Ray or ChanRay (its window kept).
template <class R>
__device__ __forceinline__ float object_ray(const R& r,
                                            const float* __restrict__ inst_inv,
                                            int inst, R& o) {
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
  o = r;
  o.ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[9];
  o.oy = m[3] * r.ox + m[4] * r.oy + m[5] * r.oz + m[10];
  o.oz = m[6] * r.ox + m[7] * r.oy + m[8] * r.oz + m[11];
  o.dx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  o.dy = m[3] * r.dx + m[4] * r.dy + m[5] * r.dz;
  o.dz = m[6] * r.dx + m[7] * r.dy + m[8] * r.dz;
  return m[12];
}

// One leaf child: the flat block, or (INST) the instanced decode —
// block row, object-space ray (object_ray) and det_sign.  (Coefficient
// leaves: stack_walk.cuh LeafTest, with coef_block.)
template <bool ANY, bool INST, bool EARLY = false, class R = Ray>
__device__ __forceinline__ void visit_leaf(const R& r,
                                           const float* __restrict__ leaves,
                                           int block,
                                           const float* __restrict__ inst_inv,
                                           int mb_bits, int leaf, Best& b) {
  if (!INST) {
    leaf_block<ANY, false, EARLY>(r, leaves, leaf, leaf, block, 1.0f, b);
    return;
  }
  const int inst = leaf >> mb_bits;
  const int row = leaf & ((1 << mb_bits) - 1);
  R o;
  const float det_sign = object_ray(r, inst_inv, inst, o);
  leaf_block<ANY, true, EARLY>(o, leaves, row, leaf, block, det_sign, b);
}

// Slab test of one child box (lo.xyz, hi.xyz) against t_lim
// (pallas_pair.py:644-651, :779-790), the entry clamped to LO: kTmin
// for a Ray, the window bound r.tn for a channel build's ChanRay
// (pallas_pair.py:783).  Returns the entry distance and whether the box
// is hit.  One body defines both overloads; each is a plain function, as
// a template of the ray type moved the default kernels' SASS.
#define VKPT_DEFINE_SLAB(R, LO)                                         \
  __device__ __forceinline__ bool slab(const R& r, const float* c,      \
                                       float t_lim, float& tn) {        \
    const float t0x = c[0] * r.ix - r.oxi;                              \
    const float t1x = c[3] * r.ix - r.oxi;                              \
    const float t0y = c[1] * r.iy - r.oyi;                              \
    const float t1y = c[4] * r.iy - r.oyi;                              \
    const float t0z = c[2] * r.iz - r.ozi;                              \
    const float t1z = c[5] * r.iz - r.ozi;                              \
    const float n = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),      \
                          fmaxf(fminf(t0z, t1z), LO));                  \
    const float f = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),      \
                          fminf(fmaxf(t0z, t1z), t_lim));               \
    tn = n;                                                             \
    return n <= f;                                                      \
  }
VKPT_DEFINE_SLAB(Ray, kTmin)
VKPT_DEFINE_SLAB(ChanRay, r.tn)
#undef VKPT_DEFINE_SLAB

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

// The channels of a channel build's launch (the Pallas kernels' channels
// 7-11, pallas_traverse.py:118-130): a closed per-lane lower bound t_near
// of the t-window (nullptr: 0), and a seed hit (t, tri, u, v; nullptr:
// none) that the lane's best hit starts from.
struct Channels {
  const float* t_near;
  const float* seed_t;
  const int* seed_tri;
  const float* seed_u;
  const float* seed_v;
};

// Ray i's window bound (ChanRay::tn) and its starting best hit: the seed,
// else a miss.  An inactive lane (t_lane < 0) returns it unchanged.
__device__ __forceinline__ float lane_tnear(const Channels& ch, int64_t i) {
  return ch.t_near == nullptr ? kTmin : fmaxf(ch.t_near[i], kTmin);
}

__device__ __forceinline__ Best lane_seed(const Channels& ch, int64_t i) {
  if (ch.seed_t == nullptr) return Best{kMissT, 0.0f, 0.0f, -1, false};
  return Best{ch.seed_t[i], ch.seed_u[i], ch.seed_v[i], ch.seed_tri[i],
              false};
}

}  // namespace
