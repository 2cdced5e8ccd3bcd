// The wavefront's shading chain on Hopper: one thread shades one lane,
// and every intermediate stays in registers.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it.  The plain PyTorch chain it stands for (render/wavefront.py
// _shade_and_extend, _next_segment and _add_sky; render/shading.py
// get_triangle_data, get_material_data, get_emissive_lean; ops/brdf.py;
// ops/rng.py pcg2d) runs as about 200 elementwise launches per shading
// call on the card, each over every lane and each through device memory.
//   - shade_extend_kernel: one bounce's shading of a lane set.  The sky
//     on the missed lanes and the emissive term on the hit lanes go into
//     the color; unless LAST, the hit's attributes and material are
//     fetched (the flat row, or on a two-level scene the decoded
//     (instance, mesh block) row under the instance's normal matrix),
//     the BRDF inputs are formed, and the next segment is drawn
//     (next_segment below).  LAST fetches the emissive factor alone.
//     A textured scene's build multiplies the factors by their bilinear
//     texels and applies the normal map (get_material_data).
//   - pixel_shade_kernel: a joint batch's bounce 0, once per pixel: the
//     color its frames add, and the surface their draws read.
//   - joint_draw_kernel: the next segment of lanes whose shading inputs
//     are given (ShadingInfo); lane i reads them at i mod `period`, so a
//     joint batch's B frames draw from one per-pixel copy.
//   - anyhit_sky_kernel: the emissive-free last bounce, the sky on the
//     lanes the any-hit kernel found missed; every lane ends.
//
// What bounds it on this card: bytes.  A lane reads its hit and state
// (81 B) and writes its new state (65 B); the attribute rows (52 of 136
// B) and material rows (24 B) its lanes hit are read once each.  Bounce
// 0 of the 1080p atrium moves 0.30 GB, 0.09 ms at 3.35 TB/s; the kernel
// takes 0.12 ms (PERF.md section 6).  The state stays in (lanes, 3)
// arrays as the program keeps it; the kernels write a lane set in place
// where the caller hands them its own state (ops/shade.py), so no
// copy-back follows.
//
// Floating point: each output is bitwise the plain chain's on the same
// device.  The chain's float operations run in the plain chain's order,
// one rounding each (-fmad=false), with PyTorch's CUDA semantics where
// they are not IEEE's plain operation: torch.rsqrt is rsqrtf; a division
// by a Python number multiplies by its float reciprocal
// (div_true_kernel_cuda); `c / t` is reciprocal(t) * c; clamp passes a
// NaN through.  Built for the CPU (tests/test_torch_shade_host.py, g++
// against host_mock.h) the same source takes PyTorch's CPU semantics
// instead: 1 / sqrtf, a true division, and PyTorch's CPU sqrt, sin and
// cos where the build names them (VKPT_HOST_SQRT, _SIN, _COS).  The uint32
// RNG state rides in int64 words, as the program keeps it.

#include <cuda_runtime.h>

#include <math.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr double kPi = 3.141592653589793238462643;   // ops/brdf.py M_PI
constexpr float kMissT = 1e32f;                      // ops/intersect.py
constexpr float kEmissiveScale = 10.0f;
constexpr float kOriginOffset = (float)1e-5;
constexpr float kRoughnessFloor = (float)0.006;
constexpr float kF0Dielectric = (float)0.02;
constexpr float kTiny = (float)1e-30;
constexpr unsigned kMul = 1664525u, kInc = 1013904223u;   // ops/rng.py
constexpr float kToFloat = (float)2.32830643654e-10;
constexpr int kAttrCols = 34;   // tri_attr row (models/device_scene.py)
constexpr int kMatCols = 8;     // mat_packed row
constexpr int kThreads = 256;

// -- PyTorch's elementwise semantics ------------------------------------

#ifdef __CUDACC__
__device__ __forceinline__ float t_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ float t_div_number(float x, float c) {
  return x * (1.0f / c);
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float t_sin(float x) { return sinf(x); }
__device__ __forceinline__ float t_cos(float x) { return cosf(x); }
#else
// PyTorch's CPU sqrt, sin and cos (vectorized, SLEEF) differ from glibc's
// by an ulp for some arguments: a host build may name its own.  Its rsqrt
// is 1 / the correctly rounded sqrt.
#ifndef VKPT_HOST_SQRT
#define VKPT_HOST_SQRT sqrtf
#define VKPT_HOST_SIN sinf
#define VKPT_HOST_COS cosf
#endif
using std::isnan;
inline float t_rsqrt(float x) { return 1.0f / sqrtf(x); }
inline float t_sqrt(float x) { return VKPT_HOST_SQRT(x); }
inline float t_div_number(float x, float c) { return x / c; }
inline float t_clamp_min(float v, float lo) { return v < lo ? lo : v; }
inline float t_clamp_max(float v, float hi) { return hi < v ? hi : v; }
inline float t_sin(float x) { return VKPT_HOST_SIN(x); }
inline float t_cos(float x) { return VKPT_HOST_COS(x); }
#endif

__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return t_clamp_max(t_clamp_min(v, lo), hi);
}

// amax's step: a NaN wins.
__device__ __forceinline__ float t_max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// `c / t` for a Python number c: reciprocal(t) * c.
__device__ __forceinline__ float t_rdiv(float c, float t) {
  return (1.0f / t) * c;
}

// -- ops/vecmath.py -------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float r = t_rsqrt(dot(v, v));
  return V3{v.x * r, v.y * r, v.z * r};
}

__device__ __forceinline__ V3 select(bool c, V3 a, V3 b) {
  return c ? a : b;
}

// -- ops/rng.py pcg2d ----------------------------------------------------

struct Draw {
  unsigned sx, sy;
  float fx, fy;
};

__device__ __forceinline__ Draw pcg2d(unsigned sx, unsigned sy) {
  sx = sx * kMul + kInc;
  sy = sy * kMul + kInc;
  sx = sx + kMul * sy;
  sy = sy + kMul * sx;
  sx = sx ^ (sx >> 16);
  sy = sy ^ (sy >> 16);
  sx = sx + kMul * sy;
  sy = sy + kMul * sx;
  sx = sx ^ (sx >> 16);
  sy = sy ^ (sy >> 16);
  return Draw{sx, sy, (float)sx * kToFloat, (float)sy * kToFloat};
}

// -- ops/brdf.py ----------------------------------------------------------

struct Shading {
  V3 normal, out_dir;
  float lambert_out;
  V3 diffuse_albedo, fresnel_0;
  float roughness;
};

__device__ __forceinline__ float luminance(V3 c) {
  return c.x * (float)0.2126 + c.y * (float)0.7152 + c.z * (float)0.0722;
}

__device__ __forceinline__ float diffuse_probability(const Shading& s) {
  return t_clamp_max(luminance(s.diffuse_albedo), 0.5f);
}

__device__ __forceinline__ float fifth(float cosine) {
  const float factor = 1.0f - cosine;
  const float sq = factor * factor;
  return sq * sq * factor;
}

__device__ V3 brdf(const Shading& s, V3 light) {
  const float ndl = dot(s.normal, light);
  const float ndv = s.lambert_out;
  const V3 hv = normalize(V3{light.x + s.out_dir.x, light.y + s.out_dir.y,
                               light.z + s.out_dir.z});
  const float hdv = dot(hv, s.out_dir);
  const float f90 = (hdv * hdv) * (2.0f * s.roughness) + 0.5f;
  const float f5v = fifth(ndv), f5l = fifth(ndl);
  const float diffuse_fresnel =
      ((1.0f - f5v) + f90 * f5v) * ((1.0f - f5l) + f90 * f5l);
  const float hdn = dot(hv, s.normal);
  const float r2 = s.roughness * s.roughness;
  const float den = hdn * (r2 - 1.0f) + 1.0f;
  const float distribution = r2 / (den * den);
  const float masking = ndl * t_sqrt((ndv - r2 * ndv) * ndv + r2);
  const float shadowing = ndv * t_sqrt((ndl - r2 * ndl) * ndl + r2);
  const float geometry = t_rdiv(0.5f, masking + shadowing);
  const float f5s = fifth(t_clamp_min(hdv, 0.0f));
  const float dg = distribution * geometry;
  const float pi = (float)kPi;
  auto channel = [&](float albedo, float f0) {
    const float r = diffuse_fresnel * albedo + dg * (f0 * (1.0f - f5s) + f5s);
    return t_div_number(r, pi);
  };
  const bool below = !(isnan(ndl) || isnan(ndv)) && fminf(ndl, ndv) < 0.0f;
  if (below) return V3{0.0f, 0.0f, 0.0f};
  return V3{channel(s.diffuse_albedo.x, s.fresnel_0.x),
            channel(s.diffuse_albedo.y, s.fresnel_0.y),
            channel(s.diffuse_albedo.z, s.fresnel_0.z)};
}

// get_shading_space's columns (col2 is the normal).
struct Frame {
  V3 c0, c1, c2;
};

__device__ __forceinline__ Frame shading_space(V3 n) {
  const float sign = n.z > 0.0f ? 1.0f : -1.0f;
  const float a = t_rdiv(-1.0f, sign + n.z);
  const float b = n.x * n.y * a;
  return Frame{V3{1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x},
               V3{b, sign + n.y * n.y * a, -n.y}, n};
}

__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  return V3{f.c0.x * v.x + f.c1.x * v.y + f.c2.x * v.z,
            f.c0.y * v.x + f.c1.y * v.y + f.c2.y * v.z,
            f.c0.z * v.x + f.c1.z * v.y + f.c2.z * v.z};
}

__device__ V3 sample_brdf(const Shading& s, float rx, float ry) {
  const Frame f = shading_space(s.normal);
  const float dp = diffuse_probability(s);
  const float phi_scale = (float)(2.0 * kPi);
  // The diffuse branch: a cosine hemisphere sample.
  const float phi_d = phi_scale * (rx / t_clamp_min(dp, kTiny));
  const float radius = t_sqrt(ry);
  const V3 psa{radius * t_cos(phi_d), radius * t_sin(phi_d),
               t_sqrt(1.0f - radius * radius)};
  const V3 diffuse_dir = to_world(f, psa);
  // The specular branch: GGX visible normals in the shading frame.
  const float rx_s = (rx - dp) / (1.0f - dp);
  const V3 view{dot(f.c0, s.out_dir), dot(f.c1, s.out_dir),
                dot(f.c2, s.out_dir)};
  const float r = s.roughness;
  const V3 tv = normalize(V3{view.x * r, view.y * r, view.z});
  const float phi = phi_scale * rx_s;
  const float z = 1.0f - ry * (1.0f + tv.z);
  const float sin_theta = t_sqrt(t_clamp_min(1.0f - z * z, 0.0f));
  const V3 summed{sin_theta * t_cos(phi) + tv.x,
                  sin_theta * t_sin(phi) + tv.y, z + tv.z};
  const V3 h = normalize(V3{summed.x * r, summed.y * r, summed.z});
  const float vh2 = 2.0f * dot(view, h);
  const V3 light{vh2 * h.x - view.x, vh2 * h.y - view.y, vh2 * h.z - view.z};
  return rx < dp ? diffuse_dir : to_world(f, light);
}

__device__ float brdf_density(const Shading& s, V3 dir) {
  const float dp = diffuse_probability(s);
  const V3 hv = normalize(
      V3{dir.x + s.out_dir.x, dir.y + s.out_dir.y, dir.z + s.out_dir.z});
  const float hdv = dot(hv, s.out_dir);
  const float hdn = dot(hv, s.normal);
  const float ndv = s.lambert_out;
  const float r2 = s.roughness * s.roughness;
  const float inv = 1.0f - r2;
  const float denominator = ndv + t_sqrt(r2 + inv * ndv * ndv);
  const float d_vis =
      t_clamp_min(hdv, 0.0f) * (float)(2.0 / kPi) / denominator;
  const float m = 1.0f - inv * hdn * hdn;
  float vndf = d_vis * r2 / (m * m);
  if (hdn < 0.0f) vndf = 0.0f;
  const float specular = vndf / (4.0f * hdv);
  const float diffuse =
      t_div_number(t_clamp_min(dot(s.normal, dir), 0.0f), (float)kPi);
  return specular * (1.0f - dp) + diffuse * dp;
}

// -- render/wavefront.py ----------------------------------------------------

// A lane's path state.
struct State {
  V3 origin, direction, atten;
  unsigned sx, sy;
  bool alive;
};

// _next_segment: the hit lanes' next segment; with RR, Russian roulette
// ends some of the surviving paths.
template <bool RR>
__device__ __forceinline__ void next_segment(const Shading& s, V3 hit_point,
                                             bool did_hit, State& st) {
  const Draw d = pcg2d(st.sx, st.sy);
  if (did_hit) {
    st.sx = d.sx;
    st.sy = d.sy;
  }
  const V3 dir = sample_brdf(s, d.fx, d.fy);
  const float density = brdf_density(s, dir);
  const float lambert_in = dot(s.normal, dir);
  const V3 f = brdf(s, dir);
  const float pdf = t_clamp_min(density, kTiny);
  bool survive = did_hit && !(lambert_in <= 0.0f);
  if (survive) {
    st.atten = V3{st.atten.x * (f.x * lambert_in / pdf),
                  st.atten.y * (f.y * lambert_in / pdf),
                  st.atten.z * (f.z * lambert_in / pdf)};
  }
  st.origin = select(did_hit, hit_point, st.origin);
  st.direction = select(did_hit, dir, st.direction);
  if (RR) {
    const float p = t_clamp(
        t_max_nan(t_max_nan(st.atten.x, st.atten.y), st.atten.z), 0.05f,
        1.0f);
    const Draw q = pcg2d(st.sx, st.sy);
    if (survive) {
      st.sx = q.sx;
      st.sy = q.sy;
    }
    const bool keep = survive && !(q.fx >= p);
    if (keep)
      st.atten = V3{st.atten.x / p, st.atten.y / p, st.atten.z / p};
    survive = keep;
  }
  st.alive = survive;
}

// sky_color (ray_gen.rgen:65-70) through `atten`.
struct Sky {
  float white[3], blue[3];
};

__device__ __forceinline__ V3 sky_term(const Sky& sky, V3 atten, V3 dir) {
  const float t = 0.5f * (dir.y + 1.0f);
  const float w = 1.0f - t;
  return V3{atten.x * (sky.white[0] * w + sky.blue[0] * t),
            atten.y * (sky.white[1] * w + sky.blue[1] * t),
            atten.z * (sky.white[2] * w + sky.blue[2] * t)};
}

__device__ __forceinline__ V3 add_masked(V3 c, bool m, V3 v) {
  return V3{c.x + (m ? v.x : 0.0f), c.y + (m ? v.y : 0.0f),
            c.z + (m ? v.z : 0.0f)};
}

// unpackUnorm4x8's byte k of a uint32 word held in an int64.
__device__ __forceinline__ float unorm8(long long word, int k) {
  return t_div_number((float)((word >> (8 * k)) & 0xFF), 255.0f);
}

__device__ __forceinline__ V3 unorm8x3(long long word) {
  return V3{unorm8(word, 0), unorm8(word, 1), unorm8(word, 2)};
}

__device__ __forceinline__ V3 mul3(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}

// -- ops/texture.py --------------------------------------------------------

// The texel pool: (P, 4) bytes, each texture's first texel, width and
// height.
struct Textures {
  const uint8_t* texels;
  const int *offset, *width, *height;
};

// torch.remainder of int32s: the sign of the divisor.
__device__ __forceinline__ int t_remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// sample_bilinear's r, g, b (its alpha is read by no caller): repeat
// wrap, the four texels as byte * (1.0 / 255.0), mixed in x then y.
__device__ V3 sample_bilinear(const Textures& tx, long long index, float uvx,
                              float uvy) {
  const int off = __ldg(tx.offset + index), w = __ldg(tx.width + index),
            h = __ldg(tx.height + index);
  const float x = uvx * (float)w - 0.5f;
  const float y = uvy * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = t_remainder((int)x0, w), x1i = t_remainder((int)(x0 + 1.0f), w);
  const int y0i = t_remainder((int)y0, h), y1i = t_remainder((int)(y0 + 1.0f), h);
  const float byte = (float)(1.0 / 255.0);
  auto fetch = [&](int xi, int yi) {
    const uint8_t* p = tx.texels + 4 * (int64_t)(off + yi * w + xi);
    return V3{(float)p[0] * byte, (float)p[1] * byte, (float)p[2] * byte};
  };
  const V3 a = fetch(x0i, y0i), b = fetch(x1i, y0i), c = fetch(x0i, y1i),
           d = fetch(x1i, y1i);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  auto mix2 = [&](float p00, float p10, float p01, float p11) {
    const float top = p00 * gx + p10 * fx;
    const float bot = p01 * gx + p11 * fx;
    return top * gy + bot * fy;
  };
  return V3{mix2(a.x, b.x, c.x, d.x), mix2(a.y, b.y, c.y, d.y),
            mix2(a.z, b.z, c.z, d.z)};
}

// -- render/shading.py -----------------------------------------------------

struct Scene {
  const float* tri_attr;           // (T, 34)
  const long long* mat_packed;     // (M, 8) uint32 words
  const int* tri_material;         // (T,), flat scenes' last bounce
  const float* inst_nrm;           // (I, 9), two-level scenes
  int block, mb_bits;              // two-level scenes
  Textures tex;                    // textured scenes
};

__device__ __forceinline__ V3 xform(const float* nrm, V3 v) {
  return V3{nrm[0] * v.x + nrm[1] * v.y + nrm[2] * v.z,
            nrm[3] * v.x + nrm[4] * v.y + nrm[5] * v.z,
            nrm[6] * v.x + nrm[7] * v.y + nrm[8] * v.z};
}

// A hit's surface: its emissive factor and, unless only that was asked
// for, its BRDF inputs and the next segment's origin.
struct Surface {
  V3 emissive;
  Shading s;
  V3 hit_point;
};

// get_triangle_data, get_material_data, _shading_info and _hit_point of
// the hit (t, tri, u, v) of the ray (origin, direction).  The attribute
// row is the flat row, or the two-level scene's object-space row of
// (instance << mb_bits | mesh block) * block + k under the instance's
// normal matrix.  TEX: the factors times their textures and the normal
// map; the texels are read where `texels` (shade_extend_kernel: on hit
// lanes alone, as its outputs mask the others' surface).  EMISSIVE_ONLY:
// the last bounce's fetch; a flat textureless scene reads its material
// id from tri_material (get_emissive_lean).
template <bool INST, bool TEX, bool EMISSIVE_ONLY>
__device__ __forceinline__ Surface surface(const Scene& sc, int tri32,
                                           float t, float u, float v,
                                           V3 origin, V3 direction,
                                           bool texels) {
  const int64_t tri = max(tri32, 0);
  const float* row;
  const float* nrm = nullptr;
  if (INST) {
    const int64_t vblock = tri / sc.block;
    row = sc.tri_attr + ((vblock & ((1ll << sc.mb_bits) - 1)) * sc.block +
                         (tri - vblock * sc.block)) * kAttrCols;
    nrm = sc.inst_nrm + (vblock >> sc.mb_bits) * 9;
  } else {
    row = sc.tri_attr + tri * kAttrCols;
  }
  const int64_t material =
      (EMISSIVE_ONLY && !INST && !TEX) ? __ldg(sc.tri_material + tri)
                                       : __float_as_int(__ldg(row + 30));
  const long long* mrow = sc.mat_packed + material * kMatCols;
  const float w0 = 1.0f - u - v;
  float uvx = 0.0f, uvy = 0.0f;
  if (TEX) {
    uvx = __ldg(row + 21) * w0 + __ldg(row + 23) * u + __ldg(row + 25) * v;
    uvy = __ldg(row + 22) * w0 + __ldg(row + 24) * u + __ldg(row + 26) * v;
  }
  Surface out;
  out.emissive = unorm8x3(__ldg(mrow + 2));
  if (TEX && texels)
    out.emissive =
        mul3(out.emissive, sample_bilinear(sc.tex, __ldg(mrow + 5), uvx, uvy));
  if (EMISSIVE_ONLY) return out;
  // get_triangle_data: the interpolated shading normal and tangent, the
  // geometry normal (each under the instance's normal matrix on
  // two-level scenes).
  V3 normal{__ldg(row + 0) * w0 + __ldg(row + 3) * u + __ldg(row + 6) * v,
            __ldg(row + 1) * w0 + __ldg(row + 4) * u + __ldg(row + 7) * v,
            __ldg(row + 2) * w0 + __ldg(row + 5) * u + __ldg(row + 8) * v};
  V3 gn{__ldg(row + 27), __ldg(row + 28), __ldg(row + 29)};
  float m[9];
  if (INST) {
    for (int k = 0; k < 9; ++k) m[k] = __ldg(nrm + k);
    normal = xform(m, normal);
    gn = normalize(xform(m, gn));
  }
  normal = normalize(normal);
  // get_material_data.
  const long long mr_word = __ldg(mrow + 1);
  V3 albedo = unorm8x3(__ldg(mrow + 0));
  float roughness = unorm8(mr_word, 1), metallic = unorm8(mr_word, 2);
  if (TEX && texels) {
    albedo = mul3(albedo, sample_bilinear(sc.tex, __ldg(mrow + 3), uvx, uvy));
    const V3 mr = sample_bilinear(sc.tex, __ldg(mrow + 4), uvx, uvy);
    roughness = roughness * mr.y;
    metallic = metallic * mr.z;
    if (__ldg(mrow + 7) != 0) {   // the normal map, not re-normalized
      const V3 nt = sample_bilinear(sc.tex, __ldg(mrow + 6), uvx, uvy);
      const V3 n_ts = normalize(V3{2.0f * nt.x - 1.0f, 2.0f * nt.y - 1.0f,
                                   2.0f * nt.z - 1.0f});
      V3 tangent{
          __ldg(row + 9) * w0 + __ldg(row + 13) * u + __ldg(row + 17) * v,
          __ldg(row + 10) * w0 + __ldg(row + 14) * u + __ldg(row + 18) * v,
          __ldg(row + 11) * w0 + __ldg(row + 15) * u + __ldg(row + 19) * v};
      const float handedness =
          __ldg(row + 12) * w0 + __ldg(row + 16) * u + __ldg(row + 20) * v;
      if (INST) tangent = xform(m, tangent);
      tangent = normalize(tangent);
      const V3 bitangent{
          (normal.y * tangent.z - normal.z * tangent.y) * handedness,
          (normal.z * tangent.x - normal.x * tangent.z) * handedness,
          (normal.x * tangent.y - normal.y * tangent.x) * handedness};
      normal = V3{tangent.x * n_ts.x + bitangent.x * n_ts.y + normal.x * n_ts.z,
                  tangent.y * n_ts.x + bitangent.y * n_ts.y + normal.y * n_ts.z,
                  tangent.z * n_ts.x + bitangent.z * n_ts.y + normal.z * n_ts.z};
    }
  }
  // _shading_info.
  Shading& s = out.s;
  s.normal = normal;
  s.out_dir = V3{-direction.x, -direction.y, -direction.z};
  s.lambert_out = dot(normal, s.out_dir);
  const float f0 = kF0Dielectric * (1.0f - metallic);
  s.fresnel_0 = V3{f0 + albedo.x * metallic, f0 + albedo.y * metallic,
                   f0 + albedo.z * metallic};
  s.diffuse_albedo = V3{albedo.x - metallic * albedo.x,
                        albedo.y - metallic * albedo.y,
                        albedo.z - metallic * albedo.z};
  s.roughness = t_clamp_min(roughness, kRoughnessFloor);
  // _hit_point.
  out.hit_point = V3{origin.x + t * direction.x + gn.x * kOriginOffset,
                     origin.y + t * direction.y + gn.y * kOriginOffset,
                     origin.z + t * direction.z + gn.z * kOriginOffset};
  return out;
}

// -- render/wavefront.py (the lane sets) ----------------------------------

struct Lanes {
  const float *hit_t, *hit_u, *hit_v;
  const int* hit_tri;
  const float *origin, *direction, *atten, *color;
  const long long *seed_x, *seed_y;
  const uint8_t* alive;
  float *origin_out, *direction_out, *atten_out, *color_out;
  long long *sx_out, *sy_out;
  uint8_t* alive_out;
  int64_t n;
};

enum Mode { kExtend = 0, kExtendRR = 1, kLast = 2 };

// _shade_and_extend on one lane.
template <bool INST, bool TEX, int MODE>
__global__ void __launch_bounds__(kThreads)
    shade_extend_kernel(Scene sc, Lanes L, Sky sky) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const bool alive = L.alive[i] != 0;
  const float t = __ldg(L.hit_t + i);
  const bool missed = alive && t >= kMissT;
  const bool did_hit = alive && !missed;
  const V3 atten = load3(L.atten, i);
  const V3 direction = load3(L.direction, i);
  const V3 origin = load3(L.origin, i);
  V3 color = add_masked(load3(L.color, i), missed,
                        sky_term(sky, atten, direction));
  const Surface sf = surface<INST, TEX, MODE == kLast>(
      sc, __ldg(L.hit_tri + i), t, __ldg(L.hit_u + i), __ldg(L.hit_v + i),
      origin, direction, did_hit);
  color = add_masked(color, did_hit,
                     V3{sf.emissive.x * kEmissiveScale * atten.x,
                        sf.emissive.y * kEmissiveScale * atten.y,
                        sf.emissive.z * kEmissiveScale * atten.z});
  store3(L.color_out, i, color);
  if (MODE == kLast) {   // the rest of the state stays as it is
    L.alive_out[i] = 0;
    return;
  }
  State st{origin, direction, atten, (unsigned)L.seed_x[i],
           (unsigned)L.seed_y[i], false};
  next_segment<MODE == kExtendRR>(sf.s, sf.hit_point, did_hit, st);
  store3(L.origin_out, i, st.origin);
  store3(L.direction_out, i, st.direction);
  store3(L.atten_out, i, st.atten);
  L.sx_out[i] = st.sx;
  L.sy_out[i] = st.sy;
  L.alive_out[i] = st.alive;
}

// The per-pixel shading inputs of the joint draws (ShadingInfo, the hit
// point, the ray, the hit flag), each row read at lane mod period.
struct Pixels {
  const float *normal, *out_dir, *lambert_out, *diffuse_albedo, *fresnel_0,
      *roughness, *hit_point, *origin, *direction;
  const uint8_t* did_hit;
  int64_t period;
};

// What pixel_shade_kernel writes: the frames' summed bounce-0 color and
// the per-pixel inputs of the joint draws but the ray, which is its input.
struct PixelsOut {
  float *color, *normal, *out_dir, *lambert_out, *diffuse_albedo,
      *fresnel_0, *roughness, *hit_point;
  uint8_t* did_hit;
};

// The joint batch's bounce 0 on one pixel (trace_progressive_batch): the
// sky or the emissive term (attenuation 1) times the frames, the surface
// its draws read.
template <bool INST, bool TEX>
__global__ void __launch_bounds__(kThreads)
    pixel_shade_kernel(Scene sc, Lanes L, PixelsOut out, Sky sky,
                       float frames) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const float t = __ldg(L.hit_t + i);
  const bool did = t < kMissT;
  const V3 direction = load3(L.direction, i);
  const Surface sf = surface<INST, TEX, false>(
      sc, __ldg(L.hit_tri + i), t, __ldg(L.hit_u + i), __ldg(L.hit_v + i),
      load3(L.origin, i), direction, true);
  const V3 base =
      did ? V3{sf.emissive.x * kEmissiveScale, sf.emissive.y * kEmissiveScale,
               sf.emissive.z * kEmissiveScale}
          : sky_term(sky, V3{1.0f, 1.0f, 1.0f}, direction);
  store3(out.color, i, V3{base.x * frames, base.y * frames, base.z * frames});
  store3(out.normal, i, sf.s.normal);
  store3(out.out_dir, i, sf.s.out_dir);
  out.lambert_out[i] = sf.s.lambert_out;
  store3(out.diffuse_albedo, i, sf.s.diffuse_albedo);
  store3(out.fresnel_0, i, sf.s.fresnel_0);
  out.roughness[i] = sf.s.roughness;
  store3(out.hit_point, i, sf.hit_point);
  out.did_hit[i] = did;
}

template <bool RR>
__global__ void __launch_bounds__(kThreads)
    joint_draw_kernel(Pixels px, Lanes L) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const int64_t p = i % px.period;
  Shading s;
  s.normal = load3(px.normal, p);
  s.out_dir = load3(px.out_dir, p);
  s.lambert_out = px.lambert_out[p];
  s.diffuse_albedo = load3(px.diffuse_albedo, p);
  s.fresnel_0 = load3(px.fresnel_0, p);
  s.roughness = px.roughness[p];
  State st{load3(px.origin, p), load3(px.direction, p),
           L.atten ? load3(L.atten, i) : V3{1.0f, 1.0f, 1.0f},
           (unsigned)L.seed_x[i], (unsigned)L.seed_y[i], false};
  next_segment<RR>(s, load3(px.hit_point, p), px.did_hit[p] != 0, st);
  store3(L.origin_out, i, st.origin);
  store3(L.direction_out, i, st.direction);
  store3(L.atten_out, i, st.atten);
  L.sx_out[i] = st.sx;
  L.sy_out[i] = st.sy;
  L.alive_out[i] = st.alive;
}

// The emissive-free last bounce: the sky on the live lanes the any hit
// missed; every lane ends.
__global__ void __launch_bounds__(kThreads)
    anyhit_sky_kernel(Lanes L, const uint8_t* hit, Sky sky) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const bool missed = L.alive[i] != 0 && hit[i] == 0;
  store3(L.color_out, i,
         add_masked(load3(L.color, i), missed,
                    sky_term(sky, load3(L.atten, i), load3(L.direction, i))));
  L.alive_out[i] = 0;
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Sky sky_of(const float* colors) {   // white, then blue
  Sky sky;
  for (int k = 0; k < 3; ++k) {
    sky.white[k] = colors[k];
    sky.blue[k] = colors[3 + k];
  }
  return sky;
}

template <bool INST, bool TEX, int MODE>
void launch_shade(const Scene& sc, const Lanes& L, const Sky& sky,
                  cudaStream_t s) {
  shade_extend_kernel<INST, TEX, MODE><<<blocks(L.n), kThreads, 0, s>>>(
      sc, L, sky);
}

template <bool INST, bool TEX>
void launch_pixels(const Scene& sc, const Lanes& L, const PixelsOut& out,
                   const Sky& sky, float frames, cudaStream_t s) {
  pixel_shade_kernel<INST, TEX><<<blocks(L.n), kThreads, 0, s>>>(
      sc, L, out, sky, frames);
}

Scene scene_of(const float* tri_attr, const long long* mat_packed,
               const int* tri_material, const float* inst_nrm, int block,
               int mb_bits, const uint8_t* texels, const int* tex_offset,
               const int* tex_width, const int* tex_height) {
  return Scene{tri_attr, mat_packed, tri_material, inst_nrm, block, mb_bits,
               Textures{texels, tex_offset, tex_width, tex_height}};
}

}  // namespace

// C launchers: pointers, sizes, the sky's two colors and the stream in;
// cudaGetLastError() out (0 = the launch was accepted).  Bool tensors are
// bytes; seeds are int64 words holding uint32 values.  An output may be
// its input (the state written in place).  A scene is its tables:
// inst_nrm == nullptr selects the flat scene, texels == nullptr the
// textureless one (the texture tables are then not read).

// mode 0: shade and draw the next segment, 1: and Russian roulette,
// 2: the last bounce (color and alive alone: the other outputs may be
// null; a flat textureless scene reads tri_material).
extern "C" int vkpt_shade_extend(
    int mode, const float* tri_attr, const long long* mat_packed,
    const int* tri_material, const float* inst_nrm, int block, int mb_bits,
    const uint8_t* texels, const int* tex_offset, const int* tex_width,
    const int* tex_height, const float* hit_t, const int* hit_tri,
    const float* hit_u, const float* hit_v, const float* origin,
    const float* direction, const float* atten, const float* color,
    const long long* seed_x, const long long* seed_y, const uint8_t* alive,
    const float* sky_colors, int64_t n, float* origin_out,
    float* direction_out, float* atten_out, float* color_out,
    long long* sx_out, long long* sy_out, uint8_t* alive_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const Scene sc = scene_of(tri_attr, mat_packed, tri_material, inst_nrm,
                            block, mb_bits, texels, tex_offset, tex_width,
                            tex_height);
  const Lanes L{hit_t,    hit_u,     hit_v,         hit_tri,   origin,
                direction, atten,    color,         seed_x,    seed_y,
                alive,    origin_out, direction_out, atten_out, color_out,
                sx_out,   sy_out,    alive_out,     n};
  using Launch = void (*)(const Scene&, const Lanes&, const Sky&,
                          cudaStream_t);
  const Launch launch[2][2][3] = {
      {{launch_shade<false, false, kExtend>,
        launch_shade<false, false, kExtendRR>,
        launch_shade<false, false, kLast>},
       {launch_shade<false, true, kExtend>,
        launch_shade<false, true, kExtendRR>,
        launch_shade<false, true, kLast>}},
      {{launch_shade<true, false, kExtend>,
        launch_shade<true, false, kExtendRR>,
        launch_shade<true, false, kLast>},
       {launch_shade<true, true, kExtend>,
        launch_shade<true, true, kExtendRR>,
        launch_shade<true, true, kLast>}}};
  launch[inst_nrm != nullptr][texels != nullptr][mode](
      sc, L, sky_of(sky_colors), static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The joint batch's bounce 0 on `n` pixels: `frames` times the bounce's
// color, and the per-pixel inputs of its draws.
extern "C" int vkpt_pixel_shade(
    const float* tri_attr, const long long* mat_packed,
    const float* inst_nrm, int block, int mb_bits, const uint8_t* texels,
    const int* tex_offset, const int* tex_width, const int* tex_height,
    const float* hit_t, const int* hit_tri, const float* hit_u,
    const float* hit_v, const float* origin, const float* direction,
    const float* sky_colors, int64_t frames, int64_t n, float* color_out,
    float* normal_out, float* out_dir_out, float* lambert_out_out,
    float* diffuse_albedo_out, float* fresnel_0_out, float* roughness_out,
    float* hit_point_out, uint8_t* did_hit_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Scene sc = scene_of(tri_attr, mat_packed, nullptr, inst_nrm, block,
                            mb_bits, texels, tex_offset, tex_width,
                            tex_height);
  const Lanes L{hit_t,   hit_u,   hit_v,   hit_tri, origin,  direction,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n};
  const PixelsOut out{color_out,          normal_out,    out_dir_out,
                      lambert_out_out,    diffuse_albedo_out,
                      fresnel_0_out,      roughness_out, hit_point_out,
                      did_hit_out};
  using Launch = void (*)(const Scene&, const Lanes&, const PixelsOut&,
                          const Sky&, float, cudaStream_t);
  const Launch launch[2][2] = {
      {launch_pixels<false, false>, launch_pixels<false, true>},
      {launch_pixels<true, false>, launch_pixels<true, true>}};
  // float(batch) * base (trace_progressive_batch).
  launch[inst_nrm != nullptr][texels != nullptr](
      sc, L, out, sky_of(sky_colors), (float)frames,
      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The joint draws: `n` lanes, the per-pixel inputs read at lane mod
// `period`; atten == nullptr reads 1.
extern "C" int vkpt_joint_draw(
    int rr, const float* normal, const float* out_dir,
    const float* lambert_out, const float* diffuse_albedo,
    const float* fresnel_0, const float* roughness, const float* hit_point,
    const float* origin, const float* direction, const uint8_t* did_hit,
    int64_t period, const float* atten, const long long* seed_x,
    const long long* seed_y, int64_t n, float* origin_out,
    float* direction_out, float* atten_out, long long* sx_out,
    long long* sy_out, uint8_t* alive_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (period <= 0) return (int)cudaErrorInvalidValue;
  const Pixels px{normal,    out_dir,   lambert_out, diffuse_albedo,
                  fresnel_0, roughness, hit_point,   origin,
                  direction, did_hit,   period};
  const Lanes L{nullptr,   nullptr, nullptr, nullptr,    nullptr,
                nullptr,   atten,   nullptr, seed_x,     seed_y,
                nullptr,   origin_out, direction_out, atten_out, nullptr,
                sx_out,    sy_out,  alive_out, n};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rr)
    joint_draw_kernel<true><<<blocks(n), kThreads, 0, s>>>(px, L);
  else
    joint_draw_kernel<false><<<blocks(n), kThreads, 0, s>>>(px, L);
  return (int)cudaGetLastError();
}

// The any-hit bounce's sky: `hit` the any-hit kernel's bytes.
extern "C" int vkpt_anyhit_sky(const float* color, const float* atten,
                               const float* direction, const uint8_t* alive,
                               const uint8_t* hit, const float* sky_colors,
                               int64_t n, float* color_out,
                               uint8_t* alive_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Lanes L{nullptr,   nullptr, nullptr, nullptr, nullptr,
                direction, atten,   color,   nullptr, nullptr,
                alive,     nullptr, nullptr, nullptr, color_out,
                nullptr,   nullptr, alive_out, n};
  anyhit_sky_kernel<<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(L, hit,
                                                           sky_of(sky_colors));
  return (int)cudaGetLastError();
}
