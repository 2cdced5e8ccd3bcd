// A CPU stand-in for the parts of the CUDA runtime that the traversal
// kernels (stack_walk.cuh with stack_traverse.cu, pair_traverse.cu and
// frontier_traverse.cu; skip_traverse.cu) use, so that g++ builds those
// sources into a host library whose C launchers run on host memory.
// tests/test_torch_walk_host.py builds it and holds the kernels' outputs
// to their plain PyTorch versions bitwise.
//
// Each block's threads run as std::threads (blocks one after another);
// the 32 threads of a warp share a std::barrier, through which the warp
// votes and shuffles exchange their values.  A thread that returns from
// the kernel leaves its warp's barrier.  __activemask reports every
// lane and __match_any_sync the calling lane alone, so the statistics
// build's SIMT and shared-leaf counters mean nothing here.  The
// launch syntax kernel<<<grid, threads, smem, stream>>>(args) is
// rewritten by the test into vkpt_mock::launch({grid, threads, smem,
// stream}, kernel, args); the SM count and the blocks per SM both read
// 2, so the persistent grids are small and their warps take many
// batches.

#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float4 {
  float x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
struct int2 {
  int x, y;
};
struct uint2 {
  unsigned x, y;
};
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

using std::max;
using std::min;

namespace vkpt_mock {

struct Warp {
  std::barrier<> bar{32};
  unsigned slot[32] = {};
  std::atomic<bool> live[32];
  Warp() {
    for (auto& l : live) l = true;
  }
};

inline thread_local dim3 thread_idx, block_idx, block_dim;
inline thread_local Warp* warp = nullptr;

inline unsigned lane() { return thread_idx.x & 31u; }

// Every live lane posts `value`; `read` sees all of them.
template <class R>
auto exchange(unsigned value, R read) {
  Warp& w = *warp;
  w.slot[lane()] = value;
  w.bar.arrive_and_wait();
  const auto out = read(w);
  w.bar.arrive_and_wait();
  return out;
}

inline unsigned live_mask(const Warp& w) {
  unsigned m = 0;
  for (int l = 0; l < 32; ++l)
    if (w.live[l]) m |= 1u << l;
  return m;
}

struct Cfg {
  long long grid, threads, smem;
  cudaStream_t stream;
};

template <class K, class... A>
void launch(Cfg c, K kernel, A... args) {
  for (long long b = 0; b < c.grid; ++b) {
    std::vector<std::unique_ptr<Warp>> warps((c.threads + 31) / 32);
    for (auto& w : warps) w = std::make_unique<Warp>();
    std::vector<std::thread> threads;
    for (long long t = 0; t < c.threads; ++t) {
      threads.emplace_back([&, t] {
        thread_idx.x = (unsigned)t;
        block_idx.x = (unsigned)b;
        block_dim.x = (unsigned)c.threads;
        warp = warps[t / 32].get();
        kernel(args...);
        warp->live[t & 31] = false;
        warp->bar.arrive_and_drop();
      });
    }
    for (auto& th : threads) th.join();
  }
}

}  // namespace vkpt_mock

#define threadIdx (vkpt_mock::thread_idx)
#define blockIdx (vkpt_mock::block_idx)
#define blockDim (vkpt_mock::block_dim)

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

// cuda_bf16.h's conversions (tests/test_torch_walk_host.py adds a
// cuda_bf16.h that includes this file): round to nearest even, as
// PyTorch's float -> bfloat16 (c10::BFloat16, a NaN to 0x7fc0), and the
// exact widening back.
struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if (std::isnan(f)) return __nv_bfloat16{0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float((uint32_t)b.bits << 16);
}

inline unsigned __activemask() { return 0xffffffffu; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }

inline unsigned __ballot_sync(unsigned, bool p) {
  return vkpt_mock::exchange(p, [](const vkpt_mock::Warp& w) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
      if (w.live[l] && w.slot[l]) m |= 1u << l;
    return m;
  });
}

inline bool __any_sync(unsigned mask, bool p) {
  return __ballot_sync(mask, p) != 0u;
}

inline bool __all_sync(unsigned, bool p) {
  return vkpt_mock::exchange(p, [](const vkpt_mock::Warp& w) {
    for (int l = 0; l < 32; ++l)
      if (w.live[l] && !w.slot[l]) return false;
    return true;
  });
}

// The lanes with the same value: each lane alone here (__activemask
// reports every lane, and a vote of the lanes inside a divergent branch
// would wait for the others at the barrier).
inline unsigned __match_any_sync(unsigned, int) {
  return 1u << vkpt_mock::lane();
}

inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return vkpt_mock::exchange(
      v, [src](const vkpt_mock::Warp& w) { return w.slot[src & 31]; });
}

inline int __reduce_max_sync(unsigned, int v) {
  return vkpt_mock::exchange((unsigned)v, [](const vkpt_mock::Warp& w) {
    int m = INT32_MIN;
    for (int l = 0; l < 32; ++l)
      if (w.live[l]) m = std::max(m, (int)w.slot[l]);
    return m;
  });
}

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}

inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}

template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int,
                                                          size_t) {
  *blocks = 2;
  return cudaSuccess;
}

inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes,
                                   cudaStream_t) {
  std::memset(p, value, bytes);
  return cudaSuccess;
}
