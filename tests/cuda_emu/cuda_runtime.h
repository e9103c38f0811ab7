// Host emulation of the few CUDA runtime features the port's kernels use, so
// that tests/test_torch_kernels_emulated.py can compile the unmodified .cu
// sources with g++ and run them on the CPU. Blocks run one after another;
// each CUDA thread of a block is a std::thread, __syncthreads() is a
// std::barrier, and __shared__ variables are function-local statics (shared
// by the threads of the one block that runs at a time); a grid may be 2-D.
// The round-to-nearest intrinsics are the plain operators (g++ does not
// contract them into FMAs for the baseline x86-64 target). The test rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` into `emu_launch(kernel, grid,
// block, smem, args)`; a kernel may be a template instantiation. Dynamic
// shared memory (`extern __shared__ T name[];`, which the test rewrites into
// `T* name = emu_dynamic_smem<T>();`) is one buffer of `smem` bytes per block,
// filled with NaN bytes so that a read of a slot no thread wrote shows; as on
// the card, a launch with more than 48 KB of it fails (cudaGetLastError) unless
// `cudaFuncSetAttribute` raised that kernel's limit, and above 227 KB always.
// `float2`, `float3` and `float4` are plain
// structs of two, three and four floats. A warp is 32 consecutive threads with a barrier of
// its own: `__shfl_xor_sync`, `__shfl_sync`, `__ballot_sync` and
// `__match_any_sync` are an exchange array between two waits on it, so every
// lane of the warp must call them (the mask is not read), as `__syncwarp`,
// one wait on it. `atomicAdd` on an unsigned int and
// `__threadfence` are the host's atomics (blocks run in order, so the last
// block of the grid draws the last ticket); `__ldg`, `__ldcg` and `__ldcs` are plain
// loads that count misaligned and vector loads. The device has 2 SMs and one resident
// block per SM, whatever the kernel.
// cp.async (CUDA's pipeline primitives) is emulated in
// cuda_pipeline_primitives.h beside this file.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <thread>
#include <utility>
#include <vector>

using std::isfinite;
using std::isnan;
using std::max;
using std::min;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
struct float3 {
  float x, y, z;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float3 make_float3(float x, float y, float z) { return {x, y, z}; }
inline float2 make_float2(float x, float y) { return {x, y}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<unsigned long long> emu_exchange;  // one slot per thread of the block
// Every lane of the calling warp posts v; f(first, lanes) then reads the
// warp's posts (emu_exchange[first + l], l < lanes) before the second wait.
template <class T, class F>
inline auto emu_warp_exchange(T v, F f) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "warp exchanges move at most 8 bytes");
  const unsigned t = threadIdx.x, first = t & ~31u;
  std::barrier<>& bar = *emu_warp_barriers[t / 32];
  std::memcpy(&emu_exchange[t], &v, sizeof(T));
  bar.arrive_and_wait();
  const auto r = f(first, std::min(32u, blockDim.x - first));
  bar.arrive_and_wait();
  return r;
}
template <class T>
inline T emu_posted(unsigned thread) {
  T r;
  std::memcpy(&r, &emu_exchange[thread], sizeof(T));
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_warp_exchange(v, [&](unsigned, unsigned) {
    return emu_posted<T>(threadIdx.x ^ (unsigned)lane_mask);
  });
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_warp_exchange(v, [&](unsigned first, unsigned) {
    return emu_posted<T>(first + ((unsigned)src_lane & 31u));
  });
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu_warp_exchange(pred != 0, [](unsigned first, unsigned lanes) {
    unsigned m = 0;
    for (unsigned l = 0; l < lanes; ++l) m |= (unsigned)emu_posted<bool>(first + l) << l;
    return m;
  });
}
template <class T>
inline unsigned __match_any_sync(unsigned, T v) {
  return emu_warp_exchange(v, [&](unsigned first, unsigned lanes) {
    unsigned m = 0;
    for (unsigned l = 0; l < lanes; ++l) m |= (unsigned)(emu_posted<T>(first + l) == v) << l;
    return m;
  });
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__ __restrict
#define __align__(n) alignas(n)
// The load intrinsics are plain loads that count a load not aligned to its
// own size (a vector load that faults on the card) and the vector loads
// (emu_counters.cpp reads both).
inline std::atomic<long long> emu_misaligned{0}, emu_vector_loads{0};
template <class T>
inline const T* emu_checked(const T* p) {
  if (reinterpret_cast<std::uintptr_t>(p) % alignof(T) != 0) ++emu_misaligned;
  if (sizeof(T) > 4) ++emu_vector_loads;
  return p;
}
template <class T>
inline T __ldg(const T* p) { return *emu_checked(p); }
template <class T>
inline T __ldcg(const T* p) { return *emu_checked(p); }
template <class T>
inline T __ldcs(const T* p) { return *emu_checked(p); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t emu_launch_error = cudaSuccess;  // the last refused launch's, until read
inline cudaError_t cudaGetLastError() { return std::exchange(emu_launch_error, cudaSuccess); }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { return *dev = 0, cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  return *value = 2, cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  return *blocks = 1, cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr size_t emu_default_smem = 48 * 1024, emu_max_smem = 232448;  // the H100's per block
inline std::map<const void*, size_t> emu_smem_limits;  // kernel -> dynamic shared memory allowed
template <class F>
inline cudaError_t cudaFuncSetAttribute(F kernel, cudaFuncAttribute, int bytes) {
  if (bytes < 0 || (size_t)bytes > emu_max_smem) return cudaErrorInvalidValue;
  emu_smem_limits[reinterpret_cast<const void*>(kernel)] = (size_t)bytes;
  return cudaSuccess;
}
inline std::vector<float4> emu_dynamic;  // the running block's dynamic shared memory
template <class T>
inline T* emu_dynamic_smem() { return reinterpret_cast<T*>(emu_dynamic.data()); }

template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int block, size_t smem, A... args) {
  const auto limit = emu_smem_limits.find(reinterpret_cast<const void*>(kernel));
  if (smem > (limit == emu_smem_limits.end() ? emu_default_smem : limit->second)) {
    emu_launch_error = cudaErrorInvalidValue;  // the card refuses it, and nothing runs
    return;
  }
  gridDim = grid;
  blockDim = dim3(block);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      emu_dynamic.assign((smem + sizeof(float4) - 1) / sizeof(float4), float4{});
      std::memset(static_cast<void*>(emu_dynamic.data()), 0xff, emu_dynamic.size() * sizeof(float4));
      std::barrier<> bar(block);
      emu_barrier = &bar;
      emu_exchange.assign(block, 0);
      emu_warp_barriers.clear();
      for (int w = 0; w * 32 < block; ++w)
        emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(std::min(32, block - 32 * w)));
      std::vector<std::thread> threads;
      threads.reserve(block);
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel(args...);
        });
      for (auto& th : threads) th.join();
    }
}
