// Host emulation of the few CUDA runtime features the port's kernels use, so
// that tests/test_torch_kernels_emulated.py can compile the unmodified .cu
// sources with g++ and run them on the CPU. Blocks run one after another;
// each CUDA thread of a block is a std::thread, __syncthreads() is a
// std::barrier, and __shared__ variables are function-local statics (shared
// by the threads of the one block that runs at a time); a grid may be 2-D.
// The round-to-nearest intrinsics are the plain operators (g++ does not
// contract them into FMAs for the baseline x86-64 target). The test rewrites
// `kernel<<<grid, block, 0, stream>>>(args)` into `emu_launch(kernel, grid,
// block, args)`; a kernel may be a template instantiation. `float4` is a plain
// struct of four floats. Warp-level intrinsics are not emulated.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>

using std::isfinite;
using std::max;
using std::min;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }

struct alignas(16) float4 {
  float x, y, z, w;
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__ __restrict
template <class T>
inline T __ldg(const T* p) { return *p; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

template <class F, class... A>
void emu_launch(F kernel, dim3 grid, int block, A... args) {
  gridDim = grid;
  blockDim = dim3(block);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(block);
      emu_barrier = &bar;
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
