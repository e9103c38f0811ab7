// Small kernels that exercise the emulation's warp intrinsics and its
// dynamic shared memory limit, for tests/test_torch_kernels_emulated.py.
#include "cuda_runtime.h"

namespace {

void warp_ops(const int* in, const int* src, int* shfl, unsigned* ballot, unsigned* match,
              int* first) {
  const int t = threadIdx.x;
  const int v = in[t];
  shfl[t] = __shfl_sync(0xffffffffu, v, src[t]);
  ballot[t] = __ballot_sync(0xffffffffu, v & 1);
  match[t] = __match_any_sync(0xffffffffu, v);
  first[t] = __ffs(match[t]) - 1;
}

void fill_dynamic(float* out, int n) {
  float* smem = emu_dynamic_smem<float>();
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = (float)i;
  __syncthreads();
  if (threadIdx.x == 0) *out = smem[n - 1];
}

}  // namespace

// One block of `threads` threads: per thread the shuffle of in[] from lane
// src[t], the ballot of (in & 1), the peer mask of in[] and its lowest lane.
extern "C" int emu_warp_ops(const int* in, const int* src, int* shfl, unsigned* ballot,
                            unsigned* match, int* first, int threads) {
  emu_launch(warp_ops, dim3(1), threads, 0, in, src, shfl, ballot, match, first);
  return cudaGetLastError();
}

// A launch with `bytes` of dynamic shared memory, after raising the kernel's
// limit to `allow` bytes (none when allow < 0); writes the last float filled.
extern "C" int emu_dynamic_smem_launch(int bytes, int allow, float* out) {
  if (allow >= 0) {
    const cudaError_t err = cudaFuncSetAttribute(fill_dynamic, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 allow);
    if (err != cudaSuccess) return err;
  }
  emu_launch(fill_dynamic, dim3(1), 64, (size_t)bytes, out, bytes / 4);
  return cudaGetLastError();
}
