// Device-memory read-and-sum: out[k] = sum_r sum_cols data2[r % 2, k, :].
//
// Replaces the TPU kernel `body` of bench.py `bench_hbm_copy_roofline`: a
// pure read of a (2, 8, mp) float32 tensor under the same repeat harness as
// moment_gram_repeat.cu, whose slope (T(R) - T(1)) / (R - 1) over the bytes
// of one copy is the read bandwidth the card really delivers. It is what the
// memory-bound kernels' times are held against, and it checks the harness:
// a slope above the card's stated 3.35 TB/s would mean reads served by the
// 50 MB L2. So the repeat is the slow axis, one launch per repeat, each
// sweeping a whole copy (268 MB at mp = 8,388,608) before the next begins.
//
// Bound: device memory, 32 B per column. Design: a block reads a span of
// columns of all 8 rows with 16-byte loads, eight independent loads in
// flight per thread and pass; a fixed-order shared-memory tree gives one
// partial per block and row, which later repeats add to (launches on one
// stream run in order); a last kernel sums the partials of each row in
// float64 in a fixed order. No atomics: the result is bitwise reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kThreads)
hbm_read_sum_kernel(const float* __restrict__ data, long long mp,
                    int cols_per_block, int accumulate,
                    float* __restrict__ partials) {
  __shared__ float red[kRows][kThreads];
  const int t = threadIdx.x;
  const long long start = (long long)blockIdx.x * cols_per_block;
  const long long stop = start + cols_per_block < mp ? start + cols_per_block : mp;

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
  for (long long c = start + 4 * t; c < stop; c += 4 * kThreads) {
    float4 v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      v[k] = __ldg(reinterpret_cast<const float4*>(data + k * mp + c));
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) red[k][t] += red[k][t + off];
    }
    __syncthreads();
  }
  if (t < kRows) {
    float* p = partials + (long long)blockIdx.x * kRows + t;
    *p = accumulate ? *p + red[t][0] : red[t][0];
  }
}

__global__ void __launch_bounds__(kThreads)
hbm_sum_partials_kernel(const float* __restrict__ partials, int nblocks,
                        float* __restrict__ out) {
  // one block per row: threads stride over the block partials, then a tree
  __shared__ double red[kThreads];
  const int t = threadIdx.x;
  double acc = 0.0;
  for (int blk = t; blk < nblocks; blk += kThreads)
    acc += (double)partials[(long long)blk * kRows + blockIdx.x];
  red[t] = acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] += red[t + off];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = (float)red[0];
}

}  // namespace

extern "C" int dpt_hbm_read_sum(const void* data2, long long mp, int cols_per_block,
                                int repeats, void* partials, int nblocks, void* out,
                                void* stream) {
  if (mp <= 0 || mp % 4 != 0 || cols_per_block <= 0 || cols_per_block % 4 != 0 ||
      repeats < 1 || nblocks <= 0 || (long long)cols_per_block * nblocks < mp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (int r = 0; r < repeats; ++r) {
    hbm_read_sum_kernel<<<nblocks, kThreads, 0, st>>>(
        (const float*)data2 + (r % 2) * kRows * mp, mp, cols_per_block, r > 0,
        (float*)partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  hbm_sum_partials_kernel<<<kRows, kThreads, 0, st>>>((const float*)partials, nblocks,
                                                      (float*)out);
  return (int)cudaGetLastError();
}
