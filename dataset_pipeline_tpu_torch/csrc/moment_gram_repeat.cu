// The moment Gram over a repeat axis: parts = sum_r Gram(copy r % 2).
//
// Replaces the TPU kernel `body` of dataset_pipeline_tpu/ops/pallas_gn.py
// `icp_moment_pallas_tri_sub_timed`: a timing harness whose repeat r reads
// copy r % 2 of a (2, rows, Mp) tensor, so that consecutive repeats re-read
// device memory, and whose time grows by one pass per repeat; the slope
// (T(R) - T(1)) / (R - 1) is the pass time free of launch and host overhead.
// On the TPU the grid is sequential and chunk-major. Here a block that
// looped over its own chunk's repeats would find both copies of the chunks
// in flight in the 50 MB L2 and the slope would read above device memory. So
// the repeat is the slow axis: one launch per repeat on the caller's stream,
// each sweeping a whole copy (0.4 GB at 8M correspondences) before the next
// begins, the first writing the parts and the later ones adding to them
// (launches on one stream run in order, so the sum has a fixed order).
// Bound per repeat: fp32 FMAs, as moment_gram.cu.

#include "moment_gram.cuh"

namespace {

template <bool kAccumulate>
__global__ void __launch_bounds__(moment::kThreads, 1)
moment_gram_repeat_kernel(const float* __restrict__ data, long long stride,
                          int rows_per_block, float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  moment::gram_block<kAccumulate>(
      data, stride, (long long)blockIdx.x * rows_per_block, rows_per_block,
      parts + (long long)blockIdx.x * moment::kMono * moment::kMono, moment::kMono, smem);
}

}  // namespace

extern "C" int dpt_moment_gram_repeat(const void* data2, int rows, int row_stride,
                                      int rows_per_block, void* parts, int nblocks,
                                      int repeats, void* stream) {
  if (rows < 13 || rows_per_block <= 0 || nblocks <= 0 || repeats < 1 ||
      (long long)rows_per_block * nblocks != (long long)row_stride)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = moment::allow_smem(moment_gram_repeat_kernel<false>);
  if (err == cudaSuccess) err = moment::allow_smem(moment_gram_repeat_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  const long long copy = (long long)rows * row_stride;
  cudaStream_t st = (cudaStream_t)stream;
  for (int r = 0; r < repeats; ++r) {
    const float* src = (const float*)data2 + (r % 2) * copy;
    if (r == 0)
      moment_gram_repeat_kernel<false><<<nblocks, moment::kThreads, moment::kSmemBytes, st>>>(
          src, (long long)row_stride, rows_per_block, (float*)parts);
    else
      moment_gram_repeat_kernel<true><<<nblocks, moment::kThreads, moment::kSmemBytes, st>>>(
          src, (long long)row_stride, rows_per_block, (float*)parts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
