// Monomial moment Gram: per block of correspondences, P = sum m m^T (42x42).
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py
// `_moment_kernel_tri_sub` (called through `icp_moment_pallas_tri_sub`). The
// TPU kernel stacks three 42-row groups into a 128-row MXU operand and
// keeps the diagonal blocks; none of that layout is carried over: this kernel
// writes one 42x42 partial per block, and the host sums the partials of a
// correspondence group in float64 (icp/moments.py). The bound (fp32 FMAs)
// and the block's design are described in moment_gram.cuh.

#include "moment_gram.cuh"

namespace {

__global__ void __launch_bounds__(moment::kThreads)
moment_gram_kernel(const float* __restrict__ data, long long stride,
                   int rows_per_block, float* __restrict__ parts) {
  moment::gram_block<false>(
      data, stride, (long long)blockIdx.x * rows_per_block, rows_per_block,
      parts + (long long)blockIdx.x * moment::kMono * moment::kMono, moment::kMono);
}

}  // namespace

extern "C" int dpt_moment_gram(const void* data, int rows, int row_stride,
                               int rows_per_block, void* parts, int nblocks,
                               void* stream) {
  if (rows < 13 || rows_per_block <= 0 || rows_per_block % moment::kTile != 0)
    return (int)cudaErrorInvalidValue;
  moment_gram_kernel<<<nblocks, moment::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (long long)row_stride, rows_per_block, (float*)parts);
  return (int)cudaGetLastError();
}
