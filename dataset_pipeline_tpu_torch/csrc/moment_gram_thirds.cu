// Monomial moment Gram per column-third of a chunk: (chunks, 3, 42, 42).
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py
// `_moment_kernel_tri` (called through `icp_moment_pallas_tri`). That kernel
// stacks the monomials of a chunk's three column-thirds into one 126-row
// operand to fill the 128x128 matrix unit, and the chunk's Gram is the sum
// of the three diagonal 42x42 blocks of its (128,128) output; the off-
// diagonal blocks are products between unrelated correspondences that the
// caller throws away. Here one block computes one third's Gram and nothing
// else: the output holds exactly those three diagonal blocks per chunk, and
// ops/gn.py:moment_tri_extract sums them. Bound: fp32 FMAs (moment_gram.cuh).

#include "moment_gram.cuh"

namespace {

__global__ void __launch_bounds__(moment::kThreads, 1)
moment_gram_thirds_kernel(const float* __restrict__ data, long long stride,
                          int third, float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  // thirds are consecutive: block i covers columns [i * third, (i + 1) * third)
  moment::gram_block<false>(
      data, stride, (long long)blockIdx.x * third, third,
      parts + (long long)blockIdx.x * moment::kMono * moment::kMono, moment::kMono, smem);
}

}  // namespace

extern "C" int dpt_moment_gram_thirds(const void* data, int rows, int row_stride,
                                      int chunk, void* parts, int nchunks,
                                      void* stream) {
  if (rows < 13 || chunk <= 0 || chunk % 3 != 0 || nchunks <= 0 ||
      (long long)chunk * nchunks != (long long)row_stride)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = moment::allow_smem(moment_gram_thirds_kernel);
  if (err != cudaSuccess) return (int)err;
  moment_gram_thirds_kernel<<<3 * nchunks, moment::kThreads, moment::kSmemBytes,
                              (cudaStream_t)stream>>>(
      (const float*)data, (long long)row_stride, chunk / 3, (float*)parts);
  return (int)cudaGetLastError();
}
