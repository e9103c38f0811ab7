// Monomial moment Gram, one zero-padded (48,48) part per chunk.
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py
// `_moment_kernel` (called through `icp_moment_pallas`): per chunk of the
// packed (16, Mp) tensor, the Gram of the 42 monomials plus 6 zero rows.
// The 48-row padding is the JAX output's shape and is kept so that the two
// can be compared entry by entry; rows and columns 42..47 are written as
// zeros, nothing is computed for them. One block per chunk: with the
// default chunk of 16384 an 8M-correspondence tensor gives 492 blocks for
// 132 SMs. Bound: fp32 FMAs, as for every kernel built on moment_gram.cuh
// (64 B per correspondence of the 16-row tensor lie in memory, 52 B are read).

#include "moment_gram.cuh"

namespace {

constexpr int kPadded = 48;

__global__ void __launch_bounds__(moment::kThreads, 1)
moment_gram48_kernel(const float* __restrict__ data, long long stride, int chunk,
                     float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  moment::gram_block<false>(data, stride, (long long)blockIdx.x * chunk, chunk,
                            parts + (long long)blockIdx.x * kPadded * kPadded, kPadded, smem);
}

}  // namespace

extern "C" int dpt_moment_gram48(const void* data, int rows, int row_stride,
                                 int chunk, void* parts, int nchunks, void* stream) {
  if (rows < 13 || chunk <= 0 || nchunks <= 0 ||
      (long long)chunk * nchunks != (long long)row_stride)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = moment::allow_smem(moment_gram48_kernel);
  if (err != cudaSuccess) return (int)err;
  moment_gram48_kernel<<<nchunks, moment::kThreads, moment::kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)data, (long long)row_stride, chunk, (float*)parts);
  return (int)cudaGetLastError();
}
