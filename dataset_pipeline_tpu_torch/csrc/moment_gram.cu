// Monomial moment Gram: per block of correspondences, P = sum m m^T (42x42).
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py
// `_moment_kernel_tri_sub` (called through `icp_moment_pallas_tri_sub`). The
// TPU kernel stacks three 42-row groups into a 128-row MXU operand and
// keeps the diagonal blocks; none of that layout is carried over: this kernel
// writes one 42x42 partial per block, and the host sums the partials of a
// correspondence group in float64 (icp/moments.py). The bound (fp32 FMAs)
// and the block's design (the Kronecker-factored 28 x 21 product) are
// described in moment_gram.cuh. One block is resident per SM (its 7 x 21
// register tiles), so the wrapper sizes the blocks from the resident slots
// that dpt_moment_gram_grid reports: a last wave of a few blocks would leave
// most SMs idle.

#include "moment_gram.cuh"

namespace {

__global__ void __launch_bounds__(moment::kThreads, 1)
moment_gram_kernel(const float* __restrict__ data, long long stride,
                   int rows_per_block, float* __restrict__ parts) {
  extern __shared__ __align__(16) float smem[];
  moment::gram_block<false>(
      data, stride, (long long)blockIdx.x * rows_per_block, rows_per_block,
      parts + (long long)blockIdx.x * moment::kMono * moment::kMono, moment::kMono, smem);
}

}  // namespace

extern "C" int dpt_moment_gram(const void* data, int rows, int row_stride,
                               int rows_per_block, void* parts, int nblocks,
                               void* stream) {
  if (rows < 13 || rows_per_block <= 0 || rows_per_block % moment::kTile != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = moment::allow_smem(moment_gram_kernel);
  if (err != cudaSuccess) return (int)err;
  moment_gram_kernel<<<nblocks, moment::kThreads, moment::kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)data, (long long)row_stride, rows_per_block, (float*)parts);
  return (int)cudaGetLastError();
}

// Resident blocks of this kernel on the current device (SMs x blocks per SM);
// negative (minus the cudaError_t) when the runtime refuses.
extern "C" int dpt_moment_gram_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = moment::allow_smem(moment_gram_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moment_gram_kernel, moment::kThreads,
                                                        moment::kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}
