// The bilinear tail of a row sampler: per observation, rows y and y+1 of its
// footprint arrive pre-gathered as two W-wide rows; the kernel picks lanes
// `lane` and `lane + 1` of each and returns value, d/dx, d/dy.
//
// Replaces the TPU kernel `_extract_kernel` of experiments/gather_probe2.py
// (called through `pallas_extract`). The TPU kernel blends whole 128-lane
// rows and then gathers lanes, because a lane gather needs the row in
// registers. The function needs four floats of the two rows: this kernel
// reads just those, in the expressions of the TPU kernel term for term
// (blend = r0 (1 - fy) + r1 fy, diff = r1 - r0, then the lane blend), every
// product through __fmul_rn so that no FMA is formed and the bits are the
// plain PyTorch version's.
//
// Bound: device memory, scattered reads. No two observations share a row, so
// nothing is reused. The card serves a scattered 32-byte sector as a 64-byte
// atom (chip_smoke.py's calibration: a lane pair costs the same in one sector
// or in two of one 64-byte chunk, and 1.7x across a 64-byte boundary), so an
// observation moves 2 x 1.06 atoms of 64 B, 12 B of lane, fx, fy and 32 B of
// output: ~180 B, whose floor at the card's streaming read rate is ~0.125 ms
// for 2 M observations; scattered atoms come at 2.1-2.3 TB/s, not 2.9. What
// a design changes is how the card is asked for them. Design: one thread per
// observation; each lane pair one 8-byte load where its address is 8-byte
// aligned (row_taps.cuh: one pair in two), so 3 tap requests per observation
// where there were 4; the eight outputs as two 16-byte stores; 64-bit row
// offsets, since n * W passes 2^31 at n > 16.7 M. More observations per
// thread on a grid of the resident blocks was slower here (the taps already
// keep enough requests in flight), and so were evict-first stores.

#include <cuda_runtime.h>

#include "row_taps.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_extract_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                   const int* __restrict__ lane, const float* __restrict__ fx,
                   const float* __restrict__ fy, float4* __restrict__ out, long long n, int W) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long at = i * W + __ldg(lane + i);
  const float x = __ldg(fx + i), y = __ldg(fy + i);
  const float2 a = tap_pair(r0 + at), b = tap_pair(r1 + at);  // lanes l, l + 1 of rows y, y + 1
  const float gx = 1.f - x, gy = 1.f - y;
  const float l0 = __fmul_rn(a.x, gy) + __fmul_rn(b.x, y);
  const float l1 = __fmul_rn(a.y, gy) + __fmul_rn(b.y, y);
  const float d0 = b.x - a.x, d1 = b.y - a.y;
  out[2 * i] = make_float4(__fmul_rn(gx, l0) + __fmul_rn(x, l1), l1 - l0,
                           __fmul_rn(gx, d0) + __fmul_rn(x, d1), 0.f);
  out[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// r0, r1 (n, W) float32; lane int32 in [0, W - 2], fx, fy float32, all (n, 1)
// -> out (n, 8) = value, d/dx, d/dy, 0, 0, 0, 0, 0. Returns a cudaError_t
// (0 = launched, or nothing to do).
extern "C" int dpt_row_extract(const void* r0, const void* r1, const void* lane, const void* fx,
                               const void* fy, void* out, long long n, int W, void* stream) {
  if (n < 0 || W < 2 || n > (long long)kThreads * 2147483647LL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  row_extract_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r0, (const float*)r1, (const int*)lane, (const float*)fx, (const float*)fy,
      (float4*)out, n, W);
  return (int)cudaGetLastError();
}
