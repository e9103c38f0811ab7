// Trilinear extraction from brick rows: per observation, one W-wide row of
// each of two pyramid levels holds its whole 2x2 footprint at lanes l, l + 1,
// l + bx, l + bx + 1 (a row is a block of bx-pixel lines); the kernel
// samples both levels bilinearly and blends them by `zf` (the weight of
// level A, the finer): value, d/dx, d/dy in level A's pixels (level B's
// derivatives count half: its pixels are twice as large) and d/dzf = vA - vB.
//
// Replaces the TPU kernel `_extract_packed_kernel` of
// experiments/gather_probe2.py (called through `pallas_extract_packed`), the
// prototype of the brick sampler's extraction; ops/brick.py runs its samples
// through this kernel. The TPU kernel holds whole 512-byte rows in registers
// for its lane gathers. The function needs eight floats per observation, and
// this kernel reads just those, `bil`'s arithmetic term for term
// (bilinear_tail.cuh) and the blend's products through __fmul_rn: no FMA, the
// bits of the plain PyTorch version.
//
// Bound: device memory, scattered reads. No two observations share a row, so
// nothing is reused, and the card serves a scattered 32-byte sector as a
// 64-byte atom (chip_smoke.py's calibration): an observation moves 4 x 1.05
// atoms of 64 B, 28 B of lanes, fractions and zf, and 32 B of output: ~330 B,
// whose floor at the card's streaming read rate is ~0.23 ms for 2 M
// observations. Design: each of the four tap pairs one 8-byte load where its
// address is 8-byte aligned (row_taps.cuh: 6 tap requests per observation
// where there were 8); a thread takes kObs observations a block-width apart
// and issues all their tap loads before it uses one; the grid is the resident
// blocks walking the observations; two 16-byte stores per observation; 64-bit
// row offsets. One observation per thread was slower here, and so were
// evict-first stores (9 %). Lanes are checked by the wrapper: l + bx + 1 < W.

#include <cuda_runtime.h>

#include "bilinear_tail.cuh"
#include "row_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kObs = 4;  // observations per thread and trip

__global__ void __launch_bounds__(kThreads)
row_extract_packed_kernel(const float* __restrict__ ra, const float* __restrict__ rb,
                          const int* __restrict__ la, const int* __restrict__ lb,
                          const float* __restrict__ fxa, const float* __restrict__ fya,
                          const float* __restrict__ fxb, const float* __restrict__ fyb,
                          const float* __restrict__ zf, float4* __restrict__ out, long long n,
                          int W, int bx) {
  const long long trip = (long long)gridDim.x * kThreads * kObs;
  for (long long first = (long long)blockIdx.x * kThreads * kObs + threadIdx.x; first < n;
       first += trip) {
    int pa[kObs], pb[kObs];
    float xa[kObs], ya[kObs], xb[kObs], yb[kObs], z[kObs];
#pragma unroll
    for (int k = 0; k < kObs; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i < n) {
        pa[k] = __ldg(la + i);
        pb[k] = __ldg(lb + i);
        xa[k] = __ldg(fxa + i);
        ya[k] = __ldg(fya + i);
        xb[k] = __ldg(fxb + i);
        yb[k] = __ldg(fyb + i);
        z[k] = __ldg(zf + i);
      }
    }
    // each level's footprint rows: lanes l, l + 1 (t) and l + bx, l + bx + 1 (b)
    float2 ta[kObs], ba[kObs], tb[kObs], bb[kObs];
#pragma unroll
    for (int k = 0; k < kObs; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i < n) {
        const float* a = ra + i * W + pa[k];
        const float* b = rb + i * W + pb[k];
        ta[k] = tap_pair(a);
        ba[k] = tap_pair(a + bx);
        tb[k] = tap_pair(b);
        bb[k] = tap_pair(b + bx);
      }
    }
#pragma unroll
    for (int k = 0; k < kObs; ++k) {
      const long long i = first + (long long)k * kThreads;
      if (i < n) {
        const Bilinear A = bilinear_tail(ta[k].x, ta[k].y, ba[k].x, ba[k].y, xa[k], ya[k]);
        const Bilinear B = bilinear_tail(tb[k].x, tb[k].y, bb[k].x, bb[k].y, xb[k], yb[k]);
        const float g = 1.f - z[k];
        out[2 * i] = make_float4(__fmul_rn(z[k], A.v) + __fmul_rn(g, B.v),
                                 __fmul_rn(z[k], A.dx) + __fmul_rn(__fmul_rn(g, B.dx), 0.5f),
                                 __fmul_rn(z[k], A.dy) + __fmul_rn(__fmul_rn(g, B.dy), 0.5f),
                                 A.v - B.v);
        out[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

}  // namespace

// ra, rb (n, W) float32; la, lb int32 in [0, W - bx - 2]; fxa, fya, fxb, fyb,
// zf float32; all (n, 1) -> out (n, 8) = value, d/dx, d/dy, d/dzf, 0, 0, 0, 0,
// on at most `nblocks` blocks (dpt_row_extract_packed_grid). Returns a
// cudaError_t (0 = launched, or nothing to do).
extern "C" int dpt_row_extract_packed(const void* ra, const void* rb, const void* la,
                                      const void* lb, const void* fxa, const void* fya,
                                      const void* fxb, const void* fyb, const void* zf, void* out,
                                      long long n, int W, int bx, int nblocks, void* stream) {
  if (n < 0 || bx < 1 || W < bx + 2 || nblocks < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long need = (n + (long long)kThreads * kObs - 1) / ((long long)kThreads * kObs);
  const unsigned blocks = (unsigned)(need < nblocks ? need : nblocks);
  row_extract_packed_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ra, (const float*)rb, (const int*)la, (const int*)lb, (const float*)fxa,
      (const float*)fya, (const float*)fxb, (const float*)fyb, (const float*)zf, (float4*)out, n,
      W, bx);
  return (int)cudaGetLastError();
}

// Resident blocks of the kernel on the current device (SMs x blocks per SM);
// negative (minus the cudaError_t) when the runtime refuses.
extern "C" int dpt_row_extract_packed_grid() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_extract_packed_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}
