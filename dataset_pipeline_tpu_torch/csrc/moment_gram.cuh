// Device code shared by the monomial moment Gram kernels (moment_gram.cu,
// moment_gram48.cu, moment_gram_thirds.cu, moment_gram_repeat.cu): one block
// computes P = sum m m^T (42x42) over `rows` consecutive correspondences.
//
// The 42 pose-independent monomials of a correspondence are (layout of
// icp/moments.py)  m = [b; ps_k * b; pt_k * b], k = 0..2, b = sqrt(w) [ns; nt].
// Bound on the H100: fp32 FMA throughput. A correspondence is 13 floats
// (52 B) but 28 6x6 register tiles cover the upper triangle (1008 FMAs), so
// 8M correspondences are 416 MB (0.12 ms at 3.35 TB/s) against 8.1 G FMAs
// (0.25 ms at 67 TFLOP/s fp32). Tensor cores would need TF32, which loses
// the digits the moment LM's noise floor is built on, so the kernels stay on
// the fp32 pipes. Design: a 256-row tile is staged in shared memory as
// monomials (each thread builds one row's 42 from its 13 inputs; the padded
// pitch keeps the column reads of different monomials on different banks;
// rows past the block's last are staged as zeros, so any row count works);
// 252 threads each own one 6x6 tile of the upper triangle for one of 9
// interleaved row groups, so a row costs 12 shared loads per 36 FMAs. The
// nine row-group sums are added in a fixed order at the end: no atomics, and
// the result is bitwise reproducible.
#pragma once

#include <cuda_runtime.h>

namespace moment {

constexpr int kThreads = 256;
constexpr int kTile = 256;         // rows staged per pass (one per thread)
constexpr int kPitch = kTile + 1;  // shared-memory pitch of one monomial's row
constexpr int kMono = 42;
constexpr int kTiles = 28;   // 6x6 tiles on or above the diagonal of a 7x7 grid
constexpr int kGroups = 9;   // interleaved row groups: 28 * 9 = 252 threads

__device__ __forceinline__ void tile_coords(int tile, int* ta, int* tb) {
  int k = tile;
  for (int a = 0; a < 7; ++a) {
    if (k < 7 - a) {
      *ta = a;
      *tb = a + k;
      return;
    }
    k -= 7 - a;
  }
  *ta = 0;
  *tb = 0;
}

// The Gram of rows [row0, row0 + rows) of `data` (row r of the packed tensor
// at data + r * stride), written to the (pitch x pitch) matrix `out`
// (pitch >= 42; rows and columns from 42 on are set to zero), or added to it
// when kAccumulate. Every thread of the 256-thread block must call it.
template <bool kAccumulate>
__device__ __forceinline__ void gram_block(const float* __restrict__ data,
                                           long long stride, long long row0,
                                           int rows, float* __restrict__ out,
                                           int pitch) {
  __shared__ float m[kMono * kPitch];

  const int tid = threadIdx.x;
  const int tile = tid / kGroups, grp = tid % kGroups;
  const bool computes = tile < kTiles;
  int ta = 0, tb = 0;
  if (computes) tile_coords(tile, &ta, &tb);

  float acc[6][6];
#pragma unroll
  for (int u = 0; u < 6; ++u)
#pragma unroll
    for (int v = 0; v < 6; ++v) acc[u][v] = 0.f;

  for (int base = 0; base < rows; base += kTile) {
    {
      float v[13];
      if (base + tid < rows) {
        const float* col = data + row0 + base + tid;
#pragma unroll
        for (int k = 0; k < 13; ++k) v[k] = __ldg(col + k * stride);
      } else {
#pragma unroll
        for (int k = 0; k < 13; ++k) v[k] = 0.f;
      }
      const float sw = sqrtf(v[12]);
      const float b[6] = {v[3] * sw, v[4] * sw, v[5] * sw,
                          v[9] * sw, v[10] * sw, v[11] * sw};
      const float a[6] = {v[0], v[1], v[2], v[6], v[7], v[8]};  // ps, pt
#pragma unroll
      for (int c = 0; c < 6; ++c) m[c * kPitch + tid] = b[c];
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int c = 0; c < 6; ++c) m[(6 + 6 * k + c) * kPitch + tid] = a[k] * b[c];
    }
    __syncthreads();
    if (computes) {
      const float* xa = m + 6 * ta * kPitch;
      const float* xb = m + 6 * tb * kPitch;
      for (int r = grp; r < kTile; r += kGroups) {
        float x[6], y[6];
#pragma unroll
        for (int u = 0; u < 6; ++u) {
          x[u] = xa[u * kPitch + r];
          y[u] = xb[u * kPitch + r];
        }
#pragma unroll
        for (int u = 0; u < 6; ++u)
#pragma unroll
          for (int v = 0; v < 6; ++v) acc[u][v] = fmaf(x[u], y[v], acc[u][v]);
      }
    }
    __syncthreads();
  }

  // sum the nine row groups of each tile in a fixed order (the staging
  // buffer is free now: 28*9*36 floats fit in 42*257)
  float* red = m;
  if (computes) {
#pragma unroll
    for (int u = 0; u < 6; ++u)
#pragma unroll
      for (int v = 0; v < 6; ++v) red[(tile * kGroups + grp) * 36 + u * 6 + v] = acc[u][v];
  }
  __syncthreads();
  for (int e = tid; e < kTiles * 36; e += kThreads) {
    const int te = e / 36, uv = e % 36;
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += red[(te * kGroups + g) * 36 + uv];
    int ea = 0, eb = 0;
    tile_coords(te, &ea, &eb);
    const int a = 6 * ea + uv / 6, b = 6 * eb + uv % 6;
    // a diagonal tile computes both (a,b) and (b,a), bitwise equal, each
    // written by its own thread; any other tile is mirrored below the diagonal
    float* ab = out + a * pitch + b;
    *ab = kAccumulate ? *ab + sum : sum;
    if (ea != eb) {
      float* ba = out + b * pitch + a;
      *ba = kAccumulate ? *ba + sum : sum;
    }
  }
  if (!kAccumulate) {
    for (int e = tid; e < pitch * pitch; e += kThreads)
      if (e / pitch >= kMono || e % pitch >= kMono) out[e] = 0.f;
  }
}

}  // namespace moment
