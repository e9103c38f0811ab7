// ICP Gauss-Newton accumulation from precomputed rows with per-row cloud ids:
// G = A1 A1^T + A2 A2^T (S x S, S = 6C + 1), H = G[:6C,:6C], b = G[:6C,6C],
// cost = G[6C,6C].
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py `_gn_kernel`
// (called through `icp_hb_cost_pallas`). Per correspondence the inputs are
// the global-frame Jacobian vectors j1, j2 (6 each), the residuals r1, r2,
// the weight w and the source and target cloud ids; column i of the operands
// is  A1 = sqrt(w) [s(c) j1 at cloud block c; r1],  A2 = sqrt(w) [-s(c) j2; r2]
// with s(c) = [tid == c] - [sid == c]. The ids change from row to row, so the
// per-chunk-pair reduction of gn_fused.cu does not apply: the dense operands
// are staged in shared memory and contracted as they stand, as the Pallas
// body does (every product of its two dot_generals is computed here, in fp32
// FMAs). Nothing of the TPU layout is kept: j1 and j2 are (6, M) without the
// 6 -> 8 row padding, S is not rounded up to 8, and a ragged last block is
// masked, so the caller pads nothing.
//
// Bound on the H100: device memory, 68 B per correspondence (0.16 ms at 8M
// and 3.35 TB/s). A column of A1 or A2 has 13 non-zeros whatever C is (two
// 6-row blocks and the residual), so the function needs 2 x 91 FMAs per
// correspondence for the upper triangle of both products (0.04 ms at
// 67 TFLOP/s); the dense contraction below spends (S^2 + S) FMAs instead
// (182 at C = 2, 992 at C = 5), most of them on zeros for C > 2.
//
// Design: a tile of up to 256 columns is staged as the two (S4 x tile) operands (S4 = S rounded up to 4;
// one thread builds one column); the upper triangle of G is cut into 4x4
// register tiles, and each thread owns one tile for one of
// floor(256 / tiles) interleaved column groups, so a column costs 16 shared
// loads per 32 FMAs. The groups are summed in a fixed order into one partial
// per block, and a second kernel adds the partials of each entry of G in
// float64 with a fixed-order tree: no float atomics, bitwise reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12032;  // 47 KB of the 48 KB a block may declare
constexpr int kAssembleThreads = 256;

__device__ __forceinline__ int tri_index(int a, int b, int nt) {
  // index of tile (a, b), a <= b, in the row-major upper triangle of nt x nt
  return a * nt - (a * (a - 1)) / 2 + (b - a);
}

__global__ void __launch_bounds__(kThreads)
gn_rows_kernel(const float* __restrict__ j1, const float* __restrict__ j2,
               const float* __restrict__ r1, const float* __restrict__ r2,
               const int* __restrict__ sid, const int* __restrict__ tid,
               const float* __restrict__ w, long long M, int num_clouds,
               int cols_per_block, int tile_cols, float* __restrict__ partials) {
  __shared__ float buf[kSmemFloats];

  const int t = threadIdx.x;
  const int n = 6 * num_clouds;
  const int nt = (n + 1 + 3) / 4, S4 = 4 * nt;
  const int ntile = nt * (nt + 1) / 2;
  const int groups = kThreads / ntile;
  const int pitch = tile_cols + 1;
  float* A1 = buf;
  float* A2 = buf + S4 * pitch;
  const long long col0 = (long long)blockIdx.x * cols_per_block;

  const int tile = t / groups, grp = t % groups;
  const bool computes = tile < ntile;
  int ta = 0, tb = 0;
  if (computes) {
    int k = tile;
    while (k >= nt - ta) {
      k -= nt - ta;
      ++ta;
    }
    tb = ta + k;
  }

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int base = 0; base < cols_per_block; base += tile_cols) {
    if (t < tile_cols) {
      const long long col = col0 + base + t;
      const bool live = base + t < cols_per_block && col < M;
      float a1[6], a2[6], q1 = 0.f, q2 = 0.f, sw = 0.f;
      int s = -1, tg = -1;
#pragma unroll
      for (int k = 0; k < 6; ++k) a1[k] = a2[k] = 0.f;
      if (live) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          a1[k] = __ldg(j1 + k * M + col);
          a2[k] = __ldg(j2 + k * M + col);
        }
        q1 = __ldg(r1 + col);
        q2 = __ldg(r2 + col);
        sw = sqrtf(__ldg(w + col));
        s = __ldg(sid + col);
        tg = __ldg(tid + col);
      }
      for (int c = 0; c < num_clouds; ++c) {
        const float s1 = (float)(tg == c) - (float)(s == c);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          A1[(6 * c + k) * pitch + t] = (a1[k] * s1) * sw;
          A2[(6 * c + k) * pitch + t] = (a2[k] * -s1) * sw;
        }
      }
      A1[n * pitch + t] = q1 * sw;
      A2[n * pitch + t] = q2 * sw;
      for (int r = n + 1; r < S4; ++r) {
        A1[r * pitch + t] = 0.f;
        A2[r * pitch + t] = 0.f;
      }
    }
    __syncthreads();
    if (computes) {
      const float* x1 = A1 + 4 * ta * pitch;
      const float* y1 = A1 + 4 * tb * pitch;
      const float* x2 = A2 + 4 * ta * pitch;
      const float* y2 = A2 + 4 * tb * pitch;
      for (int c = grp; c < tile_cols; c += groups) {
        float xa[4], ya[4], xb[4], yb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xa[u] = x1[u * pitch + c];
          ya[u] = y1[u * pitch + c];
          xb[u] = x2[u * pitch + c];
          yb[u] = y2[u * pitch + c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(xb[u], yb[v], fmaf(xa[u], ya[v], acc[u][v]));
      }
    }
    __syncthreads();
  }

  // sum the column groups of each tile in a fixed order (the staging buffer
  // is free now, and tiles * groups * 16 <= 256 * 16 floats fit in it)
  float* red = buf;
  if (computes) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) red[(tile * groups + grp) * 16 + u * 4 + v] = acc[u][v];
  }
  __syncthreads();
  float* out = partials + (long long)blockIdx.x * ntile * 16;
  for (int e = t; e < ntile * 16; e += kThreads) {
    const int te = e / 16, uv = e % 16;
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += red[(te * groups + g) * 16 + uv];
    out[e] = sum;
  }
}

__global__ void __launch_bounds__(kAssembleThreads)
gn_rows_assemble_kernel(const float* __restrict__ partials, int nblocks,
                        int num_clouds, double* __restrict__ G) {
  // one block per entry of G; its threads stride over the partials and a
  // fixed-order shared-memory tree adds their float64 sums
  __shared__ double red[kAssembleThreads];
  const int S = 6 * num_clouds + 1;
  const int nt = (S + 3) / 4;
  const int ntile = nt * (nt + 1) / 2;
  const int t = threadIdx.x;
  int i = blockIdx.x / S, j = blockIdx.x % S;
  if (i > j) {  // G is symmetric; only tiles on or above the diagonal exist
    const int k = i;
    i = j;
    j = k;
  }
  const int e = tri_index(i / 4, j / 4, nt) * 16 + (i % 4) * 4 + (j % 4);
  double acc = 0.0;
  for (int blk = t; blk < nblocks; blk += kAssembleThreads)
    acc += (double)partials[(long long)blk * ntile * 16 + e];
  red[t] = acc;
  __syncthreads();
  for (int off = kAssembleThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] += red[t + off];
    __syncthreads();
  }
  if (t == 0) G[blockIdx.x] = red[0];
}

}  // namespace

extern "C" int dpt_gn_rows(const void* j1, const void* j2, const void* r1,
                           const void* r2, const void* sid, const void* tid,
                           const void* w, long long M, int num_clouds,
                           int cols_per_block, int tile_cols, void* partials,
                           int nblocks, void* G, void* stream) {
  if (num_clouds < 1 || M <= 0 || cols_per_block <= 0 || nblocks <= 0) return (int)cudaErrorInvalidValue;
  const int S = 6 * num_clouds + 1;
  const int nt = (S + 3) / 4;
  if (nt * (nt + 1) / 2 > kThreads || tile_cols < 1 || tile_cols > kThreads ||
      2 * 4 * nt * (tile_cols + 1) > kSmemFloats ||
      (long long)cols_per_block * nblocks < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gn_rows_kernel<<<nblocks, kThreads, 0, st>>>(
      (const float*)j1, (const float*)j2, (const float*)r1, (const float*)r2,
      (const int*)sid, (const int*)tid, (const float*)w, M, num_clouds,
      cols_per_block, tile_cols, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_rows_assemble_kernel<<<S * S, kAssembleThreads, 0, st>>>(
      (const float*)partials, nblocks, num_clouds, (double*)G);
  return (int)cudaGetLastError();
}
