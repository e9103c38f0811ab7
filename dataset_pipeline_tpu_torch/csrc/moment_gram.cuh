// Device code shared by the monomial moment Gram kernels (moment_gram.cu,
// moment_gram48.cu, moment_gram_thirds.cu, moment_gram_repeat.cu): one block
// computes P = sum m m^T (42x42) over `rows` consecutive correspondences.
//
// The 42 pose-independent monomials of a correspondence are (layout of
// icp/moments.py)  m = [b; ps_k * b; pt_k * b], k = 0..2, b = sqrt(w) [ns; nt],
// that is m = a (x) b, a Kronecker product with a = [1, ps, pt] (7 values) and
// b (6). So P = sum_r kron(a a^T, b b^T): entry (6i+c, 6j+d) is
// sum a_i a_j w n_c n_d, symmetric in (i, j) and in (c, d) separately, and P
// has only 28 x 21 = 588 distinct sums. They are the dense product U^T V of
// u = vech(a a^T) (28 values per row, u_00 = 1) and v = w vech(n n^T) (21;
// no square root is needed).
//
// Bound on the H100: fp32 FMA throughput. A correspondence is 13 floats
// (52 B: 0.125 ms at 3.35 TB/s for 8.06M) against 588 FMAs plus the 48
// products that build u and v (1224 flop: 0.147 ms at 67 TFLOP/s). Tensor
// cores would need TF32 (or 3xTF32, whose error against the moment LM's
// noise floor of 1e-7 ||P||_F is unproven), so the kernels stay on the fp32
// pipes. Design:
// - a warp builds and multiplies its own 32 rows of each 256-row tile, so
//   the 8 warps of a block never wait for each other inside the loop (with
//   one __syncthreads per tile every warp waited for the slowest: 0.34 ms
//   against 0.30 at 8.06M on the H100);
// - the 13 inputs of a warp's rows are copied into its ring of four raw tiles
//   in shared memory by cp.async, three tiles ahead of the one being
//   multiplied; a lane copies one row and reads back only that row, so the
//   ring needs no barrier;
// - from its raw row each lane builds the row's u (four groups of 7 in 8
//   slots) and v (21 in 24 slots) into a staged row of 60 floats, so that a
//   lane reads its operands as 16-byte loads and the 8 rows a warp reads at
//   once fall on distinct banks; __syncwarp orders the build, the FMAs and
//   the next build;
// - each thread owns a 7 x 21 register tile (one u group by all of v: 147
//   FMAs per row for 8 loads of 16 bytes, 4.7 FMAs per shared float) for
//   every 8th of its warp's rows: lane bits 0-1 pick the u group, bits 2-4
//   the first row, so the 4 lanes of a row share its v;
// - the 64 row groups are summed at the end, in a fixed order with no
//   atomics: a reduce-scatter over the 8 lanes of a u group by warp shuffles,
//   then the 8 warps through shared memory. Every output entry is gathered
//   from its one sum (up to four entries share one), so the result is
//   bitwise reproducible and exactly symmetric.
#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace moment {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // rows per pass of the block (one built by each thread)
constexpr int kMono = 42;
constexpr int kU = 28;       // vech(a a^T), a = [1, ps, pt]
constexpr int kV = 21;       // w vech(n n^T), n = [ns, nt]
constexpr int kUGroup = 7;   // u values of one register tile
constexpr int kUGroups = 4;  // 4 x 7 = 28
constexpr int kUSlots = 8;   // shared slots of a u group (one pad)
constexpr int kVOff = kUGroups * kUSlots;  // 32
constexpr int kVSlots = 24;  // 21 + 3 pads
constexpr int kPitch = 60;   // floats per staged row: 56 used; 60 = 28 mod 32 banks
constexpr int kAcc = kUGroup * kV;                // 147 sums per thread
constexpr int kAccPadded = 152;                   // a multiple of 8 for the reduce-scatter
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTile / kWarps;      // 32 rows of a tile per warp, one per lane
constexpr int kInputs = 13;  // floats of a packed row: ps, ns, pt, nt, w
constexpr int kStages = 4;   // raw tiles in a warp's ring: three copies in flight
constexpr int kStageFloats = kTile * kPitch;   // the block's staged rows
constexpr int kRawFloats = kInputs * kWarpRows;  // one raw tile of a warp
// dynamic shared memory of a block: the staged rows of every warp (the warp
// sums of the end reuse them), then every warp's ring of raw tiles
constexpr int kSmemBytes = (kStageFloats + kWarps * kStages * kRawFloats) * (int)sizeof(float);
static_assert(kWarps * kUGroups * kAcc <= kStageFloats, "the warp sums fit the staged rows");

// index of (i, j), i <= j, in vech of an n x n symmetric matrix (row-major
// upper triangle)
__device__ __forceinline__ int vech(int n, int i, int j) { return i * n - i * (i - 1) / 2 + (j - i); }

// Copies row `col` of the packed tensor (13 floats, `stride` apart) into this
// lane's column of a raw tile, asynchronously, as one commit group (empty
// when the row lies past the block's rows).
__device__ __forceinline__ void fetch_column(const float* __restrict__ data, long long stride,
                                             long long col, bool valid, float* __restrict__ raw) {
  if (valid) {
#pragma unroll
    for (int k = 0; k < kInputs; ++k)
      __pipeline_memcpy_async(raw + k * kWarpRows, data + col + k * stride, sizeof(float));
  }
  __pipeline_commit();
}

// This lane's column of a raw tile (zeros for a row past the block's rows:
// w = 0 makes v = 0, so such a row adds nothing).
__device__ __forceinline__ void read_column(const float* __restrict__ raw, bool valid,
                                            float (&x)[kInputs]) {
#pragma unroll
  for (int k = 0; k < kInputs; ++k) x[k] = valid ? raw[k * kWarpRows] : 0.f;
}

// u and v of one row, stored into its staged row
__device__ __forceinline__ void build_row(const float (&x)[kInputs], float* __restrict__ row) {
  const float a[7] = {1.f, x[0], x[1], x[2], x[6], x[7], x[8]};
  const float n[6] = {x[3], x[4], x[5], x[9], x[10], x[11]};
  float u[kUGroups * kUSlots];
  int p = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = i; j < 7; ++j, ++p) u[(p / kUGroup) * kUSlots + p % kUGroup] = i == 0 ? a[j] : a[i] * a[j];
#pragma unroll
  for (int g = 0; g < kUGroups; ++g) u[g * kUSlots + kUGroup] = 0.f;
  float wn[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) wn[c] = x[12] * n[c];
  float v[kVSlots];
  int q = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int d = c; d < 6; ++d, ++q) v[q] = wn[c] * n[d];
#pragma unroll
  for (int s = kV; s < kVSlots; ++s) v[s] = 0.f;
  float4* dst = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int k = 0; k < kUGroups * kUSlots / 4; ++k)
    dst[k] = make_float4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
#pragma unroll
  for (int k = 0; k < kVSlots / 4; ++k)
    dst[kVOff / 4 + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// acc += u_group (7) x v (21) of one staged row
__device__ __forceinline__ void fma_row(const float* __restrict__ row, int ug,
                                        float (&acc)[kAccPadded]) {
  const float4* src = reinterpret_cast<const float4*>(row);
  const float4 u0 = src[2 * ug], u1 = src[2 * ug + 1];
  float4 vq[kVSlots / 4];
#pragma unroll
  for (int k = 0; k < kVSlots / 4; ++k) vq[k] = src[kVOff / 4 + k];
  const float u[kUGroup] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z};
  const float* v = reinterpret_cast<const float*>(vq);
#pragma unroll
  for (int i = 0; i < kUGroup; ++i)
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[i * kV + j] = fmaf(u[i], v[j], acc[i * kV + j]);
}

// One halving step of the reduce-scatter over lanes `mask` apart: the lane
// with the mask bit set keeps (and moves to the front) the upper half of its
// H-entry span, its partner the lower half, each adding the other's entries.
template <int H>
__device__ __forceinline__ void halve(float (&acc)[kAccPadded], int mask) {
  const bool upper = (threadIdx.x & mask) != 0;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float send = upper ? acc[m] : acc[m + H];
    const float keep = upper ? acc[m + H] : acc[m];
    acc[m] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// The Gram of rows [row0, row0 + rows) of `data` (row r of the packed tensor
// at data + r * stride), written to the (pitch x pitch) matrix `out`
// (pitch >= 42; rows and columns from 42 on are set to zero), or added to it
// when kAccumulate. Every thread of the 256-thread block must call it, with
// kSmemBytes of dynamic shared memory at `smem` (16-byte aligned).
template <bool kAccumulate>
__device__ __forceinline__ void gram_block(const float* __restrict__ data, long long stride,
                                           long long row0, int rows, float* __restrict__ out,
                                           int pitch, float* __restrict__ smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ug = lane & 3;   // u group of this thread's register tile
  const int q = lane >> 2;   // its staged rows: q, q + 8, q + 16, q + 24

  float acc[kAccPadded];
#pragma unroll
  for (int e = 0; e < kAccPadded; ++e) acc[e] = 0.f;

  const int tiles = (rows + kTile - 1) / kTile;
  const int mine = warp * kWarpRows + lane;  // the row this lane copies and builds in a tile
  float* stage = smem + warp * kWarpRows * kPitch;
  float* raw = smem + kStageFloats + warp * kStages * kRawFloats + lane;  // raw tile 0
  // the ring: tile t in raw tile t % kStages, kStages - 1 tiles ahead
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t)
    fetch_column(data, stride, row0 + t * kTile + mine, t * kTile + mine < rows, raw + t * kRawFloats);
  for (int t = 0; t < tiles; ++t) {
    __pipeline_wait_prior(kStages - 2);  // tile t has landed
    float x[kInputs];
    read_column(raw + (t % kStages) * kRawFloats, t * kTile + mine < rows, x);
    const int ahead = t + kStages - 1;  // into the raw tile read one pass ago
    fetch_column(data, stride, row0 + ahead * kTile + mine, ahead * kTile + mine < rows,
                 raw + (ahead % kStages) * kRawFloats);
    build_row(x, stage + lane * kPitch);
    __syncwarp();
#pragma unroll 2
    for (int r = q; r < kWarpRows; r += 8) fma_row(stage + r * kPitch, ug, acc);
    __syncwarp();
  }

  // the 8 lanes of a u group: after three halvings lane bits 4, 3, 2 name the
  // 19-entry span [76 b4 + 38 b3 + 19 b2, + 19) of the 152 that it holds
  halve<kAccPadded / 2>(acc, 16);
  halve<kAccPadded / 4>(acc, 8);
  halve<kAccPadded / 8>(acc, 4);
  const int span = (lane & 16 ? 76 : 0) + (lane & 8 ? 38 : 0) + (lane & 4 ? 19 : 0);
  float* red = smem;  // (warps, u groups, 147) over the staged rows, once every warp is done
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kAccPadded / 8; ++m)
    if (span + m < kAcc) red[(warp * kUGroups + ug) * kAcc + span + m] = acc[m];
  __syncthreads();

  for (int e = tid; e < kMono * kMono; e += kThreads) {
    const int A = e / kMono, B = e % kMono;
    const int i = A / 6, c = A % 6, j = B / 6, d = B % 6;
    const int p = vech(7, min(i, j), max(i, j)), q = vech(6, min(c, d), max(c, d));
    const float* s = red + (p / kUGroup) * kAcc + (p % kUGroup) * kV + q;
    float sum = s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += s[w * kUGroups * kAcc];
    float* o = out + A * pitch + B;
    *o = kAccumulate ? *o + sum : sum;
  }
  if (!kAccumulate) {
    for (int e = tid; e < pitch * pitch; e += kThreads)
      if (e / pitch >= kMono || e % pitch >= kMono) out[e] = 0.f;
  }
}

// Lets a kernel of this family take kSmemBytes of dynamic shared memory
// (above the 48 KB default); call before its launch.
template <class K>
inline cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

}  // namespace moment
