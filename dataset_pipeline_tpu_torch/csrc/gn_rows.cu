// ICP Gauss-Newton accumulation from precomputed rows with per-row cloud ids:
// G = [[H, b], [b^T, cost]] (S x S, S = 6C + 1) in float64.
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/pallas_gn.py `_gn_kernel`
// (called through `icp_hb_cost_pallas`). Per correspondence the inputs are
// the global-frame Jacobian vectors j1, j2 ((6, M), no padding), the
// residuals r1, r2, the weight w >= 0 and the source and target cloud ids.
// The Pallas body builds the dense one-hot operands
// A1 = sqrt(w) [s (x) j1; r1], A2 = sqrt(w) [-s (x) j2; r2] with
// s = [tid == c] - [sid == c] over the C clouds and contracts them on the MXU.
// Written out, its two products are
//   H    = sum (s s^T) (x) P,  P = w (j1 j1^T + j2 j2^T)   (21 distinct sums)
//   b    = sum s (x) q,        q = w (j1 r1 - j2 r2)        (6)
//   cost = sum w (r1^2 + r2^2)                              (1)
// the 28 weighted sums of B1 (gn_fused.cu), about 60 FMAs a row. s depends
// on the row's class alone: map an id outside [0, C) to the symbol C ("out",
// it matches no block, as in the one-hot rule). Equal mapped ids give s = 0:
// the row adds to the cost only. Otherwise the class is the pair a < b of the
// mapped ids (b may be "out"), one of K = C (C + 1) / 2, and s = sigma
// (e_a - e_b) with sigma = +1 when a is the target's id. A class's sums P and
// sigma q expand into G as H[a,a] += P, b[a] += sigma q and, when b < C,
// H[b,b] += P, H[a,b] = H[b,a] -= P, b[b] -= sigma q.
//
// Bound on the H100: device memory, 68 B a row (0.16 ms at 8M rows and
// 3.35 TB/s); the 28 sums are ~125 flops a row (0.015 ms at 67 TFLOP/s).
// Design:
// - A persistent grid (dpt_gn_rows_grid: SMs x resident blocks). Block b
//   takes the contiguous run of 128-row units [b U / grid, (b + 1) U / grid);
//   its warps interleave over the run. Lane l of a unit holds rows l, l + 32,
//   l + 64, l + 96: each of a row's 17 values is one 128-byte warp request
//   whatever M is, and a thread issues the 68 loads of its next unit before
//   the arithmetic of the present one.
// - A unit is uniform when its rows that are not cost-only share one class
//   (a warp vote on the class keys). A uniform unit adds into 28 per-thread
//   registers that hold the sums of the warp's current class; a class change
//   adds them (a shuffle butterfly) into the warp's class tables in shared
//   memory. The engine's ids, sorted by cloud pair, are uniform but at the
//   pair borders; so is every unit at C = 2 with in-range ids, since every
//   such row with sid != tid is the class {0,1}.
// - A mixed unit (random ids at C >= 3): every lane adds its rows straight
//   into its class's row of one of the warp's class tables, which
//   32 / tables lanes share. Lanes of one table with the same class take
//   turns in lane order (__match_any_sync), a __syncwarp between turns; rows
//   of an odd pitch keep the lanes of a turn on distinct banks. The tables
//   take at most 190 KB of shared memory, so that the L1 keeps 60 KB for the
//   streamed loads: with tables of 218 KB (28 KB of L1) every unit read 4.6 %
//   slower, with 178 KB not measurably (PERF.md §6). Fewer tables cost
//   turns instead: at C = 3, 16 tables in place of 32 took 19 % longer.
// - At the block's end each warp adds its tables, then the block its warps,
//   in a fixed order into one record of 28 floats per class. The assembly
//   launch gives each class one block, which adds the class's records in
//   float64 (lanes own sums, warps stride over the records, a fixed-order
//   sum of the warps); the block that draws the last ticket expands the K
//   class totals into G. No float atomics: every sum has an order fixed by
//   the shapes, the grid and the ids, so two launches give the same bits,
//   and G is exactly symmetric.
//
// The predecessor staged the dense operands in shared memory and
// contracted the (S rounded up to 4)^2 upper triangle in 4x4 register tiles,
// (S^2 + S) FMAs a row where 13 non-zeros per column need 91, then added
// ~2000 partials with one scattered float read per partial and entry. Two
// other forms of a mixed unit were measured and dropped: lanes owning the 27
// sums and walking the unit sorted by class, and a warp butterfly per class
// present (PERF.md §6).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;       // P (21, row-major upper triangle), sigma q (6), the cost
constexpr int kStaged = 27;     // the class-dependent ones
constexpr int kSlotPitch = 29;  // floats per (class, table) row of a class table: 28 used, odd
constexpr int kUnit = 128;      // rows per unit: one warp, four steps of 32
constexpr int kSteps = kUnit / 32;
constexpr size_t kTableSmem = 190 * 1024;  // class tables of a block, at most (but one table a warp)
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory a block may have on the H100
constexpr int kMaxClouds = 21;             // eight warps' single tables fit in kMaxSmem up to here
constexpr int kNone = -1;                  // class key of a row that adds to the cost only
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int num_classes(int num_clouds) {
  return num_clouds * (num_clouds + 1) / 2;
}

__device__ __forceinline__ int pair_class(int a, int b) {  // a < b <= C
  return b * (b - 1) / 2 + a;
}

__device__ __forceinline__ int sym6(int a, int b) {
  // index of (a, b), a <= b, in the row-major upper triangle of a 6x6 matrix
  return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

__host__ __device__ constexpr size_t pass_smem_bytes(int num_clouds, int tables) {
  return sizeof(float) * kWarps * num_classes(num_clouds) * tables * kSlotPitch;
}
static_assert(pass_smem_bytes(kMaxClouds, 1) <= kMaxSmem && pass_smem_bytes(kMaxClouds + 1, 1) > kMaxSmem,
              "kMaxClouds is the most clouds whose one table a warp fits");

// Class tables a warp keeps: the most (a power of two up to 32, one per lane)
// within kTableSmem, and one at least.
int tables_for(int num_clouds) {
  int tables = 32;
  while (tables > 1 && pass_smem_bytes(num_clouds, tables) > kTableSmem) tables /= 2;
  return tables;
}

struct Rows {
  const float* j1;
  const float* j2;
  const float* r1;
  const float* r2;
  const float* w;
  const int* sid;
  const int* tid;
  long long M;
};

// One row: j1 (6), j2 (6), r1, r2, w; its two cloud ids.
struct Row {
  float f[15];
  int s, t;
};

// The rows of lane `lane` in unit u (streaming loads: every byte is read
// once); past the end, zeros and two unknown ids.
__device__ __forceinline__ void load_unit(const Rows& in, long long u, int lane, Row* rows) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const long long r = u * kUnit + 32 * i + lane;
    Row& x = rows[i];
    if (r < in.M) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        x.f[k] = __ldcs(in.j1 + k * in.M + r);
        x.f[6 + k] = __ldcs(in.j2 + k * in.M + r);
      }
      x.f[12] = __ldcs(in.r1 + r);
      x.f[13] = __ldcs(in.r2 + r);
      x.f[14] = __ldcs(in.w + r);
      x.s = __ldcs(in.sid + r);
      x.t = __ldcs(in.tid + r);
    } else {
#pragma unroll
      for (int k = 0; k < 15; ++k) x.f[k] = 0.f;
      x.s = x.t = -1;
    }
  }
}

// The row's class key (kNone for a cost-only row) and sigma = s_a.
__device__ __forceinline__ int class_key(const Row& x, int C, float* sigma) {
  const int ms = (unsigned)x.s < (unsigned)C ? x.s : C;
  const int mt = (unsigned)x.t < (unsigned)C ? x.t : C;
  *sigma = ms < mt ? -1.f : 1.f;
  if (ms == mt) return kNone;
  return ms < mt ? pair_class(ms, mt) : pair_class(mt, ms);
}

// acc[0..26] += the row's class-dependent sums with weight wp (0 for a
// cost-only row).
__device__ __forceinline__ void add_row(const Row& x, float wp, float sigma, float* acc) {
  float u[6], v[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    u[a] = wp * x.f[a];
    v[a] = wp * x.f[6 + a];
  }
  const float s1 = sigma * x.f[12], s2 = -sigma * x.f[13];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b)
      acc[sym6(a, b)] = fmaf(u[a], x.f[b], fmaf(v[a], x.f[6 + b], acc[sym6(a, b)]));
    acc[21 + a] = fmaf(u[a], s1, fmaf(v[a], s2, acc[21 + a]));
  }
}

__device__ __forceinline__ float row_cost(const Row& x) {
  return x.f[14] * fmaf(x.f[12], x.f[12], x.f[13] * x.f[13]);
}

// The 28 sums summed over the warp's lanes (a fixed-order butterfly); lane
// l < 28 adds sum l into slot[l]. Call with all lanes.
__device__ __forceinline__ void warp_add(float* v, float* slot, int lane) {
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
    if (lane == k) mine = v[k];
  }
  if (lane < kSums) slot[lane] += mine;
}

// A mixed unit: each lane adds its rows into its class's row of its table;
// lanes of one table with the same class take turns in lane order.
__device__ __forceinline__ void add_to_tables(const Row* rows, const int* key, const float* sigma,
                                              float* slots, int tables, int lane) {
  const int share = 32 / tables, table = lane / share;
  const unsigned mates = share == 32 ? kFull : ((1u << share) - 1u) << (table * share);
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool classed = key[i] != kNone;
    const int turn = __popc(__match_any_sync(kFull, key[i]) & mates & ((1u << lane) - 1u));
    float* row = slots + ((classed ? key[i] : 0) * tables + table) * kSlotPitch;
    for (int r = 0; __ballot_sync(kFull, classed && turn >= r) != 0; ++r) {
      if (classed && turn == r) {
        float v[kStaged];
#pragma unroll
        for (int k = 0; k < kStaged; ++k) v[k] = row[k];
        add_row(rows[i], rows[i].f[14], sigma[i], v);
#pragma unroll
        for (int k = 0; k < kStaged; ++k) row[k] = v[k];
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gn_rows_pass_kernel(Rows in, int num_clouds, int tables, float* __restrict__ records) {
  extern __shared__ __align__(16) float smem[];  // the warps' class tables
  const int K = num_classes(num_clouds), table_floats = K * tables * kSlotPitch;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* slots = smem + warp * table_floats;
  for (int i = t; i < kWarps * table_floats / 4; i += kThreads)  // a multiple of 4: kWarps = 8
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const long long units = (in.M + kUnit - 1) / kUnit;
  const long long u_end = ((long long)blockIdx.x + 1) * units / gridDim.x;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  int cur = 0;  // the class whose sums the registers hold (table 0's row)
  long long u = (long long)blockIdx.x * units / gridDim.x + warp;
  bool have = u < u_end;
  Row next[kSteps];
  if (have) load_unit(in, u, lane, next);
  while (have) {
    Row rows[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) rows[i] = next[i];
    u += kWarps;
    have = u < u_end;
    if (have) load_unit(in, u, lane, next);
    int key[kSteps], first = kNone;  // first: this lane's first classed row's key
    float sigma[kSteps];
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      key[i] = class_key(rows[i], num_clouds, &sigma[i]);
      if (key[i] != kNone) first = key[i];
      acc[kSums - 1] += row_cost(rows[i]);
    }
    const unsigned classed = __ballot_sync(kFull, first != kNone);
    const int lead = classed ? __shfl_sync(kFull, first, __ffs(classed) - 1) : kNone;
    bool other = false;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) other |= key[i] != kNone && key[i] != lead;
    if (__ballot_sync(kFull, other) == 0) {  // uniform: one class, or cost-only rows
      if (lead != kNone && lead != cur) {
        warp_add(acc, slots + cur * tables * kSlotPitch, lane);
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
        cur = lead;
      }
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
        add_row(rows[i], key[i] == kNone ? 0.f : rows[i].f[14], sigma[i], acc);
    } else {
      add_to_tables(rows, key, sigma, slots, tables, lane);
    }
  }
  warp_add(acc, slots + cur * tables * kSlotPitch, lane);
  if (tables > 1) {  // each warp adds its tables into table 0, even and odd tables apart
    __syncwarp();
    for (int e = lane; e < K * kSums; e += 32) {
      float* col = slots + (e / kSums) * tables * kSlotPitch + e % kSums;
      float even = 0.f, odd = 0.f;
      for (int tb = 0; tb < tables; tb += 2) {
        even += col[tb * kSlotPitch];
        odd += col[(tb + 1) * kSlotPitch];
      }
      col[0] = even + odd;
    }
  }
  __syncthreads();
  // one record of 28 floats per class: the warps' tables added in warp order
  float* rec = records + (long long)blockIdx.x * K * kSums;
  for (int e = t; e < K * kSums; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += smem[w * table_floats + (e / kSums) * tables * kSlotPitch + e % kSums];
    rec[e] = s;
  }
}

// True in every thread of the block that draws the last ticket; that block
// then sees what every block wrote before it drew its own.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last != 0;
}

// Entry (i, j) of G from the class totals (K x 28 float64), by the expansion
// in the header; the same expression for (i, j) and (j, i).
__device__ double g_entry(int i, int j, int C, const double* totals) {
  const int n = 6 * C;
  if (i < n && j < n) {
    const int ci = i / 6, cj = j / 6, a = i % 6, b = j % 6;
    const int idx = a <= b ? sym6(a, b) : sym6(b, a);
    if (ci != cj) return -__ldcg(totals + pair_class(min(ci, cj), max(ci, cj)) * kSums + idx);
    double s = 0.0;
    for (int x = 0; x <= C; ++x)
      if (x != ci) s += __ldcg(totals + pair_class(min(ci, x), max(ci, x)) * kSums + idx);
    return s;
  }
  if (i < n || j < n) {
    const int r = i < n ? i : j, c = r / 6;
    double s = 0.0;
    for (int x = 0; x <= C; ++x) {
      if (x == c) continue;
      const double v = __ldcg(totals + pair_class(min(c, x), max(c, x)) * kSums + 21 + r % 6);
      s += c < x ? v : -v;
    }
    return s;
  }
  double s = 0.0;
  for (int k = 0; k < num_classes(C); ++k) s += __ldcg(totals + k * kSums + kSums - 1);
  return s;
}

// Block k adds class k's records in float64 into totals[k]; the last block
// expands the totals into G.
__global__ void __launch_bounds__(kThreads)
gn_rows_assemble_kernel(const float* records, int nblocks, int num_clouds, double* totals,
                        unsigned int* ticket, double* __restrict__ G) {
  __shared__ double part[kWarps][kSums];
  const int K = num_classes(num_clouds), k = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (lane < kSums) {
    double s = 0.0;
    for (int b = warp; b < nblocks; b += kWarps)
      s += (double)__ldcg(records + ((long long)b * K + k) * kSums + lane);
    part[warp][lane] = s;
  }
  __syncthreads();
  if (t < kSums) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += part[w][t];
    totals[k * kSums + t] = s;
  }
  if (!last_block(ticket)) return;
  const int S = 6 * num_clouds + 1;
  for (int e = t; e < S * S; e += kThreads) G[e] = g_entry(e / S, e % S, num_clouds, totals);
  if (t == 0) *ticket = 0u;  // ready for the next call
}

cudaError_t allow_smem(int num_clouds) {
  return cudaFuncSetAttribute(gn_rows_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)pass_smem_bytes(num_clouds, tables_for(num_clouds)));
}

}  // namespace

// Blocks of a persistent pass launch at `num_clouds` on the current device:
// SMs x resident blocks per SM; negative (minus the cudaError_t) when the
// runtime refuses.
extern "C" int dpt_gn_rows_grid(int num_clouds) {
  if (num_clouds < 1 || num_clouds > kMaxClouds) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(num_clouds);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gn_rows_pass_kernel, kThreads, pass_smem_bytes(num_clouds, tables_for(num_clouds)));
  if (err != cudaSuccess) return -(int)err;
  return sms * blocks;
}

// `scratch` holds nblocks x K x 28 floats of records, then K x 28 float64
// class totals; `ticket` one unsigned int that is 0 at every call (the
// assembly leaves it so); G is (6C+1, 6C+1) float64, row-major.
extern "C" int dpt_gn_rows(const void* j1, const void* j2, const void* r1, const void* r2,
                           const void* sid, const void* tid, const void* w, long long M,
                           int num_clouds, int nblocks, void* scratch, void* ticket, void* G,
                           void* stream) {
  if (num_clouds < 1 || num_clouds > kMaxClouds || M <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int K = num_classes(num_clouds), tables = tables_for(num_clouds);
  const Rows in{(const float*)j1, (const float*)j2, (const float*)r1, (const float*)r2,
                (const float*)w,  (const int*)sid,  (const int*)tid,  M};
  float* records = (float*)scratch;
  double* totals = (double*)(records + (long long)nblocks * K * kSums);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = allow_smem(num_clouds);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pass_smem_bytes(num_clouds, tables);
  gn_rows_pass_kernel<<<nblocks, kThreads, smem, st>>>(in, num_clouds, tables, records);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_rows_assemble_kernel<<<K, kThreads, 0, st>>>(records, nblocks, num_clouds, totals,
                                                  (unsigned int*)ticket, (double*)G);
  return (int)cudaGetLastError();
}
