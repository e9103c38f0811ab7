// The residuals and Gram products of the photometric registrator's H,b
// accumulation: from each (image, point) row's intensity, validity and row of
// the intensity Jacobian J (nb, M, V), the per-image H (nb, V, V), b (nb, V),
// and the summed Huber cost and residual count.
//
// Replaces dataset_pipeline_tpu/photometric/optimizer.py `_gram_assemble`:
// there, under `jit`, neighbour gathers and batched products that XLA fuses;
// in the port's plain version (photometric/optimizer.py) some forty PyTorch
// launches per call, which write J out masked and read it back once per
// neighbour slot.
//
// Per row n of image b, with its K neighbours nbr_k (indices into the same
// image's rows) and descriptors d_k:
//   valid_k  = ok[nbr_k], read through the sentinel encoding of
//              `_nbr_inten_ok` (3e8 for an invalid row, valid below 1.5e8);
//   all_ok   = ok[n] & contrib[n] & every valid_k;
//   r_k      = (I[nbr_k] - I[n]) - d_k, norm = sqrt(max(sum_k r_k^2, 1e-20));
//   rho, w   = Huber's cost and weight of the norm (ops/robust.py; the weight
//              a true quotient k / a);
//   D_k      = J[nbr_k] - J[n];
//   H       += w sum_k D_k D_k^T,  b += w sum_k r_k D_k,  cost += rho.
// A row with all_ok false adds nothing (the plain version adds 0 x J there),
// so it reads no J: only residual rows are staged.
//
// Design. A block walks tiles of 256 rows of one image (grid (nb, G): the G
// blocks of an image take every G-th tile, so the images of one tile run side
// by side and share the neighbour lists in L2). A thread computes one row's
// residuals in registers, all K neighbour gathers in flight; a ballot
// compacts the tile's residual rows; the (row, k) items of the tile, K per
// residual row, are then staged 256 at a time in shared memory as augmented
// rows [D_k | r_k] of width kW (the V columns, zero padding up to the
// template width, r_k at column kV, zero padding to a multiple of kTS), with
// the row's weight beside them. D is copied entry by entry in row order, so
// that consecutive threads read consecutive columns of J, kCopy entries a
// thread with their loads in flight. The augmented Gram
// sum_items w [D|r][D|r]^T holds H in its top-left block and b in column kV.
// Its upper triangle of kTS x kTS tiles is split among a group of threads, one
// register tile each, fed by two float4 loads an item (as B2's moment Gram,
// moment_gram.cuh), and the block's groups take every kGroups-th item.
// Products are strict fp32 FMAs (no TF32, no tensor cores).
//
// Deterministic: no float atomics. A block sums its groups' tiles in a fixed
// order into one float64 record (with the cost and count), and a second
// launch sums each image's G records in a fixed order into H (written
// symmetric) and b, and all records into the cost and count.
//
// Widths: the template width kV is 6, 10, 18 or 24 (pose only; SIMPLE_PINHOLE
// and PINHOLE with intrinsics; THIN_PRISM_FISHEYE with intrinsics; a rig,
// 6 + 6 pose dofs, under a model of 12 intrinsics); a smaller V runs in the
// next width up with zero columns.
//
// Bound on the H100: bytes at V = 10 (every row's intensity, validity and
// contribution flag, 6 B; the neighbour lists and descriptors, 12 B a
// neighbour, once per point where the images share them; J's row of each
// residual row, 4 V B), operations at V = 18 ((V^2 + 5 V) per item: the upper
// triangle and b as FMAs, D and w D). The kernel is held far above either by
// the latency of its gathers (J rows and neighbour lists, scattered as the
// neighbour lists are): a variant whose warps stage and sum their own items,
// with no barrier of the block between stages, was no faster on the H100
// (chip_smoke.py:check_hb_gram prints time and bound).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows of a tile, items of a stage
constexpr int kTS = 4;         // a register tile is kTS x kTS entries, read as one float4
constexpr int kMaxV = 24;
constexpr int kCopy = 4;       // J entries a thread copies per pass of the stage
constexpr float kInvalid = 3.0e8f;    // optimizer.py _INVALID_INTENSITY
constexpr float kValidBelow = 1.5e8f;  // _nbr_inten_ok's test

template <int kV>
struct Layout {
  static constexpr int kW = (kV + 1 + kTS - 1) / kTS * kTS;  // [D | r | zeros]: float4 rows
  static constexpr int kT = kW / kTS;                        // tile rows
  static constexpr int kTiles = kT * (kT + 1) / 2;           // upper triangle
  static constexpr int kGroups = kThreads / kTiles;
  static constexpr int kEntries = kTiles * kTS * kTS;
  static constexpr int kRecord = kEntries + 2;  // + cost, count
  static constexpr int kRound = kThreads * kW / kEntries;  // groups summed per pass of the stage
  static constexpr int kPer = (kEntries + kThreads - 1) / kThreads;  // record entries a thread
};

static_assert(kTS == 4, "a register tile's row is one float4");
static_assert(Layout<6>::kRound >= 1 && Layout<10>::kRound >= 1 && Layout<18>::kRound >= 1 &&
                  Layout<kMaxV>::kRound >= 1,
              "a group's tiles fit the stage");

// the first tile of tile row ti in the row-major upper triangle of kT x kT
__host__ __device__ constexpr int tile_row_start(int ti, int kT) {
  return ti * kT - ti * (ti - 1) / 2;
}

__device__ __forceinline__ void tile_of(int t, int kT, int& ti, int& tj) {
  ti = 0;
  while (t >= kT - ti) t -= kT - ti, ++ti;
  tj = ti + t;
}

// clamp(x, min=lo) keeps a NaN, as the library's clamp does
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// a neighbour's intensity through the sentinel encoding: 0 where invalid
__device__ __forceinline__ float neighbour(const float* __restrict__ inten,
                                           const unsigned char* __restrict__ ok, int at,
                                           bool& valid) {
  const float enc = ok[at] ? inten[at] : kInvalid;
  valid = enc < kValidBelow;
  return valid ? enc : 0.f;
}

// x / d as (x * inv) >> 18 with inv = ceil(2^18 / d): exact for 0 <= x < 2^18 / d
__device__ __forceinline__ int div18(int x, int inv) { return (x * inv) >> 18; }
__host__ __device__ constexpr int inv18(int d) { return ((1 << 18) + d - 1) / d; }

// six blocks an SM (40 registers, a few spilled): faster than four at 58 on the H100
template <int kV>
__global__ void __launch_bounds__(kThreads, 6)
hb_gram_kernel(const float* __restrict__ J, int V, const float* __restrict__ inten,
               const unsigned char* __restrict__ ok, const long long* __restrict__ nbr,
               long long nbr_image_stride, const float* __restrict__ desc,
               long long desc_image_stride, const unsigned char* __restrict__ contrib, int M,
               int K, float huber_k, float huber_half_k, double* __restrict__ partial) {
  using L = Layout<kV>;
  __align__(16) __shared__ float stage[kThreads * L::kW];
  __shared__ float stage_w[kThreads];
  __shared__ int slot_row[kThreads];
  __shared__ float slot_w[kThreads];
  __shared__ int item_centre[kThreads], item_neighbour[kThreads];
  __shared__ int warp_count[kThreads / 32];
  __shared__ double red_cost[kThreads];
  __shared__ long long red_count[kThreads];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int inv_v = inv18(V);  // the copy's f < 256 V < 2^18 / V where V < 32
  const int inv_k = inv18(K);  // an item's i < 256 K < 2^18 / K where K < 32
  const int b = blockIdx.x, G = gridDim.y;
  const int grp = tid / L::kTiles, tile = tid - grp * L::kTiles;
  int ti, tj;
  tile_of(tile, L::kT, ti, tj);
  const bool computes = grp < L::kGroups;
  float acc[kTS][kTS] = {};
  float cost = 0.f;
  int count = 0;
  // the image's rows; indices within an image are 32-bit (M V, M K < 2^31)
  const long long img = (long long)b * M;
  const float* __restrict__ Jb = J + img * V;
  const float* __restrict__ ib = inten + img;
  const unsigned char* __restrict__ okb = ok + img;
  const unsigned char* __restrict__ cb = contrib + img;
  const long long* __restrict__ nbr_b = nbr + b * nbr_image_stride;
  const float* __restrict__ desc_b = desc + b * desc_image_stride;
  const int n_tiles = (M + kThreads - 1) / kThreads;
  // the staged rows' zero columns (V to kV, and past r_k at kV) stay zero
  for (int e = tid; e < kThreads * L::kW; e += kThreads) {
    const int c = e % L::kW;
    if (c >= V && c != kV) stage[e] = 0.f;
  }

  for (int tl = blockIdx.y; tl < n_tiles; tl += G) {
    const int m0 = tl * kThreads, m = m0 + tid;
    bool res = false;
    float w = 0.f;
    if (m < M && okb[m] && cb[m]) {
      const float i0 = ib[m];
      bool all = true;
      float ss = 0.f;
#pragma unroll 5
      for (int k = 0; k < K; ++k) {  // no early exit: the K gathers overlap
        bool valid;
        const float x = neighbour(ib, okb, (int)nbr_b[m * K + k], valid);
        const float r = __fsub_rn(__fsub_rn(x, i0), desc_b[m * K + k]);
        ss = __fadd_rn(ss, __fmul_rn(r, r));
        all = all && valid;
      }
      if (all) {
        const float norm = __fsqrt_rn(clamp_min(ss, 1e-20f));
        const float a = fabsf(norm);
        const bool inlier = a <= huber_k;
        const float rho = inlier ? __fmul_rn(__fmul_rn(0.5f, norm), norm)
                                 : __fmul_rn(huber_k, __fsub_rn(a, huber_half_k));
        w = inlier ? 1.f : __fdiv_rn(huber_k, clamp_min(a, 1e-30f));
        cost = __fadd_rn(cost, rho);
        ++count;
        res = true;
      }
    }
    // compact the tile's residual rows into slots, in row order
    __syncthreads();  // the last tile's readers of warp_count are done
    const unsigned ballot = __ballot_sync(0xffffffffu, res);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, R = 0;
    for (int x = 0; x < kThreads / 32; ++x) {
      base += x < warp ? warp_count[x] : 0;
      R += warp_count[x];
    }
    if (res) {
      const int s = base + __popc(ballot & ((1u << lane) - 1u));
      slot_row[s] = m;
      slot_w[s] = w;
    }
    __syncthreads();
    // stage the items (slot, k) 256 at a time, then the register tiles take them
    const int items = R * K;
    for (int i0 = 0; i0 < items; i0 += kThreads) {
      const int i = i0 + tid;
      const int n = items - i0 < kThreads ? items - i0 : kThreads;
      if (i < items) {  // the item's rows, weight and r_k
        const int s = K < 32 ? div18(i, inv_k) : i / K, k = i - s * K;
        const int ms = slot_row[s];
        const int j = (int)nbr_b[ms * K + k];
        item_centre[tid] = ms;
        item_neighbour[tid] = j;
        // r_k as the row's thread formed it (a valid neighbour's encoding is its intensity)
        stage[tid * L::kW + kV] = __fsub_rn(__fsub_rn(ib[j], ib[ms]), desc_b[ms * K + k]);
        stage_w[tid] = slot_w[s];
      }
      __syncthreads();
      // D = J[neighbour] - J[centre]: the batch's n x V entries in row order, consecutive
      // threads on consecutive columns, kCopy entries a thread with all their loads in flight
      for (int f0 = 0; f0 < n * V; f0 += kCopy * kThreads) {
        float d[kCopy];
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
          const int f = f0 + u * kThreads + tid;
          const int it = div18(f, inv_v), c = f - it * V;
          d[u] = f < n * V ? __fsub_rn(Jb[item_neighbour[it] * V + c], Jb[item_centre[it] * V + c])
                           : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
          const int f = f0 + u * kThreads + tid;
          const int it = div18(f, inv_v);
          if (f < n * V) stage[it * L::kW + f - it * V] = d[u];
        }
      }
      __syncthreads();
      if (computes) {
        for (int s = grp; s < n; s += L::kGroups) {
          const float* row = stage + s * L::kW;
          const float ws = stage_w[s];
          const float4 av = *reinterpret_cast<const float4*>(row + ti * kTS);
          const float4 cv = *reinterpret_cast<const float4*>(row + tj * kTS);
          const float a[kTS] = {__fmul_rn(ws, av.x), __fmul_rn(ws, av.y), __fmul_rn(ws, av.z),
                                __fmul_rn(ws, av.w)};
          const float c[kTS] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int x = 0; x < kTS; ++x)
#pragma unroll
            for (int y = 0; y < kTS; ++y) acc[x][y] = fmaf(a[x], c[y], acc[x][y]);
        }
      }
      __syncthreads();
    }
  }

  // the block's record: its cost and count by a fixed tree, its groups' tiles
  // summed in group order, all in float64
  double* rec = partial + ((long long)blockIdx.y * gridDim.x + b) * L::kRecord;
  red_cost[tid] = (double)cost;
  red_count[tid] = count;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) {
      red_cost[tid] += red_cost[tid + h];
      red_count[tid] += red_count[tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    rec[L::kEntries] = red_cost[0];
    rec[L::kEntries + 1] = (double)red_count[0];
  }
  double total[L::kPer] = {};
  for (int g0 = 0; g0 < L::kGroups; g0 += L::kRound) {
    if (computes && grp >= g0 && grp < g0 + L::kRound) {
      float* dst = stage + ((grp - g0) * L::kTiles + tile) * kTS * kTS;
#pragma unroll
      for (int x = 0; x < kTS; ++x)
#pragma unroll
        for (int y = 0; y < kTS; ++y) dst[x * kTS + y] = acc[x][y];
    }
    __syncthreads();
    const int groups = L::kGroups - g0 < L::kRound ? L::kGroups - g0 : L::kRound;
#pragma unroll
    for (int p = 0; p < L::kPer; ++p) {
      const int e = tid + p * kThreads;
      if (e < L::kEntries)
        for (int q = 0; q < groups; ++q) total[p] += stage[q * L::kEntries + e];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < L::kPer; ++p)
    if (tid + p * kThreads < L::kEntries) rec[tid + p * kThreads] = total[p];
}

// Each image's records summed over its G blocks in order: H (written
// symmetric from its upper triangle) and b; block 0 also sums every record's
// cost and count.
template <int kV>
__global__ void __launch_bounds__(kThreads)
hb_gram_finish_kernel(const double* __restrict__ partial, int V, int G, float* __restrict__ H,
                      float* __restrict__ bvec, float* __restrict__ cost,
                      long long* __restrict__ count) {
  using L = Layout<kV>;
  const int b = blockIdx.x, nb = gridDim.x;
  for (int o = threadIdx.x; o < V * V + V; o += kThreads) {
    int I, C;
    if (o < V * V) {
      I = o / V, C = o - I * V;
      if (I > C) {
        const int x = I;
        I = C, C = x;
      }
    } else {
      I = o - V * V, C = kV;  // b is the augmented Gram's column kV
    }
    const int e = (tile_row_start(I / kTS, L::kT) + C / kTS - I / kTS) * kTS * kTS +
                  (I % kTS) * kTS + C % kTS;
    double s = 0.0;
    for (int g = 0; g < G; ++g) s += partial[((long long)g * nb + b) * L::kRecord + e];
    if (o < V * V)
      H[(long long)b * V * V + o] = (float)s;
    else
      bvec[(long long)b * V + I] = (float)s;
  }
  if (b == 0 && threadIdx.x == 0) {
    double c = 0.0, n = 0.0;
    for (long long r = 0; r < (long long)G * nb; ++r) {
      c += partial[r * L::kRecord + L::kEntries];
      n += partial[r * L::kRecord + L::kEntries + 1];
    }
    *cost = (float)c;
    *count = (long long)n;
  }
}

int width_of(int V) { return V <= 6 ? 6 : V <= 10 ? 10 : V <= 18 ? 18 : 24; }

template <int kV>
int launch(cudaStream_t stream, const float* J, int V, const float* inten,
           const unsigned char* ok, const long long* nbr, long long nbr_stride, const float* desc,
           long long desc_stride, const unsigned char* contrib, int M, int nb, int K,
           int G, float huber_k, float huber_half_k, double* partial, float* H, float* b,
           float* cost, long long* count) {
  const dim3 grid(nb, G);
  hb_gram_kernel<kV><<<grid, kThreads, 0, stream>>>(
      J, V, inten, ok, nbr, nbr_stride, desc, desc_stride, contrib, M, K, huber_k, huber_half_k,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hb_gram_finish_kernel<kV><<<nb, kThreads, 0, stream>>>(partial, V, G, H, b, cost, count);
  return (int)cudaGetLastError();
}

template <int kV>
int grid_of() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hb_gram_kernel<kV>, kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

}  // namespace

extern "C" {

// Blocks of a full wave of the kernel for rows of width V on the current
// device (SMs x resident blocks per SM); negative (minus the cudaError_t) when
// the runtime refuses, 0 for a V it does not take.
int dpt_hb_gram_grid(int V) {
  if (V < 1 || V > kMaxV) return 0;
  switch (width_of(V)) {
    case 6: return grid_of<6>();
    case 10: return grid_of<10>();
    case 18: return grid_of<18>();
    default: return grid_of<24>();
  }
}

// Float64 values in the record of one block for rows of width V (0 for a V
// it does not take): `partial` holds nb x blocks_per_image of them.
int dpt_hb_gram_record(int V) {
  if (V < 1 || V > kMaxV) return 0;
  switch (width_of(V)) {
    case 6: return Layout<6>::kRecord;
    case 10: return Layout<10>::kRecord;
    case 18: return Layout<18>::kRecord;
    default: return Layout<24>::kRecord;
  }
}

// J (nb,M,V) float32; inten (nb,M) float32; ok and contrib (nb,M) bool;
// neighbours (M,K) int64 shared by the images (nbr_per_image 0) or
// (nb,M,K), each an index into its image's M rows; desc (M,K) or (nb,M,K)
// float32 likewise; huber_k and huber_half_k the Huber parameter and half of
// it, as float32. M x V and M x K below 2^31 (indices within an image are
// 32-bit). blocks_per_image (>= 1) blocks walk each image's tiles;
// partial is scratch of nb x blocks_per_image records (dpt_hb_gram_record).
// Writes H (nb,V,V), b (nb,V), cost (one float32) and count (one int64). All
// device pointers, contiguous. Two launches; returns a cudaError_t (0 =
// launched).
int dpt_hb_gram(const float* J, int V, const float* inten, const unsigned char* ok,
                const long long* neighbors, int nbr_per_image, const float* desc,
                int desc_per_image, const unsigned char* contrib, long long M, int nb, int K,
                int blocks_per_image, float huber_k, float huber_half_k, double* partial,
                float* H, float* b, float* cost, long long* count, cudaStream_t stream) {
  if (V < 1 || V > kMaxV || nb < 1 || K < 1 || K > 8 * kThreads ||
      M < 0 || M * V > 2147483647LL || M * K > 2147483647LL || blocks_per_image < 1 ||
      blocks_per_image > 65535)
    return cudaErrorInvalidValue;
  const long long nbr_stride = nbr_per_image ? M * K : 0;
  const long long desc_stride = desc_per_image ? M * K : 0;
  switch (width_of(V)) {
    case 6:
      return launch<6>(stream, J, V, inten, ok, neighbors, nbr_stride, desc, desc_stride,
                       contrib, M, nb, K, blocks_per_image, huber_k, huber_half_k, partial, H, b,
                       cost, count);
    case 10:
      return launch<10>(stream, J, V, inten, ok, neighbors, nbr_stride, desc, desc_stride,
                        contrib, M, nb, K, blocks_per_image, huber_k, huber_half_k, partial, H,
                        b, cost, count);
    case 18:
      return launch<18>(stream, J, V, inten, ok, neighbors, nbr_stride, desc, desc_stride,
                        contrib, M, nb, K, blocks_per_image, huber_k, huber_half_k, partial, H,
                        b, cost, count);
    default:
      return launch<24>(stream, J, V, inten, ok, neighbors, nbr_stride, desc, desc_stride,
                        contrib, M, nb, K, blocks_per_image, huber_k, huber_half_k, partial, H,
                        b, cost, count);
  }
}

}  // extern "C"
