// Trilinear image-pyramid sampling with analytic derivatives (photometric
// registration): per observation, the blend of the bilinear samples of the
// two pyramid levels that bracket its continuous scale, and the derivatives
// by the full-resolution pixel coordinates and by the scale.
//
// Replaces the TPU kernel dataset_pipeline_tpu/ops/brick.py `_extract_kernel`
// (called through `_extract_pallas`) together with the address and blend
// code around it (`_brick_address`, `brick_sample[_with_derivs]`). It ports
// the quantity, not the brick layout: on the TPU a scattered gather costs
// ~7 ns per item whatever its width, so the pyramid is re-laid into
// overlapping 4x32 tiles, one 128-lane row per bilinear footprint, and the
// kernel extracts the four taps with one-hot sublane reductions. On the H100
// a tap is one load of a 32-byte sector.
//
// Per observation o of image b (coordinates as `_bilinear_flat`,
// photometric/optimizer.py): with s = obs_scale, si = clip(floor(s)+1, 1,
// L-1) (si = 1 for a non-finite s), z = 1 - frac(s), and for each level l in
// {si, si-1}: f = 2^-l, x = f (px + 0.5) - 0.5, y likewise, ix = floor(x),
// valid = x >= 0 & y >= 0 & ix < W_l - 1 & iy < H_l - 1 (compared in float),
// taps at the clipped (ix, iy): value, dx = (fy (br-bl) + (1-fy)(tr-tl)) f,
// dy = (bottom - top) f. Output: value = (1-z) vc + z vf, dpx, dpy likewise,
// ds = vc - vf, ok = okc & okf. With L == 1: level 0 alone and ds = 0.
// `with_derivs == 0` writes only value and ok (the cost/descriptor passes).
//
// The coordinate math uses __fmul_rn/__fadd_rn: nvcc would contract
// f*(p+0.5)-0.5 into an FMA and floor() would then flip at integer
// boundaries against the plain PyTorch version, changing ok and the taps.
//
// Bound on the H100: scattered 32-byte sector requests. An 8-image chunk of
// 3072x2048 pyramids (5 levels) is ~268 MB, far above the 50 MB L2. Read
// from the flat pyramid, a footprint is two rows of two columns, 2.25
// sectors a level (a row's pair straddles a sector 1 time in 8), 4.5 an
// observation, plus 29 streamed bytes (8 pix, 4 scale, 16+1 out); on the
// registrator's inputs that is ~4.4 requests for ~0.6 distinct sectors per
// observation, so the requests, not the bytes, set the time. Design: the
// taps are read from a row-paired copy of each level (`dpt_pyramid_pairs`,
// built once per image chunk): pair row y holds rows y and y+1 interleaved,
// (y, x) beside (y+1, x), so a footprint is 16 contiguous bytes, one 16-byte
// load when ix is even and two 8-byte loads when it is odd, inside one
// sector 3 times in 4: 1.25 sectors a level. The copy is twice the pyramid's
// size; a pair row is padded to a multiple of 4 floats so that the 16-byte
// loads stay aligned for any width. The doubled footprint is what this
// design pays: at the registrator's full-resolution inputs one image's
// levels 0 and 1 take 63 MB in the copy (31 MB flat), more than the 50 MB L2,
// and most requests miss it (on the H100 1.2x faster than the flat layout
// there, 1.5x at observations spread over all levels). The arithmetic is the flat sampler's,
// operation for operation, so the outputs have its bits. One thread per
// observation, grid (ceil(N/256), nb), level table passed by value (kernel
// parameters live in the constant bank), taps through the read-only path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

// floats of a pair row of a level of width w: 2w rounded up to 16 bytes
__host__ __device__ __forceinline__ long long pair_stride(int w) { return (2LL * w + 3) / 4 * 4; }

struct Levels {
  int count;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long off[kMaxLevels];  // of level l in an image's row-paired copy
};

struct Tap {
  float v, dx, dy;
  bool ok;
};

__device__ __forceinline__ Tap bilinear(const float* __restrict__ img, const Levels& lv,
                                        int l, float px, float py, bool derivs) {
  const float f = ldexpf(1.0f, -l);  // exact power of two
  const float x = __fadd_rn(__fmul_rn(f, __fadd_rn(px, 0.5f)), -0.5f);
  const float y = __fadd_rn(__fmul_rn(f, __fadd_rn(py, 0.5f)), -0.5f);
  const int W = lv.w[l], H = lv.h[l];
  const float flx = floorf(x), fly = floorf(y);
  Tap t;
  t.ok = (x >= 0.f) && (y >= 0.f) && (flx < (float)(W - 1)) && (fly < (float)(H - 1));
  // clip in float: fmaxf maps NaN to 0, so a NaN coordinate reads in bounds
  const int ix = (int)fminf(fmaxf(flx, 0.f), (float)max(W - 2, 0));
  const int iy = (int)fminf(fmaxf(fly, 0.f), (float)max(H - 2, 0));
  // (tl, bl, tr, br) are 16 contiguous bytes of pair row iy
  const float* p = img + lv.off[l] + (long long)iy * pair_stride(W) + 2 * ix;
  float tl, tr, bl, br;
  if ((ix & 1) == 0) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    tl = q.x, bl = q.y, tr = q.z, br = q.w;
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
    tl = a.x, bl = a.y, tr = b.x, br = b.y;
  }
  const float fx = x - (float)ix;
  const float fy = y - (float)iy;
  const float top = (1.f - fx) * tl + fx * tr;
  const float bottom = (1.f - fx) * bl + fx * br;
  t.v = (1.f - fy) * top + fy * bottom;
  if (derivs) {
    t.dx = (fy * (br - bl) + (1.f - fy) * (tr - tl)) * f;
    t.dy = (bottom - top) * f;
  } else {
    t.dx = t.dy = 0.f;
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
pyramid_sample_kernel(const float* __restrict__ pairs, long long img_stride, Levels lv,
                      const float* __restrict__ pix0, const float* __restrict__ scale,
                      int n, int with_derivs, float* __restrict__ value,
                      float* __restrict__ dpx, float* __restrict__ dpy,
                      float* __restrict__ ds, unsigned char* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = (long long)blockIdx.y * n + i;
  const float* img = pairs + (long long)blockIdx.y * img_stride;
  const float px = pix0[2 * o], py = pix0[2 * o + 1];
  const bool derivs = with_derivs != 0;
  if (lv.count == 1) {
    const Tap t = bilinear(img, lv, 0, px, py, derivs);
    value[o] = t.v;
    ok[o] = t.ok;
    if (derivs) {
      dpx[o] = t.dx;
      dpy[o] = t.dy;
      ds[o] = 0.f;
    }
    return;
  }
  const float s = scale[o];
  const float fs = floorf(s);
  const int si = isfinite(s) ? min(max((int)fs + 1, 1), lv.count - 1) : 1;
  const float z = 1.f - (s - fs);
  const Tap c = bilinear(img, lv, si, px, py, derivs);
  const Tap f = bilinear(img, lv, si - 1, px, py, derivs);
  value[o] = (1.f - z) * c.v + z * f.v;
  ok[o] = c.ok && f.ok;
  if (derivs) {
    dpx[o] = (1.f - z) * c.dx + z * f.dx;
    dpy[o] = (1.f - z) * c.dy + z * f.dy;
    ds[o] = -(f.v - c.v);
  }
}

// The row-paired copy: one thread per float2 slot (pair row y, slot s) of
// every level, (I[y][s], I[y+1][s]) for s < W and zeros in the padding.
struct PairLevels {
  int count;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long off[kMaxLevels];    // of level l in an image's flat pyramid
  long long poff[kMaxLevels];   // ... and in its row-paired copy
  long long start[kMaxLevels + 1];  // first slot of level l; start[count] = all slots
};

__global__ void __launch_bounds__(kThreads)
pyramid_pairs_kernel(const float* __restrict__ flat, long long img_stride,
                     float* __restrict__ pairs, long long pair_img_stride, PairLevels lv) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lv.start[lv.count]) return;
  int l = 0;
  while (e >= lv.start[l + 1]) ++l;
  const int W = lv.w[l];
  const long long half = pair_stride(W) / 2;
  const long long y = (e - lv.start[l]) / half, s = (e - lv.start[l]) % half;
  const float* src = flat + (long long)blockIdx.y * img_stride + lv.off[l] + y * W + s;
  float2 out = make_float2(0.f, 0.f);
  if (s < W) out = make_float2(__ldg(src), __ldg(src + W));
  reinterpret_cast<float2*>(pairs + (long long)blockIdx.y * pair_img_stride + lv.poff[l] +
                            y * 2 * half)[s] = out;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// pairs: (nb, img_stride) float32, the row-paired copy of each image's
// pyramid (dpt_pyramid_pairs), 16-byte aligned, img_stride a multiple of 4;
// level l of image b at pairs + b*img_stride + offs[l]: (hs[l]-1) pair rows of
// pair_stride(ws[l]) floats. hs/ws/offs are HOST arrays of L entries.
// pix0: (nb, n, 2), scale: (nb, n); outputs (nb, n). dpx/dpy/ds may be null
// when with_derivs == 0. Returns a cudaError_t (0 = launched).
int dpt_pyramid_sample(const float* pairs, long long img_stride, int nb, const int* hs,
                       const int* ws, const long long* offs, int L, const float* pix0,
                       const float* scale, int n, int with_derivs, float* value,
                       float* dpx, float* dpy, float* ds, unsigned char* ok,
                       cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels || nb < 1 || nb > 65535 || n < 0 || img_stride < 0 ||
      img_stride % 4 != 0 || !aligned16(pairs))
    return cudaErrorInvalidValue;
  if (with_derivs && (dpx == nullptr || dpy == nullptr || ds == nullptr))
    return cudaErrorInvalidValue;
  Levels lv;
  lv.count = L;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 2 || ws[l] < 2 || offs[l] < 0 || offs[l] % 4 != 0 ||
        offs[l] + (hs[l] - 1LL) * pair_stride(ws[l]) > img_stride)
      return cudaErrorInvalidValue;
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.off[l] = offs[l];
  }
  for (int l = L; l < kMaxLevels; ++l) {
    lv.h[l] = lv.w[l] = 0;
    lv.off[l] = 0;
  }
  if (n == 0) return cudaSuccess;
  dim3 grid((n + kThreads - 1) / kThreads, nb);
  pyramid_sample_kernel<<<grid, kThreads, 0, stream>>>(pairs, img_stride, lv, pix0, scale, n,
                                                       with_derivs, value, dpx, dpy, ds, ok);
  return (int)cudaGetLastError();
}

// Builds the row-paired copy `pairs` (nb, pair_img_stride) of the flat
// pyramids `flat` (nb, img_stride): level l at offs[l] in flat and poffs[l]
// in pairs (multiples of 4, the levels' regions disjoint and inside the
// strides). Every float of each level's region is written, padding included.
int dpt_pyramid_pairs(const float* flat, long long img_stride, float* pairs,
                      long long pair_img_stride, int nb, const int* hs, const int* ws,
                      const long long* offs, const long long* poffs, int L,
                      cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels || nb < 1 || nb > 65535 || img_stride < 0 ||
      pair_img_stride % 4 != 0 || !aligned16(pairs))
    return cudaErrorInvalidValue;
  PairLevels lv;
  lv.count = L;
  lv.start[0] = 0;
  for (int l = 0; l < L; ++l) {
    const long long ps = pair_stride(ws[l]);
    if (hs[l] < 2 || ws[l] < 2 || offs[l] < 0 || offs[l] + (long long)hs[l] * ws[l] > img_stride ||
        poffs[l] < 0 || poffs[l] % 4 != 0 || poffs[l] + (hs[l] - 1) * ps > pair_img_stride)
      return cudaErrorInvalidValue;
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.off[l] = offs[l];
    lv.poff[l] = poffs[l];
    lv.start[l + 1] = lv.start[l] + (hs[l] - 1) * ps / 2;
  }
  const long long slots = lv.start[L];
  if (slots / kThreads >= 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)((slots + kThreads - 1) / kThreads), nb);
  pyramid_pairs_kernel<<<grid, kThreads, 0, stream>>>(flat, img_stride, pairs, pair_img_stride, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
