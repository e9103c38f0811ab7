// The geometry of the photometric registrator's H,b accumulation: each
// (image, point) row's projection and validity before the pyramid sample
// (kernel B3), and its row of the intensity Jacobian after it.
//
// Replaces the geometry of dataset_pipeline_tpu/photometric/optimizer.py
// `_hb_batch`: there `jax.jacfwd` of the projection and footprint math under
// `jit`, which XLA fuses into one pass; in the port's plain version
// (photometric/optimizer.py) `torch.func.jvp` under `vmap`, some hundred
// elementwise launches per tangent pass, dispatched op by op from the host.
//
// Per row, with the image's pose (q, t) (q wxyz), its point p and the
// camera's intrinsics (PINHOLE fx fy cx cy, SIMPLE_PINHOLE f cx cy, or
// THIN_PRISM_FISHEYE fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1):
//   project:  pix from p_cam = rot(q / |q|, p) + t (the pose SE3.exp(0) .
//             pose gives: compose normalises the quaternion), valid from
//             rot(q, p) + t: z > 1e-6, r2 <= cutoff, pix finite
//             (models/cameras.py:project), with r2 = |p_cam.xy / z|^2, or
//             under THIN_PRISM_FISHEYE the radius^2 after the equidistant
//             pre-warp n -> n atan(r) / r, before the distortion
//             (_dist_thin_prism: radial 1 + r2 (k1 + r2 (k2 + r2 (k3 + r2
//             k4))), tangential p1 p2, thin prism sx1 sy1).
//   jacobian: per variable column (the P intrinsics unless dropped, then the
//             6 pose dofs [translation | rotation] of the left perturbation
//             SE3.exp(eps) . pose at eps = 0), the forward tangent of pix and,
//             with dynamic_scale, of the finite-difference footprint scale
//             log2(clamp(2 r |pix(p_cam + (e,0,0)) - pix(p_cam)| / e, 1e-12)),
//             e = 1e-3 max(z, 1e-6) (optimizer.py:_footprint_scale), chained
//             with B3's derivatives: J = dpx dpix_x + dpy dpix_y (+ dvds dfp).
//             The pose tangent of p_cam is du + dw x p_cam, the derivative of
//             SE3.exp(eps).compose(pose).apply(p) at eps = 0; every further
//             step is the chain rule through the same float32 operations.
//             Under THIN_PRISM_FISHEYE the lens's 2 x 2 derivative d pix / d n
//             is taken once per point (at n, and at the footprint's second
//             point), and each column's tangent of n goes through it.
//
// The camera model is a template parameter, one instantiation per model, so
// that the pinhole models run the instructions they ran before the lens was
// added.
//
// The projection of `project` rounds as the plain version does, op by op
// (__fmul_rn and friends, so that nvcc contracts nothing into an FMA; fmaf
// where the library's squared norm is one): pix is then what the plain
// version gives up to the last bit of the rotation, the norm and atanf, and
// valid flips only on a row that sits on a bound to the ulp.
//
// Bound on the H100: bytes. A row reads its point (12 B, shared by the
// chunk's images and mostly served by L2) and writes pix and valid (9 B); the
// Jacobian reads B3's three derivatives (12 B) and writes V floats (40 B at
// V = 10, 72 B at V = 18); some 60 flops a column. One thread per row, grid
// (ceil(M/256), nb); a block stages its rows' Jacobian in shared memory so
// that the (nb, M, V) output is written with coalesced stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 18;  // P + 6 with P <= 12
constexpr float kEps = 1e-6f;  // models/cameras.py _EPS
constexpr float kLn2 = 0.6931471805599453f;

// the `model` argument of the entry points (ops/hb_geometry.py:_MODEL_IDS)
constexpr int kPinhole = 0;
constexpr int kSimplePinhole = 1;
constexpr int kThinPrismFisheye = 2;

__host__ __device__ constexpr int param_count(int model) {
  return model == kSimplePinhole ? 3 : model == kPinhole ? 4 : 12;
}

struct Pose {
  float w, x, y, z, tx, ty, tz;
};

struct Intrinsics {
  float fx, fy, cx, cy;
};

// THIN_PRISM_FISHEYE's distortion, COLMAP's order k1 k2 p1 p2 k3 k4 sx1 sy1
struct Lens {
  float k1, k2, p1, p2, k3, k4, sx1, sy1;
};

__device__ __forceinline__ Intrinsics load_intrinsics(const float* __restrict__ params,
                                                      int unique_focal) {
  Intrinsics k;
  if (unique_focal) {
    k.fx = k.fy = __ldg(params);
    k.cx = __ldg(params + 1);
    k.cy = __ldg(params + 2);
  } else {
    k.fx = __ldg(params);
    k.fy = __ldg(params + 1);
    k.cx = __ldg(params + 2);
    k.cy = __ldg(params + 3);
  }
  return k;
}

__device__ __forceinline__ Lens load_lens(const float* __restrict__ params) {
  const float* d = params + 4;
  Lens l;
  l.k1 = __ldg(d), l.k2 = __ldg(d + 1), l.p1 = __ldg(d + 2), l.p2 = __ldg(d + 3);
  l.k3 = __ldg(d + 4), l.k4 = __ldg(d + 5), l.sx1 = __ldg(d + 6), l.sy1 = __ldg(d + 7);
  return l;
}

__device__ __forceinline__ float cross_c(float a1, float b2, float a2, float b1) {
  return __fsub_rn(__fmul_rn(a1, b2), __fmul_rn(a2, b1));
}

// quat_rotate(q, p) + t as lie.py writes it: p + 2 (w uv + uuv) + t
__device__ __forceinline__ float3 apply(const Pose& q, float px, float py, float pz) {
  const float ux = cross_c(q.y, pz, q.z, py);
  const float uy = cross_c(q.z, px, q.x, pz);
  const float uz = cross_c(q.x, py, q.y, px);
  const float vx = cross_c(q.y, uz, q.z, uy);
  const float vy = cross_c(q.z, ux, q.x, uz);
  const float vz = cross_c(q.x, uy, q.y, ux);
  return make_float3(
      __fadd_rn(__fadd_rn(px, __fmul_rn(2.f, __fadd_rn(__fmul_rn(q.w, ux), vx))), q.tx),
      __fadd_rn(__fadd_rn(py, __fmul_rn(2.f, __fadd_rn(__fmul_rn(q.w, uy), vy))), q.ty),
      __fadd_rn(__fadd_rn(pz, __fmul_rn(2.f, __fadd_rn(__fmul_rn(q.w, uz), vz))), q.tz));
}

__device__ __forceinline__ Pose load_pose(const float* __restrict__ q, const float* __restrict__ t,
                                          int b) {
  Pose p;
  p.w = __ldg(q + 4 * b), p.x = __ldg(q + 4 * b + 1), p.y = __ldg(q + 4 * b + 2),
  p.z = __ldg(q + 4 * b + 3);
  p.tx = __ldg(t + 3 * b), p.ty = __ldg(t + 3 * b + 1), p.tz = __ldg(t + 3 * b + 2);
  return p;
}

// SE3.exp(0).compose(pose): the quaternion over its norm, the translation kept
__device__ __forceinline__ Pose normalised(Pose p) {
  const float ww_xx = __fadd_rn(__fmul_rn(p.w, p.w), __fmul_rn(p.x, p.x));
  const float n = __fsqrt_rn(
      __fadd_rn(__fadd_rn(ww_xx, __fmul_rn(p.y, p.y)), __fmul_rn(p.z, p.z)));
  p.w = __fdiv_rn(p.w, n), p.x = __fdiv_rn(p.x, n), p.y = __fdiv_rn(p.y, n),
  p.z = __fdiv_rn(p.z, n);
  return p;
}

__device__ __forceinline__ float safe_z(float z) { return fabsf(z) < kEps ? kEps : z; }

// clamp(x, min=lo) keeps a NaN, as the library's clamp does
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

__device__ __forceinline__ float3 load_point(const float* __restrict__ points, long long row) {
  return make_float3(__ldg(points + 3 * row), __ldg(points + 3 * row + 1),
                     __ldg(points + 3 * row + 2));
}

__device__ __forceinline__ float scalar(const float* ptr, float value) {
  return ptr != nullptr ? __ldg(ptr) : value;
}

// cameras.py:project's pixel of the normalised point n under
// THIN_PRISM_FISHEYE, rounded op by op: _fisheye_prewarp, _dist_thin_prism,
// distorted_to_image. r2 gets the pre-warped radius^2, the cutoff's space.
__device__ __forceinline__ float2 thin_prism_pixel(float nx, float ny, const Intrinsics& k,
                                                   const Lens& d, float& r2) {
  const float rn2 = fmaf(ny, ny, __fmul_rn(nx, nx));
  const float r = __fsqrt_rn(clamp_min(rn2, kEps * kEps));
  const float factor = r < kEps ? 1.f : __fdiv_rn(atanf(r), r);
  const float x = __fmul_rn(nx, factor), y = __fmul_rn(ny, factor);
  r2 = fmaf(y, y, __fmul_rn(x, x));
  float t = __fmul_rn(r2, d.k4);
  t = __fmul_rn(r2, __fadd_rn(d.k3, t));
  t = __fmul_rn(r2, __fadd_rn(d.k2, t));
  t = __fmul_rn(r2, __fadd_rn(d.k1, t));
  const float radial = __fadd_rn(1.f, t);
  const float rt = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));  // _tangential's x*x + y*y
  const float tx = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, d.p1), x), y),
                             __fmul_rn(d.p2, __fadd_rn(rt, __fmul_rn(__fmul_rn(2.f, x), x))));
  const float ty = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, d.p2), x), y),
                             __fmul_rn(d.p1, __fadd_rn(rt, __fmul_rn(__fmul_rn(2.f, y), y))));
  const float dx = __fadd_rn(__fadd_rn(__fmul_rn(x, radial), tx), __fmul_rn(d.sx1, r2));
  const float dy = __fadd_rn(__fadd_rn(__fmul_rn(y, radial), ty), __fmul_rn(d.sy1, r2));
  return make_float2(__fadd_rn(__fmul_rn(dx, k.fx), k.cx), __fadd_rn(__fmul_rn(dy, k.fy), k.cy));
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
hb_project_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const float* __restrict__ params, const float* __restrict__ cutoff_ptr,
                  float cutoff_value, const float* __restrict__ points,
                  long long points_per_image, long long M, float2* __restrict__ pix,
                  unsigned char* __restrict__ valid) {
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const int b = blockIdx.y;
  const long long row = (long long)b * M + m;
  const Pose raw = load_pose(q, t, b);
  const Intrinsics k = load_intrinsics(params, kModel == kSimplePinhole);
  const float3 p = load_point(points, b * points_per_image + m);

  const float3 pc = apply(normalised(raw), p.x, p.y, p.z);
  const float sz = safe_z(pc.z);
  const float3 pr = apply(raw, p.x, p.y, p.z);
  const float szr = safe_z(pr.z);
  const float nx = __fdiv_rn(pr.x, szr), ny = __fdiv_rn(pr.y, szr);
  float r2, ux, uy;
  if constexpr (kModel == kThinPrismFisheye) {
    const Lens d = load_lens(params);
    float unused;
    pix[row] = thin_prism_pixel(__fdiv_rn(pc.x, sz), __fdiv_rn(pc.y, sz), k, d, unused);
    const float2 u = thin_prism_pixel(nx, ny, k, d, r2);
    ux = u.x, uy = u.y;
  } else {
    pix[row] = make_float2(__fadd_rn(__fmul_rn(__fdiv_rn(pc.x, sz), k.fx), k.cx),
                           __fadd_rn(__fmul_rn(__fdiv_rn(pc.y, sz), k.fy), k.cy));
    r2 = __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny));
    ux = __fadd_rn(__fmul_rn(nx, k.fx), k.cx);
    uy = __fadd_rn(__fmul_rn(ny, k.fy), k.cy);
  }
  valid[row] = (pr.z > kEps) && (r2 <= scalar(cutoff_ptr, cutoff_value)) && isfinite(ux) &&
               isfinite(uy);
}

// What a column's tangent reads of the row's primal values. The tangents
// divide by a row's few denominators through their reciprocals, taken once.
struct Primal {
  float nx, ny, inv_sz;
  bool small;  // |z| < 1e-6: safe_z is the constant
  float dpx, dpy, dvds;
  // the footprint's finite difference
  float n2x, ddx, inv_s, ppm, inv_e, two_r, inv_uc_ln2;
  bool zpos, upos;  // the clamps of e and of the scale pass their argument
};

// One column: the tangent of p_cam (dpc) and of the intrinsics (df, dc).
__device__ __forceinline__ float column(const Primal& a, const Intrinsics& k, float3 dpc,
                                        float dfx, float dfy, float dcx, float dcy,
                                        bool dynamic) {
  const float dsz = a.small ? 0.f : dpc.z;
  const float dnx = (dpc.x - a.nx * dsz) * a.inv_sz;
  const float dny = (dpc.y - a.ny * dsz) * a.inv_sz;
  const float dpix_x = dnx * k.fx + a.nx * dfx + dcx;
  const float dpix_y = dny * k.fy + a.ny * dfy + dcy;
  float J = a.dpx * dpix_x + a.dpy * dpix_y;
  if (dynamic) {
    // pix2 - pix moves in x alone: pix2.y is pix.y, and so are their tangents
    const float de = a.zpos ? 1e-3f * dpc.z : 0.f;
    const float dn2x = (dpc.x + de - a.n2x * dsz) * a.inv_sz;
    const float dddx = (dn2x * k.fx + a.n2x * dfx + dcx) - dpix_x;
    const float ds = a.ddx * dddx * a.inv_s;  // d sqrt(ddx^2) = 2 ddx dddx / (2 s)
    const float dppm = (ds - a.ppm * de) * a.inv_e;
    const float du = a.upos ? a.two_r * dppm : 0.f;
    J += a.dvds * (du * a.inv_uc_ln2);
  }
  return J;
}

// THIN_PRISM_FISHEYE at one normalised point: the distorted point, the
// pre-warped point and its radius^2 (what the intrinsics' tangents read),
// and the 2 x 2 derivative of pix by n, the focals in it. In double: the
// footprint's tangent is a difference of two such points 1e-3 apart, which
// in float32 keeps only some four digits.
struct LensPoint {
  double dx, dy, x, y, r2;
  double a00, a01, a10, a11;
};

struct Vec2 {
  double x, y;
};

__device__ __forceinline__ LensPoint lens_point(double nx, double ny, const Intrinsics& k,
                                                const Lens& d) {
  const double rn2 = nx * nx + ny * ny;
  const double r = sqrt(fmax(rn2, 1e-12));
  // w = g n, dw = g dn + h n (n . dn): the pre-warp's factor atan(r) / r and
  // its derivative over r; the constant 1 below r = 1e-6
  double g = 1.0, h = 0.0;
  if (!(r < kEps)) {
    const double inv_r = 1.0 / r;
    g = atan(r) * inv_r;
    h = (1.0 / (1.0 + rn2) - g) * (inv_r * inv_r);
  }
  const double k1 = d.k1, k2 = d.k2, k3 = d.k3, k4 = d.k4, p1 = d.p1, p2 = d.p2;
  const double sx1 = d.sx1, sy1 = d.sy1;
  LensPoint L;
  const double x = nx * g, y = ny * g;
  const double r2 = x * x + y * y;
  const double radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)));
  const double drad = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * (4.0 * k4)));
  L.dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + sx1 * r2;
  L.dy = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) + sy1 * r2;
  const double xyd = 2.0 * x * y * drad;
  const double j00 = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x + 2.0 * sx1 * x;
  const double j01 = xyd + 2.0 * p1 * x + 2.0 * p2 * y + 2.0 * sx1 * y;
  const double j10 = xyd + 2.0 * p2 * y + 2.0 * p1 * x + 2.0 * sy1 * x;
  const double j11 = radial + 2.0 * y * y * drad + 2.0 * p2 * x + 6.0 * p1 * y + 2.0 * sy1 * y;
  const double w00 = g + h * nx * nx, w01 = h * nx * ny, w11 = g + h * ny * ny;
  const double fx = k.fx, fy = k.fy;
  L.a00 = fx * (j00 * w00 + j01 * w01);
  L.a01 = fx * (j00 * w01 + j01 * w11);
  L.a10 = fy * (j10 * w00 + j11 * w01);
  L.a11 = fy * (j10 * w01 + j11 * w11);
  L.x = x, L.y = y, L.r2 = r2;
  return L;
}

// d pix / d intrinsic i (fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1) at a point
__device__ __forceinline__ Vec2 intrinsic_tangent(const LensPoint& L, const Intrinsics& k, int i) {
  const double fx = k.fx, fy = k.fy, x = L.x, y = L.y, r2 = L.r2, r4 = r2 * r2;
  switch (i) {
    case 0: return {L.dx, 0.0};
    case 1: return {0.0, L.dy};
    case 2: return {1.0, 0.0};
    case 3: return {0.0, 1.0};
    case 4: return {fx * x * r2, fy * y * r2};
    case 5: return {fx * x * r4, fy * y * r4};
    case 6: return {fx * 2.0 * x * y, fy * (r2 + 2.0 * y * y)};
    case 7: return {fx * (r2 + 2.0 * x * x), fy * 2.0 * x * y};
    case 8: return {fx * x * r4 * r2, fy * y * r4 * r2};
    case 9: return {fx * x * r4 * r4, fy * y * r4 * r4};
    case 10: return {fx * r2, 0.0};
    default: return {0.0, fy * r2};
  }
}

// The thin prism's row: the lens at n and at the footprint's second point n2.
struct LensPrimal {
  LensPoint at, at2;
  double nx, ny, n2x, inv_sz;
  bool small;
  double dpx, dpy, dvds;
  double ddx, ddy, inv_s, ppm, inv_e, two_r, inv_uc_ln2;
  bool zpos, upos;
};

// The footprint's tangent from its second point's and the pixel's (dd =
// dpix2 - dpix) and e's (de).
__device__ __forceinline__ double footprint_tangent(const LensPrimal& a, double ddx, double ddy,
                                                    double de) {
  const double ds = (a.ddx * ddx + a.ddy * ddy) * a.inv_s;  // d |d| = d . dd / |d|
  const double dppm = (ds - a.ppm * de) * a.inv_e;
  const double du = a.upos ? a.two_r * dppm : 0.0;
  return du * a.inv_uc_ln2;
}

// A pose column of the thin prism: the tangent of p_cam.
__device__ __forceinline__ float lens_pose_column(const LensPrimal& a, double dpcx, double dpcy,
                                                  double dpcz, bool dynamic) {
  const double dsz = a.small ? 0.0 : dpcz;
  const double dnx = (dpcx - a.nx * dsz) * a.inv_sz;
  const double dny = (dpcy - a.ny * dsz) * a.inv_sz;
  const double dpix_x = a.at.a00 * dnx + a.at.a01 * dny;
  const double dpix_y = a.at.a10 * dnx + a.at.a11 * dny;
  double J = a.dpx * dpix_x + a.dpy * dpix_y;
  if (dynamic) {
    const double de = a.zpos ? 1e-3 * dpcz : 0.0;
    const double dn2x = (dpcx + de - a.n2x * dsz) * a.inv_sz;  // n2.y is n.y
    const double ddx = (a.at2.a00 * dn2x + a.at2.a01 * dny) - dpix_x;
    const double ddy = (a.at2.a10 * dn2x + a.at2.a11 * dny) - dpix_y;
    J += a.dvds * footprint_tangent(a, ddx, ddy, de);
  }
  return (float)J;
}

// An intrinsics column of the thin prism: n does not move.
__device__ __forceinline__ float lens_intrinsic_column(const LensPrimal& a, const Intrinsics& k,
                                                       int i, bool dynamic) {
  const Vec2 dp = intrinsic_tangent(a.at, k, i);
  double J = a.dpx * dp.x + a.dpy * dp.y;
  if (dynamic && (i < 2 || i >= 4)) {  // pix2 - pix does not move with cx, cy
    const Vec2 dp2 = intrinsic_tangent(a.at2, k, i);
    J += a.dvds * footprint_tangent(a, dp2.x - dp.x, dp2.y - dp.y, 0.0);
  }
  return (float)J;
}

template <int kModel>
__device__ __forceinline__ void jacobian_row(const float* __restrict__ params, float3 pc,
                                             float dpx_, float dpy_, float dvds_, float radius,
                                             bool dynamic, bool optimize_intrinsics, float* out) {
  constexpr int P = param_count(kModel);
  const Intrinsics k = load_intrinsics(params, kModel == kSimplePinhole);
  if constexpr (kModel == kThinPrismFisheye) {
    const Lens d = load_lens(params);
    LensPrimal a;
    const double px = pc.x, py = pc.y, pz = pc.z;
    a.small = fabsf(pc.z) < kEps;
    const double sz = a.small ? (double)kEps : pz;
    a.inv_sz = 1.0 / sz;
    a.nx = px * a.inv_sz;
    a.ny = py * a.inv_sz;
    a.at = lens_point(a.nx, a.ny, k, d);
    a.dpx = dpx_, a.dpy = dpy_, a.dvds = dvds_;
    if (dynamic) {
      a.zpos = pc.z >= kEps;
      const double e = 1e-3 * (double)clamp_min(pc.z, kEps);
      a.inv_e = 1.0 / e;
      a.n2x = (px + e) * a.inv_sz;
      a.at2 = lens_point(a.n2x, a.ny, k, d);
      a.ddx = k.fx * (a.at2.dx - a.at.dx);
      a.ddy = k.fy * (a.at2.dy - a.at.dy);
      const double s = sqrt(a.ddx * a.ddx + a.ddy * a.ddy);
      a.inv_s = 1.0 / s;
      a.ppm = s * a.inv_e;
      a.two_r = 2.0 * radius;
      const double u = a.two_r * a.ppm;
      a.upos = u >= 1e-12;
      a.inv_uc_ln2 = 1.0 / ((isnan(u) ? u : fmax(u, 1e-12)) * (double)kLn2);
    }
    int j = 0;
    if (optimize_intrinsics) {
      for (int i = 0; i < P; ++i) out[j++] = lens_intrinsic_column(a, k, i, dynamic);
    }
    out[j++] = lens_pose_column(a, 1.0, 0.0, 0.0, dynamic);
    out[j++] = lens_pose_column(a, 0.0, 1.0, 0.0, dynamic);
    out[j++] = lens_pose_column(a, 0.0, 0.0, 1.0, dynamic);
    // e_i x p_cam
    out[j++] = lens_pose_column(a, 0.0, -pz, py, dynamic);
    out[j++] = lens_pose_column(a, pz, 0.0, -px, dynamic);
    out[j++] = lens_pose_column(a, -py, px, 0.0, dynamic);
  } else {
    Primal a;
    a.small = fabsf(pc.z) < kEps;
    const float sz = a.small ? kEps : pc.z;
    a.inv_sz = 1.f / sz;
    a.nx = __fdiv_rn(pc.x, sz);
    a.ny = __fdiv_rn(pc.y, sz);
    a.dpx = dpx_;
    a.dpy = dpy_;
    a.dvds = dvds_;
    if (dynamic) {
      const float zc = clamp_min(pc.z, kEps);
      a.zpos = pc.z >= kEps;
      const float e = __fmul_rn(1e-3f, zc);
      a.inv_e = 1.f / e;
      a.n2x = __fdiv_rn(__fadd_rn(pc.x, e), sz);
      a.ddx = __fsub_rn(__fadd_rn(__fmul_rn(a.n2x, k.fx), k.cx),
                        __fadd_rn(__fmul_rn(a.nx, k.fx), k.cx));
      const float s = __fsqrt_rn(__fmul_rn(a.ddx, a.ddx));
      a.inv_s = 1.f / s;
      a.ppm = __fdiv_rn(s, e);
      a.two_r = 2.f * radius;
      const float u = __fmul_rn(a.two_r, a.ppm);
      a.upos = u >= 1e-12f;
      a.inv_uc_ln2 = 1.f / ((isnan(u) ? u : fmaxf(u, 1e-12f)) * kLn2);
    }
    int j = 0;
    if (optimize_intrinsics) {
      // PINHOLE: fx, fy, cx, cy; SIMPLE_PINHOLE: f (both focals), cx, cy
      for (int i = 0; i < P; ++i) {
        const bool fy = kModel == kSimplePinhole ? i == 0 : i == 1;
        const int c = i - (P - 2);  // 0: cx, 1: cy
        out[j++] = column(a, k, make_float3(0.f, 0.f, 0.f), i == 0 ? 1.f : 0.f, fy ? 1.f : 0.f,
                          c == 0 ? 1.f : 0.f, c == 1 ? 1.f : 0.f, dynamic);
      }
    }
    out[j++] = column(a, k, make_float3(1.f, 0.f, 0.f), 0.f, 0.f, 0.f, 0.f, dynamic);
    out[j++] = column(a, k, make_float3(0.f, 1.f, 0.f), 0.f, 0.f, 0.f, 0.f, dynamic);
    out[j++] = column(a, k, make_float3(0.f, 0.f, 1.f), 0.f, 0.f, 0.f, 0.f, dynamic);
    // e_i x p_cam
    out[j++] = column(a, k, make_float3(0.f, -pc.z, pc.y), 0.f, 0.f, 0.f, 0.f, dynamic);
    out[j++] = column(a, k, make_float3(pc.z, 0.f, -pc.x), 0.f, 0.f, 0.f, 0.f, dynamic);
    out[j++] = column(a, k, make_float3(-pc.y, pc.x, 0.f), 0.f, 0.f, 0.f, 0.f, dynamic);
  }
}

template <int kModel>
__global__ void __launch_bounds__(kThreads)
hb_jacobian_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const float* __restrict__ params, const float* __restrict__ points,
                   long long points_per_image, long long M, const float* __restrict__ dpx,
                   const float* __restrict__ dpy, const float* __restrict__ dvds, float radius,
                   int dynamic_scale, int optimize_intrinsics, float* __restrict__ J) {
  constexpr int P = param_count(kModel);
  __shared__ float stage[kThreads * (P + 6)];
  const int V = (optimize_intrinsics ? P : 0) + 6;
  const int b = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * kThreads;
  const long long m = m0 + threadIdx.x;
  if (m < M) {
    const long long row = (long long)b * M + m;
    const float3 p = load_point(points, b * points_per_image + m);
    const float3 pc = apply(normalised(load_pose(q, t, b)), p.x, p.y, p.z);
    const bool dynamic = dynamic_scale != 0;
    jacobian_row<kModel>(params, pc, __ldg(dpx + row), __ldg(dpy + row),
                         dynamic ? __ldg(dvds + row) : 0.f, radius, dynamic,
                         optimize_intrinsics != 0, stage + threadIdx.x * V);
  }
  __syncthreads();
  const long long rows = M - m0 < kThreads ? M - m0 : kThreads;
  float* dst = J + ((long long)b * M + m0) * V;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) dst[i] = stage[i];
}

static_assert(param_count(kThinPrismFisheye) + 6 == kMaxCols, "the widest row");

bool launchable(int model, int nb, long long M) {
  return model >= kPinhole && model <= kThinPrismFisheye && nb >= 1 && nb <= 65535 && M >= 0 &&
         (M + kThreads - 1) / kThreads <= 2147483647LL;
}

template <int kModel>
int launch_project(dim3 grid, cudaStream_t stream, const float* q, const float* t,
                   const float* params, const float* cutoff_sq, float cutoff_value,
                   const float* points, long long points_per_image, long long M, float* pix,
                   unsigned char* valid) {
  hb_project_kernel<kModel><<<grid, kThreads, 0, stream>>>(
      q, t, params, cutoff_sq, cutoff_value, points, points_per_image, M,
      reinterpret_cast<float2*>(pix), valid);
  return (int)cudaGetLastError();
}

template <int kModel>
int launch_jacobian(dim3 grid, cudaStream_t stream, const float* q, const float* t,
                    const float* params, const float* points, long long points_per_image,
                    long long M, const float* dpx, const float* dpy, const float* dvds,
                    float radius, int dynamic_scale, int optimize_intrinsics, float* J) {
  hb_jacobian_kernel<kModel><<<grid, kThreads, 0, stream>>>(
      q, t, params, points, points_per_image, M, dpx, dpy, dvds, radius, dynamic_scale,
      optimize_intrinsics, J);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (nb,4), t (nb,3): the chunk's poses; model 0 PINHOLE (params (4,)), 1
// SIMPLE_PINHOLE (3,) or 2 THIN_PRISM_FISHEYE (12,); points (M,3) shared by
// the images (per_image 0) or (nb,M,3). cutoff_sq: a device scalar, or null
// and cutoff_value. Writes pix (nb,M,2) float32 and valid (nb,M) bool. All
// device pointers, contiguous. Returns a cudaError_t (0 = launched or
// nothing to do).
int dpt_hb_geometry_project(const float* q, const float* t, const float* params, int model,
                            const float* cutoff_sq, float cutoff_value, const float* points,
                            int per_image, long long M, int nb, float* pix, unsigned char* valid,
                            cudaStream_t stream) {
  if (!launchable(model, nb, M)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kThreads - 1) / kThreads), nb);
  const long long ppi = per_image ? M : 0;
  switch (model) {
    case kPinhole:
      return launch_project<kPinhole>(grid, stream, q, t, params, cutoff_sq, cutoff_value,
                                      points, ppi, M, pix, valid);
    case kSimplePinhole:
      return launch_project<kSimplePinhole>(grid, stream, q, t, params, cutoff_sq,
                                            cutoff_value, points, ppi, M, pix, valid);
    default:
      return launch_project<kThinPrismFisheye>(grid, stream, q, t, params, cutoff_sq,
                                               cutoff_value, points, ppi, M, pix, valid);
  }
}

// As dpt_hb_geometry_project, with B3's derivatives dpx, dpy, dvds (nb,M)
// (dvds read only with dynamic_scale) and the level's point radius. Writes
// J (nb,M,V) float32, V = 6 pose
// columns after the P intrinsics columns when optimize_intrinsics.
int dpt_hb_geometry_jacobian(const float* q, const float* t, const float* params, int model,
                             const float* points, int per_image, long long M, int nb,
                             const float* dpx, const float* dpy, const float* dvds,
                             float radius, int dynamic_scale, int optimize_intrinsics, float* J,
                             cudaStream_t stream) {
  if (!launchable(model, nb, M)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kThreads - 1) / kThreads), nb);
  const long long ppi = per_image ? M : 0;
  switch (model) {
    case kPinhole:
      return launch_jacobian<kPinhole>(grid, stream, q, t, params, points, ppi, M, dpx, dpy,
                                       dvds, radius, dynamic_scale, optimize_intrinsics, J);
    case kSimplePinhole:
      return launch_jacobian<kSimplePinhole>(grid, stream, q, t, params, points, ppi, M, dpx,
                                             dpy, dvds, radius, dynamic_scale,
                                             optimize_intrinsics, J);
    default:
      return launch_jacobian<kThinPrismFisheye>(grid, stream, q, t, params, points, ppi, M,
                                                dpx, dpy, dvds, radius, dynamic_scale,
                                                optimize_intrinsics, J);
  }
}

}  // extern "C"
