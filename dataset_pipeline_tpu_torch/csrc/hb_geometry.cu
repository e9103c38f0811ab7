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
// camera's intrinsics (PINHOLE fx fy cx cy, or SIMPLE_PINHOLE f cx cy):
//   project:  pix from p_cam = rot(q / |q|, p) + t (the pose SE3.exp(0) .
//             pose gives: compose normalises the quaternion), valid from
//             rot(q, p) + t: z > 1e-6, r2 = |p_cam.xy / z|^2 <= cutoff,
//             pix finite (models/cameras.py:project).
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
//
// The projection of `project` rounds as the plain version does, op by op
// (__fmul_rn and friends, so that nvcc contracts nothing into an FMA): pix is
// then what the plain version gives up to the last bit of the rotation and
// norm, and valid flips only on a row that sits on a bound to the ulp.
//
// Bound on the H100: bytes. A row reads its point (12 B, shared by the
// chunk's images and mostly served by L2) and writes pix and valid (9 B); the
// Jacobian reads B3's three derivatives (12 B) and writes V floats (40 B at
// V = 10); some 60 flops a column. One thread per row, grid (ceil(M/256), nb);
// a block stages its rows' Jacobian in shared memory so that the (nb, M, V)
// output is written with coalesced stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 10;  // P + 6 with P <= 4
constexpr float kEps = 1e-6f;  // models/cameras.py _EPS
constexpr float kLn2 = 0.6931471805599453f;

struct Pose {
  float w, x, y, z, tx, ty, tz;
};

struct Intrinsics {
  float fx, fy, cx, cy;
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

__device__ __forceinline__ float3 load_point(const float* __restrict__ points, long long row) {
  return make_float3(__ldg(points + 3 * row), __ldg(points + 3 * row + 1),
                     __ldg(points + 3 * row + 2));
}

__device__ __forceinline__ float scalar(const float* ptr, float value) {
  return ptr != nullptr ? __ldg(ptr) : value;
}

__global__ void __launch_bounds__(kThreads)
hb_project_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const float* __restrict__ params, int unique_focal,
                  const float* __restrict__ cutoff_ptr, float cutoff_value,
                  const float* __restrict__ points, long long points_per_image, long long M,
                  float2* __restrict__ pix, unsigned char* __restrict__ valid) {
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const int b = blockIdx.y;
  const long long row = (long long)b * M + m;
  const Pose raw = load_pose(q, t, b);
  const Intrinsics k = load_intrinsics(params, unique_focal);
  const float3 p = load_point(points, b * points_per_image + m);

  const float3 pc = apply(normalised(raw), p.x, p.y, p.z);
  const float sz = safe_z(pc.z);
  pix[row] = make_float2(__fadd_rn(__fmul_rn(__fdiv_rn(pc.x, sz), k.fx), k.cx),
                         __fadd_rn(__fmul_rn(__fdiv_rn(pc.y, sz), k.fy), k.cy));

  const float3 pr = apply(raw, p.x, p.y, p.z);
  const float szr = safe_z(pr.z);
  const float nx = __fdiv_rn(pr.x, szr), ny = __fdiv_rn(pr.y, szr);
  const float r2 = __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny));
  const float ux = __fadd_rn(__fmul_rn(nx, k.fx), k.cx);
  const float uy = __fadd_rn(__fmul_rn(ny, k.fy), k.cy);
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

__global__ void __launch_bounds__(kThreads)
hb_jacobian_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const float* __restrict__ params, int unique_focal,
                   const float* __restrict__ points, long long points_per_image, long long M,
                   const float* __restrict__ dpx, const float* __restrict__ dpy,
                   const float* __restrict__ dvds, float radius, int dynamic_scale,
                   int optimize_intrinsics, float* __restrict__ J) {
  __shared__ float stage[kThreads * kMaxCols];
  const int P = unique_focal ? 3 : 4;
  const int V = (optimize_intrinsics ? P : 0) + 6;
  const int b = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * kThreads;
  const long long m = m0 + threadIdx.x;
  if (m < M) {
    const long long row = (long long)b * M + m;
    const Intrinsics k = load_intrinsics(params, unique_focal);
    const float3 p = load_point(points, b * points_per_image + m);
    const float3 pc = apply(normalised(load_pose(q, t, b)), p.x, p.y, p.z);
    const bool dynamic = dynamic_scale != 0;
    Primal a;
    a.small = fabsf(pc.z) < kEps;
    const float sz = a.small ? kEps : pc.z;
    a.inv_sz = 1.f / sz;
    a.nx = __fdiv_rn(pc.x, sz);
    a.ny = __fdiv_rn(pc.y, sz);
    a.dpx = __ldg(dpx + row);
    a.dpy = __ldg(dpy + row);
    a.dvds = dynamic ? __ldg(dvds + row) : 0.f;
    if (dynamic) {
      // clamp(z, min=1e-6) keeps a NaN, as the library's clamp does
      const float zc = isnan(pc.z) ? pc.z : fmaxf(pc.z, kEps);
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
    float* out = stage + threadIdx.x * V;
    int j = 0;
    if (optimize_intrinsics) {
      // PINHOLE: fx, fy, cx, cy; SIMPLE_PINHOLE: f (both focals), cx, cy
      for (int i = 0; i < P; ++i) {
        const bool fy = unique_focal ? i == 0 : i == 1;
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
  __syncthreads();
  const long long rows = M - m0 < kThreads ? M - m0 : kThreads;
  float* dst = J + ((long long)b * M + m0) * V;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) dst[i] = stage[i];
}

bool launchable(int nb, long long M) {
  return nb >= 1 && nb <= 65535 && M >= 0 && (M + kThreads - 1) / kThreads <= 2147483647LL;
}

}  // namespace

extern "C" {

// q (nb,4), t (nb,3): the chunk's poses; params (4,) PINHOLE or (3,)
// SIMPLE_PINHOLE (unique_focal); points (M,3) shared by the images
// (per_image 0) or (nb,M,3). cutoff_sq: a device scalar, or null and
// cutoff_value. Writes pix (nb,M,2) float32 and valid (nb,M) bool. All device
// pointers, contiguous. Returns a cudaError_t (0 = launched or nothing to do).
int dpt_hb_geometry_project(const float* q, const float* t, const float* params,
                            int unique_focal, const float* cutoff_sq, float cutoff_value,
                            const float* points, int per_image, long long M, int nb, float* pix,
                            unsigned char* valid, cudaStream_t stream) {
  if (!launchable(nb, M)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kThreads - 1) / kThreads), nb);
  hb_project_kernel<<<grid, kThreads, 0, stream>>>(
      q, t, params, unique_focal, cutoff_sq, cutoff_value, points, per_image ? M : 0, M,
      reinterpret_cast<float2*>(pix), valid);
  return (int)cudaGetLastError();
}

// As dpt_hb_geometry_project, with B3's derivatives dpx, dpy, dvds (nb,M)
// (dvds read only with dynamic_scale) and the level's point radius. Writes
// J (nb,M,V) float32, V = 6 pose
// columns after the P intrinsics columns when optimize_intrinsics.
int dpt_hb_geometry_jacobian(const float* q, const float* t, const float* params,
                             int unique_focal, const float* points, int per_image, long long M,
                             int nb, const float* dpx, const float* dpy, const float* dvds,
                             float radius, int dynamic_scale, int optimize_intrinsics, float* J,
                             cudaStream_t stream) {
  if (!launchable(nb, M)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kThreads - 1) / kThreads), nb);
  hb_jacobian_kernel<<<grid, kThreads, 0, stream>>>(
      q, t, params, unique_focal, points, per_image ? M : 0, M, dpx, dpy, dvds, radius,
      dynamic_scale, optimize_intrinsics, J);
  return (int)cudaGetLastError();
}

}  // extern "C"
