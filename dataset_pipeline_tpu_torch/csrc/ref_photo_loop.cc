// Faithful single-core C++14 micro-kernel of the reference's photometric
// H,b accumulation hot loop for a PINHOLE camera, for the measured CPU
// baseline in BASELINE.md (the reference's binaries are unbuildable here —
// see ref_icp_loop.cc). Mirrors, per observation:
//   - pinhole projection (camera/camera_pinhole.h semantics)
//   - trilinear image interpolation with analytic x/y derivatives across a
//     2-level pyramid (opt/interpolate_trilinear.h:44-87 convention
//     x1 = 2(x0+0.5)-0.5)
//   - the chain rule to the 6-dof pose and 4 intrinsics
//     (opt/intrinsics_and_pose_optimizer.cc:932-1217, scale term omitted)
//   - descriptor-difference residual rows over K neighbors with Huber
//     weighting and the upper-triangular double H accumulation
//     (.cc:839-930, 1219-1296)
// Compiled with the reference's own flags (-O2 -msse2 -msse3),
// single-threaded like the reference's accumulation loop.

#include <chrono>
#include <cmath>
#include <cstring>

namespace {

struct Pyr {
  const float* lv0;
  const float* lv1;
  int w0, h0, w1, h1;
};

// bilinear with derivatives at one level
inline bool bilin(const float* img, int w, int h, float x, float y,
                  float* v, float* dx, float* dy) {
  int ix = int(std::floor(x));
  int iy = int(std::floor(y));
  if (ix < 0 || iy < 0 || ix >= w - 1 || iy >= h - 1) return false;
  float fx = x - ix, fy = y - iy;
  const float* p = img + iy * w + ix;
  float tl = p[0], tr = p[1], bl = p[w], br = p[w + 1];
  float top = (1 - fx) * tl + fx * tr;
  float bot = (1 - fx) * bl + fx * br;
  *v = (1 - fy) * top + fy * bot;
  *dx = fy * (br - bl) + (1 - fy) * (tr - tl);
  *dy = bot - top;
  return true;
}

// trilinear across levels 0/1 at blend z in [0,1] (0 = level 0)
inline bool trilin(const Pyr& pyr, float x0, float y0, float z,
                   float* v, float* dx0, float* dy0) {
  float v0, dx, dy, v1, dx1, dy1;
  if (!bilin(pyr.lv0, pyr.w0, pyr.h0, x0, y0, &v0, &dx, &dy)) return false;
  float x1 = 0.5f * (x0 + 0.5f) - 0.5f;
  float y1 = 0.5f * (y0 + 0.5f) - 0.5f;
  if (!bilin(pyr.lv1, pyr.w1, pyr.h1, x1, y1, &v1, &dx1, &dy1)) return false;
  *v = (1 - z) * v0 + z * v1;
  *dx0 = (1 - z) * dx + z * 0.5f * dx1;
  *dy0 = (1 - z) * dy + z * 0.5f * dy1;
  return true;
}

constexpr int kVars = 10;  // 4 intrinsics (f f cx cy -> fx fy cx cy) + 6 pose

inline void huber(double r, double tau, double* w) {
  double a = std::fabs(r);
  *w = a <= tau ? 1.0 : tau / a;
}

}  // namespace

extern "C" {

// points (N,3) camera-frame (identity pose, like the reference's residual
// evaluation at the current state), neighbors (N,K) int32, desc (N,K),
// pyramid level0 (h0,w0) + level1, blend z per point scale_z (N).
// Runs ``iters`` full accumulation passes; returns seconds.
double ref_photo_inner(const float* pts, const int* neighbors,
                       const float* desc, long N, int K, const float* lv0,
                       int w0, int h0, const float* lv1, int w1, int h1,
                       const float* scale_z, float f, float cx, float cy,
                       int iters, double* H_out, double* b_out,
                       double* cost_out, long* count_out) {
  auto t0 = std::chrono::steady_clock::now();
  Pyr pyr{lv0, lv1, w0, h0, w1, h1};
  double H[kVars * kVars];
  double b[kVars];
  double cost = 0.0;
  long count = 0;
  // per-point intensity + jacobian rows (computed once per pass, like
  // ComputePointIntensityAndJacobians per observation)
  float* inten = new float[N];
  bool* ok = new bool[N];
  float* J = new float[size_t(N) * kVars];
  const double tau = 30.0 * std::sqrt(5.0) / std::sqrt(2.0);
  for (int it = 0; it < iters; ++it) {
    std::memset(H, 0, sizeof(H));
    std::memset(b, 0, sizeof(b));
    cost = 0.0;
    count = 0;
    for (long i = 0; i < N; ++i) {
      const float* p = pts + 3 * i;
      float z = p[2];
      if (z <= 0.05f) { ok[i] = false; continue; }
      float inv_z = 1.0f / z;
      float u = f * p[0] * inv_z + cx;
      float v = f * p[1] * inv_z + cy;
      float val, dx, dy;
      if (!trilin(pyr, u, v, scale_z[i], &val, &dx, &dy)) {
        ok[i] = false;
        continue;
      }
      ok[i] = true;
      inten[i] = val;
      float* Ji = J + size_t(i) * kVars;
      // intrinsics: d(u)/dfx = x/z, d(v)/dfy = y/z, d/dcx, d/dcy
      Ji[0] = dx * (p[0] * inv_z);
      Ji[1] = dy * (p[1] * inv_z);
      Ji[2] = dx;
      Ji[3] = dy;
      // pose (left-multiplicative [t, w]): dp/dt = I, dp/dw = -[p]x
      float gx = dx * f * inv_z;
      float gy = dy * f * inv_z;
      float gz = -(dx * f * p[0] + dy * f * p[1]) * inv_z * inv_z;
      Ji[4] = gx;
      Ji[5] = gy;
      Ji[6] = gz;
      Ji[7] = gy * p[2] - gz * p[1];
      Ji[8] = gz * p[0] - gx * p[2];
      Ji[9] = gx * p[1] - gy * p[0];
    }
    // descriptor rows per completely-observed point (.cc:839-930)
    for (long i = 0; i < N; ++i) {
      if (!ok[i]) continue;
      const int* nbr = neighbors + size_t(i) * K;
      bool all = true;
      for (int k = 0; k < K; ++k) all &= ok[nbr[k]];
      if (!all) continue;
      ++count;
      // component norm for the robust weight
      double nrm2 = 0.0;
      for (int k = 0; k < K; ++k) {
        double r = (double(inten[nbr[k]]) - inten[i]) - desc[size_t(i) * K + k];
        nrm2 += r * r;
      }
      double w;
      huber(std::sqrt(nrm2), tau, &w);
      cost += w >= 1.0 ? 0.5 * nrm2
                       : tau * (std::sqrt(nrm2) - 0.5 * tau);
      const float* Jc = J + size_t(i) * kVars;
      for (int k = 0; k < K; ++k) {
        double r = (double(inten[nbr[k]]) - inten[i]) - desc[size_t(i) * K + k];
        const float* Jn = J + size_t(nbr[k]) * kVars;
        double row[kVars];
        for (int a = 0; a < kVars; ++a) row[a] = double(Jn[a]) - Jc[a];
        for (int a = 0; a < kVars; ++a) {
          for (int c = a; c < kVars; ++c)
            H[a * kVars + c] += w * row[a] * row[c];
          b[a] += w * r * row[a];
        }
      }
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  std::memcpy(H_out, H, sizeof(H));
  std::memcpy(b_out, b, sizeof(b));
  *cost_out = cost;
  *count_out = count;
  delete[] inten;
  delete[] ok;
  delete[] J;
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"
