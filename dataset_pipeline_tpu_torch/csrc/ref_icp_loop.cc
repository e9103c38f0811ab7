// Faithful C++14 re-implementation of the reference's ICP inner-iteration
// hot loop, used ONLY to obtain a measured single-node CPU baseline on this
// machine (BASELINE.md). The reference's own binaries are unbuildable in
// this image (PCL/Eigen/Boost/Glog/GMP/opengv absent, no network), so this
// mirrors /root/reference/src/icp/icp_point_to_plane_impl.h:115-211 line
// for line — per correspondence: two global-frame transforms, the
// symmetric point-to-plane residual pair, the exact 6-dof Jacobian
// expressions, and the reference's Accumulate (upper-triangular 6x6 DOUBLE
// accumulation, impl.h:82-113) — without any Eigen dependency.
// Compile with the reference's own flags: -O2 -msse2 -msse3 (its
// CMakeLists.txt:82). Single-threaded, as the reference's inner loop is.

#include <chrono>
#include <cstring>

namespace {

struct Mat3 {
  float m[9];
};

inline void transform(const Mat3& R, const float* t, const float* p,
                      float* out) {
  out[0] = R.m[0] * p[0] + R.m[1] * p[1] + R.m[2] * p[2] + t[0];
  out[1] = R.m[3] * p[0] + R.m[4] * p[1] + R.m[5] * p[2] + t[1];
  out[2] = R.m[6] * p[0] + R.m[7] * p[1] + R.m[8] * p[2] + t[2];
}

inline void rotate(const Mat3& R, const float* p, float* out) {
  out[0] = R.m[0] * p[0] + R.m[1] * p[1] + R.m[2] * p[2];
  out[1] = R.m[3] * p[0] + R.m[4] * p[1] + R.m[5] * p[2];
  out[2] = R.m[6] * p[0] + R.m[7] * p[1] + R.m[8] * p[2];
}

// impl.h:82-113 Accumulate for the 2-cloud case: cloud 0 gauge-fixed
// (variables index -1), cloud 1 owns variables 0..5.
inline void accumulate(double weight, double residual, int src_vars,
                       const double* j_src, int tgt_vars, const double* j_tgt,
                       double* H, double* b) {
  double wr = weight * residual;
  if (src_vars >= 0) {
    for (int r = 0; r < 6; ++r) {
      for (int c = r; c < 6; ++c)
        H[(src_vars + r) * 6 + src_vars + c] += weight * j_src[r] * j_src[c];
      b[src_vars + r] += wr * j_src[r];
    }
    if (tgt_vars >= 0) {
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c)
          H[(src_vars + r) * 6 + tgt_vars + c] +=
              weight * j_src[r] * j_tgt[c];
    }
  }
  if (tgt_vars >= 0) {
    for (int r = 0; r < 6; ++r) {
      for (int c = r; c < 6; ++c)
        H[(tgt_vars + r) * 6 + tgt_vars + c] += weight * j_tgt[r] * j_tgt[c];
      b[tgt_vars + r] += wr * j_tgt[r];
    }
  }
}

}  // namespace

extern "C" {

// Correspondences are split into two groups like the reference's ordered
// pair enumeration for 2 clouds: [0, half) is source=0 (fixed) -> target=1,
// [half, M) is source=1 -> target=0. ps/ns/pt/nt are LOCAL-frame (M,3)
// float32; R*/t* index [cloud*9]/[cloud*3]. Runs ``iters`` full inner
// H,b,cost accumulations (what impl.h redoes per LM lambda trial) and
// returns the total seconds; H (6x6, upper), b (6), cost written out.
double ref_icp_inner(const float* ps, const float* ns, const float* pt,
                     const float* nt, long M, long half, const float* Rs,
                     const float* ts, int iters, double* H_out, double* b_out,
                     double* cost_out) {
  auto t0 = std::chrono::steady_clock::now();
  double H[36];
  double b[6];
  double cost = 0.0;
  for (int it = 0; it < iters; ++it) {
    std::memset(H, 0, sizeof(H));
    std::memset(b, 0, sizeof(b));
    cost = 0.0;
    for (long i = 0; i < M; ++i) {
      int src_cloud = i < half ? 0 : 1;
      int tgt_cloud = 1 - src_cloud;
      int src_vars = src_cloud == 0 ? -1 : 0;
      int tgt_vars = tgt_cloud == 0 ? -1 : 0;
      Mat3 R_s, R_t;
      std::memcpy(R_s.m, Rs + 9 * src_cloud, sizeof(R_s.m));
      std::memcpy(R_t.m, Rs + 9 * tgt_cloud, sizeof(R_t.m));
      const float* t_s = ts + 3 * src_cloud;
      const float* t_t = ts + 3 * tgt_cloud;

      float gsp[3], gsn[3], gtp[3], gtn[3];
      transform(R_s, t_s, ps + 3 * i, gsp);
      rotate(R_s, ns + 3 * i, gsn);
      transform(R_t, t_t, pt + 3 * i, gtp);
      rotate(R_t, nt + 3 * i, gtn);

      // Src distance (impl.h:158-183)
      float src_res = gsn[0] * (gtp[0] - gsp[0]) + gsn[1] * (gtp[1] - gsp[1])
          + gsn[2] * (gtp[2] - gsp[2]);
      cost += double(src_res) * src_res;
      double j_tgt[6] = {
          gsn[0], gsn[1], gsn[2],
          -double(gsn[1]) * gtp[2] + double(gsn[2]) * gtp[1],
          double(gsn[0]) * gtp[2] - double(gsn[2]) * gtp[0],
          -double(gsn[0]) * gtp[1] + double(gsn[1]) * gtp[0]};
      // the reference's expanded source expression (impl.h:172-177)
      double j_src[6] = {
          -gsn[0], -gsn[1], -gsn[2],
          double(gsn[1]) * gsp[2] - double(gsn[1]) * (gsp[2] - gtp[2])
              - double(gsn[2]) * gsp[1] + double(gsn[2]) * (gsp[1] - gtp[1]),
          -double(gsn[0]) * gsp[2] + double(gsn[0]) * (gsp[2] - gtp[2])
              + double(gsn[2]) * gsp[0] - double(gsn[2]) * (gsp[0] - gtp[0]),
          double(gsn[0]) * gsp[1] - double(gsn[0]) * (gsp[1] - gtp[1])
              - double(gsn[1]) * gsp[0] + double(gsn[1]) * (gsp[0] - gtp[0])};
      accumulate(1.0, src_res, src_vars, j_src, tgt_vars, j_tgt, H, b);

      // Target distance (impl.h:185-209)
      float tgt_res = gtn[0] * (gsp[0] - gtp[0]) + gtn[1] * (gsp[1] - gtp[1])
          + gtn[2] * (gsp[2] - gtp[2]);
      cost += double(tgt_res) * tgt_res;
      double j_tgt2[6] = {
          -gtn[0], -gtn[1], -gtn[2],
          double(gtn[1]) * gtp[2] - double(gtn[1]) * (gtp[2] - gsp[2])
              - double(gtn[2]) * gtp[1] + double(gtn[2]) * (gtp[1] - gsp[1]),
          -double(gtn[0]) * gtp[2] + double(gtn[0]) * (gtp[2] - gsp[2])
              + double(gtn[2]) * gtp[0] - double(gtn[2]) * (gtp[0] - gsp[0]),
          double(gtn[0]) * gtp[1] - double(gtn[0]) * (gtp[1] - gsp[1])
              - double(gtn[1]) * gtp[0] + double(gtn[1]) * (gtp[0] - gsp[0])};
      double j_src2[6] = {
          gtn[0], gtn[1], gtn[2],
          -double(gtn[1]) * gsp[2] + double(gtn[2]) * gsp[1],
          double(gtn[0]) * gsp[2] - double(gtn[2]) * gsp[0],
          -double(gtn[0]) * gsp[1] + double(gtn[1]) * gsp[0]};
      accumulate(1.0, tgt_res, src_vars, j_src2, tgt_vars, j_tgt2, H, b);
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  std::memcpy(H_out, H, sizeof(H));
  std::memcpy(b_out, b, sizeof(b));
  *cost_out = cost;
  return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"
