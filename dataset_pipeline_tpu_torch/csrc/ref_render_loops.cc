// MEASUREMENT-ONLY reference baselines (like ref_icp_loop.cc): the
// reference's cube-map face render loop and ground-truth depth loop,
// re-implemented dependency-free so a measured single-core CPU number
// exists for BASELINE.md (the reference's binaries are unbuildable here:
// PCL/Eigen/Boost/zlib-less image stack absent, zero egress).
//
// Mirrors:
//  - /root/reference/src/exe/cube_map_renderer.cc:230-372 — per-face
//    projection with truncation rounding + z-buffer, the 8-neighbor
//    median depth / mean color fill-in, and the iterative color flood.
//  - /root/reference/src/exe/ground_truth_creator.cc:148-216 — >=2-obs
//    trimming, pinhole projection with +0.5 rounding, occlusion z-test
//    with threshold, min-z depth update.
//
// NO product code path calls into this file; it exists only so
// cubemap_vs_ref / gt_depth_vs_ref are measured, not guessed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cube_map_renderer.cc:52-103 Median3/5/7/9 take the median of the first
// 3/5/7/9 buffer entries (the reference applies them by bucketed count).
static float median_k(float* p, int k) {
  std::nth_element(p, p + k / 2, p + k);
  return p[k / 2];
}

// One cube-map face: project + z-buffer + fill-in + color flood.
// points: (n,3) f32 row-major (already in the scan's frame), colors (n,3)
// u8, R: row-major 3x3 face rotation. Outputs may be null (timing only).
void ref_cubemap_face(const float* points, const unsigned char* colors,
                      long long n, const double* R, float fx, float fy,
                      float cx, float cy, int width, int height,
                      float* out_depth, unsigned char* out_color) {
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> depth((size_t)width * height, inf);
  std::vector<unsigned char> color((size_t)width * height * 3, 0);

  // projection + z-buffer (cube_map_renderer.cc:238-259)
  for (long long i = 0; i < n; ++i) {
    const float px = points[3 * i], py = points[3 * i + 1],
                pz = points[3 * i + 2];
    const float rx = (float)(R[0] * px + R[1] * py + R[2] * pz);
    const float ry = (float)(R[3] * px + R[4] * py + R[5] * pz);
    const float rz = (float)(R[6] * px + R[7] * py + R[8] * pz);
    if (rz <= 0.f) continue;
    const float x = fx * rx / rz + cx;
    const float y = fy * ry / rz + cy;
    const int ix = static_cast<int>(x);  // reference: simple truncation
    const int iy = static_cast<int>(y);
    if (ix >= 0 && iy >= 0 && ix < width && iy < height) {
      const size_t o = (size_t)iy * width + ix;
      if (rz < depth[o]) {
        depth[o] = rz;
        color[3 * o] = colors[3 * i];
        color[3 * o + 1] = colors[3 * i + 1];
        color[3 * o + 2] = colors[3 * i + 2];
      }
    }
  }

  // fill-in: median depth of valid 8-neighbors by count bucket, mean color
  // (cube_map_renderer.cc:261-323)
  std::vector<float> fdepth((size_t)width * height, inf);
  std::vector<unsigned char> fcolor((size_t)width * height * 3, 0);
  std::vector<unsigned char> valid((size_t)width * height, 0);
  bool have_invalid = false;
  float buffer[9];
  for (int y = 1; y < height - 1; ++y) {
    for (int x = 1; x < width - 1; ++x) {
      const size_t o = (size_t)y * width + x;
      if (!std::isinf(depth[o])) {
        fdepth[o] = depth[o];
        fcolor[3 * o] = color[3 * o];
        fcolor[3 * o + 1] = color[3 * o + 1];
        fcolor[3 * o + 2] = color[3 * o + 2];
        continue;
      }
      int index = 0, r_sum = 0, g_sum = 0, b_sum = 0;
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (dx == 0 && dy == 0) continue;
          const size_t q = (size_t)(y + dy) * width + (x + dx);
          if (!std::isinf(depth[q])) {
            buffer[index] = depth[q];
            r_sum += color[3 * q];
            g_sum += color[3 * q + 1];
            b_sum += color[3 * q + 2];
            ++index;
          }
        }
      }
      if (index <= 1) {
        fdepth[o] = depth[o];
      } else if (index == 2) {
        fdepth[o] = std::min(buffer[0], buffer[1]);
      } else if (index <= 4) {
        fdepth[o] = median_k(buffer, 3);
      } else if (index <= 6) {
        fdepth[o] = median_k(buffer, 5);
      } else if (index <= 8) {
        fdepth[o] = median_k(buffer, 7);
      } else {
        fdepth[o] = median_k(buffer, 9);
      }
      if (index > 0) {
        fcolor[3 * o] = (unsigned char)(r_sum / (1.f * index) + 0.5f);
        fcolor[3 * o + 1] = (unsigned char)(g_sum / (1.f * index) + 0.5f);
        fcolor[3 * o + 2] = (unsigned char)(b_sum / (1.f * index) + 0.5f);
      } else {
        have_invalid = true;
      }
    }
  }
  for (size_t o = 0; o < (size_t)width * height; ++o)
    valid[o] = !std::isinf(fdepth[o]);

  // iterative color flood over still-invalid pixels
  // (cube_map_renderer.cc:325-373)
  std::vector<unsigned char> valid2 = valid;
  while (have_invalid) {
    color = fcolor;
    valid = valid2;
    have_invalid = false;
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        const size_t o = (size_t)y * width + x;
        if (valid[o]) continue;
        int index = 0, r_sum = 0, g_sum = 0, b_sum = 0;
        for (int dy = std::max(0, y - 1); dy <= std::min(height - 1, y + 1);
             ++dy) {
          for (int dx = std::max(0, x - 1); dx <= std::min(width - 1, x + 1);
               ++dx) {
            if (dx == x && dy == y) continue;
            const size_t q = (size_t)dy * width + dx;
            if (valid[q]) {
              r_sum += color[3 * q];
              g_sum += color[3 * q + 1];
              b_sum += color[3 * q + 2];
              ++index;
            }
          }
        }
        if (index > 0) {
          fcolor[3 * o] = (unsigned char)(b_sum / (1.f * index) + 0.5f);
          fcolor[3 * o + 1] = (unsigned char)(g_sum / (1.f * index) + 0.5f);
          fcolor[3 * o + 2] = (unsigned char)(r_sum / (1.f * index) + 0.5f);
          valid2[o] = 1;
        } else {
          have_invalid = true;
        }
      }
    }
  }

  if (out_depth)
    std::copy(fdepth.begin(), fdepth.end(), out_depth);
  if (out_color)
    std::copy(fcolor.begin(), fcolor.end(), out_color);
}

// One GT depth frame: ground_truth_creator.cc:158-216 without the
// scan-rendering splats (write_depth_maps branch only, no mask).
// T: row-major 3x4 image_T_global.
void ref_gt_depth_frame(const float* points, const int* obs_counts,
                        long long n, const double* T, float fx, float fy,
                        float cx, float cy, int width, int height,
                        const float* occlusion, float threshold,
                        float* out_depth) {
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> gt((size_t)width * height, inf);
  for (long long i = 0; i < n; ++i) {
    if (obs_counts[i] < 2) continue;
    const float px = points[3 * i], py = points[3 * i + 1],
                pz = points[3 * i + 2];
    const float zx = (float)(T[0] * px + T[1] * py + T[2] * pz + T[3]);
    const float zy = (float)(T[4] * px + T[5] * py + T[6] * pz + T[7]);
    const float zz = (float)(T[8] * px + T[9] * py + T[10] * pz + T[11]);
    if (zz <= 0.f) continue;
    const float u = fx * (zx / zz) + cx;
    const float v = fy * (zy / zz) + cy;
    const int ix = (int)(u + 0.5f);
    const int iy = (int)(v + 0.5f);
    if (ix >= 0 && iy >= 0 && ix < width && iy < height) {
      const size_t o = (size_t)iy * width + ix;
      if (occlusion[o] + threshold >= zz) {
        gt[o] = std::min(gt[o], zz);
      }
    }
  }
  if (out_depth)
    std::copy(gt.begin(), gt.end(), out_depth);
}

}  // extern "C"
