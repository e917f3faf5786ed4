// Z-buffered triangle rasterizer — native core of the pixel↔surface mapping.
//
// Copied from csrc/rasterizer.cpp (the port builds and loads its own copy,
// brdf_tpu_torch/native.py).
//
// The framework precomputes, per camera, which mesh face every pixel sees
// (brdf_tpu_torch/geometry/rasterize.py). That map is host-side scene
// preprocessing (never differentiated), and the pure-NumPy version costs
// seconds per view on scanned meshes; this C++ core does the same
// scan-conversion at native speed and is loaded via ctypes.
//
// Semantics match rasterize.py exactly: pixel centers at (x+0.5, y+0.5),
// edge-function barycentrics, perspective-correct depth via 1/z interpolation,
// closest-hit depth test. (The reference app instead projected triangle
// centroids through live GL state with no depth test — brdfdata.cpp:629-681.)

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <limits>

extern "C" {

// uv: (V,2) projected pixel coords; z: (V,) camera-space depth;
// faces: (F,3) vertex indices; outputs are H*W (face_id, depth) and H*W*3
// (bary), pre-initialized by the caller to -1 / +inf / 0.
void rasterize_faces(const double* uv, const double* z, const int32_t* faces,
                     int64_t n_faces, int32_t width, int32_t height,
                     int32_t* face_id, float* bary, float* depth) {
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f + 0];
    const int32_t i1 = faces[3 * f + 1];
    const int32_t i2 = faces[3 * f + 2];
    const double z0 = z[i0], z1 = z[i1], z2 = z[i2];
    if (!(z0 > 1e-6) || !(z1 > 1e-6) || !(z2 > 1e-6)) continue;  // behind cam

    const double x0 = uv[2 * i0], y0 = uv[2 * i0 + 1];
    const double x1 = uv[2 * i1], y1 = uv[2 * i1 + 1];
    const double x2 = uv[2 * i2], y2 = uv[2 * i2 + 1];

    const double minx = std::min({x0, x1, x2}), maxx = std::max({x0, x1, x2});
    const double miny = std::min({y0, y1, y2}), maxy = std::max({y0, y1, y2});
    if (maxx < 0 || minx >= width || maxy < 0 || miny >= height) continue;

    const int32_t px0 = std::max<int32_t>((int32_t)std::floor(minx), 0);
    const int32_t px1 = std::min<int32_t>((int32_t)std::ceil(maxx), width - 1);
    const int32_t py0 = std::max<int32_t>((int32_t)std::floor(miny), 0);
    const int32_t py1 = std::min<int32_t>((int32_t)std::ceil(maxy), height - 1);
    if (px1 < px0 || py1 < py0) continue;

    const double d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(d) < 1e-12) continue;  // degenerate
    const double inv_d = 1.0 / d;
    const double iz0 = 1.0 / z0, iz1 = 1.0 / z1, iz2 = 1.0 / z2;

    for (int32_t py = py0; py <= py1; ++py) {
      const double cy = py + 0.5;
      for (int32_t px = px0; px <= px1; ++px) {
        const double cx = px + 0.5;
        const double b0 = ((y1 - y2) * (cx - x2) + (x2 - x1) * (cy - y2)) * inv_d;
        const double b1 = ((y2 - y0) * (cx - x2) + (x0 - x2) * (cy - y2)) * inv_d;
        const double b2 = 1.0 - b0 - b1;
        if (b0 < 0 || b1 < 0 || b2 < 0) continue;
        const double inv_z = b0 * iz0 + b1 * iz1 + b2 * iz2;
        const float pz = (float)(1.0 / std::max(inv_z, 1e-12));
        const int64_t idx = (int64_t)py * width + px;
        if (pz < depth[idx]) {
          depth[idx] = pz;
          face_id[idx] = (int32_t)f;
          bary[3 * idx + 0] = (float)b0;
          bary[3 * idx + 1] = (float)b1;
          bary[3 * idx + 2] = (float)b2;
        }
      }
    }
  }
}

}  // extern "C"
