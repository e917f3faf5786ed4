// The closed-form box-constrained linear pair of the separable VarPro solves,
// solver/varpro.py::_bvls2, shared by K1 (varpro.cu) and K8 (varpro_nd.cu):
// min ‖kd·a + ks·b − y‖² over the (kd, ks) box from the Gram entries, the
// interior stationary point against the four clamped edges. Clamps and maxima
// propagate NaN as torch.clamp and torch.maximum do, so a kernel rounds as its
// plain version does on every lane (lobes.cuh states the other rules).
#pragma once

#include <math.h>

namespace brdf {

// torch.clamp / torch.maximum / torch.minimum propagate NaN; fminf and fmaxf drop it
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float gram_cost(float x0, float x1, float aa, float ab, float bb,
                                           float ay, float by) {
  return x0 * x0 * aa + x1 * x1 * bb + 2.0f * x0 * x1 * ab - 2.0f * (x0 * ay + x1 * by);
}

__device__ __forceinline__ void bvls2(float aa, float ab, float bb, float ay, float by, float l0,
                                      float u0, float l1, float u1, float& kd, float& ks) {
  const float det = aa * bb - ab * ab;
  const bool det_ok = fabsf(det) > 1e-30f;
  const float det_s = det_ok ? det : 1.0f;
  const float xi0 = (bb * ay - ab * by) / det_s;
  const float xi1 = (aa * by - ab * ay) / det_s;
  const bool interior_ok = det_ok && (xi0 >= l0) && (xi0 <= u0) && (xi1 >= l1) && (xi1 <= u1);

  float b0 = l0;
  float b1 = clip_nan((by - l0 * ab) / max_nan(bb, 1e-30f), l1, u1);
  float bc = gram_cost(b0, b1, aa, ab, bb, ay, by);
  {
    const float x1 = clip_nan((by - u0 * ab) / max_nan(bb, 1e-30f), l1, u1);
    const float c = gram_cost(u0, x1, aa, ab, bb, ay, by);
    if (c < bc) { b0 = u0; b1 = x1; bc = c; }
  }
  {
    const float x0 = clip_nan((ay - l1 * ab) / max_nan(aa, 1e-30f), l0, u0);
    const float c = gram_cost(x0, l1, aa, ab, bb, ay, by);
    if (c < bc) { b0 = x0; b1 = l1; bc = c; }
  }
  {
    const float x0 = clip_nan((ay - u1 * ab) / max_nan(aa, 1e-30f), l0, u0);
    const float c = gram_cost(x0, u1, aa, ab, bb, ay, by);
    if (c < bc) { b0 = x0; b1 = u1; bc = c; }
  }
  const bool take_i = interior_ok && (gram_cost(xi0, xi1, aa, ab, bb, ay, by) < bc);
  kd = take_i ? xi0 : b0;
  ks = take_i ? xi1 : b1;
}

}  // namespace brdf
