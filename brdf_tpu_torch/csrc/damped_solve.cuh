// The closed-form damped solve of the box-projected LM step, per lane:
// dp = −Af⁻¹ gf for a symmetric m × m system, m = 1..9. Shared by K5
// (lm.cu, the whole solve in one kernel) and the step kernels of the eager LM
// loop (lm_step.cu). Its plain PyTorch twin is ops/lm.py::_solve_damped, and
// both round alike under lobes.cuh's rules (-fmad=false; clamps and maxima
// propagate NaN, bvls2.cuh).
#pragma once

#include <math.h>

#include "bvls2.cuh"

namespace brdf {

// a determinant or Cholesky pivot at or below this flags the lane's system
constexpr float kTiny = 1e-30f;

// Closed-form symmetric solve dp = −Af⁻¹ gf; af[j][k] is read for j ≤ k only.
// Scalar, 2×2 and 3×3 Cramer; an unrolled Cholesky from m = 4 on.
template <int M>
__device__ __forceinline__ bool solve_damped(float (&af)[M][M], float (&gf)[M],
                                             float (&dp)[M]) {
  if constexpr (M == 1) {
    const float det = af[0][0];
    const bool ok = fabsf(det) > kTiny;
    const float inv = ok ? 1.0f / det : 0.0f;
    dp[0] = -gf[0] * inv;
    return ok;
  } else if constexpr (M == 2) {
    const float det = af[0][0] * af[1][1] - af[0][1] * af[0][1];
    const bool ok = fabsf(det) > kTiny;
    const float inv = ok ? 1.0f / det : 0.0f;
    dp[0] = -(af[1][1] * gf[0] - af[0][1] * gf[1]) * inv;
    dp[1] = -(af[0][0] * gf[1] - af[0][1] * gf[0]) * inv;
    return ok;
  } else if constexpr (M == 3) {
    const float c00 = af[1][1] * af[2][2] - af[1][2] * af[1][2];
    const float c01 = af[0][2] * af[1][2] - af[0][1] * af[2][2];
    const float c02 = af[0][1] * af[1][2] - af[0][2] * af[1][1];
    const float c11 = af[0][0] * af[2][2] - af[0][2] * af[0][2];
    const float c12 = af[0][1] * af[0][2] - af[0][0] * af[1][2];
    const float c22 = af[0][0] * af[1][1] - af[0][1] * af[0][1];
    const float det = af[0][0] * c00 + af[0][1] * c01 + af[0][2] * c02;
    const bool ok = fabsf(det) > kTiny;
    const float inv = ok ? 1.0f / det : 0.0f;
    dp[0] = -(c00 * gf[0] + c01 * gf[1] + c02 * gf[2]) * inv;
    dp[1] = -(c01 * gf[0] + c11 * gf[1] + c12 * gf[2]) * inv;
    dp[2] = -(c02 * gf[0] + c12 * gf[1] + c22 * gf[2]) * inv;
    return ok;
  } else {
    // Cholesky A = L Lᵀ, unrolled; a pivot at or below kTiny flags the lane
    float l[M][M];
    bool ok = true;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) s += l[j][k] * l[j][k];
      const float v = af[j][j] - s;
      ok = ok && (v > kTiny);
      l[j][j] = sqrtf(max_nan(v, kTiny));
#pragma unroll
      for (int i = j + 1; i < M; ++i) {
        float c = 0.0f;
#pragma unroll
        for (int k = 0; k < j; ++k) c += l[i][k] * l[j][k];
        l[i][j] = (af[j][i] - c) / l[j][j];
      }
    }
    float yv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {  // forward: L y = −g
      float c = 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) c += l[i][k] * yv[k];
      yv[i] = (-gf[i] - c) / l[i][i];
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {  // backward: Lᵀ dp = y
      float c = 0.0f;
#pragma unroll
      for (int k = i + 1; k < M; ++k) c += l[k][i] * dp[k];
      dp[i] = (yv[i] - c) / l[i][i];
    }
    const float okf = ok ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) dp[i] = dp[i] * okf;
    return ok;
  }
}

}  // namespace brdf
