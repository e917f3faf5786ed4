// Analytic lobe library for Hopper: value, dI/dparams and dI/dangles of one
// (view, texel) pair, as scalar device functions that every kernel of the
// port includes.
//
// Replaces brdf_tpu/ops/shading_pallas.py::SHADING_KERNELS (kernel K0) for the
// four separable lobes: _blinn_phong_full, _phong_full, _ct_core +
// _cook_torrance_full and _ward_full. The plain PyTorch twin is
// brdf_tpu_torch/ops/shading.py; both follow the same operation order and the
// clamp/mask subgradient conventions of models/brdf.py.
//
// Rules kept throughout: float literals only (nothing is promoted to double);
// expf/logf/sqrtf, never the __expf intrinsics or --use_fast_math; a mask is a
// select, never a multiply, wherever the masked branch can hold inf. Each
// operation rounds as PyTorch's CUDA kernels round the plain version's (the
// sources are built with -fmad=false, a division by a constant is a multiply
// by its float32 reciprocal, and c / x is (1 / x) * c as in torch): the fused
// solve is chaotic at the last bit, so only equal rounding lets the kernel be
// held against its plain version lane for lane.
#pragma once

#include <math.h>

namespace brdf {

enum Lobe : int {
  LOBE_BLINN_PHONG = 0,
  LOBE_PHONG = 1,
  LOBE_COOK_TORRANCE = 2,
  LOBE_WARD = 3,
};

constexpr float kEps = 1e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float kInvTwoPi = static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kFourPi = static_cast<float>(4.0 * 3.14159265358979323846);

// Number of angle channels each lobe reads, in the order of ops/shading.py:
// blinn_phong (cos_ln, cos_nh), phong (cos_ln, cos_rv),
// cook_torrance and ward (cos_ln, cos_nh, cos_vn).
template <int L> struct LobeAngles { static constexpr int n = 3; };
template <> struct LobeAngles<LOBE_BLINN_PHONG> { static constexpr int n = 2; };
template <> struct LobeAngles<LOBE_PHONG> { static constexpr int n = 2; };

struct LobeOut {
  float i;      // intensity
  float dp[3];  // dI/d(kd, ks, shape)
  float da[3];  // dI/d(angle channels); unused entries are 0
};

__device__ __forceinline__ float step_f(bool m) { return m ? 1.0f : 0.0f; }

__device__ __forceinline__ LobeOut blinn_phong_full(float cl, float cnh, float kd,
                                                   float ks, float n) {
  LobeOut o;
  const bool lit = cl > 0.0f;
  const float diff_b = fmaxf(cl, 0.0f);
  const float ln_s = logf(fmaxf(cnh, kEps));
  const bool m = lit && (cnh > 0.0f);
  const float pw = m ? expf(n * ln_s) : 0.0f;
  const float pw_m1 = m ? expf((n - 1.0f) * ln_s) : 0.0f;
  o.i = kd * diff_b + ks * pw;
  o.dp[0] = diff_b;
  o.dp[1] = pw;
  o.dp[2] = ks * ln_s * pw;
  o.da[0] = kd * step_f(lit);
  o.da[1] = ks * n * pw_m1;
  o.da[2] = 0.0f;
  return o;
}

__device__ __forceinline__ LobeOut phong_full(float cl, float crv, float kd, float ks,
                                              float n) {
  LobeOut o;
  const bool lit = cl > 0.0f;
  const float diff_b = fmaxf(cl, 0.0f);
  const float ln_s = logf(fmaxf(crv, kEps));
  const bool m = lit && (crv > 0.0f);
  const float pw = m ? expf(n * ln_s) : 0.0f;
  const float pw_m1 = m ? expf((n - 1.0f) * ln_s) : 0.0f;
  const float norm = (n + 2.0f) * kInvTwoPi;
  o.i = kd * diff_b + ks * norm * pw;
  o.dp[0] = diff_b;
  o.dp[1] = norm * pw;
  o.dp[2] = ks * (pw * kInvTwoPi + norm * ln_s * pw);
  o.da[0] = kd * step_f(lit);
  o.da[1] = ks * norm * n * pw_m1;
  o.da[2] = 0.0f;
  return o;
}

__device__ __forceinline__ LobeOut cook_torrance_full(float cl, float cnh, float cvn,
                                                      float kd, float ks, float rough) {
  // _ct_core: S = ks·D·vis·nl·[nl>0]
  const float nl = fmaxf(cl, 0.0f);
  const float nv = fmaxf(cvn, kEps);
  const float nh = fmaxf(cnh, 0.0f);
  const float r = fmaxf(rough, 1e-3f);
  const float r2 = r * r;
  const float a2 = r2 * r2;

  const float u = nh * nh * (a2 - 1.0f) + 1.0f;
  const float du = kPi * u * u;
  const bool d_clamped = du <= kEps;
  const float du_s = fmaxf(du, kEps);
  const float d = a2 / du_s;
  // selected, so the dead branch cannot turn inf·0 into NaN at grazing nh
  const float inv_u = d_clamped ? 0.0f : 1.0f / fmaxf(u, kEps);
  const float dd_da2 = 1.0f / du_s - 2.0f * a2 * nh * nh * inv_u / du_s;
  const float dd_dnh = -(2.0f * a2 * inv_u / du_s) * 2.0f * nh * (a2 - 1.0f);

  const float sv = sqrtf(nv * nv * (1.0f - a2) + a2);
  const float sl = sqrtf(nl * nl * (1.0f - a2) + a2);
  const float den_raw = nl * sv + nv * sl;
  const float den = fmaxf(den_raw, kEps);
  const float vis = (1.0f / den) * 0.5f;
  const float dden = (1.0f / (den * den)) * -0.5f * (1.0f - step_f(den_raw <= kEps));
  const float sv_s = fmaxf(sv, kEps);
  const float sl_s = fmaxf(sl, kEps);
  const float dvis_dnl = dden * (sv + nv * nl * (1.0f - a2) / sl_s);
  const float dvis_dnv = dden * (nl * nv * (1.0f - a2) / sv_s + sl);
  const float dvis_da2 =
      dden * (nl * (1.0f - nv * nv) / (2.0f * sv_s) + nv * (1.0f - nl * nl) / (2.0f * sl_s));

  const float lit = step_f(nl > 0.0f);
  const float core = d * vis * nl * lit;
  const float s_val = ks * core;
  const float da2_dr = 4.0f * r2 * r;
  const float live_r = step_f(rough > 1e-3f);
  const float ds_drough = ks * (dd_da2 * vis + d * dvis_da2) * nl * lit * da2_dr * live_r;
  const float ds_dcl = ks * (d * (vis + nl * dvis_dnl)) * lit * step_f(cl > 0.0f);
  const float ds_dcnh = ks * dd_dnh * vis * nl * lit * step_f(cnh > 0.0f);
  const float ds_dcvn = ks * d * nl * dvis_dnv * lit * step_f(cvn > kEps);

  LobeOut o;
  o.i = kd * kInvPi * nl + s_val;
  o.dp[0] = kInvPi * nl;
  o.dp[1] = core;
  o.dp[2] = ds_drough;
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f) + ds_dcl;
  o.da[1] = ds_dcnh;
  o.da[2] = ds_dcvn;
  return o;
}

__device__ __forceinline__ LobeOut ward_full(float cl, float cnh, float cvn, float kd,
                                             float ks, float alpha) {
  const float nl = fmaxf(cl, 0.0f);
  const float nv = fmaxf(cvn, kEps);
  const float nh = fmaxf(cnh, 1e-4f);  // floor matches models/brdf.py::ward
  const float a = fmaxf(alpha, 1e-3f);
  const float a2 = a * a;
  const float tan2 = (1.0f - nh * nh) / (nh * nh);
  const float lobe = expf(-tan2 / a2) / (kFourPi * a2);
  const float lit = step_f((cl > 0.0f) && (cnh > 0.0f) && (cvn > 0.0f));
  const float rt = sqrtf(nl / nv);
  const float spec_b = rt * lobe * lit;

  LobeOut o;
  o.i = kd * kInvPi * nl + ks * spec_b;
  o.dp[0] = kInvPi * nl;
  o.dp[1] = spec_b;
  o.dp[2] = ks * spec_b * 2.0f * (tan2 - a2) / (a2 * a) * step_f(alpha > 1e-3f);
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f) +
            ks * lobe * lit / (2.0f * sqrtf(fmaxf(nl * nv, kEps))) * step_f(cl > 0.0f);
  o.da[1] = ks * rt * lobe * lit * ((1.0f / (nh * nh * nh * a2)) * 2.0f) * step_f(cnh > 1e-4f);
  o.da[2] = ks * lobe * lit * (-0.5f) * rt / nv * step_f(cvn > kEps);
  return o;
}

// One lobe by its compile-time selector; ang holds LobeAngles<L>::n channels.
template <int L>
__device__ __forceinline__ LobeOut lobe_full(const float* ang, float kd, float ks,
                                             float shape) {
  if constexpr (L == LOBE_BLINN_PHONG) {
    return blinn_phong_full(ang[0], ang[1], kd, ks, shape);
  } else if constexpr (L == LOBE_PHONG) {
    return phong_full(ang[0], ang[1], kd, ks, shape);
  } else if constexpr (L == LOBE_COOK_TORRANCE) {
    return cook_torrance_full(ang[0], ang[1], ang[2], kd, ks, shape);
  } else {
    return ward_full(ang[0], ang[1], ang[2], kd, ks, shape);
  }
}

}  // namespace brdf
