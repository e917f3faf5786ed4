// Analytic lobe library for Hopper: value, dI/dparams and dI/dangles of one
// (view, texel) pair, as scalar device functions that every kernel of the
// port includes.
//
// Replaces brdf_tpu/ops/shading_pallas.py::SHADING_KERNELS (kernel K0), all ten
// lobes: _blinn_phong_full, _phong_full, _ct_core + _cook_torrance_full,
// _ward_full, _cook_torrance_fresnel_full, _lambert_full, _minnaert_full,
// _oren_nayar_full, _ward_aniso_full and _cook_torrance_aniso_full. The plain
// PyTorch twin is brdf_tpu_torch/ops/shading.py; both follow the same operation
// order and the clamp/mask subgradient conventions of models/brdf.py.
//
// Rules kept throughout: float literals only (nothing is promoted to double);
// expf/logf/sqrtf/sinf/cosf, never the __expf intrinsics or --use_fast_math; a
// mask is a select, never a multiply, wherever the masked branch can hold inf;
// an integer power is written out as multiplies, never powf. Each operation
// rounds as PyTorch's CUDA kernels round the plain version's (the sources are
// built with -fmad=false, a division by a constant is a multiply by its
// float32 reciprocal, and c / x is (1 / x) * c as in torch): the fused solves
// are chaotic at the last bit, so only equal rounding lets a kernel be held
// against its plain version lane for lane.
//
// LobeOut is sized per lobe (1-5 parameters, 1-9 angle channels), so a kernel
// that includes only the three-parameter lobes carries no wider struct than
// before; everything is __forceinline__, and an output a kernel does not read
// (dI/dangles in the solvers) is dead code the compiler removes.
#pragma once

#include <math.h>

namespace brdf {

// The lobe_id of ops/shading.py::SHADING_KERNELS.
enum Lobe : int {
  LOBE_BLINN_PHONG = 0,
  LOBE_PHONG = 1,
  LOBE_COOK_TORRANCE = 2,
  LOBE_WARD = 3,
  LOBE_COOK_TORRANCE_FRESNEL = 4,
  LOBE_LAMBERT = 5,
  LOBE_MINNAERT = 6,
  LOBE_OREN_NAYAR = 7,
  LOBE_WARD_ANISO = 8,
  LOBE_COOK_TORRANCE_ANISO = 9,
  LOBE_COUNT = 10,
};

constexpr float kEps = 1e-12f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float kInvTwoPi = static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kFourPi = static_cast<float>(4.0 * 3.14159265358979323846);

// Parameters and angle channels of each lobe, in the order of
// ops/shading.py::SHADING_KERNELS[...].angle_names:
//   blinn_phong (cos_ln, cos_nh), phong (cos_ln, cos_rv),
//   cook_torrance and ward (cos_ln, cos_nh, cos_vn),
//   cook_torrance_fresnel (+ cos_rv), lambert (cos_ln), minnaert (cos_ln, cos_vn),
//   oren_nayar (cos_ln, cos_vn, cos_rv), ward_aniso (+ cos_th, cos_bh),
//   cook_torrance_aniso (+ cos_th, cos_bh, cos_tl, cos_bl, cos_tv, cos_bv).
template <int L> struct LobeTraits { static constexpr int n_params = 3, n_angles = 3; };
template <> struct LobeTraits<LOBE_BLINN_PHONG> { static constexpr int n_params = 3, n_angles = 2; };
template <> struct LobeTraits<LOBE_PHONG> { static constexpr int n_params = 3, n_angles = 2; };
template <> struct LobeTraits<LOBE_COOK_TORRANCE_FRESNEL> { static constexpr int n_params = 4, n_angles = 4; };
template <> struct LobeTraits<LOBE_LAMBERT> { static constexpr int n_params = 1, n_angles = 1; };
template <> struct LobeTraits<LOBE_MINNAERT> { static constexpr int n_params = 2, n_angles = 2; };
template <> struct LobeTraits<LOBE_OREN_NAYAR> { static constexpr int n_params = 2, n_angles = 3; };
template <> struct LobeTraits<LOBE_WARD_ANISO> { static constexpr int n_params = 5, n_angles = 5; };
template <> struct LobeTraits<LOBE_COOK_TORRANCE_ANISO> { static constexpr int n_params = 5, n_angles = 9; };

template <int NP, int NA>
struct LobeOutN {
  float i;       // intensity
  float dp[NP];  // dI/dparams
  float da[NA];  // dI/d(angle channels)
};
template <int L>
using LobeOut = LobeOutN<LobeTraits<L>::n_params, LobeTraits<L>::n_angles>;

__device__ __forceinline__ float step_f(bool m) { return m ? 1.0f : 0.0f; }

// torch.clamp(x, lo, hi) on finite bounds: max, then min
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ LobeOut<LOBE_BLINN_PHONG> blinn_phong_full(float cl, float cnh,
                                                                      float kd, float ks,
                                                                      float n) {
  LobeOut<LOBE_BLINN_PHONG> o;
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
  return o;
}

__device__ __forceinline__ LobeOut<LOBE_PHONG> phong_full(float cl, float crv, float kd,
                                                          float ks, float n) {
  LobeOut<LOBE_PHONG> o;
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
  return o;
}

// _ct_core: S = ks·D·vis·nl·[nl>0] and its partials, shared by the plain and
// the Fresnel Cook-Torrance lobes
struct CtCore {
  float s_val, core, nl, ds_drough, ds_dcl, ds_dcnh, ds_dcvn;
};

__device__ __forceinline__ CtCore ct_core(float cl, float cnh, float cvn, float ks,
                                          float rough) {
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
  const float da2_dr = 4.0f * r2 * r;
  const float live_r = step_f(rough > 1e-3f);
  CtCore c;
  c.nl = nl;
  c.core = d * vis * nl * lit;
  c.s_val = ks * c.core;
  c.ds_drough = ks * (dd_da2 * vis + d * dvis_da2) * nl * lit * da2_dr * live_r;
  c.ds_dcl = ks * (d * (vis + nl * dvis_dnl)) * lit * step_f(cl > 0.0f);
  c.ds_dcnh = ks * dd_dnh * vis * nl * lit * step_f(cnh > 0.0f);
  c.ds_dcvn = ks * d * nl * dvis_dnv * lit * step_f(cvn > kEps);
  return c;
}

__device__ __forceinline__ LobeOut<LOBE_COOK_TORRANCE> cook_torrance_full(
    float cl, float cnh, float cvn, float kd, float ks, float rough) {
  const CtCore c = ct_core(cl, cnh, cvn, ks, rough);
  LobeOut<LOBE_COOK_TORRANCE> o;
  o.i = kd * kInvPi * c.nl + c.s_val;
  o.dp[0] = kInvPi * c.nl;
  o.dp[1] = c.core;
  o.dp[2] = c.ds_drough;
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f) + c.ds_dcl;
  o.da[1] = c.ds_dcnh;
  o.da[2] = c.ds_dcvn;
  return o;
}

__device__ __forceinline__ LobeOut<LOBE_WARD> ward_full(float cl, float cnh, float cvn,
                                                        float kd, float ks, float alpha) {
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

  LobeOut<LOBE_WARD> o;
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

__device__ __forceinline__ LobeOut<LOBE_COOK_TORRANCE_FRESNEL> cook_torrance_fresnel_full(
    float cl, float cnh, float cvn, float crv, float kd, float ks, float rough, float f0) {
  const CtCore c = ct_core(cl, cnh, cvn, ks, rough);
  // Schlick Fresnel on the half-angle: L·V = 2(N·L)(N·V) − R·V (raw angles)
  const float lv = 2.0f * cl * cvn - crv;
  const float half_raw = (1.0f + lv) * 0.5f;
  const float vh = sqrtf(fmaxf(half_raw, kEps));
  const float b = 1.0f - vh;
  const bool mb = b > 0.0f;
  const float b_s = fmaxf(b, kEps);
  const float b2 = b_s * b_s;
  const float b4 = b2 * b2;
  const float u5 = mb ? b4 * b_s : 0.0f;
  const float u4 = mb ? b4 : 0.0f;
  const float fres = f0 + (1.0f - f0) * u5;
  const float live_h = step_f(half_raw > kEps);
  const float df_dlv = -(1.0f - f0) * 5.0f * u4 / (4.0f * vh) * live_h;

  LobeOut<LOBE_COOK_TORRANCE_FRESNEL> o;
  o.i = kd * kInvPi * c.nl + fres * c.s_val;
  o.dp[0] = kInvPi * c.nl;
  o.dp[1] = fres * c.core;
  o.dp[2] = fres * c.ds_drough;
  o.dp[3] = c.s_val * (1.0f - u5);
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f) + fres * c.ds_dcl + c.s_val * df_dlv * 2.0f * cvn;
  o.da[1] = fres * c.ds_dcnh;
  o.da[2] = fres * c.ds_dcvn + c.s_val * df_dlv * 2.0f * cl;
  o.da[3] = c.s_val * df_dlv * -1.0f;
  return o;
}

__device__ __forceinline__ LobeOut<LOBE_LAMBERT> lambert_full(float cl, float kd) {
  const float nl = fmaxf(cl, 0.0f);
  LobeOut<LOBE_LAMBERT> o;
  o.i = kd * kInvPi * nl;
  o.dp[0] = kInvPi * nl;
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f);
  return o;
}

__device__ __forceinline__ LobeOut<LOBE_MINNAERT> minnaert_full(float cl, float cvn, float kd,
                                                                float k) {
  const float nl = fmaxf(cl, 0.0f);
  const float nv = fmaxf(cvn, kEps);
  const float lit = step_f((cl > 0.0f) && (cvn > 0.0f));
  const float ln_l = logf(fmaxf(nl, kEps));
  const float ln_v = logf(nv);
  const bool ml = cl > 0.0f;
  const float pl = ml ? expf(k * ln_l) : 0.0f;              // nl^k
  const float pl_m1 = ml ? expf((k - 1.0f) * ln_l) : 0.0f;
  const float pv = expf((k - 1.0f) * ln_v);                 // nv^(k−1), nv > 0 always
  const float pv_m1 = expf((k - 2.0f) * ln_v);
  const float base = pl * pv * lit;
  LobeOut<LOBE_MINNAERT> o;
  o.i = kd * base;
  o.dp[0] = base;
  o.dp[1] = kd * base * (ln_l + ln_v);
  o.da[0] = kd * k * pl_m1 * pv * lit;
  o.da[1] = kd * pl * (k - 1.0f) * pv_m1 * lit * step_f(cvn > kEps);
  return o;
}

__device__ __forceinline__ LobeOut<LOBE_OREN_NAYAR> oren_nayar_full(float cl, float cvn,
                                                                    float crv, float kd,
                                                                    float sigma) {
  const float s2 = sigma * sigma;
  const float sa = s2 + 0.33f;
  const float sb = s2 + 0.09f;
  const float a_coef = 1.0f - 0.5f * s2 / sa;
  const float b_coef = 0.45f * s2 / sb;
  const float da_ds = -0.33f * sigma / (sa * sa);
  const float db_ds = 0.081f * sigma / (sb * sb);

  const float live_l = step_f((cl > -1.0f) && (cl < 1.0f));  // clip subgradients
  const float live_v = step_f((cvn > -1.0f) && (cvn < 1.0f));
  const float nl = clamp_f(cl, -1.0f, 1.0f);
  const float nv = clamp_f(cvn, -1.0f, 1.0f);
  const float sin_i = sqrtf(fmaxf(1.0f - nl * nl, 0.0f));
  const float sin_r = sqrtf(fmaxf(1.0f - nv * nv, 0.0f));
  const float dsin_i = -nl / fmaxf(sin_i, kEps) * step_f(sin_i > 0.0f);
  const float dsin_r = -nv / fmaxf(sin_r, kEps) * step_f(sin_r > 0.0f);

  const float lv = 2.0f * cl * cvn - crv;
  const float den_raw = sin_i * sin_r;
  const float den = fmaxf(den_raw, kEps);
  const float live_den = step_f(den_raw > kEps);
  const float num = lv - nl * nv;
  const float cp_raw = num / den;
  const float live_cp = step_f((cp_raw > -1.0f) && (cp_raw < 1.0f));
  const float cp = clamp_f(cp_raw, -1.0f, 1.0f);
  const float cpp = fmaxf(cp, 0.0f);
  const float live_pos = step_f(cp > 0.0f);
  // ∂cp/∂(lv, nl, nv): quotient rule, den's own nl/nv dependence included
  const float dcp_dlv = live_cp / den * live_den;
  const float dcp_dnl = live_cp * (-nv * den - num * dsin_i * sin_r) / (den * den) * live_den;
  const float dcp_dnv = live_cp * (-nl * den - num * sin_i * dsin_r) / (den * den) * live_den;

  const float cos_a = fminf(nl, nv);
  const float cos_b = fmaxf(nl, nv);
  const bool pick_l = nl <= nv;  // nl is the larger-angle branch
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  const float cos_b_s = fmaxf(cos_b, kEps);
  const float sin_b = sqrtf(fmaxf(1.0f - cos_b * cos_b, 0.0f));
  const float tan_b = sin_b / cos_b_s;
  const float s_geo = sin_a * tan_b;
  const float ds_dca = -cos_a / fmaxf(sin_a, kEps) * step_f(sin_a > 0.0f) * tan_b;
  const float ds_dcb = -sin_a / fmaxf(sin_b * cos_b_s * cos_b_s, kEps) * step_f(sin_b > 0.0f) *
                       step_f(cos_b > kEps);
  const float ds_dnl = pick_l ? ds_dca : ds_dcb;
  const float ds_dnv = pick_l ? ds_dcb : ds_dca;

  const float nlp = fmaxf(nl, 0.0f);
  const float live_nlp = step_f(nl > 0.0f) * live_l;
  const float term = a_coef + b_coef * cpp * s_geo;
  const float base = kInvPi * nlp * term;

  const float dterm_dnl = b_coef * (live_pos * dcp_dnl * s_geo + cpp * ds_dnl);
  const float dterm_dnv = b_coef * (live_pos * dcp_dnv * s_geo + cpp * ds_dnv);
  const float dterm_dlv = b_coef * live_pos * dcp_dlv * s_geo;
  LobeOut<LOBE_OREN_NAYAR> o;
  o.i = kd * base;
  o.dp[0] = base;
  o.dp[1] = kd * kInvPi * nlp * (da_ds + db_ds * cpp * s_geo);
  // ∂I/∂cl: through nlp, through nl in (cp, S), and through lv = 2·cl·cvn − crv
  o.da[0] = kd * kInvPi * (live_nlp * term + nlp * (dterm_dnl * live_l + dterm_dlv * 2.0f * cvn));
  o.da[1] = kd * kInvPi * nlp * (dterm_dnv * live_v + dterm_dlv * 2.0f * cl);
  o.da[2] = kd * kInvPi * nlp * dterm_dlv * -1.0f;
  return o;
}

// ang: cos_ln, cos_nh, cos_vn, cos_th, cos_bh; p: kd, ks, alpha_x, alpha_y, phi
// c, s: cos φ and sin φ of p[4] (lobe_point)
__device__ __forceinline__ LobeOut<LOBE_WARD_ANISO> ward_aniso_full(const float* ang,
                                                                    const float* p, float c,
                                                                    float s) {
  const float cl = ang[0], cnh = ang[1], cvn = ang[2], cth = ang[3], cbh = ang[4];
  const float kd = p[0], ks = p[1];
  const float ax = fmaxf(p[2], 1e-3f);
  const float ay = fmaxf(p[3], 1e-3f);
  const float live_ax = step_f(p[2] > 1e-3f);
  const float live_ay = step_f(p[3] > 1e-3f);

  const float nl = fmaxf(cl, 0.0f);
  const float nv = fmaxf(cvn, kEps);
  const bool litb = (cl > 0.0f) && (cnh > 0.0f) && (cvn > 0.0f);
  const float lit = step_f(litb);
  const float nh = fmaxf(litb ? cnh : 1.0f, 1e-4f);

  const float ht = litb ? c * cth + s * cbh : 0.0f;
  const float hb = litb ? -s * cth + c * cbh : 0.0f;

  const float nh2 = nh * nh;
  const float ax2 = ax * ax;
  const float ay2 = ay * ay;
  const float expo = ((ht * ht) / ax2 + (hb * hb) / ay2) / nh2;
  const float lobe = expf(-expo) / (kFourPi * ax * ay);
  const float rt = sqrtf((litb ? nl : 1.0f) / nv);
  const float spec_b = rt * lobe * lit;

  const float common = ks * rt * lobe * lit;
  const float dexpo_dphi = 2.0f * ht * hb * (1.0f / ax2 - 1.0f / ay2) / nh2;
  LobeOut<LOBE_WARD_ANISO> o;
  o.i = kd * kInvPi * nl + ks * spec_b;
  o.dp[0] = kInvPi * nl;
  o.dp[1] = spec_b;
  o.dp[2] = common * (2.0f * ht * ht / (ax2 * ax * nh2) - 1.0f / ax) * live_ax;
  o.dp[3] = common * (2.0f * hb * hb / (ay2 * ay * nh2) - 1.0f / ay) * live_ay;
  o.dp[4] = -ks * rt * lobe * lit * dexpo_dphi;
  o.da[0] = kd * kInvPi * step_f(cl > 0.0f) +
            ks * lobe * lit / (2.0f * sqrtf(fmaxf(nl * nv, kEps))) * step_f(cl > 0.0f);
  // expo = K/nh² with K nh-independent ⇒ dexpo/dnh = −2·expo/nh
  o.da[1] = common * (2.0f * expo / nh) * step_f(cnh > 1e-4f);
  o.da[2] = ks * lobe * lit * (-0.5f) * rt / nv * step_f(cvn > kEps);
  o.da[3] = -ks * rt * lobe * lit * (2.0f * ht * c / ax2 - 2.0f * hb * s / ay2) / nh2;
  o.da[4] = -ks * rt * lobe * lit * (2.0f * ht * s / ax2 + 2.0f * hb * c / ay2) / nh2;
  return o;
}

// ang: cos_ln, cos_nh, cos_vn, cos_th, cos_bh, cos_tl, cos_bl, cos_tv, cos_bv;
// p: kd, ks, rough_x, rough_y, phi
// c, s: cos φ and sin φ of p[4] (lobe_point)
__device__ __forceinline__ LobeOut<LOBE_COOK_TORRANCE_ANISO> cook_torrance_aniso_full(
    const float* ang, const float* p, float c, float s) {
  const float cl = ang[0], cnh = ang[1], cvn = ang[2];
  const float kd = p[0], ks = p[1];
  const float rx = fmaxf(p[2], 1e-3f);
  const float ry = fmaxf(p[3], 1e-3f);
  const float a = rx * rx;  // α_x (Disney remap)
  const float b = ry * ry;
  const float live_rx = step_f(p[2] > 1e-3f);
  const float live_ry = step_f(p[3] > 1e-3f);

  const bool litb = (cl > 0.0f) && (cvn > 0.0f) && (cnh > 0.0f);
  const float lit = step_f(litb);
  const float nl = fmaxf(cl, 0.0f);
  const float nv = litb ? fmaxf(cvn, kEps) : 1.0f;
  const float nh = litb ? cnh : 1.0f;
  const float nl_s = litb ? nl : 1.0f;

  const float ht = litb ? c * ang[3] + s * ang[4] : 0.0f;
  const float hb = litb ? -s * ang[3] + c * ang[4] : 0.0f;
  const float lt = litb ? c * ang[5] + s * ang[6] : 0.0f;
  const float lb = litb ? -s * ang[5] + c * ang[6] : 0.0f;
  const float vt = litb ? c * ang[7] + s * ang[8] : 0.0f;
  const float vb = litb ? -s * ang[7] + c * ang[8] : 0.0f;

  // anisotropic GGX NDF  D = 1/max(π a b u², eps)
  const float hta = ht / a;
  const float hbb = hb / b;
  const float u = hta * hta + hbb * hbb + nh * nh;
  const float du_raw = kPi * a * b * u * u;
  const float live_d = step_f(du_raw > kEps);
  const float d = 1.0f / fmaxf(du_raw, kEps);
  const float u_s = fmaxf(u, kEps);
  const float dd_da = d * ((1.0f / a) * -1.0f + 4.0f * ht * ht / (u_s * a * a * a)) * live_d;
  const float dd_db = d * ((1.0f / b) * -1.0f + 4.0f * hb * hb / (u_s * b * b * b)) * live_d;
  const float dd_dht = -4.0f * d * ht / (u_s * a * a) * live_d;
  const float dd_dhb = -4.0f * d * hb / (u_s * b * b) * live_d;
  const float dd_dnh = -4.0f * d * nh / u_s * live_d;

  // height-correlated anisotropic Smith visibility
  const float avt = a * vt, bvb = b * vb;
  const float alt = a * lt, blb = b * lb;
  const float sv = sqrtf(avt * avt + bvb * bvb + nv * nv);
  const float sl = sqrtf(alt * alt + blb * blb + nl_s * nl_s);
  const float den_raw = nl * sv + nv * sl;
  const float live_v = step_f(den_raw > kEps);
  const float den = fmaxf(den_raw, kEps);
  const float vis = (1.0f / den) * 0.5f;
  const float dvis = (1.0f / (den * den)) * -0.5f * live_v;  // × dden/dX
  const float sv_s = fmaxf(sv, kEps);
  const float sl_s = fmaxf(sl, kEps);
  const float dden_da = nl * a * vt * vt / sv_s + nv * a * lt * lt / sl_s;
  const float dden_db = nl * b * vb * vb / sv_s + nv * b * lb * lb / sl_s;
  const float dden_dnl = sv + nv * nl_s / sl_s;
  const float dden_dnv = nl * nv / sv_s + sl;
  const float dden_dvt = nl * a * a * vt / sv_s;
  const float dden_dvb = nl * b * b * vb / sv_s;
  const float dden_dlt = nv * a * a * lt / sl_s;
  const float dden_dlb = nv * b * b * lb / sl_s;

  const float s_core = d * vis * nl;  // spec / ks
  const float dden_dphi = dden_dvt * vb - dden_dvb * vt + dden_dlt * lb - dden_dlb * lt;
  const float pos_l = step_f(cl > 0.0f);
  LobeOut<LOBE_COOK_TORRANCE_ANISO> o;
  o.i = kd * kInvPi * nl + ks * s_core * lit;
  o.dp[0] = kInvPi * nl;
  o.dp[1] = s_core * lit;
  o.dp[2] = ks * nl * (dd_da * vis + d * dvis * dden_da) * lit * 2.0f * rx * live_rx;
  o.dp[3] = ks * nl * (dd_db * vis + d * dvis * dden_db) * lit * 2.0f * ry * live_ry;
  o.dp[4] = ks * nl * ((dd_dht * hb - dd_dhb * ht) * vis + d * dvis * dden_dphi) * lit;
  o.da[0] = kd * kInvPi * pos_l + ks * lit * pos_l * (d * vis + d * nl * dvis * dden_dnl);
  o.da[1] = ks * lit * dd_dnh * vis * nl;
  o.da[2] = ks * lit * d * nl * dvis * dden_dnv * step_f(cvn > kEps);
  o.da[3] = ks * lit * nl * vis * (dd_dht * c - dd_dhb * s);
  o.da[4] = ks * lit * nl * vis * (dd_dht * s + dd_dhb * c);
  o.da[5] = ks * lit * nl * d * dvis * (dden_dlt * c - dden_dlb * s);
  o.da[6] = ks * lit * nl * d * dvis * (dden_dlt * s + dden_dlb * c);
  o.da[7] = ks * lit * nl * d * dvis * (dden_dvt * c - dden_dvb * s);
  o.da[8] = ks * lit * nl * d * dvis * (dden_dvt * s + dden_dvb * c);
  return o;
}

// What a lobe computes from its parameters alone, once per parameter point:
// cos φ and sin φ of the anisotropic lobes (zero for the others). A kernel that
// evaluates many views at one point computes it once and passes it to
// lobe_full; the values are those the lobe would compute itself.
struct LobePoint {
  float cos_phi, sin_phi;
};

template <int L>
__device__ __forceinline__ LobePoint lobe_point(const float* p) {
  if constexpr (L == LOBE_WARD_ANISO || L == LOBE_COOK_TORRANCE_ANISO) {
    return LobePoint{cosf(p[4]), sinf(p[4])};
  } else {
    return LobePoint{0.0f, 0.0f};
  }
}

// One lobe by its compile-time selector; ang holds LobeTraits<L>::n_angles
// channels and p LobeTraits<L>::n_params parameters, pt = lobe_point<L>(p).
template <int L>
__device__ __forceinline__ LobeOut<L> lobe_full(const float* ang, const float* p,
                                                const LobePoint& pt) {
  if constexpr (L == LOBE_BLINN_PHONG) {
    return blinn_phong_full(ang[0], ang[1], p[0], p[1], p[2]);
  } else if constexpr (L == LOBE_PHONG) {
    return phong_full(ang[0], ang[1], p[0], p[1], p[2]);
  } else if constexpr (L == LOBE_COOK_TORRANCE) {
    return cook_torrance_full(ang[0], ang[1], ang[2], p[0], p[1], p[2]);
  } else if constexpr (L == LOBE_WARD) {
    return ward_full(ang[0], ang[1], ang[2], p[0], p[1], p[2]);
  } else if constexpr (L == LOBE_COOK_TORRANCE_FRESNEL) {
    return cook_torrance_fresnel_full(ang[0], ang[1], ang[2], ang[3], p[0], p[1], p[2], p[3]);
  } else if constexpr (L == LOBE_LAMBERT) {
    return lambert_full(ang[0], p[0]);
  } else if constexpr (L == LOBE_MINNAERT) {
    return minnaert_full(ang[0], ang[1], p[0], p[1]);
  } else if constexpr (L == LOBE_OREN_NAYAR) {
    return oren_nayar_full(ang[0], ang[1], ang[2], p[0], p[1]);
  } else if constexpr (L == LOBE_WARD_ANISO) {
    return ward_aniso_full(ang, p, pt.cos_phi, pt.sin_phi);
  } else {
    static_assert(L == LOBE_COOK_TORRANCE_ANISO, "unknown lobe");
    return cook_torrance_aniso_full(ang, p, pt.cos_phi, pt.sin_phi);
  }
}

template <int L>
__device__ __forceinline__ LobeOut<L> lobe_full(const float* ang, const float* p) {
  return lobe_full<L>(ang, p, lobe_point<L>(p));
}

// The three-parameter form the separable solvers call.
template <int L>
__device__ __forceinline__ LobeOut<L> lobe_full(const float* ang, float kd, float ks,
                                                float shape) {
  static_assert(LobeTraits<L>::n_params == 3, "a (kd, ks, shape) lobe");
  const float p[3] = {kd, ks, shape};
  return lobe_full<L>(ang, p);
}

}  // namespace brdf

// switch over every lobe id: runs the statement with kLobe bound to the id as
// a compile-time constant (falls out of the switch for an unknown id).
#define BRDF_LOBE_CASE(ID, ...) \
  case ID: {                    \
    constexpr int kLobe = ID;   \
    __VA_ARGS__;                \
  } break;
#define BRDF_DISPATCH_LOBE(lobe, ...)                                   \
  switch (lobe) {                                                       \
    BRDF_LOBE_CASE(brdf::LOBE_BLINN_PHONG, __VA_ARGS__)                 \
    BRDF_LOBE_CASE(brdf::LOBE_PHONG, __VA_ARGS__)                       \
    BRDF_LOBE_CASE(brdf::LOBE_COOK_TORRANCE, __VA_ARGS__)               \
    BRDF_LOBE_CASE(brdf::LOBE_WARD, __VA_ARGS__)                        \
    BRDF_LOBE_CASE(brdf::LOBE_COOK_TORRANCE_FRESNEL, __VA_ARGS__)       \
    BRDF_LOBE_CASE(brdf::LOBE_LAMBERT, __VA_ARGS__)                     \
    BRDF_LOBE_CASE(brdf::LOBE_MINNAERT, __VA_ARGS__)                    \
    BRDF_LOBE_CASE(brdf::LOBE_OREN_NAYAR, __VA_ARGS__)                  \
    BRDF_LOBE_CASE(brdf::LOBE_WARD_ANISO, __VA_ARGS__)                  \
    BRDF_LOBE_CASE(brdf::LOBE_COOK_TORRANCE_ANISO, __VA_ARGS__)         \
    default: break;                                                     \
  }
