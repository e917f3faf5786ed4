// Normal equations of the joint normal-map fit (m = 9) over the view axis:
// kernel K7.
//
// Replaces brdf_tpu/ops/lm_pallas.py::_joint_ne_kernel (launched there by
// _joint_ne_call, behind lm_fit_joint_pallas_chunked and
// joint_value_and_grad_pallas). The joint model fits, per texel,
//   p = [kd_r, kd_g, kd_b, ks_r, ks_g, ks_b, shape, nu, nv]
// against 3 V measurements; the shading normal is n' = normalize(n + nu t + nv b)
// in the texel's tangent frame (n, t, b), so the cosines the base lobe reads
// depend on the parameters. The kernel takes the raw unit vectors to the light
// and to the eye per (view, texel), recomputes n', the cosines and their
// (nu, nv) partials, evaluates the base lobe once per channel with
// (p[c], p[3 + c], p[6]), chains dI/dangles into the two offset columns and
// accumulates over the views, in three modes:
//
//   chi2   row 0:             chi2 = sum_{v, c} (w_c (I_c - y_c))^2
//   grad   rows 0, 1..9:      chi2, then g = J^T W^2 e
//   full   rows 0, 1..45, ..: chi2, the 45 upper-triangle entries of J^T W^2 J
//                             in (j, k) order, j <= k, then the 9 rows of g
//
// Channel c touches the columns {c, 3 + c, 6, 7, 8} only, so 12 of the 45
// entries are structurally zero: they are never summed and are written as 0.
// Inputs are views-major: lv (6, V, T) = L then V components, y and the
// per-channel weights w (3, V, T), parameters (9, T), frame (9, T) = n, t, b;
// the output is (R, T), R = 1, 10 or 55. Base lobes: the four with
// (kd, ks, shape) parameters (blinn_phong, phong, cook_torrance, ward).
//
// Designed for this card as K6 is (csrc/ne.cu): one thread per texel walks all
// views with coalesced loads and keeps its sums in registers, so there are no
// view chunks, no texel blocks, no padded rows and no accumulator that is
// revisited. In full mode a thread holds 1 + 33 + 9 sums beside the frame's
// derived values; the assembler's register and spill counts are in PERF.md.
//
// What bounds it on an H100: bytes by count (12 floats read a pair; the three
// lobe evaluations with all their partials come to about half the byte time
// for cook_torrance), but its parallelism is T threads, and in grad and full
// mode it runs at under a third of the byte bound. Sums run left to right from
// zero, views outside and channels inside, with no atomics and no FMA
// contraction, and every normalisation is 1 / sqrtf(max(., eps)), so the
// kernel can be held to equality with ops/ne.py::joint_ne_rows_plain.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "lobes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kModeChi2 = 0, kModeGrad = 1, kModeFull = 2;
constexpr int kM = 9;
constexpr int kPairs = kM * (kM + 1) / 2;

// torch.clamp propagates NaN; fmaxf drops it
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(const float (&x)[3], const float (&z)[3]) {
  return x[0] * z[0] + x[1] * z[1] + x[2] * z[2];
}

// row of the (j, k) entry, j <= k, among the 45
__host__ __device__ constexpr int pair_index(int j, int k) {
  return j * kM - j * (j - 1) / 2 + (k - j);
}

template <int L, int MODE>
__global__ void __launch_bounds__(kThreads)
joint_ne_kernel(const float* __restrict__ lv,      // (6, V, T)
                const float* __restrict__ y,       // (3, V, T)
                const float* __restrict__ w,       // (3, V, T)
                const float* __restrict__ params,  // (9, T)
                const float* __restrict__ frame,   // (9, T)
                float* __restrict__ out,           // (R, T)
                int T, int V) {
  static_assert(brdf::LobeTraits<L>::n_params == 3, "a (kd, ks, shape) base lobe");
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr bool kNeedsH = L != brdf::LOBE_PHONG;
  constexpr bool kNeedsVn = L != brdf::LOBE_BLINN_PHONG;
  const long n = static_cast<long>(V) * T;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;

  float p[kM], nrm[3], tb[3], bb[3];
#pragma unroll
  for (int j = 0; j < kM; ++j) p[j] = params[static_cast<long>(j) * T + t];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nrm[i] = frame[static_cast<long>(i) * T + t];
    tb[i] = frame[static_cast<long>(3 + i) * T + t];
    bb[i] = frame[static_cast<long>(6 + i) * T + t];
  }

  // perturbed unit normal and its offset partials:
  // n' = u / |u|, u = n + nu t + nv b;  dn'/dnu = (t - n' (n'.t)) / |u|
  float u[3], npn[3], dn_du[3], dn_dv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = nrm[i] + p[7] * tb[i] + p[8] * bb[i];
  const float inv_ell = 1.0f / sqrtf(max_nan(dot3(u, u), brdf::kEps));
#pragma unroll
  for (int i = 0; i < 3; ++i) npn[i] = u[i] * inv_ell;
  const float ndt = dot3(npn, tb);
  const float ndb = dot3(npn, bb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dn_du[i] = (tb[i] - npn[i] * ndt) * inv_ell;
    dn_dv[i] = (bb[i] - npn[i] * ndb) * inv_ell;
  }

  float chi2 = 0.0f;
  float a_acc[kPairs], g_acc[kM];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) a_acc[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < kM; ++j) g_acc[j] = 0.0f;

  for (int v = 0; v < V; ++v) {
    const long idx = static_cast<long>(v) * T + t;
    float ell[3], eye[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ell[i] = lv[i * n + idx];
      eye[i] = lv[(3 + i) * n + idx];
    }

    // the cosines the lobe reads, and their (nu, nv) partials
    float ang[A], ang_du[A], ang_dv[A];
    const float cl = dot3(ell, npn);
    const float cl_du = dot3(ell, dn_du), cl_dv = dot3(ell, dn_dv);
    ang[0] = cl;
    ang_du[0] = cl_du;
    ang_dv[0] = cl_dv;
    float cvn = 0.0f, cvn_du = 0.0f, cvn_dv = 0.0f;
    if constexpr (kNeedsVn) {
      cvn = dot3(eye, npn);
      cvn_du = dot3(eye, dn_du);
      cvn_dv = dot3(eye, dn_dv);
    }
    if constexpr (kNeedsH) {
      float s[3], h[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] = ell[i] + eye[i];
      const float inv_s = 1.0f / sqrtf(max_nan(dot3(s, s), brdf::kEps));
#pragma unroll
      for (int i = 0; i < 3; ++i) h[i] = s[i] * inv_s;
      ang[1] = dot3(h, npn);
      ang_du[1] = dot3(h, dn_du);
      ang_dv[1] = dot3(h, dn_dv);
      if constexpr (A == 3) {
        ang[2] = cvn;
        ang_du[2] = cvn_du;
        ang_dv[2] = cvn_dv;
      }
    } else {
      // phong: R.V = 2 (N.L)(N.V) - L.V, and L.V does not depend on the normal
      const float lvdot = dot3(ell, eye);
      ang[1] = 2.0f * cl * cvn - lvdot;
      ang_du[1] = 2.0f * (cl_du * cvn + cl * cvn_du);
      ang_dv[1] = 2.0f * (cl_dv * cvn + cl * cvn_dv);
    }

#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(ang, p[c], p[3 + c], p[6]);
      const float wc = w[c * n + idx];
      const float r = (o.i - y[c * n + idx]) * wc;
      chi2 = chi2 + r * r;
      if constexpr (MODE != kModeChi2) {
        float d_nu = o.da[0] * ang_du[0];
        float d_nv = o.da[0] * ang_dv[0];
#pragma unroll
        for (int a = 1; a < A; ++a) {
          d_nu = d_nu + o.da[a] * ang_du[a];
          d_nv = d_nv + o.da[a] * ang_dv[a];
        }
        const float col[5] = {o.dp[0], o.dp[1], o.dp[2], d_nu, d_nv};
        const int ids[5] = {c, 3 + c, 6, 7, 8};
        const float rw = r * wc;
#pragma unroll
        for (int a = 0; a < 5; ++a) g_acc[ids[a]] = g_acc[ids[a]] + col[a] * rw;
        if constexpr (MODE == kModeFull) {
          const float w2 = wc * wc;
#pragma unroll
          for (int a = 0; a < 5; ++a) {
#pragma unroll
            for (int b = a; b < 5; ++b) {
              const int i = pair_index(ids[a], ids[b]);
              a_acc[i] = a_acc[i] + col[a] * col[b] * w2;
            }
          }
        }
      }
    }
  }

  out[t] = chi2;
  long row = 1;
  if constexpr (MODE == kModeFull) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) out[(row + i) * T + t] = a_acc[i];
    row += kPairs;
  }
  if constexpr (MODE != kModeChi2) {
#pragma unroll
    for (int j = 0; j < kM; ++j) out[(row + j) * T + t] = g_acc[j];
  }
}

template <int L>
int launch_mode(int mode, const float* lv, const float* y, const float* w, const float* params,
                const float* frame, float* out, int T, int V, cudaStream_t st) {
  const int blocks = static_cast<int>((static_cast<long>(T) + kThreads - 1) / kThreads);
  switch (mode) {
    case kModeChi2:
      joint_ne_kernel<L, kModeChi2><<<blocks, kThreads, 0, st>>>(lv, y, w, params, frame, out, T, V);
      break;
    case kModeGrad:
      joint_ne_kernel<L, kModeGrad><<<blocks, kThreads, 0, st>>>(lv, y, w, params, frame, out, T, V);
      break;
    case kModeFull:
      joint_ne_kernel<L, kModeFull><<<blocks, kThreads, 0, st>>>(lv, y, w, params, frame, out, T, V);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 chi2, 1 grad, 2 full; lobe: one of the four (kd, ks, shape) lobes.
extern "C" int brdf_joint_ne_rows(int lobe, int mode, const float* lv, const float* y,
                                  const float* w, const float* params, const float* frame,
                                  float* out, int T, int V, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (lobe) {
    case brdf::LOBE_BLINN_PHONG:
      return launch_mode<brdf::LOBE_BLINN_PHONG>(mode, lv, y, w, params, frame, out, T, V, st);
    case brdf::LOBE_PHONG:
      return launch_mode<brdf::LOBE_PHONG>(mode, lv, y, w, params, frame, out, T, V, st);
    case brdf::LOBE_COOK_TORRANCE:
      return launch_mode<brdf::LOBE_COOK_TORRANCE>(mode, lv, y, w, params, frame, out, T, V, st);
    case brdf::LOBE_WARD:
      return launch_mode<brdf::LOBE_WARD>(mode, lv, y, w, params, frame, out, T, V, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
