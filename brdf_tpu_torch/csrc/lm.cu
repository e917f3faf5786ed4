// Fused box-constrained Levenberg-Marquardt fit, one thread per texel (kernel K5).
//
// Replaces brdf_tpu/ops/lm_pallas.py::_lm_kernel (launched there by
// lm_fit_pallas). It computes what that kernel computes, for any of the ten
// lobes and m = 1..5 parameters: per texel, the whole box-projected LM solve —
// model and analytic Jacobian over the views, upper-triangular JᵀJ and Jᵀr,
// projected-gradient norm, Kanzow μ initialisation when no warm μ came in,
// active-set freeze of bound-stuck coordinates, additive or Marquardt damping,
// the closed-form damped solve (scalar, 2×2 and 3×3 Cramer, unrolled Cholesky
// for m = 4, 5), box projection, trial χ², predicted reduction on the unfrozen
// system, Nielsen's μ/ν control and the levmar stop codes, with the warm
// (μ, ν, stop) resume rows of the start array.
//
// Designed for this card, not carried over from the TPU block: there a block
// of 1024 lanes iterates until its slowest lane stops and packs its carry into
// one (16, TB) array. Here each thread keeps its lane's solver state in
// registers and leaves the loop when its own lane stops; the results are the
// same because a stopped lane only ever kept its state. T is bound-checked,
// never padded.
//
// What bounds it on an H100: operations, not bytes. A texel reads (A+2)·V
// floats once and then evaluates its lobe 2·V times per iteration (Jacobian
// pass and trial χ² pass), each evaluation dozens of FP32 operations with
// expf/logf/sqrtf/sinf/cosf and divides. So a block stages its texels' angles,
// targets and weights in shared memory once (layout [channel][view][texel]:
// the 32 threads of a warp touch 32 consecutive words, coalesced loads and no
// bank conflicts) and iterates from shared memory and registers with no
// further device-memory traffic until the 16 output rows. Each thread reads
// only its own texel's column, so the kernel needs no barrier. The staged
// inputs are (A+2)·V·4 bytes a texel (704 B at V=16 for the nine-channel lobe,
// 90 KB a 128-thread block), above the 48 KB static limit, hence the dynamic
// shared-memory opt-in.
//
// Rounding follows lobes.cuh's rules, so the kernel can be held against
// ops/lm.py::lm_rows_plain lane for lane: view sums run left to right from 0,
// the sums over parameters run in the order of the Pallas kernel's Python
// sums, tmp³ is two multiplies, 1/3 is a float constant.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "lobes.cuh"

namespace {

constexpr int kMaxParams = 5;
constexpr float kTiny = 1e-30f;
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// levmar stop codes (solver/lm.py::StopReason), stored as floats
constexpr float kStopSmallGradient = 1.0f;
constexpr float kStopSmallDp = 2.0f;
constexpr float kStopMaxIterations = 3.0f;
constexpr float kStopSingular = 4.0f;
constexpr float kStopNoReduction = 5.0f;
constexpr float kStopSmallChi2 = 6.0f;
constexpr float kStopInvalid = 7.0f;

struct LmArgs {
  float lb[kMaxParams], ub[kMaxParams];
  float eps1, eps2_sq, eps3, mu_max, half_mu_max, tau;
  float itmax;    // iterations are counted as floats, as the output row stores them
  int marquardt;  // 0: JᵀJ + μI, 1: JᵀJ + μ·diag(JᵀJ)
};

// torch.maximum / torch.clamp propagate NaN; fmaxf and fminf drop it
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Closed-form symmetric solve dp = −Af⁻¹ gf; af[j][k] is read for j ≤ k only.
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

template <int L>
__global__ void __launch_bounds__(128)
lm_kernel(const float* __restrict__ ang,  // (A, V, T)
          const float* __restrict__ y,    // (V, T)
          const float* __restrict__ w,    // (V, T)
          const float* __restrict__ p0,   // (8, T): rows 0..m-1 start, 5/6/7 warm (μ, ν, stop)
          float* __restrict__ out,        // (16, T)
          int T, int V, LmArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const long t = static_cast<long>(blockIdx.x) * tb + tid;
  if (t >= T) return;  // ragged edge: masked, never written

  // [channel][view][texel]; each thread owns one texel column
  float* s_ang = smem;               // A·V·tb
  float* s_y = s_ang + A * V * tb;   // V·tb
  float* s_w = s_y + V * tb;         // V·tb
  for (int v = 0; v < V; ++v) {
    const long g = static_cast<long>(v) * T + t;
    const int sv = v * tb + tid;
#pragma unroll
    for (int a = 0; a < A; ++a) s_ang[a * V * tb + sv] = ang[static_cast<long>(a) * V * T + g];
    s_y[sv] = y[g];
    s_w[sv] = w[g];
  }

  float av[A];
  auto load_angles = [&](int v) {
#pragma unroll
    for (int a = 0; a < A; ++a) av[a] = s_ang[a * V * tb + v * tb + tid];
  };
  auto chi2_of = [&](const float (&q)[M]) {
    float c = 0.0f;
    for (int v = 0; v < V; ++v) {
      load_angles(v);
      const int sv = v * tb + tid;
      const float r = (brdf::lobe_full<L>(av, q).i - s_y[sv]) * s_w[sv];
      c += r * r;
    }
    return c;
  };

  float p[M];
#pragma unroll
  for (int j = 0; j < M; ++j) p[j] = clip_nan(p0[static_cast<long>(j) * T + t], s.lb[j], s.ub[j]);
  float chi2 = chi2_of(p);

  // warm rows: μ ≤ 0 or non-finite → Kanzow init at iteration 0; ν < 2 or
  // non-finite → 2; a non-zero stop is final and short-circuits the lane
  float mu = p0[5L * T + t];
  mu = (isfinite(mu) && mu > 0.0f) ? mu : 0.0f;
  float nu = p0[6L * T + t];
  nu = (isfinite(nu) && nu >= 2.0f) ? nu : 2.0f;
  const float stop_w = p0[7L * T + t];
  float stop = stop_w != 0.0f ? stop_w : (isfinite(chi2) ? 0.0f : kStopInvalid);
  float it = 0.0f;
  float g_inf = 3.4e38f;

  while (stop == 0.0f && it < s.itmax) {
    // normal equations over the views (weights fold in once via w²)
    float a[M][M], g[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      g[j] = 0.0f;
#pragma unroll
      for (int k = j; k < M; ++k) a[j][k] = 0.0f;
    }
    for (int v = 0; v < V; ++v) {
      load_angles(v);
      const int sv = v * tb + tid;
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
      const float wv = s_w[sv];
      const float w2 = wv * wv;
      const float r = (o.i - s_y[sv]) * wv;
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int k = j; k < M; ++k) a[j][k] += o.dp[j] * o.dp[k] * w2;
        g[j] += o.dp[j] * r * wv;
      }
    }

    // projected-gradient convergence measure
    float gi = 0.0f, max_diag = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float pg = fabsf(p[j] - clip_nan(p[j] - g[j], s.lb[j], s.ub[j]));
      gi = j == 0 ? pg : max_nan(gi, pg);
      max_diag = j == 0 ? a[0][0] : max_nan(max_diag, a[j][j]);
    }
    const bool grad_conv = gi <= s.eps1;

    // Kanzow μ init only when no (warm) μ was carried in; Marquardt damping
    // is dimensionless and starts at τ directly
    const float mu_it =
        (it == 0.0f && mu <= 0.0f) ? (s.marquardt ? s.tau : s.tau * max_diag) : mu;

    // active-set freeze of bound-stuck coordinates
    float af[M][M], gf[M], fr[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const bool frozen = ((p[j] <= s.lb[j]) && (g[j] > 0.0f)) || ((p[j] >= s.ub[j]) && (g[j] < 0.0f));
      fr[j] = frozen ? 0.0f : 1.0f;
      // μ·(a_jj + ε·maxdiag): the floor keeps the damped system SPD for
      // zero-information columns
      const float damp = s.marquardt ? mu_it * (a[j][j] + 1e-8f * max_diag + kTiny) : mu_it;
      af[j][j] = frozen ? 1.0f : a[j][j] + damp;
      gf[j] = g[j] * fr[j];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int k = j + 1; k < M; ++k) af[j][k] = a[j][k] * fr[j] * fr[k];
    }

    float dp[M];
    const bool solver_ok = solve_damped<M>(af, gf, dp);

    float pn[M], dpa[M];
    float dp_nrm2 = 0.0f, p_nrm2 = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      pn[j] = clip_nan(p[j] + dp[j], s.lb[j], s.ub[j]);
      dpa[j] = pn[j] - p[j];  // the projected step
      dp_nrm2 += dpa[j] * dpa[j];
      p_nrm2 += p[j] * p[j];
    }
    const bool small_dp = dp_nrm2 <= s.eps2_sq * p_nrm2;

    const float chi2_new = chi2_of(pn);
    const bool finite = isfinite(chi2_new);
    const float df = chi2 - chi2_new;

    // predicted reduction −(2 gᵀδ + δᵀ JᵀJ δ) with the unfrozen system
    float g_dot = 0.0f, q_dot = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < M; ++k) q += (j <= k ? a[j][k] : a[k][j]) * dpa[k];
      g_dot += g[j] * dpa[j];
      q_dot += dpa[j] * q;
    }
    const float dl = -(2.0f * g_dot + q_dot);

    const bool accept = solver_ok && finite && (df > 0.0f);
    const float rho = dl > 0.0f ? df / fmaxf(dl, kTiny) : 1.0f;
    const float tmp = 2.0f * rho - 1.0f;
    const float mu_next = accept ? mu_it * fmaxf(kThird, 1.0f - tmp * tmp * tmp) : mu_it * nu;
    const float nu_next = accept ? 2.0f : nu * 2.0f;

    // stop codes: later assignments win (convergence over failure)
    float st = 0.0f;
    if (mu_next > s.mu_max) st = kStopNoReduction;
    if (!solver_ok && mu_it > s.half_mu_max) st = kStopSingular;
    if (small_dp && solver_ok) st = kStopSmallDp;
    const float chi2_sel = accept ? chi2_new : chi2;
    if (chi2_sel <= s.eps3) st = kStopSmallChi2;
    if (grad_conv) st = kStopSmallGradient;

    if (accept) {
#pragma unroll
      for (int j = 0; j < M; ++j) p[j] = pn[j];
    }
    chi2 = chi2_sel;
    mu = mu_next;
    nu = nu_next;
    it += 1.0f;
    stop = st;
    g_inf = gi;
  }

#pragma unroll
  for (int j = 0; j < M; ++j) out[static_cast<long>(j) * T + t] = p[j];
#pragma unroll
  for (int j = M; j < kMaxParams; ++j) out[static_cast<long>(j) * T + t] = 0.0f;
  out[5L * T + t] = chi2;
  out[6L * T + t] = it;
  out[7L * T + t] = stop == 0.0f ? kStopMaxIterations : stop;
  out[8L * T + t] = g_inf;
  out[9L * T + t] = mu;
  out[10L * T + t] = nu;
#pragma unroll
  for (int j = 11; j < 16; ++j) out[static_cast<long>(j) * T + t] = 0.0f;
}

template <int L>
int launch(const float* ang, const float* y, const float* w, const float* p0, float* out,
           int T, int V, int block_t, int smem_bytes, const LmArgs& s, cudaStream_t stream) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  if (smem_bytes != (A + 2) * V * block_t * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(lm_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + block_t - 1) / block_t;
  lm_kernel<L><<<blocks, block_t, smem_bytes, stream>>>(ang, y, w, p0, out, T, V, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lower/upper hold n_params floats (host memory); eps2_sq, half_mu_max come
// from the wrapper so that both versions use the same float32 constants.
extern "C" int brdf_lm_fit(int lobe, const float* ang, const float* y, const float* w,
                           const float* p0, float* out, int T, int V, int block_t,
                           int smem_bytes, const float* lower, const float* upper, int n_params,
                           float eps1, float eps2_sq, float eps3, float mu_max,
                           float half_mu_max, float tau, int itmax, int marquardt,
                           void* stream) {
  if (n_params < 1 || n_params > kMaxParams || block_t < 32 || block_t > 128 || block_t % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  LmArgs s;
  for (int j = 0; j < kMaxParams; ++j) {
    s.lb[j] = j < n_params ? lower[j] : 0.0f;
    s.ub[j] = j < n_params ? upper[j] : 0.0f;
  }
  s.eps1 = eps1;
  s.eps2_sq = eps2_sq;
  s.eps3 = eps3;
  s.mu_max = mu_max;
  s.half_mu_max = half_mu_max;
  s.tau = tau;
  s.itmax = static_cast<float>(itmax);
  s.marquardt = marquardt;
  auto st = static_cast<cudaStream_t>(stream);
  BRDF_DISPATCH_LOBE(
      lobe,
      if (brdf::LobeTraits<kLobe>::n_params != n_params)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<kLobe>(ang, y, w, p0, out, T, V, block_t, smem_bytes, s, st))
  return static_cast<int>(cudaErrorInvalidValue);
}
