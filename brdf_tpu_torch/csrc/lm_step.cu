// The eager LM loop's step (ops/ne.py::chunked_lm_loop), in two kernels a
// pass around the two row evaluations (K6 or K7):
//
//   rows("full", p) → lm_step_propose_kernel → rows("chi2", pn) → lm_step_accept_kernel
//
// Replaces no TPU kernel. The JAX package's chunked loop
// (brdf_tpu/ops/lm_pallas.py::_chunked_lm_loop) is one XLA program whose
// elementwise step XLA fuses; the port ran that step as eager PyTorch on (T,)
// lanes, some 1190 launches a pass at m = 9, each a few µs of host time for a
// few µs of device work. Here it is two launches, one thread a lane, the
// lane's state in registers.
//
// - lm_step_propose_kernel<M> reads the full rows at p (χ², the packed upper
//   triangle of JᵀJ, Jᵀe), p, μ and the iteration, and computes the
//   projected-gradient norm gi, the Kanzow μ when no (warm) μ came in, the
//   active-set freeze, the damped system, the solve (damped_solve.cuh, K5's),
//   the box projection pn, the small-step test and the predicted reduction
//   from the projected step. It writes pn and a scratch of six rows: μ_it, gi,
//   the predicted reduction and the flags solver_ok, small_dp, grad_conv (as
//   0/1). Its first thread zeroes the active count.
// - lm_step_accept_kernel<M> reads χ² at pn, the scratch and the lane's
//   state (χ², μ, ν, iteration, stop code, g_inf), and computes the accept, ρ,
//   Nielsen's μ/ν and the stop codes, later assignments winning; a lane that
//   was active takes the update, in place in p and the state. It counts the
//   lanes still active into one int: a ballot a warp, one atomic a warp.
//
// What bounds them: bytes, and at the joint fit's few thousand lanes the
// launch itself. A lane reads (R + 2M + 2) floats and writes M + 6 in the
// proposal (R = 1 + M(M+1)/2 + M rows), reads 2M + 13 and writes at most
// M + 6 in the accept; the m = 9 Cholesky is some 400 operations a lane.
//
// Rounding follows lobes.cuh's rules (-fmad=false; clip_nan/max_nan for
// torch.clamp/torch.maximum), so the kernels equal their plain versions
// ops/ne.py::lm_step_propose_plain and lm_step_accept_plain lane for lane:
// every sum over parameters starts at 0 and adds left to right, a product of
// three runs left to right ((a·free_j)·free_k, (tmp·tmp)·tmp), 1/3 and the
// stop codes are float constants.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). A
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entries return cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "bvls2.cuh"
#include "damped_solve.cuh"
#include "lanegroup.cuh"

namespace {

constexpr int kMaxStep = 9;     // the joint normal-map model; K6's lobes take 1..5
constexpr int kThreads = 128;
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// levmar stop codes (solver/lm.py::StopReason), stored as floats
constexpr float kStopSmallGradient = 1.0f;
constexpr float kStopSmallDp = 2.0f;
constexpr float kStopSingular = 4.0f;
constexpr float kStopNoReduction = 5.0f;
constexpr float kStopSmallChi2 = 6.0f;

// rows of the lane state (6, T) and of the scratch (6, T): ops/ne.py's
// STATE_ROWS and SCRATCH_ROWS
constexpr int kChi2 = 0, kMu = 1, kNu = 2, kIt = 3, kStop = 4, kGinf = 5;
constexpr int kMuIt = 0, kGi = 1, kDl = 2, kOk = 3, kSmallDp = 4, kGradConv = 5;

using brdf::clip_nan;
using brdf::kTiny;
using brdf::max_nan;

struct StepArgs {
  float lb[kMaxStep], ub[kMaxStep];
  float eps1, eps2_sq, eps3, mu_max, half_mu_max, tau;
  float itmax;  // iterations are counted as floats, as the state row stores them
};

template <int M>
__global__ void __launch_bounds__(kThreads)
lm_step_propose_kernel(const float* __restrict__ full,   // (R, T): χ², JᵀJ upper, Jᵀe
                       const float* __restrict__ p_in,   // (M, T)
                       const float* __restrict__ state,  // (6, T)
                       float* __restrict__ pn_out,       // (M, T)
                       float* __restrict__ scratch,      // (6, T)
                       int* __restrict__ active, int T, StepArgs s) {
  constexpr int NJ = M * (M + 1) / 2;
  if (blockIdx.x == 0 && threadIdx.x == 0) *active = 0;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;

  float a[M][M], g[M], p[M];
  {
    int n = 1;
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int k = j; k < M; ++k) a[j][k] = full[(n++) * static_cast<long>(T) + t];
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    g[j] = full[(1L + NJ + j) * T + t];
    p[j] = p_in[static_cast<long>(j) * T + t];
  }
  const float mu = state[kMu * static_cast<long>(T) + t];
  const float it = state[kIt * static_cast<long>(T) + t];

  // projected-gradient convergence measure
  float gi = 0.0f, max_diag = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float pg = fabsf(p[j] - clip_nan(p[j] - g[j], s.lb[j], s.ub[j]));
    gi = j == 0 ? pg : max_nan(gi, pg);
    max_diag = j == 0 ? a[0][0] : max_nan(max_diag, a[j][j]);
  }
  const bool grad_conv = gi <= s.eps1;

  // Kanzow μ only when no (warm) μ was carried in
  const float mu_it = (it == 0.0f && mu <= 0.0f) ? s.tau * max_diag : mu;

  // active-set freeze of bound-stuck coordinates, additive damping
  float af[M][M], gf[M], fr[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const bool frozen =
        ((p[j] <= s.lb[j]) && (g[j] > 0.0f)) || ((p[j] >= s.ub[j]) && (g[j] < 0.0f));
    fr[j] = frozen ? 0.0f : 1.0f;
    af[j][j] = frozen ? 1.0f : a[j][j] + mu_it;
    gf[j] = g[j] * fr[j];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int k = j + 1; k < M; ++k) af[j][k] = a[j][k] * fr[j] * fr[k];
  }

  float dp[M];
  const bool solver_ok = brdf::solve_damped<M>(af, gf, dp);

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

#pragma unroll
  for (int j = 0; j < M; ++j) pn_out[static_cast<long>(j) * T + t] = pn[j];
  scratch[kMuIt * static_cast<long>(T) + t] = mu_it;
  scratch[kGi * static_cast<long>(T) + t] = gi;
  scratch[kDl * static_cast<long>(T) + t] = dl;
  scratch[kOk * static_cast<long>(T) + t] = solver_ok ? 1.0f : 0.0f;
  scratch[kSmallDp * static_cast<long>(T) + t] = small_dp ? 1.0f : 0.0f;
  scratch[kGradConv * static_cast<long>(T) + t] = grad_conv ? 1.0f : 0.0f;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
lm_step_accept_kernel(const float* __restrict__ chi2_trial,  // (T,): χ² at pn
                      const float* __restrict__ scratch,     // (6, T)
                      const float* __restrict__ pn,          // (M, T)
                      float* __restrict__ p,                 // (M, T), updated in place
                      float* __restrict__ state,             // (6, T), updated in place
                      int* __restrict__ active, int T, StepArgs s) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool live = false;
  if (t < T) {
    const long tt = T;
    const float chi2 = state[kChi2 * tt + t], mu = state[kMu * tt + t];
    const float nu = state[kNu * tt + t], it = state[kIt * tt + t];
    const float stop = state[kStop * tt + t];
    const bool act = stop == 0.0f && it < s.itmax;

    const float mu_it = scratch[kMuIt * tt + t];
    const float dl = scratch[kDl * tt + t];
    const bool solver_ok = scratch[kOk * tt + t] != 0.0f;
    const float chi2_new = chi2_trial[t];
    const bool finite = isfinite(chi2_new);
    const float df = chi2 - chi2_new;

    const bool accept = solver_ok && finite && (df > 0.0f);
    const float rho = dl > 0.0f ? df / max_nan(dl, kTiny) : 1.0f;
    const float tmp = 2.0f * rho - 1.0f;
    const float mu_next = accept ? mu_it * max_nan(kThird, 1.0f - tmp * tmp * tmp) : mu_it * nu;
    const float nu_next = accept ? 2.0f : nu * 2.0f;

    // stop codes: later assignments win (convergence over failure)
    float st = 0.0f;
    if (mu_next > s.mu_max) st = kStopNoReduction;
    if (!solver_ok && mu_it > s.half_mu_max) st = kStopSingular;
    if (scratch[kSmallDp * tt + t] != 0.0f && solver_ok) st = kStopSmallDp;
    const float chi2_sel = accept ? chi2_new : chi2;
    if (chi2_sel <= s.eps3) st = kStopSmallChi2;
    if (scratch[kGradConv * tt + t] != 0.0f) st = kStopSmallGradient;

    if (act) {
      if (accept) {
#pragma unroll
        for (int j = 0; j < M; ++j) p[j * tt + t] = pn[j * tt + t];
      }
      state[kChi2 * tt + t] = chi2_sel;
      state[kMu * tt + t] = mu_next;
      state[kNu * tt + t] = nu_next;
      state[kIt * tt + t] = it + 1.0f;
      state[kStop * tt + t] = st;
      state[kGinf * tt + t] = scratch[kGi * tt + t];
      live = st == 0.0f && it + 1.0f < s.itmax;
    }
  }
  // the lanes still active: a ballot a warp, one atomic a warp (every lane of
  // the block's full warps reaches it)
  const unsigned ballot = __ballot_sync(brdf::kFullWarp, live);
  if ((threadIdx.x & 31) == 0 && ballot != 0u) atomicAdd(active, __popc(ballot));
}

using ProposeFn = void (*)(const float*, const float*, const float*, float*, float*, int*, int,
                           StepArgs);
using AcceptFn = void (*)(const float*, const float*, const float*, float*, float*, int*, int,
                          StepArgs);

ProposeFn propose_for(int m) {
  switch (m) {
    case 1: return lm_step_propose_kernel<1>;
    case 2: return lm_step_propose_kernel<2>;
    case 3: return lm_step_propose_kernel<3>;
    case 4: return lm_step_propose_kernel<4>;
    case 5: return lm_step_propose_kernel<5>;
    case 9: return lm_step_propose_kernel<9>;
    default: return nullptr;
  }
}

AcceptFn accept_for(int m) {
  switch (m) {
    case 1: return lm_step_accept_kernel<1>;
    case 2: return lm_step_accept_kernel<2>;
    case 3: return lm_step_accept_kernel<3>;
    case 4: return lm_step_accept_kernel<4>;
    case 5: return lm_step_accept_kernel<5>;
    case 9: return lm_step_accept_kernel<9>;
    default: return nullptr;
  }
}

bool make_args(int m, const float* lower, const float* upper, float eps1, float eps2_sq,
               float eps3, float mu_max, float half_mu_max, float tau, int itmax, StepArgs* s) {
  if (m < 1 || m > kMaxStep) return false;
  for (int j = 0; j < kMaxStep; ++j) {
    s->lb[j] = j < m ? lower[j] : 0.0f;
    s->ub[j] = j < m ? upper[j] : 0.0f;
  }
  s->eps1 = eps1;
  s->eps2_sq = eps2_sq;
  s->eps3 = eps3;
  s->mu_max = mu_max;
  s->half_mu_max = half_mu_max;
  s->tau = tau;
  s->itmax = static_cast<float>(itmax);
  return true;
}

unsigned blocks_for(int T) {
  return static_cast<unsigned>((static_cast<long>(T) + kThreads - 1) / kThreads);
}

}  // namespace

// lower/upper hold m floats (host memory); eps2_sq and half_mu_max come from
// the wrapper, so that both versions use the same float32 constants.
extern "C" int brdf_lm_step_propose(int m, const float* full, const float* p,
                                    const float* state, float* pn, float* scratch, int* active,
                                    int T, const float* lower, const float* upper, float eps1,
                                    float eps2_sq, float eps3, float mu_max, float half_mu_max,
                                    float tau, int itmax, void* stream) {
  const ProposeFn kernel = propose_for(m);
  StepArgs s;
  if (kernel == nullptr || T < 1 ||
      !make_args(m, lower, upper, eps1, eps2_sq, eps3, mu_max, half_mu_max, tau, itmax, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks_for(T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(full, p, state, pn,
                                                                             scratch, active, T, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brdf_lm_step_accept(int m, const float* chi2_trial, const float* scratch,
                                   const float* pn, float* p, float* state, int* active, int T,
                                   const float* lower, const float* upper, float eps1,
                                   float eps2_sq, float eps3, float mu_max, float half_mu_max,
                                   float tau, int itmax, void* stream) {
  const AcceptFn kernel = accept_for(m);
  StepArgs s;
  if (kernel == nullptr || T < 1 ||
      !make_args(m, lower, upper, eps1, eps2_sq, eps3, mu_max, half_mu_max, tau, itmax, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks_for(T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      chi2_trial, scratch, pn, p, state, active, T, s);
  return static_cast<int>(cudaGetLastError());
}
