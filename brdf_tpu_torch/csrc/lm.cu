// Fused box-constrained Levenberg-Marquardt fit (kernel K5): one texel a group
// of S lanes of a warp, each lane holding a slice of the texel's views, and
// texels handed out as groups finish theirs.
//
// Replaces brdf_tpu/ops/lm_pallas.py::_lm_kernel (launched there by
// lm_fit_pallas). It computes what that kernel computes, for any of the ten
// lobes and m = 1..5 parameters: per texel, the whole box-projected LM solve —
// model and analytic Jacobian over the views, upper-triangular JᵀJ and Jᵀr,
// projected-gradient norm, Kanzow μ initialisation when no warm μ came in,
// active-set freeze of bound-stuck coordinates, additive or Marquardt damping,
// the closed-form damped solve (scalar, 2×2 and 3×3 Cramer, unrolled Cholesky
// for m = 4, 5; damped_solve.cuh, shared with lm_step.cu), box projection,
// trial χ², predicted reduction on the unfrozen system, Nielsen's μ/ν control
// and the levmar stop codes, with the warm (μ, ν, stop) resume rows of the
// start array.
//
// What bounds it on an H100: operations, not bytes. A texel reads (A+2)·V
// floats once and then evaluates its lobe 2·V times an iteration (Jacobian
// pass and trial χ² pass), each evaluation dozens of FP32 operations with
// expf/logf/sqrtf/sinf/cosf and divides, and the number of iterations is the
// texel's own (1 to itmax).
//
// What held the first design back (one thread a texel, its views staged in
// shared memory): each thread walked its views in one dependent chain with a
// shared-memory load a view, and a warp iterated until the slowest of its 32
// texels stopped — on the timber-aniso call 83% of the issued lane-iterations
// were idle lanes.
//
// This design (csrc/lanegroup.cuh):
// - A texel is solved by S lanes; lane l holds views l, l + S, … (VPL of them,
//   A + 2 floats a view: angles, y, w). Every view sum (the start χ², JᵀJ and
//   Jᵀr, the trial χ²) is the lane's partial left to right, then log2 S
//   butterfly rounds, so all S lanes hold the same bits and run the scalar
//   solve replicated in lockstep. ops/lm.py::lane_layout picks (S, VPL) from
//   V and the lobe's angle count for the wrapper and the plain version alike:
//   (4, 4) at V=16, (8, 2) for the two-channel lobes.
// - Where a lane keeps its views: in registers (VPL = 1 or 2 slots, a
//   template parameter; a slot past V runs on a clamped view and its terms
//   are left out by select) while they take at most 8 floats, else staged in
//   shared memory (VPL = 0), [warp][channel][slot][lane of the warp]: a lane
//   stores and reads back only its own column, so a load needs no barrier
//   and the 32 lanes hit 32 banks, and the slot loop runs to the lane's own
//   last view. Measured on an H100 (PERF.md, the K5 findings), registers win for
//   blinn_phong at (8, 2); for the heavier lobes, views held in registers
//   raise the registers a thread and so cut the warps an SM, and staging wins.
//   Staging also takes every view count fits_fused admits (up to 605) with
//   one instantiation a lobe, 128·(A+2)·⌈V/S⌉·4 bytes a block (at most 33 KB,
//   for cook_torrance_aniso at 165 views).
// - The loop is warp-uniform: it runs while any group of the warp has a
//   texel, every lane makes every shuffle, and a group whose texel has stopped
//   (final stop code or itmax) writes its 16 rows and takes the next untaken
//   texel from a work counter — one atomicAdd a warp for all its groups that
//   finished in that trip, then a shuffle. The grid is persistent (the SM
//   count × resident blocks an SM), so a warp no longer waits on its slowest
//   texel but only, at the very end, on the last ones.
// - A trip is the same instructions for every texel: the Jacobian pass at p
//   (which also sums χ²(p): a fresh texel takes it as its start χ², which is
//   the trial pass's arithmetic), the solve, the trial χ² pass and the
//   accept. A texel's result depends on its own inputs alone, so it does not
//   matter which group took it.
// - refill = 0 launches one group a texel instead (no counter), for the
//   timing phase that weighs the refill; the results are the same.
// There is no fallback.
//
// Rounding follows lobes.cuh's rules (built with -fmad=false, NaN-propagating
// clamps and maxima), so the kernel can be held against
// ops/lm.py::lm_rows_plain lane for lane: its view sums follow the same lane
// order and tree (ops/lanegroup.py::group_sum), the sums over parameters run
// in the order of the Pallas kernel's Python sums, tmp³ is two multiplies, 1/3
// is a float constant.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; counters[0] is the work counter and counters[1] sums the warps'
// trips, both zeroed by the caller; the entry returns cudaGetLastError()
// after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "bvls2.cuh"
#include "damped_solve.cuh"
#include "lanegroup.cuh"
#include "lobes.cuh"

namespace {

constexpr int kMaxParams = 5;
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr int kThreads = 128;   // a block: four warps, 128 / S texels in flight
constexpr int kMinBlocks = 4;   // 16 warps an SM: at most 128 registers a thread

// levmar stop codes (solver/lm.py::StopReason), stored as floats
constexpr float kStopSmallGradient = 1.0f;
constexpr float kStopSmallDp = 2.0f;
constexpr float kStopMaxIterations = 3.0f;
constexpr float kStopSingular = 4.0f;
constexpr float kStopNoReduction = 5.0f;
constexpr float kStopSmallChi2 = 6.0f;
constexpr float kStopInvalid = 7.0f;

using brdf::clip_nan;
using brdf::kTiny;
using brdf::max_nan;
using brdf::solve_damped;

struct LmArgs {
  float lb[kMaxParams], ub[kMaxParams];
  float eps1, eps2_sq, eps3, mu_max, half_mu_max, tau;
  float itmax;    // iterations are counted as floats, as the output row stores them
  int marquardt;  // 0: JᵀJ + μI, 1: JᵀJ + μ·diag(JᵀJ)
};

// VPL > 0: VPL view slots a lane in registers; VPL == 0: the views staged in
// shared memory, (A+2)·⌈V/S⌉ floats a lane
template <int L, int VPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lm_kernel(const float* __restrict__ ang,  // (A, V, T)
          const float* __restrict__ y,    // (V, T)
          const float* __restrict__ w,    // (V, T)
          const float* __restrict__ p0,   // (8, T): rows 0..m-1 start, 5/6/7 warm (μ, ν, stop)
          float* __restrict__ out,        // (16, T)
          int* __restrict__ counters,     // [0] next texel, [1] warp trips
          int T, int V, int S, int refill, LmArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  constexpr int NJ = M * (M + 1) / 2;   // JᵀJ, upper triangle, row by row
  constexpr int NS = NJ + M + 1;        // then Jᵀr, then χ²
  constexpr bool kStaged = VPL == 0;
  constexpr int NR = kStaged ? 1 : VPL;
  extern __shared__ float smem[];
  const int lane = static_cast<int>(threadIdx.x) & (S - 1);
  const long vt = static_cast<long>(V) * T;
  // staged views: [warp][channel][slot][lane of the warp], so that a lane
  // reads and writes only its own column and the 32 lanes hit 32 banks
  const int n_slots = (V + S - 1) / S;
  float* sv = smem + (threadIdx.x >> 5) * (A + 2) * n_slots * 32 + (threadIdx.x & 31);

  // register slots: lane's views k·S + lane; only the last can fall past V
  float av[NR][A], yv[NR], wv[NR];
  bool in_v[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    in_v[k] = k * S + lane < V;
    yv[k] = wv[k] = 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) av[k][a] = 0.0f;
  }

  // f(angles, y, w, in) on each of this lane's views, left to right
  auto each_view = [&](auto&& f) {
    if constexpr (kStaged) {
      float a_v[A];
      for (int k = 0; k * S + lane < V; ++k) {
#pragma unroll
        for (int a = 0; a < A; ++a) a_v[a] = sv[(a * n_slots + k) * 32];
        f(a_v, sv[(A * n_slots + k) * 32], sv[((A + 1) * n_slots + k) * 32], true);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) f(av[k], yv[k], wv[k], in_v[k]);
    }
  };

  // the group's texel and solver state (the same bits on its S lanes)
  int t = 0;
  bool have = false, done = true, fresh = false;
  float p[M], chi2 = 0.0f, mu = 0.0f, nu = 2.0f, stop = 0.0f, stop_w = 0.0f, it = 0.0f;
  float g_inf = 3.4e38f;
#pragma unroll
  for (int j = 0; j < M; ++j) p[j] = 0.0f;
  const long first = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / S;
  int trips = 0;

  for (;;) {
    // groups whose texel is written (and, at the start, every group) take the
    // next untaken one; with refill = 0 a group takes one texel only
    const int taken = refill ? brdf::take_items(counters, done, S) : 0;
    if (done) {
      t = refill ? taken : (trips == 0 && first < T ? static_cast<int>(first) : T);
      have = t < T;
      done = false;
      if (have) {
        if constexpr (kStaged) {
          for (int k = 0; k * S + lane < V; ++k) {
            const long g = static_cast<long>(k * S + lane) * T + t;
#pragma unroll
            for (int a = 0; a < A; ++a) sv[(a * n_slots + k) * 32] = ang[a * vt + g];
            sv[(A * n_slots + k) * 32] = y[g];
            sv[((A + 1) * n_slots + k) * 32] = w[g];
          }
        } else {
#pragma unroll
          for (int k = 0; k < NR; ++k) {
            const long g = static_cast<long>(in_v[k] ? k * S + lane : V - 1) * T + t;
#pragma unroll
            for (int a = 0; a < A; ++a) av[k][a] = ang[a * vt + g];
            yv[k] = y[g];
            wv[k] = w[g];
          }
        }
#pragma unroll
        for (int j = 0; j < M; ++j)
          p[j] = clip_nan(p0[static_cast<long>(j) * T + t], s.lb[j], s.ub[j]);
        // warm rows: μ ≤ 0 or non-finite → Kanzow init at iteration 0; ν < 2
        // or non-finite → 2; a non-zero stop is final and short-circuits
        const float mu_w = p0[5L * T + t];
        mu = (isfinite(mu_w) && mu_w > 0.0f) ? mu_w : 0.0f;
        const float nu_w = p0[6L * T + t];
        nu = (isfinite(nu_w) && nu_w >= 2.0f) ? nu_w : 2.0f;
        stop_w = p0[7L * T + t];
        it = 0.0f;
        g_inf = 3.4e38f;
        fresh = true;
      }
    }
    if (!__any_sync(brdf::kFullWarp, have)) break;
    ++trips;

    // Jacobian pass at p: the normal equations (weights fold in once via w²)
    // and χ²(p)
    float sums[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sums[i] = 0.0f;
    {
      const brdf::LobePoint pt = brdf::lobe_point<L>(p);
      each_view([&](const float* a_v, float yk, float wk, bool in) {
        const brdf::LobeOut<L> o = brdf::lobe_full<L>(a_v, p, pt);
        const float w2 = wk * wk;
        const float r = (o.i - yk) * wk;
        if (in) {
          int n = 0;
#pragma unroll
          for (int j = 0; j < M; ++j) {
#pragma unroll
            for (int k = j; k < M; ++k) sums[n++] += o.dp[j] * o.dp[k] * w2;
          }
#pragma unroll
          for (int j = 0; j < M; ++j) sums[NJ + j] += o.dp[j] * r * wk;
          sums[NS - 1] += r * r;
        }
      });
    }
    brdf::group_sum(sums, S);
    if (fresh) {  // the start χ², and the stop code it gives
      chi2 = sums[NS - 1];
      stop = stop_w != 0.0f ? stop_w : (isfinite(chi2) ? 0.0f : kStopInvalid);
      fresh = false;
    }
    const bool active = have && stop == 0.0f && it < s.itmax;

    float a[M][M], g[M];
    {
      int n = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int k = j; k < M; ++k) a[j][k] = sums[n++];
        g[j] = sums[NJ + j];
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

    // trial χ² pass at pn
    float c_new[1] = {0.0f};
    {
      const brdf::LobePoint pt = brdf::lobe_point<L>(pn);
      each_view([&](const float* a_v, float yk, float wk, bool in) {
        const float r = (brdf::lobe_full<L>(a_v, pn, pt).i - yk) * wk;
        if (in) c_new[0] += r * r;
      });
    }
    brdf::group_sum(c_new, S);
    const float chi2_new = c_new[0];
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

    if (active) {
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

    // a texel that has stopped is written, and its group takes another
    done = have && !(stop == 0.0f && it < s.itmax);
    if (done && lane == 0) {
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
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(&counters[1], trips);
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*, int*,
                          int, int, int, int, LmArgs);

// the instantiation for `slots` register slots a lane (1 or 2), or the staged
// one (0)
template <int L>
KernelFn kernel_for(int slots) {
  switch (slots) {
    case 0: return lm_kernel<L, 0>;
    case 1: return lm_kernel<L, 1>;
    case 2: return lm_kernel<L, 2>;
    default: return nullptr;
  }
}

KernelFn pick_kernel(int lobe, int slots) {
  BRDF_DISPATCH_LOBE(lobe, return kernel_for<kLobe>(slots))
  return nullptr;
}

int n_params_of(int lobe) {
  BRDF_DISPATCH_LOBE(lobe, return brdf::LobeTraits<kLobe>::n_params)
  return 0;
}

int n_angles_of(int lobe) {
  BRDF_DISPATCH_LOBE(lobe, return brdf::LobeTraits<kLobe>::n_angles)
  return 0;
}

// dynamic shared memory of a block: the staged views of its warps
int smem_bytes(int lobe, int slots, int lanes, int V) {
  if (slots != 0) return 0;
  return kThreads * (n_angles_of(lobe) + 2) * ((V + lanes - 1) / lanes) *
         static_cast<int>(sizeof(float));
}

}  // namespace

// lower/upper hold n_params floats (host memory); eps2_sq, half_mu_max come
// from the wrapper so that both versions use the same float32 constants.
// lanes: a power of two dividing 32; slots: 1 or 2 register slots a lane
// (slots·lanes ≥ V), or 0 for the views staged in shared memory; refill: 1
// for the persistent grid that hands out texels as groups finish.
extern "C" int brdf_lm_fit(int lobe, const float* ang, const float* y, const float* w,
                           const float* p0, float* out, int* counters, int T, int V, int lanes,
                           int slots, int refill, const float* lower, const float* upper,
                           int n_params, float eps1, float eps2_sq, float eps3, float mu_max,
                           float half_mu_max, float tau, int itmax, int marquardt,
                           void* stream) {
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (n_params < 1 || n_params > kMaxParams || n_params != n_params_of(lobe) || T < 1 || V < 1 ||
      !lanes_ok || (slots != 0 && static_cast<long>(slots) * lanes < V))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(lobe, slots);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  const int smem = smem_bytes(lobe, slots, lanes, V);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one group a texel, or (refill) the blocks the card holds at once
  const long texels_a_block = kThreads / lanes;
  long blocks = (static_cast<long>(T) + texels_a_block - 1) / texels_a_block;
  if (refill) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
            cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = blocks < static_cast<long>(sms) * per_sm ? blocks : static_cast<long>(sms) * per_sm;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ang, y, w, p0, out, counters, T, V, lanes, refill, s);
  return static_cast<int>(cudaGetLastError());
}

// What an instantiation gets on this card: out[0] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory for V
// views), out[1] registers a thread, out[2] local memory bytes a thread (stack
// and spills), out[3] threads a block, out[4] the card's SM count.
extern "C" int brdf_lm_occupancy(int lobe, int slots, int lanes, int V, int* out) {
  const KernelFn kernel = pick_kernel(lobe, slots);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, kThreads, smem_bytes(lobe, slots, lanes, V));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, device));
}
