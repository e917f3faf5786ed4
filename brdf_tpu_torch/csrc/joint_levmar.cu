// The m = 11 joint normal-map solve in one launch (joint_levmar_kernel): for
// each face, the box-constrained Levenberg-Marquardt of
// brdf_tpu_torch/solver/lm.py::levmar_bc over the anisotropic joint model
// (RGB kd, RGB ks, rough_x, rough_y, phi, and the normal offset nu, nv), its
// outer and inner loops both on the device.
//
// Replaces no TPU kernel: the JAX package runs brdf_tpu/solver/lm.py::levmar_bc
// for this fit, and XLA compiles the whole vmapped while_loop there. The port
// ran it as eager PyTorch: a forward-mode Jacobian under vmap through
// perturbed_angles, then up to max_inner batched Cholesky solves and residuals
// an outer iteration, with a host test of the lanes before each — some 5700
// launches and 11 synchronisations an iteration, ~230k launches a solve at
// 8203 faces, while the device work of a solve is milliseconds.
//
// What it computes, per face, in levmar_bc's order:
//   p = proj(p0); χ² = Σ r² (r = (I − y)·w over the 3·V residuals);
//   stop = INVALID_VALUES where χ² is not finite; μ = 0, ν = 2
//   while stop == RUNNING and iters < itmax:
//     J at p (analytic), JᵀJ, g = Jᵀr; gi = max|p − proj(p − g)|
//     frozen_j = (p_j ≤ lb_j and g_j > 0) or (p_j ≥ ub_j and g_j < 0)
//     JᵀJ_f: frozen rows and columns zeroed, a 1 on their diagonal; g_f = g·free
//     μ_t = τ·max diag(JᵀJ) at iteration 0 where μ ≤ 0, else μ
//     up to max_inner tries, while none is accepted and no stop code is set:
//       δ from (JᵀJ_f + μ_t I) δ = −g_f by Cholesky (a pivot that is not
//         positive fails the try: δ is NaN); p' = proj(p + δ), Δ = p' − p
//       small_dp = |Δ|² ≤ eps2²·|p|²; χ²' at p'; df = χ² − χ²'
//       predicted dl = −(2 gᵀΔ + Δᵀ JᵀJ Δ) with the unfrozen JᵀJ
//       accept = solved and χ²' finite and df > 0
//       ρ = df / max(dl, tiny) where dl > 0, else 1
//       μ' = accept ? μ_t·max(1 − (2ρ − 1)³, 1/3) : μ_t·ν;  ν' = accept ? 2 : 2ν
//       stop: SMALL_DP (small_dp and solved), then NO_REDUCTION (μ' > mu_max),
//         then SINGULAR (not solved and μ_t > mu_max/2), later ones winning
//     then NO_REDUCTION where no try was accepted and no code set, SMALL_CHI2
//     where χ² ≤ eps3, SMALL_GRADIENT where gi ≤ eps1; iters, nfev, njev and
//     nlss counted as levmar_bc counts them; RUNNING at the end reads
//     MAX_ITERATIONS.
//
// The Jacobian: K0's lobe_full<L> (lobes.cuh) gives each channel's ∂I/∂params
// and ∂I/∂angles; the offsets' columns chain ∂I/∂angles with the angles'
// partials in (nu, nv), carried as a value and two directional derivatives
// through the tilted normal N = normalize(n + nu·t + nv·b) and the Duff frame
// (T, B) that models/normalmap.py::perturbed_angles rebuilds from N. A
// roughness exactly at the lobe's floor, 1e-3 (the box's lower bound), takes
// half its derivative just above it: forward mode through torch.maximum gives
// levmar_bc half at the tie, where K0 gives 0, which would hold the parameter
// at the bound for good. Its plain twin is ops/joint_levmar.py::joint_jacobian.
//
// Layout (csrc/lanegroup.cuh): a face is solved by a group of S lanes of one
// warp, lane l walking views l, l + S, … (any V; ops/joint_levmar.py::
// lane_layout picks S). A lane sums its views' χ², the 66 upper-triangle
// entries of JᵀJ and the 11 of g left to right, the three channels in order
// within a view; the group combines them by group_sum's XOR butterfly, so
// every lane holds the same bits and the 11 × 11 Cholesky runs replicated on
// the group. JᵀJ and g are kept in the group's slot of shared memory across
// an iteration's tries. The loop is warp-uniform: a trip is a Jacobian pass
// (where a group of the warp starts an iteration) and one try (where a group
// is inside one); a group whose face has stopped writes it and takes the next
// untaken face from a work counter (take_items), on a persistent grid, so
// stopped faces leave the loop.
//
// What bounds it on an H100: latency, not bytes or operations. A face reads
// 12·V floats an evaluation (from L2; 6.3 MB for 8203 × 16 views), and a
// solve is ~1–2 MFLOP a face (about 40 iterations of a 48-residual Jacobian,
// ~2 Cholesky solves and residual passes each), ~10–15 GFLOP at 8203 faces;
// each trip is a dependent chain of lobe evaluations, a 78-value butterfly
// and an 11 × 11 factorisation, and the registers these hold cap the warps
// an SM.
//
// Rounding: built with -fmad=false and lobes.cuh's rules; clamps and maxima
// propagate NaN as torch's do (bvls2.cuh). The geometry (the tilted normal,
// its frame, the half vector, the cosines) repeats joint_eval's float32 torch
// operations on the card bit for bit (dot below), because the lobe is not
// continuous where a cosine crosses 0 and the fit drives some faces onto that
// edge. The view sums run in the lane group's order and the solve is this
// file's own, so the kernel agrees with the plain version to float32's
// rounding (tools/joint_levmar_agreement.py).
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; counters[0] is the work counter and counters[1] sums the warps'
// trips, both zeroed by the caller; the entry returns cudaGetLastError()
// after the launch.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "bvls2.cuh"
#include "lanegroup.cuh"
#include "lobes.cuh"

namespace {

constexpr int kM = 11;                  // kd_rgb, ks_rgb, rough_x, rough_y, phi, nu, nv
constexpr int kNJ = kM * (kM + 1) / 2;  // JᵀJ's upper triangle, row by row
constexpr int kNS = kNJ + kM + 1;       // then g = Jᵀr, then χ²
constexpr int kSlot = kNJ + kM;         // a group's JᵀJ and g in shared memory
constexpr int kThreads = 128;           // a block: four warps, 128 / S faces
constexpr float kThird = static_cast<float>(1.0 / 3.0);
// the anisotropic lobes' roughness floor (lobes.cuh: max(p, 1e-3)) and the
// float above it
constexpr float kRoughFloor = 1e-3f;
constexpr float kAboveFloor = 0x1.0624e0p-10f;

// levmar stop codes (solver/lm.py::StopReason)
constexpr int kRunning = 0;
constexpr int kSmallGradient = 1;
constexpr int kSmallDp = 2;
constexpr int kMaxIterations = 3;
constexpr int kSingular = 4;
constexpr int kNoReduction = 5;
constexpr int kSmallChi2 = 6;
constexpr int kInvalid = 7;

using brdf::clip_nan;
using brdf::max_nan;

struct Args {
  float lb[kM], ub[kM];
  float tau, eps1, eps2_sq, eps3, mu_max, half_mu_max;
  int itmax, max_inner;
};

// the index of JᵀJ's entry (j, k), j ≤ k, in its packed upper triangle
__host__ __device__ constexpr int tri(int j, int k) { return j * (2 * kM - j - 1) / 2 + k; }

struct V3 {
  float x, y, z;
};

// a·b in the order torch.sum(a * b, dim=-1) adds three channels on the card,
// (a.x b.x + a.z b.z) + a.y b.y, and |u| floored as the model floors it
// (models/normalmap.py::perturbed_angles, models/brdf.py::_normalize:
// torch.linalg.vector_norm adds the squares in the same order): the
// normalisations divide by it, as they do. So the tilted normal, the half
// vector and the cosines carry the bits models/normalmap.py::joint_eval gives
// them on the card, and the lobe's lit tests (cos > 0) fall on the same side
// for both: a fit that stops with the eye or a light on a face's horizon,
// where the lobe jumps, keeps the χ² that joint_eval gives its answer
__device__ __forceinline__ float dot(const V3& a, const V3& b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}

__device__ __forceinline__ float norm_floor(const V3& u) {
  return max_nan(sqrtf(dot(u, u)), brdf::kEps);
}

// the Duff frame of unit n (models/normalmap.py::tangent_basis)
__device__ __forceinline__ void duff_frame(const V3& n, float sgn, float a, V3& t, V3& b) {
  const float bb = n.x * n.y * a;
  t = V3{1.0f + sgn * (n.x * n.x) * a, sgn * bb, -sgn * n.x};
  b = V3{bb, sgn + (n.y * n.y) * a, -n.y};
}

// the frame's derivative along d (ops/joint_levmar.py::frame_partials)
__device__ __forceinline__ void duff_partials(const V3& n, float sgn, float a, const V3& d,
                                              V3& dt, V3& db) {
  const float da = a * a * d.z;
  const float dbb = (d.x * n.y + n.x * d.y) * a + n.x * n.y * da;
  dt = V3{sgn * (2.0f * n.x * d.x * a + n.x * n.x * da), sgn * dbb, -sgn * d.x};
  db = V3{dbb, 2.0f * n.y * d.y * a + n.y * n.y * da, -d.y};
}

// The tilted normal and its frame at (nu, nv); with DUAL also their partials
// in nu (_u) and nv (_v).
template <bool DUAL>
struct Tilt {
  V3 n, t, b;
  V3 n_u, n_v, t_u, t_v, b_u, b_v;
};

template <bool DUAL>
__device__ __forceinline__ Tilt<DUAL> tilt(const V3& n0, const V3& t0, const V3& b0, float nu,
                                           float nv) {
  Tilt<DUAL> f;
  const V3 u{n0.x + nu * t0.x + nv * b0.x, n0.y + nu * t0.y + nv * b0.y,
             n0.z + nu * t0.z + nv * b0.z};
  const float ell = norm_floor(u);
  f.n = V3{u.x / ell, u.y / ell, u.z / ell};
  const float sgn = f.n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (sgn + f.n.z)) * -1.0f;
  duff_frame(f.n, sgn, a, f.t, f.b);
  if constexpr (DUAL) {
    const float ndt = dot(f.n, t0), ndb = dot(f.n, b0);
    f.n_u = V3{(t0.x - f.n.x * ndt) / ell, (t0.y - f.n.y * ndt) / ell, (t0.z - f.n.z * ndt) / ell};
    f.n_v = V3{(b0.x - f.n.x * ndb) / ell, (b0.y - f.n.y * ndb) / ell, (b0.z - f.n.z * ndb) / ell};
    duff_partials(f.n, sgn, a, f.n_u, f.t_u, f.b_u);
    duff_partials(f.n, sgn, a, f.n_v, f.t_v, f.b_v);
  }
  return f;
}

// A view's angle channels in ops/shading.py's order (cos_ln, cos_nh, cos_vn,
// cos_th, cos_bh, then for nine channels cos_tl, cos_bl, cos_tv, cos_bv) and,
// with DUAL, their partials in nu and nv.
template <int A, bool DUAL>
__device__ __forceinline__ void view_angles(const Tilt<DUAL>& f, const V3& l, const V3& e,
                                            float* ang, float* ang_u, float* ang_v) {
  const V3 s{l.x + e.x, l.y + e.y, l.z + e.z};
  const float len_s = norm_floor(s);
  const V3 h{s.x / len_s, s.y / len_s, s.z / len_s};
  ang[0] = dot(f.n, l);
  ang[1] = dot(f.n, h);
  ang[2] = dot(f.n, e);
  ang[3] = dot(f.t, h);
  ang[4] = dot(f.b, h);
  if constexpr (A == 9) {
    ang[5] = dot(f.t, l);
    ang[6] = dot(f.b, l);
    ang[7] = dot(f.t, e);
    ang[8] = dot(f.b, e);
  }
  if constexpr (DUAL) {
    ang_u[0] = dot(f.n_u, l);
    ang_v[0] = dot(f.n_v, l);
    ang_u[1] = dot(f.n_u, h);
    ang_v[1] = dot(f.n_v, h);
    ang_u[2] = dot(f.n_u, e);
    ang_v[2] = dot(f.n_v, e);
    ang_u[3] = dot(f.t_u, h);
    ang_v[3] = dot(f.t_v, h);
    ang_u[4] = dot(f.b_u, h);
    ang_v[4] = dot(f.b_v, h);
    if constexpr (A == 9) {
      ang_u[5] = dot(f.t_u, l);
      ang_v[5] = dot(f.t_v, l);
      ang_u[6] = dot(f.b_u, l);
      ang_v[6] = dot(f.b_v, l);
      ang_u[7] = dot(f.t_u, e);
      ang_v[7] = dot(f.t_v, e);
      ang_u[8] = dot(f.b_u, e);
      ang_v[8] = dot(f.b_v, e);
    }
  }
}

// What a face's passes read: its views' directions, targets and weights,
// views-major (lv (6, V, T), y and w (3, V, T)), and its untilted frame.
struct Face {
  const float* lv;
  const float* y;
  const float* w;
  long vt;  // V·T, a channel's stride
  int T, V, t;
  V3 n0, t0, b0;
};

__device__ __forceinline__ V3 load3(const float* x, long stride, long g) {
  return V3{__ldg(x + g), __ldg(x + stride + g), __ldg(x + 2 * stride + g)};
}

// This lane's views' sums at q, added to sums (χ² last): χ² alone (JAC false,
// N = 1), or JᵀJ's upper triangle, g = Jᵀr and χ² (JAC true, N = kNS). A lane
// of a group that takes no part (live false) reads nothing.
template <int L, bool JAC, int N>
__device__ __forceinline__ void view_pass(const Face& fc, const float (&q)[kM], int lane, int s,
                                          bool live, float (&sums)[N]) {
  static_assert(N == (JAC ? kNS : 1), "JᵀJ, g and χ², or χ² alone");
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  const Tilt<JAC> f = tilt<JAC>(fc.n0, fc.t0, fc.b0, q[9], q[10]);
  const brdf::LobePoint pt{cosf(q[8]), sinf(q[8])};
  const int views = live ? fc.V : 0;
  // a roughness at the lobe's floor (the box's lower bound, where the step's
  // projection puts it) takes half its derivative above the floor, as
  // forward mode through torch.maximum gives levmar_bc at the tie; K0's 0
  // there would pin the parameter to the floor for good
  const bool tie_x = JAC && q[6] == kRoughFloor, tie_y = JAC && q[7] == kRoughFloor;
  for (int v = lane; v < views; v += s) {
    const long g = static_cast<long>(v) * fc.T + fc.t;
    const V3 l = load3(fc.lv, fc.vt, g);
    const V3 e = load3(fc.lv + 3 * fc.vt, fc.vt, g);
    float ang[A], ang_u[A], ang_v[A];
    view_angles<A, JAC>(f, l, e, ang, ang_u, ang_v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pc[5] = {q[c], q[3 + c], q[6], q[7], q[8]};
      brdf::LobeOut<L> o = brdf::lobe_full<L>(ang, pc, pt);
      if (tie_x || tie_y) {
        const float up[5] = {pc[0], pc[1], tie_x ? kAboveFloor : pc[2],
                             tie_y ? kAboveFloor : pc[3], pc[4]};
        const brdf::LobeOut<L> above = brdf::lobe_full<L>(ang, up, pt);
        if (tie_x) o.dp[2] = 0.5f * above.dp[2];
        if (tie_y) o.dp[3] = 0.5f * above.dp[3];
      }
      const float wc = __ldg(fc.w + c * fc.vt + g);
      const float r = (o.i - __ldg(fc.y + c * fc.vt + g)) * wc;
      if constexpr (JAC) {
        float d_nu = o.da[0] * ang_u[0];
        float d_nv = o.da[0] * ang_v[0];
#pragma unroll
        for (int a = 1; a < A; ++a) {
          d_nu = d_nu + o.da[a] * ang_u[a];
          d_nv = d_nv + o.da[a] * ang_v[a];
        }
        // the channel's row: its kd and ks, the shared shape and offsets
        const int col[7] = {c, 3 + c, 6, 7, 8, 9, 10};
        const float jr[7] = {o.dp[0] * wc, o.dp[1] * wc, o.dp[2] * wc, o.dp[3] * wc,
                             o.dp[4] * wc, d_nu * wc,    d_nv * wc};
#pragma unroll
        for (int i = 0; i < 7; ++i) {
#pragma unroll
          for (int k = i; k < 7; ++k) sums[tri(col[i], col[k])] += jr[i] * jr[k];
          sums[kNJ + col[i]] += jr[i] * r;
        }
      }
      sums[N - 1] += r * r;
    }
  }
}

// (JᵀJ_f + μI) δ = −g_f from the group's slot (JᵀJ packed, then g): frozen
// rows and columns zeroed with a 1 on the diagonal, as levmar_bc forms them.
// An unrolled Cholesky; a pivot that is not positive fails the solve (false,
// δ NaN), as torch.linalg.cholesky_ex reports it.
__device__ __forceinline__ bool damped_cholesky(const float* slot, int frozen, float mu,
                                                float (&dp)[kM]) {
  float l[kM][kM];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    const float fj = (frozen >> j) & 1 ? 0.0f : 1.0f;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) s += l[j][k] * l[j][k];
    const float ajj = slot[tri(j, j)] * (fj * fj) + (fj == 0.0f ? 1.0f : 0.0f) + mu;
    const float d = ajj - s;
    ok = ok && (d > 0.0f);
    l[j][j] = sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < kM; ++i) {
      const float fi = (frozen >> i) & 1 ? 0.0f : 1.0f;
      float c = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) c += l[i][k] * l[j][k];
      l[i][j] = (slot[tri(j, i)] * (fj * fi) - c) / l[j][j];
    }
  }
  float yv[kM];
#pragma unroll
  for (int i = 0; i < kM; ++i) {  // forward: L y = −g_f
    const float gf = slot[kNJ + i] * ((frozen >> i) & 1 ? 0.0f : 1.0f);
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) c += l[i][k] * yv[k];
    yv[i] = (-gf - c) / l[i][i];
  }
#pragma unroll
  for (int i = kM - 1; i >= 0; --i) {  // backward: Lᵀ δ = y
    float c = 0.0f;
#pragma unroll
    for (int k = i + 1; k < kM; ++k) c += l[k][i] * dp[k];
    dp[i] = (yv[i] - c) / l[i][i];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i) dp[i] = ok ? dp[i] : NAN;
  return ok;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
joint_levmar_kernel(const float* __restrict__ lv,     // (6, V, T): light, then eye
                    const float* __restrict__ y,      // (3, V, T)
                    const float* __restrict__ w,      // (3, V, T)
                    const float* __restrict__ frame,  // (9, T): n, t, b
                    const float* __restrict__ p0,     // (11, T)
                    float* __restrict__ p_out,        // (T, 11)
                    float* __restrict__ f_out,        // (5, T): χ², χ²₀, g_inf, μ, ν
                    int* __restrict__ n_out,          // (5, T): iters, stop, nfev, njev, nlss
                    int* __restrict__ counters,       // [0] next face, [1] warp trips
                    int T, int V, int S, Args s) {
  extern __shared__ float smem[];
  const int lane = static_cast<int>(threadIdx.x) & (S - 1);
  float* const slot = smem + (threadIdx.x / S) * kSlot;
  Face fc{lv, y, w, static_cast<long>(V) * T, T, V, 0, {}, {}, {}};

  // the group's face and solver state (the same bits on its S lanes)
  bool have = false, done = true, fresh = false, in_iter = false;
  float p[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) p[j] = 0.0f;
  float chi2 = 0.0f, chi2_0 = 0.0f, mu = 0.0f, nu = 2.0f, g_inf = INFINITY;
  int stop = kRunning, iters = 0, nfev = 1, njev = 0, nlss = 0;
  // the state of an outer iteration across its tries
  float gi = 0.0f, mu_t = 0.0f, nu_t = 2.0f;
  bool grad_conv = false;
  int frozen = 0, tries = 0;
  int trips = 0;

  // an outer iteration's end: levmar_bc's stop codes after the inner loop
  auto end_iteration = [&](bool accepted, int st) {
    if (st == kRunning && !accepted) st = kNoReduction;
    if (chi2 <= s.eps3) st = kSmallChi2;
    if (grad_conv) st = kSmallGradient;
    g_inf = gi;
    mu = mu_t;
    nu = nu_t;
    iters += 1;
    stop = st;
    nfev += tries;
    njev += 1;
    nlss += tries;
    in_iter = false;
    done = !(stop == kRunning && iters < s.itmax);
  };

  for (;;) {
    // groups whose face is written (and, at the start, every group) take the
    // next untaken one
    const int taken = brdf::take_items(counters, done, S);
    if (done) {
      fc.t = taken;
      have = taken < T;
      done = false;
      if (have) {
        const int t = taken;
        fc.n0 = V3{frame[t], frame[T + t], frame[2L * T + t]};
        fc.t0 = V3{frame[3L * T + t], frame[4L * T + t], frame[5L * T + t]};
        fc.b0 = V3{frame[6L * T + t], frame[7L * T + t], frame[8L * T + t]};
#pragma unroll
        for (int j = 0; j < kM; ++j)
          p[j] = clip_nan(p0[static_cast<long>(j) * T + t], s.lb[j], s.ub[j]);
        mu = 0.0f;
        nu = 2.0f;
        g_inf = INFINITY;
        stop = kRunning;
        iters = njev = nlss = 0;
        nfev = 1;
        fresh = true;
        in_iter = false;
      }
    }
    if (!__any_sync(brdf::kFullWarp, have)) break;
    ++trips;

    // a Jacobian pass where a group of the warp starts an outer iteration (a
    // fresh face takes its χ² as the start χ²)
    const bool need_jac = have && !in_iter;
    if (__any_sync(brdf::kFullWarp, need_jac)) {
      float sums[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) sums[i] = 0.0f;
      view_pass<L, true>(fc, p, lane, S, need_jac, sums);
      brdf::group_sum(sums, S);
      if (need_jac) {
        if (fresh) {
          chi2 = chi2_0 = sums[kNS - 1];
          stop = isfinite(chi2) ? kRunning : kInvalid;
          fresh = false;
        }
        if (stop == kRunning && iters < s.itmax) {
#pragma unroll
          for (int i = 0; i < kSlot; ++i) slot[i] = sums[i];
          // projected-gradient measure, active-set freeze, Kanzow μ
          float diag_max = 0.0f;
          frozen = 0;
#pragma unroll
          for (int j = 0; j < kM; ++j) {
            const float g = sums[kNJ + j];
            const float pg = fabsf(p[j] - clip_nan(p[j] - g, s.lb[j], s.ub[j]));
            gi = j == 0 ? pg : max_nan(gi, pg);
            diag_max = j == 0 ? sums[0] : max_nan(diag_max, sums[tri(j, j)]);
            if (((p[j] <= s.lb[j]) && (g > 0.0f)) || ((p[j] >= s.ub[j]) && (g < 0.0f)))
              frozen |= 1 << j;
          }
          grad_conv = gi <= s.eps1;
          mu_t = (iters == 0 && mu <= 0.0f) ? s.tau * diag_max : mu;
          nu_t = nu;
          tries = 0;
          in_iter = true;
          if (s.max_inner <= 0) end_iteration(false, kRunning);
        } else {
          done = true;
        }
      }
      __syncwarp();
    }

    // one try where a group is inside an outer iteration
    const bool in_try = have && in_iter;
    if (__any_sync(brdf::kFullWarp, in_try)) {
      float dp[kM];
      damped_cholesky(slot, frozen, mu_t, dp);
      float pn[kM], dpa[kM];
      float dp_nrm2 = 0.0f, p_nrm2 = 0.0f;
      bool solved = true;
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        pn[j] = clip_nan(p[j] + dp[j], s.lb[j], s.ub[j]);
        dpa[j] = pn[j] - p[j];  // the projected step
        dp_nrm2 += dpa[j] * dpa[j];
        p_nrm2 += p[j] * p[j];
        solved = solved && isfinite(dp[j]);
      }
      const bool small_dp = dp_nrm2 <= s.eps2_sq * p_nrm2;
      float c_new[1] = {0.0f};
      view_pass<L, false>(fc, pn, lane, S, in_try, c_new);
      brdf::group_sum(c_new, S);
      if (in_try) {
        const float chi2_new = c_new[0];
        const float df = chi2 - chi2_new;
        // predicted reduction −(2 gᵀΔ + Δᵀ JᵀJ Δ) with the unfrozen system
        float g_dot = 0.0f, q_dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          float jd = 0.0f;
#pragma unroll
          for (int k = 0; k < kM; ++k) jd += slot[j <= k ? tri(j, k) : tri(k, j)] * dpa[k];
          g_dot += slot[kNJ + j] * dpa[j];
          q_dot += dpa[j] * jd;
        }
        const float dl = -(2.0f * g_dot + q_dot);
        const bool accept = solved && isfinite(chi2_new) && (df > 0.0f);
        const float rho = dl > 0.0f ? df / fmaxf(dl, FLT_MIN) : 1.0f;
        const float tmp = 2.0f * rho - 1.0f;
        const float shrink = 1.0f - tmp * tmp * tmp;
        const float mu_next = accept ? mu_t * (shrink != shrink ? shrink : fmaxf(shrink, kThird))
                                     : mu_t * nu_t;
        const float nu_next = accept ? 2.0f : nu_t * 2.0f;
        int st = kRunning;
        if (small_dp && solved) st = kSmallDp;
        if (mu_next > s.mu_max) st = kNoReduction;
        if (!solved && mu_t > s.half_mu_max) st = kSingular;
        mu_t = mu_next;
        nu_t = nu_next;
        tries += 1;
        if (accept) {
#pragma unroll
          for (int j = 0; j < kM; ++j) p[j] = pn[j];
          chi2 = chi2_new;
        }
        if (accept || st != kRunning || tries >= s.max_inner) end_iteration(accept, st);
      }
    }

    // a face that has stopped is written, and its group takes another
    if (done && have && lane == 0) {
      const int t = fc.t;
#pragma unroll
      for (int j = 0; j < kM; ++j) p_out[static_cast<long>(t) * kM + j] = p[j];
      f_out[t] = chi2;
      f_out[static_cast<long>(T) + t] = chi2_0;
      f_out[2L * T + t] = g_inf;
      f_out[3L * T + t] = mu;
      f_out[4L * T + t] = nu;
      n_out[t] = iters;
      n_out[static_cast<long>(T) + t] = stop == kRunning ? kMaxIterations : stop;
      n_out[2L * T + t] = nfev;
      n_out[3L * T + t] = njev;
      n_out[4L * T + t] = nlss;
    }
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(&counters[1], trips);
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          float*, float*, int*, int*, int, int, int, Args);

KernelFn pick_kernel(int lobe) {
  switch (lobe) {
    case brdf::LOBE_WARD_ANISO: return joint_levmar_kernel<brdf::LOBE_WARD_ANISO>;
    case brdf::LOBE_COOK_TORRANCE_ANISO: return joint_levmar_kernel<brdf::LOBE_COOK_TORRANCE_ANISO>;
    default: return nullptr;
  }
}

bool lanes_ok(int lanes) { return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0; }

// dynamic shared memory of a block: a slot a group
int smem_bytes(int lanes) { return kThreads / lanes * kSlot * static_cast<int>(sizeof(float)); }

}  // namespace

// lower/upper hold 11 floats (host memory); eps2_sq and half_mu_max come from
// the wrapper, so that the kernel compares against levmar_bc's float32 values.
// lanes: a power of two dividing 32.
extern "C" int brdf_joint_levmar(int lobe, const float* lv, const float* y, const float* w,
                                 const float* frame, const float* p0, float* p_out, float* f_out,
                                 int* n_out, int* counters, int T, int V, int lanes,
                                 const float* lower, const float* upper, float tau, float eps1,
                                 float eps2_sq, float eps3, float mu_max, float half_mu_max,
                                 int itmax, int max_inner, void* stream) {
  const KernelFn kernel = pick_kernel(lobe);
  if (kernel == nullptr || T < 1 || V < 1 || !lanes_ok(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  Args s;
  for (int j = 0; j < kM; ++j) {
    s.lb[j] = lower[j];
    s.ub[j] = upper[j];
  }
  s.tau = tau;
  s.eps1 = eps1;
  s.eps2_sq = eps2_sq;
  s.eps3 = eps3;
  s.mu_max = mu_max;
  s.half_mu_max = half_mu_max;
  s.itmax = itmax;
  s.max_inner = max_inner;
  const int smem = smem_bytes(lanes);
  // the blocks the card holds at once, or fewer where the faces fill fewer
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long faces_a_block = kThreads / lanes;
  long blocks = (static_cast<long>(T) + faces_a_block - 1) / faces_a_block;
  if (blocks > static_cast<long>(sms) * per_sm) blocks = static_cast<long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, y, w, frame, p0, p_out, f_out, n_out, counters, T, V, lanes, s);
  return static_cast<int>(cudaGetLastError());
}

// What the instantiation gets on this card at `lanes` lanes a face: out[0]
// resident blocks an SM, out[1] registers a thread, out[2] local memory bytes
// a thread (stack and spills), out[3] threads a block, out[4] the SM count.
extern "C" int brdf_joint_levmar_occupancy(int lobe, int lanes, int* out) {
  const KernelFn kernel = pick_kernel(lobe);
  if (kernel == nullptr || !lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, smem_bytes(lanes));
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
