// Fused VarPro solve for the separable m=3 lobes (kernel K1): one texel a
// group of S lanes of a warp, each lane holding VPL of the texel's views and
// their per-view state in registers.
//
// Replaces brdf_tpu/ops/varpro_pallas.py::_varpro_kernel (launched there by
// varpro_fit_pallas). It computes what that kernel computes: an in-kernel
// shape grid with the closed-form box-constrained linear pair (_bvls2) at
// each point, then `iters` profiled Newton steps in log σ (exponent) or σ
// (roughness) with Kaufman's projected curvature and a trust-clipped
// accept-if-better step; a caller start (sig0) skips the grid.
//
// What bounds it on an H100: issue, not bytes. A texel reads (A+2)·V floats
// once (A = 2 or 3 angle channels) and evaluates its lobe (grid + 1 + iters)
// times per view: for cook_torrance 8 IEEE divides and 2 square roots a view
// and evaluation, for the Phong lobes an expf, whose rounding the plain
// version fixes; between the passes over the views, some 80 operations of
// scalar solve a texel with divides of their own.
//
// What held the first design back: one thread a texel, with a block's views
// staged in shared memory ((A + 5)·V floats a texel, 57–66 KB for a block of
// 128 texels at V=16), so 12–16 warps an SM, each thread one dependent chain
// of (grid + 1 + iters) evaluations with the view state read back from
// shared memory in each, at 10–11% of the operation bound.
//
// This design (csrc/lanegroup.cuh, as K8 and K5): a texel is solved by S
// lanes; lane l holds views l, l + S, … (VPL slots, a template parameter, so
// the state arrays stay in registers under #pragma unroll). A lane loads its
// views' angles, w and y·w once from device memory and keeps them beside a·w
// and the last evaluation's b·w and ∂b·w: (A + 5)·VPL floats, at most
// kLaneStateFloats (for blinn_phong, view_part keeps what a view gives alone
// in place of its angles). There is no shared memory. A lane's VPL lobe
// evaluations are independent, so they overlap. Every view sum is a lane's
// partial left to right, then log2 S butterfly rounds: all S lanes hold the
// same bits, run the scalar solve (bvls2, the curvature, the step, the
// accept, the trust radius) replicated in lockstep, and lane 0 writes the 8
// output rows. Lanes past T run on a clamped texel and only skip the write;
// a slot past V runs on a clamped view and its terms are left out by select.
// The work is fixed (grid + 1 + iters evaluations, no early exit), so no
// texel is refilled. ops/varpro.py::lane_layout picks (S, VPL) from A and V,
// for the wrapper and the plain version alike (at V=16: (2, 8) for the
// two-channel lobes, (4, 4) for the three-channel ones). Each copy of the
// scalar solve costs issue slots, so the fewest lanes whose state fits 20
// warps an SM win.
//
// Past 32 lanes of kLaneStateFloats (288 views for the two-channel lobes,
// 256 for the three-channel ones) the views do not fit registers, and the
// same kernel runs its long-view path (VPL = 0, one instantiation a lobe;
// ops/lanegroup.py::long_view_layout): 32 lanes a texel, lane l walking views
// l, l + 32, … in a run-time loop, each view read anew from device memory in
// every pass (the inputs are read 1 + grid + 2·(1 + iters) times; L2 holds
// a block's rows between passes). It sums in the same lane order, so the
// plain version's group_sum covers both paths, and it takes any V: it is the
// kernel at that size, not a fallback.
//
// χ² is formed from residuals in a second pass over a lane's views (the Gram
// identity's f32 cancellation floors χ² and breaks the accept test).
//
// Rounding follows lobes.cuh's rules (built with -fmad=false, reciprocals as
// torch takes them, NaN-propagating clamps and maxima as torch.clamp), so the
// kernel can be held against ops/varpro.py::varpro_rows_plain lane for lane:
// its view sums follow the same lane order and tree.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "bvls2.cuh"
#include "lanegroup.cuh"
#include "lobes.cuh"

namespace {

constexpr int kMaxGrid = 16;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;          // a block: four warps, 128 / S texels
constexpr int kLaneStateFloats = 64;   // view state a lane may hold (ops/varpro.py)
// Views a lane holds while a group of up to 32 lanes can take the views, by
// angle channels (index A): the twin of ops/varpro.py's
// VIEWS_PER_LANE_BY_ANGLES, which picks the layouts; min_blocks reads it, and
// tests/test_torch_varpro_layout.py holds the two equal.
constexpr int kViewsPerLane[4] = {0, 0, 8, 4};

struct GridArgs {
  float sig[kMaxGrid];  // grid values of σ (f32)
  float t[kMaxGrid];    // the same points in the Newton coordinate
  int n;
};

struct SolveArgs {
  float l0, u0, l1, u1;  // box of (kd, ks)
  float s_lo, s_hi;      // box of the Newton coordinate
  float p0_lo, p0_hi;    // clip of a caller's σ start
  float span, trust0, conv_tol;
  int use_log, iters;
};

using brdf::bvls2;
using brdf::clip_nan;
using brdf::group_sum;
using brdf::max_nan;

// K1's lobe at (kd, ks) = (0, 1): b = I and ∂b/∂σ. For blinn_phong the
// evaluation is split into what a view gives alone (ViewPart, computed once a
// view and kept in the lane's registers in place of its angles: 0·max(cos_ln,
// 0) and the log of the power's base) and what each shape point adds, which
// takes a logf out of every evaluation. The split repeats lobes.cuh's
// operations in their order, so b and ∂b carry the bits lobe_full<L>(ang, 0,
// 1, σ) gives them (∂b may be a zero of the other sign where the mask is off:
// added to a sum that starts at +0 it changes no bit). The other lobes keep
// their angles and call lobe_full.
template <int L>
struct ViewPart {
  float x[brdf::LobeTraits<L>::n_angles];
};

template <int L>
__device__ __forceinline__ ViewPart<L> view_part(const float* ang) {
  ViewPart<L> v;
  if constexpr (L == brdf::LOBE_BLINN_PHONG) {
    // 0·diff_b, and the log of the power's base, NaN where the mask is off
    const bool m = (ang[0] > 0.0f) && (ang[1] > 0.0f);
    v.x[0] = 0.0f * fmaxf(ang[0], 0.0f);
    v.x[1] = m ? logf(fmaxf(ang[1], brdf::kEps)) : NAN;
  } else {
#pragma unroll
    for (int a = 0; a < brdf::LobeTraits<L>::n_angles; ++a) v.x[a] = ang[a];
  }
  return v;
}

template <int L>
__device__ __forceinline__ void shape_part(const ViewPart<L>& v, float sig, float& b,
                                           float& db) {
  if constexpr (L == brdf::LOBE_BLINN_PHONG) {
    const bool m = v.x[1] == v.x[1];
    const float pw = m ? expf(sig * v.x[1]) : 0.0f;
    b = v.x[0] + pw;
    db = m ? v.x[1] * pw : 0.0f;
  } else {
    const brdf::LobeOut<L> o = brdf::lobe_full<L>(v.x, 0.0f, 1.0f, sig);
    b = o.i;
    db = o.dp[2];
  }
}

// the most views a lane holds: the view part (A floats), w, y·w, a·w, b·w and
// ∂b·w a view
template <int L>
__host__ __device__ constexpr int max_vpl() {
  return kLaneStateFloats / (brdf::LobeTraits<L>::n_angles + 5);
}

// the blocks an SM __launch_bounds__ asks for: 5 (20 warps, at most 102
// registers a thread) up to the views a lane holds below 32 lanes a texel
// (kViewsPerLane) and on the long-view path (VPL = 0), else 4 (16 warps, 128
// registers), where 102 would spill the views' state
template <int L, int VPL>
__host__ __device__ constexpr int min_blocks() {
  return VPL <= kViewsPerLane[brdf::LobeTraits<L>::n_angles] ? 5 : 4;
}

// VPL > 0: a lane holds VPL views in registers (the register layouts of
// lane_layout). VPL = 0: the long-view path, past the register layouts: 32
// lanes a texel, lane l walking views l, l + 32, … (⌈V / 32⌉ of them, a
// run-time count), each read anew from device memory into slot 0 in every pass; pass 2
// evaluates the lobe again where the register path reads b·w and ∂b·w kept
// from pass 1, with the same operations, so both paths give the bits of the
// plain version's sum order.
template <int L, int VPL>
__global__ void __launch_bounds__(kThreads, (min_blocks<L, VPL>()))
varpro_kernel(const float* __restrict__ ang,   // (A, V, T)
              const float* __restrict__ y,     // (V, T)
              const float* __restrict__ w,     // (V, T)
              const float* __restrict__ sig0,  // (T,) caller σ start, or null
              float* __restrict__ out,         // (8, T)
              int T, int V, int S, GridArgs grid, SolveArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  static_assert(VPL >= 0 && VPL <= max_vpl<L>(), "a lane's view state fits its budget");
  constexpr bool kLong = VPL == 0;
  constexpr int kSlots = kLong ? 1 : VPL;
  const brdf::LaneGroup lg = brdf::lane_group(S);
  // ragged edge: lanes past T stay for the shuffles on the last texel, unwritten
  const bool live = lg.item < T;
  const long t = live ? lg.item : T - 1;
  const long vt = static_cast<long>(V) * T;
  const int n_slots = kLong ? (V + S - 1) / S : VPL;

  // this lane's views k·S + lane; only the last slot can fall past V. On the
  // long-view path slot k lives in slot 0 (i = 0) while its pass uses it.
  ViewPart<L> vp[kSlots];
  float wv[kSlots], yw[kSlots], aw[kSlots], bw[kSlots], dbw[kSlots];
  bool in_v[kSlots];
  // slot k's view into slot i: what it gives alone, w, y·w and a·w (the
  // diffuse basis is σ-independent for every separable lobe)
  auto load = [&](int k, int i) {
    const int v = k * S + lg.lane;
    in_v[i] = v < V;
    const long gi = static_cast<long>(in_v[i] ? v : V - 1) * T + t;
    float av[A];
#pragma unroll
    for (int a = 0; a < A; ++a) av[a] = ang[a * vt + gi];
    wv[i] = w[gi];
    yw[i] = y[gi] * wv[i];
    aw[i] = brdf::lobe_full<L>(av, 0.0f, 1.0f, grid.sig[0]).dp[0] * wv[i];
    vp[i] = view_part<L>(av);
  };
  float a_sums[2] = {0.0f, 0.0f};  // Σ a·a, Σ a·y
#pragma unroll
  for (int k = 0; k < n_slots; ++k) {
    const int i = kLong ? 0 : k;
    load(k, i);
    if (in_v[i]) {
      a_sums[0] += aw[i] * aw[i];
      a_sums[1] += aw[i] * yw[i];
    }
  }
  group_sum(a_sums, S);
  const float aa = a_sums[0], ay = a_sums[1];

  float best_t;
  if (sig0 != nullptr) {
    const float s0 = clip_nan(sig0[t], s.p0_lo, s.p0_hi);
    best_t = s.use_log ? logf(s0) : s0;
  } else {
    // grid init: the Gram-form cost only ranks the points
    best_t = grid.t[0];
    float best_cost = INFINITY;
    for (int gi = 0; gi < grid.n; ++gi) {
      const float sig = grid.sig[gi];
      float b_sums[3] = {0.0f, 0.0f, 0.0f};  // Σ a·b, b·b, b·y
#pragma unroll
      for (int k = 0; k < n_slots; ++k) {
        const int i = kLong ? 0 : k;
        if constexpr (kLong) load(k, 0);
        float bk, dbk;
        shape_part<L>(vp[i], sig, bk, dbk);
        const float bwk = bk * wv[i];
        if (in_v[i]) {
          b_sums[0] += aw[i] * bwk;
          b_sums[1] += bwk * bwk;
          b_sums[2] += bwk * yw[i];
        }
      }
      group_sum(b_sums, S);
      float kd, ks;
      bvls2(aa, b_sums[0], b_sums[1], ay, b_sums[2], s.l0, s.u0, s.l1, s.u1, kd, ks);
      const float cost = kd * kd * aa + ks * ks * b_sums[1] + 2.0f * kd * ks * b_sums[0] -
                         2.0f * (kd * ay + ks * b_sums[2]);
      if (cost < best_cost) {
        best_t = grid.t[gi];
        best_cost = cost;
      }
    }
  }

  // profiled χ², gradient, projected curvature, kd and ks at coordinate tv
  auto eval_at = [&](float tv, float& chi2, float& g, float& h, float& kd, float& ks) {
    const float sig = s.use_log ? expf(tv) : tv;
    // slot i's b·w and ∂b·w (in the Newton coordinate) at σ
    auto shape_at = [&](int i) {
      float bk, dbk;
      shape_part<L>(vp[i], sig, bk, dbk);
      const float db_t = s.use_log ? dbk * sig : dbk;
      bw[i] = bk * wv[i];
      dbw[i] = db_t * wv[i];
    };
    // pass 1: the lobe; Σ a·b, b·b, b·y, a·∂b, b·∂b, ∂b·∂b
    float b_sums[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < n_slots; ++k) {
      const int i = kLong ? 0 : k;
      if constexpr (kLong) load(k, 0);
      shape_at(i);
      if (in_v[i]) {
        b_sums[0] += aw[i] * bw[i];
        b_sums[1] += bw[i] * bw[i];
        b_sums[2] += bw[i] * yw[i];
        b_sums[3] += aw[i] * dbw[i];
        b_sums[4] += bw[i] * dbw[i];
        b_sums[5] += dbw[i] * dbw[i];
      }
    }
    group_sum(b_sums, S);
    const float ab = b_sums[0], bb = b_sums[1], by = b_sums[2];
    const float a_db = b_sums[3], b_db = b_sums[4], dd = b_sums[5];
    bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
    float r_sums[2] = {0.0f, 0.0f};  // pass 2: χ² and Σ r·∂b from residuals
#pragma unroll
    for (int k = 0; k < n_slots; ++k) {
      const int i = kLong ? 0 : k;
      if constexpr (kLong) {
        load(k, 0);
        shape_at(0);
      }
      const float rw = yw[i] - kd * aw[i] - ks * bw[i];
      if (in_v[i]) {
        r_sums[0] += rw * rw;
        r_sums[1] += rw * dbw[i];
      }
    }
    group_sum(r_sums, S);
    chi2 = r_sums[0];
    g = -2.0f * ks * r_sums[1];
    const float det = aa * bb - ab * ab;
    const bool det_ok = det > kTiny;
    const float det_s = det_ok ? det : 1.0f;
    const float x1 = det_ok ? (bb * a_db - ab * b_db) / det_s : 0.0f;
    const float x2 = det_ok ? (aa * b_db - ab * a_db) / det_s : 0.0f;
    const float proj = dd - x1 * a_db - x2 * b_db;
    h = 2.0f * ks * ks * max_nan(proj, 0.0f);
  };

  float tc = best_t, chi2, g, h, kd, ks;
  eval_at(tc, chi2, g, h, kd, ks);
  float trust = s.trust0;
  float n_acc = 0.0f;
  for (int it = 0; it < s.iters; ++it) {
    const float step = clip_nan(-g / max_nan(h, kTiny), -trust, trust);
    const float t_new = clip_nan(tc + step, s.s_lo, s.s_hi);
    float chi2_n, g_n, h_n, kd_n, ks_n;
    eval_at(t_new, chi2_n, g_n, h_n, kd_n, ks_n);
    const bool ok = (chi2_n < chi2) && isfinite(chi2_n);
    if (ok) {
      tc = t_new;
      chi2 = chi2_n;
      g = g_n;
      h = h_n;
      kd = kd_n;
      ks = ks_n;
      trust = fminf(trust * 2.0f, s.span);
      n_acc += 1.0f;
    } else {
      trust = trust * 0.25f;
    }
  }

  if (!live || lg.lane != 0) return;
  out[t] = kd;
  out[T + t] = ks;
  out[2L * T + t] = s.use_log ? expf(tc) : tc;
  out[3L * T + t] = max_nan(chi2, 0.0f);
  out[4L * T + t] = n_acc;
  out[5L * T + t] = trust < s.conv_tol ? 2.0f : 3.0f;
  out[6L * T + t] = fabsf(g);
  out[7L * T + t] = 0.0f;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*, int,
                          int, int, GridArgs, SolveArgs);

// the instantiation for VPL = vpl views a lane in registers, or past the
// lobe's budget the long-view path's (32 lanes a texel only)
template <int L, int VPL = 1>
KernelFn kernel_for(int vpl, int lanes) {
  if constexpr (VPL > max_vpl<L>()) {
    return lanes == 32 ? varpro_kernel<L, 0> : nullptr;
  } else {
    if (vpl == VPL) return varpro_kernel<L, VPL>;
    return kernel_for<L, VPL + 1>(vpl, lanes);
  }
}

KernelFn pick_kernel(int lobe, int vpl, int lanes) {
  switch (lobe) {
    case brdf::LOBE_BLINN_PHONG:
      return kernel_for<brdf::LOBE_BLINN_PHONG>(vpl, lanes);
    case brdf::LOBE_PHONG:
      return kernel_for<brdf::LOBE_PHONG>(vpl, lanes);
    case brdf::LOBE_COOK_TORRANCE:
      return kernel_for<brdf::LOBE_COOK_TORRANCE>(vpl, lanes);
    case brdf::LOBE_WARD:
      return kernel_for<brdf::LOBE_WARD>(vpl, lanes);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" int brdf_varpro_fit(int lobe, const float* ang, const float* y, const float* w,
                               const float* sig0, float* out, int T, int V, int lanes, int vpl,
                               const float* grid_sig, const float* grid_t, int n_grid, float l0,
                               float u0, float l1, float u1, int use_log, float s_lo,
                               float s_hi, float p0_lo, float p0_hi, float span, float trust0,
                               float conv_tol, int iters, void* stream) {
  // lanes: a power of two dividing 32; vpl: ceil(V / lanes), so every lane
  // holds a view in each slot but the last
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (n_grid < 1 || n_grid > kMaxGrid || T < 1 || V < 1 || !lanes_ok || vpl < 1 ||
      static_cast<long>(vpl) * lanes < V || static_cast<long>(vpl - 1) * lanes >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(lobe, vpl, lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs grid;
  for (int i = 0; i < kMaxGrid; ++i) {
    grid.sig[i] = i < n_grid ? grid_sig[i] : 0.0f;
    grid.t[i] = i < n_grid ? grid_t[i] : 0.0f;
  }
  grid.n = n_grid;
  const SolveArgs s{l0, u0, l1, u1, s_lo, s_hi, p0_lo, p0_hi,
                    span, trust0, conv_tol, use_log, iters};
  const long threads = static_cast<long>(T) * lanes;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ang, y, w, sig0, out, T, V,
                                                                     lanes, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// What the launched instantiation gets on this card: out[0] resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at kThreads threads and no
// shared memory), out[1] registers a thread, out[2] local memory bytes a
// thread (stack and spills), out[3] threads a block.
extern "C" int brdf_varpro_occupancy(int lobe, int vpl, int lanes, int* out) {
  const KernelFn kernel = pick_kernel(lobe, vpl, lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  return 0;
}
