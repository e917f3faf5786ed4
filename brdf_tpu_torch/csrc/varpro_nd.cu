// Fused d-D VarPro solve for the m=4 and m=5 separable lobes (kernel K8): one
// texel a group of S lanes of a warp, each lane holding VPL of the texel's
// views and their per-view state in registers.
//
// Replaces brdf_tpu/ops/varpro_pallas.py::_varpro_nd_kernel (launched there by
// varpro_fit_pallas_nd). It computes what that kernel computes for
// cook_torrance_fresnel (shape (roughness, f0), d=2), ward_aniso and
// cook_torrance_aniso (shape (rough_x, rough_y, φ), d=3): an in-kernel grid of
// shape d-tuples with the closed-form box-constrained linear pair (_bvls2) at
// each point, then `iters` Kaufman-projected d×d Newton steps (damped closed-form
// solve, the step cut to a trust radius and clipped to the box, accepted if χ²
// falls); a caller start (p0) skips the grid. One inlined lobe_full<L>
// evaluation per view and step gives b and every ∂b/∂shape_j, the design
// point of the TPU kernel too.
//
// What bounds it on an H100: operations, not bytes. A texel reads (A+2)·V
// floats once (A = 4, 5 or 9 angle channels) and evaluates its lobe
// (grid + 1 + iters) times per view, each evaluation 100–200 FP32 operations
// with expf/sqrtf/sinf/cosf and divides for the anisotropic lobes.
//
// What held the first design back: one thread a texel, with every view's
// inputs, b·w and the d raw ∂b_j staged in shared memory ((A + 4 + d)·V floats
// a texel, 98–131 KB for a block of 128 texels at V=16). One or two blocks fit
// on an SM, one or two warps a scheduler, and each thread ran one long serial
// chain of lobe evaluations with nothing to hide its latency: 3–4% of the
// bound.
//
// This design (csrc/lanegroup.cuh): a texel is solved by S lanes; lane l holds
// views l, l + S, … (VPL slots, a template parameter, so the state arrays stay
// in registers under #pragma unroll). A lane loads its views' angles, w, y·w
// and a·w once from device memory (a warp's load of one slot reads S view rows
// of 32/S consecutive texels) and keeps the last evaluation's b·w and ∂b_j
// beside them; what a lobe computes from the shape alone (cos φ, sin φ) is
// computed once a point, not once a view (lobes.cuh lobe_point). There is no
// shared memory; registers set the occupancy
// (__launch_bounds__ asks for 16 warps an SM, at most 128 registers a thread),
// and a lane's VPL lobe evaluations are independent, so they overlap. Every
// view sum is a lane's partial left to right, then log2 S butterfly rounds:
// all S lanes hold the same bits, run the scalar solve (bvls2, the damped
// solve, trust radius, accept) replicated in lockstep, and lane 0 writes the
// 16 output rows. Lanes past T run on a clamped texel and only skip the write;
// a slot past V runs on a clamped view and its terms are left out by select.
// ops/varpro_nd.py::lane_layout picks (S, VPL) from V, for the wrapper and the
// plain version alike; a lane keeps at most kLaneStateFloats floats of view
// state.
//
// Past 32 lanes of that (192 views for cook_torrance_fresnel, 160 for
// ward_aniso, 128 for cook_torrance_aniso) the same kernel runs its long-view
// path (VPL = 0, one instantiation a lobe; ops/lanegroup.py::
// long_view_layout): 32 lanes a texel, lane l walking views l, l + 32, … in a
// run-time loop, each view read anew from device memory in every pass and the
// lobe evaluated in each of a Newton step's three passes. It sums in the same
// lane order, so the plain version's group_sum covers both paths, and it
// takes any V: it is the kernel at that size, not a fallback.
//
// A Newton step needs three passes over a lane's views, because the
// projection coefficients x1, x2 of the curvature come from view sums of the
// second:
//   1. the lobe, Σ a·b, b·b, b·y (then _bvls2 gives kd, ks);
//   2. the residual: χ², g_j, Σ u_j·a, u_j·b with u_j = ks·∂b_j·w;
//   3. the projected columns u_j − x1_j·a·w − x2_j·b·w: H_jk = 2 Σ col_j·col_k.
// H is never expanded into Gram terms: that form cancels in float32 (ROADMAP
// Queue C).
//
// Rounding follows lobes.cuh's rules (built with -fmad=false, reciprocals as
// torch takes them, NaN-propagating clamps and maxima as torch.clamp and
// torch.maximum), and the grid comes by value, so the kernel can be held against
// ops/varpro_nd.py::varpro_nd_rows_plain lane for lane: its view sums follow
// the same lane order and tree.
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

constexpr int kMaxGrid = 32;  // grid_points=16 gives 32 d-tuples for the aniso lobes
constexpr int kMaxShape = 3;
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;          // a block: four warps, 128 / S texels
constexpr int kMinBlocks = 4;          // 16 warps an SM: at most 128 registers a thread
constexpr int kLaneStateFloats = 64;   // view state a lane may hold (ops/varpro_nd.py)
constexpr int kGridBatch = 2;          // grid points evaluated side by side

struct GridArgs {
  float shape[kMaxGrid][kMaxShape];  // grid d-tuples (f32)
  int n;
};

struct SolveArgs {
  float l0, u0, l1, u1;                        // box of (kd, ks)
  float lo_s[kMaxShape], hi_s[kMaxShape];      // the floored shape box
  float span, trust0, conv_tol;
  int iters;
};

using brdf::bvls2;
using brdf::clip_nan;
using brdf::group_sum;
using brdf::max_nan;
using brdf::min_nan;

// the most views a lane holds: angles, w, y·w, a·w, b·w and d ∂b_j a view
template <int L, int D>
__host__ __device__ constexpr int max_vpl() {
  return kLaneStateFloats / (brdf::LobeTraits<L>::n_angles + 4 + D);
}

// upper-triangle index of (j, k), j ≤ k, in the order (0,0), (0,1), …, (d−1,d−1)
template <int D>
__host__ __device__ constexpr int hidx(int j, int k) {
  return j * D - j * (j - 1) / 2 + (k - j);
}

// solver/varpro.py::_solve_damped_sym: step = −(H + λI)⁻¹ g, d = 2 by a
// division by det, d = 3 by cofactors times 1/det
template <int D>
__device__ __forceinline__ bool solve_damped_sym(const float (&h)[D * (D + 1) / 2],
                                                 const float (&g)[D], float lam,
                                                 float (&step)[D]) {
  static_assert(D == 2 || D == 3, "K8 takes d = 2 or 3");
  if constexpr (D == 2) {
    const float h00 = h[0] + lam, h01 = h[1], h11 = h[2] + lam;
    const float det = h00 * h11 - h01 * h01;
    const bool ok = fabsf(det) > kTiny;
    const float det_s = ok ? det : 1.0f;
    step[0] = -(h11 * g[0] - h01 * g[1]) / det_s;
    step[1] = -(h00 * g[1] - h01 * g[0]) / det_s;
    return ok;
  } else {
    const float h00 = h[0] + lam, h01 = h[1], h02 = h[2];
    const float h11 = h[3] + lam, h12 = h[4], h22 = h[5] + lam;
    const float c00 = h11 * h22 - h12 * h12;
    const float c01 = h02 * h12 - h01 * h22;
    const float c02 = h01 * h12 - h02 * h11;
    const float c11 = h00 * h22 - h02 * h02;
    const float c12 = h01 * h02 - h00 * h12;
    const float c22 = h00 * h11 - h01 * h01;
    const float det = h00 * c00 + h01 * c01 + h02 * c02;
    const bool ok = fabsf(det) > kTiny;
    const float inv = ok ? 1.0f / det : 0.0f;
    step[0] = -(c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv;
    step[1] = -(c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv;
    step[2] = -(c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv;
    return ok;
  }
}

// VPL > 0: a lane holds VPL views in registers (the register layouts of
// lane_layout). VPL = 0: the long-view path, past the register layouts: 32
// lanes a texel, lane l walking views l, l + 32, … (⌈V / 32⌉ of them, a
// run-time count), each read anew from device memory into slot 0 in every
// pass; passes 2 and 3 evaluate the lobe again where the register path reads
// b·w and ∂b_j kept from pass 1, with the same operations, so both paths give
// the bits of the plain version's sum order.
template <int L, int D, int VPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
varpro_nd_kernel(const float* __restrict__ ang,   // (A, V, T)
                 const float* __restrict__ y,     // (V, T)
                 const float* __restrict__ w,     // (V, T)
                 const float* __restrict__ p0,    // (m, T) caller start, or null
                 float* __restrict__ out,         // (16, T)
                 int T, int V, int S, GridArgs grid, SolveArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int NP = brdf::LobeTraits<L>::n_params;
  constexpr int NH = D * (D + 1) / 2;
  static_assert(NP == D + 2, "a separable lobe: kd, ks and d shape parameters");
  static_assert(VPL >= 0 && VPL <= max_vpl<L, D>(), "a lane's view state fits its budget");
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
  float av[kSlots][A], wv[kSlots], yw[kSlots], aw[kSlots], bw[kSlots], db[kSlots][D];
  bool in_v[kSlots];
  float p[NP];
  p[0] = 0.0f;
  p[1] = 1.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) p[2 + j] = grid.shape[0][j];

  const brdf::LobePoint pt0 = brdf::lobe_point<L>(p);
  float p_a[NP];  // the start point: a·w of a view read again (long-view path)
#pragma unroll
  for (int j = 0; j < NP; ++j) p_a[j] = p[j];
  // slot k's view into slot i: angles, w, y·w and a·w (the diffuse basis is
  // shape-independent for every separable lobe)
  auto load = [&](int k, int i) {
    const int v = k * S + lg.lane;
    in_v[i] = v < V;
    const long gi = static_cast<long>(in_v[i] ? v : V - 1) * T + t;
#pragma unroll
    for (int a = 0; a < A; ++a) av[i][a] = ang[a * vt + gi];
    wv[i] = w[gi];
    yw[i] = y[gi] * wv[i];
    aw[i] = brdf::lobe_full<L>(av[i], p_a, pt0).dp[0] * wv[i];
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

  float shape[D];
  if (p0 != nullptr) {
#pragma unroll
    for (int j = 0; j < D; ++j) shape[j] = clip_nan(p0[(2L + j) * T + t], s.lo_s[j], s.hi_s[j]);
  } else {
    // grid init: the Gram-form cost only ranks the points. kGridBatch points
    // at a time, so that their lobe evaluations, sums and solves overlap; they
    // are compared in the grid's order, as one at a time would be.
#pragma unroll
    for (int j = 0; j < D; ++j) shape[j] = grid.shape[0][j];
    float best_cost = INFINITY;
    for (int g0 = 0; g0 < grid.n; g0 += kGridBatch) {
      float b_sums[3 * kGridBatch];  // per point: Σ a·b, b·b, b·y
#pragma unroll
      for (int i = 0; i < 3 * kGridBatch; ++i) b_sums[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < kGridBatch; ++q) {
        const int gi = min(g0 + q, grid.n - 1);  // past the last point: a copy, never compared
        float pq[NP];
        pq[0] = 0.0f;
        pq[1] = 1.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) pq[2 + j] = grid.shape[gi][j];
        const brdf::LobePoint pt = brdf::lobe_point<L>(pq);
#pragma unroll
        for (int k = 0; k < n_slots; ++k) {
          const int i = kLong ? 0 : k;
          if constexpr (kLong) load(k, 0);
          const float bwk = brdf::lobe_full<L>(av[i], pq, pt).i * wv[i];
          if (in_v[i]) {
            b_sums[3 * q] += aw[i] * bwk;
            b_sums[3 * q + 1] += bwk * bwk;
            b_sums[3 * q + 2] += bwk * yw[i];
          }
        }
      }
      group_sum(b_sums, S);
#pragma unroll
      for (int q = 0; q < kGridBatch; ++q) {
        const float ab = b_sums[3 * q], bb = b_sums[3 * q + 1], by = b_sums[3 * q + 2];
        float kd, ks;
        bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
        const float cost = kd * kd * aa + ks * ks * bb + 2.0f * kd * ks * ab -
                           2.0f * (kd * ay + ks * by);
        if (g0 + q < grid.n && cost < best_cost) {
#pragma unroll
          for (int j = 0; j < D; ++j) shape[j] = grid.shape[g0 + q][j];
          best_cost = cost;
        }
      }
    }
  }

  // profiled χ², gradient, projected Gauss-Newton curvature (upper triangle),
  // kd and ks at the shape point sh
  auto eval_at = [&](const float (&sh)[D], float& chi2, float (&g)[D], float (&h)[NH],
                     float& kd, float& ks) {
#pragma unroll
    for (int j = 0; j < D; ++j) p[2 + j] = sh[j];
    const brdf::LobePoint pt = brdf::lobe_point<L>(p);
    // slot i's lobe at p: b·w and the ∂b_j
    auto lobe_at = [&](int i) {
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(av[i], p, pt);
      bw[i] = o.i * wv[i];
#pragma unroll
      for (int j = 0; j < D; ++j) db[i][j] = o.dp[2 + j];
    };
    float b_sums[3] = {0.0f, 0.0f, 0.0f};  // pass 1: the lobe and the Gram sums of b
#pragma unroll
    for (int k = 0; k < n_slots; ++k) {
      const int i = kLong ? 0 : k;
      if constexpr (kLong) load(k, 0);
      lobe_at(i);
      if (in_v[i]) {
        b_sums[0] += aw[i] * bw[i];
        b_sums[1] += bw[i] * bw[i];
        b_sums[2] += bw[i] * yw[i];
      }
    }
    group_sum(b_sums, S);
    const float ab = b_sums[0], bb = b_sums[1], by = b_sums[2];
    bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
    // pass 2: χ², then per shape dimension Σ r·u_j, Σ u_j·a, Σ u_j·b
    float r_sums[1 + 3 * D];
#pragma unroll
    for (int i = 0; i < 1 + 3 * D; ++i) r_sums[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < n_slots; ++k) {
      const int i = kLong ? 0 : k;
      if constexpr (kLong) {
        load(k, 0);
        lobe_at(0);
      }
      const float rw = yw[i] - kd * aw[i] - ks * bw[i];
      if (in_v[i]) r_sums[0] += rw * rw;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float u = ks * db[i][j] * wv[i];
        if (in_v[i]) {
          r_sums[1 + j] += rw * u;
          r_sums[1 + D + j] += u * aw[i];
          r_sums[1 + 2 * D + j] += u * bw[i];
        }
      }
    }
    group_sum(r_sums, S);
    chi2 = r_sums[0];
    const float det = aa * bb - ab * ab;
    const bool det_ok = det > kTiny;
    const float det_s = det_ok ? det : 1.0f;
    float x1[D], x2[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float ua = r_sums[1 + D + j], ub = r_sums[1 + 2 * D + j];
      g[j] = -2.0f * r_sums[1 + j];
      x1[j] = det_ok ? (bb * ua - ab * ub) / det_s : 0.0f;
      x2[j] = det_ok ? (aa * ub - ab * ua) / det_s : 0.0f;
    }
    float hs[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) hs[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < n_slots; ++k) {  // pass 3: the projected columns
      const int i = kLong ? 0 : k;
      if constexpr (kLong) {
        load(k, 0);
        lobe_at(0);
      }
      float col[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float u = ks * db[i][j] * wv[i];
        col[j] = u - x1[j] * aw[i] - x2[j] * bw[i];
      }
      if (in_v[i]) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
#pragma unroll
          for (int c = j; c < D; ++c) hs[hidx<D>(j, c)] += col[j] * col[c];
        }
      }
    }
    group_sum(hs, S);
#pragma unroll
    for (int i = 0; i < NH; ++i) h[i] = 2.0f * hs[i];
  };

  float chi2, g[D], h[NH], kd, ks;
  eval_at(shape, chi2, g, h, kd, ks);
  float trust = s.trust0;
  float n_acc = 0.0f;
  for (int it = 0; it < s.iters; ++it) {
    float hdiag = h[hidx<D>(0, 0)];
#pragma unroll
    for (int j = 1; j < D; ++j) hdiag = hdiag + h[hidx<D>(j, j)];
    const float lam = 1e-6f * hdiag + kTiny;
    float step[D];
    const bool ok_h = solve_damped_sym<D>(h, g, lam, step);
    float nrm2 = step[0] * step[0];
#pragma unroll
    for (int j = 1; j < D; ++j) nrm2 = nrm2 + step[j] * step[j];
    const float nrm = sqrtf(max_nan(nrm2, kTiny));
    const float scale = ok_h ? min_nan(trust / nrm, 1.0f) : 0.0f;
    float shape_n[D];
#pragma unroll
    for (int j = 0; j < D; ++j) shape_n[j] = clip_nan(shape[j] + step[j] * scale, s.lo_s[j], s.hi_s[j]);
    float chi2_n, g_n[D], h_n[NH], kd_n, ks_n;
    eval_at(shape_n, chi2_n, g_n, h_n, kd_n, ks_n);
    const bool ok = (chi2_n < chi2) && isfinite(chi2_n);
    if (ok) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        shape[j] = shape_n[j];
        g[j] = g_n[j];
      }
#pragma unroll
      for (int i = 0; i < NH; ++i) h[i] = h_n[i];
      chi2 = chi2_n;
      kd = kd_n;
      ks = ks_n;
      trust = fminf(trust * 2.0f, s.span);
      n_acc += 1.0f;
    } else {
      trust = trust * 0.25f;
    }
  }

  if (!live || lg.lane != 0) return;
  float g_abs = fabsf(g[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) g_abs = max_nan(g_abs, fabsf(g[j]));
  out[t] = kd;
  out[T + t] = ks;
#pragma unroll
  for (int j = 0; j < D; ++j) out[(2L + j) * T + t] = shape[j];
  out[(2L + D) * T + t] = max_nan(chi2, 0.0f);
  out[(3L + D) * T + t] = n_acc;
  out[(4L + D) * T + t] = trust < s.conv_tol ? 2.0f : 3.0f;
  out[(5L + D) * T + t] = g_abs;
  for (int r = 6 + D; r < 16; ++r) out[static_cast<long>(r) * T + t] = 0.0f;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*, int,
                          int, int, GridArgs, SolveArgs);

// the instantiation for VPL = vpl views a lane in registers, or past the
// lobe's budget the long-view path's (32 lanes a texel only)
template <int L, int D, int VPL = 1>
KernelFn kernel_for(int vpl, int lanes) {
  if constexpr (VPL > max_vpl<L, D>()) {
    return lanes == 32 ? varpro_nd_kernel<L, D, 0> : nullptr;
  } else {
    if (vpl == VPL) return varpro_nd_kernel<L, D, VPL>;
    return kernel_for<L, D, VPL + 1>(vpl, lanes);
  }
}

KernelFn pick_kernel(int lobe, int d, int vpl, int lanes) {
  switch (lobe) {
    case brdf::LOBE_COOK_TORRANCE_FRESNEL:
      return d == 2 ? kernel_for<brdf::LOBE_COOK_TORRANCE_FRESNEL, 2>(vpl, lanes) : nullptr;
    case brdf::LOBE_WARD_ANISO:
      return d == 3 ? kernel_for<brdf::LOBE_WARD_ANISO, 3>(vpl, lanes) : nullptr;
    case brdf::LOBE_COOK_TORRANCE_ANISO:
      return d == 3 ? kernel_for<brdf::LOBE_COOK_TORRANCE_ANISO, 3>(vpl, lanes) : nullptr;
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" int brdf_varpro_nd_fit(int lobe, const float* ang, const float* y, const float* w,
                                  const float* p0, float* out, int T, int V, int lanes,
                                  int vpl, const float* grid_shape, int n_grid, int d,
                                  float l0, float u0, float l1, float u1, const float* lo_s,
                                  const float* hi_s, float span, float trust0, float conv_tol,
                                  int iters, void* stream) {
  // lanes: a power of two dividing 32; vpl: ceil(V / lanes), so every lane
  // holds a view in each slot but the last
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (n_grid < 1 || n_grid > kMaxGrid || d < 2 || d > kMaxShape || T < 1 || V < 1 || !lanes_ok ||
      vpl < 1 || static_cast<long>(vpl) * lanes < V || static_cast<long>(vpl - 1) * lanes >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(lobe, d, vpl, lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs grid;
  for (int i = 0; i < kMaxGrid; ++i)
    for (int j = 0; j < kMaxShape; ++j)
      grid.shape[i][j] = (i < n_grid && j < d) ? grid_shape[i * d + j] : 0.0f;
  grid.n = n_grid;
  SolveArgs s;
  s.l0 = l0;
  s.u0 = u0;
  s.l1 = l1;
  s.u1 = u1;
  for (int j = 0; j < kMaxShape; ++j) {
    s.lo_s[j] = j < d ? lo_s[j] : 0.0f;
    s.hi_s[j] = j < d ? hi_s[j] : 0.0f;
  }
  s.span = span;
  s.trust0 = trust0;
  s.conv_tol = conv_tol;
  s.iters = iters;
  const long threads = static_cast<long>(T) * lanes;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ang, y, w, p0, out, T, V,
                                                                     lanes, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// What the launched instantiation gets on this card: out[0] resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at kThreads threads and no
// shared memory), out[1] registers a thread, out[2] local memory bytes a
// thread (stack and spills), out[3] threads a block.
extern "C" int brdf_varpro_nd_occupancy(int lobe, int d, int vpl, int lanes, int* out) {
  const KernelFn kernel = pick_kernel(lobe, d, vpl, lanes);
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
