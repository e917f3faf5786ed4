// Fused d-D VarPro solve for the m=4 and m=5 separable lobes, one thread per
// texel (kernel K8).
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
// with expf/sqrtf/sinf/cosf and divides for the anisotropic lobes. So, as in
// K1, a block stages its texels' inputs in shared memory once (layout
// [channel][view][texel]: the 32 threads of a warp touch 32 consecutive words,
// coalesced loads and no bank conflicts) and solves from shared memory and
// registers until the 16 output rows. Each thread reads only its own texel's
// column, so the kernel needs no barrier.
//
// A Newton step needs three passes over the views, because the projection
// coefficients x1, x2 of the curvature come from view sums of the second:
//   1. the lobe, Σ a·b, b·b, b·y (then _bvls2 gives kd, ks);
//   2. the residual: χ², g_j, Σ u_j·a, u_j·b with u_j = ks·∂b_j·w;
//   3. the projected columns u_j − x1_j·a·w − x2_j·b·w: H_jk = 2 Σ col_j·col_k.
// H is never expanded into Gram terms: that form cancels in float32 (ROADMAP
// Queue C). Passes 2 and 3 need b and ∂b_j per view. Staging them (b·w and
// the d raw ∂b_j, beside the angles, w, y·w and a·w: A + 4 + d floats a view
// and texel, 16 for cook_torrance_aniso, 131 KB for 128 texels at V=16) was
// chosen over evaluating the lobe again in passes 2 and 3, which would triple
// the work of an operation-bound kernel; the price is occupancy, and the block
// shrinks to 32 texels before the wrapper (ops/varpro_nd.py::block_size)
// raises for too many views. There is no fallback.
//
// Rounding follows lobes.cuh's rules, so the kernel can be held against
// ops/varpro_nd.py::varpro_nd_rows_plain lane for lane: view sums run left to
// right from 0, Python's sums over shape dimensions run left to right, clamps
// and maxima propagate NaN as torch.clamp and torch.maximum do.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "bvls2.cuh"
#include "lobes.cuh"

namespace {

constexpr int kMaxGrid = 32;  // grid_points=16 gives 32 d-tuples for the aniso lobes
constexpr int kMaxShape = 3;
constexpr float kTiny = 1e-30f;

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
using brdf::max_nan;
using brdf::min_nan;

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

template <int L, int D>
__global__ void __launch_bounds__(128)
varpro_nd_kernel(const float* __restrict__ ang,   // (A, V, T)
                 const float* __restrict__ y,     // (V, T)
                 const float* __restrict__ w,     // (V, T)
                 const float* __restrict__ p0,    // (m, T) caller start, or null
                 float* __restrict__ out,         // (16, T)
                 int T, int V, GridArgs grid, SolveArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int NP = brdf::LobeTraits<L>::n_params;
  constexpr int NH = D * (D + 1) / 2;
  static_assert(NP == D + 2, "a separable lobe: kd, ks and d shape parameters");
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const long t = static_cast<long>(blockIdx.x) * tb + tid;
  if (t >= T) return;  // ragged edge: masked, never written

  // [channel][view][texel]; each thread owns one texel column
  float* s_ang = smem;                 // A·V·tb
  float* s_w = s_ang + A * V * tb;     // w
  float* s_yw = s_w + V * tb;          // y·w
  float* s_aw = s_yw + V * tb;         // a·w (shape-free diffuse basis)
  float* s_bw = s_aw + V * tb;         // b·w of the last evaluation
  float* s_db = s_bw + V * tb;         // D · ∂b/∂shape_j of the last evaluation

  float av[A];
  float p[NP];
  p[0] = 0.0f;
  p[1] = 1.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) p[2 + j] = grid.shape[0][j];

  float aa = 0.0f, ay = 0.0f;
  for (int v = 0; v < V; ++v) {
    const long gi = static_cast<long>(v) * T + t;
    const int sv = v * tb + tid;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      av[a] = ang[static_cast<long>(a) * V * T + gi];
      s_ang[a * V * tb + sv] = av[a];
    }
    const float wv = w[gi];
    const float ywv = y[gi] * wv;
    // the diffuse basis is shape-independent for every separable lobe
    const float aw = brdf::lobe_full<L>(av, p).dp[0] * wv;
    s_w[sv] = wv;
    s_yw[sv] = ywv;
    s_aw[sv] = aw;
    aa += aw * aw;
    ay += aw * ywv;
  }

  auto load_angles = [&](int v) {
#pragma unroll
    for (int a = 0; a < A; ++a) av[a] = s_ang[a * V * tb + v * tb + tid];
  };

  float shape[D];
  if (p0 != nullptr) {
#pragma unroll
    for (int j = 0; j < D; ++j) shape[j] = clip_nan(p0[(2L + j) * T + t], s.lo_s[j], s.hi_s[j]);
  } else {
    // grid init: the Gram-form cost only ranks the points
#pragma unroll
    for (int j = 0; j < D; ++j) shape[j] = grid.shape[0][j];
    float best_cost = INFINITY;
    for (int gi = 0; gi < grid.n; ++gi) {
#pragma unroll
      for (int j = 0; j < D; ++j) p[2 + j] = grid.shape[gi][j];
      float ab = 0.0f, bb = 0.0f, by = 0.0f;
      for (int v = 0; v < V; ++v) {
        load_angles(v);
        const int sv = v * tb + tid;
        const float bw = brdf::lobe_full<L>(av, p).i * s_w[sv];
        ab += s_aw[sv] * bw;
        bb += bw * bw;
        by += bw * s_yw[sv];
      }
      float kd, ks;
      bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
      const float cost = kd * kd * aa + ks * ks * bb + 2.0f * kd * ks * ab -
                         2.0f * (kd * ay + ks * by);
      if (cost < best_cost) {
#pragma unroll
        for (int j = 0; j < D; ++j) shape[j] = grid.shape[gi][j];
        best_cost = cost;
      }
    }
  }

  // profiled χ², gradient, projected Gauss-Newton curvature (upper triangle),
  // kd and ks at the shape point sh
  auto eval_at = [&](const float (&sh)[D], float& chi2, float (&g)[D], float (&h)[NH],
                     float& kd, float& ks) {
#pragma unroll
    for (int j = 0; j < D; ++j) p[2 + j] = sh[j];
    float ab = 0.0f, bb = 0.0f, by = 0.0f;
    for (int v = 0; v < V; ++v) {  // pass 1: the lobe and the Gram sums of b
      load_angles(v);
      const int sv = v * tb + tid;
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
      const float bw = o.i * s_w[sv];
      s_bw[sv] = bw;
#pragma unroll
      for (int j = 0; j < D; ++j) s_db[j * V * tb + sv] = o.dp[2 + j];
      ab += s_aw[sv] * bw;
      bb += bw * bw;
      by += bw * s_yw[sv];
    }
    bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
    float c2 = 0.0f, gs[D], ua[D], ub[D];
#pragma unroll
    for (int j = 0; j < D; ++j) gs[j] = ua[j] = ub[j] = 0.0f;
    for (int v = 0; v < V; ++v) {  // pass 2: the residual and the projections' sums
      const int sv = v * tb + tid;
      const float wv = s_w[sv], aw = s_aw[sv], bw = s_bw[sv];
      const float rw = s_yw[sv] - kd * aw - ks * bw;
      c2 += rw * rw;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float u = ks * s_db[j * V * tb + sv] * wv;
        gs[j] += rw * u;
        ua[j] += u * aw;
        ub[j] += u * bw;
      }
    }
    chi2 = c2;
    const float det = aa * bb - ab * ab;
    const bool det_ok = det > kTiny;
    const float det_s = det_ok ? det : 1.0f;
    float x1[D], x2[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      g[j] = -2.0f * gs[j];
      x1[j] = det_ok ? (bb * ua[j] - ab * ub[j]) / det_s : 0.0f;
      x2[j] = det_ok ? (aa * ub[j] - ab * ua[j]) / det_s : 0.0f;
    }
    float hs[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) hs[i] = 0.0f;
    for (int v = 0; v < V; ++v) {  // pass 3: the projected columns
      const int sv = v * tb + tid;
      const float wv = s_w[sv], aw = s_aw[sv], bw = s_bw[sv];
      float col[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float u = ks * s_db[j * V * tb + sv] * wv;
        col[j] = u - x1[j] * aw - x2[j] * bw;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int k = j; k < D; ++k) hs[hidx<D>(j, k)] += col[j] * col[k];
      }
    }
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

template <int L, int D>
int launch(const float* ang, const float* y, const float* w, const float* p0, float* out,
           int T, int V, int block_t, int smem_bytes, const GridArgs& grid, const SolveArgs& s,
           cudaStream_t stream) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  if (smem_bytes != (A + 4 + D) * V * block_t * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      varpro_nd_kernel<L, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + block_t - 1) / block_t;
  varpro_nd_kernel<L, D><<<blocks, block_t, smem_bytes, stream>>>(ang, y, w, p0, out, T, V,
                                                                  grid, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brdf_varpro_nd_fit(int lobe, const float* ang, const float* y, const float* w,
                                  const float* p0, float* out, int T, int V, int block_t,
                                  int smem_bytes, const float* grid_shape, int n_grid, int d,
                                  float l0, float u0, float l1, float u1, const float* lo_s,
                                  const float* hi_s, float span, float trust0, float conv_tol,
                                  int iters, void* stream) {
  if (n_grid < 1 || n_grid > kMaxGrid || d < 2 || d > kMaxShape || block_t < 32 ||
      block_t > 128 || block_t % 32)
    return static_cast<int>(cudaErrorInvalidValue);
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
  auto st = static_cast<cudaStream_t>(stream);
  switch (lobe) {
    case brdf::LOBE_COOK_TORRANCE_FRESNEL:
      if (d != 2) return static_cast<int>(cudaErrorInvalidValue);
      return launch<brdf::LOBE_COOK_TORRANCE_FRESNEL, 2>(ang, y, w, p0, out, T, V, block_t,
                                                         smem_bytes, grid, s, st);
    case brdf::LOBE_WARD_ANISO:
      if (d != 3) return static_cast<int>(cudaErrorInvalidValue);
      return launch<brdf::LOBE_WARD_ANISO, 3>(ang, y, w, p0, out, T, V, block_t, smem_bytes,
                                              grid, s, st);
    case brdf::LOBE_COOK_TORRANCE_ANISO:
      if (d != 3) return static_cast<int>(cudaErrorInvalidValue);
      return launch<brdf::LOBE_COOK_TORRANCE_ANISO, 3>(ang, y, w, p0, out, T, V, block_t,
                                                       smem_bytes, grid, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
