// Fused VarPro solve for the separable lobes, one thread per texel (kernel K1).
//
// Replaces brdf_tpu/ops/varpro_pallas.py::_varpro_kernel (launched there by
// varpro_fit_pallas). It computes what that kernel computes: an in-kernel
// shape grid with the closed-form box-constrained linear pair (_bvls2) at
// each point, then `iters` profiled Newton steps in log σ (exponent) or σ
// (roughness) with Kaufman's projected curvature and a trust-clipped
// accept-if-better step; a caller start (sig0) skips the grid.
//
// What bounds it on an H100: not bytes. Each texel reads (A+2)·V floats once
// (≈34 MB at T=131072, V=16) but evaluates its lobe (grid + 1 + iters) times
// per view, each evaluation a handful of expf/logf/sqrtf and divides, so it is
// bound by FP32 and special-function issue. The design keeps every input in
// device memory exactly once: a block stages its texels' angles, weights and
// weighted targets in shared memory (layout [channel][view][texel], so the 32
// threads of a warp touch 32 consecutive words: coalesced loads, no bank
// conflicts), and the whole solve then runs from shared memory and registers
// with no further device-memory traffic until the 8 output rows. Each thread
// reads only its own texel's column, so the kernel needs no barrier.
//
// χ² is formed from residuals in a second pass over the views (the Gram
// identity's f32 cancellation floors χ² and breaks the accept test); the
// first pass keeps w·b and w·∂b in shared memory for it.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "bvls2.cuh"
#include "lobes.cuh"

namespace {

constexpr int kMaxGrid = 16;
constexpr float kTiny = 1e-30f;

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

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  // jnp.clip order (max, then min); NaN handling is not relied upon
  return fminf(fmaxf(x, lo), hi);
}

template <int L>
__global__ void __launch_bounds__(128)
varpro_kernel(const float* __restrict__ ang,   // (A, V, T)
              const float* __restrict__ y,     // (V, T)
              const float* __restrict__ w,     // (V, T)
              const float* __restrict__ sig0,  // (T,) caller σ start, or null
              float* __restrict__ out,         // (8, T)
              int T, int V, GridArgs grid, SolveArgs s) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  extern __shared__ float smem[];
  const int tb = blockDim.x;
  const int tid = threadIdx.x;
  const long t = static_cast<long>(blockIdx.x) * tb + tid;
  if (t >= T) return;  // ragged edge: masked, never written

  // [channel][view][texel]; each thread owns one texel column
  float* s_ang = smem;                 // A·V·tb
  float* s_w = s_ang + A * V * tb;     // w
  float* s_yw = s_w + V * tb;          // y·w
  float* s_aw = s_yw + V * tb;         // a·w (σ-free diffuse basis)
  float* s_bw = s_aw + V * tb;         // b·w of the last evaluation
  float* s_dbw = s_bw + V * tb;        // ∂b/∂t·w of the last evaluation

  float av[A];
  float aa = 0.0f, ay = 0.0f;
  for (int v = 0; v < V; ++v) {
    const long g = static_cast<long>(v) * T + t;
    const int sv = v * tb + tid;
    for (int a = 0; a < A; ++a) {
      av[a] = ang[static_cast<long>(a) * V * T + g];
      s_ang[a * V * tb + sv] = av[a];
    }
    const float wv = w[g];
    const float ywv = y[g] * wv;
    // the diffuse basis is σ-independent for every separable lobe
    const float aw = brdf::lobe_full<L>(av, 0.0f, 1.0f, grid.sig[0]).dp[0] * wv;
    s_w[sv] = wv;
    s_yw[sv] = ywv;
    s_aw[sv] = aw;
    aa += aw * aw;
    ay += aw * ywv;
  }

  auto load_angles = [&](int v) {
    for (int a = 0; a < A; ++a) av[a] = s_ang[a * V * tb + v * tb + tid];
  };

  float best_t;
  if (sig0 != nullptr) {
    const float s0 = clipf(sig0[t], s.p0_lo, s.p0_hi);
    best_t = s.use_log ? logf(s0) : s0;
  } else {
    // grid init: the Gram-form cost only ranks the points
    best_t = grid.t[0];
    float best_cost = INFINITY;
    for (int gi = 0; gi < grid.n; ++gi) {
      const float sig = grid.sig[gi];
      float ab = 0.0f, bb = 0.0f, by = 0.0f;
      for (int v = 0; v < V; ++v) {
        load_angles(v);
        const int sv = v * tb + tid;
        const float bw = brdf::lobe_full<L>(av, 0.0f, 1.0f, sig).i * s_w[sv];
        ab += s_aw[sv] * bw;
        bb += bw * bw;
        by += bw * s_yw[sv];
      }
      float kd, ks;
      brdf::bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
      const float cost = kd * kd * aa + ks * ks * bb + 2.0f * kd * ks * ab -
                         2.0f * (kd * ay + ks * by);
      if (cost < best_cost) {
        best_t = grid.t[gi];
        best_cost = cost;
      }
    }
  }

  // profiled objective, gradient and projected curvature at coordinate tv
  auto eval_at = [&](float tv, float& chi2, float& g, float& h, float& kd, float& ks) {
    const float sig = s.use_log ? expf(tv) : tv;
    float ab = 0.0f, bb = 0.0f, by = 0.0f, a_db = 0.0f, b_db = 0.0f, dd = 0.0f;
    for (int v = 0; v < V; ++v) {
      load_angles(v);
      const int sv = v * tb + tid;
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, 0.0f, 1.0f, sig);
      const float db_t = s.use_log ? o.dp[2] * sig : o.dp[2];
      const float wv = s_w[sv];
      const float aw = s_aw[sv];
      const float bw = o.i * wv;
      const float dbw = db_t * wv;
      s_bw[sv] = bw;
      s_dbw[sv] = dbw;
      ab += aw * bw;
      bb += bw * bw;
      by += bw * s_yw[sv];
      a_db += aw * dbw;
      b_db += bw * dbw;
      dd += dbw * dbw;
    }
    brdf::bvls2(aa, ab, bb, ay, by, s.l0, s.u0, s.l1, s.u1, kd, ks);
    float c2 = 0.0f, gs = 0.0f;
    for (int v = 0; v < V; ++v) {
      const int sv = v * tb + tid;
      const float rw = s_yw[sv] - kd * s_aw[sv] - ks * s_bw[sv];
      c2 += rw * rw;
      gs += rw * s_dbw[sv];
    }
    chi2 = c2;
    g = -2.0f * ks * gs;
    const float det = aa * bb - ab * ab;
    const bool det_ok = det > kTiny;
    const float det_s = det_ok ? det : 1.0f;
    const float x1 = det_ok ? (bb * a_db - ab * b_db) / det_s : 0.0f;
    const float x2 = det_ok ? (aa * b_db - ab * a_db) / det_s : 0.0f;
    const float proj = dd - x1 * a_db - x2 * b_db;
    h = 2.0f * ks * ks * fmaxf(proj, 0.0f);
  };

  float tc = best_t, chi2, g, h, kd, ks;
  eval_at(tc, chi2, g, h, kd, ks);
  float trust = s.trust0;
  float n_acc = 0.0f;
  for (int it = 0; it < s.iters; ++it) {
    const float step = clipf(-g / fmaxf(h, kTiny), -trust, trust);
    const float t_new = clipf(tc + step, s.s_lo, s.s_hi);
    float chi2_n, g_n, h_n, kd_n, ks_n;
    eval_at(t_new, chi2_n, g_n, h_n, kd_n, ks_n);
    const bool ok = (chi2_n < chi2) && isfinite(chi2_n);
    if (ok) {
      tc = t_new; chi2 = chi2_n; g = g_n; h = h_n; kd = kd_n; ks = ks_n;
      trust = fminf(trust * 2.0f, s.span);
      n_acc += 1.0f;
    } else {
      trust = trust * 0.25f;
    }
  }

  out[t] = kd;
  out[T + t] = ks;
  out[2L * T + t] = s.use_log ? expf(tc) : tc;
  out[3L * T + t] = chi2 < 0.0f ? 0.0f : chi2;
  out[4L * T + t] = n_acc;
  out[5L * T + t] = trust < s.conv_tol ? 2.0f : 3.0f;
  out[6L * T + t] = fabsf(g);
  out[7L * T + t] = 0.0f;
}

template <int L>
int launch(const float* ang, const float* y, const float* w, const float* sig0, float* out,
           int T, int V, int block_t, int smem_bytes, const GridArgs& grid,
           const SolveArgs& s, cudaStream_t stream) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  if (smem_bytes != (A + 5) * V * block_t * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      varpro_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (T + block_t - 1) / block_t;
  varpro_kernel<L><<<blocks, block_t, smem_bytes, stream>>>(ang, y, w, sig0, out, T, V,
                                                            grid, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brdf_varpro_fit(int lobe, const float* ang, const float* y, const float* w,
                               const float* sig0, float* out, int T, int V, int block_t,
                               int smem_bytes, const float* grid_sig, const float* grid_t,
                               int n_grid, float l0, float u0, float l1, float u1,
                               int use_log, float s_lo, float s_hi, float p0_lo,
                               float p0_hi, float span, float trust0, float conv_tol,
                               int iters, void* stream) {
  if (n_grid < 1 || n_grid > kMaxGrid || block_t < 32 || block_t > 128 || block_t % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  GridArgs grid;
  for (int i = 0; i < kMaxGrid; ++i) {
    grid.sig[i] = i < n_grid ? grid_sig[i] : 0.0f;
    grid.t[i] = i < n_grid ? grid_t[i] : 0.0f;
  }
  grid.n = n_grid;
  const SolveArgs s{l0, u0, l1, u1, s_lo, s_hi, p0_lo, p0_hi,
                    span, trust0, conv_tol, use_log, iters};
  auto st = static_cast<cudaStream_t>(stream);
  switch (lobe) {
    case brdf::LOBE_BLINN_PHONG:
      return launch<brdf::LOBE_BLINN_PHONG>(ang, y, w, sig0, out, T, V, block_t, smem_bytes,
                                            grid, s, st);
    case brdf::LOBE_PHONG:
      return launch<brdf::LOBE_PHONG>(ang, y, w, sig0, out, T, V, block_t, smem_bytes, grid,
                                      s, st);
    case brdf::LOBE_COOK_TORRANCE:
      return launch<brdf::LOBE_COOK_TORRANCE>(ang, y, w, sig0, out, T, V, block_t,
                                              smem_bytes, grid, s, st);
    case brdf::LOBE_WARD:
      return launch<brdf::LOBE_WARD>(ang, y, w, sig0, out, T, V, block_t, smem_bytes, grid,
                                     s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
