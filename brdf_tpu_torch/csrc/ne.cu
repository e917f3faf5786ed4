// Per-texel normal equations of a lobe fit over the view axis: kernel K6.
//
// Replaces brdf_tpu/ops/lm_pallas.py::_ne_kernel (launched there by _ne_call,
// behind lm_fit_pallas_chunked and shading_value_and_grad_pallas). For any of
// the ten lobes (m = 1..5 parameters) and per texel it accumulates over all V
// views, in one of three modes:
//
//   chi2   row 0:            chi2 = sum_v (w (I - y))^2
//   grad   rows 0, 1..m:     chi2, then g_j = sum_v dI/dp_j * w^2 (I - y)
//   full   rows 0, 1..P, ..: chi2, the P = m(m+1)/2 upper-triangle entries
//                            sum_v dI/dp_j dI/dp_k w^2 in (j, k) order, j <= k,
//                            then the m rows of g
//
// with a variant that takes no weights at all (one (V, T) read fewer).
// Inputs are views-major: angles (A, V, T), y and w (V, T), parameters (m, T);
// the output is (R, T), R = 1, 1 + m or 1 + P + m.
//
// Designed for this card, not carried over from the TPU grid: there the grid
// is (texel block, view chunk) and the output block is an accumulator that
// every chunk revisits, because one chunk has to fit the fast memory. Here one
// thread owns one texel, walks all V views (consecutive threads read
// consecutive addresses), keeps its R sums in registers and writes each once.
// The view count is unbounded by construction, nothing is staged in shared
// memory because nothing is read twice, and neither T, V nor the parameter
// rows are padded: the kernel bound-checks and indexes with 64 bits.
//
// The mode and the lobe are template parameters: the chi2 kernel never
// computes a partial (lobe_full<L> is inlined and its unused outputs are dead
// code), and the grad kernel no product of two partials.
//
// What bounds it on an H100: bytes. It reads (A V + V [+ V] + m) T floats and
// writes R T, against a few dozen to a few hundred operations a pair. Its
// parallelism is T threads, not V T: at a small T and a large V most of the
// card stands idle. That is the price of sums that run left to right from zero
// with no atomics, which (with -fmad=false) lets the kernel be held to equality
// with ops/ne.py::ne_rows_plain.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "lobes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kModeChi2 = 0, kModeGrad = 1, kModeFull = 2;

template <int L, int MODE, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
ne_kernel(const float* __restrict__ ang,     // (A, V, T)
          const float* __restrict__ y,       // (V, T)
          const float* __restrict__ w,       // (V, T), not read unless WEIGHTED
          const float* __restrict__ params,  // (m, T)
          float* __restrict__ out,           // (R, T)
          int T, int V) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  constexpr int P = M * (M + 1) / 2;
  const long n = static_cast<long>(V) * T;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;

  float av[A], p[M];
  float chi2 = 0.0f;
  float a_acc[P], g_acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    p[j] = params[static_cast<long>(j) * T + t];
    g_acc[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) a_acc[i] = 0.0f;

  for (int v = 0; v < V; ++v) {
    const long idx = static_cast<long>(v) * T + t;
#pragma unroll
    for (int a = 0; a < A; ++a) av[a] = ang[a * n + idx];
    const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
    float r, rw, w2 = 1.0f;
    if constexpr (WEIGHTED) {
      const float wv = w[idx];
      r = (o.i - y[idx]) * wv;
      rw = r * wv;
      w2 = wv * wv;
    } else {
      r = o.i - y[idx];
      rw = r;
    }
    chi2 = chi2 + r * r;
    if constexpr (MODE == kModeFull) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int k = j; k < M; ++k) {
          const int i = j * M - j * (j - 1) / 2 + (k - j);   // (j, k) in row order
          const float dd = o.dp[j] * o.dp[k];
          if constexpr (WEIGHTED) {
            a_acc[i] = a_acc[i] + dd * w2;
          } else {
            a_acc[i] = a_acc[i] + dd;
          }
        }
      }
    }
    if constexpr (MODE != kModeChi2) {
#pragma unroll
      for (int j = 0; j < M; ++j) g_acc[j] = g_acc[j] + o.dp[j] * rw;
    }
  }

  out[t] = chi2;
  long row = 1;
  if constexpr (MODE == kModeFull) {
#pragma unroll
    for (int i = 0; i < P; ++i) out[(row + i) * T + t] = a_acc[i];
    row += P;
  }
  if constexpr (MODE != kModeChi2) {
#pragma unroll
    for (int j = 0; j < M; ++j) out[(row + j) * T + t] = g_acc[j];
  }
}

template <int L, bool WEIGHTED>
int launch_mode(int mode, const float* ang, const float* y, const float* w, const float* params,
                float* out, int T, int V, cudaStream_t st) {
  const int blocks = static_cast<int>((static_cast<long>(T) + kThreads - 1) / kThreads);
  switch (mode) {
    case kModeChi2:
      ne_kernel<L, kModeChi2, WEIGHTED><<<blocks, kThreads, 0, st>>>(ang, y, w, params, out, T, V);
      break;
    case kModeGrad:
      ne_kernel<L, kModeGrad, WEIGHTED><<<blocks, kThreads, 0, st>>>(ang, y, w, params, out, T, V);
      break;
    case kModeFull:
      ne_kernel<L, kModeFull, WEIGHTED><<<blocks, kThreads, 0, st>>>(ang, y, w, params, out, T, V);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 chi2, 1 grad, 2 full. w == nullptr selects the unweighted variant.
extern "C" int brdf_ne_rows(int lobe, int mode, const float* ang, const float* y, const float* w,
                            const float* params, float* out, int T, int V, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  BRDF_DISPATCH_LOBE(lobe, {
    if (w != nullptr) return launch_mode<kLobe, true>(mode, ang, y, w, params, out, T, V, st);
    return launch_mode<kLobe, false>(mode, ang, y, w, params, out, T, V, st);
  })
  return static_cast<int>(cudaErrorInvalidValue);
}
