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
// every chunk revisits, because one chunk has to fit the fast memory. Here a
// texel's views are split over the W warps of a block that share 32 texels,
// warp w taking views w, w + W, …, so every load is a whole 128-byte row
// segment (a warp split, lanegroup.cuh). ops/ne.py::ne_layout picks W from
// (m, mode, V), the same function for this kernel and its plain version;
// W = 1 is one thread a texel, walking every view.
//
// Each thread keeps its R partial sums in registers, left to right from 0
// over its views; the W partials meet in shared memory (R · W · 32 floats)
// and combine as the pairwise tree ((p0 + p1) + (p2 + p3)) + …, the R row
// stores spread over the block's warps. In grad and full a thread stages its
// next view into its own column of a shared-memory double buffer by cp.async
// while it computes on the current one, so the loads' latency hides behind
// the lobe's arithmetic without a register more; chi2 reads as it goes. The
// view count is unbounded by construction and neither T, V nor the parameter
// rows are padded: the kernel bound-checks and indexes with 64 bits. W is a
// run-time argument, so the instantiations stay ten lobes x three modes x two
// weight variants.
//
// The mode and the lobe are template parameters: the chi2 kernel never
// computes a partial (lobe_full<L> is inlined and its unused outputs are dead
// code), and the grad kernel no product of two partials.
//
// What bounds it on an H100: bytes by count. It reads (A V + V [+ V] + m) T
// floats and writes R T, against a few dozen to a few hundred operations a
// pair. With one thread a texel its parallelism is T threads, and at a small
// T and a large V (the routed fit, 65536 x 384) each thread's chain of V
// dependent loads leaves most of the card waiting; the split gives it W T
// threads and chi2 comes near its byte bound. In grad and full the lobe's
// partials (IEEE divisions and square roots, no FMA) cost more issue slots
// than the bytes take, at any split. The sums keep a fixed order with no
// atomics, which (with -fmad=false) lets the kernel be held to equality with
// ops/ne.py::ne_rows_plain.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "lanegroup.cuh"
#include "lobes.cuh"

namespace {

constexpr int kModeChi2 = 0, kModeGrad = 1, kModeFull = 2;

__host__ __device__ constexpr int rows_of(int m, int mode) {
  return mode == kModeChi2 ? 1 : mode == kModeGrad ? 1 + m : 1 + m * (m + 1) / 2 + m;
}

// floats of a (view, texel) pair: the angles, y and w
__host__ __device__ constexpr int staged_floats(int n_angles, bool weighted) {
  return n_angles + 1 + (weighted ? 1 : 0);
}

template <int L, int MODE, bool WEIGHTED>
__global__ void __launch_bounds__(32 * brdf::kSplitMaxWarps)
ne_kernel(const float* __restrict__ ang,     // (A, V, T)
          const float* __restrict__ y,       // (V, T)
          const float* __restrict__ w,       // (V, T), not read unless WEIGHTED
          const float* __restrict__ params,  // (m, T)
          float* __restrict__ out,           // (R, T)
          int T, int V, int warps) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  constexpr int P = M * (M + 1) / 2;
  constexpr int R = rows_of(M, MODE);
  constexpr int G = MODE == kModeFull ? 1 + P : 1;   // first row of g
  constexpr int F = staged_floats(A, WEIGHTED);
  extern __shared__ float smem[];
  const long n = static_cast<long>(V) * T;
  const brdf::SplitPlace at = brdf::split_place(warps);
  const long t = at.t;
  const bool live = t < T;

  // acc: chi2, then in full the P entries of JᵀW²J in (j, k) order, then g
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  if (live) {
    float p[M];
#pragma unroll
    for (int j = 0; j < M; ++j) p[j] = params[static_cast<long>(j) * T + t];
    // a view's floats: the angles, y, w. grad and full stage each view one
    // ahead; chi2, byte-bound with its latency hidden by occupancy, reads
    // them as it goes
    auto addr = [&](int f, long idx) {
      return f < A ? ang + f * n + idx : f == A ? y + idx : w + idx;
    };
    brdf::walk_views<F, MODE != kModeChi2>(smem, at.part, warps, V, T, t, addr,
                                           [&](const float (&x)[F]) {
      float av[A];
#pragma unroll
      for (int a = 0; a < A; ++a) av[a] = x[a];
      const float yv = x[A];
      const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
      float r, rw, w2 = 1.0f;
      if constexpr (WEIGHTED) {
        const float wv = x[A + 1];
        r = (o.i - yv) * wv;
        rw = r * wv;
        w2 = wv * wv;
      } else {
        r = o.i - yv;
        rw = r;
      }
      acc[0] = acc[0] + r * r;
      if constexpr (MODE == kModeFull) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
#pragma unroll
          for (int k = j; k < M; ++k) {
            const int i = 1 + j * M - j * (j - 1) / 2 + (k - j);   // (j, k) in row order
            const float dd = o.dp[j] * o.dp[k];
            if constexpr (WEIGHTED) {
              acc[i] = acc[i] + dd * w2;
            } else {
              acc[i] = acc[i] + dd;
            }
          }
        }
      }
      if constexpr (MODE != kModeChi2) {
#pragma unroll
        for (int j = 0; j < M; ++j) acc[G + j] = acc[G + j] + o.dp[j] * rw;
      }
    });
  }
  brdf::split_store(acc, warps, smem, out, T, t, live);
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, float*, int,
                          int, int);

template <int L, bool WEIGHTED>
KernelFn pick_mode(int mode) {
  switch (mode) {
    case kModeChi2: return ne_kernel<L, kModeChi2, WEIGHTED>;
    case kModeGrad: return ne_kernel<L, kModeGrad, WEIGHTED>;
    case kModeFull: return ne_kernel<L, kModeFull, WEIGHTED>;
    default: return nullptr;
  }
}

KernelFn pick_kernel(int lobe, int mode, bool weighted) {
  BRDF_DISPATCH_LOBE(lobe, {
    return weighted ? pick_mode<kLobe, true>(mode) : pick_mode<kLobe, false>(mode);
  })
  return nullptr;
}

// The launch of W warps a split (lanegroup.cuh); false if the kernel does
// not take it.
bool launch_shape(int lobe, int mode, bool weighted, int warps, long T, brdf::SplitLaunch* l) {
  BRDF_DISPATCH_LOBE(lobe, {
    using Traits = brdf::LobeTraits<kLobe>;
    const int staged = mode == kModeChi2 ? 0 : staged_floats(Traits::n_angles, weighted);
    return brdf::split_launch(warps, T, rows_of(Traits::n_params, mode), staged, l);
  })
  return false;
}

}  // namespace

// mode: 0 chi2, 1 grad, 2 full. w == nullptr selects the unweighted variant.
// warps: W of a warp split (1: one thread a texel).
extern "C" int brdf_ne_rows(int lobe, int mode, int warps, const float* ang, const float* y,
                            const float* w, const float* params, float* out, int T, int V,
                            void* stream) {
  const KernelFn kernel = pick_kernel(lobe, mode, w != nullptr);
  brdf::SplitLaunch l{};
  if (kernel == nullptr || !launch_shape(lobe, mode, w != nullptr, warps, T, &l) ||
      l.blocks > 0x7fffffffL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(l.blocks), l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      ang, y, w, params, out, T, V, warps);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime gives a split's instantiation: out = {blocks an SM,
// registers a thread, local bytes a thread, threads a block}.
extern "C" int brdf_ne_occupancy(int lobe, int mode, int weighted, int warps, int* out) {
  const KernelFn kernel = pick_kernel(lobe, mode, weighted != 0);
  brdf::SplitLaunch l{};
  if (kernel == nullptr || !launch_shape(lobe, mode, weighted != 0, warps, 1, &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, l.threads, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = l.threads;
  return static_cast<int>(cudaSuccess);
}
