// Forward shading and its analytic backward: kernels K2, K3 and K4.
//
// Replaces brdf_tpu/ops/shading_pallas.py::_fwd_kernel (K2),
// ::_bwd_params_kernel (K3) and ::_bwd_angles_kernel (K4), the three
// pallas_calls behind shade_pallas and its custom VJP. Inputs are views-major:
// angles (A, V, T), parameters (m, T), cotangent (V, T), texels on the fast
// axis, so consecutive threads read consecutive addresses.
//
//   K2 shade_fwd         I[v, t]                      one thread per (view, texel)
//   K3 shade_bwd_params  dp[j, t] = sum_v dI/dp_j*ct  one thread per texel
//   K4 shade_bwd_angles  da[a, v, t] = dI/dang_a*ct   one thread per (view, texel)
//
// The backward recomputes the lobe from the saved inputs (the TPU kernel's
// rematerialisation): nothing of size V*T is kept between forward and
// backward. K3 and K4 are separate launches so that a caller who wants only
// one set of cotangents pays for one (ops/shading.py launches each only when
// autograd asks for it). lobe_full<L> is inlined into all three; each kernel
// reads one of its three outputs and the compiler drops the code of the others.
//
// What bounds them on an H100 is bytes: K2 reads (A*V + m)*T floats and writes
// V*T; K3 reads (A*V + V + m)*T and writes m*T; K4 reads the same and writes
// A*V*T, with a few dozen operations per pair in between. Nothing is staged in
// shared memory because nothing is read twice: K3's thread keeps its m
// parameters and m running sums in registers and walks the views, each step a
// coalesced load across the warp. The TPU kernels pad T to a block and the
// parameter rows to 8; these bound-check instead and write exactly m rows.
// K3's view sum runs left to right from zero, as the plain version's does
// (and the sources build with -fmad=false), so the two can be held to equality.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). Each
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; each entry returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>

#include "lobes.cuh"

namespace {

constexpr int kThreads = 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
shade_fwd_kernel(const float* __restrict__ ang,     // (A, V, T)
                 const float* __restrict__ params,  // (m, T)
                 float* __restrict__ out_i,         // (V, T)
                 int T, int V) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  const long n = static_cast<long>(V) * T;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long t = idx % T;
  float av[A], p[M];
#pragma unroll
  for (int a = 0; a < A; ++a) av[a] = ang[a * n + idx];
#pragma unroll
  for (int j = 0; j < M; ++j) p[j] = params[static_cast<long>(j) * T + t];
  out_i[idx] = brdf::lobe_full<L>(av, p).i;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
shade_bwd_params_kernel(const float* __restrict__ ang,     // (A, V, T)
                        const float* __restrict__ params,  // (m, T)
                        const float* __restrict__ ct,      // (V, T)
                        float* __restrict__ out_dp,        // (m, T)
                        int T, int V) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  const long n = static_cast<long>(V) * T;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float av[A], p[M], acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    p[j] = params[static_cast<long>(j) * T + t];
    acc[j] = 0.0f;
  }
  for (int v = 0; v < V; ++v) {
    const long idx = static_cast<long>(v) * T + t;
#pragma unroll
    for (int a = 0; a < A; ++a) av[a] = ang[a * n + idx];
    const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
    const float c = ct[idx];
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = acc[j] + o.dp[j] * c;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) out_dp[static_cast<long>(j) * T + t] = acc[j];
}

template <int L>
__global__ void __launch_bounds__(kThreads)
shade_bwd_angles_kernel(const float* __restrict__ ang,     // (A, V, T)
                        const float* __restrict__ params,  // (m, T)
                        const float* __restrict__ ct,      // (V, T)
                        float* __restrict__ out_da,        // (A, V, T)
                        int T, int V) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  const long n = static_cast<long>(V) * T;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long t = idx % T;
  float av[A], p[M];
#pragma unroll
  for (int a = 0; a < A; ++a) av[a] = ang[a * n + idx];
#pragma unroll
  for (int j = 0; j < M; ++j) p[j] = params[static_cast<long>(j) * T + t];
  const brdf::LobeOut<L> o = brdf::lobe_full<L>(av, p);
  const float c = ct[idx];
#pragma unroll
  for (int a = 0; a < A; ++a) out_da[a * n + idx] = o.da[a] * c;
}

int blocks_for(long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int brdf_shade_fwd(int lobe, const float* ang, const float* params, float* out_i,
                              int T, int V, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(static_cast<long>(V) * T);
  BRDF_DISPATCH_LOBE(lobe, {
    shade_fwd_kernel<kLobe><<<blocks, kThreads, 0, st>>>(ang, params, out_i, T, V);
    return static_cast<int>(cudaGetLastError());
  })
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int brdf_shade_bwd_params(int lobe, const float* ang, const float* params,
                                     const float* ct, float* out_dp, int T, int V,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(T);
  BRDF_DISPATCH_LOBE(lobe, {
    shade_bwd_params_kernel<kLobe><<<blocks, kThreads, 0, st>>>(ang, params, ct, out_dp, T, V);
    return static_cast<int>(cudaGetLastError());
  })
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int brdf_shade_bwd_angles(int lobe, const float* ang, const float* params,
                                     const float* ct, float* out_da, int T, int V,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(static_cast<long>(V) * T);
  BRDF_DISPATCH_LOBE(lobe, {
    shade_bwd_angles_kernel<kLobe><<<blocks, kThreads, 0, st>>>(ang, params, ct, out_da, T, V);
    return static_cast<int>(cudaGetLastError());
  })
  return static_cast<int>(cudaErrorInvalidValue);
}
