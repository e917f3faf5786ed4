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
//                        (shade_bwd_params_ahead_kernel for the heavy lobes)
//   K4 shade_bwd_angles  da[a, v, t] = dI/dang_a*ct   one thread per (view, texel)
//
// The backward recomputes the lobe from the saved inputs (the TPU kernel's
// rematerialisation): nothing of size V*T is kept between forward and
// backward. K3 and K4 are separate launches so that a caller who wants only
// one set of cotangents pays for one (ops/shading.py launches each only when
// autograd asks for it). lobe_full<L> is inlined into all three; each kernel
// reads one of its three outputs and the compiler drops the code of the others.
//
// K2 and K4 are bound by bytes: K2 reads (A*V + m)*T floats and writes V*T;
// K4 reads (A*V + V + m)*T and writes A*V*T. K3 reads the same as K4 and
// writes m*T, but for the heavy lobes it is bound by issue: cook_torrance's
// dI/dparams takes 4 IEEE divides, 4 reciprocals and 2 square roots a pair,
// each with its range check, slow-path branch and reconvergence, about 230
// SASS instructions a pair (tools/k3_probe.py), whose floor lies above the
// byte bound. The compiler already hoists the parameter-only terms (the
// roughness powers) out of the view loop. K3's design, from that probe: one
// thread a texel keeps its m parameters and m running sums in registers and
// walks the views; for the heavy lobes the next view's A + 1 loads are issued
// before the current view's lobe (32-bit offsets that step by T), so a thread
// no longer waits on its loads at every view, with registers capped for 48
// warps an SM (shade_bwd_params_ahead_kernel, k3_ahead); the light lobes load
// each view as they reach it. Nothing is staged in shared memory because
// nothing is read twice. The TPU kernels pad T to a block and the parameter
// rows to 8; these bound-check instead and write exactly m rows.
// K3's view sum runs left to right from zero, as the plain version's does
// (and the sources build with -fmad=false), so the two can be held to
// equality.
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

// K3 by lobe, from tools/k3_probe.py on all ten lobes at the shading batch's
// shape: the four lobes whose pair issues 220–650 instructions (the GGX,
// Smith and anisotropic terms, divide- and root-heavy) run
// shade_bwd_params_ahead_kernel, which loads the inputs of view v + 1 while
// view v's lobe is evaluated; the six lighter ones (10–150 instructions) run
// shade_bwd_params_kernel, which loads each view as it reaches it and leaves
// its registers to the compiler: the prefetch's registers cost them more
// warps than the loads' wait (PERF.md).
template <int L>
__host__ __device__ constexpr bool k3_ahead() {
  return L == brdf::LOBE_COOK_TORRANCE || L == brdf::LOBE_COOK_TORRANCE_FRESNEL ||
         L == brdf::LOBE_WARD_ANISO || L == brdf::LOBE_COOK_TORRANCE_ANISO;
}

// the load-ahead kernel's blocks an SM: 6, at most 40 registers and 48 warps
// (4 for cook_torrance_aniso, whose state needs 64 registers)
template <int L>
__host__ __device__ constexpr int k3_min_blocks() {
  return L == brdf::LOBE_COOK_TORRANCE_ANISO ? 4 : 6;
}

// K3 for the light lobes: one thread a texel loads each view as it reaches it
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

// K3 for the heavy lobes: the A + 1 loads of view v + 1 issue before view v's
// lobe, so a thread no longer waits on its loads at every view
template <int L>
__global__ void __launch_bounds__(kThreads, k3_min_blocks<L>())
shade_bwd_params_ahead_kernel(const float* __restrict__ ang,     // (A, V, T)
                              const float* __restrict__ params,  // (m, T)
                              const float* __restrict__ ct,      // (V, T)
                              float* __restrict__ out_dp,        // (m, T)
                              int T, int V) {
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr int M = brdf::LobeTraits<L>::n_params;
  const long n = static_cast<long>(V) * T;
  // V·T < 2^31 (the wrapper's bound): offsets within a plane are 32-bit and
  // step by T a view; only the planes' bases are 64-bit, once
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= static_cast<unsigned>(T)) return;
  float p[M], acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    p[j] = params[static_cast<long>(j) * T + t];
    acc[j] = 0.0f;
  }
  const unsigned last = static_cast<unsigned>(V - 1) * T + t;
  unsigned next = t;  // offset of the next view to load (clamped to the last)
  float nxt[A + 1];   // its A angles and its cotangent
  auto load = [&]() {
#pragma unroll
    for (int a = 0; a < A; ++a) nxt[a] = ang[a * n + next];
    nxt[A] = ct[next];
    next = min(next + T, last);
  };
  load();
  for (int v = 0; v < V; ++v) {  // views in order: the sum runs left to right from zero
    float x[A + 1];
#pragma unroll
    for (int a = 0; a <= A; ++a) x[a] = nxt[a];
    load();
    const brdf::LobeOut<L> o = brdf::lobe_full<L>(x, p);
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = acc[j] + o.dp[j] * x[A];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) out_dp[static_cast<long>(j) * T + t] = acc[j];
}

// the K3 kernel a lobe runs
template <int L>
constexpr auto k3_kernel() {
  if constexpr (k3_ahead<L>()) {
    return shade_bwd_params_ahead_kernel<L>;
  } else {
    return shade_bwd_params_kernel<L>;
  }
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
    const auto k3 = k3_kernel<kLobe>();
    k3<<<blocks, kThreads, 0, st>>>(ang, params, ct, out_dp, T, V);
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

// What K3's instantiation for a lobe gets on this card: out[0] resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at kThreads threads),
// out[1] registers a thread, out[2] local memory bytes a thread, out[3]
// threads a block.
extern "C" int brdf_shade_bwd_params_occupancy(int lobe, int* out) {
  const void* fn = nullptr;
  BRDF_DISPATCH_LOBE(lobe, { fn = reinterpret_cast<const void*>(k3_kernel<kLobe>()); })
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = kThreads;
  return 0;
}
