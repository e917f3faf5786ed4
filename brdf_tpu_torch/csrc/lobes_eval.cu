// The lobe library as a kernel of its own: value, dI/dparams and dI/dangles of
// one lobe at every (view, texel) pair, one thread per pair.
//
// It exists so that every output of every function in lobes.cuh (kernel K0,
// which replaces brdf_tpu/ops/shading_pallas.py::SHADING_KERNELS and is
// otherwise only inlined into other kernels, each of which reads a part of it:
// the solvers the value and dI/dparams, shade.cu one output a kernel) can be
// held against the plain twin brdf_tpu_torch/ops/shading.py at once on
// the card. What bounds it on an H100 is bytes: it reads A + m/V floats per
// pair and writes 1 + m + A, with a few dozen operations between.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "lobes.cuh"

namespace {

template <int L>
__global__ void __launch_bounds__(256)
lobes_eval_kernel(const float* __restrict__ ang,     // (A, V, T)
                  const float* __restrict__ params,  // (m, T)
                  float* __restrict__ out_i,         // (V, T)
                  float* __restrict__ out_dp,        // (m, V, T)
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
  out_i[idx] = o.i;
#pragma unroll
  for (int j = 0; j < M; ++j) out_dp[j * n + idx] = o.dp[j];
#pragma unroll
  for (int a = 0; a < A; ++a) out_da[a * n + idx] = o.da[a];
}

template <int L>
int launch(const float* ang, const float* params, float* out_i, float* out_dp, float* out_da,
           int T, int V, cudaStream_t stream) {
  const long n = static_cast<long>(V) * T;
  const int blocks = static_cast<int>((n + 255) / 256);
  lobes_eval_kernel<L><<<blocks, 256, 0, stream>>>(ang, params, out_i, out_dp, out_da, T, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brdf_lobes_eval(int lobe, const float* ang, const float* params, float* out_i,
                               float* out_dp, float* out_da, int T, int V, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  BRDF_DISPATCH_LOBE(lobe, return launch<kLobe>(ang, params, out_i, out_dp, out_da, T, V, st))
  return static_cast<int>(cudaErrorInvalidValue);
}
