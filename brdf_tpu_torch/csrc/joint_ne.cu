// Normal equations of the joint normal-map fit (m = 9) over the view axis:
// kernel K7.
//
// Replaces brdf_tpu/ops/lm_pallas.py::_joint_ne_kernel (launched there by
// _joint_ne_call, behind lm_fit_joint_pallas_chunked and
// joint_value_and_grad_pallas). The joint model fits, per texel,
//   p = [kd_r, kd_g, kd_b, ks_r, ks_g, ks_b, shape, nu, nv]
// against 3 V measurements; the shading normal is n' = normalize(n + nu t + nv b)
// in the texel's tangent frame (n, t, b), so the cosines the base lobe reads
// depend on the parameters. The kernel takes the raw unit vectors to the light
// and to the eye per (view, texel), recomputes n', the cosines and their
// (nu, nv) partials, evaluates the base lobe once per channel with
// (p[c], p[3 + c], p[6]), chains dI/dangles into the two offset columns and
// accumulates over the views, in three modes:
//
//   chi2   row 0:             chi2 = sum_{v, c} (w_c (I_c - y_c))^2
//   grad   rows 0, 1..9:      chi2, then g = J^T W^2 e
//   full   rows 0, 1..45, ..: chi2, the 45 upper-triangle entries of J^T W^2 J
//                             in (j, k) order, j <= k, then the 9 rows of g
//
// Channel c touches the columns {c, 3 + c, 6, 7, 8} only, so 12 of the 45
// entries are structurally zero: they are never summed and are written as 0.
// Inputs are views-major: lv (6, V, T) = L then V components, y and the
// per-channel weights w (3, V, T), parameters (9, T), frame (9, T) = n, t, b;
// the output is (R, T), R = 1, 10 or 55. Base lobes: the four with
// (kd, ks, shape) parameters (blinn_phong, phong, cook_torrance, ward).
//
// Designed for this card as K6 is (csrc/ne.cu): a texel's views are split
// over the W warps of a block that share 32 texels (warp w: views w, w + W,
// …), as ops/ne.py::ne_layout picks; W = 1 is one thread a texel. Each
// thread recomputes the texel's n' and its partials, walks its views with
// coalesced loads, keeps its sums in registers and adds them left to right
// from 0, views outside and channels inside; the W partials combine as the
// pairwise tree in shared memory (csrc/lanegroup.cuh), the row stores spread
// over the block's warps. There are no view chunks, no texel blocks, no
// padded rows and no accumulator that is revisited. In full mode a thread
// holds 1 + 33 + 9 sums beside the frame's derived values; the structural
// zeros are never summed and stay 0 through the combine. The assembler's
// register and spill counts are in PERF.md.
//
// What bounds it on an H100: bytes by count (12 floats read a pair; the three
// lobe evaluations with all their partials come to about half the byte time
// for cook_torrance), but in grad and full mode the registers (80 and about
// 120 a thread) leave 16 to 24 warps an SM, too few to hide a view's loads
// behind another warp's arithmetic. So in those modes a thread stages its
// next view (L, V, y, w: 12 floats) into its own column of a shared-memory
// double buffer by cp.async while it computes on the current one, which
// costs no register; chi2, with 40 warps an SM, reads as it goes. At 16
// views a split only adds the per-texel set-up and the combine, so the
// main paths take one thread a texel; at hundreds of views it gives grad
// more warps to hide the loads with, and full, capped at 16 warps an SM by
// its registers, gains only where one thread a texel leaves the card short
// of them (PERF.md). Sums run in the fixed order above,
// with no atomics and no FMA contraction, and every normalisation is
// 1 / sqrtf(max(., eps)), so the kernel can be held to equality with
// ops/ne.py::joint_ne_rows_plain.
//
// Interface: plain C, loaded with ctypes (brdf_tpu_torch/ops/_build.py). The
// kernel runs on the caller's stream, never synchronises and allocates
// nothing; the entry returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>

#include "lanegroup.cuh"
#include "lobes.cuh"

namespace {

constexpr int kModeChi2 = 0, kModeGrad = 1, kModeFull = 2;
constexpr int kM = 9;
constexpr int kPairs = kM * (kM + 1) / 2;
constexpr int kPairFloats = 12;      // floats of a (view, texel) pair: L, V, y, w

__host__ __device__ constexpr int rows_of(int mode) {
  return mode == kModeChi2 ? 1 : mode == kModeGrad ? 1 + kM : 1 + kPairs + kM;
}

// torch.clamp propagates NaN; fmaxf drops it
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(const float (&x)[3], const float (&z)[3]) {
  return x[0] * z[0] + x[1] * z[1] + x[2] * z[2];
}

// row of the (j, k) entry, j <= k, among the 45
__host__ __device__ constexpr int pair_index(int j, int k) {
  return j * kM - j * (j - 1) / 2 + (k - j);
}

template <int L, int MODE>
__global__ void __launch_bounds__(32 * brdf::kSplitMaxWarps)
joint_ne_kernel(const float* __restrict__ lv,      // (6, V, T)
                const float* __restrict__ y,       // (3, V, T)
                const float* __restrict__ w,       // (3, V, T)
                const float* __restrict__ params,  // (9, T)
                const float* __restrict__ frame,   // (9, T)
                float* __restrict__ out,           // (R, T)
                int T, int V, int warps) {
  static_assert(brdf::LobeTraits<L>::n_params == 3, "a (kd, ks, shape) base lobe");
  constexpr int A = brdf::LobeTraits<L>::n_angles;
  constexpr bool kNeedsH = L != brdf::LOBE_PHONG;
  constexpr bool kNeedsVn = L != brdf::LOBE_BLINN_PHONG;
  constexpr int R = rows_of(MODE);
  constexpr int G = MODE == kModeFull ? 1 + kPairs : 1;   // first row of g
  extern __shared__ float smem[];
  const long n = static_cast<long>(V) * T;
  const brdf::SplitPlace at = brdf::split_place(warps);
  const long t = at.t;
  const bool live = t < T;

  // acc: chi2, then in full the 45 entries of JᵀW²J in (j, k) order (12 stay
  // 0), then g
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  if (live) {
    float p[kM], nrm[3], tb[3], bb[3];
#pragma unroll
    for (int j = 0; j < kM; ++j) p[j] = params[static_cast<long>(j) * T + t];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      nrm[i] = frame[static_cast<long>(i) * T + t];
      tb[i] = frame[static_cast<long>(3 + i) * T + t];
      bb[i] = frame[static_cast<long>(6 + i) * T + t];
    }

    // perturbed unit normal and its offset partials:
    // n' = u / |u|, u = n + nu t + nv b;  dn'/dnu = (t - n' (n'.t)) / |u|
    float u[3], npn[3], dn_du[3], dn_dv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = nrm[i] + p[7] * tb[i] + p[8] * bb[i];
    const float inv_ell = 1.0f / sqrtf(max_nan(dot3(u, u), brdf::kEps));
#pragma unroll
    for (int i = 0; i < 3; ++i) npn[i] = u[i] * inv_ell;
    const float ndt = dot3(npn, tb);
    const float ndb = dot3(npn, bb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dn_du[i] = (tb[i] - npn[i] * ndt) * inv_ell;
      dn_dv[i] = (bb[i] - npn[i] * ndb) * inv_ell;
    }

    // a view's floats: L, V, y and w. grad and full stage each view one
    // ahead; chi2, byte-bound with its latency hidden by occupancy, reads
    // them as it goes
    auto addr = [&](int f, long idx) {
      return f < 6 ? lv + f * n + idx : f < 9 ? y + (f - 6) * n + idx : w + (f - 9) * n + idx;
    };
    brdf::walk_views<kPairFloats, MODE != kModeChi2>(smem, at.part, warps, V, T, t, addr,
                                                     [&](const float (&x)[kPairFloats]) {
      float ell[3], eye[3], yv[3], wv[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ell[i] = x[i];
        eye[i] = x[3 + i];
        yv[i] = x[6 + i];
        wv[i] = x[9 + i];
      }

      // the cosines the lobe reads, and their (nu, nv) partials
      float ang[A], ang_du[A], ang_dv[A];
      const float cl = dot3(ell, npn);
      const float cl_du = dot3(ell, dn_du), cl_dv = dot3(ell, dn_dv);
      ang[0] = cl;
      ang_du[0] = cl_du;
      ang_dv[0] = cl_dv;
      float cvn = 0.0f, cvn_du = 0.0f, cvn_dv = 0.0f;
      if constexpr (kNeedsVn) {
        cvn = dot3(eye, npn);
        cvn_du = dot3(eye, dn_du);
        cvn_dv = dot3(eye, dn_dv);
      }
      if constexpr (kNeedsH) {
        float s[3], h[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) s[i] = ell[i] + eye[i];
        const float inv_s = 1.0f / sqrtf(max_nan(dot3(s, s), brdf::kEps));
#pragma unroll
        for (int i = 0; i < 3; ++i) h[i] = s[i] * inv_s;
        ang[1] = dot3(h, npn);
        ang_du[1] = dot3(h, dn_du);
        ang_dv[1] = dot3(h, dn_dv);
        if constexpr (A == 3) {
          ang[2] = cvn;
          ang_du[2] = cvn_du;
          ang_dv[2] = cvn_dv;
        }
      } else {
        // phong: R.V = 2 (N.L)(N.V) - L.V, and L.V does not depend on the normal
        const float lvdot = dot3(ell, eye);
        ang[1] = 2.0f * cl * cvn - lvdot;
        ang_du[1] = 2.0f * (cl_du * cvn + cl * cvn_du);
        ang_dv[1] = 2.0f * (cl_dv * cvn + cl * cvn_dv);
      }

#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const brdf::LobeOut<L> o = brdf::lobe_full<L>(ang, p[c], p[3 + c], p[6]);
        const float wc = wv[c];
        const float r = (o.i - yv[c]) * wc;
        acc[0] = acc[0] + r * r;
        if constexpr (MODE != kModeChi2) {
          float d_nu = o.da[0] * ang_du[0];
          float d_nv = o.da[0] * ang_dv[0];
#pragma unroll
          for (int a = 1; a < A; ++a) {
            d_nu = d_nu + o.da[a] * ang_du[a];
            d_nv = d_nv + o.da[a] * ang_dv[a];
          }
          const float col[5] = {o.dp[0], o.dp[1], o.dp[2], d_nu, d_nv};
          const int ids[5] = {c, 3 + c, 6, 7, 8};
          const float rw = r * wc;
#pragma unroll
          for (int a = 0; a < 5; ++a) acc[G + ids[a]] = acc[G + ids[a]] + col[a] * rw;
          if constexpr (MODE == kModeFull) {
            const float w2 = wc * wc;
#pragma unroll
            for (int a = 0; a < 5; ++a) {
#pragma unroll
              for (int b = a; b < 5; ++b) {
                const int i = 1 + pair_index(ids[a], ids[b]);
                acc[i] = acc[i] + col[a] * col[b] * w2;
              }
            }
          }
        }
      }
    });
  }
  brdf::split_store(acc, warps, smem, out, T, t, live);
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          float*, int, int, int);

template <int L>
KernelFn pick_mode(int mode) {
  switch (mode) {
    case kModeChi2: return joint_ne_kernel<L, kModeChi2>;
    case kModeGrad: return joint_ne_kernel<L, kModeGrad>;
    case kModeFull: return joint_ne_kernel<L, kModeFull>;
    default: return nullptr;
  }
}

KernelFn pick_kernel(int lobe, int mode) {
  switch (lobe) {
    case brdf::LOBE_BLINN_PHONG: return pick_mode<brdf::LOBE_BLINN_PHONG>(mode);
    case brdf::LOBE_PHONG: return pick_mode<brdf::LOBE_PHONG>(mode);
    case brdf::LOBE_COOK_TORRANCE: return pick_mode<brdf::LOBE_COOK_TORRANCE>(mode);
    case brdf::LOBE_WARD: return pick_mode<brdf::LOBE_WARD>(mode);
    default: return nullptr;
  }
}

// The launch of W warps a split (lanegroup.cuh); false if the kernel does
// not take it.
bool launch_shape(int mode, int warps, long T, brdf::SplitLaunch* l) {
  return brdf::split_launch(warps, T, rows_of(mode), mode == kModeChi2 ? 0 : kPairFloats, l);
}

}  // namespace

// mode: 0 chi2, 1 grad, 2 full; lobe: one of the four (kd, ks, shape) lobes;
// warps: W of a warp split (1: one thread a texel).
extern "C" int brdf_joint_ne_rows(int lobe, int mode, int warps, const float* lv, const float* y,
                                  const float* w, const float* params, const float* frame,
                                  float* out, int T, int V, void* stream) {
  const KernelFn kernel = pick_kernel(lobe, mode);
  brdf::SplitLaunch l{};
  if (kernel == nullptr || !launch_shape(mode, warps, T, &l) || l.blocks > 0x7fffffffL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(l.blocks), l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      lv, y, w, params, frame, out, T, V, warps);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime gives a split's instantiation: out = {blocks an SM,
// registers a thread, local bytes a thread, threads a block}.
extern "C" int brdf_joint_ne_occupancy(int lobe, int mode, int warps, int* out) {
  const KernelFn kernel = pick_kernel(lobe, mode);
  brdf::SplitLaunch l{};
  if (kernel == nullptr || !launch_shape(mode, warps, 1, &l)) {
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
