// The linear grid init in one launch (grid_init_kernel): for each texel, the
// first point of a shape grid whose closed-form non-negative linear fit has
// the least Gram-form cost, as (kd[, ks], shape…) clipped to the model's box.
//
// Replaces no TPU kernel. The JAX package's brdf_tpu/solver/init.py::
// linear_grid_init is plain jnp that XLA fuses under jit; the port ran it as
// G eager solves (ops/grid_init.py::linear_grid_init_plain): per grid point
// two lobe evaluations, five weighted view sums, the closed-form NNLS
// (_nnls2, some 25 elementwise operations), the cost and two selects, 100–150
// launches a point, each a few µs of host time for little device work. This
// kernel computes the same algorithm:
//
//   ty = y·w; for g in grid, in order:
//     a = lobe(1, 0, shape_g), b = lobe(0, 1, shape_g)       (K0's lobe_full<L>)
//     aa = Σ (a·w)·a, ab = Σ (a·w)·b, bb = Σ (b·w)·b, ay = Σ a·ty, by = Σ b·ty
//     (kd, ks) = _nnls2: the interior solution where |det| > 1e-30 and both
//       parts are ≥ 0, else the better single-variable one (cost_a <= cost_b
//       picks a); non-negative only, no upper bound (not bvls2.cuh's box)
//     cost = the Gram form; the point replaces the best only where
//       cost < best, which starts at +inf (the first minimum wins; a NaN cost
//       never does)
//   out = the best (kd, ks, shape_g) clipped to the box; a lane that no point
//   won keeps zeros, clipped.
//
// The lobes linear in one parameter (lambert, minnaert, oren_nayar) form aa
// and ay alone, with kd = max(ay / max(aa, 1e-30), 0).
//
// Layout (csrc/lanegroup.cuh, as K1 and K8): a texel is taken by S lanes of
// one warp, lane l holding views l, l + S, … (VPL of them) of the texel-major
// (T, V) inputs, so a group's load of one slot reads S consecutive floats of
// a texel row. A lane reads its views' angles, y and w once into registers
// and runs every grid point from them; a point's sums are a lane's partial
// then an XOR butterfly, and the scalar solve runs replicated on the S lanes.
// ops/grid_init.py::kernel_layout picks S from the angle channels and V, the
// fewest lanes whose (A + 2)·VPL floats fit kLaneStateFloats. Past 32 lanes of
// that the kernel's long-view instantiation (SLOTS = 0) has 32 lanes read
// their views from device memory at every grid point.
//
// What bounds it on an H100: its instructions, not bytes. A texel reads
// (A + 2)·V floats once and evaluates its lobe 2·G·V times (the two bases
// share their shape terms, so the compiler may form those once), then solves
// a 2×2 system G times. The grid, at most kMaxGrid points of kMaxShape shape
// values, goes in by value as a kernel parameter: no allocation and no copy a
// launch.
//
// Rounding: built with -fmad=false and lobes.cuh's rules, clamps and maxima
// propagate NaN as torch.clamp does (bvls2.cuh's clip_nan, max_nan), so each
// term rounds as the plain version's; the sums' order is the lane group's,
// not torch.sum's, so the two agree to a sum's rounding.
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

constexpr int kMaxGrid = 64;          // ops/grid_init.py MAX_GRID
constexpr int kMaxShape = 3;          // the most shape parameters of a lobe
constexpr int kMaxParams = 5;
constexpr int kThreads = 128;         // a block: four warps, 128 / S texels
constexpr int kLaneStateFloats = 32;  // ops/grid_init.py LANE_STATE_FLOATS
constexpr float kTiny = 1e-30f;

struct GridArgs {
  float v[kMaxGrid * kMaxShape];  // point g's shape values at v[g·k …], f32
  int n;
};

struct BoxArgs {
  float lo[kMaxParams], hi[kMaxParams];
};

using brdf::LobeTraits;
using brdf::max_nan;
using brdf::min_nan;

// the leading parameters a lobe is linear in (models/brdf.py ModelSpec.linear)
template <int L>
constexpr int kLinear =
    (L == brdf::LOBE_LAMBERT || L == brdf::LOBE_MINNAERT || L == brdf::LOBE_OREN_NAYAR) ? 1 : 2;

// views a lane holds in registers: the angles, w and y·w of each
template <int L>
__host__ __device__ constexpr int max_vpl() {
  return kLaneStateFloats / (LobeTraits<L>::n_angles + 2);
}

// solver init's _nnls2 and the Gram-form cost at its solution
__device__ __forceinline__ float nnls2_cost(float aa, float ab, float bb, float ay, float by,
                                            float& kd, float& ks) {
  const float det = aa * bb - ab * ab;
  const bool det_ok = fabsf(det) > kTiny;
  const float det_s = det_ok ? det : 1.0f;
  const float x0 = (bb * ay - ab * by) / det_s;
  const float x1 = (aa * by - ab * ay) / det_s;
  const bool interior_ok = det_ok && (x0 >= 0.0f) && (x1 >= 0.0f);
  const float a_only = max_nan(ay / max_nan(aa, kTiny), 0.0f);
  const float b_only = max_nan(by / max_nan(bb, kTiny), 0.0f);
  const float cost_a = a_only * a_only * aa - 2.0f * a_only * ay;
  const float cost_b = b_only * b_only * bb - 2.0f * b_only * by;
  const bool pick_a = cost_a <= cost_b;
  kd = interior_ok ? x0 : (pick_a ? a_only : 0.0f);
  ks = interior_ok ? x1 : (pick_a ? 0.0f : b_only);
  return brdf::gram_cost(kd, ks, aa, ab, bb, ay, by);
}

// SLOTS > 0: a lane holds up to SLOTS views in registers (ceil(V / S) of them,
// a run-time count). SLOTS = 0: the long-view path, 32 lanes a texel, each
// view read anew from device memory into slot 0 at every grid point.
template <int L, int SLOTS>
__global__ void __launch_bounds__(kThreads)
grid_init_kernel(const float* __restrict__ ang,  // (A, T, V)
                 const float* __restrict__ y,    // (T, V)
                 const float* __restrict__ w,    // (T, V), or null: unit weights
                 float* __restrict__ out,        // (T, NP)
                 int T, int V, int S, GridArgs grid, BoxArgs box) {
  constexpr int A = LobeTraits<L>::n_angles;
  constexpr int NP = LobeTraits<L>::n_params;
  constexpr int NL = kLinear<L>;
  constexpr int K = NP - NL;
  constexpr int NS = NL == 2 ? 5 : 2;  // the view sums a point forms
  constexpr bool kLong = SLOTS == 0;
  constexpr int kSlots = kLong ? 1 : SLOTS;
  static_assert(SLOTS <= max_vpl<L>(), "a lane's view state fits its budget");
  static_assert(K <= kMaxShape, "the grid holds the lobe's shape values");

  const brdf::LaneGroup lg = brdf::lane_group(S);
  // ragged edge: lanes past T stay for the shuffles on the last texel, unwritten
  const bool live = lg.item < T;
  const long t = live ? lg.item : T - 1;
  const long row = t * V;
  const long tv = static_cast<long>(T) * V;
  const int n_slots = (V + S - 1) / S;

  float av[kSlots][A];
  float wv[kSlots], tyv[kSlots];
  bool in_v[kSlots];
  // slot k's view into slot i; a slot past V reads nothing and adds nothing
  auto load = [&](int k, int i) {
    const int v = k * S + lg.lane;
    in_v[i] = v < V;
    if (!in_v[i]) return;
    const long gi = row + v;
#pragma unroll
    for (int a = 0; a < A; ++a) av[i][a] = ang[a * tv + gi];
    wv[i] = w != nullptr ? w[gi] : 1.0f;
    tyv[i] = y[gi] * wv[i];
  };
  if constexpr (!kLong) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      in_v[k] = false;
      if (k < n_slots) load(k, k);
    }
  }

  float best[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) best[j] = 0.0f;
  float best_cost = INFINITY;
  for (int g = 0; g < grid.n; ++g) {
    // the bases' parameters: (1, 0, shape) and (0, 1, shape)
    float pa[NP], pb[NP];
    pa[0] = 1.0f;
    pb[0] = 0.0f;
    if constexpr (NL == 2) {
      pa[1] = 0.0f;
      pb[1] = 1.0f;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) pa[NL + j] = pb[NL + j] = grid.v[g * K + j];
    const brdf::LobePoint pt = brdf::lobe_point<L>(pa);

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.0f;
    auto add_view = [&](int i) {
      const float a = brdf::lobe_full<L>(av[i], pa, pt).i;
      const float aw = a * wv[i];
      s[0] += aw * a;
      if constexpr (NL == 2) {
        const float b = brdf::lobe_full<L>(av[i], pb, pt).i;
        s[1] += aw * b;
        s[2] += (b * wv[i]) * b;
        s[3] += a * tyv[i];
        s[4] += b * tyv[i];
      } else {
        s[1] += a * tyv[i];
      }
    };
    if constexpr (kLong) {
      for (int k = 0; k < n_slots; ++k) {
        load(k, 0);
        if (in_v[0]) add_view(0);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (in_v[k]) add_view(k);
      }
    }
    brdf::group_sum(s, S);

    float kd, ks = 0.0f, cost;
    if constexpr (NL == 2) {
      cost = nnls2_cost(s[0], s[1], s[2], s[3], s[4], kd, ks);
    } else {
      kd = max_nan(s[1] / max_nan(s[0], kTiny), 0.0f);
      cost = kd * kd * s[0] - 2.0f * kd * s[1];
    }
    if (cost < best_cost) {
      best_cost = cost;
      best[0] = kd;
      if constexpr (NL == 2) best[1] = ks;
#pragma unroll
      for (int j = 0; j < K; ++j) best[NL + j] = pa[NL + j];
    }
  }

  if (!live || lg.lane != 0) return;
#pragma unroll
  for (int j = 0; j < NP; ++j) out[t * NP + j] = min_nan(max_nan(best[j], box.lo[j]), box.hi[j]);
}

using KernelFn = void (*)(const float*, const float*, const float*, float*, int, int, int,
                          GridArgs, BoxArgs);

// the register instantiation where ceil(V / lanes) views fit a lane, else the
// long-view one (32 lanes only)
template <int L>
KernelFn kernel_for(int V, int lanes) {
  if ((V + lanes - 1) / lanes <= max_vpl<L>()) return grid_init_kernel<L, max_vpl<L>()>;
  return lanes == 32 ? grid_init_kernel<L, 0> : nullptr;
}

KernelFn pick_kernel(int lobe, int V, int lanes) {
  KernelFn fn = nullptr;
  BRDF_DISPATCH_LOBE(lobe, fn = kernel_for<kLobe>(V, lanes));
  return fn;
}

int shape_count(int lobe) {
  int k = -1;
  BRDF_DISPATCH_LOBE(lobe, k = LobeTraits<kLobe>::n_params - kLinear<kLobe>);
  return k;
}

int param_count(int lobe) {
  int m = 0;
  BRDF_DISPATCH_LOBE(lobe, m = LobeTraits<kLobe>::n_params);
  return m;
}

}  // namespace

// grid: n_grid points of k shape values, row-major; lower/upper: the model's
// box, one value a parameter
extern "C" int brdf_grid_init(int lobe, const float* ang, const float* y, const float* w,
                              float* out, int T, int V, int lanes, const float* grid, int n_grid,
                              int k, const float* lower, const float* upper, void* stream) {
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (T < 1 || V < 0 || !lanes_ok || n_grid < 1 || n_grid > kMaxGrid || k != shape_count(lobe))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(lobe, V, lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs g;
  for (int i = 0; i < kMaxGrid * kMaxShape; ++i) g.v[i] = i < n_grid * k ? grid[i] : 0.0f;
  g.n = n_grid;
  BoxArgs box;
  const int m = param_count(lobe);
  for (int j = 0; j < kMaxParams; ++j) {
    box.lo[j] = j < m ? lower[j] : 0.0f;
    box.hi[j] = j < m ? upper[j] : 0.0f;
  }
  const long threads = static_cast<long>(T) * lanes;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ang, y, w, out, T, V, lanes,
                                                                     g, box);
  return static_cast<int>(cudaGetLastError());
}

// What the instantiation for V views at `lanes` lanes gets on this card:
// out[0] resident blocks an SM, out[1] registers a thread, out[2] local memory
// bytes a thread (stack and spills), out[3] threads a block.
extern "C" int brdf_grid_init_occupancy(int lobe, int V, int lanes, int* out) {
  const KernelFn kernel = pick_kernel(lobe, V, lanes);
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
