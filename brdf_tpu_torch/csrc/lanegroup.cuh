// Lane groups and warp splits: one work item (a texel) taken by several
// threads, each holding a slice of the item's views. K1 (varpro.cu), K8
// (varpro_nd.cu) and K5 (lm.cu) solve a texel with a lane group; K6 (ne.cu)
// and K7 (joint_ne.cu) sum a texel's normal equations over a warp split.
//
// A lane group: S is a power of two that divides 32, so a group never
// straddles a warp; lane l of a group holds views l, l + S, l + 2S, … ("slot"
// k holds view k·S + l), so a warp's load of one slot reads S view rows of
// 32/S consecutive texels of a views-major (V, T) array. Only the last slot of
// a lane can fall past V.
//
// A warp split: W warps of one block (W a power of two up to kSplitMaxWarps)
// take the same 32 texels, warp w holding views w, w + W, …, so every warp
// load is a whole 128-byte segment of one view row. The W partials meet in
// shared memory. W = 1 is one thread a texel: a block of kSplitThreads
// threads over as many texels, with nothing to combine.
//
// The sums are in a fixed order, so that a plain version can repeat them bit
// for bit: each thread adds its own views left to right from 0, then the S
// (or W) partials combine as the pairwise tree ((p0 + p1) + (p2 + p3)) + …
// over the partials in order. A lane group combines by log2 S rounds of an XOR
// butterfly: IEEE addition commutes, so every lane of the group ends with the
// tree's bits and the scalar work after a sum runs replicated on the S lanes
// in lockstep, with no broadcast. A warp split folds the tree in place in
// shared memory, one thread a row (ops/lanegroup.py::group_sum is the plain
// side of both).
#pragma once

#include <cuda_runtime.h>

namespace brdf {

constexpr unsigned kFullWarp = 0xffffffffu;

struct LaneGroup {
  int lane;   // this lane's index in its group, 0 … S−1
  long item;  // the group's work item: (global thread) / S
};

// s lanes an item, s a power of two dividing 32 and the block size
__device__ __forceinline__ LaneGroup lane_group(int s) {
  const long gid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  return LaneGroup{static_cast<int>(threadIdx.x) & (s - 1), gid >> (__ffs(s) - 1)};
}

// x[i] ← the sum of x[i] over this lane's group of s lanes. Every lane of the
// warp must call it, ragged or not (full-mask shuffles).
template <int N>
__device__ __forceinline__ void group_sum(float (&x)[N], int s) {
  for (int o = 1; o < s; o <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + __shfl_xor_sync(kFullWarp, x[i], o);
  }
}

// Work items handed out as groups finish theirs (K5's refill). Every lane of
// the warp calls it (full-mask ballot and shuffle); `want` is the same on the
// s lanes of a group. The warp's wanting groups take consecutive values of
// *counter with one atomicAdd, in lane order; what a group that does not want
// one gets is meaningless. Values past the work are the caller's to test.
__device__ __forceinline__ int take_items(int* counter, bool want, int s) {
  const int lane_w = static_cast<int>(threadIdx.x) & 31;
  const unsigned leaders = __ballot_sync(kFullWarp, want && (lane_w & (s - 1)) == 0);
  int base = 0;
  if (lane_w == 0 && leaders != 0u) base = atomicAdd(counter, __popc(leaders));
  base = __shfl_sync(kFullWarp, base, 0);
  return base + __popc(leaders & ((1u << (lane_w & ~(s - 1))) - 1u));
}

// A warp split's launch (see the top of this file): W = 1 takes blocks of
// kSplitThreads threads, one texel each; W > 1 blocks of 32 W threads over
// 32 texels. Dynamic shared memory holds a thread's staged views (a double
// buffer of `staged` floats a thread, 0 when it reads as it goes) and, for
// W > 1, the W partials of `rows` rows, which reuse it. False if the split is
// not one the kernels take or the shared memory passes kSplitMaxSmem.
constexpr int kSplitThreads = 128;
constexpr int kSplitMaxWarps = 8;
constexpr int kSplitMaxSmem = 48 * 1024;  // no opt-in above the default

struct SplitLaunch {
  int threads;
  long blocks;
  int smem;  // bytes
};

inline bool split_launch(int warps, long T, int rows, int staged, SplitLaunch* out) {
  if (warps < 1 || warps > kSplitMaxWarps || (warps & (warps - 1)) != 0) return false;
  out->threads = warps == 1 ? kSplitThreads : 32 * warps;
  out->blocks = warps == 1 ? (T + kSplitThreads - 1) / kSplitThreads : (T + 31) / 32;
  const int buffer = 2 * staged * out->threads;
  const int partials = warps == 1 ? 0 : rows * warps * 32;
  out->smem = (buffer > partials ? buffer : partials) * static_cast<int>(sizeof(float));
  return out->smem <= kSplitMaxSmem;
}

struct SplitPlace {
  long t;    // this thread's texel
  int part;  // its warp within the split: views part, part + W, …
};

__device__ __forceinline__ SplitPlace split_place(int warps) {
  if (warps == 1) return SplitPlace{static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x, 0};
  return SplitPlace{static_cast<long>(blockIdx.x) * 32 + (threadIdx.x & 31),
                    static_cast<int>(threadIdx.x) >> 5};
}

// A warp split's combine and store: each of the block's W warps holds
// partials x of the same 32 texels (lane = texel). They meet in smem
// (N · W · 32 floats, which may overlap the views a thread staged); then warp
// w folds rows w, w + W, … as the pairwise tree and stores each as one
// 128-byte segment of out (N, T). W = 1 stores its sums as they are. Every
// thread of the block must call it (it synchronises the block). Threads past
// T pass live = false.
template <int N>
__device__ __forceinline__ void split_store(const float (&x)[N], int warps, float* smem,
                                            float* out, long T, long t, bool live) {
  if (warps == 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (live) out[r * T + t] = x[r];
    }
    return;
  }
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int w = static_cast<int>(threadIdx.x) >> 5;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r) smem[(r * warps + w) * 32 + lane] = x[r];
  __syncthreads();
  for (int r = w; r < N; r += warps) {
    float* s = smem + r * warps * 32 + lane;
    for (int o = 1; o < warps; o <<= 1) {
      for (int p = 0; p < warps; p += 2 * o) s[p * 32] = s[p * 32] + s[(p + o) * 32];
    }
    if (live) out[r * T + t] = s[0];
  }
}

// A thread's views staged one ahead: while it computes on one view, the F
// floats of its next one travel into its own column of a double buffer in
// shared memory (stage[(buf · F + f) · nt], nt = threads a block) by cp.async,
// so the loads' latency hides behind the arithmetic without holding registers.
// Nothing is shared between threads, so nothing but the thread's own
// wait_group orders the copies.
__device__ __forceinline__ void stage_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the group committed last have landed
__device__ __forceinline__ void stage_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Texel t's views part, part + W, … in order, each as its F floats x[f] =
// *addr(f, v · T + t), handed to use(x). With STAGE they come staged one view
// ahead through the block's dynamic shared memory (F · 2 floats a thread);
// without, they are read as the loop goes.
template <int F, bool STAGE, class Addr, class Use>
__device__ __forceinline__ void walk_views(float* smem, int part, int warps, int V, long T,
                                           long t, Addr addr, Use use) {
  float x[F];
  if constexpr (STAGE) {
    const int nt = static_cast<int>(blockDim.x);
    float* const stage = smem + threadIdx.x;
    auto fetch = [&](int view, int buf) {
      const long idx = static_cast<long>(view) * T + t;
      float* const dst = stage + buf * F * nt;
#pragma unroll
      for (int f = 0; f < F; ++f) stage_f32(dst + f * nt, addr(f, idx));
    };
    int buf = 0;
    if (part < V) fetch(part, 0);
    stage_commit();
    for (int v = part; v < V; v += warps) {
      if (v + warps < V) fetch(v + warps, buf ^ 1);
      stage_commit();
      stage_wait_prior();
      const float* const src = stage + buf * F * nt;
      buf ^= 1;
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = src[f * nt];
      use(x);
    }
  } else {
    for (int v = part; v < V; v += warps) {
      const long idx = static_cast<long>(v) * T + t;
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = *addr(f, idx);
      use(x);
    }
  }
}

}  // namespace brdf
