// Lane groups: one work item (a texel) solved by a group of S lanes of one
// warp, each lane holding a slice of the item's views in registers. Used by K8
// (varpro_nd.cu) and K5 (lm.cu); meant for the kernels that walk every view of
// a texel in one thread today (K6 ne.cu, K7 joint_ne.cu).
//
// The layout: S is a power of two that divides 32, so a group never straddles
// a warp; lane l of a group holds views l, l + S, l + 2S, … ("slot" k holds
// view k·S + l), so a warp's load of one slot reads S view rows of 32/S
// consecutive texels of a views-major (V, T) array. Only the last slot of a
// lane can fall past V.
//
// The sums are in a fixed order, so that a plain version can repeat them bit
// for bit: each lane adds its own views left to right from 0, then the group
// combines its S partials by log2 S rounds of an XOR butterfly. IEEE addition
// commutes, so every lane of the group ends with the same bits, those of the
// pairwise tree ((p0 + p1) + (p2 + p3)) + … over the lanes in order, and the
// scalar work after a sum runs replicated on the S lanes in lockstep, with no
// broadcast.
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

}  // namespace brdf
