// A warp on the host: runs a CUDA kernel's source with g++ one lane at a
// time, each lane a context (a stack) of its own, and every warp intrinsic a point
// where the lane yields until all 32 lanes of its warp have reached it
// (tools/joint_levmar_host.py builds a kernel against this header). The
// warps of every block of the grid take turns, one intrinsic each, so lane
// groups, warp votes, shuffles, the work counter's refill and a block's
// shared memory behave as on a card where every warp keeps pace; a warp
// whose lanes reach different intrinsics, or leave the kernel apart, is an
// error (brdf_host_error) and stops the launch.
//
// Force-included ahead of the kernel's source with its own cuda_runtime.h.
#pragma once

#include <ucontext.h>

#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};

namespace brdf_host {

enum Op { kNone, kShflXor, kShfl, kAny, kBallot, kSyncwarp };

// A lane's context: on x86-64 a stack pointer and a switch that saves the
// callee-saved registers and the floating-point control words (no signal
// mask, so no system call a switch); elsewhere ucontext.
#if defined(__x86_64__)
extern "C" void brdf_host_switch(void** save, void* to);
__asm__(
    ".text\n"
    ".globl brdf_host_switch\n"
    ".hidden brdf_host_switch\n"
    ".type brdf_host_switch,@function\n"
    "brdf_host_switch:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n  pushq %r15\n"
    "  subq $8, %rsp\n  stmxcsr (%rsp)\n  fnstcw 4(%rsp)\n"
    "  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  ldmxcsr (%rsp)\n  fldcw 4(%rsp)\n  addq $8, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n"
    "  ret\n"
    ".size brdf_host_switch, .-brdf_host_switch\n");

struct Ctx {
  void* sp = nullptr;
};

// a context that enters entry() on its first switch, on the stack [base, base + size)
inline void make_ctx(Ctx& c, char* base, size_t size, void (*entry)()) {
  auto top = reinterpret_cast<uintptr_t>(base + size) & ~uintptr_t{15};
  auto* slot = reinterpret_cast<uint64_t*>(top);
  slot[-1] = 0;                                      // entry's return address: none
  slot[-2] = reinterpret_cast<uint64_t>(entry);      // what the switch returns to
  for (int r = 3; r <= 8; ++r) slot[-r] = 0;         // rbp, rbx, r12–r15
  uint32_t ctl[2] = {0x1f80u, 0x037fu};              // mxcsr, x87 control word
  std::memcpy(&slot[-9], ctl, 8);
  c.sp = &slot[-9];
}
inline void switch_ctx(Ctx& from, Ctx& to) { brdf_host_switch(&from.sp, to.sp); }
#else
struct Ctx {
  ucontext_t uc;
};
inline void make_ctx(Ctx& c, char* base, size_t size, void (*entry)()) {
  getcontext(&c.uc);
  c.uc.uc_stack.ss_sp = base;
  c.uc.uc_stack.ss_size = size;
  c.uc.uc_link = nullptr;
  makecontext(&c.uc, entry, 0);
}
inline void switch_ctx(Ctx& from, Ctx& to) { swapcontext(&from.uc, &to.uc); }
#endif

struct Lane {
  Ctx ctx;
  Op op = kNone;
  unsigned mask = 0;
  float f = 0.0f;
  int i = 0, arg = 0;
  float out_f = 0.0f;
  int out_i = 0;
  bool done = false;
};

struct Warp {
  Lane lanes[32];
  int block = 0, warp = 0;
  bool done = false;
};

inline Ctx g_sched;
inline Warp* g_warp = nullptr;
inline int g_lane = 0;
inline float* g_smem = nullptr;
inline const char* g_error = nullptr;
inline int g_sms = 132;
inline std::function<void()> g_body;
inline dim3 g_thread, g_block, g_dim;

inline void arrive(Op op) {
  Lane& l = g_warp->lanes[g_lane];
  l.op = op;
  switch_ctx(l.ctx, g_sched);
}

// a lane's life: the kernel, then back to the scheduler for good
inline void lane_main() {
  g_body();
  Lane& l = g_warp->lanes[g_lane];
  l.done = true;
  switch_ctx(l.ctx, g_sched);
  __builtin_trap();
}

// one step of a warp: every lane runs to its next intrinsic (or its end),
// then the intrinsic is resolved for the 32 lanes together
inline void step(Warp& w, std::vector<std::vector<float>>& smem, int threads) {
  for (int l = 0; l < 32; ++l) {
    Lane& lane = w.lanes[l];
    if (lane.done) continue;
    g_warp = &w;
    g_lane = l;
    g_thread = dim3{static_cast<unsigned>(w.warp * 32 + l), 0, 0};
    g_block = dim3{static_cast<unsigned>(w.block), 0, 0};
    g_dim = dim3{static_cast<unsigned>(threads), 1, 1};
    g_smem = smem[w.block].data();
    switch_ctx(g_sched, lane.ctx);
  }
  int finished = 0;
  for (auto& lane : w.lanes) finished += lane.done;
  if (finished == 32) {
    w.done = true;
    return;
  }
  if (finished != 0) {
    g_error = "lanes of a warp left the kernel apart";
    return;
  }
  const Op op = w.lanes[0].op;
  for (auto& lane : w.lanes) {
    if (lane.op != op) {
      g_error = "lanes of a warp reached different intrinsics";
      return;
    }
    if (lane.mask != 0xffffffffu) {
      g_error = "an intrinsic with a partial mask";
      return;
    }
  }
  unsigned ballot = 0;
  for (int l = 0; l < 32; ++l) ballot |= (w.lanes[l].i != 0 ? 1u : 0u) << l;
  for (int l = 0; l < 32; ++l) {
    Lane& lane = w.lanes[l];
    switch (op) {
      case kShflXor: lane.out_f = w.lanes[l ^ lane.arg].f; break;
      case kShfl: lane.out_i = w.lanes[lane.arg & 31].i; break;
      case kAny: lane.out_i = ballot != 0u; break;
      case kBallot: lane.out_i = static_cast<int>(ballot); break;
      default: break;
    }
    lane.op = kNone;
  }
}

// the launch: grid × threads lanes, each with its own stack, the warps
// stepping in turn until every lane has left the kernel
template <class Kernel, class... Args>
void launch(Kernel kernel, unsigned grid, int threads, int smem_bytes, Args... args) {
  g_error = nullptr;
  if (threads % 32 != 0) {
    g_error = "a block that is not whole warps";
    return;
  }
  g_body = [=] { kernel(args...); };
  const int warps_a_block = threads / 32;
  std::vector<std::vector<float>> smem(grid);
  for (auto& s : smem) {
    // what the kernel reads before it writes shows as NaN
    s.assign((smem_bytes + 3) / 4, 0.0f);
    const uint32_t nan_bits = 0x7fc00001u;
    for (auto& x : s) std::memcpy(&x, &nan_bits, 4);
  }
  std::vector<Warp> warps(static_cast<size_t>(grid) * warps_a_block);
  constexpr size_t kStack = 256 * 1024;
  std::vector<char> stacks(warps.size() * 32 * kStack);
  for (size_t k = 0; k < warps.size(); ++k) {
    warps[k].block = static_cast<int>(k / warps_a_block);
    warps[k].warp = static_cast<int>(k % warps_a_block);
    for (int l = 0; l < 32; ++l)
      make_ctx(warps[k].lanes[l].ctx, stacks.data() + (k * 32 + l) * kStack, kStack, lane_main);
  }
  for (bool left = true; left && g_error == nullptr;) {
    left = false;
    for (auto& w : warps) {
      if (w.done) continue;
      step(w, smem, threads);
      if (g_error != nullptr) return;
      left = left || !w.done;
    }
  }
}

}  // namespace brdf_host

#define threadIdx (brdf_host::g_thread)
#define blockIdx (brdf_host::g_block)
#define blockDim (brdf_host::g_dim)

inline float __shfl_xor_sync(unsigned mask, float x, int o) {
  auto& l = brdf_host::g_warp->lanes[brdf_host::g_lane];
  l.mask = mask;
  l.f = x;
  l.arg = o;
  brdf_host::arrive(brdf_host::kShflXor);
  return l.out_f;
}

inline int __shfl_sync(unsigned mask, int x, int src) {
  auto& l = brdf_host::g_warp->lanes[brdf_host::g_lane];
  l.mask = mask;
  l.i = x;
  l.arg = src;
  brdf_host::arrive(brdf_host::kShfl);
  return l.out_i;
}

inline int __any_sync(unsigned mask, int p) {
  auto& l = brdf_host::g_warp->lanes[brdf_host::g_lane];
  l.mask = mask;
  l.i = p != 0;
  brdf_host::arrive(brdf_host::kAny);
  return l.out_i;
}

inline unsigned __ballot_sync(unsigned mask, int p) {
  auto& l = brdf_host::g_warp->lanes[brdf_host::g_lane];
  l.mask = mask;
  l.i = p != 0;
  brdf_host::arrive(brdf_host::kBallot);
  return static_cast<unsigned>(l.out_i);
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  auto& l = brdf_host::g_warp->lanes[brdf_host::g_lane];
  l.mask = mask;
  brdf_host::arrive(brdf_host::kSyncwarp);
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
inline void __syncthreads() { brdf_host::g_error = "__syncthreads is not emulated"; }
