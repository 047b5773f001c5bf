// Host emulation of the CUDA device features the flash-attention and
// overhead-probe kernels use, so that g++ can compile their source and run it
// on the CPU (tests/test_torch_cuda_emulated.py,
// tests/test_torch_probe_emulated.py).  A block's threads are coroutines
// (ucontext) on one OS thread, switched only where a thread waits at a
// barrier; the warp-wide operations (shuffles, ldmatrix, mma) exchange values
// through the warp's slots between two warp barriers, and __syncthreads is a
// barrier over the block.  This checks a kernel's indexing, fragment
// layouts, masking and pipeline order; it says nothing of its speed, and it
// is no substitute for running it on the card.
#pragma once

#include <math.h>

#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline emu_uint3 threadIdx, blockIdx;  // set for the thread the scheduler resumes

struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline int min(int a, int b) { return a < b ? a : b; }

// cp.async: a thread's copies are held back until a wait retires their group,
// so a kernel that reads a stage before waiting for it reads stale data.
struct EmuCopy { uint32_t dst; const void* src; int n, size; };

struct EmuBarrier {
  int n, count = 0;
  unsigned generation = 0;
};

struct EmuWarp {
  EmuBarrier bar{32};
  float f[32];
  uint32_t u[32][8];
  // lanes whose ldmatrix reads of shared memory no fence.proxy.async has ordered yet before
  // the async proxy (bulk copies) may write there (bulk_copy.cuh)
  bool unfenced[32] = {};
};

// A bulk store (shared -> global) whose source has not been read yet: it is read, and lands,
// only when its thread's wait_read retires its group (bulk_copy.cuh).
struct EmuBulkStore { void* dst; uint32_t src; int bytes; };

// One simulated thread: its context, stack and pending cp.async and bulk-store groups.
struct EmuThread {
  ucontext_t ctx;
  std::vector<char> stack;
  std::vector<EmuCopy> open_group;
  std::deque<std::vector<EmuCopy>> groups;
  std::vector<EmuBulkStore> bulk_open;
  std::deque<std::vector<EmuBulkStore>> bulk_groups;
  bool done = false;
};

// The running block, and the thread the scheduler last resumed.
inline ucontext_t emu_main;
inline EmuThread* emu_thread;
inline EmuWarp* emu_warp;
inline int emu_lane;
inline EmuBarrier* emu_block_bar;
inline unsigned long emu_arrivals;  // barrier arrivals so far: the scheduler's progress
inline const char* emu_fault;      // set when an emulated instruction is misused

inline void emu_wait(EmuBarrier& b) {
  const unsigned gen = b.generation;
  ++emu_arrivals;
  if (++b.count == b.n) {
    b.count = 0;
    ++b.generation;
    return;
  }
  while (b.generation == gen) swapcontext(&emu_thread->ctx, &emu_main);
}

inline void __syncthreads() { emu_wait(*emu_block_bar); }
inline void __syncwarp() { emu_wait(emu_warp->bar); }  // all 32 lanes

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& w = *emu_warp;
  w.f[emu_lane] = v;
  emu_wait(w.bar);
  const float r = w.f[emu_lane ^ mask];
  emu_wait(w.bar);
  return r;
}
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int mask) {
  EmuWarp& w = *emu_warp;
  w.u[emu_lane][0] = v;
  emu_wait(w.bar);
  const uint32_t r = w.u[emu_lane ^ mask][0];
  emu_wait(w.bar);
  return r;
}
