// Tensor-core building blocks for sm_80+ (used on sm_90a): cp.async copies
// into shared memory, ldmatrix fragment loads, and the bf16 m16n8k16 mma.sync
// with f32 accumulation.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each 32-bit register holding two bf16 with the lower column
// (or k) index in the low half:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
//                           a3 = (g+8, 8+2t..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8, 2t+1)
// ldmatrix.x4 reads four 8 x 8 b16 matrices whose row addresses come from
// lanes 0-7, 8-15, 16-23 and 24-31; register i gets matrix i with lane
// holding row g, columns 2t..2t+1 (.trans: row 2t..2t+1, column g).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; !valid writes zeros
// (the source is not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b on the tensor cores: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error ~2^-22; subnormal results
// flush to 0, so a masked score's 2^(-1e30) is exactly 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 (nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 product from four 16 x 8 f32 accumulators laid
// out as C fragments: columns 0-7 in c_lo, 8-15 in c_hi.  This is how a score
// tile computed by one mma becomes, in registers, the left operand of the next.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c_lo)[4],
                                         const float (&c_hi)[4]) {
  a[0] = pack(c_lo[0], c_lo[1]);
  a[1] = pack(c_lo[2], c_lo[3]);
  a[2] = pack(c_hi[0], c_hi[1]);
  a[3] = pack(c_hi[2], c_hi[3]);
}

}  // namespace mma_bf16
