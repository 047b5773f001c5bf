// Host emulation of gpuschedule_tpu_torch/ops/csrc/mma_bf16.cuh: the same
// names, with the PTX semantics of cp.async, ldmatrix and
// mma.sync.m16n8k16 (row.col, bf16 in, f32 accumulate) written out.  The
// fragment layouts are those listed in the header this file stands in for.
#pragma once

#include "emu.h"

namespace {
alignas(16) float4 smem4[1 << 15];  // one block's dynamic shared memory, 512 KiB
}

namespace mma_bf16 {

inline char* emu_smem() { return reinterpret_cast<char*>(smem4); }

inline uint32_t smem_addr(const void* p) {
  return uint32_t(static_cast<const char*>(p) - emu_smem());
}

inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  emu_thread->open_group.push_back({dst, src, valid ? 16 : 0, 16});
}
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  emu_thread->open_group.push_back({dst, src, valid ? 4 : 0, 4});
}
inline void cp_async_commit() {
  emu_thread->groups.push_back(emu_thread->open_group);
  emu_thread->open_group.clear();
}
template <int N>
inline void cp_async_wait() {
  auto& groups = emu_thread->groups;
  while ((int)groups.size() > N) {
    for (const EmuCopy& c : groups.front()) {
      std::memset(emu_smem() + c.dst, 0, c.size);
      if (c.n) std::memcpy(emu_smem() + c.dst, c.src, c.n);
    }
    groups.pop_front();
  }
}

inline uint16_t emu_ld16(uint32_t addr) {
  uint16_t v;
  std::memcpy(&v, emu_smem() + addr, 2);
  return v;
}

// Lanes 8j..8j+7 give the row addresses of matrix j; lane (g, t) receives
// row g, columns 2t and 2t+1 (trans: rows 2t and 2t+1, column g).
inline void emu_ldmatrix(uint32_t (&r)[4], uint32_t addr, bool trans) {
  EmuWarp& w = *emu_warp;
  const int lane = emu_lane, g = lane >> 2, t = lane & 3;
  w.unfenced[lane] = true;
  w.u[lane][0] = addr;
  emu_wait(w.bar);
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (!trans) {
      const uint32_t a = w.u[8 * j + g][0] + t * 4;
      lo = emu_ld16(a);
      hi = emu_ld16(a + 2);
    } else {
      lo = emu_ld16(w.u[8 * j + 2 * t][0] + g * 2);
      hi = emu_ld16(w.u[8 * j + 2 * t + 1][0] + g * 2);
    }
    r[j] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  emu_wait(w.bar);
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, true); }

inline float emu_half(uint32_t r, int hi) {
  return __bfloat162float(__nv_bfloat16{uint16_t(hi ? r >> 16 : r & 0xffffu)});
}

// Every lane posts its fragments; each rebuilds A (16 x 16) and B (16 x 8)
// and computes its own four accumulator entries.
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = *emu_warp;
  const int lane = emu_lane;
  for (int i = 0; i < 4; ++i) w.u[lane][i] = a[i];
  w.u[lane][4] = b0;
  w.u[lane][5] = b1;
  emu_wait(w.bar);
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(w.u[l][0], h);
      A[g + 8][2 * t + h] = emu_half(w.u[l][1], h);
      A[g][8 + 2 * t + h] = emu_half(w.u[l][2], h);
      A[g + 8][8 + 2 * t + h] = emu_half(w.u[l][3], h);
      B[2 * t + h][g] = emu_half(w.u[l][4], h);
      B[8 + 2 * t + h][g] = emu_half(w.u[l][5], h);
    }
  }
  emu_wait(w.bar);
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    float s = d[e];
    for (int kk = 0; kk < 16; ++kk) s += A[row][kk] * B[kk][col];
    d[e] = s;
  }
}

inline float exp2_approx(float x) {  // ftz: subnormal results are 0
  const float y = exp2f(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}

inline uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  std::memcpy(&r, &v, 4);
  return r;
}

inline void a_from_c(uint32_t (&a)[4], const float (&c_lo)[4], const float (&c_hi)[4]) {
  a[0] = pack(c_lo[0], c_lo[1]);
  a[1] = pack(c_lo[2], c_lo[3]);
  a[2] = pack(c_hi[0], c_hi[1]);
  a[3] = pack(c_hi[2], c_hi[3]);
}

}  // namespace mma_bf16
