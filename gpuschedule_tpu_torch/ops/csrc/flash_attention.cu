// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of gpuschedule_tpu/ops/flash_attention.py:
//   fwd_mma_kernel (bf16), fwd_kernel (f32)        <- _fwd_kernel       (:98-152)
//   dq_mma_kernel (bf16), bwd_dq_kernel (f32)      <- _bwd_dq_kernel    (:155-199)
//   dkdv_mma_kernel (bf16), bwd_dkdv_kernel (f32)  <- _bwd_dkdv_kernel  (:202-252)
// They compute what the Pallas kernels compute (the plain PyTorch versions in
// ../flash_attention.py spell it out), not how: Pallas walks a sequential grid
// and carries state across k steps in VMEM scratch; here one thread block owns
// one (batch*head, 64-row tile) and loops over the other tiles itself, so the
// causal skip is a loop bound and the state lives in registers.  The dtype
// picks the kernel: bf16 (the model's dtype, the main path) runs the
// tensor-core kernels, f32 the FMA kernels, for all three functions.
// Neither is a fallback for the other.
//
// Output forms.  The tensor-core kernels are templated on their output type:
// bf16, outputs like the inputs (the op's form), or f32 from bf16 inputs, the
// form the ring's chunk ops launch (flash_chunk_fwd / flash_chunk_bwd, JAX's
// out_dtype=jnp.float32 at :519-561): each (q-chunk, k-chunk) pair's out, dq,
// dk and dv are merged and summed across the ring in f32, so they must not be
// rounded to bf16 first.  The accumulators are f32 in registers either way;
// only the epilogue's store differs (store2).  The FMA kernels store f32.
//
// Layout.  q, k, v, dO, O, dq, dk, dv are read and written in the caller's
// (B, S, H, D) layout (row (b, s, h) starts at ((b*S + s)*H + h)*D), so no
// transpose or padding copy is made.  lse and delta are plain (B*H, S) f32
// rows.  The ragged tail (rows or columns >= S) is masked inside the kernels,
// the `cols < seq_len` rule of the Pallas `_mask`: padding is never visible.
//
// Numerics, as in the Pallas kernels.  Products take their operands in the
// input dtype (bf16 or f32) and accumulate in f32.  sm_scale multiplies the
// f32 product; p is rounded to V's dtype before p.V and p^T.dO, ds to K's and
// q's dtype before ds.K and ds^T.q.  The running max, denominator and
// accumulators are f32 in registers; masked entries of p are exactly 0; lse is
// the natural-log logsumexp m + log(l).  The tensor-core kernels take their
// exponentials as exp2 (ex2.approx, relative error ~2^-22) with log2(e)
// folded into the scale (and into lse in the backward): the same function,
// with the f32 rounding of one more product in the exponent's argument.
//
// Bound.  At transformer-long's shape (B*H = 16, S = 4096, D = 32, causal,
// bf16) the work is matmul FLOPs: forward 17.2 GFLOP, dq 25.8, dk/dv 34.4,
// against ~17 MB of q/k/v/o traffic, so the tensor-core rate (989 TFLOP/s
// bf16) sets the bound, not the 3.35 TB/s memory.  At D = 32 the softmax's
// per-score work (scale, mask, max, exp2, sum: ~10 instructions and one MUFU
// exp2 for every 2*2*32 matmul FLOPs) is large beside the products, so the
// exp2 and FMA pipes, not only the tensor cores, bound a real kernel.
//
// Design of the tensor-core kernels (bf16).  One block of 4 warps owns a
// 64-row tile; each warp owns 16 of its rows.
//   * Products are mma.sync.m16n8k16 bf16 with f32 accumulators
//     (mma_bf16.cuh).  A score tile computed by one mma is rounded and packed
//     in registers as the A operand of the next (p.V; ds.K in dq; p^T.dO and
//     ds^T.q in dk/dv), so p and ds never pass through shared memory.
//   * The tiles that stream (K and V in the forward and dq, q and dO in dk/dv)
//     come in through a 2-stage cp.async ring: tile j+1 is in flight while
//     tile j is computed.  The block's own tiles (q; q and dO; k and v) are
//     read once into registers as A fragments.
//   * Shared-memory rows are padded by 16 bytes (D + 8 bf16), so the eight
//     16-byte rows that one ldmatrix phase reads fall in eight distinct bank
//     groups at every head dim: no bank conflicts, no swizzle.
//   * Row statistics (max, sum) are reduced over the 4 lanes of a quad that
//     share a row: two shuffles.
//   * Mask arithmetic runs only on the diagonal tile and on the ragged last
//     tile; tiles above the diagonal are skipped by the loop bound, and the
//     heaviest blocks are launched first.
//   * The dq kernel is the forward's loop with the backward's arithmetic:
//     p from the saved lse (no online rescaling), dp = dO.V^T beside
//     s = q.K^T, and ds packed as the A operand of dq += ds.K, whose B operand
//     is the same K tile read with ldmatrix.trans.
//   * The dk/dv kernel is written transposed (S^T = K.q^T, its rows the
//     block's keys), so p^T and ds^T come out of the mma already in the A
//     layout of dV += p^T.dO and dK += ds^T.q.
//   * At D > 64 the two backward kernels walk each streamed tile in halves
//     of 32 rows, and reload their own tiles' fragments from shared memory,
//     to keep their accumulators (dq; dK and dV) in registers.
// Not yet: wgmma, TMA, warp specialisation, persistent blocks.
//
// Design of the FMA kernels (f32).  Products as f32 FMA loops on CUDA cores
// from shared-memory tiles: each K/V (or Q/dO) tile is loaded once per block
// and reused by all 64 rows of the block's tile; each of 256 threads keeps a
// 4 x 4 patch of the score tile and 4 rows of the output in registers, so
// every shared-memory load feeds 4 FMAs or more.  The tensor
// cores have no f32 x f32 product short of TF32, which would change f32
// results, so f32 inputs stay here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // k rows per tile
constexpr int NT = 256;     // threads per block: 16 x 16, each owns a 4 x 4 score patch
constexpr int LD = 68;      // row stride of transposed tiles: float4-aligned, spreads banks
constexpr float NEG_INF = -1e30f;

static_assert(BQ == 64 && BK == 64, "the thread mapping assumes 64 x 64 tiles");

// Rows [r0, r0 + 64) of one head's (S, D) matrix into dst[d * LD + r] (f32,
// transposed); rows >= S load as 0.
template <int D>
__device__ __forceinline__ void load_tile_t(float* dst, const float* src, size_t base,
                                            int r0, int S, int HD) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[d * LD + r] = s < S ? src[base + (size_t)s * HD + d] : 0.f;
  }
}

// The same rows into dst[r * D + d] (f32, row-major).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t base,
                                          int r0, int S, int HD) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * D + d] = s < S ? src[base + (size_t)s * HD + d] : 0.f;
  }
}

// Reductions over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- forward --
// grid (nq, B*H); thread (tr, tc) owns q rows tr*4 + i and key columns
// tc + 16*j of the score tile, and output columns tc + 16*dc.
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
           int S, int H, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // D x LD
  float* kT = qT + D * LD;                       // D x LD
  float* vs = kT + D * LD;                       // BK x D
  float* pT = vs + BK * D;                       // BK x LD: p transposed

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int q0 = qi * BQ;

  load_tile_t<D>(qT, q, base, q0, S, HD);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[i][dc] = 0.f;
  }

  // k tiles wholly above the diagonal contribute nothing: stop before them
  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<D>(kT, k, base, k0, S, HD);
    load_tile<D>(vs, v, base, k0, S, HD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * LD + tr * 4]);
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = kT[d * LD + tc + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] += a.x * kk[j];
        s[1][j] += a.y * kk[j];
        s[2][j] += a.z * kk[j];
        s[3][j] += a.w * kk[j];
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        const bool ok = col < S && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) acc[i][dc] *= corr;
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&pT[(tc + 16 * j) * LD + tr * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&pT[c * LD + tr * 4]);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float x = vs[c * D + tc + 16 * dc];
        acc[0][dc] += p.x * x;
        acc[1][dc] += p.y * x;
        acc[2][dc] += p.z * x;
        acc[3][dc] += p.w * x;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row < S) {
      const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
        o[base + (size_t)row * HD + tc + 16 * dc] = acc[i][dc] / lf;
      if (tc == 0) lse[(size_t)bh * S + row] = m[i] + logf(lf);
    }
  }
}

// -------------------------------------------------------------------- dq --
// grid (nq, B*H); the thread mapping of the forward.
template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq,
              int S, int H, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // D x LD
  float* gT = qT + D * LD;                       // D x LD
  float* kT = gT + D * LD;                       // D x LD
  float* vT = kT + D * LD;                       // D x LD
  float* dsT = vT + D * LD;                      // BK x LD: ds transposed

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int q0 = qi * BQ;

  load_tile_t<D>(qT, q, base, q0, S, HD);
  load_tile_t<D>(gT, g, base, q0, S, HD);
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    lse_r[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[i][dc] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tile_t<D>(kT, k, base, k0, S, HD);
    load_tile_t<D>(vT, v, base, k0, S, HD);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * LD + tr * 4]);
      const float4 gg = *reinterpret_cast<const float4*>(&gT[d * LD + tr * 4]);
      float kk[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = kT[d * LD + tc + 16 * j];
        vv[j] = vT[d * LD + tc + 16 * j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] += a.x * kk[j];
        s[1][j] += a.y * kk[j];
        s[2][j] += a.z * kk[j];
        s[3][j] += a.w * kk[j];
        dp[0][j] += gg.x * vv[j];
        dp[1][j] += gg.y * vv[j];
        dp[2][j] += gg.z * vv[j];
        dp[3][j] += gg.w * vv[j];
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tc + 16 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + tr * 4 + i;
        const bool ok = row < S && col < S && (!causal || row >= col);
        // normalized probabilities from the saved logsumexp; masked entries are 0
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[i] = p * (dp[i][j] - delta_r[i]) * scale;
      }
      *reinterpret_cast<float4*>(&dsT[(tc + 16 * j) * LD + tr * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&dsT[c * LD + tr * 4]);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float x = kT[(tc + 16 * dc) * LD + c];
        acc[0][dc] += a.x * x;
        acc[1][dc] += a.y * x;
        acc[2][dc] += a.z * x;
        acc[3][dc] += a.w * x;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row < S) {
#pragma unroll
      for (int dc = 0; dc < DC; ++dc)
        dq[base + (size_t)row * HD + tc + 16 * dc] = acc[i][dc];
    }
  }
}

// ------------------------------------------------------------------ dk/dv --
// grid (nk, B*H); thread (a, bq) owns key rows a*4 + i and query columns
// bq + 16*j of the transposed score tile, and gradient columns bq + 16*dc.
// dk and dv accumulate in f32 registers over the q tiles and are written once.
template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv,
                int S, int H, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // D x LD
  float* vT = kT + D * LD;                       // D x LD
  float* qT = vT + D * LD;                       // D x LD
  float* gT = qT + D * LD;                       // D x LD
  float* ps = gT + D * LD;                       // BQ x LD: p by q row
  float* dss = ps + BQ * LD;                     // BQ x LD: ds by q row
  float* lse_s = dss + BQ * LD;                  // BQ
  float* delta_s = lse_s + BQ;                   // BQ

  const int kb = blockIdx.x;  // low k tiles see the most q tiles: launched first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int a = threadIdx.x / 16, bq = threadIdx.x % 16;
  const int k0 = kb * BK;

  load_tile_t<D>(kT, k, base, k0, S, HD);
  load_tile_t<D>(vT, v, base, k0, S, HD);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) dk_acc[i][dc] = dv_acc[i][dc] = 0.f;

  // q tiles wholly above this k tile see none of it: start at the diagonal
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile_t<D>(qT, q, base, q0, S, HD);
    load_tile_t<D>(gT, g, base, q0, S, HD);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      delta_s[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(&kT[d * LD + a * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&vT[d * LD + a * 4]);
      float qq[4], gg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = qT[d * LD + bq + 16 * j];
        gg[j] = gT[d * LD + bq + 16 * j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] += kk.x * qq[j];
        s[1][j] += kk.y * qq[j];
        s[2][j] += kk.z * qq[j];
        s[3][j] += kk.w * qq[j];
        dp[0][j] += vv.x * gg[j];
        dp[1][j] += vv.y * gg[j];
        dp[2][j] += vv.z * gg[j];
        dp[3][j] += vv.w * gg[j];
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = bq + 16 * j, row = q0 + rl;
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + a * 4 + i;
        const bool ok = row < S && col < S && (!causal || row >= col);
        const float p = ok ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        pr[i] = p;
        dr[i] = p * (dp[i][j] - delta_s[rl]) * scale;
      }
      *reinterpret_cast<float4*>(&ps[rl * LD + a * 4]) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(&dss[rl * LD + a * 4]) = make_float4(dr[0], dr[1], dr[2], dr[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[r * LD + a * 4]);
      const float4 ds = *reinterpret_cast<const float4*>(&dss[r * LD + a * 4]);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float gg = gT[(bq + 16 * dc) * LD + r];
        const float qq = qT[(bq + 16 * dc) * LD + r];
        dv_acc[0][dc] += p.x * gg;
        dv_acc[1][dc] += p.y * gg;
        dv_acc[2][dc] += p.z * gg;
        dv_acc[3][dc] += p.w * gg;
        dk_acc[0][dc] += ds.x * qq;
        dk_acc[1][dc] += ds.y * qq;
        dk_acc[2][dc] += ds.z * qq;
        dk_acc[3][dc] += ds.w * qq;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + a * 4 + i;
    if (row < S) {
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const size_t off = base + (size_t)row * HD + bq + 16 * dc;
        dk[off] = dk_acc[i][dc];
        dv[off] = dv_acc[i][dc];
      }
    }
  }
}

// ------------------------------------------------ tensor-core kernels (bf16) --

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int NTC = 128;  // threads of a tensor-core block: 4 warps x 16 rows
static_assert(NTC == 2 * BQ, "the dk/dv kernel loads lse and delta rows one thread each");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory row stride of a 64 x D bf16 tile: D + 8 elements, so the rows
// of one ldmatrix phase land in distinct bank groups (see the header).
template <int D> constexpr int LDS = D + 8;
template <int D> constexpr int TILE_ELEMS = 64 * LDS<D>;

// Rows [r0, r0 + 64) of one head's (S, D) bf16 matrix into dst[r * (D + 8) + d]
// with cp.async, 16 bytes a copy; rows >= S are filled with zeros.
template <int D>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, size_t base, int r0,
                                           int S, int HD) {
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  static_assert(64 * CH % NTC == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < 64 * CH / NTC; ++it) {
    const int i = threadIdx.x + it * NTC, r = i / CH, c = i % CH, s = r0 + r;
    const bool ok = s < S;
    cp_async16(smem_addr(dst + r * LDS<D> + c * 8),
               src + base + (size_t)(ok ? s : 0) * HD + c * 8, ok);
  }
}

// The A fragments of rows [r0, r0 + 16) of a smem tile, all D columns.
template <int D>
__device__ __forceinline__ void a_frags(uint32_t (&a)[D / 16][4], const bf16* tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(a[kk], smem_addr(tile + (r0 + (lane & 15)) * LDS<D> + kk * 16 +
                                 (lane >> 4) * 8));
}

// B fragments of (rows of tile)^T for n-blocks 2*nb2 and 2*nb2 + 1 of the
// rows starting at r0, k-step kk of the D columns: {b0, b1} of each.
template <int D>
__device__ __forceinline__ void bt_frags(uint32_t (&b)[4], const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, smem_addr(tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * LDS<D> +
                           kk * 16 + ((lane >> 3) & 1) * 8));
}

// B fragments of the tile itself (k = its rows r0..r0+15, n = its columns),
// for column blocks 2*nd2 and 2*nd2 + 1: {b0, b1} of each.
template <int D>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const bf16* tile, int r0, int nd2) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_addr(tile + (r0 + (lane & 15)) * LDS<D> + nd2 * 16 +
                                 (lane >> 4) * 8));
}

// Columns c and c + 1 of one output row from the f32 accumulators, in the
// output's type: a packed bf16 pair (the op's form, out like its inputs) or
// two f32 (the ring's chunk form: each chunk pair's out, dq, dk and dv are
// merged and summed across the ring in f32, so they are not rounded first).
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------- forward, bf16 (K1) --
// grid (nq, B*H), 128 threads; warp w owns q rows q0 + 16w .. q0 + 16w + 15,
// lane (g, t) rows g and g + 8 of them.  Shared memory: q (64 x D), then two
// stages of K and V (64 x D each).  At D = 32, left to itself, ptxas holds
// the kernel to 96 registers and spills; asking for 4 blocks an SM lets it
// use up to 128.
template <int D, typename OutT>
__global__ void __launch_bounds__(NTC, D == 32 ? 4 : 1)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, OutT* __restrict__ o, float* __restrict__ lse,
               int S, int H, float scale, int causal) {
  constexpr int KS = D / 16, ND = D / 8, NB = BK / 8, TE = TILE_ELEMS<D>;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + TE;      // 2 stages
  bf16* vs = ks + 2 * TE;  // 2 stages

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8

  // k tiles wholly above the diagonal contribute nothing: stop before them
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;

  tile_async<D>(qs, q, base, q0, S, HD);
  cp_async_commit();
  tile_async<D>(ks, k, base, 0, S, HD);
  tile_async<D>(vs, v, base, 0, S, HD);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; the first K/V tile may still be in flight
  __syncthreads();
  uint32_t qf[KS][4];  // this warp's 16 q rows, held for the whole loop
  a_frags<D>(qf, qs, warp * 16);

  const float scale2 = scale * LOG2E;  // scores in log2 units: exp2(s2 - m2)
  float acc[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {  // the next tile is in flight while this one is computed
      const int st = (j + 1) & 1;
      tile_async<D>(ks + st * TE, k, base, k0 + BK, S, HD);
      tile_async<D>(vs + st * TE, v, base, k0 + BK, S, HD);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the group just committed has landed
    __syncthreads();
    const bf16* kt = ks + (j & 1) * TE;
    const bf16* vt = vs + (j & 1) * TE;

    // s = q k^T: 16 rows x 64 keys per warp
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t bk[4];
        bt_frags<D>(bk, kt, nb2 * 16, kk);
        mma(s[2 * nb2], qf[kk], bk[0], bk[1]);
        mma(s[2 * nb2 + 1], qf[kk], bk[2], bk[3]);
      }

    // scale, mask (diagonal and ragged tiles only), online softmax
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale2;
        if (masked) {
          const int row = row0 + (e >> 1) * 8, col = k0 + nb * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) x = NEG_INF;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];  // l is this lane's partial sum; the quad's is summed at the end
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[nb][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nb][e] = p;
      }

    // o += bf16(p) v, p straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t bv[4];
        b_frags<D>(bv, vt, kk * 16, nd2);
        mma(acc[2 * nd2], pa, bv[0], bv[1]);
        mma(acc[2 * nd2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row < S) {
      const float lf = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        store2(o + base + (size_t)row * HD + nd * 8 + 2 * t, acc[nd][2 * r] / lf,
               acc[nd][2 * r + 1] / lf);
      if (t == 0) lse[(size_t)bh * S + row] = (m[r] + log2f(lf)) * LN2;
    }
  }
}

// --------------------------------------------------------- dk/dv, bf16 (K3) --
// grid (nk, B*H), 128 threads; warp w owns keys k0 + 16w .. k0 + 16w + 15,
// lane (g, t) keys g and g + 8 of them.  Computed transposed: s^T = K q^T has
// the block's keys as rows, so p^T and ds^T are A operands in registers.
// Shared memory: K, V (64 x D each), two stages of q and dO (64 x D each),
// then two stages of the q tile's lse and delta rows (64 f32 each).
template <int D, typename OutT>
__global__ void __launch_bounds__(NTC)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                OutT* __restrict__ dk, OutT* __restrict__ dv, int S, int H, float scale,
                int causal) {
  constexpr int KS = D / 16, ND = D / 8, TE = TILE_ELEMS<D>;
  constexpr bool KV_REGS = D <= 64;    // K and V fragments held in registers
  constexpr int QW = D <= 64 ? 64 : 32;  // q columns a warp takes at a time
  constexpr int NB = QW / 8;
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + TE;
  bf16* qs = vs + TE;       // 2 stages
  bf16* gs = qs + 2 * TE;   // 2 stages
  float* lse_s = reinterpret_cast<float*>(gs + 2 * TE);  // 2 stages x 64
  float* delta_s = lse_s + 2 * BQ;                          // 2 stages x 64

  const int kb = blockIdx.x;  // low k tiles see the most q tiles: launched first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int k0 = kb * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + gq;  // this lane's keys: key0 and key0 + 8

  // q tiles wholly above this k tile see none of it: start at the diagonal
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + BQ - 1) / BQ;

  // one stage: the q and dO tiles at q0, and their lse and delta rows
  auto load_stage = [&](int st, int q0) {
    tile_async<D>(qs + st * TE, q, base, q0, S, HD);
    tile_async<D>(gs + st * TE, g, base, q0, S, HD);
    const int i = threadIdx.x & (BQ - 1), row = q0 + i;
    const bool ok = row < S;
    const float* src = (threadIdx.x < BQ ? lse : delta) + (size_t)bh * S + (ok ? row : 0);
    cp_async4(smem_addr((threadIdx.x < BQ ? lse_s : delta_s) + st * BQ + i), src, ok);
  };

  tile_async<D>(ks, k, base, k0, S, HD);
  tile_async<D>(vs, v, base, k0, S, HD);
  load_stage(0, qstart);
  cp_async_commit();

  const float scale2 = scale * LOG2E;
  uint32_t kf[KS][4], vf[KS][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qstart + j * BQ;
    if (j + 1 < ntiles) load_stage((j + 1) & 1, q0 + BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (KV_REGS && j == 0) {
      a_frags<D>(kf, ks, warp * 16);
      a_frags<D>(vf, vs, warp * 16);
    }
    const bf16* qt = qs + (j & 1) * TE;
    const bf16* gt = gs + (j & 1) * TE;
    const float* ls = lse_s + (j & 1) * BQ;
    const float* dl = delta_s + (j & 1) * BQ;
    const bool masked = (causal && q0 < k0 + BK - 1) || q0 + BQ > S;

#pragma unroll
    for (int qo = 0; qo < BQ; qo += QW) {
      if (!KV_REGS) a_frags<D>(kf, ks, warp * 16);

      // s^T = K q^T: 16 keys x QW q columns per warp
      float p[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t bq[4];
          bt_frags<D>(bq, qt, qo + nb2 * 16, kk);
          mma(p[2 * nb2], kf[kk], bq[0], bq[1]);
          mma(p[2 * nb2 + 1], kf[kk], bq[2], bq[3]);
        }

      // p^T = exp(scale s^T - lse[q]), normalised by the saved logsumexp;
      // masked entries (diagonal and ragged tiles only) are exactly 0
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qo + nb * 8 + 2 * t + (e & 1);
          float x = exp2_approx(p[nb][e] * scale2 - ls[c] * LOG2E);
          if (masked) {
            const int col = q0 + c, key = key0 + (e >> 1) * 8;
            if (col >= S || (causal && col < key)) x = 0.f;
          }
          p[nb][e] = x;
        }

      // dV += bf16(p^T) dO
#pragma unroll
      for (int kq = 0; kq < NB / 2; ++kq) {
        uint32_t pa[4];
        a_from_c(pa, p[2 * kq], p[2 * kq + 1]);
#pragma unroll
        for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
          uint32_t bg[4];
          b_frags<D>(bg, gt, qo + kq * 16, nd2);
          mma(dva[2 * nd2], pa, bg[0], bg[1]);
          mma(dva[2 * nd2 + 1], pa, bg[2], bg[3]);
        }
      }

      // dp^T = V dO^T
      if (!KV_REGS) a_frags<D>(vf, vs, warp * 16);
      float dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t bg[4];
          bt_frags<D>(bg, gt, qo + nb2 * 16, kk);
          mma(dp[2 * nb2], vf[kk], bg[0], bg[1]);
          mma(dp[2 * nb2 + 1], vf[kk], bg[2], bg[3]);
        }

      // ds^T = p^T (dp^T - delta[q]) scale, from the unrounded p
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qo + nb * 8 + 2 * t + (e & 1);
          dp[nb][e] = p[nb][e] * (dp[nb][e] - dl[c]) * scale;
        }

      // dK += bf16(ds^T) q
#pragma unroll
      for (int kq = 0; kq < NB / 2; ++kq) {
        uint32_t da[4];
        a_from_c(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
          uint32_t bq[4];
          b_frags<D>(bq, qt, qo + kq * 16, nd2);
          mma(dka[2 * nd2], da, bq[0], bq[1]);
          mma(dka[2 * nd2 + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + r * 8;
    if (row < S) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const size_t off = base + (size_t)row * HD + nd * 8 + 2 * t;
        store2(dk + off, dka[nd][2 * r], dka[nd][2 * r + 1]);
        store2(dv + off, dva[nd][2 * r], dva[nd][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ dq, bf16 (K2) --
// grid (nq, B*H), 128 threads; warp w owns q rows q0 + 16w .. q0 + 16w + 15,
// lane (g, t) rows g and g + 8 of them, as in the forward.  Per k tile:
// s = q K^T and dp = dO V^T, then p and ds in the score registers, then
// dq += bf16(ds) K with ds packed straight into the A operand.  Shared
// memory: q and dO (64 x D each, read once), then two stages of K and V.
// At D > 64 the q and dO fragments are re-read from shared memory and each
// K tile is walked in halves of 32 keys, to keep the dq accumulator in
// registers.
template <int D, typename OutT>
__global__ void __launch_bounds__(NTC)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              OutT* __restrict__ dq, int S, int H, float scale, int causal) {
  constexpr int KS = D / 16, ND = D / 8, TE = TILE_ELEMS<D>;
  constexpr bool QG_REGS = D <= 64;      // q and dO fragments held in registers
  constexpr int KW = D <= 64 ? 64 : 32;  // keys a warp takes at a time
  constexpr int NB = KW / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* gs = qs + TE;
  bf16* ks = gs + TE;      // 2 stages
  bf16* vs = ks + 2 * TE;  // 2 stages

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + gq;  // this lane's rows: row0 and row0 + 8

  // k tiles wholly above the diagonal contribute nothing: stop before them
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;

  tile_async<D>(qs, q, base, q0, S, HD);
  tile_async<D>(gs, g, base, q0, S, HD);
  cp_async_commit();
  tile_async<D>(ks, k, base, 0, S, HD);
  tile_async<D>(vs, v, base, 0, S, HD);
  cp_async_commit();

  // this lane's rows' logsumexp (in log2 units) and delta; rows >= S are never
  // written, and their zero q and dO rows give ds = 0
  const float scale2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse2[r] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
    dl[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }

  uint32_t qf[KS][4], gf[KS][4];
  float dqa[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {  // the next tile is in flight while this one is computed
      const int st = (j + 1) & 1;
      tile_async<D>(ks + st * TE, k, base, k0 + BK, S, HD);
      tile_async<D>(vs + st * TE, v, base, k0 + BK, S, HD);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the group just committed has landed
    __syncthreads();
    if (QG_REGS && j == 0) {
      a_frags<D>(qf, qs, warp * 16);
      a_frags<D>(gf, gs, warp * 16);
    }
    const bf16* kt = ks + (j & 1) * TE;
    const bf16* vt = vs + (j & 1) * TE;
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > S;

#pragma unroll
    for (int ko = 0; ko < BK; ko += KW) {
      if (!QG_REGS) a_frags<D>(qf, qs, warp * 16);

      // s = q K^T: 16 rows x KW keys per warp
      float p[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t bk[4];
          bt_frags<D>(bk, kt, ko + nb2 * 16, kk);
          mma(p[2 * nb2], qf[kk], bk[0], bk[1]);
          mma(p[2 * nb2 + 1], qf[kk], bk[2], bk[3]);
        }

      // p = exp(scale s - lse[q]), normalised by the saved logsumexp; masked
      // entries (diagonal and ragged tiles only) are exactly 0
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2_approx(p[nb][e] * scale2 - lse2[e >> 1]);
          if (masked) {
            const int row = row0 + (e >> 1) * 8, col = k0 + ko + nb * 8 + 2 * t + (e & 1);
            if (col >= S || (causal && col > row)) x = 0.f;
          }
          p[nb][e] = x;
        }

      // dp = dO V^T
      if (!QG_REGS) a_frags<D>(gf, gs, warp * 16);
      float dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t bv[4];
          bt_frags<D>(bv, vt, ko + nb2 * 16, kk);
          mma(dp[2 * nb2], gf[kk], bv[0], bv[1]);
          mma(dp[2 * nb2 + 1], gf[kk], bv[2], bv[3]);
        }

      // ds = p (dp - delta[q]) scale, from the unrounded p
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nb][e] = p[nb][e] * (dp[nb][e] - dl[e >> 1]) * scale;

      // dq += bf16(ds) K
#pragma unroll
      for (int kq = 0; kq < NB / 2; ++kq) {
        uint32_t da[4];
        a_from_c(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
          uint32_t bk[4];
          b_frags<D>(bk, kt, ko + kq * 16, nd2);
          mma(dqa[2 * nd2], da, bk[0], bk[1]);
          mma(dqa[2 * nd2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < S) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        store2(dq + base + (size_t)row * HD + nd * 8 + 2 * t, dqa[nd][2 * r],
               dqa[nd][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launchers --

template <int D>
int fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D * LD + BK * D + BK * LD) * sizeof(float);
  auto kernel = fwd_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq,
              int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * D * LD + BK * LD) * sizeof(float);
  auto kernel = bwd_dq_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), lse, delta, static_cast<float*>(dq), S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dkdv_launch(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * D * LD + 2 * BQ * LD + 2 * BQ) * sizeof(float);
  auto kernel = bwd_dkdv_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BK - 1) / BK, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int fwd_mma_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)5 * TILE_ELEMS<D> * sizeof(bf16);  // q, 2 x (K, V)
  auto kernel = fwd_mma_kernel<D, OutT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<OutT*>(o), lse, S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int dq_mma_launch(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, void* dq,
                  int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)6 * TILE_ELEMS<D> * sizeof(bf16);  // q, dO, 2 x (K, V)
  auto kernel = dq_mma_kernel<D, OutT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<OutT*>(dq), S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
int dkdv_mma_launch(const void* q, const void* k, const void* v, const void* g,
                    const float* lse, const float* delta, void* dk, void* dv,
                    int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  // K, V, 2 x (q, dO), then 2 x (lse, delta) rows
  const size_t smem = (size_t)6 * TILE_ELEMS<D> * sizeof(bf16) + 4 * BQ * sizeof(float);
  auto kernel = dkdv_mma_kernel<D, OutT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BK - 1) / BK, B * H);
  kernel<<<grid, NTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<OutT*>(dk), static_cast<OutT*>(dv),
      S, H, scale, causal);
  return (int)cudaGetLastError();
}

// Head dims instantiated: 32 (transformer-tiny/-small/-long), 64 (-xlong),
// 96 (-large), 128.  Anything else returns kUnsupported; an output form other
// than 0 (like the inputs) or 1 (f32) returns kUnsupportedOut.
constexpr int kUnsupported = -1;
constexpr int kUnsupportedOut = -2;

#define GST_DISPATCH_D(D_, CALL)           \
  switch (D_) {                            \
    case 32: { constexpr int Dc = 32; return CALL; }   \
    case 64: { constexpr int Dc = 64; return CALL; }   \
    case 96: { constexpr int Dc = 96; return CALL; }   \
    case 128: { constexpr int Dc = 128; return CALL; } \
    default: return kUnsupported;          \
  }

int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse,
          int B, int S, int H, int D, float scale, int causal, cudaStream_t st) {
  GST_DISPATCH_D(D, (fwd_launch<Dc>(q, k, v, o, lse, B, S, H, scale, causal, st)))
}
int fwd_mma_d(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int S, int H, int D, float scale, int causal, int out_f32,
              cudaStream_t st) {
  GST_DISPATCH_D(D, (out_f32 ? fwd_mma_launch<Dc, float>(q, k, v, o, lse, B, S, H, scale,
                                                         causal, st)
                             : fwd_mma_launch<Dc, bf16>(q, k, v, o, lse, B, S, H, scale,
                                                        causal, st)))
}

int dq_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
         const float* delta, void* dq, int B, int S, int H, int D, float scale, int causal,
         cudaStream_t st) {
  GST_DISPATCH_D(D, (dq_launch<Dc>(q, k, v, g, lse, delta, dq, B, S, H, scale, causal, st)))
}
int dq_mma_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
             const float* delta, void* dq, int B, int S, int H, int D, float scale, int causal,
             int out_f32, cudaStream_t st) {
  GST_DISPATCH_D(D, (out_f32 ? dq_mma_launch<Dc, float>(q, k, v, g, lse, delta, dq, B, S, H,
                                                        scale, causal, st)
                             : dq_mma_launch<Dc, bf16>(q, k, v, g, lse, delta, dq, B, S, H,
                                                       scale, causal, st)))
}

int dkdv_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* delta, void* dk, void* dv, int B, int S, int H, int D, float scale,
           int causal, cudaStream_t st) {
  GST_DISPATCH_D(D, (dkdv_launch<Dc>(q, k, v, g, lse, delta, dk, dv, B, S, H, scale,
                                        causal, st)))
}
int dkdv_mma_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
               const float* delta, void* dk, void* dv, int B, int S, int H, int D,
               float scale, int causal, int out_f32, cudaStream_t st) {
  GST_DISPATCH_D(D, (out_f32 ? dkdv_mma_launch<Dc, float>(q, k, v, g, lse, delta, dk, dv, B, S,
                                                          H, scale, causal, st)
                             : dkdv_mma_launch<Dc, bf16>(q, k, v, g, lse, delta, dk, dv, B, S,
                                                         H, scale, causal, st)))
}

}  // namespace

// ------------------------------------------------------- plain C interface --
// Each returns 0 on success, a cudaError_t code from the launch, -1 for an
// unsupported head dim or -2 for an unsupported output form.  is_bf16: 1 for
// bfloat16 inputs, 0 for float32; the inputs' dtype picks the kernel (bf16:
// tensor cores, f32: FMA).  out_f32: 0 for outputs in the inputs' dtype, 1
// for f32 outputs (the ring's chunk form; from bf16 inputs the tensor-core
// kernels' f32 epilogue, from f32 inputs the FMA kernels as they are).

extern "C" {

int gst_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, int S, int H, int D, float scale, int causal, int is_bf16,
                  int out_f32, void* stream) {
  if (out_f32 != 0 && out_f32 != 1) return kUnsupportedOut;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd_mma_d(q, k, v, o, lse, B, S, H, D, scale, causal, out_f32, st)
                 : fwd_d(q, k, v, o, lse, B, S, H, D, scale, causal, st);
}

int gst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                     const float* lse, const float* delta, void* dq,
                     int B, int S, int H, int D, float scale, int causal, int is_bf16,
                     int out_f32, void* stream) {
  if (out_f32 != 0 && out_f32 != 1) return kUnsupportedOut;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dq_mma_d(q, k, v, g, lse, delta, dq, B, S, H, D, scale, causal, out_f32, st)
                 : dq_d(q, k, v, g, lse, delta, dq, B, S, H, D, scale, causal, st);
}

int gst_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int B, int S, int H, int D, float scale, int causal, int is_bf16,
                       int out_f32, void* stream) {
  if (out_f32 != 0 && out_f32 != 1) return kUnsupportedOut;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dkdv_mma_d(q, k, v, g, lse, delta, dk, dv, B, S, H, D, scale, causal,
                              out_f32, st)
                 : dkdv_d(q, k, v, g, lse, delta, dk, dv, B, S, H, D, scale, causal, st);
}

const char* gst_error_string(int code) {
  if (code == kUnsupported) return "unsupported head dim (instantiated: 32, 64, 96, 128)";
  if (code == kUnsupportedOut) return "unsupported output form (0: the inputs' dtype, 1: f32)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
