// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of gpuschedule_tpu/ops/flash_attention.py:
//   fwd_kernel      <- _fwd_kernel       (:98-152)
//   bwd_dq_kernel   <- _bwd_dq_kernel    (:155-199)
//   bwd_dkdv_kernel <- _bwd_dkdv_kernel  (:202-252)
// They compute what the Pallas kernels compute (the plain PyTorch versions in
// ../flash_attention.py spell it out), not how: Pallas walks a sequential grid
// and carries state across k steps in VMEM scratch; here one thread block owns
// one (batch*head, 64-row tile) and loops over the other tiles itself, so the
// causal skip is a loop bound and the state lives in registers.
//
// Layout.  q, k, v, dO, O, dq, dk, dv are read and written in the caller's
// (B, S, H, D) layout (row (b, s, h) starts at ((b*S + s)*H + h)*D), so no
// transpose or padding copy is made.  lse and delta are plain (B*H, S) f32
// rows.  The ragged tail (rows or columns >= S) is masked inside the kernels,
// the `cols < seq_len` rule of the Pallas `_mask`: padding is never visible.
//
// Numerics, as in the Pallas kernels.  Products take their operands in the
// input dtype (bf16 or f32) and accumulate in f32: a bf16 operand widened to
// f32 multiplies exactly, so an f32 FMA chain is the same arithmetic.
// sm_scale multiplies the f32 product; p is rounded to V's dtype before p.V and
// p^T.dO, ds to K's and q's dtype before ds.K and ds^T.q.  The running max,
// denominator and accumulators are f32 in registers.
//
// Bound and design.  At transformer-long's shape (B*H = 16, S = 4096, D = 32,
// causal, bf16) the work is matmul FLOPs: forward 17.2 GFLOP, dq 25.8,
// dk/dv 34.4, against ~17 MB of q/k/v/o traffic, so the tensor-core rate
// (989 TFLOP/s bf16) sets the bound, not the 3.35 TB/s memory.  This first
// version does its products as f32 FMA loops on CUDA cores from shared-memory
// tiles (no mma.sync / wgmma, no TMA): simple and right first; it runs at the
// FMA rate, far from the tensor-core bound.  What the design does about the
// bound: each K/V (or Q/dO) tile is loaded once per block into shared memory
// and reused by all 64 rows of the block's tile; each thread keeps a 4 x 4
// patch of the score tile and 4 rows of the output in registers, so every
// shared-memory load feeds 4 FMAs or more; causal blocks skip every tile above
// the diagonal by loop bound, and the heaviest blocks are launched first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // k rows per tile
constexpr int NT = 256;     // threads per block: 16 x 16, each owns a 4 x 4 score patch
constexpr int LD = 68;      // row stride of transposed tiles: float4-aligned, spreads banks
constexpr float NEG_INF = -1e30f;

static_assert(BQ == 64 && BK == 64, "the thread mapping assumes 64 x 64 tiles");

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// x rounded to T and widened back: the operand cast before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Rows [r0, r0 + 64) of one head's (S, D) matrix into dst[d * LD + r] (f32,
// transposed); rows >= S load as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src, size_t base,
                                            int r0, int S, int HD) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[d * LD + r] = s < S ? to_f<T>(src[base + (size_t)s * HD + d]) : 0.f;
  }
}

// The same rows into dst[r * D + d] (f32, row-major).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t base,
                                          int r0, int S, int HD) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * D + d] = s < S ? to_f<T>(src[base + (size_t)s * HD + d]) : 0.f;
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
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int S, int H, float scale, int causal) {
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

  load_tile_t<T, D>(qT, q, base, q0, S, HD);

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
    load_tile_t<T, D>(kT, k, base, k0, S, HD);
    load_tile<T, D>(vs, v, base, k0, S, HD);
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
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                      round_to<T>(s[2][j]), round_to<T>(s[3][j]));
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
        o[base + (size_t)row * HD + tc + 16 * dc] = from_f<T>(acc[i][dc] / lf);
      if (tc == 0) lse[(size_t)bh * S + row] = m[i] + logf(lf);
    }
  }
}

// -------------------------------------------------------------------- dq --
// grid (nq, B*H); the thread mapping of the forward.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq,
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

  load_tile_t<T, D>(qT, q, base, q0, S, HD);
  load_tile_t<T, D>(gT, g, base, q0, S, HD);
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
    load_tile_t<T, D>(kT, k, base, k0, S, HD);
    load_tile_t<T, D>(vT, v, base, k0, S, HD);
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
        ds[i] = round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
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
        dq[base + (size_t)row * HD + tc + 16 * dc] = from_f<T>(acc[i][dc]);
    }
  }
}

// ------------------------------------------------------------------ dk/dv --
// grid (nk, B*H); thread (a, bq) owns key rows a*4 + i and query columns
// bq + 16*j of the transposed score tile, and gradient columns bq + 16*dc.
// dk and dv accumulate in f32 registers over the q tiles and are written once.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int S, int H, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // D x LD
  float* vT = kT + D * LD;                       // D x LD
  float* qT = vT + D * LD;                       // D x LD
  float* gT = qT + D * LD;                       // D x LD
  float* ps = gT + D * LD;                       // BQ x LD: p (rounded) by q row
  float* dss = ps + BQ * LD;                     // BQ x LD: ds (rounded) by q row
  float* lse_s = dss + BQ * LD;                  // BQ
  float* delta_s = lse_s + BQ;                   // BQ

  const int kb = blockIdx.x;  // low k tiles see the most q tiles: launched first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int HD = H * D;
  const size_t base = (size_t)b * S * HD + (size_t)h * D;
  const int a = threadIdx.x / 16, bq = threadIdx.x % 16;
  const int k0 = kb * BK;

  load_tile_t<T, D>(kT, k, base, k0, S, HD);
  load_tile_t<T, D>(vT, v, base, k0, S, HD);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) dk_acc[i][dc] = dv_acc[i][dc] = 0.f;

  // q tiles wholly above this k tile see none of it: start at the diagonal
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile_t<T, D>(qT, q, base, q0, S, HD);
    load_tile_t<T, D>(gT, g, base, q0, S, HD);
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
        pr[i] = round_to<T>(p);
        dr[i] = round_to<T>(p * (dp[i][j] - delta_s[rl]) * scale);
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
        dk[off] = from_f<T>(dk_acc[i][dc]);
        dv[off] = from_f<T>(dv_acc[i][dc]);
      }
    }
  }
}

// ------------------------------------------------------------- launchers --

template <typename T, int D>
int fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * D * LD + BK * D + BK * LD) * sizeof(float);
  auto kernel = fwd_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq_launch(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq,
              int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * D * LD + BK * LD) * sizeof(float);
  auto kernel = bwd_dq_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dq), S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv_launch(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int S, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * D * LD + 2 * BQ * LD + 2 * BQ) * sizeof(float);
  auto kernel = bwd_dkdv_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BK - 1) / BK, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, scale, causal);
  return (int)cudaGetLastError();
}

// Head dims instantiated: 32 (transformer-tiny/-small/-long), 64 (-xlong),
// 96 (-large), 128.  Anything else returns kUnsupported.
constexpr int kUnsupported = -1;

#define GST_DISPATCH_D(D_, CALL)           \
  switch (D_) {                            \
    case 32: { constexpr int Dc = 32; return CALL; }   \
    case 64: { constexpr int Dc = 64; return CALL; }   \
    case 96: { constexpr int Dc = 96; return CALL; }   \
    case 128: { constexpr int Dc = 128; return CALL; } \
    default: return kUnsupported;          \
  }

template <typename T>
int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse,
          int B, int S, int H, int D, float scale, int causal, cudaStream_t st) {
  GST_DISPATCH_D(D, (fwd_launch<T, Dc>(q, k, v, o, lse, B, S, H, scale, causal, st)))
}

template <typename T>
int dq_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
         const float* delta, void* dq, int B, int S, int H, int D, float scale, int causal,
         cudaStream_t st) {
  GST_DISPATCH_D(D, (dq_launch<T, Dc>(q, k, v, g, lse, delta, dq, B, S, H, scale, causal, st)))
}

template <typename T>
int dkdv_d(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* delta, void* dk, void* dv, int B, int S, int H, int D, float scale,
           int causal, cudaStream_t st) {
  GST_DISPATCH_D(D, (dkdv_launch<T, Dc>(q, k, v, g, lse, delta, dk, dv, B, S, H, scale,
                                        causal, st)))
}

}  // namespace

// ------------------------------------------------------- plain C interface --
// Each returns 0 on success, a cudaError_t code from the launch, or -1 for an
// unsupported head dim.  is_bf16: 1 for bfloat16 tensors, 0 for float32.

extern "C" {

int gst_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, int S, int H, int D, float scale, int causal, int is_bf16,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, D, scale, causal, st)
                 : fwd_d<float>(q, k, v, o, lse, B, S, H, D, scale, causal, st);
}

int gst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                     const float* lse, const float* delta, void* dq,
                     int B, int S, int H, int D, float scale, int causal, int is_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dq_d<__nv_bfloat16>(q, k, v, g, lse, delta, dq, B, S, H, D, scale, causal, st)
             : dq_d<float>(q, k, v, g, lse, delta, dq, B, S, H, D, scale, causal, st);
}

int gst_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int B, int S, int H, int D, float scale, int causal, int is_bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dkdv_d<__nv_bfloat16>(q, k, v, g, lse, delta, dk, dv, B, S, H, D, scale,
                                         causal, st)
                 : dkdv_d<float>(q, k, v, g, lse, delta, dk, dv, B, S, H, D, scale, causal,
                                 st);
}

const char* gst_error_string(int code) {
  if (code == kUnsupported) return "unsupported head dim (instantiated: 32, 64, 96, 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
