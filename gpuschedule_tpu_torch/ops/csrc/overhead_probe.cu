// Overhead-probe kernels for Hopper (sm_90a): a tile copy and rows 0-7 of a tile's x^T.x.
//
// Replaces the two Pallas TPU kernels of tools/overhead_probe.py:
//   probe_copy_kernel <- _copy_kernel    (:54-55)
//   probe_xtx_kernel  <- _matmul_kernel  (:58-61)
// x and out are (n * 8, BLOCK) bf16, row-major and contiguous: n tiles of (8, BLOCK), the
// Pallas BlockSpec((8, block), lambda i: (i, 0)).  For each tile t:
//   copy: out[t] = x[t];
//   xtx:  out[t][i][j] = bf16(sum_{r < 8} x[t][r][i] * x[t][r][j]) for i < 8, j < BLOCK.
//         A bf16 x bf16 product is exact in f32; the sum is f32, in order r = 0..7, and is
//         rounded to bf16 once.  The Mosaic body forms the whole BLOCK x BLOCK product and
//         keeps rows 0-7; only those rows are computed here.
//
// Grid mapping.  `parallel` picks one of two launch forms:
//   parallel = 0: ONE thread block walks the n tiles in order.  This is the counterpart of the
//                 TPU's default sequential ("arbitrary") grid: Hopper has no sequential grid,
//                 and a loop inside the block takes the place of the sequential dimension;
//   parallel = 1: n thread blocks, one tile each: dimension_semantics=("parallel",).
// So the two sweeps over n price different things on this card: the sequential slope is the
// cost of one loop iteration inside a block (a dependent global-memory round trip per tile),
// the parallel slope the cost of scheduling one more block.  A TPU number for either flag
// measures something else (the per-grid-step pipeline overhead of Mosaic).
//
// Bound.  Both kernels are bound by bytes: at n = 4096, BLOCK = 128 they read 8.39 MB and
// write 8.39 MB, 5.0 us at 3.35 TB/s.  K5b's function needs 2*8*8*128 FLOP per tile, 67 MFLOP
// at n = 4096: 0.07 us at the 989 TFLOP/s bf16 rate, negligible.  With so little work a call
// costs about as much to launch as to run, and that overhead is what the probe measures.
//
// Design.  128 threads per block.  A tile is 8 x 128 bf16 = 2 KB = 128 vectors of 16 bytes,
// so the copy moves one vector per thread per tile, neighbouring threads on neighbouring
// addresses.  xtx loads the tile the same way into shared memory as f32; thread j then forms
// column j of the 8 output rows (64 FMAs), reading x[r][i] as a broadcast and x[r][j] with no
// bank conflict, and the 8 rows are stored coalesced.  No wgmma or TMA: a tile this small
// cannot feed them, and the probe prices overhead, not arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;   // rows of one tile (the TPU's sublane count)
constexpr int NT = 128;   // threads per block

// Tiles [t0, t1) of a block: tiles_per_block is 1 (parallel) or n (sequential).
__device__ __forceinline__ void block_tiles(int n_tiles, int tiles_per_block, int& t0, int& t1) {
  t0 = blockIdx.x * tiles_per_block;
  t1 = min(t0 + tiles_per_block, n_tiles);
}

template <int BLOCK>
__global__ void __launch_bounds__(NT)
probe_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int n_tiles,
                  int tiles_per_block) {
  constexpr int VEC = ROWS * BLOCK * 2 / 16;  // 16-byte vectors per tile
  int t0, t1;
  block_tiles(n_tiles, tiles_per_block, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const size_t base = (size_t)t * VEC;
    for (int v = threadIdx.x; v < VEC; v += NT) out[base + v] = x[base + v];
  }
}

template <int BLOCK>
__global__ void __launch_bounds__(NT)
probe_xtx_kernel(const uint4* __restrict__ x, __nv_bfloat16* __restrict__ out, int n_tiles,
                 int tiles_per_block) {
  constexpr int VEC = ROWS * BLOCK / 8;  // 16-byte vectors (8 bf16) per tile
  __shared__ float xs[ROWS * BLOCK];
  int t0, t1;
  block_tiles(n_tiles, tiles_per_block, t0, t1);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile's reads of xs are done
    for (int v = threadIdx.x; v < VEC; v += NT) {
      const uint4 w = x[(size_t)t * VEC + v];
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[v * 8 + e] = __bfloat162float(h[e]);
    }
    __syncthreads();
    __nv_bfloat16* o = out + (size_t)t * ROWS * BLOCK;
    for (int j = threadIdx.x; j < BLOCK; j += NT) {
      float acc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float xj = xs[r * BLOCK + j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(xs[r * BLOCK + i], xj, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) o[i * BLOCK + j] = __float2bfloat16(acc[i]);
    }
  }
}

template <int BLOCK>
int copy_launch(const void* x, void* out, int n, int parallel, cudaStream_t st) {
  probe_copy_kernel<BLOCK><<<parallel ? n : 1, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n, parallel ? 1 : n);
  return (int)cudaGetLastError();
}

template <int BLOCK>
int xtx_launch(const void* x, void* out, int n, int parallel, cudaStream_t st) {
  probe_xtx_kernel<BLOCK><<<parallel ? n : 1, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<__nv_bfloat16*>(out), n, parallel ? 1 : n);
  return (int)cudaGetLastError();
}

// Block widths instantiated: 128 (the probe's).  Anything else returns kUnsupported.
constexpr int kUnsupported = -1;

}  // namespace

// ------------------------------------------------------- plain C interface --
// x and out: (n * 8, block) bf16, contiguous, 16-byte aligned.  Each returns 0 on success, a
// cudaError_t code from the launch, or -1 for an unsupported block.

extern "C" {

int gst_probe_copy(const void* x, void* out, int n, int block, int parallel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return copy_launch<128>(x, out, n, parallel, st);
    default: return kUnsupported;
  }
}

int gst_probe_xtx(const void* x, void* out, int n, int block, int parallel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return xtx_launch<128>(x, out, n, parallel, st);
    default: return kUnsupported;
  }
}

const char* gst_error_string(int code) {
  if (code == kUnsupported) return "unsupported block (instantiated: 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
