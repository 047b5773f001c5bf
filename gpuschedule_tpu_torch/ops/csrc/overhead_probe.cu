// Overhead-probe kernels for Hopper (sm_90a): a tile copy and rows 0-7 of a tile's x^T.x.
//
// Replaces the two Pallas TPU kernels of tools/overhead_probe.py:
//   probe_copy_kernel <- _copy_kernel    (:54-55)
//   probe_xtx_kernel  <- _matmul_kernel  (:58-61)
// x and out are (n * 8, BLOCK) bf16, row-major and contiguous: n tiles of (8, BLOCK), the
// Pallas BlockSpec((8, block), lambda i: (i, 0)).  A tile is 8 x 128 bf16 = 2,048 contiguous
// bytes.  For each tile t:
//   copy: out[t] = x[t];
//   xtx:  out[t][i][j] = bf16(sum_{r < 8} x[t][r][i] * x[t][r][j]) for i < 8, j < BLOCK.
//         A bf16 x bf16 product is exact in f32; the sum is f32 and is rounded to bf16 once.
//         The Mosaic body forms the whole BLOCK x BLOCK product and keeps rows 0-7; only those
//         rows are computed here.
//
// Grid mapping.  `parallel` picks one of two launch forms of the same kernel body:
//   parallel = 0: ONE thread block walks the n tiles in order, the counterpart of the TPU's
//                 default sequential ("arbitrary") grid: Hopper has no sequential grid, and a
//                 loop inside the block takes the place of the sequential dimension;
//   parallel = 1: n thread blocks, one tile each: dimension_semantics=("parallel",).
// Mosaic pipelines a sequential grid: each BlockSpec operand is double-buffered in VMEM, so
// step i+1's copy in is in flight while step i runs, and step i's copy out drains behind it.
// The loop here is pipelined the same way, so the sequential slope prices the pipelined cost
// of one more tile in one block (the copy engine's rate for 2 KB tiles and the per-tile
// barrier work), which is what the TPU tool's slope means; the parallel slope prices the
// scheduling of one more block.
//
// Bound.  Both kernels are bound by bytes: at n = 4096, BLOCK = 128 they read 8.39 MB and
// write 8.39 MB, 5.0 us at 3.35 TB/s.  K5b's function needs 2*8*8*128 FLOP per tile, 67 MFLOP
// at n = 4096: 0.07 us at the 989 TFLOP/s bf16 rate, negligible.  One block is held to what
// one SM can move, far below the card's rate; that per-tile cost is what the probe measures.
//
// Design: a ring of tiles fed by the Tensor Memory Accelerator (bulk_copy.cuh).
//   * The block keeps a ring of `stages` input tiles in dynamic shared memory, each with a
//     full and an empty mbarrier; stages = min(STAGES, tiles per block), so a block of the
//     parallel form holds one tile (2-4 KB) and keeps its occupancy.  Thread 0 is the
//     producer: it issues one 1-D bulk copy per tile (no tensor map: a tile is contiguous),
//     each into a stage once the stage's empty barrier says it is free, so up to `stages`
//     tiles are in flight ahead of the consumers.  Its parity flips at each use of a stage.
//   * Consumers wait on a stage's full barrier, process the tile, store the result with a bulk
//     store from shared memory, and hand a stage back only once nothing reads it any more.
//     Every bulk store has read shared memory before its block exits (wait_read<0>).
//   * K5a's compute step is empty: device memory -> shared -> device memory by the copy
//     engine, the analogue of Mosaic's VMEM copies in and out.  No thread spends registers on
//     data: the block is two warps, thread 0 loading and thread 32 storing each tile straight
//     from its stage; a stage is handed back once its store has read it (wait_read), which
//     the storer checks STORES_IN_FLIGHT tiles later so as not to wait on each store.
//   * K5b forms out = X[:, :8]^T . X with mma.sync.m16n8k16 (bf16 in, f32 accumulators;
//     mma_bf16.cuh), the counterpart of the MXU jnp.dot.  Warps 1..W (W = XTX_WARPS) take
//     tiles in turn, a whole tile each, so W tiles are processed at once with no block
//     barrier.  A warp reads its tile's B fragments straight from the ring stage with 4
//     ldmatrix.x4.trans (16 n-tiles of 8 columns); the A operand, X[:, :8]^T in rows 0-7 and k
//     0-7, is the B fragment of columns 0-7, and rows 8-15 and k 8-15 are zero registers, not
//     memory, as is the k 8-15 half of B.  The tile's rows are 256 bytes apart, so each
//     ldmatrix phase is an 8-way bank conflict (a 1-D copy has no padding or swizzle).  The
//     warp fences its reads for the async proxy and hands the stage back, rounds each result
//     once to bf16, swaps words within each quad of lanes so that every lane writes 16
//     contiguous bytes of its row, and bulk-stores the tile from one of its XTX_OUT_STAGES
//     output tiles.  STAGES is a multiple of W, so each stage has one consumer warp, which
//     sees its uses in order and cannot mistake one use's parity for another's.
// Not used: wgmma (64-row tiles; a probe tile has 8 rows) and clusters.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 8;              // rows of one tile (the TPU's sublane count)
constexpr int STAGES = 16;           // input tiles in flight in one block (PERF.md: sweep)
constexpr int STORES_IN_FLIGHT = 2;  // K5a: bulk stores left unread when a stage is released
constexpr int XTX_WARPS = 8;         // K5b: consumer warps, each on a tile of its own
constexpr int XTX_OUT_STAGES = 2;    // K5b: output tiles of each consumer warp
static_assert(STAGES > STORES_IN_FLIGHT, "K5a releases a stage STORES_IN_FLIGHT tiles late");
static_assert(STAGES % XTX_WARPS == 0, "each stage of K5b's ring has one consumer warp");

template <int BLOCK>
constexpr uint32_t TILE_BYTES = ROWS * BLOCK * 2;

// Ring sizes of a block that walks tiles_per_block tiles (1 in the parallel form, n in the
// sequential one): the launchers size the block and its shared memory from them, the kernels
// lay shared memory out by them.
__host__ __device__ constexpr int ring_stages(int tiles_per_block) {
  return tiles_per_block < STAGES ? tiles_per_block : STAGES;
}
__host__ __device__ constexpr int xtx_warps(int tiles_per_block) {
  return tiles_per_block < XTX_WARPS ? tiles_per_block : XTX_WARPS;
}
__host__ __device__ constexpr int xtx_out_stages(int tiles_per_block) {
  return tiles_per_block <= XTX_WARPS ? 1 : XTX_OUT_STAGES;
}
// Shared memory: the full and the empty mbarrier of each stage (8 bytes each), then, from a
// 128-byte boundary, the ring's tiles (and K5b's output tiles).
__host__ __device__ constexpr uint32_t ring_offset(int stages) {
  return (uint32_t)(2 * stages * 8 + 127) / 128 * 128;
}
template <int BLOCK>
constexpr size_t copy_smem(int tiles_per_block) {
  const int st = ring_stages(tiles_per_block);
  return ring_offset(st) + (size_t)st * TILE_BYTES<BLOCK>;
}
template <int BLOCK>
constexpr size_t xtx_smem(int tiles_per_block) {
  const int st = ring_stages(tiles_per_block);
  const int out = xtx_warps(tiles_per_block) * xtx_out_stages(tiles_per_block);
  return ring_offset(st) + (size_t)(st + out) * TILE_BYTES<BLOCK>;
}

// Tiles [t0, t1) of a block: tiles_per_block is 1 (parallel) or n (sequential).
__device__ __forceinline__ void block_tiles(int n_tiles, int tiles_per_block, int& t0, int& t1) {
  t0 = blockIdx.x * tiles_per_block;
  t1 = min(t0 + tiles_per_block, n_tiles);
}

// The ring: `stages` tiles of `bytes` at shared address `ring`; stage s's full barrier at
// full + 8s completes when a tile has landed in it, its empty barrier at full + 8 * stages +
// 8s when the tile in it is no longer needed.  Tile i goes to stage i % stages; the use
// i / stages of a stage waits with that use's parity.
struct Ring {
  uint32_t full, ring, bytes;
  int stages;
  __device__ uint32_t full_bar(int s) const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full + 8 * (stages + s); }
  __device__ uint32_t tile(int s) const { return ring + s * bytes; }
};

// Thread 0: every barrier of the ring starts waiting for one arrival.  The block then syncs.
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < 2 * r.stages; ++s) bulk_copy::mbar_init(r.full + 8 * s, 1);
  bulk_copy::fence_mbar_init();
}

// The producer: asks for the tiles src[0, count) in order, each once its stage is empty.
__device__ __forceinline__ void ring_produce(const Ring& r, const unsigned char* src,
                                             int count) {
  int s = 0;
  uint32_t parity = 0;  // of the stage's previous use
  for (int i = 0; i < count; ++i) {
    if (i >= r.stages) bulk_copy::wait_parity(r.empty_bar(s), parity);
    bulk_copy::arrive_expect_tx(r.full_bar(s), r.bytes);
    bulk_copy::load(r.tile(s), src + (size_t)i * r.bytes, r.bytes, r.full_bar(s));
    if (++s == r.stages) {
      s = 0;
      if (i >= r.stages) parity ^= 1;
    }
  }
}

// K5a.  Thread 0 loads, thread 32 (another warp) stores each tile straight from its stage and
// releases the stage once its store has read it, STORES_IN_FLIGHT tiles later.
template <int BLOCK>
__global__ void __launch_bounds__(64)
probe_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                  int n_tiles, int tiles_per_block) {
  extern __shared__ float4 smem4[];
  int t0, t1;
  block_tiles(n_tiles, tiles_per_block, t0, t1);
  const int count = t1 - t0, stages = ring_stages(tiles_per_block);
  const uint32_t bar0 = mma_bf16::smem_addr(smem4);
  const Ring r{bar0, bar0 + ring_offset(stages), TILE_BYTES<BLOCK>, stages};
  if (threadIdx.x == 0) ring_init(r);
  __syncthreads();
  if (threadIdx.x == 0) {
    ring_produce(r, x + (size_t)t0 * r.bytes, count);
  } else if (threadIdx.x == 32) {
    unsigned char* dst = out + (size_t)t0 * r.bytes;
    int s = 0, released = 0;
    uint32_t parity = 0;
    for (int i = 0; i < count; ++i) {
      bulk_copy::wait_parity(r.full_bar(s), parity);
      bulk_copy::store(dst + (size_t)i * r.bytes, r.tile(s), r.bytes);
      bulk_copy::commit();
      if (i >= STORES_IN_FLIGHT) {  // tile i - STORES_IN_FLIGHT's store has read its stage
        bulk_copy::wait_read<STORES_IN_FLIGHT>();
        bulk_copy::arrive(r.empty_bar(released));
        if (++released == stages) released = 0;
      }
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
    bulk_copy::wait_read<0>();
  }
}

// One round of a transpose within a quad of lanes: lanes `mask` apart trade one word, the
// upper lane giving `lo` for its partner's `hi`.
__device__ __forceinline__ void quad_trade(uint32_t& lo, uint32_t& hi, bool upper, int mask) {
  const uint32_t got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, mask);
  if (upper) lo = got;
  else hi = got;
}

// 4 x 4 transpose over the quad of lanes t = 0..3 that shares a row: lane t's v[j] becomes
// lane j's v[t].
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  quad_trade(v[0], v[1], t & 1, 1);
  quad_trade(v[2], v[3], t & 1, 1);
  quad_trade(v[0], v[2], t & 2, 2);
  quad_trade(v[1], v[3], t & 2, 2);
}

// K5b.  Warp 0's thread 0 loads; warp 1 + w (w < xtx_warps) takes tiles w, w + W, ...: it
// reads its tile's fragments, releases the stage, forms the 8 x BLOCK rows with mma.sync into
// an output tile of its own and stores them.  STAGES is a multiple of W, so each stage has one
// consumer warp, which sees its uses in order.
template <int BLOCK>
__global__ void __launch_bounds__(32 * (1 + XTX_WARPS))
probe_xtx_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                 int n_tiles, int tiles_per_block) {
  constexpr int NTILES = BLOCK / 8;  // n-tiles of 8 columns
  static_assert(BLOCK % 32 == 0, "BLOCK is read in ldmatrix.x4 groups of 32 columns");
  extern __shared__ float4 smem4[];
  int t0, t1;
  block_tiles(n_tiles, tiles_per_block, t0, t1);
  const int count = t1 - t0, stages = ring_stages(tiles_per_block);
  const int warps = xtx_warps(tiles_per_block), ostages = xtx_out_stages(tiles_per_block);
  const uint32_t bar0 = mma_bf16::smem_addr(smem4);
  const Ring r{bar0, bar0 + ring_offset(stages), TILE_BYTES<BLOCK>, stages};
  if (threadIdx.x == 0) ring_init(r);
  __syncthreads();
  const int warp = threadIdx.x / 32 - 1, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if (warp < 0) {
    if (lane == 0) ring_produce(r, x + (size_t)t0 * r.bytes, count);
    return;
  }
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const uint32_t oring = r.tile(stages) + warp * ostages * r.bytes;  // this warp's output tiles
  unsigned char* dst = out + (size_t)t0 * r.bytes;
  // tile i's stage s = i % stages and its use's parity, and this warp's output tile os, kept
  // by counting (no integer division in the loop); warps <= stages, so s wraps at most once
  // a step
  int s = warp, os = 0;
  uint32_t parity = 0;
  for (int i = warp; i < count; i += warps) {
    bulk_copy::wait_parity(r.full_bar(s), parity);
    // b[n] = the B fragment of columns 8n..8n+7: lane (g, t) holds X[2t..2t+1][8n + g].  With
    // .trans, ldmatrix matrix m of group q is rows 0-7 of columns 32q + 8m, its row addresses
    // given by lanes 8m..8m+7.
    uint32_t b[NTILES];
#pragma unroll
    for (int q = 0; q < NTILES / 4; ++q) {
      uint32_t v[4];
      mma_bf16::ldmatrix_x4_trans(v, r.tile(s) + (lane % 8) * BLOCK * 2 + (32 * q + 8 * (lane / 8)) * 2);
#pragma unroll
      for (int m = 0; m < 4; ++m) b[4 * q + m] = v[m];
    }
    // the stage is read: the reads are ordered before the bulk load that will refill it (the
    // card otherwise lets that load overwrite the stage under them), then handed back
    bulk_copy::fence_proxy_async();
    __syncwarp();
    if (lane == 0) bulk_copy::arrive(r.empty_bar(s));
    // A = X[:, :8]^T: A[g][2t..2t+1] = X[2t..2t+1][g] is b[0]; rows 8-15 and k 8-15 are zero,
    // as is the k 8-15 half of B
    const uint32_t a[4] = {b[0], 0u, 0u, 0u};
    // p[n] = row g, columns 8n + 2t and 2t+1, rounded once to bf16; c[2], c[3] are rows 8-15
    // of the product, all 0
    uint32_t p[NTILES];
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16::mma(c, a, b[n], 0u);
      p[n] = mma_bf16::pack(c[0], c[1]);
    }
    const uint32_t otile = oring + os * r.bytes;
    // the store that last read this output tile (XTX_OUT_STAGES tiles ago) has read it
    if (lane == 0) bulk_copy::wait_read<XTX_OUT_STAGES - 1>();
    __syncwarp();
    unsigned char* orow = base + (otile - bar0) + g * BLOCK * 2;  // row g of the output tile
#pragma unroll
    for (int m = 0; m < NTILES / 4; ++m) {
      // The quad of lanes that shares row g transposes its words of n-tiles 4m..4m+3, so that
      // lane t holds the 16 bytes of n-tile 4m + t: one 16-byte store a lane where 4-byte
      // ones would hit one bank from all 8 rows.
      uint32_t v[4] = {p[4 * m], p[4 * m + 1], p[4 * m + 2], p[4 * m + 3]};
      quad_transpose(v, t);
      reinterpret_cast<uint4*>(orow + (4 * m + t) * 16)[0] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    bulk_copy::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      bulk_copy::store(dst + (size_t)i * r.bytes, otile, r.bytes);
      bulk_copy::commit();
    }
    if ((s += warps) >= stages) {
      s -= stages;
      parity ^= 1;
    }
    if (++os == ostages) os = 0;
  }
  if (lane == 0) bulk_copy::wait_read<0>();
}

// ------------------------------------------------------------- launchers --

// A kernel may take more than 48 KB of dynamic shared memory only once allowed to, on each
// device it runs on: only the sequential form's ring needs it, and it is set at each launch
// of that form, as the flash launchers do.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int BLOCK>
int copy_launch(const void* x, void* out, int n, int parallel, cudaStream_t st) {
  auto kernel = probe_copy_kernel<BLOCK>;
  const int per_block = parallel ? 1 : n;
  const size_t smem = copy_smem<BLOCK>(per_block);
  if (const int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<parallel ? n : 1, 64, smem, st>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), n, per_block);
  return (int)cudaGetLastError();
}

template <int BLOCK>
int xtx_launch(const void* x, void* out, int n, int parallel, cudaStream_t st) {
  auto kernel = probe_xtx_kernel<BLOCK>;
  const int per_block = parallel ? 1 : n;
  const size_t smem = xtx_smem<BLOCK>(per_block);
  if (const int rc = allow_smem(kernel, smem)) return rc;
  kernel<<<parallel ? n : 1, 32 * (1 + xtx_warps(per_block)), smem, st>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), n, per_block);
  return (int)cudaGetLastError();
}

// Block widths instantiated: 128 (the probe's).  Anything else returns kUnsupported.
constexpr int kUnsupported = -1;

}  // namespace

// ------------------------------------------------------- plain C interface --
// x and out: (n * 8, block) bf16, contiguous, 16-byte aligned.  The kernels' entry points
// return 0 on success, a cudaError_t code from the launch, or -1 for an unsupported block.

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

// Dynamic shared memory of one block, in bytes, as the launcher of K5a (xtx = 0) or K5b
// (xtx = 1) sizes it for n tiles in the given form: for reports.
int gst_probe_smem(int xtx, int n, int parallel) {
  const int per_block = parallel ? 1 : n;
  return (int)(xtx ? xtx_smem<128>(per_block) : copy_smem<128>(per_block));
}

// The ring depth STAGES the kernels were built with: for reports and tests.
int gst_probe_stages() { return STAGES; }

const char* gst_error_string(int code) {
  if (code == kUnsupported) return "unsupported block (instantiated: 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
