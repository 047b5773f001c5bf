// Hopper bulk-copy helpers (sm_90): the 1-D form of the Tensor Memory Accelerator, which
// copies a contiguous run of bytes between device memory and shared memory with no tensor map,
// and the mbarriers its loads complete on.
//
//   global -> shared: load() asks for `bytes` to land at a shared address; the copy adds its
//     bytes to the transaction count of an mbarrier as they land.  A phase of the barrier
//     completes when its expected arrivals have arrived AND the transaction count is back to
//     0, so the thread that issues a load first arms the barrier with arrive_expect_tx(bytes).
//   shared -> global: store() reads shared memory asynchronously; stores are grouped per
//     thread by commit(), and wait_read<N>() waits until at most N of the thread's groups have
//     yet to finish READING shared memory, after which their source may be overwritten.  The
//     block must wait_read<0>() before it exits.
//   fence_proxy_async() orders this thread's ordinary (generic-proxy) writes of shared memory
//     before a later bulk copy (async proxy) that reads it; a barrier between writers and the
//     issuing thread then completes the hand-over.
// Addresses in shared memory are 32-bit shared-window addresses (mma_bf16::smem_addr); every
// address and size is a multiple of 16 bytes.  tests/cuda_emu/bulk_copy.cuh emulates these
// helpers on the host.

#pragma once

#include <stdint.h>

namespace bulk_copy {

// An mbarrier (8 bytes of shared memory) that completes a phase after `count` arrivals.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy before a bulk copy names them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more of transactions in the current phase.
__device__ __forceinline__ void arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One arrival, with no transactions.
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// True once the phase of parity `parity` has completed (the barrier's current phase has the
// other parity).  A barrier starts in phase 0, so its first use waits with parity 0.
__device__ __forceinline__ bool try_wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  while (!try_wait_parity(bar, parity)) {
  }
}

// `bytes` from global `src` to shared `dst`, completing on barrier `bar`.
__device__ __forceinline__ void load(uint32_t dst, const void* src, uint32_t bytes,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared `src` to global `dst`, in this thread's open bulk group.
__device__ __forceinline__ void store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk_copy
