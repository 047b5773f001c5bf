// Host emulation of gpuschedule_tpu_torch/ops/csrc/bulk_copy.cuh: the same names, with the
// PTX semantics of mbarriers with transaction counts and of the 1-D bulk copies written out,
// each copy held back as late as the hardware may hold it, so that a kernel that trusts it too
// early reads or writes stale data:
//   * a bulk load fills its destination with 0xff bytes (a bf16 NaN) when it is issued, as
//     a copy in flight may have written any part of it, so a thread still reading a stage
//     that was handed back too early reads NaN;
//   * it lands, 16 bytes at a time, each adding its bytes to its barrier's transaction
//     count, only when a thread waits on that barrier for a phase that has not completed, so
//     a thread that reads before its wait reads NaN too; the phase completes when its
//     arrivals are in and the count is back to 0, and landing stops there (so an expect_tx
//     that is short leaves bytes unlanded, one that is long never completes);
//   * a wait for a phase that has already completed returns at once and lands nothing;
//   * a bulk store reads shared memory, and writes device memory, only when wait_read
//     retires its group; a store still in flight when its block exits is a fault (-3);
//   * a warp that read a stage with ldmatrix and hands it back with arrive() before each lane
//     has passed fence.proxy.async is a fault (-3): on the card the bulk load that refills
//     the stage can overwrite it before those reads are done;
//   * a wait that can never complete leaves every thread waiting: the scheduler's deadlock
//     (-2).
#pragma once

#include <map>

#include "mma_bf16.cuh"

namespace bulk_copy {

struct EmuLoad {
  uint32_t dst;
  const char* src;
  uint32_t bytes, landed;
};

struct EmuMbar {
  uint32_t count, pending;  // arrivals per phase, arrivals still due in this phase
  long long tx;             // transaction bytes expected and not yet landed
  unsigned phase;           // phases completed
  std::deque<EmuLoad> loads;
};

inline std::map<uint32_t, EmuMbar> emu_mbars;  // by shared address

inline void emu_fail(const char* what) {
  if (!emu_fault) emu_fault = what;
}

inline EmuMbar* emu_mbar(uint32_t bar) {
  auto it = emu_mbars.find(bar);
  if (it == emu_mbars.end()) {
    emu_fail("an mbarrier used before mbar_init");
    return nullptr;
  }
  return &it->second;
}

inline void emu_complete_if_done(EmuMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
    ++emu_arrivals;
  }
}

inline void mbar_init(uint32_t bar, uint32_t count) {
  if (bar % 8) emu_fail("an mbarrier off an 8-byte boundary");
  emu_mbars[bar] = EmuMbar{count, count, 0, 0, {}};
}

inline void fence_mbar_init() {}

inline void arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  EmuMbar* m = emu_mbar(bar);
  if (!m) return;
  if (m->pending == 0) {
    emu_fail("an arrival on an mbarrier with no arrival due");
    return;
  }
  m->tx += bytes;
  --m->pending;
  emu_complete_if_done(*m);
}

// A stage handed back (to a producer whose bulk loads will overwrite it) by a warp that
// read it with ldmatrix must have ordered those reads first with fence.proxy.async, each
// lane its own: the card reorders the generic-proxy reads after the async-proxy writes.
inline void arrive(uint32_t bar) {
  for (bool unfenced : emu_warp->unfenced)
    if (unfenced) return emu_fail("a stage handed back before fence.proxy.async");
  arrive_expect_tx(bar, 0);
}

// Land the barrier's loads until its current phase completes.
inline void emu_land(EmuMbar& m) {
  const unsigned phase = m.phase;
  while (!m.loads.empty() && m.phase == phase) {
    EmuLoad& l = m.loads.front();
    std::memcpy(mma_bf16::emu_smem() + l.dst + l.landed, l.src + l.landed, 16);
    l.landed += 16;
    m.tx -= 16;
    if (l.landed == l.bytes) m.loads.pop_front();
    emu_complete_if_done(m);
  }
}

inline bool try_wait_parity(uint32_t bar, uint32_t parity) {
  EmuMbar* m = emu_mbar(bar);
  if (m) {
    if ((m->phase & 1u) != parity) return true;
    emu_land(*m);
    if ((m->phase & 1u) != parity) return true;
  }
  swapcontext(&emu_thread->ctx, &emu_main);  // let the other threads run
  return false;
}

inline void wait_parity(uint32_t bar, uint32_t parity) {
  while (!try_wait_parity(bar, parity)) {
  }
}

inline bool emu_aligned(const void* p, uint32_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && bytes % 16 == 0 && bytes > 0;
}

inline void load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  if (dst % 16 || !emu_aligned(src, bytes)) return emu_fail("a bulk load off 16 bytes");
  EmuMbar* m = emu_mbar(bar);
  if (!m) return;
  std::memset(mma_bf16::emu_smem() + dst, 0xff, bytes);
  m->loads.push_back({dst, static_cast<const char*>(src), bytes, 0});
}

inline void store(void* dst, uint32_t src, uint32_t bytes) {
  if (src % 16 || !emu_aligned(dst, bytes)) return emu_fail("a bulk store off 16 bytes");
  emu_thread->bulk_open.push_back({dst, src, int(bytes)});
}

inline void commit() {
  EmuThread& th = *emu_thread;
  th.bulk_groups.push_back(th.bulk_open);
  th.bulk_open.clear();
}

template <int N>
inline void wait_read() {
  auto& groups = emu_thread->bulk_groups;
  while ((int)groups.size() > N) {
    for (const EmuBulkStore& s : groups.front())
      std::memcpy(s.dst, mma_bf16::emu_smem() + s.src, s.bytes);
    groups.pop_front();
  }
}

inline void fence_proxy_async() { emu_warp->unfenced[emu_lane] = false; }

}  // namespace bulk_copy
