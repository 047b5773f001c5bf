"""Struct-of-arrays job accounting ledger — the v2 vectorized core.

The port's own copy of ``gpuschedule_tpu/sim/ledger.py``: the same numpy
operations in the same order, so a v2 replay's sums equal the JAX
package's to the bit (``tests/test_torch_snapshot.py``).

Under ``--accounting v1`` (the default) the engine advances every running
job at every event batch, and the resulting chunk-per-batch float sums are
part of the byte-identity contract (docs/performance.md).  ``v2`` replaces
that contract with **exact-sum closure** (the goodput and attribution
decompositions still close against :class:`SimResult` to the last float,
under the v2 summation order) — which unlocks two things:

- **lazy integration**: :meth:`~gpuschedule_tpu_torch.sim.job.Job.advance` is
  segment-exact for any ``dt``, so a policy that never reads running-job
  progress between events (``Policy.reads_progress = False``, e.g. FIFO)
  needs *no per-batch work at all* — each job integrates once per
  mutation instead of once per batch;
- **vectorized sync** for policies that *do* read progress every pass
  (DLAS attained service, SRTF remaining work, ...): this ledger mirrors
  the per-job hot state ``Job.advance`` integrates — ``executed_work``,
  ``attained_service``, ``overhead_remaining``, ``overhead_service``, the
  attribution run legs, ``last_update_time``, and the
  speed x locality x slow effective rate — into slot-indexed numpy
  columns anchored at each job's last mutation, so the per-batch sweep
  becomes a handful of masked array ops plus one scatter loop instead of
  a full Python ``advance`` per job.

Anchor discipline (what keeps the two views consistent):

- a slot's columns are (re)copied **from the job's own fields** at every
  engine mutation (bind / refresh / release ride ``try_start`` /
  ``set_speed`` / ``resize`` / ``migrate`` / net & straggler re-pricing /
  warning overhead / ``preempt`` / ``_finish`` / ``_revoke``), at which
  point the job is integrated to ``sim.now`` — the anchor time IS
  ``job.last_update_time``;
- :meth:`sync_all` evaluates each column **absolutely** from its anchor
  (never incrementally) and scatters into the job fields, so repeated
  syncs between mutations are idempotent and the arrays are a pure
  derived cache — the Job fields remain the single source of truth.

Slots are dense (swap-remove on release) so the vector ops run on a
contiguous prefix; capacity growth doubles and is the only "re-pack"
(``ledger_rebuild`` miss in the cache-telemetry family — slot
reuse within capacity is a hit).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from gpuschedule_tpu_torch.sim.job import Job

# column names, in bind/refresh copy order (one numpy float64 array each)
_COLUMNS = (
    "t0",       # anchor time == job.last_update_time at the last mutation
    "work",     # executed_work at anchor
    "service",  # attained_service at anchor
    "ovsvc",    # overhead_service at anchor
    "ov",       # overhead_remaining at anchor
    "eff",      # speed * locality_factor * slow_factor (the advance product)
    "chips",    # allocated_chips (float64: int*float == float*float exactly)
    "speed",    # components kept for the attribution leg split
    "loc",
    "slow",
    "cw",       # ckpt_write_s (0 = unpriced writes)
    "ce",       # ckpt_every (inf = unpriced; the division then yields 0)
)
# attribution run-leg anchor columns (armed only when attribution is on)
_LEG_COLUMNS = ("lw", "lp", "ln", "ls", "lo")
_LEG_KEYS = ("work", "policy-share", "net-degraded", "straggler", "overhead")

_INITIAL_CAPACITY = 64

# Below this many slotted jobs the masked-array sync costs more than it
# saves (a dozen array slices + tolist scatter vs a handful of plain
# ``advance`` calls), so :meth:`JobLedger.sync_all` falls back to the
# scalar loop.  Both paths bring the fields to the same reals (advance
# is segment-exact; the columns stay anchored at the last mutation
# either way), so the cutover moves only float summation order — inside
# the v2 closure contract, and deterministic per replay since the
# running count is.  Measured on the 1k-job / 64-chip DLAS overhead
# world: vector-always was ~2.4x the v1 advance sweep; with the cutover
# the same world runs at parity.
SCALAR_CUTOVER = 32


class JobLedger:
    """Slot-indexed numpy mirror of the running set's accounting state.

    ``vector=False`` (a ``reads_progress=False`` policy) keeps the ledger
    as a pure marker — no arrays, no per-mutation work — because the lazy
    path needs nothing synced between mutations.  ``vector=True``
    maintains the columns and serves :meth:`sync_all` as the engine's
    per-batch advance replacement.
    """

    def __init__(self, *, attribution: bool = False, vector: bool = True,
                 capacity: int = _INITIAL_CAPACITY):
        self.attribution = bool(attribution)
        self.vector = bool(vector)
        self.rebuild_hits = 0    # binds/releases served within capacity
        self.rebuild_misses = 0  # capacity growth (the only re-pack)
        self._n = 0
        self._slots: Dict[int, int] = {}      # id(job) -> slot
        self._jobs: List[Job] = []            # dense, slot-indexed
        self._cap = 0
        if self.vector:
            self._alloc(max(1, int(capacity)))

    # ------------------------------------------------------------------ #
    # slot lifecycle (engine mutation sites)

    def _alloc(self, cap: int) -> None:
        for name in _COLUMNS:
            old = getattr(self, "_" + name, None)
            arr = np.zeros(cap, dtype=np.float64)
            if old is not None:
                arr[: self._n] = old[: self._n]
            setattr(self, "_" + name, arr)
        if self.attribution:
            for name in _LEG_COLUMNS:
                old = getattr(self, "_" + name, None)
                arr = np.zeros(cap, dtype=np.float64)
                if old is not None:
                    arr[: self._n] = old[: self._n]
                setattr(self, "_" + name, arr)
        self._cap = cap

    def _fill(self, slot: int, job: Job) -> None:
        self._t0[slot] = job.last_update_time
        self._work[slot] = job.executed_work
        self._service[slot] = job.attained_service
        self._ovsvc[slot] = job.overhead_service
        self._ov[slot] = job.overhead_remaining
        self._eff[slot] = job.speed * job.locality_factor * job.slow_factor
        self._chips[slot] = job.allocated_chips
        self._speed[slot] = job.speed
        self._loc[slot] = job.locality_factor
        self._slow[slot] = job.slow_factor
        if job.ckpt_write_s > 0.0 and 0.0 < job.ckpt_every < math.inf:
            self._cw[slot] = job.ckpt_write_s
            self._ce[slot] = job.ckpt_every
        else:
            self._cw[slot] = 0.0
            self._ce[slot] = math.inf
        if self.attribution:
            a = job.attrib or {}
            for name, key in zip(_LEG_COLUMNS, _LEG_KEYS):
                getattr(self, "_" + name)[slot] = a.get(key, 0.0)

    def bind(self, job: Job) -> None:
        """Assign a slot to a newly-running job (fields already final and
        integrated to ``sim.now``)."""
        if not self.vector:
            return
        n = self._n
        if n == self._cap:
            self.rebuild_misses += 1
            self._alloc(self._cap * 2)
        else:
            self.rebuild_hits += 1
        self._slots[id(job)] = n
        if n == len(self._jobs):
            self._jobs.append(job)
        else:
            self._jobs[n] = job
        self._n = n + 1
        self._fill(n, job)

    def refresh(self, job: Job) -> None:
        """Re-anchor a running job after a mutation changed any of its
        rates/overhead/legs (the job is integrated to ``sim.now``)."""
        if not self.vector:
            return
        slot = self._slots.get(id(job))
        if slot is not None:
            self._fill(slot, job)

    def release(self, job: Job) -> None:
        """Drop a job leaving the running set (swap-remove keeps the
        columns dense; the moved job keeps its anchor values)."""
        if not self.vector:
            return
        slot = self._slots.pop(id(job), None)
        if slot is None:
            return
        self.rebuild_hits += 1
        last = self._n - 1
        if slot != last:
            moved = self._jobs[last]
            self._jobs[slot] = moved
            self._slots[id(moved)] = slot
            for name in _COLUMNS:
                arr = getattr(self, "_" + name)
                arr[slot] = arr[last]
            if self.attribution:
                for name in _LEG_COLUMNS:
                    arr = getattr(self, "_" + name)
                    arr[slot] = arr[last]
        self._n = last

    # ------------------------------------------------------------------ #
    # the per-batch vectorized advance (reads_progress policies)

    def sync_all(self, t: float) -> None:
        """Bring every slotted job's fields to ``t`` — the masked-array
        replacement for the v1 per-batch ``advance`` sweep.  Absolute
        evaluation from each slot's anchor; anchors are NOT moved (only a
        mutation re-anchors), so calling this once per batch re-derives,
        never re-accumulates."""
        n = self._n
        if n == 0:
            return
        jobs = self._jobs
        if n < SCALAR_CUTOVER:
            # small running set: the plain per-job advance is cheaper
            # than the numpy setup (see SCALAR_CUTOVER); anchors stay
            # put, so later vector syncs still evaluate absolutely
            for i in range(n):
                jobs[i].advance(t)
            return
        ov0 = self._ov[:n]
        eff = self._eff[:n]
        chips = self._chips[:n]
        dt = t - self._t0[:n]
        overheady = bool(ov0.any())
        priced = bool(self._cw[:n].any())
        if not overheady and not priced:
            run = dt
            burned = write = None
        else:
            burned = np.minimum(ov0, dt)
            rem = dt - burned
            if priced:
                pw = eff * self._cw[:n]
                write = rem * (pw / (self._ce[:n] + pw))
                run = rem - write
            else:
                write = None
                run = rem
        w = (self._work[:n] + eff * run).tolist()
        s = (self._service[:n] + chips * run).tolist()
        if not overheady and not priced and not self.attribution:
            for i in range(n):
                job = jobs[i]
                job.executed_work = w[i]
                job.attained_service = s[i]
                job.last_update_time = t
            return
        burned_l = burned.tolist() if burned is not None else None
        write_l = write.tolist() if write is not None else None
        if overheady or priced:
            wr = write if write is not None else 0.0
            bu = burned if burned is not None else 0.0
            ov_l = (ov0 - bu).tolist() if burned is not None else None
            ovsvc_l = ((self._ovsvc[:n] + chips * bu) + chips * wr).tolist()
        else:
            ov_l = ovsvc_l = None
        if self.attribution:
            speed = self._speed[:n]
            d_work = eff * run
            d_pol = (1.0 - speed) * run
            d_net = speed * (1.0 - self._loc[:n]) * run
            d_slow = speed * self._loc[:n] * (1.0 - self._slow[:n]) * run
            legs_d = [d_work.tolist(), d_pol.tolist(), d_net.tolist(),
                      d_slow.tolist()]
            legs_v = [(self._lw[:n] + d_work).tolist(),
                      (self._lp[:n] + d_pol).tolist(),
                      (self._ln[:n] + d_net).tolist(),
                      (self._ls[:n] + d_slow).tolist()]
            lo = self._lo[:n]
        for i in range(n):
            job = jobs[i]
            job.executed_work = w[i]
            job.attained_service = s[i]
            job.last_update_time = t
            d_over = 0.0
            if burned_l is not None:
                d_over += burned_l[i]
            if write_l is not None:
                d_over += write_l[i]
            if d_over:
                if ov_l is not None:
                    job.overhead_remaining = ov_l[i]
                job.overhead_service = ovsvc_l[i]
            if self.attribution:
                a = job.attrib
                for k, (dl, vl) in enumerate(zip(legs_d, legs_v)):
                    if dl[i]:
                        a[_LEG_KEYS[k]] = vl[i]
                if d_over:
                    a["overhead"] = float(lo[i]) + d_over

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """``ledger_rebuild`` counters for the unified cache-telemetry
        family: slot churn served in place vs array growth."""
        return {
            "ledger_rebuild": {
                "hit": self.rebuild_hits,
                "miss": self.rebuild_misses,
            },
        }
