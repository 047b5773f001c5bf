"""Wall-clock phase profiler for the replay loop itself.

The port's own copy of ``gpuschedule_tpu/obs/selfprof.py`` (the same
phases, document and ``exporter`` tag).

The engine is fast through its caches and indexes; this module makes a
regression in any of them *diagnosable*.  Where the span tracer
(obs/tracer.py) answers "what did this one batch do", the profiler
answers the fleet-scale question: **which phase of the replay loop is the
wall time going to** — event application, the policy pass, the max-min
net re-solve, fault dispatch, metrics emission, or end-of-run analytics —
so a jobs/sec drop on a noisy box reads as "net re-solve grew 3x", not a
bare suspect number.

Design:

- the engine runs a dedicated ``_run_profiled`` loop body when a
  :class:`PhaseProfiler` is attached (``run --self-profile out.json``) —
  the disabled path never sees a clock read;
- each batch's wall time is bucketed into the :data:`PHASES` with two
  ``perf_counter`` reads per segment; whatever the segments do not cover
  (heap peeks, the quiescence test, loop overhead) lands in ``other``, so
  **the phases sum to the measured total exactly** — the tier-1 smoke
  asserts it;
- alongside the totals the profiler coalesces batches into fixed-size
  chunks and records one span per phase per chunk **through the
  tracer's span machinery** (a private, always-enabled
  :class:`~gpuschedule_tpu_torch.obs.tracer.Tracer`), giving a
  ui.perfetto.dev-loadable *wall-clock* phase track next to the existing
  sim-time tracks — phase weight over wall time, at bounded span count
  whatever the trace length.

The profile document written by :meth:`PhaseProfiler.write` is both
artifacts in one file: a Chrome trace (``traceEvents``) that Perfetto
loads directly, plus the machine-readable ``selfprof`` summary block
(phase totals/shares, batches, run identity) for trend tooling and the
report's Engine-health panel.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

from gpuschedule_tpu_torch.obs.tracer import Tracer

# Phase keys, in the order the report's stacked bar lists them.  "other"
# is the residual (total minus every timed segment) — always present, so
# sum(phases) == total_wall_s identically.
PHASES = (
    "event_apply",      # _drain_batch minus nested fault dispatch
    "policy_schedule",  # Policy.schedule invocations
    "net_resolve",      # _net_update (poll + max-min recompute + emits)
    "fault_dispatch",   # _apply_fault / _apply_warning / repair handling
    "advance",          # progress charging + hazard wear integration
    "ledger_sync",      # v2 accounting only: the JobLedger's
                        # vectorized per-batch sync replacing the advance
                        # sweep for progress-reading policies; identically
                        # zero under v1 and under v2's fully-lazy path
    "metrics_emit",     # utilization sampling, cutoff/attribution emits
    "analytics",        # end-of-run SimResult assembly
    "other",            # loop overhead: heap peeks, quiescence, dispatch
)

# Batches per coalesced Perfetto chunk: one span per phase per chunk keeps
# the wall-time track at O(batches / chunk) spans — a million-batch replay
# exports ~4k spans per phase, loadable without pain.
_CHUNK_BATCHES = 256


class _PhaseCtx:
    """Reusable ``with profiler.phase(name):`` timer — one per phase, so
    the profiled loop allocates nothing per batch."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "PhaseProfiler", name: str):
        self._prof = prof
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_PhaseCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._prof.add(self._name, time.perf_counter() - self._t0)
        return False


class PhaseProfiler:
    """Accumulates per-phase wall time for one ``Simulator.run`` and
    exports the JSON-profile + Perfetto-wall-track document.

    One profiler instance serves one run: attach a fresh one per
    ``Simulator`` (the engine never resets it)."""

    def __init__(self, *, chunk_batches: int = _CHUNK_BATCHES):
        self.totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.batches = 0
        self.total_wall_s = 0.0
        self.meta: Dict[str, object] = {}
        self._t_run0: Optional[float] = None
        self._t_run1: Optional[float] = None
        self._chunk_batches = max(1, int(chunk_batches))
        self._chunk_t0: Optional[float] = None
        self._chunk_sums: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._chunk_n = 0
        # the tracer's span machinery, reused verbatim on the wall clock: a
        # private always-on tracer collects one coalesced span per phase
        # per chunk; chrome_events() renders them with the same exporter
        # the `run --spans` timeline uses
        self._tracer = Tracer(enabled=True)
        self._ctx: Dict[str, _PhaseCtx] = {p: _PhaseCtx(self, p) for p in PHASES}

    # ------------------------------------------------------------------ #
    # engine-facing recording

    def start(self, **meta) -> None:
        """Stamp run identity and open the total-wall interval."""
        self.meta.update(meta)
        self._t_run0 = time.perf_counter()
        self._chunk_t0 = self._t_run0

    def phase(self, name: str) -> _PhaseCtx:
        """The reusable ``with``-timer for one phase."""
        return self._ctx[name]

    def add(self, name: str, dt: float) -> None:
        """Charge ``dt`` wall seconds to ``name`` (negative clamps to 0:
        the event-apply segment subtracts nested fault time, and two
        adjacent clock reads may land on the same counter tick)."""
        if dt < 0.0:
            dt = 0.0
        self.totals[name] += dt
        self._chunk_sums[name] += dt

    def total(self, name: str) -> float:
        return self.totals[name]

    def batch_done(self) -> None:
        """Close one engine batch; every ``chunk_batches`` batches the
        accumulated per-phase time flushes as one span per phase."""
        self.batches += 1
        self._chunk_n += 1
        if self._chunk_n >= self._chunk_batches:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if self._chunk_n == 0 or self._chunk_t0 is None:
            return
        t0 = self._chunk_t0
        for name in PHASES:
            dt = self._chunk_sums[name]
            if dt > 0.0:
                self._tracer.record(
                    name, wall_start=t0, wall_dur=dt, cat="selfprof",
                    batches=self._chunk_n,
                )
            self._chunk_sums[name] = 0.0
        self._chunk_t0 = time.perf_counter()
        self._chunk_n = 0

    def finish(self) -> None:
        """Close the run: flush the final partial chunk, stamp the total,
        and charge the residual (un-segmented loop overhead) to
        ``other`` so the phase totals sum to the total exactly."""
        self._t_run1 = time.perf_counter()
        if self._t_run0 is None:
            self._t_run0 = self._t_run1
        self.total_wall_s = self._t_run1 - self._t_run0
        timed = sum(self.totals[p] for p in PHASES if p != "other")
        self.totals["other"] += max(0.0, self.total_wall_s - timed
                                    - self.totals["other"])
        # float dust can leave timed > total on a near-empty run; pin the
        # invariant the smoke test asserts by re-deriving the total as the
        # sum — the residual formulation makes the two agree to the ulp
        self.total_wall_s = sum(self.totals.values())
        self._flush_chunk()

    # ------------------------------------------------------------------ #
    # export

    def profile(self) -> dict:
        """The machine-readable summary block."""
        total = self.total_wall_s
        return {
            "total_wall_s": total,
            "batches": self.batches,
            "batches_per_s": (self.batches / total) if total > 0 else None,
            "phases": {
                name: {
                    "total_s": self.totals[name],
                    "share": (self.totals[name] / total) if total > 0 else 0.0,
                }
                for name in PHASES
            },
            **self.meta,
        }

    def chrome_events(self) -> list:
        """The coalesced wall-clock phase spans as Chrome trace events
        (the private tracer's exporter — one tid per thread, ts in µs)."""
        return self._tracer.chrome_events()

    def to_document(self) -> dict:
        """One JSON document that is simultaneously a loadable Chrome
        trace (``traceEvents`` on the wall clock) and the profile summary
        (``selfprof``)."""
        return {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {"clock": "wall", "exporter": "gpuschedule_tpu.obs.selfprof"},
            "selfprof": self.profile(),
        }

    def write(self, path) -> Path:
        out = Path(path)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(self.to_document(), f, indent=2, sort_keys=True)
        return out


def load_profile(path) -> dict:
    """Read back the ``selfprof`` summary block from a profile document
    (the report's ``--selfprof`` input)."""
    with open(path) as f:
        doc = json.load(f)
    prof = doc.get("selfprof")
    if not isinstance(prof, dict) or "phases" not in prof:
        raise ValueError(
            f"{path} is not a self-profile document (no 'selfprof' block "
            "with phase totals — was it written by run --self-profile?)"
        )
    return prof


def merge_profiles(per_worker) -> dict:
    """Deterministic federation of self-profile blocks keyed by worker
   : ``per_worker`` maps a worker key (e.g. ``"worker-0"``) to
    the sequence of :meth:`PhaseProfiler.profile` blocks its tasks
    produced, in task order.  Per worker, phase totals / wall totals /
    batch counts are exact sums over its blocks; the ``fleet`` block sums
    across workers (iterated in sorted key order, so the merge is a pure
    function of the inputs — arrival order never matters).  Workers with
    no profile blocks are dropped."""

    def _merged(blocks) -> dict:
        names = list(PHASES)
        for b in blocks:
            for name in b.get("phases", {}):
                if name not in names:
                    names.append(name)
        totals = {
            name: sum(
                b.get("phases", {}).get(name, {}).get("total_s", 0.0)
                for b in blocks
            )
            for name in names
        }
        total = sum(b.get("total_wall_s", 0.0) for b in blocks)
        batches = sum(b.get("batches", 0) for b in blocks)
        return {
            "total_wall_s": total,
            "batches": batches,
            "batches_per_s": (batches / total) if total > 0 else None,
            "tasks": len(blocks),
            "phases": {
                name: {
                    "total_s": totals[name],
                    "share": (totals[name] / total) if total > 0 else 0.0,
                }
                for name in names
            },
        }

    workers = {
        key: _merged(list(per_worker[key]))
        for key in sorted(per_worker)
        if per_worker[key]
    }
    flat = [b for key in sorted(per_worker) for b in per_worker[key]]
    return {"workers": workers, "fleet": _merged(flat)}
