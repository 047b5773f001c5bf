"""Metrics and logging: per-job CSV, cluster-utilization samples, summaries.

The port's own copy of ``gpuschedule_tpu/sim/metrics.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

Matches the reference's logging surface (SURVEY.md §2 "Metrics/log", §8 in the
layer map): per-job rows (submit/start/end → JCT, queueing delay), per-event
cluster utilization samples, and an end-of-run summary whose headline numbers
are **average JCT** and **makespan** (the BASELINE.json contract metrics),
plus 95th-percentile queueing delay (SURVEY.md §3.1 summary line).
"""

from __future__ import annotations

import csv
import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Dict, List, Optional, Sequence, Union

from gpuschedule_tpu_torch.sim.job import Job, JobState

# JCT/queueing-delay histogram buckets for the obs registry: seconds to a
# week, the span Philly-scale replays actually cover.
_DELAY_BUCKETS = (
    60.0, 300.0, 900.0, 3600.0, 4 * 3600.0, 24 * 3600.0, 7 * 24 * 3600.0,
    float("inf"),
)

# Streamed-sink write batching: events accumulate in
# an in-process buffer and hit the sink in one write() per this many
# records, instead of one write() per event.  The flush contract is
# explicit: flush_events() / close_events() / write() force the buffer
# down (the MetricsLog context manager guarantees it on engine crashes —
# the pinned crash-flush regression); until then the tail of the stream
# may sit in the buffer.
_SINK_BUFFER_RECORDS = 512

# Version of the JSONL event-stream schema.  The stream's first record is a
# header ``{"schema": EVENT_SCHEMA, "run_id", "seed", "policy",
# "config_hash", ...}`` when the run supplies ``run_meta``; readers
# (obs/analyze.py) refuse streams whose header is missing or from a
# different schema version instead of silently mis-reconstructing.  Bump
# this when event payloads change incompatibly (docs/events.md records the
# policy).
EVENT_SCHEMA = 1

JOB_CSV_FIELDS = [
    "job_id",
    "num_chips",
    "submit_time",
    "first_start_time",
    "end_time",
    "jct",
    "queueing_delay",
    "slowdown",
    "executed_work",
    "attained_service",
    "preempt_count",
    "migration_count",
    "fault_count",
    "lost_work",
    "status",
    "end_state",
    "model_name",
]


def _percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile on a copy-sorted list (no numpy dependency in
    the sim core)."""
    if not values:
        return 0.0
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclass
class SimResult:
    """End-of-run summary. ``jobs`` holds the full per-job records."""

    avg_jct: float
    makespan: float
    p95_queueing_delay: float
    mean_utilization: float
    num_finished: int
    num_unfinished: int
    counters: Dict[str, int]
    end_time: float
    num_rejected: int = 0
    # Fairness tail: slowdown = JCT / dedicated-run duration per job
    # (sim/job.py).  avg JCT rewards policies that favor short jobs;
    # these expose what that costs the worst-treated job (Themis's
    # objective is minimizing exactly this tail).
    p95_slowdown: float = 0.0
    max_slowdown: float = 0.0
    # Trace-declared end states among the finished jobs (a faithful Philly
    # replay surfaces Failed/Killed terminals, not just a finished count).
    num_done: int = 0
    num_failed: int = 0
    num_killed: int = 0
    # Goodput decomposition in chip-seconds (faults/): every chip-second of
    # service went to exactly one leg — work that survived to the end
    # ("useful"), work a later fault rolled back ("lost"), or modeled
    # restart/migration/restore overhead.  useful + lost + overhead ==
    # total by construction.  "total" is per-job service time (each job's
    # allocated_chips x held seconds); under Gandiva overlay packing two
    # jobs sharing one slice each accrue their own service, so the total
    # can exceed physical occupancy — it equals it exactly when nothing
    # is packed.
    goodput: Dict[str, float] = field(default_factory=dict)
    # Causal attribution: per-cause delay/run legs in seconds,
    # summed over per-job ``Job.attrib`` dicts in arrival order — the same
    # order and arithmetic obs/analyze.py uses, so the analyzer's
    # ``delay_by_cause()`` equals this to the last float (the wait-
    # decomposition closure, like the goodput one).  Empty unless the run
    # was captured with ``MetricsLog(attribution=True)``.
    delay_by_cause: Dict[str, float] = field(default_factory=dict)
    jobs: List[Job] = field(repr=False, default_factory=list)

    def summary(self) -> Dict[str, float]:
        return {
            "avg_jct": self.avg_jct,
            "makespan": self.makespan,
            "p95_queueing_delay": self.p95_queueing_delay,
            "p95_slowdown": self.p95_slowdown,
            "max_slowdown": self.max_slowdown,
            "mean_utilization": self.mean_utilization,
            "num_finished": self.num_finished,
            "num_unfinished": self.num_unfinished,
            "num_rejected": self.num_rejected,
            "num_done": self.num_done,
            "num_failed": self.num_failed,
            "num_killed": self.num_killed,
            **{f"goodput_{k}": v for k, v in self.goodput.items()},
            # only attribution-armed runs carry these keys, so the
            # attribution-off stdout contract stays byte-identical
            **{
                f"delay_{k.replace('-', '_')}_s": v
                for k, v in sorted(self.delay_by_cause.items())
            },
            **{k: float(v) for k, v in self.counters.items()},
        }


class MetricsLog:
    """Accumulates job records and utilization samples during a run.

    The time-weighted utilization summary is integrated incrementally at
    every :meth:`sample` call, so it stays exact regardless of how many
    samples are *stored*: storage is capped at ``max_util_samples`` by
    stride-doubling decimation (keep every 2nd, then every 4th, ...), which
    bounds memory on Philly-scale traces (10^5 jobs -> ~10^6 event samples)
    while the persisted utilization.csv remains a uniform subsample.
    """

    def __init__(
        self,
        *,
        max_util_samples: int = 200_000,
        record_events: bool = False,
        events_sink: Optional[Union[str, Path, IO]] = None,
        registry=None,
        run_meta: Optional[dict] = None,
        attribution: bool = False,
        cache_telemetry: bool = False,
        flush_interval_s: Optional[float] = None,
    ) -> None:
        self.job_rows: List[dict] = []
        # Cache telemetry: when armed, the engine harvests
        # every cache's hit/miss/invalidate counts at the end of
        # the run through :meth:`cache_event` — summary counters gain
        # ``cache_<name>_<outcome>`` keys, the registry (when attached)
        # gains the labeled ``engine_cache_events`` family, and the event
        # stream a trailing ``cache`` record.  Off (the default) the
        # summary/stream/registry stay byte-identical to pre-telemetry.
        self.cache_telemetry = bool(cache_telemetry)
        self._reg_cache_events = None
        # Causal attribution: when True the engine blames every
        # queued interval with its cause, splits running time into
        # slowdown legs (sim/job.py WAIT_CAUSES / RUN_LEGS), and stamps
        # the cumulative legs onto lifecycle events.  Off by default —
        # the off path emits byte-identical streams, jobs.csv, and
        # summaries (the regression contract).
        self.attribution = bool(attribution)
        # Structured event stream (SURVEY.md §5 "Metrics/logging": CSVs plus
        # a structured JSONL event log).  Off by default: at Philly scale the
        # stream is ~10^6 dicts, so it is opt-in (CLI --events).
        #
        # ``events_sink`` (a path or an open text file) streams each event to
        # JSONL as it happens instead of buffering: the in-memory list stays
        # empty, so Philly-scale runs no longer hold ~10^6 dicts in RAM just
        # to persist them at write() time.  Passing a
        # sink implies ``record_events``.
        self.record_events = record_events or events_sink is not None
        self.events: List[dict] = []
        # Event-stream header: when the caller identifies
        # the run (run_id/seed/policy/config_hash, CLI does), the first
        # record emitted is a schema-versioned header so readers can refuse
        # mismatched or concatenated streams.  None (the default, every
        # pre-existing caller) emits no header and the stream is exactly the
        # bare transition log it always was.
        self.run_meta = dict(run_meta) if run_meta is not None else None
        self._header_emitted = False
        self._sink_path: Optional[Path] = None
        self._sink_fh: Optional[IO] = None
        self._owns_sink = False
        self._sink_opened = False
        self._sink_buf: List[str] = []  # pending JSONL lines (flush contract)
        if events_sink is not None:
            if hasattr(events_sink, "write"):
                self._sink_fh = events_sink
            else:
                self._sink_path = Path(events_sink)
        # Tailable-sink flush cadence: batching alone lets the
        # tail of a live stream sit in the buffer for an unbounded sim
        # span (512 records can be hours of a quiet replay), which a
        # tailing watcher (obs/watch.py) would read as a stalled cluster.
        # ``flush_interval_s`` arms a SIM-TIME cadence: whenever an event
        # lands at or past the next multiple, the buffer AND the file
        # handle flush, so the on-disk stream is never more than one
        # interval of sim time behind the replay.  None (the default)
        # keeps the pure 512-record batching — byte-for-byte the
        # historical write pattern.  The engine's periodic snapshots
        # flush independently (sim/snapshot.py snapshot_state), so a
        # snapshot always lands on a stream consistent AT its instant —
        # the watchtower's flight-recorder handshake.
        if flush_interval_s is not None and flush_interval_s <= 0.0:
            raise ValueError(
                f"flush_interval_s must be > 0 seconds, got {flush_interval_s}"
            )
        self._flush_every = flush_interval_s
        self._flush_next = flush_interval_s if flush_interval_s else None
        # Optional obs-layer registry (obs/metrics.py): counters mirror into
        # Prometheus counter families, per-job records feed JCT/queueing
        # histograms, and every utilization sample updates the occupancy
        # gauges.  None (the default) costs one attribute check per call.
        self._registry = registry
        self._reg_counters: Dict[str, object] = {}  # count() key -> Counter
        if registry is not None:
            self._reg_running = registry.gauge(
                "sim_jobs_running", "jobs holding allocations")
            self._reg_pending = registry.gauge(
                "sim_jobs_pending", "jobs queued for allocations")
            self._reg_used = registry.gauge(
                "sim_chips_used", "chips currently allocated")
            self._reg_total = registry.gauge(
                "sim_chips_total", "cluster capacity in chips")
            self._reg_jct = registry.histogram(
                "sim_jct_seconds", "job completion time", buckets=_DELAY_BUCKETS)
            self._reg_queue = registry.histogram(
                "sim_queueing_delay_seconds", "submit-to-first-start delay",
                buckets=_DELAY_BUCKETS)
            self._reg_end_state = registry.counter(
                "sim_jobs_end_state_total",
                "terminal job states (trace-declared Pass/Failed/Killed "
                "plus admission rejections)",
                labelnames=("state",))
        # net/ link gauges are created lazily on the first sample: a run
        # without the contention model must leave the registry (and its
        # metrics.prom bytes) exactly as before the net layer existed
        self._reg_net_util = None
        self._reg_net_gbps = None
        self.util_samples: List[tuple] = []  # (t, used, total, running, pending)
        self.counters: Counter = Counter()
        self._all_jobs: Sequence[Job] = ()   # set by attach_jobs(); lets write()
                                             # emit rows for unfinished jobs too
        self.max_util_samples = max(2, max_util_samples)
        self._stride = 1                     # store every _stride-th sample
        self._sample_calls = 0
        self._last_t: Optional[float] = None
        self._last_frac = 0.0                # used/total at the previous sample
        self._util_area = 0.0                # integral of (used/total) dt
        self._util_horizon = 0.0             # total dt with total > 0
        self._tail: Optional[tuple] = None   # most recent sample, always kept

    def attach_jobs(self, jobs: Sequence[Job]) -> None:
        """Register the full job list (engine does this at construction) so
        :meth:`write` can emit rows for unfinished jobs even if the run aborts
        before :meth:`result` is reached."""
        self._all_jobs = jobs

    # ------------------------------------------------------------------ #
    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n
        if self._registry is not None:
            c = self._reg_counters.get(key)
            if c is None:
                # resolve the family once per key: sanitize + registry lock
                # stay off the per-event hot path
                c = self._registry.counter(
                    f"sim_{key}_total", "engine counter (MetricsLog)")
                self._reg_counters[key] = c
            c.inc(n)

    def cache_event(self, cache: str, outcome: str, n: int = 1) -> None:
        """One unified cache-telemetry event: mirrors into the
        plain summary counter ``cache_<cache>_<outcome>`` and, with a
        registry attached, the labeled counter family
        ``engine_cache_events{cache=...,outcome=...}`` — one surface for
        what used to be ad-hoc per-subsystem counters."""
        self.counters[f"cache_{cache}_{outcome}"] += n
        if self._registry is not None:
            if self._reg_cache_events is None:
                self._reg_cache_events = self._registry.counter(
                    "engine_cache_events",
                    "engine cache events by cache and outcome "
                    "(hit / miss / invalidate / fallback)",
                    labelnames=("cache", "outcome"),
                )
            self._reg_cache_events.labels(cache, outcome).inc(n)

    def _sink(self) -> Optional[IO]:
        if self._sink_fh is not None:
            return self._sink_fh
        if self._sink_path is not None:
            self._sink_path.parent.mkdir(parents=True, exist_ok=True)
            # "a" on reopen: a close_events()/write() mid-run must not let a
            # later event truncate everything streamed before it
            self._sink_fh = open(self._sink_path, "w" if not self._sink_opened else "a")
            self._owns_sink = self._sink_opened = True
            return self._sink_fh
        return None

    def set_run_meta(self, **fields) -> None:
        """Merge identifying fields into the pending event-stream header
        (no-op once the header has been written — identity is immutable
        after the first event)."""
        if self._header_emitted:
            return
        if self.run_meta is None:
            self.run_meta = {}
        self.run_meta.update(fields)

    def _emit_record(self, rec: dict) -> None:
        if self._sink_fh is not None or self._sink_path is not None:
            # buffered streaming: one write() per
            # _SINK_BUFFER_RECORDS events instead of one per event; the
            # explicit flush contract (flush_events/close_events/write)
            # forces the tail down
            buf = self._sink_buf
            buf.append(json.dumps(rec) + "\n")
            if len(buf) >= _SINK_BUFFER_RECORDS:
                self.flush_events()
        else:
            self.events.append(rec)

    def flush_events(self) -> None:
        """Push buffered event lines to the sink in a single write().
        Part of the explicit flush contract: callers that need the stream
        durable mid-run (tailing a live replay, handing the file to a
        reader) call this; :meth:`close_events` and :meth:`write` call it
        for you."""
        if self._sink_buf:
            sink = self._sink()
            if sink is not None:
                sink.write("".join(self._sink_buf))
            self._sink_buf.clear()

    def _emit_header(self) -> None:
        """Write the schema-versioned header record ahead of the first
        event (lazy so ``set_run_meta`` calls between construction and the
        first transition — the Simulator fills in policy/cluster facts —
        all land in it)."""
        if self._header_emitted or self.run_meta is None:
            return
        self._header_emitted = True
        self._emit_record({"schema": EVENT_SCHEMA, **self.run_meta})

    def event(self, kind: str, t: float, job: Optional[Job] = None, **extra) -> None:
        """Record one structured event (no-op unless ``record_events``):
        streamed straight to the JSONL sink when one is configured, buffered
        in :attr:`events` otherwise."""
        if not self.record_events:
            return
        if not self._header_emitted:
            self._emit_header()
        rec: dict = {"t": t, "event": kind}
        if job is not None:
            rec["job"] = job.job_id
        rec.update(extra)
        self._emit_record(rec)
        if self._flush_every is not None and t >= self._flush_next:
            # tailable-sink cadence: make everything up to and
            # including this event durable, down to the OS
            self.flush_events()
            if self._sink_fh is not None:
                self._sink_fh.flush()
            nxt = self._flush_next
            while nxt <= t:
                nxt += self._flush_every
            self._flush_next = nxt

    def close_events(self) -> None:
        """Flush (buffer included) and — when this log opened it — close
        the JSONL sink.  Safe to call repeatedly; :meth:`write` calls it
        for you."""
        self.flush_events()
        if self._sink_fh is not None:
            self._sink_fh.flush()
            if self._owns_sink:
                self._sink_fh.close()
                self._sink_fh = None
                self._owns_sink = False

    def __enter__(self) -> "MetricsLog":
        """Context-manager path: guarantees the JSONL
        sink is flushed/closed even when the engine raises mid-run, so a
        crashed replay still leaves an analyzable stream behind."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close_events()

    @staticmethod
    def _job_row(job: Job) -> dict:
        """One jobs.csv row; end_time/jct are None while a job is unfinished."""
        return {
            "job_id": job.job_id,
            "num_chips": job.num_chips,
            "submit_time": job.submit_time,
            "first_start_time": job.first_start_time,
            "end_time": job.end_time,
            "jct": job.jct(),
            "queueing_delay": job.queueing_delay(),
            "slowdown": job.slowdown(),
            "executed_work": round(job.executed_work, 6),
            "attained_service": round(job.attained_service, 6),
            "preempt_count": job.preempt_count,
            "migration_count": job.migration_count,
            "fault_count": job.fault_count,
            "lost_work": round(job.lost_work, 6),
            "status": job.status,
            "end_state": job.state.value,
            "model_name": job.model_name,
        }

    def record_job(self, job: Job) -> None:
        self.job_rows.append(self._job_row(job))
        if self._registry is not None:
            self._reg_end_state.labels(job.state.value).inc()
            if job.state is not JobState.REJECTED:
                j = job.jct()
                if j is not None:
                    self._reg_jct.observe(j)
                q = job.queueing_delay()
                if q is not None:
                    self._reg_queue.observe(q)

    def sample(self, t: float, cluster, num_running: int, num_pending: int) -> None:
        used, total = cluster.used_chips, cluster.total_chips
        # Exact piecewise-constant integral: occupancy over [last_t, t) is
        # whatever the previous sample observed.
        if self._last_t is not None and total > 0 and t > self._last_t:
            dt = t - self._last_t
            self._util_area += self._last_frac * dt
            self._util_horizon += dt
        self._last_t = t
        self._last_frac = used / total if total > 0 else 0.0

        if self._registry is not None:
            self._reg_running.set(num_running)
            self._reg_pending.set(num_pending)
            self._reg_used.set(used)
            self._reg_total.set(total)

        self._tail = (t, used, total, num_running, num_pending)
        if self._sample_calls % self._stride == 0:
            self.util_samples.append(self._tail)
            if len(self.util_samples) > self.max_util_samples:
                self.util_samples = self.util_samples[::2]
                self._stride *= 2
        self._sample_calls += 1

    def net_link_samples(self, links) -> None:
        """Mirror the contention model's per-link load into labeled
        registry gauges (net/ tentpole observability).  No-op without a
        registry; gauges materialize on the first call so net-free runs
        keep a byte-identical Prometheus exposition."""
        if self._registry is None or not links:
            return
        if self._reg_net_util is None:
            self._reg_net_util = self._registry.gauge(
                "net_link_utilization",
                "fraction of DCN link capacity in use (ingest + allreduce)",
                labelnames=("link",))
            self._reg_net_gbps = self._registry.gauge(
                "net_link_used_gbps",
                "DCN link load in Gbps (ingest + allreduce)",
                labelnames=("link",))
        for name, sample in links.items():
            self._reg_net_util.labels(name).set(sample.util)
            self._reg_net_gbps.labels(name).set(sample.used_gbps)

    def _flush_tail(self) -> None:
        """Ensure the final observed sample is stored: once decimation raises
        the stride, the last call is usually not a stride multiple, and the
        persisted log would end before the simulation does.

        Idempotent by construction — the tail is only appended when it is not
        already the stored last sample — so ``write()`` twice, or ``write()``
        followed by ``result()``, never duplicates it even right after a
        stride-doubling decimation dropped it (the regression pinned by
        tests/test_events.py::test_write_idempotent_after_flush_tail)."""
        if self._tail is not None and (
            not self.util_samples or self.util_samples[-1] != self._tail
        ):
            self.util_samples.append(self._tail)

    # ------------------------------------------------------------------ #
    def result(self, jobs: Sequence[Job], end_time: float) -> SimResult:
        self._flush_tail()
        # Admission-rejected jobs never ran: counting their 0-second "JCT"
        # would flatter clusters that reject more, so they are excluded from
        # every aggregate and surfaced via the num_rejected field /
        # rejected_unsatisfiable counter instead.
        finished = [
            j for j in jobs if j.end_time is not None and j.state is not JobState.REJECTED
        ]
        jcts = [j.jct() for j in finished]
        qdelays = [j.queueing_delay() for j in finished if j.queueing_delay() is not None]
        slowdowns = [j.slowdown() for j in finished if j.slowdown() is not None]
        if finished:
            start = min(j.submit_time for j in finished)
            makespan = max(j.end_time for j in finished) - start
        else:
            makespan = 0.0
        # Time-weighted mean utilization, integrated incrementally in sample()
        # (exact even when the stored sample list has been decimated).
        util = self._util_area / self._util_horizon if self._util_horizon > 0 else 0.0
        rejected = sum(1 for j in jobs if j.state is JobState.REJECTED)
        states = Counter(j.state for j in finished)
        # Goodput decomposition over ALL jobs (unfinished ones occupied
        # chips too): attained_service splits into the surviving and the
        # fault-rolled-back share, overhead_service is the third leg.
        attained = sum(j.attained_service for j in jobs)
        lost = sum(j.lost_service for j in jobs)
        overhead = sum(j.overhead_service for j in jobs)
        goodput = {
            "useful_chip_s": attained - lost,
            "lost_chip_s": lost,
            "restart_overhead_chip_s": overhead,
            "total_chip_s": attained + overhead,
        }
        # Attribution legs summed per cause, jobs in arrival order with
        # sorted keys per job — obs/analyze.py mirrors this arithmetic
        # exactly, which is what makes the wait-decomposition closure
        # bit-exact (same floats, same additions, same order).
        delay_by_cause: Dict[str, float] = {}
        for j in jobs:
            if j.attrib:
                for k in sorted(j.attrib):
                    delay_by_cause[k] = delay_by_cause.get(k, 0.0) + j.attrib[k]
        return SimResult(
            avg_jct=sum(jcts) / len(jcts) if jcts else 0.0,
            makespan=makespan,
            p95_queueing_delay=_percentile(qdelays, 95.0),
            p95_slowdown=_percentile(slowdowns, 95.0),
            max_slowdown=max(slowdowns) if slowdowns else 0.0,
            mean_utilization=util,
            num_finished=len(finished),
            num_unfinished=len(jobs) - len(finished) - rejected,
            counters=dict(self.counters),
            end_time=end_time,
            num_rejected=rejected,
            num_done=states[JobState.DONE],
            num_failed=states[JobState.FAILED],
            num_killed=states[JobState.KILLED],
            goodput=goodput,
            delay_by_cause=delay_by_cause,
            jobs=list(jobs),
        )

    # ------------------------------------------------------------------ #
    def write(self, out_dir: str | Path, *, prefix: str = "") -> None:
        """Write job-level and utilization CSVs plus a counters JSON."""
        self._flush_tail()
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        # Finished jobs were recorded incrementally; unfinished jobs (horizon
        # cutoff) get a row with empty end_time/jct so the persisted log covers
        # the whole trace.
        extra_rows = [
            self._job_row(j) for j in self._all_jobs if j.end_time is None
        ]
        with open(out / f"{prefix}jobs.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=JOB_CSV_FIELDS)
            w.writeheader()
            w.writerows(self.job_rows)
            w.writerows(extra_rows)
        with open(out / f"{prefix}utilization.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time", "used_chips", "total_chips", "running", "pending"])
            w.writerows(self.util_samples)
        with open(out / f"{prefix}counters.json", "w") as f:
            json.dump(dict(self.counters), f, indent=2, sort_keys=True)
        if self.record_events:
            if self._sink_path is not None or self._sink_fh is not None:
                # streamed as they happened; just make them durable.  A
                # zero-event run never opened its lazy path sink — force the
                # file into existence (header included, when armed) so the
                # JSONL is always there, exactly as the buffered branch
                # below guarantees.
                if self._sink_path is not None and not self._sink_opened:
                    self._sink()
                self._emit_header()
                self.close_events()
            else:
                self._emit_header()  # zero-event buffered run, header armed
                with open(out / f"{prefix}events.jsonl", "w") as f:
                    for rec in self.events:
                        f.write(json.dumps(rec) + "\n")
