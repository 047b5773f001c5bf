"""Run analytics: streaming per-job lifecycle reconstruction from the
JSONL event log.

The port's own copy of ``gpuschedule_tpu/obs/analyze.py``; its documents
equal that package's to the byte (``tests/test_torch_obs.py``).

The Philly study draws its conclusions from *derived* analytics —
queueing-delay distributions, utilization over time, failure attribution —
not raw traces.  This module is that layer for our event streams: a
single-pass analyzer that replays the ``MetricsLog`` transition log
through per-job state machines

    submit -> queued -> running -> (preempt | migrate | resize | rebind |
    fault-revoke)* -> done / failed / killed   (or rejected / cut off)

in O(active jobs) working state, validating every transition, and derives

- wait / run / JCT / slowdown / preemption-count distributions with exact
  p50/p95/p99 (``obs.metrics.exact_quantile``, numpy-equivalent);
- demand-occupancy and fragmentation time series (time-weighted means are
  integrated incrementally, exact under sample decimation);
- a fault-attribution table (per fault kind: outages, revocations, lost
  work, lost chip-seconds, restore cost charged) whose goodput
  decomposition **closes bit-exactly against SimResult.goodput**: every
  per-job lifecycle event carries the engine's cumulative progress
  snapshot (``"prog"``, exact floats, sim/engine.py), and
  :meth:`RunAnalysis.goodput` sums the per-job legs in arrival order —
  the same order and the same arithmetic ``SimResult`` uses.

Streams are versioned: the first record must be a schema header
(``{"schema": 1, "run_id", "seed", "policy", "config_hash", ...}``,
written by ``MetricsLog(run_meta=...)``).  A missing or mismatched header
raises :class:`SchemaError`; a second header mid-stream means two runs
were concatenated and raises :class:`StreamError` — both instead of
silently producing garbage.

Pure stdlib, jax-free, streaming: a Philly-scale events.jsonl never needs
to be held in memory (per-*finished*-job output records are kept — the
same footprint as jobs.csv — but full event payloads are not).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import math
import os
import sqlite3
import tempfile
from pathlib import Path
from dataclasses import dataclass, field, fields as dataclass_fields
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from gpuschedule_tpu_torch.obs.metrics import quantile_sorted

# The event-stream schema version this analyzer understands.  Kept as the
# reader's own constant (the writer's is sim/metrics.py:EVENT_SCHEMA;
# tests pin the two equal) so the obs layer never imports the sim package
# at module load.
SCHEMA_VERSION = 1

# Analyzer lifecycle states (strings, not the sim's JobState enum: the
# analyzer must work on a bare JSONL file with no sim objects in sight).
QUEUED, RUNNING, SUSPENDED = "queued", "running", "suspended"
TERMINAL_STATES = ("done", "failed", "killed", "rejected")

# Causal-attribution leg names — the reader's own copy of
# sim/job.py's WAIT_CAUSES / RUN_LEGS (same no-sim-import rule as
# SCHEMA_VERSION; tests pin the two equal).  WAIT_CAUSES blame queued/
# suspended intervals; RUN_LEGS split running time into the work-
# equivalent and its slowdown stretches.
WAIT_CAUSES = (
    "admission", "capacity", "fault-outage", "net-outage", "policy-preempt"
)
RUN_LEGS = ("work", "policy-share", "net-degraded", "straggler", "overhead")

_QUANTS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class SchemaError(ValueError):
    """The stream's header is missing, unversioned, or from a schema this
    analyzer does not understand."""


class StreamError(ValueError):
    """The stream is structurally invalid: an impossible lifecycle
    transition, non-monotonic time, or two concatenated runs."""


class StreamCursor:
    """Incremental JSONL ingestion: feed text chunks as they
    arrive and get back complete parsed records.

    The one invariant that makes a *growing* file tailable: a trailing
    line that has not yet received its newline is **retained, not
    parsed and not skipped** — mid-record truncation is the normal state
    of a stream another process is still appending to, so the fragment
    waits in the cursor and is re-read whole once the writer completes
    it.  A *complete* line that fails to parse is corruption and raises
    :class:`StreamError` immediately.

    One cursor serves every ingestion mode: ``analyze_file`` (one-shot,
    both memory modes) drives it to :meth:`finish`, where a leftover
    fragment IS corruption; ``watch --follow`` feeds whatever bytes the
    poll loop found and simply keeps going.

    Yields ``(lineno, raw_line, record)`` tuples so tailing consumers
    (the watchtower's flight recorder) can keep the writer's exact bytes
    without re-serializing."""

    def __init__(self, name: str = "<stream>"):
        self.name = name
        self.lineno = 0
        self._pending = ""

    @property
    def pending(self) -> str:
        """The retained (newline-less) tail fragment, if any."""
        return self._pending

    def _parse(self, line: str) -> Optional[Tuple[int, str, dict]]:
        self.lineno += 1
        stripped = line.strip()
        if not stripped:
            return None
        try:
            return (self.lineno, line, json.loads(stripped))
        except json.JSONDecodeError as e:
            raise StreamError(
                f"{self.name}:{self.lineno}: truncated or corrupt JSONL "
                f"record ({e}) — was the writer killed mid-record?"
            ) from None

    def feed(self, chunk: str) -> List[Tuple[int, str, dict]]:
        """Absorb one text chunk; return the complete records it closed.
        One split per chunk (never a per-line re-slice of the remaining
        buffer) keeps ingestion linear in the stream length — this is
        the hot path of every ``analyze``/``report``/``compare``
        invocation, not just the tail loop."""
        out: List[Tuple[int, str, dict]] = []
        lines = (self._pending + chunk).split("\n")
        self._pending = lines.pop()
        for line in lines:
            item = self._parse(line)
            if item is not None:
                out.append(item)
        return out

    def finish(self, *, strict: bool = True) -> List[Tuple[int, str, dict]]:
        """End of stream.  A retained fragment is parsed if it is a whole
        record (the writer just never wrote the final newline); a
        fragment that does not parse raises under ``strict`` (one-shot
        readers: the file is truncated) and is dropped otherwise (a tail
        the live writer never completed before the watcher gave up)."""
        tail, self._pending = self._pending, ""
        if not tail.strip():
            return []
        if strict:
            item = self._parse(tail)
            return [item] if item is not None else []
        try:
            return [x for x in (self._parse(tail),) if x is not None]
        except StreamError:
            return []


def iter_jsonl_items(path) -> Iterator[Tuple[int, str, dict]]:
    """One-shot streaming iteration over an events.jsonl(.gz) file via
    :class:`StreamCursor` — the same incremental reader the watchtower
    tails with, driven to completion: unreadable files and truncated or
    corrupt records raise :class:`StreamError` (the CLI's exit-2
    "not comparable" bucket, never a raw traceback).  Yields
    ``(lineno, raw_line, record)`` so consumers that need the writer's
    exact bytes (the watchtower's flight recorder) share this one
    drive loop."""
    opener = gzip.open if str(path).endswith(".gz") else open
    cursor = StreamCursor(name=str(path))
    try:
        with opener(path, "rt") as f:
            while True:
                chunk = f.read(1 << 16)
                if not chunk:
                    break
                for item in cursor.feed(chunk):
                    yield item
        for item in cursor.finish():
            yield item
    except (OSError, EOFError) as e:
        # gzip corruption raises BadGzipFile (an OSError) or EOFError
        raise StreamError(f"cannot read event stream {path}: {e}") from None


def iter_jsonl_records(path) -> Iterator[dict]:
    """:func:`iter_jsonl_items` without the raw-byte plumbing — the
    record view ``analyze_file`` and the report/compare CLIs consume."""
    return (rec for _, _, rec in iter_jsonl_items(path))


def config_hash(config: dict) -> str:
    """Stable 12-hex-digit digest of a run configuration (sorted-key JSON
    over the given mapping).  The CLI hashes the *experiment* config —
    cluster + trace + fault spec, deliberately **not** the policy — so two
    runs are header-compatible for ``compare`` exactly when they replayed
    the same world, whichever policy scheduled it."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


@dataclass
class RunHeader:
    """The stream's identity record (first line of events.jsonl)."""

    schema: int
    run_id: str = ""
    seed: Optional[int] = None
    policy: str = ""
    config_hash: str = ""
    total_chips: Optional[int] = None
    extra: dict = field(default_factory=dict)

    _KNOWN = ("schema", "run_id", "seed", "policy", "config_hash", "total_chips")

    @classmethod
    def from_record(cls, rec: dict) -> "RunHeader":
        schema = rec.get("schema")
        if not isinstance(schema, int):
            raise SchemaError(f"header schema must be an int, got {schema!r}")
        if schema != SCHEMA_VERSION:
            raise SchemaError(
                f"event stream is schema {schema}; this analyzer understands "
                f"schema {SCHEMA_VERSION} — re-capture the stream or use a "
                f"matching version"
            )
        return cls(
            schema=schema,
            run_id=str(rec.get("run_id", "")),
            seed=rec.get("seed"),
            policy=str(rec.get("policy", "")),
            config_hash=str(rec.get("config_hash", "")),
            total_chips=rec.get("total_chips"),
            extra={k: v for k, v in rec.items() if k not in cls._KNOWN},
        )

    def to_json(self) -> dict:
        out = {
            "schema": self.schema, "run_id": self.run_id, "seed": self.seed,
            "policy": self.policy, "config_hash": self.config_hash,
            "total_chips": self.total_chips,
        }
        out.update(self.extra)
        return out


@dataclass
class JobRecord:
    """One job's reconstructed lifecycle (the analyzer's jobs.csv row)."""

    job_id: str
    order: int                    # arrival order == trace submit order
    submit_t: float
    chips: int = 0                # requested gang size
    duration: Optional[float] = None
    status: Optional[str] = None
    first_start_t: Optional[float] = None
    end_t: Optional[float] = None
    end_state: Optional[str] = None   # done/failed/killed/rejected; None = unfinished
    starts: int = 0
    preempts: int = 0
    migrations: int = 0
    rebinds: int = 0
    faults: int = 0
    # shared-fabric contention (net/): how often this job's bandwidth was
    # re-priced, its time-integrated allocated bandwidth (Gbps x s while
    # running), and its offered demand — the bandwidth-share table inputs
    net_updates: int = 0
    bw_gbps_s: float = 0.0
    demand_gbps: Optional[float] = None
    # adaptive routing: how often this flow's weighted uplink
    # set changed (a degraded sibling shed onto survivors, or healed)
    reroutes: int = 0
    run_time: float = 0.0         # seconds spent RUNNING
    queue_time: float = 0.0       # seconds QUEUED after submit (incl. requeues)
    suspended_time: float = 0.0   # seconds SUSPENDED (preempted with resume intent)
    # exact cumulative legs from the engine's last "prog" snapshot
    work: float = 0.0
    service: float = 0.0
    lost_service: float = 0.0
    overhead_service: float = 0.0
    lost_work: float = 0.0
    # causal attribution: the engine's exact cumulative per-leg
    # seconds, adopted from event "blame" snapshots (empty when the run
    # was captured without attribution)
    delay_legs: Dict[str, float] = field(default_factory=dict)
    # three-way split of the folded net-degraded stretch: the analyzer derives it from the
    # locality ladder the stream already carries — placement events
    # (start/migrate/resize/rebind) carry the allocation's STATIC factor,
    # `net` re-prices carry the DYNAMIC one, and the `track` prefix says
    # whether a static toll is the multislice DCN term or a GPU locality
    # tier.  Keys: `dcn-contention` (speed x (static - dynamic)),
    # `multislice-toll` / `gpu-locality` (speed x (1 - static)).  Empty
    # whenever every factor was 1.0.
    net_legs: Dict[str, float] = field(default_factory=dict)

    def wait(self) -> Optional[float]:
        if self.first_start_t is None:
            return None
        return self.first_start_t - self.submit_t

    def jct(self) -> Optional[float]:
        if self.end_t is None:
            return None
        return self.end_t - self.submit_t

    def slowdown(self) -> Optional[float]:
        j = self.jct()
        if j is None or not self.duration:
            return None
        return j / max(self.duration, 1e-9)

    def mean_bw_gbps(self) -> Optional[float]:
        """Time-weighted mean allocated DCN bandwidth while running (None
        for jobs the contention model never priced)."""
        if not self.net_updates or self.run_time <= 0.0:
            return None
        return self.bw_gbps_s / self.run_time

    # ---- causal decompositions ----------------------------- #

    def wait_legs(self) -> Dict[str, float]:
        """The queued-interval blame legs alone (WAIT_CAUSES keys)."""
        return {
            k: self.delay_legs[k]
            for k in sorted(self.delay_legs)
            if k in WAIT_CAUSES
        }

    def run_legs(self) -> Dict[str, float]:
        """The running-interval slowdown legs alone (RUN_LEGS keys)."""
        return {
            k: self.delay_legs[k]
            for k in sorted(self.delay_legs)
            if k not in WAIT_CAUSES
        }

    def attributed_wait(self) -> float:
        """This job's wait as the decomposition's own arithmetic states
        it: the ordered (sorted-key) sum of the blame legs.  The per-job
        closure is definitional — ``sum(wait_legs().values())`` IS this
        number — while the analyzer's independently integrated
        ``queue_time + suspended_time`` cross-checks it to float dust
        (``wait_residual``)."""
        total = 0.0
        for k in sorted(self.delay_legs):
            if k in WAIT_CAUSES:
                total += self.delay_legs[k]
        return total

    def attributed_jct(self) -> float:
        """All legs summed (sorted keys): waits + work + slowdown
        stretches + overhead — the slowdown decomposition's JCT."""
        total = 0.0
        for k in sorted(self.delay_legs):
            total += self.delay_legs[k]
        return total

    def wait_residual(self) -> Optional[float]:
        """Attributed wait minus the analyzer's own state integration
        (float re-association dust on healthy streams; a large value
        means the stream is missing a transition)."""
        if not self.delay_legs:
            return None
        return self.attributed_wait() - (self.queue_time + self.suspended_time)

    def jct_residual(self) -> Optional[float]:
        """Attributed JCT minus ``end_t - submit_t`` for finished jobs
        (same dust-vs-missing-transition meaning as wait_residual)."""
        j = self.jct()
        if j is None or not self.delay_legs:
            return None
        return self.attributed_jct() - j

    @property
    def finished(self) -> bool:
        return self.end_state in ("done", "failed", "killed")

    def to_json(self) -> dict:
        return {
            "job_id": self.job_id, "submit_t": self.submit_t,
            "chips": self.chips, "wait": self.wait(), "jct": self.jct(),
            "run_time": self.run_time, "queue_time": self.queue_time,
            "suspended_time": self.suspended_time,
            "slowdown": self.slowdown(), "end_state": self.end_state,
            "starts": self.starts, "preempts": self.preempts,
            "migrations": self.migrations, "faults": self.faults,
            "work": self.work, "service": self.service,
            "lost_service": self.lost_service,
            "overhead_service": self.overhead_service,
            "lost_work": self.lost_work,
            "net_updates": self.net_updates,
            "mean_bw_gbps": self.mean_bw_gbps(),
            "demand_gbps": self.demand_gbps,
            **({"reroutes": self.reroutes} if self.reroutes else {}),
            **({"delay_legs": dict(self.delay_legs)} if self.delay_legs else {}),
            **({"net_legs": dict(self.net_legs)} if self.net_legs else {}),
        }


# --------------------------------------------------------------------- #
# bounded-memory spill store (the streaming analyzer)

_REC_FIELDS = tuple(f.name for f in dataclass_fields(JobRecord))


class JobSpill:
    """Disk spill for finished :class:`JobRecord` rows — the bounded-
    memory analyzer's job store.

    Finished records leave RAM as soon as their job leaves the active
    set; a sqlite temp file keeps them keyed by arrival ``order`` (so
    every aggregate still sums in arrival order — the bit-exact closure
    arithmetic) alongside the finished-job metric columns the exact-
    quantile second pass sorts server-side.  Rows round-trip through
    JSON, which reproduces every float bit-for-bit, and ``delay_legs``
    key order (the engine's accrual order — it IS the emitted-dict
    order) survives because JSON objects preserve insertion order."""

    def __init__(self) -> None:
        # spill-flush telemetry: batched INSERT count — the
        # analyzer-side analogue of the engine caches' hit counters
        self.flushes = 0
        self._dir = tempfile.TemporaryDirectory(prefix="gstpu-analyze-")
        self._db = sqlite3.connect(os.path.join(self._dir.name, "jobs.sqlite"))
        self._db.execute("PRAGMA journal_mode=OFF")
        self._db.execute("PRAGMA synchronous=OFF")
        self._db.execute(
            "CREATE TABLE jobs ("
            "ord INTEGER PRIMARY KEY, fin INTEGER, wait REAL, run_time REAL,"
            "jct REAL, slowdown REAL, preempts REAL, faults REAL, data TEXT)"
        )
        self._buf: List[tuple] = []
        self.count = 0

    def add(self, rec: JobRecord) -> None:
        state = {name: getattr(rec, name) for name in _REC_FIELDS}
        fin = rec.finished
        self._buf.append((
            rec.order, 1 if fin else 0,
            rec.wait() if fin else None,
            rec.run_time if fin else None,
            rec.jct() if fin else None,
            rec.slowdown() if fin else None,
            float(rec.preempts) if fin else None,
            float(rec.faults) if fin else None,
            json.dumps(state),
        ))
        self.count += 1
        if len(self._buf) >= 512:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self.flushes += 1
            self._db.executemany(
                "INSERT INTO jobs VALUES (?,?,?,?,?,?,?,?,?)", self._buf
            )
            self._buf.clear()

    @staticmethod
    def _load(data: str) -> JobRecord:
        state = json.loads(data)
        state["delay_legs"] = dict(state.get("delay_legs") or {})
        return JobRecord(**state)

    def iter_records(self) -> Iterator[JobRecord]:
        self.flush()
        cur = self._db.execute("SELECT data FROM jobs ORDER BY ord")
        for (data,) in cur:
            yield self._load(data)

    def get(self, order: int) -> JobRecord:
        self.flush()
        row = self._db.execute(
            "SELECT data FROM jobs WHERE ord = ?", (order,)
        ).fetchone()
        if row is None:
            raise IndexError(order)
        return self._load(row[0])

    def sorted_metric(self, column: str) -> Tuple[int, Iterator[float]]:
        """(count, ascending iterator) over one finished-job metric —
        sqlite's external sort keeps the analyzer's resident memory flat
        however long the stream was."""
        self.flush()
        (n,) = self._db.execute(
            f"SELECT COUNT(*) FROM jobs WHERE fin = 1 AND {column} IS NOT NULL"
        ).fetchone()
        cur = self._db.execute(
            f"SELECT {column} FROM jobs "
            f"WHERE fin = 1 AND {column} IS NOT NULL ORDER BY {column}"
        )
        return n, (v for (v,) in cur)


class SpilledJobs(Sequence):
    """Arrival-order view over a :class:`JobSpill` with the list surface
    :class:`RunAnalysis` consumers use (iteration, ``len``, indexing).
    Each pass re-reads the store, so any number of aggregate scans run at
    constant resident memory."""

    def __init__(self, spill: JobSpill):
        self._spill = spill

    def __len__(self) -> int:
        return self._spill.count

    def __iter__(self) -> Iterator[JobRecord]:
        return self._spill.iter_records()

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(len(self)))]
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        return self._spill.get(index)


@dataclass
class _Active:
    """Per-job in-flight reconstruction state (the O(active jobs) part)."""

    rec: JobRecord
    state: str = QUEUED
    t_state: float = 0.0       # when the current state was entered
    cause: Optional[str] = None  # blame of the open queued interval
    chips_alloc: int = 0
    speed: float = 0.0
    locality: float = 1.0
    # the net-degraded split's inputs: the STATIC locality of
    # the current placement (what the last start/migrate/resize/rebind
    # carried — `net` re-prices move `locality` but never this), and
    # whether that placement is a GPU gang (track prefix), which names
    # the static toll's cause
    static_loc: float = 1.0
    gpu: bool = False
    slow: float = 1.0          # straggler multiplier (faults/)
    overhead_left: float = 0.0
    t_prog: float = 0.0        # time of the last adopted snapshot
    bw_gbps: float = 0.0       # current net/ bandwidth allocation
    t_bw: float = 0.0          # time the current allocation was set
    # priced checkpoint writes: per-job write cost and period
    # from the arrival record, so the drift guard can mirror the engine's
    # work/overhead split
    ckpt_w: float = 0.0
    ckpt_every: float = math.inf


def _stat_block(values: Sequence[float]) -> dict:
    """Exact distribution summary for one metric: n/mean/max + p50/p95/p99.
    One sort serves every quantile (Philly-scale lists are large)."""
    if not values:
        return {"n": 0, "mean": None, "max": None,
                **{name: None for name, _ in _QUANTS}}
    s = sorted(float(v) for v in values)
    return {
        "n": len(s),
        "mean": sum(s) / len(s),
        "max": s[-1],
        **{name: quantile_sorted(s, q) for name, q in _QUANTS},
    }


def _stat_block_sorted(n: int, ascending: Iterable[float]) -> dict:
    """:func:`_stat_block` from a pre-sorted value stream of known length
    (the spill store's server-side ORDER BY): one pass captures the sum
    (same ascending addition order as the in-memory sort), the max (last
    value), and the straddling order statistics each quantile needs —
    then interpolates with :func:`quantile_sorted`'s exact formula, so
    the result dict is bit-identical to the in-memory one."""
    if n == 0:
        return {"n": 0, "mean": None, "max": None,
                **{name: None for name, _ in _QUANTS}}
    wanted: Dict[int, float] = {}
    for _, q in _QUANTS:
        h = (n - 1) * q
        i = int(math.floor(h))
        wanted[i] = 0.0
        if i + 1 < n:
            wanted[i + 1] = 0.0
    total = 0.0
    last = 0.0
    for idx, v in enumerate(ascending):
        v = float(v)
        total += v
        if idx in wanted:
            wanted[idx] = v
        last = v
    out = {"n": n, "mean": total / n, "max": last}
    for name, q in _QUANTS:
        h = (n - 1) * q
        i = int(math.floor(h))
        g = h - i
        if g == 0.0 or i + 1 >= n:
            out[name] = float(wanted[i])
        else:
            a, b = float(wanted[i]), float(wanted[i + 1])
            # numpy _lerp anchor switch — quantile_sorted's own formula
            out[name] = b - (b - a) * (1.0 - g) if g >= 0.5 else a + (b - a) * g
    return out


@dataclass
class RunAnalysis:
    """Everything :func:`analyze_events` derives from one stream."""

    header: Optional[RunHeader]
    jobs: List[JobRecord]                       # arrival order
    num_events: int = 0
    end_t: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)
    util_series: List[Tuple[float, int, int, int]] = field(default_factory=list)
    fault_kinds: Dict[str, dict] = field(default_factory=dict)
    fault_timeline: List[dict] = field(default_factory=list)
    mean_occupancy: Optional[float] = None      # time-weighted used/total
    mean_fragmentation: Optional[float] = None  # time-weighted free/total while demand waits
    mean_pending: float = 0.0                   # time-weighted queue length
    max_progress_drift: float = 0.0             # analyzer-vs-engine integration check
    # shared-fabric telemetry (net/): per-link load series reconstructed
    # from "netlink" events — (t, used_gbps, capacity_gbps) change points —
    # and the exact time-weighted mean utilization per link
    net_links: Dict[str, List[Tuple[float, float, float]]] = field(
        default_factory=dict)
    net_link_means: Dict[str, float] = field(default_factory=dict)
    # cluster-side sampling: periodic ``sample`` events as
    # (t, physical_used, unhealthy, pending) change points, plus the exact
    # time-weighted mean *physical* occupancy — the series the report
    # overlays on the demand series (divergence = overlay packing)
    sample_series: List[Tuple[float, int, int, int]] = field(
        default_factory=list)
    # proactive checkpoint-and-migrate: aggregate of the
    # ``proactive`` payloads riding migrate events — moves taken, the
    # work a revocation at each move instant would have rolled back
    # (avoided loss), and the write+restore overhead actually paid.
    # Empty when the run never migrated proactively.
    proactive: Dict[str, float] = field(default_factory=dict)
    mean_phys_occupancy: Optional[float] = None
    # engine cache telemetry: the trailing ``cache`` record a
    # cache-telemetry-armed run emits — {cache: {outcome: count}}; empty
    # for runs captured without the flag.  The report's Engine-health
    # panel renders the hit-rate table from it.
    cache_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # bounded-memory mode: the spill store behind ``jobs`` when
    # the stream was analyzed with one — distributions() then sorts each
    # metric server-side instead of materializing value lists
    _spill: Optional[JobSpill] = field(
        default=None, repr=False, compare=False)
    # memoized derived views (report/compare each read them several times;
    # at Philly scale recomputing means redundant full scans and sorts)
    _goodput_cache: Optional[Dict[str, float]] = field(
        default=None, repr=False, compare=False)
    _dist_cache: Optional[Dict[str, dict]] = field(
        default=None, repr=False, compare=False)
    _delay_cache: Optional[Dict[str, float]] = field(
        default=None, repr=False, compare=False)
    _attrib_cache: Optional[dict] = field(
        default=None, repr=False, compare=False)

    # ------------------------------------------------------------------ #
    def goodput(self) -> Dict[str, float]:
        """The fault-attribution closure: per-job service legs (engine
        snapshots, exact floats) summed in arrival order with the same
        arithmetic ``SimResult`` uses — equal to ``SimResult.goodput`` to
        the last float (the golden tests pin this for all eight policies)."""
        if self._goodput_cache is not None:
            return dict(self._goodput_cache)
        attained = sum(r.service for r in self.jobs)
        lost = sum(r.lost_service for r in self.jobs)
        overhead = sum(r.overhead_service for r in self.jobs)
        self._goodput_cache = {
            "useful_chip_s": attained - lost,
            "lost_chip_s": lost,
            "restart_overhead_chip_s": overhead,
            "total_chip_s": attained + overhead,
        }
        return dict(self._goodput_cache)

    def distributions(self) -> Dict[str, dict]:
        """Wait/run/JCT/slowdown/preempt-count distributions over finished
        jobs, with exact p50/p95/p99 (numpy-equivalent linear quantiles).
        In bounded-memory mode each metric streams from the spill store's
        server-side sort — identical floats (same ascending multiset, same
        ordered sum, same interpolation), no value lists in RAM."""
        if self._dist_cache is not None:
            return self._dist_cache
        if self._spill is not None:
            self._dist_cache = {
                name: _stat_block_sorted(*self._spill.sorted_metric(col))
                for name, col in (
                    ("wait", "wait"), ("run", "run_time"), ("jct", "jct"),
                    ("slowdown", "slowdown"), ("preempt_count", "preempts"),
                    ("fault_count", "faults"),
                )
            }
            return self._dist_cache
        fin = [r for r in self.jobs if r.finished]
        waits = [w for w in (r.wait() for r in fin) if w is not None]
        slow = [s for s in (r.slowdown() for r in fin) if s is not None]
        self._dist_cache = {
            "wait": _stat_block(waits),
            "run": _stat_block([r.run_time for r in fin]),
            "jct": _stat_block([j for j in (r.jct() for r in fin) if j is not None]),
            "slowdown": _stat_block(slow),
            "preempt_count": _stat_block([float(r.preempts) for r in fin]),
            "fault_count": _stat_block([float(r.faults) for r in fin]),
        }
        return self._dist_cache

    def delay_by_cause(self) -> Dict[str, float]:
        """The wait/slowdown-decomposition closure: per-leg
        seconds summed over jobs in arrival order with sorted keys per
        job — the engine's exact floats (adopted from event ``blame``
        snapshots) added with the same arithmetic ``SimResult`` uses, so
        this equals ``SimResult.delay_by_cause`` to the last float for
        all eight policies, with and without faults/net (the golden
        attribution tests pin it).  Empty for attribution-free runs."""
        if self._delay_cache is not None:
            return dict(self._delay_cache)
        out: Dict[str, float] = {}
        for r in self.jobs:
            for k in sorted(r.delay_legs):
                out[k] = out.get(k, 0.0) + r.delay_legs[k]
        self._delay_cache = out
        return dict(out)

    def attribution(self) -> dict:
        """The cluster lost-time-by-cause table: where the cluster's time
        went, cause by cause.

        - ``wait_s`` / ``run_s``: the per-leg aggregate in seconds
          (``delay_by_cause`` split into blame causes vs running legs);
        - ``chip_demand_wait_s``: blame legs weighted by each job's
          requested gang (chip-demand-seconds stuck in queue per cause);
        - ``lost_chip_s`` / ``restart_overhead_chip_s``: the fault and
          overhead legs in chip-seconds, taken verbatim from
          :meth:`goodput` — which is exactly ``SimResult.goodput``, so
          the table *closes against SimResult's own arithmetic*;
        - residuals: ``max_wait_residual`` / ``max_jct_residual``, the
          worst per-job gap between the decomposition totals and the
          independently reconstructed wait/JCT (float dust on healthy
          streams).

        Memoized like goodput/distributions: report + to_json each read
        it, and every computation rescans the full job list."""
        if self._attrib_cache is not None:
            return dict(self._attrib_cache)
        legs = self.delay_by_cause()
        gp = self.goodput()
        chip_wait: Dict[str, float] = {}
        for r in self.jobs:
            for k in sorted(r.delay_legs):
                if k in WAIT_CAUSES:
                    chip_wait[k] = chip_wait.get(k, 0.0) + r.chips * r.delay_legs[k]
        wait_res = [abs(v) for v in (r.wait_residual() for r in self.jobs)
                    if v is not None]
        jct_res = [abs(v) for v in (r.jct_residual() for r in self.jobs)
                   if v is not None]
        self._attrib_cache = {
            "wait_s": {k: v for k, v in sorted(legs.items())
                       if k in WAIT_CAUSES},
            "run_s": {k: v for k, v in sorted(legs.items())
                      if k not in WAIT_CAUSES},
            "chip_demand_wait_s": dict(sorted(chip_wait.items())),
            "lost_chip_s": gp["lost_chip_s"],
            "restart_overhead_chip_s": gp["restart_overhead_chip_s"],
            "max_wait_residual": max(wait_res, default=0.0),
            "max_jct_residual": max(jct_res, default=0.0),
        }
        return dict(self._attrib_cache)

    def fault_attribution(self) -> dict:
        """Per-fault-kind attribution plus the exact goodput closure.

        ``kinds[kind].lost_chip_s`` sums per-revocation snapshot deltas, so
        the per-kind split telescopes to the per-job totals only up to
        float re-association; ``closure_residual`` reports that gap (zero
        or ~1e-9-relative), while ``goodput`` itself is exact."""
        gp = self.goodput()
        kinds_lost = sum(k["lost_chip_s"] for k in self.fault_kinds.values())
        return {
            "kinds": {k: dict(v) for k, v in sorted(self.fault_kinds.items())},
            "goodput": gp,
            "kinds_lost_chip_s": kinds_lost,
            "closure_residual": kinds_lost - gp["lost_chip_s"],
            "domains": self.domain_outages(),
        }

    def domain_outages(self) -> Dict[str, dict]:
        """The per-domain outage table (correlated ``kind="domain"``
        faults): scope label -> hierarchy level, outage count,
        and total down seconds.  Permanent outages (duration ``"inf"``)
        and outages still open at the stream's end are capped at the
        observed horizon, so ``down_s`` is the downtime the replay
        actually saw."""
        out: Dict[str, dict] = {}
        for f in self.fault_timeline:
            if f.get("kind") != "domain":
                continue
            scope = str(f.get("scope"))
            row = out.setdefault(scope, {
                "level": f.get("level"), "outages": 0, "down_s": 0.0,
            })
            row["outages"] += 1
            d = f.get("duration")
            horizon = max(0.0, self.end_t - float(f.get("t", 0.0)))
            if d is None or d == "inf":
                dur = horizon
            else:
                dur = min(float(d), horizon)
            row["down_s"] += dur
        return dict(sorted(out.items()))

    def net_degraded_split(self) -> Dict[str, float]:
        """The folded ``net-degraded`` leg split three ways:
        per-segment seconds summed over jobs
        in arrival order with sorted keys — ``dcn-contention`` (the gap
        between the placement's static factor and the ``net``-repriced
        dynamic one), ``multislice-toll`` (the static DCN term a
        multislice gang pays even on an idle fabric), ``gpu-locality``
        (scattered-gang placement tiers).  Derived by the analyzer from
        the stream's locality ladder — no new event fields, so historical
        streams split retroactively.  On attribution-armed runs the three
        segments sum to ``delay_by_cause()['net-degraded']`` up to float
        re-association.  Empty when no job ever ran below locality 1.0."""
        out: Dict[str, float] = {}
        for r in self.jobs:
            for k in sorted(r.net_legs):
                out[k] = out.get(k, 0.0) + r.net_legs[k]
        return out

    def network(self) -> dict:
        """The network panel's data: per-link utilization series/means and
        the per-job bandwidth-share table (jobs the contention model
        priced at least once).  Empty links + jobs means the run had no
        net model (or no multislice job ever ran)."""
        jobs = []
        for r in self.jobs:
            if not r.net_updates:
                continue
            mean_bw = r.mean_bw_gbps()
            jobs.append({
                "job_id": r.job_id,
                "chips": r.chips,
                "net_updates": r.net_updates,
                "mean_bw_gbps": mean_bw,
                "demand_gbps": r.demand_gbps,
                "mean_share": (
                    mean_bw / r.demand_gbps
                    if mean_bw is not None and r.demand_gbps else None
                ),
            })
        return {
            "links": {
                name: {
                    "mean_util": self.net_link_means.get(name),
                    "samples": len(series),
                    "last_capacity_gbps": series[-1][2] if series else None,
                }
                for name, series in sorted(self.net_links.items())
            },
            "jobs": jobs,
            "net_degraded_split": self.net_degraded_split(),
        }

    def summary(self) -> Dict[str, object]:
        """Headline scalars (the compare surface).  avg_jct and makespan
        use SimResult's exact formulas so the two cross-check bit-for-bit."""
        fin = [r for r in self.jobs if r.finished]
        jcts = [j for j in (r.jct() for r in fin) if j is not None]
        makespan = (
            max(r.end_t for r in fin) - min(r.submit_t for r in fin)
            if fin else 0.0
        )
        states = {s: 0 for s in TERMINAL_STATES}
        for r in self.jobs:
            if r.end_state is not None:
                states[r.end_state] = states.get(r.end_state, 0) + 1
        gp = self.goodput()
        useful_frac = (
            gp["useful_chip_s"] / gp["total_chip_s"]
            if gp["total_chip_s"] > 0 else None
        )
        return {
            "num_jobs": len(self.jobs),
            "num_finished": len(fin),
            "num_unfinished": sum(
                1 for r in self.jobs if r.end_state is None
            ),
            "num_rejected": states["rejected"],
            "num_done": states["done"],
            "num_failed": states["failed"],
            "num_killed": states["killed"],
            "avg_jct": sum(jcts) / len(jcts) if jcts else 0.0,
            "makespan": makespan,
            "mean_occupancy": self.mean_occupancy,
            "mean_fragmentation": self.mean_fragmentation,
            "mean_pending": self.mean_pending,
            "preemptions": self.counts.get("preempt", 0),
            "migrations": self.counts.get("migrate", 0),
            "faults": self.counts.get("fault", 0),
            "revocations": self.counts.get("revoke", 0),
            "repairs": self.counts.get("repair", 0),
            "net_reprices": self.counts.get("net", 0),
            "useful_frac": useful_frac,
            **{f"goodput_{k}": v for k, v in gp.items()},
            # attribution-armed runs only: the same delay_<cause>_s keys
            # SimResult.summary() emits (closure surface), plus physical
            # occupancy when the run was sampled
            **{
                f"delay_{k.replace('-', '_')}_s": v
                for k, v in sorted(self.delay_by_cause().items())
            },
            **(
                {"mean_phys_occupancy": self.mean_phys_occupancy}
                if self.mean_phys_occupancy is not None else {}
            ),
        }

    def _json_head(self) -> dict:
        """Everything :meth:`to_json` carries except the ``jobs`` array —
        the part :meth:`write_json` serializes up front (every value here
        is already aggregate-sized, never per-job)."""
        return {
            "header": self.header.to_json() if self.header else None,
            "num_events": self.num_events,
            "end_t": self.end_t,
            "summary": self.summary(),
            "distributions": self.distributions(),
            "faults": self.fault_attribution(),
            "fault_timeline": list(self.fault_timeline),
            "network": self.network(),
            "attribution": (
                self.attribution() if self.delay_by_cause() else None
            ),
            "samples": {
                "n": len(self.sample_series),
                "mean_phys_occupancy": self.mean_phys_occupancy,
            },
            "cache_stats": self.cache_stats or None,
            "max_progress_drift": self.max_progress_drift,
        }

    def to_json(self) -> dict:
        return {
            **self._json_head(),
            "jobs": [r.to_json() for r in self.jobs],
        }

    # ------------------------------------------------------------------ #

    def write_json(self, path) -> Path:
        """Write :meth:`to_json` to ``path`` byte-for-byte as
        ``json.dumps(self.to_json(), indent=2, sort_keys=True)`` would —
        but with the ``jobs`` array **streamed one record at a time**, so
        a bounded-memory analysis (the spill store) dumps a
        million-job document without ever materializing the job list or
        the document string.  Pinned byte-identical by tests/test_torch_obs.py.

        Mechanics: the document head is serialized with the ``jobs``
        value replaced by a sentinel string, split at the sentinel, and
        each job record is serialized independently and re-indented to
        the depth the enclosing dump would have used — ``json.dumps``
        with a fixed ``indent`` is position-independent, so the splice
        reproduces the monolithic serialization exactly."""
        sentinel = "__GSTPU_JOBS_STREAM__"
        head = dict(self._json_head(), jobs=sentinel)
        text = json.dumps(head, indent=2, sort_keys=True)
        prefix, suffix = text.split(json.dumps(sentinel), 1)
        out = Path(path)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            f.write(prefix)
            wrote = False
            for r in self.jobs:
                chunk = json.dumps(r.to_json(), indent=2, sort_keys=True)
                f.write("[\n" if not wrote else ",\n")
                f.write("\n".join("    " + ln for ln in chunk.splitlines()))
                wrote = True
            f.write("\n  ]" if wrote else "[]")
            f.write(suffix)
        return out


# --------------------------------------------------------------------- #

# event kind -> states it is legal to arrive from (None key: job may not
# exist yet).  Kinds touching a job not in this table are stream errors.
_LEGAL_FROM = {
    "start": (QUEUED, SUSPENDED),
    "preempt": (RUNNING,),
    "speed": (RUNNING,),
    "migrate": (RUNNING,),
    "resize": (RUNNING,),
    "rebind": (RUNNING,),
    "revoke": (RUNNING,),
    "finish": (RUNNING,),
    # cutoff also reaches queued/suspended jobs: attribution-armed runs
    # emit a horizon record for every waiting job so the stream provably
    # extends to max_time (the wait closure depends on it)
    "cutoff": (RUNNING, QUEUED, SUSPENDED),
    "net": (RUNNING,),
    # adaptive routing: the flow's weighted uplink set moved
    # onto different siblings (rate/factor changes ride "net" events)
    "reroute": (RUNNING,),
    # straggler re-price (faults/): the gang's rate changed
    # because a chip under it degraded or recovered
    "slow": (RUNNING,),
    # spot pre-revoke notice: may charge emergency-checkpoint overhead
    "warn": (RUNNING,),
}


def analyze_events(
    events: Iterable[dict],
    *,
    require_header: bool = True,
    strict: bool = True,
    drift_tol: float = 1e-5,
    max_util_samples: int = 200_000,
    spill: Optional[JobSpill] = None,
) -> RunAnalysis:
    """Single-pass lifecycle reconstruction of one event stream.

    ``require_header=False`` admits bare pre-header streams (Python-API
    captures without ``run_meta``) — ``compare`` never does, ``report``
    only with an explicit flag.  ``strict`` turns impossible transitions,
    time going backwards, and analyzer-vs-engine progress drift beyond
    ``drift_tol`` (relative) into :class:`StreamError`; non-strict mode
    tallies them in ``counts["anomalies"]`` instead.

    ``spill`` (bounded-memory mode, usually via ``analyze_file
    (low_memory=True)``): finished job records leave RAM for the given
    :class:`JobSpill` as their jobs finish, and the returned analysis's
    ``jobs`` is a lazy arrival-order view over the store — every derived
    number (aggregates, exact quantiles, report tables) is the in-memory
    analysis's, at O(active jobs) resident memory, but for the last digits
    of a mean (the spilled path sums sorted values in a loop, the
    in-memory one with ``sum``; ROADMAP.md Queue 3).
    """
    header: Optional[RunHeader] = None
    jobs: List[JobRecord] = []
    n_jobs = 0
    active: Dict[str, _Active] = {}
    counts: Dict[str, int] = {}
    fault_kinds: Dict[str, dict] = {}
    fault_timeline: List[dict] = []
    util_series: List[Tuple[float, int, int, int]] = []
    stride, sample_i = 1, 0
    # net/ link telemetry: change-point series per link plus an exact
    # piecewise-constant utilization integral ([last_t, last_util, area])
    net_links: Dict[str, List[Tuple[float, float, float]]] = {}
    net_acc: Dict[str, List[float]] = {}
    # cluster samples: physical-occupancy series + its exact
    # piecewise-constant integral ([last_t, last_used, area, first_t])
    sample_series: List[Tuple[float, int, int, int]] = []
    samp_acc: Optional[List[float]] = None
    # proactive checkpoint-and-migrate aggregate
    proactive: Dict[str, float] = {}
    # trailing engine cache-telemetry record
    cache_stats: Dict[str, dict] = {}

    used = running_n = pending_n = 0
    last_t: Optional[float] = None
    last_used = last_pending = 0
    occ_area = frag_area = pend_area = horizon = 0.0
    max_drift = 0.0
    n_events = 0
    end_t = 0.0

    def bad(msg: str) -> None:
        if strict:
            raise StreamError(msg)
        counts["anomalies"] = counts.get("anomalies", 0) + 1

    def kind_row(kind: str) -> dict:
        row = fault_kinds.get(kind)
        if row is None:
            row = fault_kinds[kind] = {
                "faults": 0, "revocations": 0, "lost_work_s": 0.0,
                "lost_chip_s": 0.0, "restore_charged_s": 0.0,
                "warned_revocations": 0, "lost_work_warned_s": 0.0,
            }
        return row

    def adopt_snapshot(a: _Active, ev: dict, t: float, rollback: float = 0.0) -> None:
        """Take the engine's exact cumulative legs; first cross-check them
        against this analyzer's own integration of the interval since the
        previous snapshot (payload-sufficiency guard: if the stream lacked
        a transition, the drift shows it).  ``rollback`` is the work a
        revoke rolled back before its snapshot was taken."""
        nonlocal max_drift
        prog = ev.get("prog")
        if prog is None:
            return
        r = a.rec
        if a.state == RUNNING:
            dt = t - a.t_prog
            burn = min(a.overhead_left, dt)
            e = a.speed * a.locality * a.slow
            run = dt - burn
            if a.ckpt_w > 0.0 and e > 0.0 and 0.0 < a.ckpt_every < math.inf:
                # priced checkpoint writes: mirror the engine's steady-
                # state write-share split (sim/job.py advance)
                run -= run * (e * a.ckpt_w) / (a.ckpt_every + e * a.ckpt_w)
            expect = r.work + e * run - rollback
            drift = abs(expect - prog["work"]) / (1.0 + abs(expect))
            if drift > max_drift:
                max_drift = drift
            if drift > drift_tol:
                bad(
                    f"progress drift {drift:.3e} for {r.job_id} at t={t} "
                    f"(expected work {expect}, snapshot {prog['work']}): "
                    "the stream is missing a transition"
                )
            if run > 0.0:
                # net-degraded three-way split: the same
                # productive span the engine's RUN_LEGS arithmetic
                # charges, split along the locality ladder — the static
                # toll (placement-carried factor) vs the contention gap
                # (static minus the `net`-repriced dynamic factor)
                if a.static_loc != 1.0:
                    nl = r.net_legs
                    key = "gpu-locality" if a.gpu else "multislice-toll"
                    nl[key] = (
                        nl.get(key, 0.0)
                        + a.speed * (1.0 - a.static_loc) * run
                    )
                if a.locality != a.static_loc:
                    nl = r.net_legs
                    nl["dcn-contention"] = (
                        nl.get("dcn-contention", 0.0)
                        + a.speed * (a.static_loc - a.locality) * run
                    )
        r.work = prog["work"]
        r.service = prog["service"]
        r.lost_service = prog["lost_service"]
        r.overhead_service = prog["overhead_service"]
        r.lost_work = prog["lost_work"]
        a.overhead_left = prog.get("overhead_left", 0.0)
        a.t_prog = t

    def leave_state(a: _Active, t: float) -> None:
        """Charge the time spent in the state being left to its bucket."""
        dt = t - a.t_state
        if a.state == RUNNING:
            a.rec.run_time += dt
        elif a.state == QUEUED:
            a.rec.queue_time += dt
        else:
            a.rec.suspended_time += dt

    def settle_bw(a: _Active, t: float) -> None:
        """Integrate the job's current bandwidth allocation up to ``t``
        (piecewise-constant between net events, exact)."""
        if a.bw_gbps > 0.0 and t > a.t_bw:
            a.rec.bw_gbps_s += a.bw_gbps * (t - a.t_bw)
        a.t_bw = t

    def adopt_blame(a: _Active, ev: dict) -> None:
        """Take the engine's exact cumulative attribution legs —
        the ``blame`` analogue of the ``prog`` adoption above: snapshots
        replace the analyzer's view wholesale, so every adopted float is
        the engine's own."""
        blame = ev.get("blame")
        if blame is not None:
            a.rec.delay_legs = dict(blame)

    def sample(t: float) -> None:
        """Integrate occupancy/fragmentation/pending exactly (piecewise-
        constant), store a decimation-capped series for the report."""
        nonlocal last_t, last_used, last_pending, occ_area, frag_area
        nonlocal pend_area, horizon, stride, sample_i
        total = header.total_chips if header else None
        if last_t is not None and t > last_t:
            dt = t - last_t
            horizon += dt
            pend_area += last_pending * dt
            if total:
                occ_area += (last_used / total) * dt
                if last_pending > 0:
                    frag_area += (max(0, total - last_used) / total) * dt
        last_t, last_used, last_pending = t, used, pending_n
        if sample_i % stride == 0:
            util_series.append((t, used, running_n, pending_n))
            if len(util_series) > max_util_samples:
                del util_series[::2]
                stride *= 2
        sample_i += 1

    for rec_i, ev in enumerate(events):
        if "schema" in ev:
            if rec_i == 0:
                header = RunHeader.from_record(ev)
                continue
            raise StreamError(
                "second header record mid-stream: this file concatenates "
                "two runs — analyze them separately"
            )
        if rec_i == 0 and require_header:
            raise SchemaError(
                "event stream has no schema header; re-capture with "
                "run identity (CLI --events does) or pass "
                "require_header=False for bare streams"
            )
        kind = ev.get("event")
        if kind is None:
            bad(f"record {rec_i} has no 'event' field")
            continue
        t = float(ev.get("t", 0.0))
        if t < end_t:
            bad(f"time went backwards at record {rec_i}: {end_t} -> {t}")
        end_t = max(end_t, t)
        n_events += 1
        counts[kind] = counts.get(kind, 0) + 1

        if kind == "arrival":
            if ev.get("job") is None or ev.get("job") in active:
                bad(f"bad/duplicate arrival for {ev.get('job')!r}")
                continue
            rec = JobRecord(
                job_id=ev["job"], order=n_jobs, submit_t=t,
                chips=int(ev.get("chips", 0)),
                duration=ev.get("duration"), status=ev.get("status"),
            )
            n_jobs += 1
            if spill is None:
                jobs.append(rec)
            active[rec.job_id] = _Active(
                rec=rec, state=QUEUED, t_state=t, t_prog=t,
                cause=ev.get("cause"),
                ckpt_w=float(ev.get("ckpt_write_s", 0.0)),
                ckpt_every=float(ev.get("ckpt_every", math.inf)),
            )
            pending_n += 1
            sample(t)
            continue
        if kind == "reject":
            if ev.get("job") is None:
                bad("reject without a job id")
                continue
            rec = JobRecord(
                job_id=ev["job"], order=n_jobs, submit_t=t,
                chips=int(ev.get("chips", 0)), end_t=t, end_state="rejected",
            )
            n_jobs += 1
            if spill is None:
                jobs.append(rec)
            else:
                # a reject never re-enters the stream: spill it now
                spill.add(rec)
            continue
        if kind == "fault":
            row = kind_row(str(ev.get("fault", "?")))
            row["faults"] += 1
            entry = {
                "t": t, "scope": ev.get("scope"), "kind": ev.get("fault"),
                "duration": ev.get("duration"), "fid": ev.get("fid"),
            }
            # domain hierarchy tier / degrade fraction ride along only
            # when the record carries them (domain / straggler / link
            # kinds), keeping historical timelines byte-identical
            if "level" in ev:
                entry["level"] = ev["level"]
            if "degrade" in ev:
                entry["degrade"] = ev["degrade"]
            fault_timeline.append(entry)
            continue
        if kind == "repair":
            continue
        if kind == "alert":
            # watchtower detection record (obs/watch.py):
            # alerts live in their own side stream, but a combined or
            # hand-concatenated file must analyze cleanly — counted,
            # never a lifecycle transition
            continue
        if kind == "cache":
            # trailing cache-telemetry table: the engine's
            # unified {cache: {outcome: count}} harvest — a later record
            # (one per run in practice) replaces an earlier one wholesale
            caches = ev.get("caches")
            if isinstance(caches, dict):
                cache_stats = caches
            continue
        if kind == "netlink":
            name = str(ev.get("link", "?"))
            util = float(ev.get("util", 0.0))
            acc = net_acc.get(name)
            if acc is None:
                net_acc[name] = [t, util, 0.0, t]  # last_t, last_util, area, first_t
            else:
                acc[2] += acc[1] * (t - acc[0])
                acc[0], acc[1] = t, util
            series = net_links.setdefault(name, [])
            series.append((
                t, float(ev.get("used_gbps", 0.0)),
                float(ev.get("capacity_gbps", 0.0)),
            ))
            if len(series) > max_util_samples:
                # decimate but always keep the newest sample — the report
                # reads the link's current capacity off series[-1]
                last = series[-1]
                del series[::2]
                if series[-1] != last:
                    series.append(last)
            continue
        if kind == "sample":
            # periodic cluster-side snapshot: PHYSICAL occupancy
            # — overlay guests consume no extra chips here, unlike the
            # demand series integrated from start events above; the gap
            # between the two series is the packing signal
            used_p = int(ev.get("used", 0))
            if samp_acc is None:
                # integral seeded at t=0 with occupancy 0: the cluster is
                # known-empty at run start (the engine skips the t=0
                # sample for exactly that reason), so the physical mean
                # covers the same span as the demand mean instead of
                # starting at the first sample tick
                samp_acc = [0.0, 0.0, 0.0, 0.0]
            samp_acc[2] += samp_acc[1] * (t - samp_acc[0])
            samp_acc[0], samp_acc[1] = t, float(used_p)
            sample_series.append((
                t, used_p, int(ev.get("unhealthy", 0)),
                int(ev.get("pending", 0)),
            ))
            if len(sample_series) > max_util_samples:
                last_s = sample_series[-1]
                del sample_series[::2]
                if sample_series[-1] != last_s:
                    sample_series.append(last_s)
            continue

        # ---- per-job transitions ------------------------------------- #
        a = active.get(ev.get("job"))
        if a is None:
            bad(f"{kind} for unknown/finished job {ev.get('job')!r}")
            continue
        legal = _LEGAL_FROM.get(kind)
        if legal is None:
            bad(f"unknown event kind {kind!r}")
            continue
        if a.state not in legal:
            bad(
                f"illegal transition: {kind} while {a.rec.job_id} is "
                f"{a.state} at t={t}"
            )
            continue

        if kind == "start":
            leave_state(a, t)
            adopt_snapshot(a, ev, t)
            adopt_blame(a, ev)
            a.cause = None  # the engine closed the wait interval at start
            a.rec.starts += 1
            if a.rec.first_start_t is None:
                a.rec.first_start_t = t
            a.state, a.t_state = RUNNING, t
            a.chips_alloc = int(ev.get("chips", a.rec.chips))
            a.speed = float(ev.get("speed", 1.0))
            a.locality = float(ev.get("locality", 1.0))
            # the start event carries the STATIC placement factor (the
            # engine binds it before any net re-price): the net-degraded
            # split's toll baseline; the track prefix names its cause
            a.static_loc = a.locality
            a.gpu = str(ev.get("track", "")).startswith("gpu/")
            # placement-changing events carry slow_factor only when a
            # straggler chip paces the gang; absence means full rate
            a.slow = float(ev.get("slow_factor", 1.0))
            used += a.chips_alloc
            running_n += 1
            # queued AND suspended jobs both sit in the engine's pending
            # set (demand waiting for chips), so any start drains one
            pending_n -= 1
            sample(t)
        elif kind == "preempt":
            leave_state(a, t)
            adopt_snapshot(a, ev, t)
            adopt_blame(a, ev)
            a.cause = ev.get("cause")
            settle_bw(a, t)
            a.bw_gbps = 0.0
            a.rec.preempts += 1
            used -= a.chips_alloc
            running_n -= 1
            a.chips_alloc = 0
            a.speed = 0.0
            a.slow = 1.0
            # engine semantics: suspend=True keeps resume intent (Gandiva),
            # suspend=False demotes back to the pending queue — but both
            # land in the engine's pending set, so both count as demand
            a.state = SUSPENDED if ev.get("suspend", True) else QUEUED
            a.t_state = t
            pending_n += 1
            sample(t)
        elif kind == "speed":
            adopt_snapshot(a, ev, t)
            a.speed = float(ev.get("speed", a.speed))
        elif kind == "slow":
            # straggler re-price (faults/): progress up to t accrued at
            # the OLD slow factor (adopt first), the new factor onward
            adopt_snapshot(a, ev, t)
            a.slow = float(ev.get("slow_factor", a.slow))
        elif kind == "warn":
            # spot pre-revoke notice: a saved emergency checkpoint
            # charged write overhead (the snapshot's overhead_left
            # already includes it); an unsaved notice changes nothing
            adopt_snapshot(a, ev, t)
        elif kind == "net":
            # contention re-price (net/): progress up to t accrued at the
            # OLD locality (adopt first), the new factor applies onward
            adopt_snapshot(a, ev, t)
            settle_bw(a, t)
            a.locality = float(ev.get("locality", a.locality))
            a.bw_gbps = float(ev.get("bw_gbps", 0.0))
            a.rec.net_updates += 1
            if ev.get("demand_gbps") is not None:
                a.rec.demand_gbps = float(ev["demand_gbps"])
        elif kind == "reroute":
            # route choice moved: no rate or progress change by
            # itself — share/factor changes arrive as their own "net"
            # event in the same batch
            a.rec.reroutes += 1
        elif kind in ("migrate", "resize", "rebind"):
            adopt_snapshot(a, ev, t)
            # close the bandwidth integral at the placement boundary; the
            # engine emits a follow-up "net" event (possibly bw=0) when
            # the move changed the job's flow-set membership or share
            settle_bw(a, t)
            if kind == "migrate":
                a.rec.migrations += 1
                pro = ev.get("proactive")
                if pro:
                    # hazard-driven checkpoint-then-migrate:
                    # aggregate avoided-loss vs paid-overhead for the
                    # fault panel
                    proactive["migrations"] = (
                        proactive.get("migrations", 0) + 1
                    )
                    proactive["avoided_s"] = (
                        proactive.get("avoided_s", 0.0)
                        + float(pro.get("avoided_s", 0.0))
                    )
                    proactive["overhead_s"] = (
                        proactive.get("overhead_s", 0.0)
                        + float(pro.get("write_s", 0.0))
                        + float(pro.get("restore_s", 0.0))
                    )
            elif kind == "rebind":
                a.rec.rebinds += 1
            new_chips = int(ev.get("chips", a.chips_alloc))
            used += new_chips - a.chips_alloc
            a.chips_alloc = new_chips
            a.speed = float(ev.get("speed", a.speed))
            a.locality = float(ev.get("locality", a.locality))
            # placement moved: the carried locality is again the new
            # allocation's STATIC factor (the engine re-binds before
            # emitting; any net re-price follows as its own event)
            a.static_loc = a.locality
            if "track" in ev:
                a.gpu = str(ev.get("track", "")).startswith("gpu/")
            a.slow = float(ev.get("slow_factor", 1.0))
            sample(t)
        elif kind == "revoke":
            prev_lost = a.rec.lost_service
            leave_state(a, t)
            adopt_snapshot(a, ev, t, rollback=float(ev.get("lost_work", 0.0)))
            adopt_blame(a, ev)
            a.cause = ev.get("cause")
            settle_bw(a, t)
            a.bw_gbps = 0.0
            a.rec.faults += 1
            row = kind_row(str(ev.get("fault", "?")))
            row["revocations"] += 1
            row["lost_work_s"] += float(ev.get("lost_work", 0.0))
            row["lost_chip_s"] += a.rec.lost_service - prev_lost
            row["restore_charged_s"] += float(ev.get("restore", 0.0))
            if ev.get("warned"):
                # an emergency checkpoint (spot pre-revoke warning)
                # shrank this rollback: split the lost work so the
                # report can show warned vs unwarned losses
                row["warned_revocations"] += 1
                row["lost_work_warned_s"] += float(ev.get("lost_work", 0.0))
            used -= a.chips_alloc
            running_n -= 1
            a.chips_alloc = 0
            a.speed = 0.0
            a.slow = 1.0
            a.state, a.t_state = QUEUED, t
            pending_n += 1
            sample(t)
        elif kind == "finish":
            leave_state(a, t)
            adopt_snapshot(a, ev, t)
            adopt_blame(a, ev)
            settle_bw(a, t)
            a.rec.end_t = t
            a.rec.end_state = str(ev.get("end_state", "done"))
            used -= a.chips_alloc
            running_n -= 1
            del active[a.rec.job_id]
            if spill is not None:
                # the record is final: it leaves resident memory here —
                # the bounded-memory mode's whole point
                spill.add(a.rec)
            sample(t)
        elif kind == "cutoff":
            # horizon cutoff: final snapshot for a still-active job; the
            # job stays unfinished (end_state None) like its jobs.csv row.
            # For queued/suspended jobs the engine already closed the wait
            # interval into this record's blame snapshot — clear the open
            # cause so the end-of-stream close cannot double-charge it.
            leave_state(a, t)
            adopt_snapshot(a, ev, t)
            adopt_blame(a, ev)
            settle_bw(a, t)
            a.t_state = t
            if a.state != RUNNING:
                a.cause = None

    if header is None and require_header:
        # zero-record stream: the in-loop guard never saw a first record
        raise SchemaError(
            "event stream is empty and has no schema header; nothing to "
            "analyze (pass require_header=False to accept bare streams)"
        )
    sample(end_t)  # close the last integration interval
    # close open wait intervals: a job still queued/suspended
    # when the stream ends got no closing event, so charge its open
    # interval to its blame cause here — the engine performs the same
    # close at the same time with the same floats (_close_attribution),
    # which is what keeps the aggregate closure exact for unfinished jobs
    for a in active.values():
        if a.cause is not None and a.state in (QUEUED, SUSPENDED):
            dt = end_t - a.t_state
            if dt > 0.0:
                a.rec.delay_legs[a.cause] = (
                    a.rec.delay_legs.get(a.cause, 0.0) + dt
                )
    if spill is not None:
        # unfinished jobs spill after their open wait interval closed,
        # then the lazy arrival-order view replaces the in-memory list
        for a in active.values():
            spill.add(a.rec)
        spill.flush()
        jobs = SpilledJobs(spill)
    net_link_means: Dict[str, float] = {}
    for name, (last_t_l, util, area, first_t) in sorted(net_acc.items()):
        area += util * (end_t - last_t_l)  # hold the last value to the end
        span = end_t - first_t
        net_link_means[name] = area / span if span > 0 else util
    mean_phys: Optional[float] = None
    if samp_acc is not None and header and header.total_chips:
        last_t_s, last_used_s, area_s, first_t_s = samp_acc
        area_s += last_used_s * (end_t - last_t_s)  # hold last to the end
        span = end_t - first_t_s  # first_t_s is 0.0: the demand mean's span
        mean_phys = (
            (area_s / span) / header.total_chips if span > 0
            else last_used_s / header.total_chips
        )

    analysis = RunAnalysis(
        header=header,
        jobs=jobs,
        num_events=n_events,
        end_t=end_t,
        counts=counts,
        util_series=util_series,
        fault_kinds=fault_kinds,
        fault_timeline=fault_timeline,
        mean_occupancy=occ_area / horizon if horizon > 0 and header and header.total_chips else None,
        mean_fragmentation=frag_area / horizon if horizon > 0 and header and header.total_chips else None,
        mean_pending=pend_area / horizon if horizon > 0 else 0.0,
        max_progress_drift=max_drift,
        net_links=net_links,
        net_link_means=net_link_means,
        sample_series=sample_series,
        mean_phys_occupancy=mean_phys,
        proactive=proactive,
        cache_stats=cache_stats,
        _spill=spill,
    )
    return analysis


def analyze_file(path, *, low_memory: bool = False, **kwargs) -> RunAnalysis:
    """Analyze an events.jsonl file (streaming — constant memory in the
    stream length).  Unreadable files and truncated/corrupt records raise
    :class:`StreamError` — so the CLI's "not comparable" refusal path
    (exit 2) covers them, instead of a raw traceback masquerading as a
    scheduler regression (exit 1).

    Gzip-compressed streams (``*.jsonl.gz``) decompress transparently —
    multi-GB fleet logs are stored compressed, and ``report``/``compare``
    read them the same way.  ``low_memory=True``
    additionally spills finished job records to a sqlite temp store
    (:class:`JobSpill`) so the whole analysis — aggregates, exact
    quantiles, report tables — runs at O(active jobs) resident memory
    with the same output, a mean's last digits aside (the streaming
    analyzer).

    Ingestion rides :func:`iter_jsonl_records` — the same incremental
    :class:`StreamCursor` machinery the live-tail watchtower
    (``obs/watch.py``) polls a growing file with, driven here in
    one-shot mode (the shared reader)."""
    if low_memory:
        kwargs["spill"] = JobSpill()
    return analyze_events(iter_jsonl_records(path), **kwargs)
