"""Discrete-event simulation engine.

The port's own copy of ``gpuschedule_tpu/sim/engine.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The reference drives its policies from per-policy time-stepped while-loops
(SURVEY.md §3.1: advance clock, charge progress, invoke policy, apply
preemptions).  This engine keeps that contract — progress charging, policy
invocation after every state change, gang-aware start/preempt — but is
event-driven rather than fixed-delta: the clock jumps between arrivals,
(predicted) completions, and policy-requested wakeups ("ticks", used for
Tiresias quanta / Gandiva rounds / Optimus rounds).  Completion events are
predicted from each job's current speed and invalidated by a per-job epoch
counter whenever a preemption/resize changes the prediction, so replay is
exact rather than quantized to a time step.

Single-process, pure Python, no accelerator in the loop (SURVEY.md §3.1:
"pure single-process CPU sim").
"""

from __future__ import annotations

import heapq
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence

from gpuschedule_tpu_torch.obs.perfetto import track_label
from gpuschedule_tpu_torch.obs.tracer import get_tracer
from gpuschedule_tpu_torch.sim.job import Job, JobState
from gpuschedule_tpu_torch.sim.jobset import JobSet
from gpuschedule_tpu_torch.sim.metrics import MetricsLog, SimResult

# Event kinds, in processing-priority order at equal timestamps: completions
# free resources before arrivals are considered, faults land after both (a
# job finishing exactly when its chips fail completed first — nothing to
# revoke), repairs land after the fault that scheduled them (a zero-length
# outage still revokes, then heals, within one batch), spot pre-revoke
# warnings land after repairs (they are pushed strictly before
# their fault's timestamp, so they can never share a batch with it), and
# the policy runs once after the whole batch.  Cluster samples
# sort last so a sample coinciding with real events snapshots the
# post-fault/repair state of that instant (though still before the policy
# pass reacts to it) — and so the run loops' "sample on top means the
# whole batch is samples" fast path stays sound.
_COMPLETION, _ARRIVAL, _TICK, _FAULT, _REPAIR, _WARN, _SAMPLE = (
    0, 1, 2, 3, 4, 5, 6
)
# Injected what-if mutations (sim/whatif.py): sorts after
# everything at an equal timestamp — INCLUDING _SAMPLE, so the run
# loops' samples-only fast path is gated on `_whatif_pending == 0` (a
# sample on top no longer proves the batch is all samples while a
# mutation is in flight).  Critically EVEN: the lazy spec feed treats
# odd kinds as cursor-fed specs (popping one admits the next), so an
# injected event must never wear an odd kind or it would double-feed
# the cursor.  Only present in speculative forks / direct API use;
# ordinary replays never push it.
_WHATIF = 8


def _prog(job: Job) -> dict:
    """Exact cumulative progress snapshot carried under ``"prog"`` on every
    per-job lifecycle event (schema 1, docs/events.md).  Full-precision
    floats — json round-trips Python floats bit-exactly — so the analyzer
    (obs/analyze.py) reconstructs the goodput decomposition to the last
    float without replaying the engine's internal advance chunking."""
    return {
        "work": job.executed_work,
        "service": job.attained_service,
        "lost_service": job.lost_service,
        "overhead_service": job.overhead_service,
        "lost_work": job.lost_work,
        "overhead_left": job.overhead_remaining,
    }


class Simulator:
    """Replay a trace against a cluster under a policy.

    The policy object receives this simulator as its scheduling context and
    mutates job state only through the engine API (:meth:`try_start`,
    :meth:`preempt`, :meth:`set_speed`, :meth:`migrate`), which keeps
    progress accounting and completion prediction consistent.
    """

    # count of injected-but-unapplied what-if events in the heap (class
    # default so restored older snapshots read 0).  _WHATIF sorts
    # after _SAMPLE, so the run loops' "sample on top means the whole
    # batch is samples" fast path is only sound while this is zero —
    # with a mutation pending, sample-topped batches take the full path
    # (pre-advance, fault dispatch, policy pass, net update).  Ordinary
    # replays never inject, so the fast path — and its byte-identity
    # contract — is untouched outside speculative forks.
    _whatif_pending = 0

    def __init__(
        self,
        cluster,
        policy,
        jobs: Sequence[Job],
        *,
        metrics: Optional[MetricsLog] = None,
        max_time: float = float("inf"),
        eps: float = 1e-6,
        faults=None,
        net=None,
        sample_interval: Optional[float] = None,
        sample_on_change: bool = False,
        profiler=None,
        accounting: str = "v1",
        snapshot_every: Optional[float] = None,
        snapshot_path=None,
    ):
        self.cluster = cluster
        self.policy = policy
        # Accounting version.  "v1" (the default) is
        # the historical chunk-per-batch integration — every running job
        # advances at every event batch, and the resulting float sums are
        # part of the byte-identity contract.  "v2" replaces byte-identity
        # with exact-sum closure (docs/performance.md): jobs integrate
        # lazily at mutation/read points (Job.advance is segment-exact for
        # any dt), the per-batch sweep disappears for policies that never
        # read running-job progress (Policy.reads_progress False — FIFO),
        # and becomes the JobLedger's vectorized sync_all for those that
        # do.  The knob rides the CLI config hash when set to v2.
        if accounting not in ("v1", "v2"):
            raise ValueError(
                f"accounting must be 'v1' or 'v2', got {accounting!r}"
            )
        self.accounting = accounting
        self._lazy = accounting == "v2"
        self._ledger = None
        self._lv = None  # the ledger iff it maintains columns (vector mode)
        if self._lazy:
            from gpuschedule_tpu_torch.sim.ledger import JobLedger

            self._ledger = JobLedger(
                attribution=bool(getattr(metrics, "attribution", False)),
                vector=bool(getattr(policy, "reads_progress", True)),
            )
            if self._ledger.vector:
                self._lv = self._ledger
        # Periodic engine snapshots: every ``snapshot_every``
        # sim seconds the full engine state is serialized to
        # ``snapshot_path`` (sim/snapshot.py), making long replays
        # crash-resumable.  Purely observational: the snapshot lands
        # between batches, so the replay's own bytes never move.
        if (snapshot_every is None) != (snapshot_path is None):
            raise ValueError(
                "snapshot_every and snapshot_path arm together"
            )
        if snapshot_every is not None and snapshot_every <= 0.0:
            raise ValueError(
                f"snapshot_every must be > 0, got {snapshot_every}"
            )
        self._snap_every = snapshot_every
        self._snap_path = snapshot_path
        self._snap_next = snapshot_every if snapshot_every is not None else math.inf
        self._snap_writes = 0
        self._snap_restores = 0
        # Shared-fabric contention (net/): a NetModel that re-prices every
        # running multislice job's locality_factor by max-min fair
        # bandwidth sharing whenever the running set or link health
        # changes.  None (the default) is the static-factor path,
        # bit-identical to the pre-net engine.
        self.net = net
        self._net_links: Dict[str, tuple] = {}  # last emitted link sample
        self._net_priced: Dict[str, float] = {}  # job_id -> last emitted bw
        # adaptive routing: job_id -> last priced route (the
        # flow's weighted uplink set); maintained only when the fabric
        # has redundant uplinks, so single-uplink runs never touch it
        self._net_routes: Dict[str, tuple] = {}
        if net is not None:
            net.attach(cluster)
        # Fault injection (faults/): a FaultPlan whose records become
        # _FAULT events and whose RecoveryModel prices each revocation.
        # None (the default) is the fault-free path, bit-identical to the
        # pre-faults engine; an empty-record plan (mtbf=inf) arms the path
        # without firing it.
        self.faults = faults
        # Failure hazard (faults/hazard.py): when the fault plan
        # arms any hazard knob, build the runtime model, bind it to the
        # cluster (placement schemes read cluster.hazard_score) and arm
        # the proactive checkpoint-and-migrate trigger.  The default
        # (plan.hazard None) leaves self.hazard None: no wear tracking,
        # no per-batch observe call, no behavior change.
        self.hazard = None
        self._migrate_threshold = math.inf
        if faults is not None and getattr(faults, "hazard", None) is not None:
            from gpuschedule_tpu_torch.faults.hazard import HazardModel

            self.hazard = HazardModel(faults.hazard, cluster)
            cluster.bind_hazard(self.hazard)
            self._migrate_threshold = faults.hazard.migrate_threshold
        # Stable sort: ties on submit_time keep trace order, and each job gets
        # a numeric arrival sequence so policies can tie-break without relying
        # on string job_id ordering (which misorders 'j2' vs 'j10').
        self.jobs: List[Job] = sorted(jobs, key=lambda j: j.submit_time)
        for seq, job in enumerate(self.jobs):
            job.arrival_seq = seq
        self.metrics = metrics or MetricsLog()
        self.metrics.attach_jobs(self.jobs)
        self.max_time = max_time
        self.eps = eps
        # Causal attribution: armed by the metrics log
        # (MetricsLog(attribution=True) / CLI --attrib).  Arms each job's
        # ``attrib`` leg dict; everything else is gated on this flag so
        # the off path stays byte-identical to the pre-attribution engine.
        self.attribution = bool(getattr(self.metrics, "attribution", False))
        if self.attribution:
            for job in self.jobs:
                job.attrib = {}
        # Periodic cluster-side samples: every ``sample_interval``
        # sim seconds a ``sample`` event snapshots physical occupancy,
        # health-masked chips, fragmentation and queue depth straight from
        # the cluster flavor.  Samples never mark the batch dirty (no
        # policy invocation, no replay perturbation) and stop re-arming
        # once only ticks/samples remain in the heap.
        if sample_interval is not None and sample_interval <= 0.0:
            raise ValueError(
                f"sample_interval must be > 0, got {sample_interval}"
            )
        self.sample_interval = sample_interval
        # On-change sampling: emit a cluster
        # ``sample`` event whenever a batch changed the health/degrade
        # masks (fault, repair, straggler onset/recovery, domain outage)
        # — in addition to (and independent of) the periodic timer.  The
        # sample lands after the batch's fault/repair records and before
        # the policy pass's reactions, the same instant the timer-driven
        # sampler would snapshot; like it, it observes without dirtying,
        # so the lifecycle stream stays byte-identical modulo the sample
        # records themselves.
        self.sample_on_change = bool(sample_on_change)
        # bumped by every health/degrade-mask transition (chip/domain
        # fault, straggler onset/recovery, mask repair) — NOT by link
        # faults (net-model state, no cluster mask moves) or warnings
        self._mask_mut = 0
        # Wall-clock phase profiler: when attached,
        # run() selects the _run_profiled loop body — the plain loop with
        # two perf_counter reads per segment; detached (the default) no
        # code path ever reads a clock (the check_overhead.py contract).
        self._profiler = profiler
        # Cache telemetry: when the metrics log arms
        # it, the end of the run harvests every cache's hit/miss
        # counters (cluster allocate caches, net pricing/flow/group
        # caches, engine memos) into labeled engine_cache_events metrics,
        # summary counters, and one trailing "cache" stream record.  Off
        # (the default) nothing is harvested and the summary/stream stay
        # byte-identical.
        self._cache_telemetry = bool(
            getattr(self.metrics, "cache_telemetry", False)
        )
        # Observability (obs/): the span tracer is a process singleton whose
        # ``enabled`` flag picks the run loop — the disabled path is the
        # uninstrumented loop verbatim (tools/check_overhead.py guards that
        # it stays overhead-free).
        self._tracer = get_tracer()

        self.now: float = 0.0
        # Insertion-ordered, O(1)-mutation sets (see jobset.py): pending keeps
        # arrival order for non-preemptive policies; both make start/preempt/
        # finish constant-time at Philly scale.
        self.pending: JobSet = JobSet()   # submitted, not running, not finished
        self.running: JobSet = JobSet()   # holding allocations
        self.finished: List[Job] = []
        self._heap: list = []
        self._seq = itertools.count()
        self._nonticks = 0  # heap entries that are not policy ticks
        # Indexed hot paths: alloc_id -> Job for every bound
        # allocation, so fault/warning victim resolution is O(victims)
        # instead of a running-set sweep; running-set insertion tickets
        # (Job.run_seq) let any indexed subset reproduce the sweep's exact
        # iteration order by sorting.
        self._alloc_jobs: Dict[int, Job] = {}
        self._run_tickets = itertools.count()
        # running multislice members (net/): the only jobs _net_update can
        # emit for, so the per-pass scan is O(flows), not O(running).
        # Keyed by object identity; values iterated in run_seq order.
        self._net_members: Dict[int, Job] = {}
        # engine-mutation counter + memo for the _quiesced endgame scan
        # (every job.epoch bump increments it; see _quiesced); hit/miss
        # counts feed the cache telemetry
        self._mut = 0
        self._stall_memo: tuple = ()
        self._stall_hits = 0
        self._stall_misses = 0
        if self.sample_interval is not None:
            # first sample one interval in (a t=0 sample of an empty
            # cluster carries no information)
            self._push(self.sample_interval, _SAMPLE)
        # _drain_faults: records remain in the heap after every job has
        # reached an end state (the schedule is generated to a conservative
        # horizon); the run loops discard them by stopping early.  False
        # for an empty plan so mtbf=inf replays stay event-for-event
        # identical to faults=None.
        self._drain_faults = False
        # Event-stream header (obs/analyze.py): when the caller armed a
        # header (run_meta), fill in the facts the engine knows and the
        # caller might not have set — the policy name and cluster capacity
        # (the analyzer's utilization denominator).  setdefault: explicit
        # caller values win.
        if self.metrics.run_meta is not None:
            self.metrics.run_meta.setdefault("policy", policy.name)
            self.metrics.run_meta.setdefault("total_chips", cluster.total_chips)
        # record identity -> stable index: fault and repair events carry it
        # as "fid" so the Perfetto exporter pairs each repair with ITS
        # outage even when outages of different durations overlap on one
        # scope (FIFO pairing would mis-attribute the intervals)
        self._fault_ids: Dict[int, int] = {}
        # spot record identity -> job_ids that took an emergency
        # checkpoint on ITS warning: the revoke event's "warned" flag
        # marks only revocations whose own notice protected the victim
        # (the persistent ckpt_protected watermark still shrinks losses
        # of later unrelated revocations, but those are not "warned")
        self._warned_jobs: Dict[int, set] = {}
        # Lazy event feed: trace arrivals and fault/warning
        # records used to be pushed into the heap up front, so the heap
        # held O(jobs + faults) entries for the whole replay and every
        # push/pop paid a log of the TRACE length — the first of the
        # per-event costs that grew with fleet scale.  Instead, the
        # pre-known events become a time-sorted spec list fed through a
        # cursor: exactly one spec sits in the heap at a time, and popping
        # it pushes the next, so the heap stays at O(running + residue)
        # whatever the trace length.  Byte-identity: the heap breaks ties
        # by (time, kind, push seq) and spec kinds (_ARRIVAL/_FAULT/_WARN,
        # the odd numbers) never collide with dynamic kinds at equal
        # (time, kind) — sorting specs by (time, kind) with a stable sort
        # (construction order breaks remaining ties, exactly as the old
        # ascending push-seq did) reproduces the old pop order event for
        # event.
        specs: list = [(job.submit_time, _ARRIVAL, job) for job in self.jobs]
        if faults is not None and faults.records:
            self._drain_faults = True
            for i, rec in enumerate(faults.records):
                self._fault_ids[id(rec)] = i
                specs.append((rec.time, _FAULT, rec))
                # spot pre-revoke notice (priced recovery): the
                # warning lands strictly before its revocation, giving
                # running gangs on the spot unit a window to take an
                # emergency checkpoint (faults/recovery.py)
                if rec.kind == "spot" and rec.warning > 0.0:
                    t_warn = rec.time - rec.warning
                    if 0.0 < t_warn < rec.time:
                        specs.append((t_warn, _WARN, rec))
        specs.sort(key=lambda s: (s[0], s[1]))
        self._specs = specs
        self._spec_i = 0
        self._push_next_spec()
        # Priced checkpoint writes: when the recovery model
        # charges for writes, size each job's per-write cost from its
        # model state and gang once, up front — Job.advance folds it into
        # the overhead leg as the write-time fraction of every productive
        # interval.  The default (ckpt_write=0) leaves every job's fields
        # at their dataclass defaults, keeping the advance hot path (and
        # every replayed float) bit-identical to the unpriced engine.
        if faults is not None and faults.recovery is not None:
            recovery = faults.recovery
            if getattr(recovery, "writes_cost", lambda: False)():
                for job in self.jobs:
                    interval = recovery.checkpoint_interval(job)
                    if 0.0 < interval < math.inf:
                        job.ckpt_write_s = recovery.ckpt_write_seconds(
                            job, cluster
                        )
                        job.ckpt_every = interval
        policy.attach(self)

    # ------------------------------------------------------------------ #
    # event plumbing

    def _push(self, time: float, kind: int, payload=None, epoch: int = 0) -> None:
        # ticks and samples are excluded from _nonticks: neither can change
        # scheduler-visible state, so _quiesced()'s "only residue remains"
        # test (and the sample re-arm cutoff) ignores them
        if kind != _TICK and kind != _SAMPLE:
            self._nonticks += 1
        heapq.heappush(self._heap, (time, kind, next(self._seq), payload, epoch))

    def _push_next_spec(self) -> None:
        """Feed the next pre-known event (arrival / fault / warning) from
        the time-sorted spec list into the heap.  Exactly one spec lives
        in the heap at a time — the cursor invariant that keeps the heap
        scale-free and, while any spec remains, keeps
        ``_nonticks`` >= 1 so the quiescence test and the sample re-arm
        cutoff see pending real work exactly as they used to."""
        i = self._spec_i
        specs = self._specs
        if i < len(specs):
            self._spec_i = i + 1
            t, kind, payload = specs[i]
            self._push(t, kind, payload)

    def request_wakeup(self, time: float) -> None:
        """Policy-facing: ask to be re-invoked at absolute sim time ``time``."""
        if time > self.now + self.eps:
            self._push(time, _TICK)

    def _schedule_completion(self, job: Job) -> None:
        rt = job.remaining_runtime()
        if rt != float("inf"):
            self._push(self.now + rt, _COMPLETION, job, job.epoch)

    def _advance_running(self, t: float) -> None:
        for job in self.running:
            job.advance(t)

    def _bind_allocation(self, job: Job, alloc) -> None:
        """Attach a granted allocation to a job, deriving every allocation-
        dependent field (single site: placement quality feeds progress).
        ``slow_factor`` is the straggler multiplier (faults/): the min
        residual rate over the granted chips — 1.0 (and free to compute)
        whenever no chip is degraded."""
        job.allocation = alloc
        job.locality_factor = getattr(alloc.detail, "speed_factor", 1.0)
        job.slow_factor = self.cluster.alloc_slow_factor(alloc)
        self._alloc_jobs[alloc.alloc_id] = job
        if self.net is not None:
            # the flow set / pod occupancy changed: invalidate the cached
            # fabric pricing (incremental re-pricing)
            self.net.mark_dirty(job)
            if getattr(alloc.detail, "slices", None):
                # a DCN-spanning gang: it is (or is about to become) a
                # flow, so _net_update must visit it (member set)
                self._net_members[id(job)] = job

    def _unbind_allocation(self, job: Job) -> None:
        """Drop a job's allocation from the engine indices — called at
        every ``cluster.free`` site, before the free, so the index never
        holds a dead alloc_id."""
        alloc = job.allocation
        if alloc is not None:
            self._alloc_jobs.pop(alloc.alloc_id, None)

    def _net_release(self, job: Job) -> None:
        """Invalidate the cached fabric pricing for a job about to lose
        its allocation — called while the allocation is still attached so
        the dirty test can see which pods it loaded.  Only leaving-the-
        running-set sites call this (preempt / finish / revoke), so it
        also retires the job's net-member entry; the resize/migrate paths
        keep membership until the next recompute closes the job's share."""
        if self.net is not None:
            self.net.mark_dirty(job)
            self._net_members.pop(id(job), None)

    # ------------------------------------------------------------------ #
    # causal attribution: blame tagging + cluster sampling

    def _queue_cause(self, job: Job) -> str:
        """Blame for a queued-at-arrival interval, decided from cluster
        state at event time: ``capacity`` when not even unhealthy chips
        would cover the gang, ``fault-outage`` when health-masked chips
        are what's missing, ``net-outage`` when the missing chips are
        held by gangs stalled at rate 0 by hard DCN-uplink outages (the
        capacity would exist if those gangs could progress and finish —
        rather than misfiling this under ``capacity``),
        ``admission`` when enough nominally-free healthy chips exist —
        the delay is slice geometry or scheduler ordering, not a
        resource shortage."""
        free = self.cluster.free_chips
        if free >= job.num_chips:
            return "admission"
        unhealthy = self.cluster.unhealthy_chips
        if free + unhealthy >= job.num_chips:
            return "fault-outage"
        if self.net is not None:
            # a locality factor of exactly 0.0 only arises from a fully
            # degraded uplink (net/model.py): the gang holds its chips
            # but can never finish until the link heals
            stalled = sum(
                j.allocated_chips
                for j in self.running
                if j.locality_factor == 0.0
            )
            if stalled and free + unhealthy + stalled >= job.num_chips:
                return "net-outage"
        return "capacity"

    def _open_blame(self, job: Job, cause: str) -> None:
        job.blame_cause = cause
        job.blame_since = self.now

    def _close_blame(self, job: Job) -> None:
        """Charge the open queued/suspended interval to its cause (exact
        cumulative floats; the analyzer adopts them from event snapshots
        and SimResult sums them with the same arithmetic)."""
        cause = job.blame_cause
        if cause is None:
            return
        dt = self.now - job.blame_since
        if dt > 0.0:
            job.attrib[cause] = job.attrib.get(cause, 0.0) + dt
        job.blame_cause = None

    def _close_attribution(self) -> None:
        """End of run: close the open wait interval of every job still in
        the pending set (queued or suspended), so SimResult's per-cause
        aggregate covers the full simulated span.

        Each closed job also gets a terminal ``cutoff`` record carrying
        the final legs: the run can end *later* than the last lifecycle
        event (a max_time horizon with nothing running, a stale-
        completion drain), and without a record at ``self.now`` the
        analyzer's stream would end early and its end-of-stream close
        would stop short — silently losing the wait tail (pinned by the
        JAX package's tests/test_attrib.py)."""
        if not self.attribution:
            return
        record = self.metrics.record_events
        for job in self.pending:
            if job.blame_cause is None:
                continue
            self._close_blame(job)
            if record:
                self.metrics.event(
                    "cutoff", self.now, job, chips=0, blame=dict(job.attrib)
                )

    def _emit_sample(self, t: float) -> None:
        """One periodic cluster-side ``sample`` event: *physical*
        occupancy (overlay-packed guests consume no extra chips, unlike
        the demand series the analyzer derives from start events),
        health-masked chips, fragmentation, and queue depth — straight
        from the cluster flavor's :meth:`sample_state`.  A no-op without
        the event stream, so the sampling-on/events-off path costs only
        the heap traffic (tools/check_overhead.py gates it)."""
        if not self.metrics.record_events:
            return
        self.metrics.event(
            "sample", t, None,
            running=len(self.running), pending=len(self.pending),
            **self.cluster.sample_state(),
        )

    # ------------------------------------------------------------------ #
    # policy-facing mutation API

    def try_start(
        self,
        job: Job,
        *,
        chips: Optional[int] = None,
        speed: float = 1.0,
        overhead: float = 0.0,
        placement_hint: Optional[dict] = None,
        why: Optional[dict] = None,
    ) -> bool:
        """Gang-start (or resume) ``job`` on ``chips`` chips; False if the
        cluster cannot grant a valid allocation (all-or-nothing, SURVEY.md §3.1
        placement step).

        ``why`` is the policy's scheduling rationale for this decision (the
        ``Policy.explain`` channel): a small dict naming the rule that fired,
        persisted into the event stream so a trace answers *why* a job
        started, not just *that* it did.  Policies pass None when the event
        stream is off, keeping the hot path allocation-free."""
        if job.state not in (JobState.PENDING, JobState.SUSPENDED):
            raise RuntimeError(f"try_start on non-schedulable job {job!r}")
        if speed <= 0.0:
            # A RUNNING job at speed<=0 never completes and holds chips forever;
            # pausing-in-place is expressed via preempt(suspend=True) instead.
            raise ValueError(f"try_start requires speed > 0, got {speed}")
        chips = chips if chips is not None else job.num_chips
        if job.pin_hint is not None:
            # what-if placement pin: the injected candidate's
            # hint wins over the policy's on key conflicts
            placement_hint = (
                {**placement_hint, **job.pin_hint} if placement_hint
                else job.pin_hint
            )
        alloc = self.cluster.allocate(chips, job=job, hint=placement_hint)
        if alloc is None:
            return False
        job.advance(self.now)
        if self.attribution:
            self._close_blame(job)
        self._bind_allocation(job, alloc)
        job.allocated_chips = chips
        job.state = JobState.RUNNING
        job.speed = speed
        job.overhead_remaining += overhead
        job.epoch += 1
        self._mut += 1
        if job.first_start_time is None:
            job.first_start_time = self.now
        self.pending.discard(job)
        self.running.append(job)
        # running-set insertion ticket: ascending run_seq IS the running
        # set's iteration order, so indexed subsets (victims, net members)
        # can reproduce a full sweep's order by sorting on it
        job.run_seq = next(self._run_tickets)
        self._schedule_completion(job)
        if self._lv is not None:
            self._lv.bind(job)
        if self.metrics.record_events:
            extra = {"chips": chips, "speed": speed, "overhead": overhead,
                     "locality": job.locality_factor,
                     "track": track_label(alloc.detail), "prog": _prog(job)}
            if job.slow_factor != 1.0:
                extra["slow_factor"] = job.slow_factor
            if why is not None:
                extra["why"] = why
            if self.attribution:
                extra["blame"] = dict(job.attrib)
            self.metrics.event("start", self.now, job, **extra)
        return True

    def preempt(
        self, job: Job, *, suspend: bool = True, why: Optional[dict] = None
    ) -> None:
        """Take ``job`` off the cluster.  ``suspend=True`` marks it as a
        time-sliced victim with resume intent (Gandiva); ``suspend=False``
        returns it to the pending queue (Tiresias/SRTF demotion).  ``why``
        is the rationale channel (see :meth:`try_start`)."""
        if job.state is not JobState.RUNNING:
            raise RuntimeError(f"preempt on non-running job {job!r}")
        record = self.metrics.record_events
        track = track_label(job.allocation.detail) if record else None
        job.advance(self.now)
        self._net_release(job)
        self._unbind_allocation(job)
        self.cluster.free(job.allocation)
        job.allocation = None
        job.allocated_chips = 0
        job.speed = 0.0
        job.locality_factor = 1.0
        job.slow_factor = 1.0
        job.epoch += 1
        self._mut += 1
        job.preempt_count += 1
        job.state = JobState.SUSPENDED if suspend else JobState.PENDING
        self.running.remove(job)
        if self._lv is not None:
            self._lv.release(job)
        self.pending.append(job)
        self.metrics.count("preemptions")
        if self.attribution:
            # the whole wait that follows is blamed on this preemption,
            # however long capacity later takes to reappear (cause decided
            # at interval start — docs/events.md)
            self._open_blame(job, "policy-preempt")
        if record:
            extra = {"suspend": suspend, "track": track, "prog": _prog(job)}
            if why is not None:
                extra["why"] = why
            if self.attribution:
                extra["cause"] = "policy-preempt"
                if why is not None and "code" in why:
                    extra["cause_code"] = why["code"]
                extra["blame"] = dict(job.attrib)
            self.metrics.event("preempt", self.now, job, **extra)

    def set_speed(self, job: Job, speed: float, *, why: Optional[dict] = None) -> None:
        """Change a running job's progress rate (elastic resize effect)."""
        if job.state is not JobState.RUNNING:
            raise RuntimeError(f"set_speed on non-running job {job!r}")
        if speed <= 0.0:
            raise ValueError(f"set_speed requires speed > 0, got {speed}")
        job.advance(self.now)
        job.speed = speed
        job.epoch += 1
        self._mut += 1
        self._schedule_completion(job)
        if self._lv is not None:
            self._lv.refresh(job)
        if self.metrics.record_events:
            extra = {"speed": speed, "prog": _prog(job)}
            if why is not None:
                extra["why"] = why
            self.metrics.event("speed", self.now, job, **extra)

    def migrate(
        self,
        job: Job,
        *,
        overhead: float,
        placement_hint: Optional[dict] = None,
        why: Optional[dict] = None,
        event_extra: Optional[dict] = None,
    ) -> bool:
        """Move a running job to a fresh allocation, paying ``overhead``
        seconds of modeled checkpoint/restore cost (SURVEY.md §3.3 migration).

        Returns False — with NO cost charged — when the move didn't happen:
        the hint was unsatisfiable, or first-fit handed back the very slice
        the job already held (a job already at its packed position must not
        be taxed for a no-op "migration")."""
        if job.state is not JobState.RUNNING:
            raise RuntimeError(f"migrate on non-running job {job!r}")
        chips, speed = job.allocated_chips, job.speed
        old_detail = job.allocation.detail if job.allocation is not None else None
        job.advance(self.now)
        self._unbind_allocation(job)
        self.cluster.free(job.allocation)
        alloc = self.cluster.allocate(chips, job=job, hint=placement_hint)
        if alloc is None:  # hint unsatisfiable; restore in place (no cost charged)
            alloc = self.cluster.allocate(chips, job=job)
            if alloc is None:
                raise RuntimeError(f"allocation vanished during migration of {job!r}")
            # "in place" may still land differently (e.g. a better GPU
            # locality tier): re-derive the factor and re-predict completion,
            # or the stale event computed at the old rate stands
            self._bind_allocation(job, alloc)
            job.epoch += 1
            self._mut += 1
            self._schedule_completion(job)
            if self._lv is not None:
                self._lv.refresh(job)
            self._emit_rebind(job, old_detail, alloc)
            return False
        self._bind_allocation(job, alloc)
        if old_detail is not None and alloc.detail == old_detail:
            if self._lv is not None:
                self._lv.refresh(job)
            return False  # same slice re-granted: no movement, no cost
        job.overhead_remaining += overhead
        job.migration_count += 1
        job.epoch += 1
        self._mut += 1
        self._schedule_completion(job)
        if self._lv is not None:
            self._lv.refresh(job)
        self.metrics.count("migrations")
        if self.metrics.record_events:
            extra = {"overhead": overhead, "locality": job.locality_factor,
                     "track": track_label(alloc.detail), "prog": _prog(job)}
            if job.slow_factor != 1.0:
                extra["slow_factor"] = job.slow_factor
            if why is not None:
                extra["why"] = why
            if event_extra:
                extra.update(event_extra)
            self.metrics.event("migrate", self.now, job, **extra)
        return True

    def resize(
        self,
        job: Job,
        *,
        chips: int,
        speed: float,
        overhead: float = 0.0,
        why: Optional[dict] = None,
    ) -> bool:
        """Elastic grow/shrink (Optimus, SURVEY.md §3.2): re-allocate ``job``
        at ``chips`` with new progress rate ``speed``."""
        if job.state is not JobState.RUNNING:
            raise RuntimeError(f"resize on non-running job {job!r}")
        if speed <= 0.0:
            raise ValueError(f"resize requires speed > 0, got {speed}")
        if chips == job.allocated_chips and speed == job.speed:
            return True
        job.advance(self.now)
        old_detail = job.allocation.detail if job.allocation is not None else None
        self._unbind_allocation(job)
        self.cluster.free(job.allocation)
        alloc = self.cluster.allocate(chips, job=job)
        if alloc is None:
            alloc = self.cluster.allocate(job.allocated_chips, job=job)
            if alloc is None:
                raise RuntimeError(f"allocation vanished during resize of {job!r}")
            self._bind_allocation(job, alloc)
            job.epoch += 1
            self._mut += 1
            self._schedule_completion(job)
            if self._lv is not None:
                self._lv.refresh(job)
            self._emit_rebind(job, old_detail, alloc)
            return False
        self._bind_allocation(job, alloc)
        job.allocated_chips = chips
        job.speed = speed
        job.overhead_remaining += overhead
        job.epoch += 1
        self._mut += 1
        self._schedule_completion(job)
        if self._lv is not None:
            self._lv.refresh(job)
        if self.metrics.record_events:
            extra = {"chips": chips, "speed": speed,
                     "locality": job.locality_factor,
                     "track": track_label(alloc.detail), "prog": _prog(job)}
            if job.slow_factor != 1.0:
                extra["slow_factor"] = job.slow_factor
            if why is not None:
                extra["why"] = why
            self.metrics.event("resize", self.now, job, **extra)
        return True

    def _emit_rebind(self, job: Job, old_detail, alloc) -> None:
        """Event for the migrate/resize fallback that re-granted an
        allocation in place: the move the policy asked for didn't happen,
        but the job may now sit on a *different* slice (a better locality
        tier), which changes its progress rate — a silent transition the
        analyzer could not reconstruct without this record.  Skipped when
        the re-grant is literally the same placement (nothing observable
        changed)."""
        if not self.metrics.record_events:
            return
        if old_detail is not None and alloc.detail == old_detail:
            return
        extra = {}
        if job.slow_factor != 1.0:
            extra["slow_factor"] = job.slow_factor
        self.metrics.event(
            "rebind", self.now, job,
            chips=job.allocated_chips, speed=job.speed,
            locality=job.locality_factor,
            track=track_label(alloc.detail), prog=_prog(job), **extra,
        )

    def proactive_migrate(
        self, job: Job, *, exposure: float = 0.0, why: Optional[dict] = None
    ) -> bool:
        """Priced checkpoint-then-migrate: the action the
        engine offers ``Policy.on_hazard`` when a running gang's failure
        exposure crosses the fault plan's ``migrate_threshold``.

        Takes a checkpoint *now* (the write cost plus the restore on the
        new slice ride the move as overhead — the priced-recovery
        machinery), migrates the gang to a strictly clean allocation
        (``avoid_degraded="strict"``: no clean box anywhere → no move,
        NO cost — the gang keeps limping where it is), and raises the
        rollback floor to the checkpointed watermark so a later fault on
        the new hardware loses nothing already protected.

        Accounting: ``avoided_s`` is the work a revocation at this
        instant would have rolled back (the loss this move insures
        against), ``write_s + restore_s`` the overhead actually paid —
        both ride the migrate event (``proactive`` payload) and the
        ``proactive_avoided_work_s`` / ``proactive_overhead_s``
        counters, so the fault panel can weigh avoided-loss against
        paid-overhead."""
        if job.state is not JobState.RUNNING:
            return False
        if self.faults is None or self.faults.recovery is None:
            return False
        recovery = self.faults.recovery
        job.advance(self.now)
        write = recovery.ckpt_write_seconds(job, self.cluster)
        restore = recovery.restore_overhead(job, self.cluster)
        avoided = recovery.lost_progress(job)
        event_extra = None
        if self.metrics.record_events:
            event_extra = {"proactive": {
                "exposure": exposure, "avoided_s": avoided,
                "write_s": write, "restore_s": restore,
            }}
        moved = self.migrate(
            job, overhead=write + restore,
            placement_hint={"avoid_degraded": "strict"},
            why=why, event_extra=event_extra,
        )
        if not moved:
            self.metrics.count("proactive_migrates_blocked")
            return False
        # the checkpoint this move just paid for protects everything
        # executed so far: a fault right after it loses nothing
        job.ckpt_protected = max(job.ckpt_protected or 0.0, job.executed_work)
        self.metrics.count("proactive_migrations")
        self.metrics.count("proactive_avoided_work_s", avoided)
        self.metrics.count("proactive_overhead_s", write + restore)
        return True

    def _offer_hazard_migrations(self) -> None:
        """Offer ``Policy.on_hazard`` every running gang whose exposure
        crosses the armed ``migrate_threshold``.  Evaluated after each
        degrade-mask change (straggler onset/recovery) — the events that
        move exposure; a gang stuck on degraded chips with no clean box
        is re-offered at the next change and stays put at zero cost."""
        hazard = self.hazard
        threshold = self._migrate_threshold
        for job in list(self.running):
            exposure = 1.0 - job.slow_factor
            if hazard is not None and job.allocation is not None:
                exposure += hazard.gang_exposure(job.allocation)
            if exposure >= threshold:
                self.policy.on_hazard(self, job, exposure)

    # ------------------------------------------------------------------ #

    def _finish(self, job: Job) -> None:
        record = self.metrics.record_events
        track = track_label(job.allocation.detail) if record else None
        job.advance(self.now)
        job.executed_work = job.duration  # absorb float residue
        self._net_release(job)
        self._unbind_allocation(job)
        self.cluster.free(job.allocation)
        job.allocation = None
        job.allocated_chips = 0
        job.speed = 0.0
        job.epoch += 1
        self._mut += 1
        job.state = job.end_state
        job.end_time = self.now
        self.running.remove(job)
        if self._lv is not None:
            self._lv.release(job)
        self.finished.append(job)
        self.metrics.record_job(job)
        if record:
            extra = {}
            if self.attribution:
                extra = {"blame": dict(job.attrib)}
            self.metrics.event(
                "finish", self.now, job, end_state=job.state.value, track=track,
                prog=_prog(job), **extra,
            )

    # ------------------------------------------------------------------ #
    # shared-fabric contention (net/)

    def _net_update(self) -> None:
        """Re-price every running multislice job's dynamic locality factor
        from its max-min fair bandwidth share (net/), after any event
        batch that may have changed the running set or link health.

        Factor changes ride the same re-predict machinery as the migrate/
        resize in-place fallback: advance progress at the old rate, bind
        the new factor, bump the epoch, reschedule the completion.  Each
        change is emitted as a ``net`` event (with the exact progress
        snapshot) and changed link loads as ``netlink`` events, so the
        analyzer reconstructs bandwidth shares and link utilization from
        the stream alone.

        Incremental fast path: when no allocation mutation or
        link-health change marked the model dirty since the last pass,
        ``poll`` hands back the cached state and the whole running-set
        scan is skipped — nothing could have changed, so no event would
        have been emitted anyway (the pre-incremental engine would have
        re-derived identical shares and fallen through every emit
        branch).

        Member-set scan: only running multislice gangs (plus
        gangs whose stale bandwidth share still needs closing) can make
        this loop emit or mutate anything — the engine maintains exactly
        that set at bind/release time (``_net_members``), so a dirty pass
        costs O(flows), not O(running).  Iterating members in ascending
        ``run_seq`` reproduces the running-set sweep's order exactly, so
        every emitted event lands in the same stream position."""
        if self.net.poll(self.now) is not None:
            return
        state = self.net.recompute(self.now, self.running, reuse_flows=True)
        record = self.metrics.record_events
        # adaptive routing: with redundant uplinks, a flow's
        # weighted uplink set is a route choice that shifts when link
        # health does — emit the change as a ``reroute`` event.  Gated on
        # the fabric actually having siblings, so single-uplink replays
        # never touch the dict (byte-identity with the
        # single-uplink fabric).
        routing = getattr(self.net, "routing_enabled", False)
        if routing:
            routed, self._net_routes = self._net_routes, {}
        priced, self._net_priced = self._net_priced, {}
        # _net_members holds running multislice gangs only (registered
        # at bind, retired at release):
        members = sorted(
            self._net_members.values(), key=lambda j: j.run_seq
        )
        for job in members:
            share = state.shares.get(job.job_id)
            if share is None:
                # still running but no longer a flow (an elastic shrink/
                # migration back inside one pod): close its bandwidth in
                # the stream if it was priced, then retire the membership
                # — a later multislice re-grow re-registers it at bind
                del self._net_members[id(job)]
                if priced.get(job.job_id):
                    self.metrics.count("net_reprices")
                    if record:
                        self.metrics.event(
                            "net", self.now, job,
                            locality=job.locality_factor, bw_gbps=0.0,
                            prog=_prog(job),
                        )
                continue
            self._net_priced[job.job_id] = share.gbps
            if routing:
                route = share.route
                self._net_routes[job.job_id] = route
                old = routed.get(job.job_id)
                if old is not None and old != route:
                    # the flow moved onto different uplinks (or different
                    # weights) — a route change, not just a speed change
                    self.metrics.count("reroutes")
                    if record:
                        self.metrics.event(
                            "reroute", self.now, job,
                            links=[[name, w] for name, w in route],
                        )
            if (share.factor == job.locality_factor
                    and priced.get(job.job_id) == share.gbps):
                continue
            if share.factor != job.locality_factor:
                job.advance(self.now)
                job.locality_factor = share.factor
                job.epoch += 1
                self._mut += 1
                self._schedule_completion(job)
                if self._lv is not None:
                    self._lv.refresh(job)
            self.metrics.count("net_reprices")
            if record:
                self.metrics.event(
                    "net", self.now, job, locality=share.factor,
                    bw_gbps=share.gbps, demand_gbps=share.demand_gbps,
                    prog=_prog(job),
                )
        if record:
            for name, sample in state.links.items():
                cur = (sample.used_gbps, sample.capacity_gbps)
                if self._net_links.get(name) == cur:
                    continue
                self._net_links[name] = cur
                self.metrics.event(
                    "netlink", self.now, None, link=name,
                    used_gbps=sample.used_gbps,
                    capacity_gbps=sample.capacity_gbps, util=sample.util,
                )
        self.metrics.net_link_samples(state.links)

    # ------------------------------------------------------------------ #
    # fault injection (faults/)

    def _apply_fault(self, rec) -> None:
        """One hardware outage: mark the scope unhealthy, revoke every
        running gang on it, schedule the repair, and let the policy react.

        A correlated domain outage (``kind="domain"``) rides this same
        path: its scope covers every chip under the host/rack/pod at
        once, so the single ``mark_unhealthy`` returns every overlapping
        gang and the whole blast radius is one fault event, one
        revocation batch, one repair — the single-event accounting the
        per-chip model could not express."""
        if rec.scope and rec.scope[0] == "link":
            self._apply_link_fault(rec)
            return
        if rec.kind == "straggler":
            self._apply_straggler(rec)
            return
        if self._lazy and self._lv is None:
            # v2 lazy accounting: fault dispatch (and the policy hooks it
            # invokes) may read any running job's progress — bring the
            # whole set to now first (cold path; v1 already swept it at
            # the top of the batch, and vector mode's sync_all did too)
            self._advance_running(self.now)
        victim_ids = self.cluster.mark_unhealthy(rec.scope)
        self._mask_mut += 1  # health mask moved (on-change sampling)
        self.metrics.count("faults")
        self.metrics.count(f"faults_{rec.kind}")
        if self.metrics.record_events:
            extra = {"level": rec.level} if rec.level else {}
            self.metrics.event(
                "fault", self.now, None,
                scope=rec.label, fault=rec.kind, fid=self._fault_ids[id(rec)],
                # "inf" (string) keeps events.jsonl strict JSON for
                # never-repaired outages
                duration=rec.duration if math.isfinite(rec.duration) else "inf",
                **extra,
            )
        if math.isfinite(rec.duration):
            # duration <= 0 lands in this same batch (kind order puts the
            # repair after the fault), modeling a blip that still revokes
            self._push(self.now + max(0.0, rec.duration), _REPAIR, rec)
        # alloc-index victim resolution: O(victims) instead of a
        # running-set sweep; run_seq order IS the sweep's iteration order
        victims = self._victim_jobs(victim_ids)
        for job in victims:
            self._revoke(job, rec)
        self.policy.on_fault(self, rec, victims)
        if math.isfinite(self._migrate_threshold):
            # hazard-heat exposure (wear-aged pods) moves with time, not
            # only with the degrade mask: fault events are the periodic
            # evaluation points for configs whose stragglers are off
            self._offer_hazard_migrations()

    def _apply_link_fault(self, rec) -> None:
        """A ``("link", pod)`` DCN-uplink outage — the first *partial
        degradation* fault: nothing is revoked
        and no chip goes unhealthy; the degraded uplink slows multislice
        jobs through the contention model (the post-batch ``_net_update``
        re-prices them).  Without a net model the outage is recorded but
        cannot change any speed — counted as ``link_faults_inert`` so an
        operator sees the fault spec asked for something the run cannot
        express (run with ``--net``)."""
        if self._lazy and self._lv is None:
            self._advance_running(self.now)
        self.metrics.count("faults")
        self.metrics.count(f"faults_{rec.kind}")
        if self.metrics.record_events:
            self.metrics.event(
                "fault", self.now, None,
                scope=rec.label, fault=rec.kind, fid=self._fault_ids[id(rec)],
                degrade=rec.degrade,
                duration=rec.duration if math.isfinite(rec.duration) else "inf",
            )
        if self.net is not None:
            # keyed by record identity so the repair heals exactly the
            # sibling this outage degraded (redundant-uplink fabrics)
            self.net.degrade_link(int(rec.scope[1]), rec.degrade, key=id(rec))
        else:
            self.metrics.count("link_faults_inert")
        if math.isfinite(rec.duration):
            self._push(self.now + max(0.0, rec.duration), _REPAIR, rec)
        self.policy.on_fault(self, rec, [])

    def _apply_straggler(self, rec) -> None:
        """A straggler onset (``kind="straggler"``): one chip/node drops
        to ``rec.degrade`` of its rate.  Nothing is revoked and no chip
        leaves the health mask — the unit stays allocatable, just slow —
        but every synchronous gang holding it slows to the straggler's
        rate (``Job.slow_factor``, the compute-side analogue of
        link degradation).  Clusters without a degrade mask record the
        fault but cannot slow anyone (``straggler_faults_inert``, the
        link_faults_inert pattern)."""
        if self._lazy and self._lv is None:
            self._advance_running(self.now)
        self.metrics.count("faults")
        self.metrics.count(f"faults_{rec.kind}")
        if self.metrics.record_events:
            self.metrics.event(
                "fault", self.now, None,
                scope=rec.label, fault=rec.kind, fid=self._fault_ids[id(rec)],
                degrade=rec.degrade,
                duration=rec.duration if math.isfinite(rec.duration) else "inf",
            )
        mark = getattr(self.cluster, "mark_degraded", None)
        if mark is None:
            self.metrics.count("straggler_faults_inert")
        else:
            touched = mark(rec.scope, rec.degrade)
            self._mask_mut += 1  # degrade mask moved (on-change sampling)
            self._apply_slow_factors(touched)
        if math.isfinite(rec.duration):
            self._push(self.now + max(0.0, rec.duration), _REPAIR, rec)
        self.policy.on_fault(self, rec, [])

    def _apply_slow_factors(self, alloc_ids=None) -> None:
        """Re-derive running gangs' straggler multipliers from the
        cluster's degrade mask after a straggler onset or recovery.
        Factor changes ride the usual re-predict machinery (advance at
        the old rate, bind, epoch bump, reschedule) and are emitted as
        ``slow`` events with the exact progress snapshot, so the
        analyzer tracks the rate change without replaying the mask.

        ``alloc_ids`` scopes the re-derivation to the gangs the
        cluster reported overlapping the changed scope — a gang's min-
        over-chips factor can only move when one of ITS chips did, so
        visiting only those gangs (in run_seq = sweep order) emits the
        identical events.  ``None`` keeps the full running-set sweep for
        clusters whose mask cannot report overlap."""
        record = self.metrics.record_events
        jobs = (
            self.running if alloc_ids is None
            else self._victim_jobs(alloc_ids)
        )
        for job in jobs:
            factor = self.cluster.alloc_slow_factor(job.allocation)
            if factor == job.slow_factor:
                continue
            job.advance(self.now)
            job.slow_factor = factor
            job.epoch += 1
            self._mut += 1
            self._schedule_completion(job)
            if self._lv is not None:
                self._lv.refresh(job)
            self.metrics.count("straggler_reprices")
            if record:
                self.metrics.event(
                    "slow", self.now, job, slow_factor=factor,
                    prog=_prog(job),
                )
        if math.isfinite(self._migrate_threshold):
            # proactive checkpoint-and-migrate: straggler
            # exposure moves exactly when the degrade mask does; the
            # hazard-heat term is additionally re-evaluated at fault
            # events (_apply_fault) — between those, exposure changes
            # are not observed (docs/faults.md omissions)
            self._offer_hazard_migrations()

    def _apply_warning(self, rec) -> None:
        """A spot pre-revoke notice, ``rec.warning`` seconds ahead of its
        revocation: every gang that would be revoked right now gets the
        chance to take an *emergency checkpoint* (faults/recovery.py) —
        when the window covers the job's checkpoint-write cost, the
        write is charged as overhead inside the window and the rollback
        floor rises to the warned watermark, so the later revocation
        loses only the window's tail instead of a full checkpoint
        interval.  Gangs whose write cannot finish in time are notified
        but unprotected (``spot_warnings_missed``)."""
        if self._lazy and self._lv is None:
            self._advance_running(self.now)
        self.metrics.count("spot_warnings")
        peek = getattr(self.cluster, "peek_victims", None)
        victims = self._victim_jobs(peek(rec.scope) if peek is not None else ())
        record = self.metrics.record_events
        recovery = self.faults.recovery
        window = rec.time - self.now
        for job in victims:
            write = recovery.ckpt_write_seconds(job, self.cluster)
            if write > window + self.eps:
                self.metrics.count("spot_warnings_missed")
                if record:
                    self.metrics.event(
                        "warn", self.now, job, scope=rec.label,
                        fault=rec.kind, window=window, write=write,
                        saved=False,
                    )
                continue
            job.advance(self.now)
            job.ckpt_protected = max(
                job.ckpt_protected or 0.0, job.executed_work
            )
            job.overhead_remaining += write
            job.epoch += 1
            self._mut += 1
            self._schedule_completion(job)
            if self._lv is not None:
                self._lv.refresh(job)
            self._warned_jobs.setdefault(id(rec), set()).add(job.job_id)
            self.metrics.count("emergency_ckpts")
            if record:
                self.metrics.event(
                    "warn", self.now, job, scope=rec.label, fault=rec.kind,
                    window=window, write=write, saved=True, prog=_prog(job),
                )
        self.policy.on_warning(self, rec, victims)

    def _revoke(self, job: Job, rec) -> None:
        """Fault-revoke one running job: progress rolls back to its last
        checkpoint, a restore cost is charged for the next run, and the job
        requeues (the recovery model in faults/recovery.py decides both
        amounts; this method only applies them)."""
        record = self.metrics.record_events
        track = track_label(job.allocation.detail) if record else None
        job.advance(self.now)
        recovery = self.faults.recovery
        # priced while the gang still holds its chips (restore cost scales
        # with the slice's host count in "auto" mode)
        restore = recovery.restore_overhead(job, self.cluster)
        lost = recovery.lost_progress(job)
        # a warned revocation is one whose OWN pre-revoke notice took the
        # emergency checkpoint that then shrank the rollback; the
        # persistent watermark shrinking a later unrelated revocation's
        # loss does not count (that record gave no warning)
        warned = (
            job.job_id in self._warned_jobs.get(id(rec), ())
            and lost < recovery.lost_progress(job, use_emergency=False)
        )
        if lost > 0.0 and job.executed_work > 0.0:
            # prorate the rolled-back share of this job's useful chip-time
            # into the lost leg of the goodput decomposition: surviving
            # work keeps (1 - frac) of the previously-useful service
            frac = min(1.0, lost / job.executed_work)
            job.lost_service += frac * max(
                0.0, job.attained_service - job.lost_service
            )
            job.executed_work -= lost
            job.lost_work += lost
        self._net_release(job)
        self._unbind_allocation(job)
        self.cluster.free(job.allocation)
        job.allocation = None
        job.allocated_chips = 0
        job.speed = 0.0
        job.locality_factor = 1.0
        job.slow_factor = 1.0
        job.epoch += 1
        self._mut += 1
        job.fault_count += 1
        # the checkpoint restore supersedes any partially burned setup cost
        # (a job faulted mid-resume starts its recovery over)
        job.overhead_remaining = restore
        job.state = JobState.PENDING
        self.running.remove(job)
        if self._lv is not None:
            self._lv.release(job)
        self.pending.append(job)
        self.metrics.count("fault_revocations")
        if warned:
            self.metrics.count("warned_revocations")
        if self.attribution:
            self._open_blame(job, "fault-outage")
        if record:
            # exact floats (schema 1): the analyzer attributes this event's
            # lost work to its fault kind and closes the decomposition
            # against SimResult.goodput bit-for-bit — rounding here would
            # break the closure (docs/events.md)
            extra = {}
            if self.attribution:
                extra = {"cause": "fault-outage", "blame": dict(job.attrib)}
            if warned:
                extra["warned"] = True
            self.metrics.event(
                "revoke", self.now, job,
                scope=rec.label, fault=rec.kind,
                lost_work=lost, restore=restore,
                track=track, prog=_prog(job), **extra,
            )

    def _apply_repair(self, payload, t: float) -> None:
        """One repair record: heal the link / degrade mask / health mask
        (hoisted verbatim out of ``_drain_batch`` so the profiled loop
        can time it as fault dispatch with one wrapper)."""
        if payload.scope and payload.scope[0] == "link":
            # uplink outages live in the net model, not the chip
            # health mask (nothing was marked unhealthy)
            if self.net is not None:
                self.net.repair_link(int(payload.scope[1]),
                                     payload.degrade,
                                     key=id(payload))
        elif payload.kind == "straggler":
            # straggler recovery lives in the degrade mask, not
            # the health mask; gangs on the healed unit speed
            # back up through the same slow-factor re-derivation
            if hasattr(self.cluster, "clear_degraded"):
                touched = self.cluster.clear_degraded(
                    payload.scope, payload.degrade
                )
                self._mask_mut += 1
                self._apply_slow_factors(touched)
        else:
            self.cluster.repair(payload.scope)
            self._mask_mut += 1
        self.metrics.count("repairs")
        if self.metrics.record_events:
            self.metrics.event(
                "repair", t, None, scope=payload.label,
                fault=payload.kind, fid=self._fault_ids[id(payload)],
            )

    # resolves alloc ids through the live allocation index, so every
    # returned job holds an allocation:
    def _victim_jobs(self, alloc_ids) -> List[Job]:
        """Resolve a cluster-reported alloc_id list to the running jobs
        holding them, in running-set iteration order (ascending run_seq) —
        the indexed replacement for ``[j for j in self.running if
        j.allocation.alloc_id in ids]``."""
        if not alloc_ids:
            return []
        index = self._alloc_jobs
        victims = [index[a] for a in alloc_ids if a in index]
        victims.sort(key=lambda j: j.run_seq)
        return victims

    def _drain_batch(self, t: float, prof=None) -> bool:
        """Pop and apply every event at or before ``t``; True if any event
        changed scheduler-visible state (the policy must then run).

        ``prof`` (the profiled loop only) times fault/warning/repair
        dispatch as its own phase — the cold branches check it once per
        fault event; the plain/traced loops never pass it, so the hot
        arrival/completion branches are untouched."""
        dirty = False
        heap = self._heap
        heappop = heapq.heappop
        metrics = self.metrics
        lazy = self._lazy
        while heap and heap[0][0] <= t:
            _, kind, _, payload, epoch = heappop(heap)
            if kind != _TICK and kind != _SAMPLE:
                self._nonticks -= 1
            if kind & 1:
                # spec kinds are exactly the odd ones (_ARRIVAL/_FAULT/
                # _WARN): popping the cursor's in-heap spec admits the
                # next one — at an equal timestamp it joins this same
                # batch, in the old pop order (see _push_next_spec)
                self._push_next_spec()
            if kind == _SAMPLE:
                # cluster-side snapshot: emit (when the event stream is on)
                # and re-arm while real events remain — sampling past the
                # last arrival/completion/fault would only pad the stream.
                # Never marks the batch dirty: the sampler observes, the
                # replay must not feel it.
                self._emit_sample(t)
                if self._nonticks:
                    self._push(t + self.sample_interval, _SAMPLE)
                continue
            if kind == _ARRIVAL:
                job: Job = payload
                job.last_update_time = t
                metrics.count("arrivals")
                if not self.cluster.is_satisfiable(job.num_chips):
                    # Admission control: this gang size can never be
                    # granted here (non-slice size, bigger than a pod).
                    # Reject now instead of letting it wedge priority
                    # schedulers that would reserve budget for it forever.
                    # REJECTED is excluded from JCT/makespan aggregates
                    # (metrics.result), so rejecting clusters don't score
                    # artificially good headline numbers.
                    job.state = JobState.REJECTED
                    job.end_time = t
                    self.finished.append(job)
                    metrics.record_job(job)
                    metrics.count("rejected_unsatisfiable")
                    if metrics.record_events:
                        metrics.event("reject", t, job, chips=job.num_chips)
                else:
                    self.pending.append(job)
                    cause = None
                    if self.attribution:
                        cause = self._queue_cause(job)
                        self._open_blame(job, cause)
                    if metrics.record_events:
                        # duration/status ride along so the analyzer can
                        # derive slowdown and expected end states without
                        # re-reading the trace
                        extra = {"chips": job.num_chips,
                                 "duration": job.duration,
                                 "status": job.status}
                        if job.ckpt_write_s > 0.0:
                            # priced checkpoint writes: the analyzer needs
                            # the per-job write cost and period to mirror
                            # the engine's work/overhead split in its
                            # drift guard
                            extra["ckpt_write_s"] = job.ckpt_write_s
                            extra["ckpt_every"] = job.ckpt_every
                        if cause is not None:
                            extra["cause"] = cause
                        metrics.event("arrival", t, job, **extra)
                dirty = True
            elif kind == _COMPLETION:
                job = payload
                if job.epoch != epoch or job.state is not JobState.RUNNING:
                    continue  # stale prediction from before a preempt/resize
                if lazy:
                    # v2: integrate to the completion instant (v1 swept
                    # the whole running set at the top of the batch; the
                    # vector sync_all leaves this a dt == 0 no-op)
                    job.advance(t)
                if job.remaining_runtime() > self.eps:
                    # speed changed without epoch bump — repredict
                    self._schedule_completion(job)
                    continue
                self._finish(job)
                dirty = True
            elif kind == _FAULT:
                if prof is not None:
                    with prof.phase("fault_dispatch"):
                        self._apply_fault(payload)
                else:
                    self._apply_fault(payload)
                dirty = True
            elif kind == _WARN:
                # spot pre-revoke notice: may charge emergency
                # checkpoint overhead, so the policy gets a pass after it
                if prof is not None:
                    with prof.phase("fault_dispatch"):
                        self._apply_warning(payload)
                else:
                    self._apply_warning(payload)
                dirty = True
            elif kind == _REPAIR:
                if prof is not None:
                    with prof.phase("fault_dispatch"):
                        self._apply_repair(payload, t)
                else:
                    self._apply_repair(payload, t)
                dirty = True  # restored capacity: waiters may now place
            elif kind == _WHATIF:
                # injected what-if mutation (cold path: only speculative
                # forks ever push these)
                self._apply_whatif(payload, t)
                dirty = True
            else:  # _TICK
                dirty = True
        return dirty

    def run(self) -> SimResult:
        """Drive the event loop to completion and return summary metrics.

        Three bodies, one behavior: the profiled loop buckets
        each batch's wall time into replay phases, the traced loop wraps
        each event batch and policy invocation in tracer spans (dual
        wall/sim clocks), and the plain loop is the uninstrumented hot
        path, selected when both are off so replay pays nothing for the
        telemetry layer's existence (the tools/check_overhead.py
        contract).  A profiler takes precedence over the tracer — the
        phase buckets ARE the wall-clock story; per-batch spans on top
        would double the clock reads they measure."""
        if self._profiler is not None:
            return self._run_profiled()
        if self._tracer.enabled:
            return self._run_traced()
        return self._run_plain()

    def _cutoff_at_horizon(self) -> None:
        """Horizon cutoff: charge running jobs up to max_time so executed
        work and utilization cover the full simulated span.  Shared by both
        run-loop bodies — cold code, one owner.

        Each still-running job gets a terminal ``cutoff`` event carrying its
        final progress snapshot: the cutoff advance happens *after* the
        job's last lifecycle event, so without this record the analyzer's
        per-job legs would stop short of what SimResult.goodput integrates
        (suspended/pending jobs don't advance here and need none)."""
        self.now = self.max_time
        self._advance_running(self.max_time)
        if self.metrics.record_events:
            for job in self.running:
                extra = {}
                if self.attribution:
                    extra = {"blame": dict(job.attrib)}
                self.metrics.event(
                    "cutoff", self.now, job,
                    chips=job.allocated_chips,
                    track=track_label(job.allocation.detail),
                    prog=_prog(job), **extra,
                )
            # waiting jobs get their horizon record from the end-of-run
            # _close_attribution (which runs at this same self.now)
        self.metrics.sample(
            self.now, self.cluster, len(self.running), len(self.pending)
        )

    def _quiesced(self) -> bool:
        """Fault runs can strand jobs: a permanent outage (repair=inf) may
        leave a once-satisfiable gang unplaceable forever.  Once nothing is
        running and no arrival/completion/fault/repair remains — only
        policy-requested ticks — no tick can change anything (every policy
        already ran after the last real event and placed what fits; time
        alone cannot un-strand a gang), so spinning through the tick chain
        would loop forever for policies that always re-request a wakeup
        while jobs wait (Gandiva rounds).  Gated on _drain_faults: the
        fault-free path cannot strand jobs (unsatisfiable gangs are
        rejected at admission) and keeps its exact pre-faults behavior.

        The net/ analogue of a stranded gang: a permanent hard link
        outage (link_repair=inf, degrade=0) pins a multislice job's
        dynamic locality factor at 0.0 — it runs forever at zero rate
        and never schedules a completion.  With nothing pending and only
        ticks left, no tick can revive it (the policy already ran after
        the outage and every tick since; the dead uplink stays dead), so
        the run quiesces instead of spinning through the tick chain."""
        if not self._drain_faults:
            return False
        if len(self.finished) == len(self.jobs):
            return True
        if self._nonticks:
            return False
        if not self.running:
            return True
        if self.pending:
            return False
        # Memoized endgame scan: between heap events nothing can
        # change a running job's remaining_runtime without bumping _mut (a
        # job already stalled at rate 0 burns neither work nor its stall:
        # advance() is a no-op on the answer), so a long tick chain asks
        # the O(running) question once per mutation instead of per tick.
        key = (len(self.finished), len(self.running), self._mut)
        memo = self._stall_memo
        if memo and memo[0] == key:
            self._stall_hits += 1
            return memo[1]
        stalled = all(
            j.remaining_runtime() == math.inf for j in self.running
        )
        self._stall_memo = (key, stalled)
        self._stall_misses += 1
        return stalled

    def _run_plain(self) -> SimResult:
        # Hot loop: every attribute below is fixed for the whole
        # run, so bind once — at Philly scale this loop turns over millions
        # of times and the repeated self.* lookups are measurable.
        heap = self._heap
        max_time = self.max_time
        net = self.net
        hazard = self.hazard
        cluster = self.cluster
        running, pending = self.running, self.pending
        policy_schedule = self.policy.schedule
        metrics_sample = self.metrics.sample
        soc = self.sample_on_change
        # Per-batch progress sweep: v1 = the chunked advance
        # of every running job (byte-identity contract); v2 vector = the
        # ledger's masked-array sync_all (policy reads progress every
        # pass); v2 lazy = nothing at all (jobs integrate at mutations).
        advance = self._advance_running
        if self._ledger is not None:
            advance = self._lv.sync_all if self._lv is not None else None
        snapping = self._snap_every is not None
        while heap:
            if self._quiesced():
                break  # only fault/repair/tick residue past the last job
            head = heap[0]
            t = head[0]
            if t > max_time:
                self._cutoff_at_horizon()
                break
            if snapping and t >= self._snap_next:
                # between-batch instant: self.now is still the previous
                # batch time and every index/heap invariant holds — the
                # exact state a restore re-enters (sim/snapshot.py)
                self._snapshot_tick(t)
            self.now = t
            if head[1] == _SAMPLE and not self._whatif_pending:
                # _SAMPLE sorts last at equal timestamps, so a sample on
                # top means the whole batch is samples: nothing scheduler-
                # visible changes and no progress needs integrating.
                # Skipping the advance keeps every progress float chunked
                # — and therefore the event stream byte-for-byte — exactly
                # as in the sampling-free replay (the regression
                # contract extends to sampling-on runs modulo the sample
                # records themselves).
                # deliberately no metrics.sample() either: an extra
                # integration point would re-chunk the utilization
                # integral and dust its low-order bits
                self._drain_batch(t)
                continue
            if hazard is not None:
                # integrate wear before the batch mutates occupancy:
                # between batches occupancy is constant, so the busy
                # chip-second integral is exact piecewise
                hazard.observe(t, cluster)
            if advance is not None:
                advance(t)
            mm = self._mask_mut
            if self._drain_batch(t):
                if soc and self._mask_mut != mm:
                    # on-change sample: the batch
                    # touched a health/degrade mask — snapshot the
                    # post-fault, pre-policy cluster state, exactly where
                    # a coinciding timer sample would land
                    self._emit_sample(t)
                wakeup = policy_schedule(self)
                if wakeup is not None:
                    self.request_wakeup(wakeup)
                if net is not None:
                    self._net_update()
            metrics_sample(self.now, cluster, len(running), len(pending))
        if self._lazy:
            # v2: the loop never swept progress — bring every still-
            # running job to the final clock before the summary sums
            self._advance_running(self.now)
        if self.net is not None:
            self.net.close(self.now)
        self._close_attribution()
        if self._cache_telemetry:
            self._harvest_cache_stats()
        return self.metrics.result(self.jobs, self.now)

    def _run_traced(self) -> SimResult:
        tracer = self._tracer
        with tracer.span(
            "sim.run", cat="sim", sim_now=0.0,
            policy=self.policy.name, jobs=len(self.jobs),
        ) as run_sp:
            n_batches = 0
            advance = self._advance_running
            if self._ledger is not None:
                advance = self._lv.sync_all if self._lv is not None else None
            snapping = self._snap_every is not None
            while self._heap:
                if self._quiesced():
                    break  # only fault/repair/tick residue past the last job
                t = self._heap[0][0]
                if t > self.max_time:
                    self._cutoff_at_horizon()
                    break
                if snapping and t >= self._snap_next:
                    self._snapshot_tick(t)
                self.now = t
                if self._heap[0][1] == _SAMPLE and not self._whatif_pending:
                    # pure-sample batch: same skip as the plain loop (no
                    # advance, no metrics.sample, no policy, no span —
                    # the sampler observes, the replay must not feel it)
                    self._drain_batch(t)
                    continue
                if self.hazard is not None:
                    self.hazard.observe(t, self.cluster)
                with tracer.span("sim.batch", cat="sim", sim_now=t) as sp:
                    if advance is not None:
                        advance(t)
                    mm = self._mask_mut
                    dirty = self._drain_batch(t)
                    if dirty:
                        if self.sample_on_change and self._mask_mut != mm:
                            self._emit_sample(t)
                        with tracer.span(
                            "policy.schedule", cat="policy", sim_now=t,
                            policy=self.policy.name,
                        ) as psp:
                            wakeup = self.policy.schedule(self)
                            psp.set(
                                running=len(self.running),
                                pending=len(self.pending),
                                wakeup=wakeup,
                            )
                        if wakeup is not None:
                            self.request_wakeup(wakeup)
                        if self.net is not None:
                            self._net_update()
                    sp.set(dirty=dirty).end_sim(self.now)
                n_batches += 1
                self.metrics.sample(
                    self.now, self.cluster, len(self.running), len(self.pending)
                )
            run_sp.set(batches=n_batches).end_sim(self.now)
        if self._lazy:
            self._advance_running(self.now)
        if self.net is not None:
            self.net.close(self.now)
        self._close_attribution()
        if self._cache_telemetry:
            self._harvest_cache_stats()
        return self.metrics.result(self.jobs, self.now)

    def _run_profiled(self) -> SimResult:
        """The self-profiling loop body: the plain loop's exact
        call sequence with each segment's wall time charged to a replay
        phase (obs/selfprof.py PHASES).  Replay behavior is byte-
        identical to the plain loop — the clock reads observe, they never
        steer — pinned by tests/test_selfprof.py.

        Phase accounting: fault/warning/repair dispatch is timed inside
        ``_drain_batch`` (the ``prof`` parameter) and subtracted from the
        surrounding event-apply segment, so phases are disjoint; the
        un-segmented residue (heap peeks, the quiescence test, loop
        dispatch) lands in ``other`` at :meth:`PhaseProfiler.finish`, so
        the phase totals sum to the measured total exactly."""
        prof = self._profiler
        perf = time.perf_counter
        prof.start(policy=self.policy.name, jobs=len(self.jobs))
        heap = self._heap
        max_time = self.max_time
        net = self.net
        hazard = self.hazard
        cluster = self.cluster
        running, pending = self.running, self.pending
        policy_schedule = self.policy.schedule
        metrics_sample = self.metrics.sample
        soc = self.sample_on_change
        p_advance = prof.phase("advance")
        p_policy = prof.phase("policy_schedule")
        p_net = prof.phase("net_resolve")
        p_metrics = prof.phase("metrics_emit")
        fault_totals = prof.totals  # read fault_dispatch between clock reads
        # v2 accounting: the vector ledger sync is its own
        # phase (``ledger_sync``) so a v2 profile names the new per-batch
        # cost; the lazy path has no per-batch sweep at all and charges
        # nothing here.  Hazard wear integration stays under ``advance``.
        advance = self._advance_running
        adv_phase = p_advance
        if self._ledger is not None:
            if self._lv is not None:
                advance = self._lv.sync_all
                adv_phase = prof.phase("ledger_sync")
            else:
                advance = None
        snapping = self._snap_every is not None
        while heap:
            if self._quiesced():
                break  # only fault/repair/tick residue past the last job
            head = heap[0]
            t = head[0]
            if t > max_time:
                with p_metrics:
                    self._cutoff_at_horizon()
                break
            if snapping and t >= self._snap_next:
                self._snapshot_tick(t)
            self.now = t
            if head[1] == _SAMPLE and not self._whatif_pending:
                # pure-sample batch: same skip as the plain loop (no
                # advance, no metrics.sample, no policy); sample batches
                # can never contain faults (_SAMPLE sorts last), so the
                # whole drain is event application
                t0 = perf()
                self._drain_batch(t)
                prof.add("event_apply", perf() - t0)
                prof.batch_done()
                continue
            if hazard is not None:
                with p_advance:
                    hazard.observe(t, cluster)
            if advance is not None:
                with adv_phase:
                    advance(t)
            mm = self._mask_mut
            f0 = fault_totals["fault_dispatch"]
            t0 = perf()
            dirty = self._drain_batch(t, prof=prof)
            prof.add(
                "event_apply",
                (perf() - t0) - (fault_totals["fault_dispatch"] - f0),
            )
            if dirty:
                if soc and self._mask_mut != mm:
                    with p_metrics:
                        self._emit_sample(t)
                with p_policy:
                    wakeup = policy_schedule(self)
                if wakeup is not None:
                    self.request_wakeup(wakeup)
                if net is not None:
                    with p_net:
                        self._net_update()
            with p_metrics:
                metrics_sample(self.now, cluster, len(running), len(pending))
            prof.batch_done()
        if self._lazy:
            with p_advance:
                self._advance_running(self.now)
        if self.net is not None:
            self.net.close(self.now)
        with p_metrics:
            self._close_attribution()
        if self._cache_telemetry:
            self._harvest_cache_stats()
        with prof.phase("analytics"):
            res = self.metrics.result(self.jobs, self.now)
        prof.finish()
        return res

    # ------------------------------------------------------------------ #
    # what-if speculation (sim/whatif.py)

    def run_until(self, t: float) -> None:
        """Advance the replay through every batch at time <= ``t``, then
        pause *between batches* — exactly the instant :meth:`snapshot` /
        :meth:`fork` capture, so a paused engine is a live mirror to
        speculate from.  The loop body is the plain loop's exact call
        sequence; pausing never finalizes (no horizon cutoff, no
        attribution close, no summary — those belong to :meth:`run`,
        which picks up seamlessly), so ``run_until(t)`` followed by
        ``run()`` replays byte-identically to an uninterrupted ``run()``
        (pinned by tests/test_whatif.py)."""
        heap = self._heap
        max_time = self.max_time
        net = self.net
        hazard = self.hazard
        cluster = self.cluster
        running, pending = self.running, self.pending
        policy_schedule = self.policy.schedule
        metrics_sample = self.metrics.sample
        soc = self.sample_on_change
        advance = self._advance_running
        if self._ledger is not None:
            advance = self._lv.sync_all if self._lv is not None else None
        snapping = self._snap_every is not None
        while heap:
            if self._quiesced():
                break
            head = heap[0]
            bt = head[0]
            if bt > t or bt > max_time:
                break
            if snapping and bt >= self._snap_next:
                self._snapshot_tick(bt)
            self.now = bt
            if head[1] == _SAMPLE and not self._whatif_pending:
                self._drain_batch(bt)
                continue
            if hazard is not None:
                hazard.observe(bt, cluster)
            if advance is not None:
                advance(bt)
            mm = self._mask_mut
            if self._drain_batch(bt):
                if soc and self._mask_mut != mm:
                    self._emit_sample(bt)
                wakeup = policy_schedule(self)
                if wakeup is not None:
                    self.request_wakeup(wakeup)
                if net is not None:
                    self._net_update()
            metrics_sample(self.now, cluster, len(running), len(pending))

    def inject_admit(self, job: Job, *, t: Optional[float] = None,
                     pin: Optional[dict] = None) -> Job:
        """Queue a synthetic arrival — the "admit this job (where)?"
        what-if mutation.  ``job`` joins the trace at ``t`` (default:
        now) through the ordinary arrival path (admission control, blame
        tagging, policy pass); ``pin`` (an allocation hint, e.g.
        ``{"pod": 3}``) rides the job as :attr:`Job.pin_hint` and wins
        over the policy's placement hints, so candidate placements are
        comparable across forks.  Meant for speculative forks; calling
        it on a live run legitimately extends that run's trace."""
        at = self.now if t is None else float(t)
        if at < self.now:
            raise ValueError(
                f"inject_admit at {at} is in the past (now={self.now})"
            )
        job.submit_time = at
        job.arrival_seq = len(self.jobs)
        if pin:
            job.pin_hint = dict(pin)
        if self.attribution:
            job.attrib = {}
        if self.faults is not None and self.faults.recovery is not None:
            recovery = self.faults.recovery
            if getattr(recovery, "writes_cost", lambda: False)():
                interval = recovery.checkpoint_interval(job)
                if 0.0 < interval < math.inf:
                    job.ckpt_write_s = recovery.ckpt_write_seconds(
                        job, self.cluster
                    )
                    job.ckpt_every = interval
        self.jobs.append(job)
        self._whatif_pending += 1
        self._push(at, _WHATIF, ("admit", job))
        return job

    def inject_drain(self, scope, *, t: Optional[float] = None,
                     duration: float = math.inf):
        """Schedule a what-if drain: every chip under ``scope`` (e.g.
        ``("pod", 7)``) leaves service at ``t`` (default: now) for
        ``duration`` seconds, as a synthetic ``maintenance`` outage
        riding the ordinary fault path — running gangs revoke with
        checkpoint recovery priced by the armed RecoveryModel (a default
        one is armed when the run had no fault plan), capacity returns
        at the repair.  Answers "drain pod 7 now or at the maintenance
        window?" by forked replay of both variants."""
        at = self.now if t is None else float(t)
        if at < self.now:
            raise ValueError(
                f"inject_drain at {at} is in the past (now={self.now})"
            )
        from gpuschedule_tpu_torch.faults.recovery import FaultPlan
        from gpuschedule_tpu_torch.faults.schedule import FaultRecord

        rec = FaultRecord(at, tuple(scope), float(duration), "maintenance")
        if self.faults is None:
            self.faults = FaultPlan(records=[rec])
        else:
            self.faults.records.append(rec)
        # registered like a scheduled record: snapshot/fork remap the
        # id()-keyed index through the records list, injected or not
        self._fault_ids[id(rec)] = len(self.faults.records) - 1
        self._drain_faults = True
        self._whatif_pending += 1
        self._push(at, _WHATIF, ("fault", rec))
        return rec

    def swap_policy(self, policy) -> None:
        """Replace the scheduling policy mid-replay — the "what if we
        ran SRTF instead?" mutation.  Per-job policy scratch
        (``Job.sched``) is cleared for live jobs so the incoming policy
        derives its own state lazily; engine-owned accounting (progress,
        attained service, attribution legs) carries over untouched.
        Under v2 accounting the ledger rebuilds for the new policy's
        ``reads_progress`` declaration.  A tick is pushed at the swap
        instant so the incoming policy gets an immediate scheduling pass
        — without it the swap would lie dormant until the next dirty
        batch (hours of sim time away on a quiet heap), and a
        policy-swap what-if would under-measure its own delta."""
        for job in self.pending:
            job.sched.clear()
        for job in self.running:
            job.sched.clear()
        self.policy = policy
        if self._lazy:
            from gpuschedule_tpu_torch.sim.ledger import JobLedger

            self._ledger = JobLedger(
                attribution=self.attribution,
                vector=bool(getattr(policy, "reads_progress", True)),
            )
            self._lv = self._ledger if self._ledger.vector else None
            if self._lv is not None:
                for job in self.running:
                    self._lv.bind(job)
        policy.attach(self)
        # request_wakeup drops same-instant ticks; the swap wants one NOW
        self._push(self.now, _TICK)

    def _apply_whatif(self, payload, t: float) -> None:
        """Apply one injected what-if mutation: a synthetic arrival
        (mirroring the _ARRIVAL branch — kept inline there for the hot
        path) or a drain record dispatched down the ordinary fault
        path."""
        self._whatif_pending -= 1
        kind = payload[0]
        if kind == "admit":
            job: Job = payload[1]
            job.last_update_time = t
            self.metrics.count("arrivals")
            self.metrics.count("whatif_admits")
            if not self.cluster.is_satisfiable(job.num_chips):
                job.state = JobState.REJECTED
                job.end_time = t
                self.finished.append(job)
                self.metrics.record_job(job)
                self.metrics.count("rejected_unsatisfiable")
                if self.metrics.record_events:
                    self.metrics.event("reject", t, job, chips=job.num_chips)
                return
            self.pending.append(job)
            cause = None
            if self.attribution:
                cause = self._queue_cause(job)
                self._open_blame(job, cause)
            if self.metrics.record_events:
                extra = {"chips": job.num_chips, "duration": job.duration,
                         "status": job.status}
                if job.ckpt_write_s > 0.0:
                    extra["ckpt_write_s"] = job.ckpt_write_s
                    extra["ckpt_every"] = job.ckpt_every
                if cause is not None:
                    extra["cause"] = cause
                self.metrics.event("arrival", t, job, **extra)
        elif kind == "fault":
            self.metrics.count("whatif_drains")
            self._apply_fault(payload[1])
        else:
            raise ValueError(f"unknown what-if mutation {kind!r}")

    # ------------------------------------------------------------------ #
    # engine snapshot / restore / fork

    def _snapshot_tick(self, t: float) -> None:
        """Periodic snapshot trigger (``--snapshot-every``): serialize the
        engine between batches — ``self.now`` is still the previous batch
        time, the heap head at ``t`` is untouched — then re-arm at the
        next multiple past ``t``.  Cold path; the run loops pay one bool
        test per batch when disarmed.

        Tailable-sink contract: the snapshot itself flushes
        the event sink (sim/snapshot.py ``snapshot_state``), so the
        on-disk stream is always consistent AT the snapshot instant —
        and a tiny ``<snapshot>.meta.json`` sidecar names that instant,
        so a tailing watchtower (obs/watch.py) can pin "the nearest
        snapshot before the incident" for ``whatif`` replay without
        unpickling the full engine state.  The sidecar is replaced
        BEFORE the snapshot: at every instant the on-disk meta's ``t``
        is >= the on-disk snapshot's, so a concurrent watcher copying
        snap-then-meta can never pair a snapshot with an OLDER sidecar
        (its ``snapshot_t`` may overstate — harmless, ``whatif --at``
        lands at-or-after the restored clock — but never understate)."""
        import json as _json
        import os as _os

        meta = str(self._snap_path) + ".meta.json"
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            f.write(_json.dumps(
                {"t": self.now, "snapshot_writes": self._snap_writes + 1},
                sort_keys=True,
            ))
        _os.replace(tmp, meta)
        self.snapshot(self._snap_path)
        every = self._snap_every
        nxt = self._snap_next
        while nxt <= t:
            nxt += every
        self._snap_next = nxt

    def snapshot(self, path) -> None:
        """Serialize the full engine state (jobset, cluster masks and
        counters, heap + lazy-feed cursor, net dirty sets, metrics
        accumulators, event-sink position) to a versioned snapshot file
        (sim/snapshot.py).  Purely observational — the replay's own
        bytes never move; RNG-free by construction since every stochastic
        stream (trace, faults) is pregenerated into specs."""
        from gpuschedule_tpu_torch.sim.snapshot import save_snapshot

        save_snapshot(self, path)
        self._snap_writes += 1

    @classmethod
    def restore(cls, path, *, metrics=None, events_sink=None, profiler=None):
        """Reconstruct a mid-replay simulator from :meth:`snapshot` in a
        fresh process; ``run()`` then finishes the replay.  Under v1
        accounting the resumed tail is byte-identical to the
        uninterrupted run (events.jsonl / jobs.csv / utilization.csv);
        under v2 it is closure-exact (docs/performance.md)."""
        from gpuschedule_tpu_torch.sim.snapshot import load_snapshot

        return load_snapshot(
            path, metrics=metrics, events_sink=events_sink,
            profiler=profiler,
        )

    def fork(self):
        """In-memory speculative copy (the digital-twin primitive): a
        fully independent simulator continuing from this engine's exact
        current state, with the event stream detached so what-if replays
        never write into the parent's outputs.  Counters and utilization
        integrals carry over, so the fork's ``result()`` covers the whole
        history."""
        from gpuschedule_tpu_torch.sim.snapshot import fork_simulator

        return fork_simulator(self)

    # ------------------------------------------------------------------ #
    # cache telemetry

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Every engine-visible cache's event counts, unified as
        ``{cache: {outcome: count}}`` — the lattice made
        observable: the fabric pricing / flow-list / bottleneck-group
        caches (net/), the TPU allocate-failure cache, can_allocate memo
        and bitmask row cache (cluster/tpu.py), and the engine's own
        quiescence memo.  Sources that were never armed (no net model, a
        non-TPU cluster) simply contribute nothing."""
        stats: Dict[str, Dict[str, int]] = {}
        cluster = getattr(self.cluster, "inner", self.cluster)
        for source in (cluster, self.net):
            get = getattr(source, "cache_stats", None)
            if get is not None:
                for name, outcomes in get().items():
                    stats[name] = dict(outcomes)
        stats["quiesce_memo"] = {
            "hit": self._stall_hits, "miss": self._stall_misses,
        }
        if self._ledger is not None:
            # v2 accounting: slot churn served in place vs
            # capacity growth
            for name, outcomes in self._ledger.cache_stats().items():
                stats[name] = dict(outcomes)
        if self._snap_writes or self._snap_restores:
            stats["snapshot"] = {
                "write": self._snap_writes, "restore": self._snap_restores,
            }
        return stats

    def _harvest_cache_stats(self) -> None:
        """End-of-run: fold :meth:`cache_stats` into summary counters
        (``cache_<name>_<outcome>``), the labeled registry metric
        (``engine_cache_events{cache,outcome}``), and — when the event
        stream is on — one trailing ``cache`` record the analyzer turns
        into the report's Engine-health table."""
        stats = self.cache_stats()
        emit = {}
        for name in sorted(stats):
            outcomes = stats[name]
            kept = {k: int(v) for k, v in sorted(outcomes.items()) if v}
            if not kept:
                continue
            emit[name] = kept
            for outcome, n in kept.items():
                self.metrics.cache_event(name, outcome, n)
        if self.metrics.record_events:
            self.metrics.event("cache", self.now, None, caches=emit)
