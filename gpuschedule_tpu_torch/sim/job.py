"""Job model and progress accounting.

The port's own copy of ``gpuschedule_tpu/sim/job.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

Mirrors the reference's per-job trace record (SURVEY.md §2 "Job model + trace
loader": id, submit_time, num_gpu, iterations, model, duration) with the GPU
request generalized to a TPU chip request, plus the runtime accounting every
policy needs:

- ``executed_work`` / ``remaining_work`` in *reference-speed seconds* — the
  progress currency for FIFO/SRTF and for deadline prediction;
- ``attained_service`` in *chip-seconds* — the Tiresias-LAS priority currency
  (SURVEY.md §2 "Policy: Tiresias LAS/DLAS");
- ``speed`` — the instantaneous progress rate.  1.0 means "running at the
  trace-declared allocation"; Optimus-style elastic policies set it from the
  fitted goodput curve when they grow/shrink a job (SURVEY.md §3.2);
- ``overhead_remaining`` — modeled preemption/migration cost: seconds of run
  time that must be burned before real work resumes (Gandiva suspend/resume
  and migration penalties are charged this way, SURVEY.md §3.3 / §5
  "Checkpoint / resume": costs are modeled, not real).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# Causal-attribution leg names.  A job's whole lifetime
# decomposes into these legs, each an exact cumulative float in
# ``Job.attrib`` when attribution is armed:
#
# - WAIT_CAUSES blame queued/suspended intervals.  The cause is decided
#   once, when the interval *starts* (the engine's blame rule at arrival /
#   preempt / revoke time), and the whole interval is charged to it:
#   ``capacity`` (not enough healthy chips existed), ``fault-outage``
#   (enough chips existed but some were health-masked), ``net-outage``
#   (enough chips existed but they are held by gangs stalled at rate 0
#   by hard DCN-uplink outages — the capacity shortage IS the link
#   outage; distinct from the running ``net-degraded`` leg, which would
#   collide with it in the shared legs dict), ``admission`` (enough
#   nominally-free healthy chips existed — the delay is geometry or
#   scheduler ordering, not resource shortage), ``policy-preempt``
#   (the interval began with a policy preemption; the preempting rule's
#   machine-parseable code rides on the event).
# - RUN_LEGS split every running second: ``work`` (speed x locality x
#   slow — the reference-speed work-equivalent; sums to ~duration for a
#   finished job), ``policy-share`` ((1-speed) — time-sliced packing /
#   elastic shrink; negative when an elastic grow runs the job *faster*
#   than its trace speed), ``net-degraded`` (speed x (1-locality) —
#   interconnect stretch: DCN contention, static multislice toll, GPU
#   locality tiers), ``straggler`` (speed x locality x (1-slow) — the
#   gang running at a degraded chip's rate, faults/), ``overhead``
#   (modeled restart/migration/restore burn, including priced
#   checkpoint writes).
#
# The analyzer (obs/analyze.py) re-declares these names — the obs layer
# never imports the sim package at module load; tests pin the two equal.
WAIT_CAUSES = (
    "admission", "capacity", "fault-outage", "net-outage", "policy-preempt"
)
RUN_LEGS = ("work", "policy-share", "net-degraded", "straggler", "overhead")


class JobState(enum.Enum):
    """Lifecycle states of a simulated job."""

    PENDING = "pending"        # submitted, waiting for its first/next allocation
    RUNNING = "running"        # holds an allocation, accruing progress
    SUSPENDED = "suspended"    # preempted with resume intent (Gandiva time-slice)
    DONE = "done"              # ran to completion (trace status Pass)
    FAILED = "failed"          # trace-declared failure surfaced at completion
    KILLED = "killed"          # trace-declared kill surfaced at completion
    REJECTED = "rejected"      # admission control: gang size never satisfiable
                               # on this cluster; excluded from JCT aggregates

END_STATES = (JobState.DONE, JobState.FAILED, JobState.KILLED, JobState.REJECTED)

# Hoisted for Job.advance's hot path: the enum attribute lookup is not free
# at millions of calls per replay.
_RUNNING = JobState.RUNNING

# Map of trace-declared completion statuses (Philly schema, SURVEY.md §5
# "Failure detection": a faithful replayer must handle failed/killed jobs) to
# the terminal JobState a job enters once its trace duration has elapsed.
STATUS_TO_END_STATE = {
    "Pass": JobState.DONE,
    "Failed": JobState.FAILED,
    "Killed": JobState.KILLED,
}


@dataclass(slots=True)
class Job:
    """A single trace job.

    Parameters mirror one trace row; everything after ``status`` is runtime
    state owned by the simulation engine.

    ``slots=True``: a million-job trace holds a million of these
    alive for the whole replay, and the per-instance ``__dict__`` roughly
    doubled the footprint; slots also shave the attribute loads off
    :meth:`advance`, the engine's hottest method.  Every runtime attribute
    is a declared field — policies get the ``sched`` dict for scratch
    state, never ad-hoc attributes.
    """

    job_id: str
    submit_time: float
    num_chips: int                      # requested gang size, in TPU chips
    duration: float                     # total service time (s) at requested size
    model_name: str = "transformer-tiny"
    iterations: Optional[int] = None    # optional iteration count (Optimus uses it)
    status: str = "Pass"                # trace-declared outcome: Pass|Failed|Killed
    user: str = ""                      # submitting user/vc (Philly has VCs)
    utilization: float = 1.0            # profiled device utilization in [0,1];
                                        # Gandiva's packing signal (SURVEY.md §3.3)
    sp: int = 1                         # declared sequence-parallel factor: one
    tp: int = 1                         # model replica spans sp*tp*pp chips,
    pp: int = 1                         # and goodput curves resolve to the
                                        # @sp{s}tp{t} / @sp{s}tp{t}pp{p} cache
                                        # variant when set (parallelism-aware
                                        # curves get a policy consumer; pp
                                        # mirrors the profiler's
                                        # pipeline-mesh keys)
    ckpt_interval: Optional[float] = None
                                        # work-seconds between checkpoints; a
                                        # fault rolls progress back to the last
                                        # multiple (None -> the fault plan's
                                        # RecoveryModel default, faults/)

    # ---- priced recovery (engine-armed from the fault plan, faults/) ----
    ckpt_write_s: float = 0.0           # seconds one periodic checkpoint write
                                        # takes (0 = free writes, the historical
                                        # model; advance() folds the cost into
                                        # the overhead leg when > 0)
    ckpt_every: float = math.inf        # work-seconds between priced writes
                                        # (the resolved checkpoint interval;
                                        # inf with ckpt_write_s=0 keeps the
                                        # write branch cold)
    ckpt_protected: Optional[float] = None
                                        # emergency-checkpoint watermark: work
                                        # protected by the newest warned spot
                                        # checkpoint — the rollback floor rises
                                        # to max(periodic multiple, this)

    # ---- runtime accounting (engine-owned) ----
    state: JobState = JobState.PENDING
    executed_work: float = 0.0          # reference-speed seconds of work done
    attained_service: float = 0.0       # chip-seconds of service received
    speed: float = 0.0                  # policy-set progress rate (0 unless RUNNING)
    locality_factor: float = 1.0        # allocation-quality multiplier set by the
                                        # engine from the granted placement: 1.0 on
                                        # TPU slices (contiguous by construction),
                                        # <1.0 for scattered GPU gangs (NVLink vs
                                        # PCIe vs cross-switch, cluster/gpu.py)
    slow_factor: float = 1.0            # straggler multiplier (faults/): the min
                                        # residual rate over the gang's chips —
                                        # a synchronous gang runs at its slowest
                                        # chip's rate; engine-set from the
                                        # cluster's degrade mask on every bind
    overhead_remaining: float = 0.0     # modeled restart cost still to burn (s)
    allocation: Optional[Any] = None    # cluster allocation handle when RUNNING
    allocated_chips: int = 0            # chips currently held (elastic != num_chips)

    first_start_time: Optional[float] = None
    end_time: Optional[float] = None
    last_update_time: float = 0.0       # progress integrated up to this sim time
    preempt_count: int = 0
    migration_count: int = 0
    fault_count: int = 0                # revocations by hardware faults (faults/)
    lost_work: float = 0.0              # reference-speed seconds rolled back to
                                        # the last checkpoint by fault revocations
    lost_service: float = 0.0           # chip-seconds attributed to rolled-back
                                        # work (goodput decomposition: the share
                                        # of attained_service that produced work
                                        # a fault later erased)
    overhead_service: float = 0.0       # chip-seconds spent burning
                                        # overhead_remaining (modeled restart /
                                        # migration / restore cost) while holding
                                        # chips — the decomposition's third leg
    epoch: int = 0                      # invalidates stale scheduled completions
    arrival_seq: int = 0                # submit-order index assigned by the engine
                                        # (numeric FIFO tie-break; 'j2' < 'j10')
    run_seq: int = 0                    # monotonic ticket stamped at every gang
                                        # start: the engine's running
                                        # set iterates in insertion order, which
                                        # is ascending run_seq — so any indexed
                                        # subset (fault victims, multislice
                                        # members) can reproduce the exact sweep
                                        # order of a full running-set scan by
                                        # sorting on this ticket

    # ---- causal attribution (engine-owned) ----
    # None keeps the attribution-off path allocation-free and byte-
    # identical; the engine sets it to {} when attribution is armed and
    # legs (WAIT_CAUSES / RUN_LEGS keys, exact cumulative seconds) appear
    # lazily as they first accrue.
    attrib: Optional[Dict[str, float]] = None
    blame_cause: Optional[str] = None   # cause of the open queued interval
    blame_since: float = 0.0            # when that interval started

    # scratch space for policies (queue index, profiling state, ...)
    sched: dict = field(default_factory=dict)

    # what-if placement pin: a per-job allocation hint the
    # engine merges into every try_start for this job — how an injected
    # "admit this job WHERE?" candidate forces its placement.  None (the
    # default) keeps try_start's hint handling byte-identical.
    pin_hint: Optional[dict] = None

    # ------------------------------------------------------------------ #

    @property
    def remaining_work(self) -> float:
        """Reference-speed seconds of service still owed to this job."""
        return max(0.0, self.duration - self.executed_work)

    @property
    def finished(self) -> bool:
        return self.state in END_STATES

    @property
    def end_state(self) -> JobState:
        """Terminal state declared by the trace for when this job completes."""
        return STATUS_TO_END_STATE.get(self.status, JobState.DONE)

    @property
    def effective_speed(self) -> float:
        """Actual progress rate: policy speed degraded by placement
        quality and any straggler chip in the gang (x1.0 is exact, so
        straggler-free replays keep bit-identical floats)."""
        return self.speed * self.locality_factor * self.slow_factor

    def remaining_runtime(self) -> float:
        """Wall-clock seconds to completion at the current speed (inf if idle)."""
        # effective_speed inlined (same expression as the property, so the
        # division sees bit-identical floats) — this is called twice per
        # completion at fleet scale
        es = self.speed * self.locality_factor * self.slow_factor
        if es <= 0.0:
            return float("inf")
        t = self.overhead_remaining + self.remaining_work / es
        if self.ckpt_write_s > 0.0 and 0.0 < self.ckpt_every < math.inf:
            # priced checkpoint writes stretch the remaining wall time by
            # one write per ckpt_every work-seconds still owed — the same
            # split advance() integrates, so predictions land on the
            # completion instant instead of firing early and re-predicting
            t += self.remaining_work * (self.ckpt_write_s / self.ckpt_every)
        return t

    def _accrue_run_legs(self, a: Dict[str, float], e: float, span: float) -> None:
        """Charge one productive interval's RUN_LEGS split (work +
        policy-share + net-degraded + straggler) into the attribution
        dict — the four-leg arithmetic both :meth:`advance` branches
        (priced-checkpoint-write and plain) used to repeat verbatim
       .  Expressions and dict insertion order are
        identical to the historical inline copies, so every attribution
        snapshot stays byte-for-byte (pinned by the closure grid in
        tests/test_attrib.py)."""
        a["work"] = a.get("work", 0.0) + e * span
        if self.speed != 1.0:
            a["policy-share"] = (
                a.get("policy-share", 0.0) + (1.0 - self.speed) * span
            )
        if self.locality_factor != 1.0:
            a["net-degraded"] = (
                a.get("net-degraded", 0.0)
                + self.speed * (1.0 - self.locality_factor) * span
            )
        if self.slow_factor != 1.0:
            a["straggler"] = (
                a.get("straggler", 0.0)
                + self.speed * self.locality_factor
                * (1.0 - self.slow_factor) * span
            )

    def advance(self, now: float) -> None:
        """Integrate progress from ``last_update_time`` to ``now``.

        Overhead (modeled suspend/resume or migration cost) is burned first at
        wall-clock rate; only the remainder of the interval accrues work and
        attained service.

        This is the engine's hottest method (every running job, every
        event batch): the running-state constant is hoisted and the
        effective-speed product inlined (same expression as the property,
        so every float is bit-identical) to keep the per-call overhead
        down at Philly scale.

        The arithmetic is **segment-exact for any ``dt``**: between two
        engine mutations a running job's rates are constant, so one call
        spanning the whole gap computes the same reals as v1's
        chunk-per-batch calls (the floats differ only in summation
        order).  The v2 accounting mode leans on exactly this
        — it skips the per-batch sweep and advances each job lazily at
        its next mutation/read point, under the closure (not
        byte-identity) contract.
        """
        dt = now - self.last_update_time
        if dt < 0:
            raise ValueError(
                f"time went backwards for {self.job_id}: {self.last_update_time} -> {now}"
            )
        self.last_update_time = now
        if self.state is not _RUNNING or dt == 0.0:
            return
        if self.overhead_remaining > 0.0:
            burned = min(self.overhead_remaining, dt)
            self.overhead_remaining -= burned
            # chips are occupied but produce no work while overhead burns:
            # the restart-overhead leg of the goodput decomposition
            self.overhead_service += self.allocated_chips * burned
            if self.attrib is not None:
                self.attrib["overhead"] = self.attrib.get("overhead", 0.0) + burned
            dt -= burned
        if dt > 0.0:
            if self.ckpt_write_s > 0.0 and 0.0 < self.ckpt_every < math.inf:
                # Priced checkpoint writes (faults/recovery.py): the job
                # alternates ckpt_every work-seconds of progress with one
                # ckpt_write_s write, so the steady-state write share of
                # wall time is e*w / (every + e*w) at effective speed e.
                # The write share occupies chips without producing work —
                # the overhead leg — exactly like restore burn.  Gated on
                # the knob so free-write replays keep the branchless
                # arithmetic below bit for bit.
                e = self.effective_speed
                write = dt * (e * self.ckpt_write_s) / (
                    self.ckpt_every + e * self.ckpt_write_s
                )
                run = dt - write
                self.executed_work += e * run
                self.attained_service += self.allocated_chips * run
                self.overhead_service += self.allocated_chips * write
                if self.attrib is not None:
                    a = self.attrib
                    a["overhead"] = a.get("overhead", 0.0) + write
                    self._accrue_run_legs(a, e, run)
                return
            e = self.speed * self.locality_factor * self.slow_factor
            self.executed_work += e * dt
            self.attained_service += self.allocated_chips * dt
            if self.attrib is not None:
                # RUN_LEGS split of this productive interval: work +
                # policy-share + net-degraded + straggler == dt in real
                # arithmetic (s*l*f + (1-s) + s*(1-l) + s*l*(1-f) == 1);
                # the decomposition's own ordered sum absorbs the float
                # dust
                self._accrue_run_legs(self.attrib, e, dt)

    def jct(self) -> Optional[float]:
        """Job completion time (end - submit), once finished."""
        if self.end_time is None:
            return None
        return self.end_time - self.submit_time

    def queueing_delay(self) -> Optional[float]:
        """Delay between submission and first start."""
        if self.first_start_time is None:
            return None
        return self.first_start_time - self.submit_time

    def slowdown(self) -> Optional[float]:
        """JCT relative to a dedicated-cluster run (the trace duration at
        the requested gang).  1.0 = ran immediately with no interference;
        the fairness policies (Themis) minimize the tail of this ratio."""
        j = self.jct()
        if j is None:
            return None
        return j / max(self.duration, 1e-9)

    def __repr__(self) -> str:  # compact for debugging/log lines
        return (
            f"Job({self.job_id}, chips={self.num_chips}, state={self.state.value}, "
            f"work={self.executed_work:.1f}/{self.duration:.1f})"
        )
