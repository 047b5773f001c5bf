"""Themis-style finish-time fairness (beyond reference parity).

The port's own copy of ``gpuschedule_tpu/policies/themis.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.

The reference's policy set stops at Optimus (SURVEY.md §2 lists five
policies); this sixth policy is a round-based finish-time-fairness
scheduler in the spirit of Themis (Mahajan et al., NSDI'20), adapted to
gang trace-replay.  Each round every active job is scored by its
projected *slowdown*

    rho(job, t) = projected_finish / ideal_jct
                = ((t - submit) + overhead_remaining + remaining/rate)
                  / duration

— the completion time the job would see if granted its full gang right
now, relative to a dedicated-cluster run (its trace duration at the
requested chip count).  The cluster then runs the highest-rho prefix
that fits, via the same gang-aware prefix-preemption step SRTF and
Tiresias use (policies/preemptive.py).

Fairness intuition: rho >= 1 always.  A freshly submitted job starts at
rho = 1 and a waiting job's rho grows at rate 1/duration — so a short
job's urgency climbs fast (it has the most to lose, proportionally,
from every second of queueing) but it can never starve a long job
indefinitely: the long job's accumulated wait eventually dominates any
newcomer's.  That min-max-slowdown behavior is the deliberate contrast
to SRTF (min *mean* JCT, starvation-prone under a stream of short
arrivals — the JAX package's tests/test_themis.py pins the contrast) and is what the
p95_slowdown / max_slowdown summary metrics (sim/metrics.py) measure.

Round-based (default 300 s, the paper's auction-round scale): rho
drifts continuously even when no event fires, so a purely event-driven
policy would never revisit its ordering between arrivals; the round
wakeup bounds how stale the ordering can get.  Preemption uses
``suspend=False`` (the Tiresias/SRTF demotion path) and charges
``restart_overhead`` on resume like the other preemptive policies —
pass ``"auto"`` to derive it from model size and slice shape.
"""

from __future__ import annotations

from typing import Optional

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.policies.preemptive import (
    PRIORITY_RULE_CODES,
    active_jobs,
    apply_priority_schedule,
)
from gpuschedule_tpu_torch.sim.job import Job, JobState

_EPS = 1e-9


def finish_time_rho(job: Job, now: float) -> float:
    """Projected slowdown if ``job`` ran its full gang from ``now`` on.

    Running jobs project at their current effective speed (packing or
    locality degradation makes their finish later, raising rho — a
    degraded job becomes *more* urgent, not less); pending/suspended
    jobs project at full reference speed, which is what ``try_start``
    grants (engine.try_start defaults speed=1.0).
    """
    ideal = max(job.duration, _EPS)
    if job.state is JobState.RUNNING and job.effective_speed > 0.0:
        rate = job.effective_speed
    else:
        rate = 1.0
    projected = (
        (now - job.submit_time)
        + job.overhead_remaining
        + job.remaining_work / rate
    )
    return projected / ideal


class ThemisPolicy(Policy):
    name = "themis"

    # shared prefix-preemption cause codes (attribution layer)
    rule_codes = PRIORITY_RULE_CODES

    def __init__(
        self,
        *,
        round_s: float = 300.0,
        hysteresis: float = 0.05,
        restart_overhead: float | str = 0.0,
    ):
        if not round_s > 0.0:
            raise ValueError(f"round_s must be > 0, got {round_s}")
        if hysteresis < 0.0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.round_s = float(round_s)
        self.hysteresis = float(hysteresis)
        self.restart_overhead = restart_overhead
        self._next_tick: Optional[float] = None

    def attach(self, sim) -> None:
        self._next_tick = None

    def schedule(self, sim) -> Optional[float]:
        jobs = active_jobs(sim)
        if not jobs:
            self._next_tick = None
            return None
        now = sim.now
        # A waiting job's rho always outgrows a running one's (the runner's
        # projected finish is fixed while the waiter's recedes), so a bare
        # rho ordering churns allocations at every event — the thrash the
        # paper's leases exist to stop.  The incumbent-retention boost is
        # the lease in rho terms: a challenger must beat a runner by
        # ``hysteresis`` (relative), not merely tie past it.
        h = 1.0 + self.hysteresis
        ordered = sorted(
            jobs,
            key=lambda j: (
                -finish_time_rho(j, now)
                * (h if j.state is JobState.RUNNING else 1.0),
                j.arrival_seq,
            ),
        )
        apply_priority_schedule(
            sim, ordered, restart_overhead=self.restart_overhead,
            policy=self,
            detail_fn=lambda j: {"rho": round(finish_time_rho(j, now), 4)},
        )
        # One outstanding tick, ever: the engine arms a _TICK for every
        # non-None return with no dedup (engine.run), and each tick
        # re-invokes schedule() — returning now + round_s unconditionally
        # would let every arrival/completion event spawn its own
        # self-perpetuating tick chain, O(events x horizon / round_s)
        # sorts on a Philly-scale replay.  Re-arm only once the armed
        # tick has fired (or was never armed).
        if self._next_tick is not None and self._next_tick > now + sim.eps:
            return None
        self._next_tick = now + self.round_s
        return self._next_tick
