"""Tiresias-DLAS: discretized least-attained-service MLFQ.

The port's own copy of ``gpuschedule_tpu/policies/dlas.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The Tiresias scheduler (NSDI'19, the algorithm the reference implements per
SURVEY.md §2 "Policy: Tiresias LAS/DLAS") prioritizes jobs by how little
**attained service** (chip-seconds = gang size x run time) they have
consumed, discretized into a small number of queues so that long jobs are
not perpetually reshuffled:

- a job enters the highest-priority queue (Q0) and is demoted to the next
  queue each time its attained service crosses a configured threshold
  (quantum expiry);
- scheduling is strict priority across queues, FIFO within a queue,
  gang-aware and preemptive;
- a starving job — one that has waited longer than ``promote_ratio`` times
  its executed time since it last ran — is promoted back to Q0, with its
  service counter offset so it re-earns its demotions (the anti-starvation
  knob).

Demotions and promotions are event-exact: the policy computes the next
threshold-crossing / promote-eligibility instant and asks the engine for a
wakeup then, instead of polling on a fixed delta (the engine's event-driven
departure from the reference's stepped loops, engine.py module docstring).
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.policies.preemptive import (
    PRIORITY_RULE_CODES,
    active_jobs,
    apply_priority_schedule,
)
from gpuschedule_tpu_torch.sim.job import Job, JobState

# Default queue thresholds in chip-seconds: Q0 -> Q1 after one chip-hour,
# Q1 -> Q2 after ten chip-hours (Tiresias uses coarse exponential bands).
DEFAULT_THRESHOLDS = (3600.0, 36000.0)


class DlasPolicy(Policy):
    name = "dlas"

    # shared prefix-preemption cause codes (attribution layer)
    rule_codes = PRIORITY_RULE_CODES

    def __init__(
        self,
        *,
        thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
        promote_ratio: float = 2.0,
        restart_overhead: float = 0.0,
    ):
        self.thresholds = sorted(float(t) for t in thresholds)
        if any(t <= 0 for t in self.thresholds):
            raise ValueError(f"thresholds must be positive: {self.thresholds}")
        self.promote_ratio = promote_ratio
        self.restart_overhead = restart_overhead

    # ------------------------------------------------------------------ #

    def _effective_service(self, job: Job) -> float:
        """Attained service since the last promotion (offset resets demotions)."""
        return job.attained_service - job.sched.get("dlas_offset", 0.0)

    def _queue(self, job: Job) -> int:
        return bisect.bisect_right(self.thresholds, self._effective_service(job))

    def _maybe_promote(self, job: Job, now: float) -> None:
        if job.state is not JobState.PENDING or job.executed_work <= 0.0:
            return
        waited = now - job.sched.get("dlas_last_run", job.submit_time)
        if waited >= self.promote_ratio * job.executed_work and self._queue(job) > 0:
            job.sched["dlas_offset"] = job.attained_service
            job.sched["dlas_promotions"] = job.sched.get("dlas_promotions", 0) + 1

    # ------------------------------------------------------------------ #

    def schedule(self, sim) -> Optional[float]:
        now = sim.now
        # Jobs running as of this event have been served up to now; stamp
        # before any preemption so a victim's waiting clock starts at now.
        for job in sim.running:
            job.sched["dlas_last_run"] = now

        jobs = active_jobs(sim)
        for job in jobs:
            self._maybe_promote(job, now)

        ordered = sorted(jobs, key=lambda j: (self._queue(j), j.arrival_seq))
        apply_priority_schedule(
            sim, ordered, restart_overhead=self.restart_overhead,
            policy=self,
            # which MLFQ band put the job here, and the service that earned
            # it (quantum expiry = a higher queue index than last round)
            detail_fn=lambda j: {
                "queue": self._queue(j),
                "service_chip_s": round(self._effective_service(j), 1),
                "promotions": j.sched.get("dlas_promotions", 0),
            },
        )

        # Jobs (re)started this round are also "last seen running now".
        for job in sim.running:
            job.sched["dlas_last_run"] = now

        return self._next_wakeup(sim, now)

    def _next_wakeup(self, sim, now: float) -> Optional[float]:
        """Earliest future demotion or promotion instant.

        Wakeups overshoot the analytic crossing time by 2x the engine's eps:
        attained service is integrated across multiple advance() segments,
        so at the exact instant the accumulated value can sit a few ulps
        below the threshold — the queue would not change and the re-armed
        wakeup (now + tiny) would be silently dropped by request_wakeup's
        eps guard, losing the demotion tick entirely.
        """
        slack = 2.0 * sim.eps
        candidates = []
        for job in sim.running:
            eff = self._effective_service(job)
            i = bisect.bisect_right(self.thresholds, eff)
            if i < len(self.thresholds) and job.allocated_chips > 0:
                dt = (self.thresholds[i] - eff) / job.allocated_chips
                candidates.append(now + job.overhead_remaining + dt + slack)
        for job in sim.pending:
            if job.executed_work > 0.0 and self._queue(job) > 0:
                t = (
                    job.sched.get("dlas_last_run", job.submit_time)
                    + self.promote_ratio * job.executed_work
                )
                if t > now:
                    candidates.append(t + slack)
        return min(candidates) if candidates else None
