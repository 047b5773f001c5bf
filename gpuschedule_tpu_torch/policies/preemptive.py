"""Shared machinery for priority-driven preemptive policies.

The port's own copy of ``gpuschedule_tpu/policies/preemptive.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

SRTF and Tiresias-DLAS both reduce to the same step each time the engine
wakes them (SURVEY.md §3.1: "preempt lower-queue jobs if needed,
gang-aware"): order the active jobs by policy priority, make the running set
equal the longest prefix that fits the cluster, preempting losers and
gang-starting winners.  The helper here implements that step once.

Capacity planning is chip-count based (strict priority: a high-priority gang
reserves its chips even while geometry search for it fails), while actual
grants go through ``cluster.allocate`` so slice-shape constraints always
hold.  A winner whose box cannot be carved this round simply stays pending —
its reservation still throttles lower-priority jobs, which is what keeps
large gangs from starving on a fragmented pod.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from gpuschedule_tpu_torch.sim.job import Job, JobState
from gpuschedule_tpu_torch.sim.overhead import resolve_overhead

# Machine-parseable cause codes for the two rationale rules this
# shared prefix-preemption step emits; every policy built on it (SRTF /
# DLAS / Themis) adopts the table so blame analysis sees the same stable
# tokens whichever priority currency ranked the prefix.
PRIORITY_RULE_CODES = {
    "displaced-by-priority-prefix": "displace",
    "priority-prefix": "start",
}


def apply_priority_schedule(
    sim,
    ordered: Sequence[Job],
    *,
    restart_overhead: float | str = 0.0,
    policy=None,
    detail_fn: Optional[Callable[[Job], dict]] = None,
) -> None:
    """Make the running set match the highest-priority prefix that fits.

    ``ordered`` lists schedulable jobs (PENDING/SUSPENDED/RUNNING), highest
    priority first.  ``restart_overhead`` seconds are charged to a job that
    resumes after having run before (modeled checkpoint/restore, SURVEY.md
    §5 "Checkpoint / resume"); pass ``"auto"`` to derive the cost from the
    job's model size and slice shape (sim/overhead.py).

    When ``policy`` is given and the run records events, every start /
    preempt carries a rationale record (``Policy.explain``): the job's rank
    in ``ordered`` plus whatever ``detail_fn(job)`` adds (the policy's
    priority currency — remaining time, queue index, rho).  Rationale
    construction is skipped entirely otherwise.
    """
    budget = sim.cluster.total_chips
    keep: List[Job] = []
    for job in ordered:
        if job.num_chips <= budget:
            keep.append(job)
            budget -= job.num_chips
    keep_ids = {id(j) for j in keep}

    expl = None
    if policy is not None and policy.explaining(sim):
        ranks = {id(j): r for r, j in enumerate(ordered)}

        def expl(job: Job, rule: str) -> dict:
            detail = detail_fn(job) if detail_fn is not None else {}
            return policy.explain(rule, rank=ranks.get(id(job)), **detail)

    # Preempt running losers first so their chips are free for winners.
    for job in list(sim.running):
        if id(job) not in keep_ids:
            sim.preempt(
                job, suspend=False,
                why=expl(job, "displaced-by-priority-prefix") if expl else None,
            )

    # Gang-start winners in priority order; geometry failures skip (the
    # budget reservation above already throttled lower priorities).
    for job in keep:
        if job.state is JobState.RUNNING:
            continue
        overhead = (
            resolve_overhead(restart_overhead, job, sim.cluster)
            if job.executed_work > 0.0
            else 0.0
        )
        sim.try_start(
            job, overhead=overhead,
            why=expl(job, "priority-prefix") if expl else None,
        )


def active_jobs(sim) -> List[Job]:
    """All jobs currently competing for the cluster."""
    return [j for j in sim.pending + sim.running if not j.finished]
