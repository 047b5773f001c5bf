"""SRTF: preemptive shortest-remaining-time-first.

The port's own copy of ``gpuschedule_tpu/policies/srtf.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The reference's SRTF/SJF uses known (trace-declared) remaining time to order
jobs and preempts running work when a shorter job arrives (SURVEY.md §2
"Policy: SRTF/SJF").  Remaining time here is ``job.remaining_work`` — the
trace duration minus executed work — which is exactly what a simulator knows
and what the optimality argument (exchange argument on any two jobs sharing
a resource) is stated over.

Ties break on arrival order so equal-length jobs never thrash.
"""

from __future__ import annotations

from typing import Optional

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.policies.preemptive import (
    PRIORITY_RULE_CODES,
    active_jobs,
    apply_priority_schedule,
)


class SrtfPolicy(Policy):
    name = "srtf"

    # shared prefix-preemption cause codes (attribution layer)
    rule_codes = PRIORITY_RULE_CODES

    def __init__(self, *, restart_overhead: float = 0.0):
        self.restart_overhead = restart_overhead

    def schedule(self, sim) -> Optional[float]:
        ordered = sorted(
            active_jobs(sim),
            key=lambda j: (j.remaining_work, j.arrival_seq),
        )
        apply_priority_schedule(
            sim, ordered, restart_overhead=self.restart_overhead,
            policy=self,
            detail_fn=lambda j: {"remaining_s": round(j.remaining_work, 3)},
        )
        return None
