"""FIFO: non-preemptive gang scheduling in arrival order.

The port's own copy of ``gpuschedule_tpu/policies/fifo.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

Head-of-line blocking is intentional and part of the policy's definition
(SURVEY.md §2 "Policy: FIFO": "Non-preemptive gang scheduling in arrival
order; head-of-line blocks"): if the oldest pending job's gang cannot be
placed, nothing behind it starts, which is what makes FIFO the baseline the
preemptive policies beat.  A ``backfill=True`` variant relaxes that for
comparison runs.
"""

from __future__ import annotations

from typing import Optional

from gpuschedule_tpu_torch.policies.base import Policy


class FifoPolicy(Policy):
    name = "fifo"

    # FIFO (both variants) orders by submit_time alone and never inspects
    # a running job's integrated progress — the v2 accounting engine may
    # skip the per-batch sweep (sim/ledger.py)
    reads_progress = False

    # stable cause-code tokens for the attribution layer
    rule_codes = {
        "arrival-order-head": "head",
        "backfill": "backfill",
    }

    def __init__(self, *, backfill: bool = False):
        self.backfill = backfill

    def schedule(self, sim) -> Optional[float]:
        # ``sim.pending`` iterates in arrival order by construction (jobset.py
        # invariant; FIFO never preempts, so no job is ever re-appended out of
        # order) — no per-event sort.
        ex = self.explaining(sim)
        if not self.backfill:
            # Head-of-line: peek the oldest pending job; each successful start
            # removes it from the set, so this is O(1) per start and O(1) per
            # blocked event — no snapshot of a possibly-huge backlog.
            while sim.pending:
                job = sim.pending[0]
                why = (
                    self.explain(
                        "arrival-order-head",
                        waited_s=round(sim.now - job.submit_time, 3),
                    )
                    if ex else None
                )
                if not sim.try_start(job, why=why):
                    break  # head-of-line blocks
            return None
        for job in list(sim.pending):  # backfill scans past blocked heads
            why = (
                self.explain(
                    "backfill",
                    waited_s=round(sim.now - job.submit_time, 3),
                )
                if ex else None
            )
            sim.try_start(job, why=why)
        return None
