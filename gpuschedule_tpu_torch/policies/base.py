"""Policy interface.

The port's own copy of ``gpuschedule_tpu/policies/base.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

A policy is invoked by the engine after every event batch (arrival,
completion, or a wakeup the policy itself requested) and manipulates jobs
exclusively through the engine API — ``sim.try_start`` / ``sim.preempt`` /
``sim.set_speed`` / ``sim.migrate`` / ``sim.resize`` — which is the same
contract as the reference's per-policy ``*_sim_jobs`` loops acting on the
global JOBS/CLUSTER singletons (SURVEY.md §3.1), minus the globals.
"""

from __future__ import annotations

from typing import Dict, Optional


class Policy:
    """Base class for scheduling policies."""

    name: str = "base"

    #: Progress-read declaration (v2 accounting).  True (the
    #: safe default) means ``schedule()`` may read running jobs'
    #: *integrated* progress state — ``executed_work`` /
    #: ``attained_service`` / ``remaining_work`` / ``remaining_runtime``
    #: — so the v2 engine must sync the accounting ledger before every
    #: policy pass.  A policy that only inspects pending jobs and
    #: cluster state (FIFO) sets False and the v2 engine skips the
    #: per-batch sweep entirely: jobs then integrate lazily at their
    #: next mutation.  Irrelevant under v1 (the default accounting),
    #: which always advances every running job every batch.
    reads_progress: bool = True

    #: Machine-parseable cause codes: maps each human-readable
    #: ``explain()`` rule string to a short stable token.  When a run is
    #: captured with attribution armed (``MetricsLog(attribution=True)``),
    #: every rationale record additionally carries
    #: ``code = "<policy>/<token>"`` — the key the analyzer's blame
    #: tables group preemptions by.  The tokens are a compatibility
    #: surface: renaming a rule string must keep its token.
    rule_codes: Dict[str, str] = {}

    def attach(self, sim) -> None:
        """Called once before the run starts; override for setup that needs
        the cluster/trace (e.g. Tiresias queue thresholds)."""

    # ------------------------------------------------------------------ #
    # scheduling-rationale channel (obs layer)

    def explaining(self, sim) -> bool:
        """True when rationale records should be built for this run — i.e.
        the structured event stream is on.  Policies hoist this check once
        per ``schedule()`` call so the disabled path never constructs a
        rationale dict (the tools/check_overhead.py zero-overhead
        contract).  Also latches whether this run wants machine-parseable
        cause codes stamped on rationale records (attribution armed) —
        off-path streams must stay byte-identical, so ``explain()`` adds
        the ``code`` field only then."""
        self._stamp_codes = bool(getattr(sim.metrics, "attribution", False))
        return sim.metrics.record_events

    def cause_code(self, rule: str) -> str:
        """The stable machine-parseable token for a rule:
        ``<policy>/<rule_codes[rule]>`` (falling back to the rule string
        itself for rules without a table entry)."""
        return f"{self.name}/{self.rule_codes.get(rule, rule)}"

    def explain(self, rule: str, **detail) -> dict:
        """One scheduling-rationale record: which rule fired and the numbers
        behind it (queue rank, quantum age, goodput delta, ...).  Passed as
        the ``why=`` argument of the engine's mutation API, which persists
        it on the corresponding event in the run's event stream.  Under
        attribution the record leads with its ``code`` so blame tables
        never have to parse the human-readable rule text."""
        d = {"policy": self.name, "rule": rule}
        if getattr(self, "_stamp_codes", False):
            d["code"] = self.cause_code(rule)
        d.update(detail)
        return d

    def on_fault(self, sim, fault, victims) -> None:
        """React to a hardware fault (faults/) at ``sim.now``.

        The engine has already done the mechanical recovery before this is
        called: ``fault.scope`` is marked unhealthy on the cluster and every
        running gang overlapping it has been revoked — progress rolled back
        to its last checkpoint, restore cost charged, job requeued as
        PENDING (``victims`` lists them).  The default is exactly that
        requeue: victims wait in the queue like any other pending job and
        the next ``schedule()`` pass (the engine runs one after every fault
        batch) places them when capacity allows.

        Override to react beyond requeueing — e.g. Gandiva migrates running
        jobs away from a degraded pod.  Implementations may use the full
        engine mutation API; ``sim.cluster`` already reflects the outage.

        Straggler onsets (``fault.kind == "straggler"``) also arrive
        here: nothing is revoked (``victims`` is empty) but gangs on the
        degraded unit are already slowed — Gandiva migrates them off.
        """

    def on_hazard(self, sim, job, exposure: float) -> None:
        """React to a running gang whose failure exposure crossed the
        fault plan's ``migrate_threshold`` (faults/hazard.py).

        ``exposure`` combines the gang's lost straggler rate
        (``1 - job.slow_factor``) with its relative hazard heat (how much
        hotter than the fleet mean its pods run).  The engine offers a
        priced **checkpoint-then-migrate**: the default accepts —
        :meth:`Simulator.proactive_migrate` takes a checkpoint (raising
        the rollback floor to the current watermark), pays the write +
        restore cost as overhead, and moves the gang to a strictly
        clean allocation (``avoid_degraded="strict"``; no clean box →
        no move, no cost).  Override to decline (``pass``) or to react
        differently; the ``proactive-migrate`` rationale rides the
        migrate event either way so avoided-loss is measurable against
        lost-work in the fault panel.
        """
        why = (
            self.explain("proactive-migrate", exposure=round(exposure, 6))
            if self.explaining(sim) else None
        )
        sim.proactive_migrate(job, exposure=exposure, why=why)

    def on_warning(self, sim, fault, victims) -> None:
        """React to a spot pre-revoke notice (faults/) at ``sim.now``.

        ``fault`` is the upcoming revocation record (``fault.time`` is
        when it lands) and ``victims`` the running jobs that would be
        revoked right now.  The engine has already taken the emergency
        checkpoints the recovery model allows; the default is to do
        nothing more.  Override to act on the notice — e.g. migrate the
        gang off the spot unit before the revocation lands.
        """

    def schedule(self, sim) -> Optional[float]:
        """Make scheduling decisions at ``sim.now``.

        Returns an optional absolute sim time at which the policy wants to be
        woken even if no arrival/completion occurs (time-slice quanta,
        periodic rounds).  Return ``None`` for purely event-driven policies.
        """
        raise NotImplementedError
