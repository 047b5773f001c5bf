"""Gandiva: time-slicing, packing, and migration-for-defrag.

The port's own copy of ``gpuschedule_tpu/policies/gandiva.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.

The three Gandiva mechanisms (OSDI'18; SURVEY.md §3.3) re-targeted to
slice-shaped TPU allocations:

- **Time-slicing**: when demand exceeds capacity, running and waiting jobs
  rotate in rounds.  A job that has held its slice for a full round is
  suspended (preempt with resume intent) in favor of the longest-waiting
  job of a size that can use the freed chips; resuming burns
  ``suspend_overhead`` seconds of modeled checkpoint/restore cost through
  the engine's ``overhead_remaining`` mechanism (SURVEY.md §5
  "Checkpoint / resume": costs are modeled, not real).
- **Packing**: a waiting job may be *overlaid* onto a running job's slice
  (cluster overlay allocation) when both gangs are the same size and the
  sum of their profiled utilizations stays under ``pack_util_threshold``.
  If the pair fits under 1.0 they both run at full speed — the ideal
  Gandiva case; above 1.0 both are slowed proportionally.
- **Migration**: when a waiting gang is blocked purely by fragmentation
  (enough free chips, no contiguous box), running jobs are migrated —
  paying ``migration_overhead`` — toward the origin-packed first-fit
  layout until the box exists.  This exercises the engine's migrate path
  on real slice geometry.
- **Grow-shrink**: when nothing is waiting, running data-parallel jobs
  opportunistically *grow* into idle chips (slice-doubling, speed from the
  growth goodput curve); the moment demand returns they *shrink* back to
  their requested size so waiters see the chips (SURVEY.md §3.3
  "grow-shrink idle-GPU opportunistic expansion").

Round ticks are policy-requested wakeups; between ticks the policy is
purely event-driven.
"""

from __future__ import annotations

from typing import List, Optional

from gpuschedule_tpu_torch.policies.base import Policy
from gpuschedule_tpu_torch.profiler.goodput import GoodputCurve
from gpuschedule_tpu_torch.sim.job import Job, JobState
from gpuschedule_tpu_torch.sim.overhead import resolve_overhead

# Growth model for opportunistic expansion: near-linear DP scaling with a
# whisper of per-chip latency, same family Optimus fits (profiler/goodput).
DEFAULT_GROWTH_CURVE = GoodputCurve((1.0, 0.0, 1e-4))


class GandivaPolicy(Policy):
    name = "gandiva"

    # stable cause-code tokens (attribution layer): one per
    # rationale rule this policy emits, grouped by mechanism — time-slice
    # rotation, overlay packing, and migration
    rule_codes = {
        "quantum-expired": "quantum",
        "longest-waiting": "resume",
        "pack-low-utilization": "pack",
        "pack-contention": "pack-net",
        "pack-dissolved": "unpack",
        "evacuate-degraded-pod": "evacuate",
        "evacuate-straggler": "evacuate-slow",
        "defrag-for-blocked-waiter": "defrag",
        "shrink-for-demand": "shrink",
        "grow-into-idle": "grow",
    }

    def __init__(
        self,
        *,
        round_length: float = 300.0,
        suspend_overhead: float | str = 30.0,
        migration_overhead: float | str = 45.0,
        packing: bool = True,
        pack_util_threshold: float = 1.25,
        max_migrations_per_event: int = 2,
        grow_shrink: bool = True,
        grow_overhead: float = 1.0,
        growth_curve: Optional[GoodputCurve] = None,
    ):
        if round_length <= 0:
            raise ValueError("round_length must be positive")
        # Overhead knobs take a constant (seconds) or "auto": derive the
        # cost from the job's model size and slice shape (sim/overhead.py —
        # checkpoint costs parameterized per slice size).
        for knob in (suspend_overhead, migration_overhead):
            if knob != "auto":
                float(knob)
        self.round_length = round_length
        self.suspend_overhead = suspend_overhead
        self.migration_overhead = migration_overhead
        self.packing = packing
        self.pack_util_threshold = pack_util_threshold
        self.max_migrations_per_event = max_migrations_per_event
        self.grow_shrink = grow_shrink
        self.grow_overhead = grow_overhead
        self.growth_curve = growth_curve or DEFAULT_GROWTH_CURVE

    # ------------------------------------------------------------------ #
    # fault reaction (faults/): evacuate degraded pods

    def on_fault(self, sim, fault, victims) -> None:
        """Migrate running jobs off a degraded pod.

        A chip failure inside a pod both fragments it and signals elevated
        risk (maintenance windows and spot revocations take whole pods at
        once), so Gandiva — the one policy with a migration mechanism —
        proactively moves unpacked survivors on the faulted pod to the
        healthiest other pod that can hold their slice, paying the usual
        migration overhead.  Victims re-enter the wait queue stamped with
        the fault time, same as rotation victims (longest-waiting order
        stays meaningful under churn).  Single-pod fleets and non-TPU
        scopes have nowhere to evacuate to; the default requeue stands.
        """
        for v in victims:
            v.sched["g_wait_since"] = sim.now
        if getattr(fault, "kind", "") == "straggler":
            # nothing was revoked: gangs on the degraded chip are merely
            # slowed, and the one policy with a migration mechanism can
            # move them somewhere fast
            self._evacuate_stragglers(sim)
            return
        if fault.scope[0] not in ("chip", "box", "pod"):
            return
        cluster = sim.cluster
        if getattr(cluster, "num_pods", 1) <= 1 or not hasattr(
            cluster, "pod_free_chips"
        ):
            return
        pod = fault.scope[1]
        budget = self.max_migrations_per_event
        groups = self._overlay_groups(sim)
        ex = self.explaining(sim)
        for job in list(sim.running):
            if budget == 0:
                break
            geom = job.allocation.detail if job.allocation is not None else None
            if getattr(geom, "pod", None) != pod:
                continue  # multislice gangs (no .pod) stay put too
            if self._is_packed(sim, job, groups):
                continue
            targets = sorted(
                (p for p in range(cluster.num_pods) if p != pod),
                key=lambda p: -cluster.pod_free_chips(p),
            )
            for target in targets:
                if cluster.pod_free_chips(target) < job.allocated_chips:
                    break  # healthiest pod first: smaller ones won't fit either
                overhead = resolve_overhead(
                    self.migration_overhead, job, cluster, migration=True
                )
                why = (
                    self.explain(
                        "evacuate-degraded-pod",
                        pod=pod, target=target, fault=fault.kind,
                    )
                    if ex else None
                )
                if sim.migrate(
                    job, overhead=overhead, placement_hint={"pod": target},
                    why=why,
                ):
                    sim.metrics.count("fault_evacuations")
                    budget -= 1
                    break

    def _evacuate_stragglers(self, sim) -> None:
        """Migrate slowed gangs off straggler chips.

        A gang whose ``slow_factor`` dropped below 1.0 is paced by a
        degraded chip somewhere in its slice; moving it to another pod
        (healthiest first, the evacuate-degraded-pod target order)
        restores full rate for the usual migration overhead.  Packed
        groups and multislice gangs stay put, and single-pod fleets have
        nowhere to go — the slowdown stands (the engine's slow-factor
        re-derivation heals them on straggler recovery)."""
        cluster = sim.cluster
        if getattr(cluster, "num_pods", 1) <= 1 or not hasattr(
            cluster, "pod_free_chips"
        ):
            return
        budget = self.max_migrations_per_event
        groups = self._overlay_groups(sim)
        ex = self.explaining(sim)
        for job in list(sim.running):
            if budget == 0:
                break
            if job.slow_factor >= 1.0 or self._is_packed(sim, job, groups):
                continue
            geom = job.allocation.detail if job.allocation is not None else None
            pod = getattr(geom, "pod", None)
            if pod is None:
                continue  # multislice gangs stay put (whole-pod claims)
            targets = sorted(
                (p for p in range(cluster.num_pods) if p != pod),
                key=lambda p: -cluster.pod_free_chips(p),
            )
            for target in targets:
                if cluster.pod_free_chips(target) < job.allocated_chips:
                    break  # healthiest pod first: smaller ones won't fit either
                overhead = resolve_overhead(
                    self.migration_overhead, job, cluster, migration=True
                )
                why = (
                    self.explain(
                        "evacuate-straggler",
                        pod=pod, target=target,
                        slow=round(job.slow_factor, 4),
                    )
                    if ex else None
                )
                if sim.migrate(
                    job, overhead=overhead, placement_hint={"pod": target},
                    why=why,
                ):
                    sim.metrics.count("straggler_evacuations")
                    budget -= 1
                    break

    # ------------------------------------------------------------------ #

    def schedule(self, sim) -> Optional[float]:
        now = sim.now
        groups = self._overlay_groups(sim)
        if self.grow_shrink:
            self._shrink_for_demand(sim, now, groups)  # waiters reclaim idle growth
        self._rotate(sim, now, groups)
        self._start_waiters(sim, now)
        if self.packing:
            groups = self._overlay_groups(sim)
            self._pack_waiters(sim, now, groups)
            self._update_pack_speeds(sim)
        self._defrag(sim, now)
        self._start_waiters(sim, now)  # migration may have opened a box
        if self.grow_shrink and not sim.pending:
            self._grow_into_idle(sim)

        if sim.pending:
            # Anchor the next tick to the earliest *future* round end among
            # running jobs: a waiter arriving mid-round must trigger rotation
            # when the incumbent's round ends, not a full round_length after
            # the arrival.  Rounds already expired (victim not suspendable —
            # packed, or no waiter fits) must NOT anchor, or the tick would
            # land in the past and degenerate into an eps-spaced tick storm.
            groups = self._overlay_groups(sim)
            future_ends = [
                end
                for j in sim.running
                if not self._is_packed(sim, j, groups)
                for end in [j.sched.get("g_round_start", now) + self.round_length]
                if end > now + sim.eps
            ]
            return min(future_ends) if future_ends else now + self.round_length
        return None

    @staticmethod
    def _overlay_groups(sim) -> dict:
        getter = getattr(sim.cluster, "overlay_groups", None)
        return getter() if getter is not None else {}

    # ------------------------------------------------------------------ #
    # time-slicing

    def _waiters(self, sim) -> List[Job]:
        """Pending jobs, longest-waiting first (by when they last ran or
        arrived)."""
        return sorted(
            sim.pending, key=lambda j: (j.sched.get("g_wait_since", j.submit_time), j.arrival_seq)
        )

    def _rotate(self, sim, now: float, groups: dict) -> None:
        """Suspend jobs whose round expired while same-size work waits."""
        if not sim.pending:
            return
        min_waiting = min(j.num_chips for j in sim.pending)
        expired = [
            j
            for j in sim.running
            if now - j.sched.get("g_round_start", j.submit_time) >= self.round_length - sim.eps
            and not self._is_packed(sim, j, groups)
            # a victim is only useful if some waiter fits in what it frees
            and min_waiting <= j.allocated_chips
        ]
        # oldest rounds first; suspend at most one victim per distinct waiter
        expired.sort(key=lambda j: j.sched.get("g_round_start", 0.0))
        n_waiters = len(sim.pending)
        ex = self.explaining(sim)
        for job in expired[:n_waiters]:
            why = (
                self.explain(
                    "quantum-expired",
                    round_age_s=round(
                        now - job.sched.get("g_round_start", job.submit_time), 3
                    ),
                    round_length_s=self.round_length,
                    waiters=n_waiters,
                )
                if ex else None
            )
            sim.preempt(job, suspend=True, why=why)
            job.sched["g_wait_since"] = now

    def _resume_overhead(self, sim, job: Job) -> float:
        if job.executed_work <= 0.0:
            return 0.0  # first start: nothing to restore
        return resolve_overhead(self.suspend_overhead, job, sim.cluster)

    def _start_waiters(self, sim, now: float) -> None:
        ex = self.explaining(sim)
        for job in self._waiters(sim):
            why = (
                self.explain(
                    "longest-waiting",
                    waited_s=round(
                        now - job.sched.get("g_wait_since", job.submit_time), 3
                    ),
                )
                if ex else None
            )
            if sim.try_start(job, overhead=self._resume_overhead(sim, job), why=why):
                job.sched["g_round_start"] = now

    # ------------------------------------------------------------------ #
    # packing

    @staticmethod
    def _is_packed(sim, job: Job, groups: dict) -> bool:
        if not groups or job.allocation is None:
            return False
        aid = job.allocation.alloc_id
        return aid in groups or any(aid in os for os in groups.values())

    def _pack_waiters(self, sim, now: float, groups: dict) -> None:
        if not hasattr(sim.cluster, "overlay_groups"):
            return
        for job in self._waiters(sim):
            if job.utilization >= 1.0:
                continue
            host = self._find_pack_host(sim, job, groups)
            if host is None:
                continue
            hint = {"overlay": host.allocation}
            # started at nominal speed; _update_pack_speeds (invoked right
            # after in the same schedule pass, zero sim time elapsing) is the
            # single owner of the contention model for packed groups
            overhead = self._resume_overhead(sim, job)
            why = (
                self.explain(
                    "pack-low-utilization",
                    host=host.job_id,
                    combined_util=round(host.utilization + job.utilization, 3),
                    threshold=self.pack_util_threshold,
                )
                if self.explaining(sim) else None
            )
            if sim.try_start(job, overhead=overhead, speed=1.0,
                             placement_hint=hint, why=why):
                job.sched["g_round_start"] = now
                sim.metrics.count("packings")
                groups = self._overlay_groups(sim)  # refresh: host now packed

    def _find_pack_host(self, sim, job: Job, groups: dict) -> Optional[Job]:
        """A running, unpacked job whose slice can host the waiter — same
        size or larger (sub-box overlay) — with combined utilization under
        the threshold (best = lowest combined).

        Gandiva's packing co-locates ANY low-util pair whose demand fits,
        not just equal sizes; the slice-geometry
        form is: a guest no bigger than the host's granted box shares its
        chips.  The contention model stays the utilization sum — slightly
        conservative for a smaller guest, which only occupies a sub-box of
        the host's slice."""
        best, best_u = None, self.pack_util_threshold
        for host in sim.running:
            # A grown host is never a pack target: packed jobs are exempt
            # from shrink/rotate, so packing one would lock its grown
            # excess away from waiters for the pack's whole lifetime.
            if (
                host.allocated_chips < job.num_chips
                or host.allocated_chips > host.num_chips
                or self._is_packed(sim, host, groups)
            ):
                continue
            combined = host.utilization + job.utilization
            if combined <= best_u:
                best, best_u = host, combined
        return best

    def _update_pack_speeds(self, sim) -> None:
        """Re-derive packed-group speeds (a partner may have finished)."""
        groups = self._overlay_groups(sim)  # {} on clusters without overlays
        by_alloc = {
            j.allocation.alloc_id: j for j in sim.running if j.allocation is not None
        }
        ex = self.explaining(sim)
        grouped_ids = set()
        for base, overlays in groups.items():
            members = [by_alloc[a] for a in [base, *overlays] if a in by_alloc]
            grouped_ids.update(j.allocation.alloc_id for j in members)
            combined = sum(j.utilization for j in members)
            factor = 1.0 if combined <= 1.0 else 1.0 / combined
            for j in members:
                # scale each member's entitled rate (growth speedup for a
                # grown host) — packing no longer erases a host's growth
                speed = self._nominal_speed(j) * factor
                if abs(j.speed - speed) > 1e-12:
                    why = (
                        self.explain(
                            "pack-contention",
                            combined_util=round(combined, 3),
                            group_size=len(members),
                        )
                        if ex else None
                    )
                    sim.set_speed(j, speed, why=why)
        # jobs no longer sharing: restore nominal speed (which is the growth
        # speedup for an opportunistically grown job, not necessarily 1.0)
        for j in sim.running:
            if j.allocation is not None and j.allocation.alloc_id not in grouped_ids:
                target = self._nominal_speed(j)
                if j.speed != target:
                    why = self.explain("pack-dissolved") if ex else None
                    sim.set_speed(j, target, why=why)

    # ------------------------------------------------------------------ #
    # migration / defrag

    def _defrag(self, sim, now: float) -> None:
        """If the head waiter is blocked purely by fragmentation, migrate
        running jobs toward the packed first-fit layout to open a box."""
        cluster = sim.cluster
        if not hasattr(cluster, "fragmentation"):
            return
        waiters = self._waiters(sim)
        if not waiters:
            return
        head = waiters[0]
        k = head.num_chips
        if k > cluster.free_chips or cluster.can_allocate(k):
            return  # not fragmentation-blocked
        budget = self.max_migrations_per_event
        # migrate smallest unpacked jobs first: cheapest moves, and small
        # slices are what shatters the free space.  A job already at its
        # first-fit position re-grants the same slice and migrate() returns
        # False with no cost charged (engine contract), so the loop walks on
        # to a job whose move actually compacts the layout.
        groups = self._overlay_groups(sim)
        movable = sorted(
            (j for j in sim.running if not self._is_packed(sim, j, groups)),
            key=lambda j: (j.allocated_chips, j.arrival_seq),
        )
        ex = self.explaining(sim)
        for job in movable:
            if budget == 0 or cluster.can_allocate(k):
                break
            overhead = resolve_overhead(
                self.migration_overhead, job, cluster, migration=True
            )
            why = (
                self.explain(
                    "defrag-for-blocked-waiter",
                    waiter=head.job_id,
                    waiter_chips=k,
                    free_chips=cluster.free_chips,
                )
                if ex else None
            )
            if sim.migrate(job, overhead=overhead, why=why):
                budget -= 1

    # ------------------------------------------------------------------ #
    # grow-shrink

    def _nominal_speed(self, job: Job) -> float:
        """Progress rate a job is entitled to at its current slice size:
        1.0 at the requested size, the growth curve's speedup when grown."""
        if job.allocated_chips and job.allocated_chips != job.num_chips:
            return self.growth_curve.speed_factor(job.allocated_chips, job.num_chips)
        return 1.0

    def _shrink_for_demand(self, sim, now: float, groups: dict) -> None:
        """Waiters the free pool cannot place reclaim grown jobs' excess.

        Growth survives arrivals that currently-free chips already satisfy
        (an unconditional collapse would shrink every
        grown job whenever *anything* was pending, then ``_grow_into_idle``
        would re-grow it later — charging ``grow_overhead`` twice for a no-op
        round trip).  Placement is interleaved with reclaim — place what
        fits, shrink ONE job, place again — so each freed chip is consumed
        by a waiter before the next probe (a shared-pool ``can_allocate``
        over multiple waiters would double-count the same free chips).
        Reclaim is skipped outright when free + total excess cannot cover
        even the smallest waiter: shrinking would charge overhead and
        forfeit growth speedup without placing anyone (fragmentation-
        blocked waiters are ``_defrag``'s job, later in the same pass)."""
        if not sim.pending:
            return
        grown = [
            j
            for j in sim.running
            if j.allocated_chips > j.num_chips
            and not self._is_packed(sim, j, groups)
        ]
        if not grown:
            return
        # largest excess first: most chips reclaimed per overhead charge
        grown.sort(key=lambda j: j.allocated_chips - j.num_chips, reverse=True)
        self._start_waiters(sim, now)
        remaining_excess = sum(j.allocated_chips - j.num_chips for j in grown)
        for job in grown:
            if not sim.pending:
                break
            # re-checked per shrink, against the CURRENT pending set: once
            # the placeable waiters are gone, the survivors may all be too
            # big for free + what's still reclaimable — shrinking then
            # would charge overhead and forfeit speedup for nobody
            if sim.cluster.free_chips + remaining_excess < min(
                j.num_chips for j in sim.pending
            ):
                break
            remaining_excess -= job.allocated_chips - job.num_chips
            sim.resize(
                job,
                chips=job.num_chips,
                speed=1.0,
                overhead=self.grow_overhead,
                why=(
                    self.explain(
                        "shrink-for-demand",
                        reclaimed_chips=job.allocated_chips - job.num_chips,
                        pending=len(sim.pending),
                    )
                    if self.explaining(sim) else None
                ),
            )
            self._start_waiters(sim, now)

    def _grow_into_idle(self, sim) -> None:
        """Nothing waits and chips sit idle: double willing jobs' slices
        (slice sizes are powers of two), cheapest-to-please first."""
        cluster = sim.cluster
        groups = self._overlay_groups(sim)
        candidates = sorted(
            (
                j
                for j in sim.running
                if not self._is_packed(sim, j, groups)
            ),
            key=lambda j: (j.allocated_chips, j.arrival_seq),
        )
        for job in candidates:
            # pick the largest power-of-two size that fits AND still improves
            # the curve speed, then resize ONCE — one overhead charge and one
            # free/alloc cycle instead of a doubling ladder
            budget = job.allocated_chips + cluster.free_chips
            # growth never crosses the DCN boundary: the growth curve
            # models ICI scaling only, so cap at one pod on slice clusters
            cap = min(
                cluster.total_chips,
                getattr(cluster, "pod_chips", cluster.total_chips),
            )
            best_k, best_speed = job.allocated_chips, job.speed
            k = job.allocated_chips * 2
            while k <= cap and k <= budget:
                speed = self.growth_curve.speed_factor(k, job.num_chips)
                if speed <= best_speed:
                    break  # latency term took over; bigger only gets worse
                best_k, best_speed = k, speed
                k *= 2
            # geometry may refuse the chosen box (fragmentation): halve until
            # a contiguous slice exists or growth stops being worthwhile
            while best_k > job.allocated_chips:
                why = (
                    self.explain(
                        "grow-into-idle",
                        speedup=round(best_speed, 4),
                        idle_chips=cluster.free_chips,
                    )
                    if self.explaining(sim) else None
                )
                if sim.resize(
                    job, chips=best_k, speed=best_speed,
                    overhead=self.grow_overhead, why=why,
                ):
                    sim.metrics.count("grows")
                    break
                best_k //= 2
                best_speed = self.growth_curve.speed_factor(best_k, job.num_chips)
                if best_speed <= job.speed:
                    break
