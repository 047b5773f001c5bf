"""Cluster allocation protocol + flat counting cluster.

The port's own copy of ``gpuschedule_tpu/cluster/base.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

All cluster flavors expose the same surface the reference's CLUSTER singleton
offered its policies (SURVEY.md §1 layer 3: "allocate/release GPU sets,
free-resource queries"): ``allocate(num_chips) -> Allocation | None`` with
all-or-nothing gang semantics, ``free(allocation)``, and capacity properties.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class Allocation:
    """Handle for a granted gang allocation.

    ``detail`` is cluster-flavor specific: a slice geometry for
    :class:`~gpuschedule_tpu_torch.cluster.tpu.TpuCluster`, a node→gpu map for the
    GPU model, nothing for :class:`SimpleCluster`.
    """

    alloc_id: int
    num_chips: int
    detail: Any = None


class ClusterBase:
    """Protocol all cluster models implement."""

    total_chips: int

    @property
    def used_chips(self) -> int:
        raise NotImplementedError

    @property
    def unhealthy_chips(self) -> int:
        """Chips currently offline under the fault health mask (faults/).

        Flavors with a health mask override this; the default 0 keeps
        fault-free clusters exactly as before.  Under the engine's fault
        invariant (victims are revoked in the same event that marks their
        chips unhealthy), unhealthy chips are never also occupied, so
        subtracting both ``used`` and ``unhealthy`` from the total never
        double-counts.
        """
        return 0

    @property
    def free_chips(self) -> int:
        return self.total_chips - self.used_chips - self.unhealthy_chips

    def allocate(self, num_chips: int, *, job=None, hint: Optional[dict] = None):
        """Grant ``num_chips`` chips or return ``None`` (all-or-nothing)."""
        raise NotImplementedError

    def free(self, allocation: Allocation) -> None:
        raise NotImplementedError

    # ---- fault health mask (faults/) ---------------------------------- #

    def mark_unhealthy(self, scope) -> list:
        """Take the chips named by a fault ``scope`` offline.

        Returns the alloc_ids of live allocations (including overlays
        sharing a victim base) that overlap the scope — the engine revokes
        the jobs holding them.  Marking is a counter, not a flag: the same
        chip can be inside several overlapping outages and only returns to
        service once every one of them is repaired.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no fault health mask"
        )

    def repair(self, scope) -> None:
        """Undo one :meth:`mark_unhealthy` for the same ``scope``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fault health mask"
        )

    def peek_victims(self, scope) -> list:
        """The alloc_ids an outage of ``scope`` *would* revoke right now,
        without mutating anything — the addressee list of a spot
        pre-revoke warning (faults/).  The default empty list makes
        warnings inert on flavors without the query."""
        return []

    def failure_domains(self) -> list:
        """The correlated-failure hierarchy as ``(level, scope)`` pairs
        (faults/ ``domain_mtbf``): every host, rack, and pod blast
        radius this cluster's geometry defines, each a scope
        :meth:`mark_unhealthy` accepts.  Flavors with topology override;
        the default empty list disables the domain process."""
        return []

    # ---- failure hazard (faults/hazard.py) ------------------- #

    def bind_hazard(self, model) -> None:
        """Attach a runtime :class:`~gpuschedule_tpu_torch.faults.hazard.
        HazardModel` (the engine does this when the fault plan arms any
        hazard knob).  Unbound clusters score every scope 0.0."""
        self._hazard_model = model

    def hazard_score(self, scope) -> float:
        """Failure-hazard signal for a fault ``scope``: expected failure
        arrivals per hour over its chips at their effective (wear-
        inflated) age, from the bound hazard model, plus the flavor's
        degrade-mask penalty (each known-slow chip adds its lost rate
        fraction — flavors with a degrade mask override and add it).
        0.0 with no model bound and nothing degraded — the knob-off
        answer, free to compute."""
        model = getattr(self, "_hazard_model", None)
        return 0.0 if model is None else model.score(self, scope)

    # ---- straggler degrade mask (faults/) ----------------------------- #

    def degraded_chips(self) -> dict:
        """Currently degraded units as ``{unit_id: residual rate
        fraction}`` — the policy-facing straggler view (Gandiva's
        evacuation reads it).  Empty on flavors without a degrade mask
        and whenever nothing is degraded."""
        return {}

    def alloc_slow_factor(self, allocation) -> float:
        """The straggler multiplier of one allocation: the min residual
        rate over its chips (a synchronous gang runs at its slowest
        chip).  1.0 — and O(1) — whenever nothing is degraded; the
        engine derives ``Job.slow_factor`` from this on every bind."""
        return 1.0

    def can_allocate(self, num_chips: int) -> bool:
        """Cheap feasibility probe (may be optimistic only for flavors where
        placement can still fail; SimpleCluster's answer is exact)."""
        return num_chips <= self.free_chips

    def sample_state(self) -> dict:
        """Snapshot for the engine's periodic ``sample`` events:
        *physical* occupancy and health, straight from the flavor's own
        bookkeeping.  ``used`` counts chips physically held — under
        overlay packing two jobs share the same chips, so this can be
        *less* than the demand series the analyzer derives from start
        events (the divergence IS the packing signal).  Flavors extend
        with their topology's own facts (per-pod fragmentation, down
        nodes); keys are additive, schema stays v1."""
        return {"used": self.used_chips, "unhealthy": self.unhealthy_chips}

    # ---- engine snapshot/restore (sim/snapshot.py) ---------- #

    def restored(self) -> None:
        """Post-restore hook: called once after this cluster is
        deserialized from an engine snapshot, before the resumed replay
        touches it.  Flavors with derived caches drop or rebuild them
        here (or shed them in ``__getstate__``) so a resume never trusts
        pre-snapshot geometry; the default flat pool carries no caches.
        Everything else — occupancy, health/degrade masks, counters,
        allocation ids, placement RNGs — is plain picklable state and
        rides the snapshot as-is, which is what makes a v1 resume
        byte-identical to the uninterrupted run."""

    def is_satisfiable(self, num_chips: int) -> bool:
        """Could ``num_chips`` EVER be granted on this cluster (ignoring the
        current occupancy)?  The engine rejects unsatisfiable jobs at
        admission so they cannot wedge priority schedulers by reserving
        budget for a grant that can never happen."""
        return 0 < num_chips <= self.total_chips


class OverlayMixin:
    """Shared-allocation ("packing") support for cluster flavors.

    Gandiva co-locates low-utilization jobs on the same devices (SURVEY.md
    §3.3 "packing").  An *overlay* is an Allocation that shares the chips of
    a live base allocation: it consumes no extra capacity, must fit within
    the base's size (a smaller guest occupies a sub-box of the base slice),
    and when the base is freed the oldest overlay is promoted to become the
    new owner so the remaining packed job keeps its chips — a promoted
    smaller heir holds the full base box until it finishes (slice geometry
    is immutable once granted).

    Flavors call :meth:`_try_overlay` from ``allocate`` and
    :meth:`_free_with_overlays` from ``free``; ``_promote`` is the flavor
    hook that rebinds base-side bookkeeping (nothing for the flat pool,
    geometry ownership for the slice allocator).
    """

    def _init_overlays(self) -> None:
        self._overlays: dict[int, int] = {}  # overlay alloc_id -> base alloc_id

    def sample_state(self) -> dict:
        state = super().sample_state()
        # live overlay count: how many packed guests currently share a
        # base allocation's chips — the reason the analyzer's demand
        # series can exceed the ``used`` reported here
        state["overlays"] = len(self._overlays)
        return state

    def _base_id(self, allocation: Allocation) -> int:
        return self._overlays.get(allocation.alloc_id, allocation.alloc_id)

    def overlay_groups(self) -> dict[int, list[int]]:
        """base alloc_id -> overlay alloc_ids currently sharing it."""
        groups: dict[int, list[int]] = {}
        for o, b in self._overlays.items():
            groups.setdefault(b, []).append(o)
        return {b: sorted(os) for b, os in groups.items()}

    def _try_overlay(self, num_chips: int, hint: Optional[dict], job=None):
        """Return an overlay Allocation if the hint asks for one, None if the
        hint is absent, or raise if the request is malformed."""
        if not hint or "overlay" not in hint:
            return None
        base: Allocation = hint["overlay"]
        bid = self._base_id(base)
        size = self._live_size(bid)
        if size is None:
            raise ValueError(f"overlay base {base.alloc_id} is not live")
        if num_chips > size:
            raise ValueError(
                f"overlay must fit the base: requested {num_chips}, base has {size}"
            )
        alloc = Allocation(
            next(self._ids), num_chips,
            detail=self._overlay_detail(bid, num_chips, job),
        )
        self._overlays[alloc.alloc_id] = bid
        return alloc

    def _free_with_overlays(self, alloc_id: int) -> bool:
        """Handle freeing when overlays are involved.  Returns True if the
        free is fully handled (overlay dropped, or ownership promoted)."""
        if alloc_id in self._overlays:
            del self._overlays[alloc_id]
            return True
        heirs = sorted(o for o, b in self._overlays.items() if b == alloc_id)
        if heirs:
            new_base = heirs[0]
            del self._overlays[new_base]
            for o in heirs[1:]:
                self._overlays[o] = new_base
            self._promote(alloc_id, new_base)
            return True
        return False

    # flavor hooks -------------------------------------------------------
    def _live_size(self, alloc_id: int) -> Optional[int]:
        raise NotImplementedError

    def _live_detail(self, alloc_id: int):
        return None

    def _overlay_detail(self, alloc_id: int, num_chips: int, job=None):
        """Detail to hand a guest overlaying ``alloc_id``.  Defaults to the
        base's detail; flavors override when a smaller guest spans less
        than the base does (e.g. a single-pod guest on a multislice base
        must not inherit the base's DCN speed_factor)."""
        return self._live_detail(alloc_id)

    def _promote(self, old_base_id: int, new_base_id: int) -> None:
        raise NotImplementedError


class SimpleCluster(OverlayMixin, ClusterBase):
    """Flat chip pool with no topology — the minimal stand-in that makes the
    policy layer runnable before (or without) the slice allocator, equivalent
    to treating the cluster as one big node."""

    def __init__(self, total_chips: int):
        self.total_chips = int(total_chips)
        self._used = 0
        self._unhealthy = 0
        self._ids = itertools.count()
        self._live: dict[int, int] = {}
        self._init_overlays()

    @property
    def used_chips(self) -> int:
        return self._used

    @property
    def unhealthy_chips(self) -> int:
        # min() guards the window inside a fault event between marking and
        # the engine revoking the overlapping victims: free_chips must not
        # go negative while both "occupied" and "unhealthy" briefly overlap.
        return min(self._unhealthy, self.total_chips - self._used)

    def mark_unhealthy(self, scope) -> list:
        """Flat-pool outage: ``("chips", n)`` takes n fungible chips down.

        Chips are drawn from the free pool first; only the shortfall
        revokes live allocations (whole gangs, oldest first — deterministic
        and cheap to reason about), plus any overlays packed onto them.
        Victim selection is :meth:`peek_victims` (single owner — the spot
        pre-revoke warning must address exactly the gangs the outage
        would revoke)."""
        victims = self.peek_victims(scope)
        self._unhealthy += int(scope[1])
        return victims

    def repair(self, scope) -> None:
        if scope[0] != "chips":
            raise ValueError(
                f"SimpleCluster faults take ('chips', n) scopes, got {scope!r}"
            )
        self._unhealthy = max(0, self._unhealthy - int(scope[1]))

    def peek_victims(self, scope) -> list:
        """The gangs :meth:`mark_unhealthy` WOULD revoke for this scope
        right now — same free-pool-first selection, no mutation (the
        spot pre-revoke warning's addressee list)."""
        if scope[0] != "chips":
            raise ValueError(
                f"SimpleCluster faults take ('chips', n) scopes, got {scope!r}"
            )
        n = int(scope[1])
        shortfall = n - max(0, self.total_chips - self._used - self._unhealthy)
        victims: list = []
        if shortfall > 0:
            for aid in sorted(self._live):
                victims.append(aid)
                shortfall -= self._live[aid]
                if shortfall <= 0:
                    break
        if victims:
            bases = set(victims)
            victims += sorted(o for o, b in self._overlays.items() if b in bases)
        return victims

    def failure_domains(self) -> list:
        """Flat-pool blast radii: 8-chip "hosts" and eighth-of-the-pool
        "racks" (the same eighth the maintenance rotation uses).  Scopes
        are fungible counts — the pool has no chip identity — so each
        domain is an anonymous ``("chips", n)`` block."""
        domains: list = []
        host = min(8, self.total_chips)
        if host > 0:
            domains += [("host", ("chips", host))] * (self.total_chips // host)
        rack = self.total_chips // 8
        if rack > 0:
            domains += [("rack", ("chips", rack))] * 8
        return domains

    def allocate(self, num_chips: int, *, job=None, hint: Optional[dict] = None):
        overlay = self._try_overlay(num_chips, hint, job)
        if overlay is not None:
            return overlay
        if num_chips <= 0 or num_chips > self.free_chips:
            return None
        alloc = Allocation(next(self._ids), num_chips)
        self._live[alloc.alloc_id] = num_chips
        self._used += num_chips
        return alloc

    def free(self, allocation: Optional[Allocation]) -> None:
        if allocation is None:
            return
        if self._free_with_overlays(allocation.alloc_id):
            return
        n = self._live.pop(allocation.alloc_id, None)
        if n is None:
            raise ValueError(f"double free of allocation {allocation.alloc_id}")
        self._used -= n

    def _live_size(self, alloc_id: int) -> Optional[int]:
        return self._live.get(alloc_id)

    def _promote(self, old_base_id: int, new_base_id: int) -> None:
        self._live[new_base_id] = self._live.pop(old_base_id)
