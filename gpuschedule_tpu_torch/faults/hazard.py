"""Age- and utilization-dependent failure hazard.

The port's own copy of ``gpuschedule_tpu/faults/hazard.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

Fault injection makes the fleet *fail* realistically; this module makes the failure
rate itself realistic — and, more importantly, makes it a **signal**
consumers can react to instead of pure damage:

- **Age dependence** (generation-time): with ``hazard_shape != 1`` the
  per-chip MTBF process in :mod:`gpuschedule_tpu_torch.faults.schedule` stops
  being memoryless.  The fleet failure intensity follows a Weibull-style
  power law in replay time, sampled by the classic time-rescaling
  construction (draw unit-exponential arrivals in transformed time and
  invert the cumulative hazard), normalized so the *expected* failure
  count over the horizon matches the homogeneous process at the same
  ``mtbf`` — the knob keeps meaning "mean failures per chip over the
  replay", only their clustering in time changes.  ``shape > 1`` is
  wear-out (failures pile up late), ``shape < 1`` infant mortality.
- **Utilization dependence** (run-time): hardware that works harder ages
  faster.  :class:`HazardModel` integrates per-pod **wear** (busy
  chip-seconds, observed from the cluster's occupancy counters at event-
  batch granularity) and folds it into an *effective age*
  ``A = now + util_weight * wear_per_chip``, so two pods at the same
  wall-clock age score differently when one has been loaded and the
  other idle.  The fault *schedule* cannot depend on runtime utilization
  (it is generated up front, before the replay runs — the deterministic
  seeded-schedule contract); utilization dependence therefore lives
  entirely in the runtime **score** that placement and proactive
  migration consume.

Consumers read the signal as ``cluster.hazard_score(scope)`` (bound via
``cluster.bind_hazard``; 0.0 when no model is armed): the expected
failure arrivals per hour over the scope's chips at their effective age,
plus the flavor's own degrade-mask penalty for known-slow chips (each
straggler chip adds its lost rate fraction — a degraded chip is the most
concrete hazard evidence there is).  The ``health`` placement scheme
orders pods by it, the ``contention`` scheme discounts residual
bandwidth by it, and the engine's proactive checkpoint-and-migrate
trigger (``migrate_threshold``) compares a running gang's combined
straggler + hazard exposure against it.

Deterministic, pure Python, host code (sim-core rule).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class HazardConfig:
    """The armed subset of FaultConfig's hazard knobs (what the engine
    needs to build a :class:`HazardModel`; rides ``FaultPlan.hazard``).

    ``life`` is the Weibull characteristic life — the ``mtbf`` knob, so
    one number governs both how often chips fail and how fast they age.
    ``migrate_threshold`` arms the engine's proactive checkpoint-and-
    migrate offer: a running gang whose exposure (lost straggler rate
    plus relative hazard heat) reaches it is offered to
    ``Policy.on_hazard`` (inf = never, the default)."""

    shape: float = 1.0
    util_weight: float = 0.0
    migrate_threshold: float = math.inf
    life: float = math.inf

    @property
    def armed(self) -> bool:
        return (
            self.shape != 1.0
            or self.util_weight > 0.0
            or math.isfinite(self.migrate_threshold)
        )


def hazard_config(config) -> Optional["HazardConfig"]:
    """The :class:`HazardConfig` a FaultConfig's knobs describe, or None
    when every hazard knob sits at its default (the knob-off path: no
    model is built, no wear is tracked, nothing changes)."""
    hc = HazardConfig(
        shape=getattr(config, "hazard_shape", 1.0),
        util_weight=getattr(config, "hazard_util_weight", 0.0),
        migrate_threshold=getattr(config, "migrate_threshold", math.inf),
        life=getattr(config, "mtbf", math.inf),
    )
    return hc if hc.armed else None


class HazardModel:
    """Runtime hazard scoring over one cluster's topology.

    The engine constructs one per run (when the fault plan arms any
    hazard knob), binds it to the cluster (``cluster.bind_hazard``), and
    calls :meth:`observe` once per event batch — wear integrates at
    batch granularity, which is exact while occupancy is constant
    between batches (it is: every occupancy change is itself a batch).
    Scores are a heuristic *signal*, deliberately outside the bit-exact
    accounting closures: they steer placement and migration, they never
    enter the goodput/attribution arithmetic.
    """

    def __init__(self, config: HazardConfig, cluster):
        self.config = config
        inner = getattr(cluster, "inner", cluster)
        # per-pod wear for torus fleets (placement steers pods); one
        # fleet-wide bucket for flavors without pod identity
        self._num_pods = int(getattr(inner, "num_pods", 0) or 0)
        self._pod_chips = int(getattr(inner, "pod_chips", 0) or 0)
        self._total_chips = int(getattr(inner, "total_chips", 0) or 0)
        self.wear: Dict[int, float] = {p: 0.0 for p in range(self._num_pods)}
        self._wear_total = 0.0
        self._last_t = 0.0
        self.now = 0.0

    # ------------------------------------------------------------------ #
    # wear integration (utilization dependence)

    def observe(self, now: float, cluster) -> None:
        """Integrate busy chip-seconds up to ``now`` from the cluster's
        O(1) occupancy counters.  Called by the engine before each event
        batch mutates occupancy, so the integral is exact piecewise."""
        dt = now - self._last_t
        if dt > 0.0:
            if self._num_pods:
                wear = self.wear
                for p in range(self._num_pods):
                    busy = cluster.pod_used_chips(p) * dt
                    wear[p] += busy
                    self._wear_total += busy
            else:
                self._wear_total += cluster.used_chips * dt
        self._last_t = now
        self.now = now

    # ------------------------------------------------------------------ #
    # scoring

    def _rate(self, effective_age: float) -> float:
        """Weibull hazard rate per chip at ``effective_age``:
        ``(k / life) * (A / life)^(k-1)`` — constant ``1/life`` at the
        memoryless shape of 1, rising with age for wear-out shapes.
        0.0 when ``life`` is infinite (no MTBF process armed).

        Calibration caveat: at shape 1 this is exactly the scheduled
        per-chip intensity; at other shapes the *schedule* normalizes
        its power law to the replay horizon (same expected count as the
        memoryless process) while this score uses ``life`` as the
        characteristic scale — the scale the wear-inflated effective age
        lives on.  Ratios between scopes (what placement and the
        proactive trigger consume) agree with the scheduled process;
        absolute magnitudes at shape != 1 are a steering signal, not the
        scheduled failures/hour (docs/faults.md omissions)."""
        life = self.config.life
        if not math.isfinite(life) or life <= 0.0:
            return 0.0
        k = self.config.shape
        if k == 1.0:
            return 1.0 / life
        a = max(0.0, effective_age) / life
        if a == 0.0:
            # k < 1 has an infinite hazard at age 0 (infant mortality);
            # report the rate one second in rather than inf
            a = 1.0 / life
        return (k / life) * a ** (k - 1.0)

    def _effective_age(self, wear_per_chip: float) -> float:
        return self.now + self.config.util_weight * wear_per_chip

    def pod_rate(self, pod: int) -> float:
        """Per-chip hazard rate of one pod at its effective age; flavors
        without pod identity fall back to the fleet mean."""
        if self._num_pods and self._pod_chips:
            wpc = self.wear.get(pod, 0.0) / self._pod_chips
            return self._rate(self._effective_age(wpc))
        return self._fleet_rate()

    def _fleet_rate(self) -> float:
        """Fleet-mean per-chip hazard rate (the relative-heat baseline).
        Flavors without pod identity (GPU tree, flat pool) read the
        fleet-wide wear bucket, so ``hazard_util`` still ages a busy
        fleet faster than an idle one — uniformly, since no per-unit
        wear is tracked there."""
        if self._num_pods and self._pod_chips:
            wpc = self._wear_total / (self._num_pods * self._pod_chips)
        elif self._total_chips:
            wpc = self._wear_total / self._total_chips
        else:
            wpc = 0.0
        return self._rate(self._effective_age(wpc))

    def score(self, cluster, scope) -> float:
        """Expected failure arrivals per hour over ``scope``'s chips at
        their effective age — the age/utilization half of
        ``cluster.hazard_score`` (flavors add their degrade-mask penalty
        on top).  ``("pod", p)`` scopes use that pod's own wear; other
        scopes fall back to the fleet mean."""
        from gpuschedule_tpu_torch.faults.schedule import scope_capacity

        chips = scope_capacity(cluster, scope)
        if chips <= 0:
            return 0.0
        if scope[0] == "pod" and self._num_pods:
            rate = self.pod_rate(int(scope[1]))
        elif scope[0] in ("chip", "box") and self._num_pods:
            rate = self.pod_rate(int(scope[1]))
        else:
            rate = self._fleet_rate()
        return chips * rate * 3600.0

    def gang_exposure(self, allocation) -> float:
        """Relative hazard heat of one allocation's hardware in [0, 1]:
        how much hotter than the fleet mean its pods run (0 when its
        pods sit at or below the mean — uniform wear scores 0 for
        everyone).  Feeds the engine's proactive-migrate exposure next
        to the gang's lost straggler rate."""
        if not self._num_pods:
            return 0.0
        detail = getattr(allocation, "detail", None)
        slices = getattr(detail, "slices", None)
        if slices:
            pods = sorted({s.pod for s in slices})
        else:
            pod = getattr(detail, "pod", None)
            if pod is None:
                return 0.0
            pods = [pod]
        base = self._fleet_rate()
        if base <= 0.0:
            return 0.0
        heat = sum(self.pod_rate(p) for p in pods) / (len(pods) * base)
        return min(1.0, max(0.0, heat - 1.0))
