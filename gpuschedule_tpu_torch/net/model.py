"""The shared-fabric contention model: dynamic multislice speed factors.

The port's own copy of ``gpuschedule_tpu/net/model.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

This is the piece that turns :class:`~gpuschedule_tpu_torch.cluster.tpu.
TpuCluster`'s *static* per-allocation ``speed_factor`` into a **dynamic**
one.  The static model assumes every DCN-spanning gang owns the whole
fabric; here, whenever the engine's running set changes (start / done /
preempt / migrate / revoke) or a link degrades (``("link", pod)`` faults),
:meth:`NetModel.recompute` re-derives every multislice job's effective
bandwidth by max-min fair sharing over the fabric graph and re-prices its
``locality_factor`` with the same analytic allreduce term the static
model uses — just fed the job's *actual* share instead of the nominal
:data:`~gpuschedule_tpu_torch.cluster.tpu.DCN_GBPS`.

Demands, from the existing :mod:`gpuschedule_tpu_torch.profiler.ici` model:

- each running **multislice** job contributes one elastic flow over the
  uplinks of the pods it spans plus the aggregation core (weighted by its
  pod count — see :meth:`FabricTopology.path`).  Its offered demand is
  one full uplink (``hosts_per_pod x dcn_gbps``): with every host NIC
  saturated the per-host share is the nominal ``DCN_GBPS``, which is
  exactly what the static model assumed — so an uncontended job on a
  non-blocking core reproduces the static factor bit-for-bit;
- each running job (any size) contributes **inelastic ingest** of
  ``ingest_gbps_per_chip`` per occupied chip on its pod's uplink — the
  input-pipeline traffic that makes residual-bandwidth placement scoring
  meaningful.  Ingest is subtracted from link capacity before the elastic
  flows are filled (it does not slow the ingesting job; docs/network.md
  records that omission).

The resulting per-host bandwidth ``share / hosts_per_pod`` feeds
``cross_pod_allreduce_seconds(..., dcn_gbps=share_per_host)`` and the
familiar ``t / (t + t_dcn)`` factor.  A fully degraded uplink gives a
factor of 0.0: the job *stalls* (holding its chips) until the link is
repaired — slowed, never killed.

Deterministic, pure Python, host code (sim-core rule).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from gpuschedule_tpu_torch.models.config import resolve_model_config
from gpuschedule_tpu_torch.net.fabric import CORE, FabricTopology
from gpuschedule_tpu_torch.net.maxmin import (
    Flow,
    GroupCache,
    maxmin_allocate,
    maxmin_allocate_grouped,
)
from gpuschedule_tpu_torch.profiler.ici import (
    cross_pod_allreduce_seconds,
    dp_gradient_bytes,
)


@dataclass
class NetConfig:
    """Knobs of the shared-fabric model.

    ``oversubscription`` is the core:uplink capacity ratio (1.0 =
    non-blocking, no contention between disjoint-pod jobs; 4.0 = the
    textbook 4:1 datacenter fabric).  ``ingest_gbps_per_chip`` is the
    inelastic input-pipeline draw per occupied chip (0 disables the
    ingest term entirely).  ``uplinks_per_pod`` splits each
    pod's injection budget across that many redundant sibling uplinks —
    independent failure domains the model routes flows around when one
    degrades; 1 (the default) is the historical single-uplink fabric,
    byte-identical.  ``partial`` arms the bottleneck-group
    max-min solve: flows decompose into connected components over
    contended links, each group solves independently, and a dirty set
    touching only some groups re-solves only those against cached group
    solutions (``net/maxmin.py:maxmin_allocate_grouped``).  Off (the
    default) keeps the flat progressive-filling pass — the historical
    float chunking, byte-identical to the flat solve; the grouped arithmetic can
    differ from it in the last ulp across multiple groups, which is why
    the knob rides the config hash like every other ``--net`` key."""

    oversubscription: float = 4.0
    ingest_gbps_per_chip: float = 0.05
    uplinks_per_pod: int = 1
    partial: bool = False


_SPEC_KEYS = {
    "os": "oversubscription",
    "oversubscription": "oversubscription",
    "ingest": "ingest_gbps_per_chip",
    "uplinks": "uplinks_per_pod",
    "partial": "partial",
}


def parse_net_spec(spec: str) -> NetConfig:
    """Parse the CLI's ``--net k=v,...`` spec.  Keys: ``os`` /
    ``oversubscription`` (core oversubscription ratio), ``ingest``
    (Gbps per occupied chip), ``uplinks`` (redundant sibling uplinks
    per pod, 1-8; >1 arms adaptive routing), ``partial`` (0/1: arm the
    bottleneck-group partial max-min re-solve)."""
    config = NetConfig()
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        key, sep, raw = pair.partition("=")
        key = key.strip().replace("-", "_")
        if not sep or key not in _SPEC_KEYS:
            raise ValueError(
                f"bad --net entry {pair!r}; known keys: {sorted(set(_SPEC_KEYS))}"
            )
        if key == "uplinks":
            v = float(raw)
            if v != int(v):
                # every other malformed --net value errors loudly; a
                # fractional sibling count must not silently truncate
                raise ValueError(
                    f"--net uplinks must be a whole number of sibling "
                    f"uplinks, got {raw.strip()}"
                )
            config.uplinks_per_pod = int(v)
        elif key == "partial":
            if raw.strip() not in ("0", "1"):
                raise ValueError(
                    f"--net partial must be 0 or 1, got {raw.strip()}"
                )
            config.partial = raw.strip() == "1"
        else:
            setattr(config, _SPEC_KEYS[key], float(raw))
    # range-check here, not deep inside FabricTopology at Simulator
    # construction: a bad spec must be a clean CLI error, not a traceback
    if not config.oversubscription > 0:
        raise ValueError(
            f"--net oversubscription must be > 0, got {config.oversubscription}"
        )
    if config.ingest_gbps_per_chip < 0:
        raise ValueError(
            f"--net ingest must be >= 0, got {config.ingest_gbps_per_chip}"
        )
    if not 1 <= config.uplinks_per_pod <= 8:
        raise ValueError(
            f"--net uplinks must be in [1, 8], got {config.uplinks_per_pod}"
        )
    return config


@dataclass(frozen=True)
class JobShare:
    """One multislice job's allocation in the latest recompute.

    ``route`` (adaptive routing) is the flow's weighted uplink
    set on a redundant-sibling fabric — the engine emits a ``reroute``
    event when it changes.  Always the empty tuple on a single-uplink
    fabric."""

    gbps: float           # per-pod injection rate granted (max-min fair)
    demand_gbps: float    # offered demand (one full pod uplink budget)
    factor: float         # the dynamic locality factor at this share
    pods: Tuple[int, ...]
    route: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class LinkSample:
    """One link's load in the latest recompute (capacity is post-degrade)."""

    used_gbps: float
    capacity_gbps: float

    @property
    def util(self) -> float:
        if self.capacity_gbps <= 0.0:
            return 1.0 if self.used_gbps > 0.0 else 0.0
        return self.used_gbps / self.capacity_gbps


@dataclass
class NetState:
    """What one :meth:`NetModel.recompute` derived."""

    shares: Dict[str, JobShare] = field(default_factory=dict)
    links: Dict[str, LinkSample] = field(default_factory=dict)


class NetModel:
    """Engine-facing contention model over one fleet's shared fabric.

    The engine calls :meth:`attach` once, :meth:`mark_dirty` on every
    allocation mutation, :meth:`poll` / :meth:`recompute` after every
    event batch that may have changed the running set (poll returns the
    cached state when the dirty set is empty — the incremental
    fast path), and :meth:`degrade_link` / :meth:`repair_link` from
    ``("link", pod)`` fault records.  Placement (the ``contention``
    scheme) reads :meth:`residual_gbps` between recomputes.
    :meth:`recompute` alone is always a correct full pass — direct
    callers need no marking discipline.
    """

    def __init__(self, config: Optional[NetConfig] = None):
        self.config = config or NetConfig()
        self.topology: Optional[FabricTopology] = None
        self._cluster = None
        # active uplink degradations: link NAME -> list of residual-
        # capacity fractions (stacked outages multiply; repair pops one
        # instance).  On a redundant-sibling fabric each new outage lands
        # on the least-degraded sibling, spreading damage deterministically.
        self._degraded: Dict[str, List[float]] = {}
        # outage identity -> the sibling it landed on, so repair heals
        # exactly the right sibling under overlapping equal-severity
        # outages (the engine keys by fault-record identity)
        self._degrade_sites: Dict[object, str] = {}
        # cached per-pod route weights (routing fabrics): a pure function
        # of link health, invalidated by degrade/repair alongside the
        # flow cache so healthy-fabric recomputes skip the rebuild
        self._pod_routes: Optional[List[Tuple[Tuple[str, float], ...]]] = None
        # last recompute's elastic usage per link (residual_gbps reads it)
        self._elastic_used: Dict[str, float] = {}
        self.recomputes = 0
        # Incremental re-pricing: the progressive-
        # filling pass is a pure function of (flow set, pod occupancy,
        # link health), so the engine marks this model dirty on every
        # mutation of those inputs (mark_dirty / degrade_link /
        # repair_link) and skips the whole pass via poll() when nothing
        # changed since the cached state was derived.  recompute() itself
        # is always a full pass — direct callers (tests, tools) need no
        # marking discipline to stay correct.
        self._dirty = True
        self._state = NetState()
        self.cache_hits = 0
        # flow-set cache (second dirty tier): the flow list only changes
        # when a *multislice* allocation is bound or released, which is
        # rare next to single-pod churn — occupancy-only invalidations
        # (the ingest term) reuse the cached flows and skip the whole
        # running-set scan.  Only the engine's reuse_flows=True path
        # consults it; direct recompute() callers always rebuild.
        self._flows_dirty = True
        self._flows: List[Flow] = []
        self._flow_meta: Dict[str, Tuple[int, ...]] = {}
        self._flow_jobs: Dict[str, object] = {}
        # flow-cache telemetry: reuses vs running-set rebuilds
        self.flow_reuses = 0
        self.flow_rebuilds = 0
        # Bottleneck-group partial re-solve: when the config
        # arms it, recompute() solves per connected component over
        # contended links and reuses cached group solutions whose inputs
        # are bitwise unchanged.  ``partial_cache`` (test hook) disables
        # only the reuse — every group solves fresh with the identical
        # grouped arithmetic, the byte-equivalence comparator.
        self._group_cache = GroupCache() if self.config.partial else None
        self.partial_cache = True
        # per-(model, tp) gradient payload cache: the resolved config and
        # payload never change for a given job, so the per-flow model
        # lookup happens once per distinct model instead of per recompute
        self._grad_bytes: Dict[Tuple[Optional[str], int], float] = {}
        # per-pods-tuple weighted link path (topo.path validates and
        # rebuilds the tuple on every call; flows reuse a handful of
        # distinct pod sets for the whole replay)
        self._paths: Dict[Tuple[int, ...], Tuple] = {}
        # attach()-time link metadata: sorted names and the name -> pod
        # parse, so recompute stops re-sorting and re-splitting per pass
        self._sorted_links: Tuple[str, ...] = ()
        self._uplinks: Tuple[str, ...] = ()
        self._link_pod: Dict[str, Optional[int]] = {}
        self._base_caps: Dict[str, float] = {}
        self._t_step = 1.0
        # time-weighted utilization integrals (the net sweep and the
        # compare-topology contention column read the means)
        self._last_t: Optional[float] = None
        self._last_util: Dict[str, float] = {}
        self._util_area: Dict[str, float] = {}
        self._horizon = 0.0

    # ------------------------------------------------------------------ #

    # the snapshot contract's audit surface: every derived
    # cache listed here must be rebuilt/invalidated in restored() —
    # cross-checked statically by the JAX package's contract linter
    # (GS502, docs/static-analysis.md)
    _DERIVED_CACHES = (
        "_dirty",
        "_flows_dirty",
        "_state",
        "_pod_routes",
        "_group_cache",
    )

    def restored(self) -> None:
        """Post-restore cache invalidation (engine snapshots):
        a deserialized model keeps its authoritative state — link degrade
        stacks, the elastic/ingest bookkeeping, the utilization-integral
        accumulators (whose exact values make a v1 resume's ``netlink``
        means byte-identical) — but every derived cache is marked for
        rebuild, so the first post-restore ``poll``/``recompute`` prices
        from scratch instead of trusting pre-snapshot flow lists, group
        solves, or route weights."""
        self._dirty = True
        self._flows_dirty = True
        self._state = NetState()
        self._pod_routes = None
        if self._group_cache is not None:
            self._group_cache = GroupCache()

    def attach(self, cluster) -> None:
        """Bind to a (possibly placement-wrapped) TpuCluster; idempotent —
        the engine and the CLI may both attach the same cluster."""
        inner = getattr(cluster, "inner", cluster)
        if self._cluster is inner:
            # same fleet, but drop the pricing cache: a NetModel reused
            # for a second Simulator over the same cluster must start
            # from a full recompute (pre-incremental semantics), not
            # serve the previous run's final state from poll().  The
            # group cache drops with it — a fresh run must not reuse the
            # previous run's group solves (same rule, same reason).
            self._dirty = True
            self._flows_dirty = True
            self._state = NetState()
            if self._group_cache is not None:
                self._group_cache = GroupCache()
            return
        self.topology = FabricTopology.from_cluster(
            inner,
            oversubscription=self.config.oversubscription,
            uplinks_per_pod=self.config.uplinks_per_pod,
        )
        self._cluster = inner
        self._elastic_used = {}
        self._degraded = {}
        self._degrade_sites = {}
        self._pod_routes = None
        self._dirty = True
        self._flows_dirty = True
        self._state = NetState()
        self._paths = {}
        topo = self.topology
        self._base_caps = {
            name: link.capacity_gbps for name, link in topo.links.items()
        }
        self._sorted_links = tuple(sorted(topo.links))
        # per-pod sibling uplink names (one historical name each on a
        # non-redundant fabric); _uplinks keeps the primary sibling for
        # the single-uplink fast paths
        self._pod_links = tuple(
            topo.pod_uplinks(p) for p in range(topo.num_pods)
        )
        self._uplinks = tuple(names[0] for names in self._pod_links)
        self._link_pod = {
            name: (
                None if name == CORE
                else int(name.rsplit("pod", 1)[1].split(".", 1)[0])
            )
            for name in topo.links
        }
        self._t_step = float(getattr(inner, "dcn_step_seconds", 1.0))

    def _require_attached(self) -> FabricTopology:
        if self.topology is None:
            raise RuntimeError("NetModel.attach(cluster) must run first")
        return self.topology

    # ------------------------------------------------------------------ #
    # link health (the ("link", pod) fault scope, faults/)

    @property
    def routing_enabled(self) -> bool:
        """True when the fabric has redundant sibling uplinks to route
        around; single-uplink fabrics keep every historical
        code path."""
        return self.topology is not None and self.topology.uplinks_per_pod > 1

    def degrade_link(self, pod: int, residual_frac: float, *, key=None) -> None:
        """One DCN-uplink outage: a sibling of pod ``pod``'s uplink set
        drops to ``residual_frac`` of its current capacity (0.0 = hard
        outage).  On a redundant fabric the outage lands on the sibling
        with the fewest active degradations (lowest index breaks ties),
        spreading damage deterministically; outages stack
        multiplicatively until each is repaired.

        ``key`` (the engine passes the fault record's identity) pins the
        chosen sibling so the matching :meth:`repair_link` heals exactly
        the sibling THIS outage degraded — overlapping outages of equal
        severity on different siblings would otherwise be un-pairable
        from the fraction alone."""
        topo = self._require_attached()
        if not 0 <= pod < topo.num_pods:
            raise ValueError(f"link fault pod {pod} out of range")
        name = min(
            self._pod_links[pod],
            key=lambda n: (len(self._degraded.get(n, ())), n),
        )
        frac = min(1.0, max(0.0, float(residual_frac)))
        self._degraded.setdefault(name, []).append(frac)
        if key is not None:
            self._degrade_sites[key] = name
        self._dirty = True
        if topo.uplinks_per_pod > 1:
            # route weights are part of the cached flow links: a health
            # change re-routes, so the flow cache must rebuild
            self._flows_dirty = True
            self._pod_routes = None

    def repair_link(self, pod: int, residual_frac: float, *, key=None) -> None:
        """Undo one :meth:`degrade_link` of the same severity — on the
        sibling its ``key`` recorded, falling back (keyless callers) to
        the first sibling in index order holding a matching
        degradation."""
        topo = self._require_attached()
        frac = min(1.0, max(0.0, float(residual_frac)))
        site = self._degrade_sites.pop(key, None) if key is not None else None
        names = (site,) if site is not None else self._pod_links[pod]
        for name in names:
            stack = self._degraded.get(name)
            if stack and frac in stack:
                stack.remove(frac)
                if not stack:
                    del self._degraded[name]
                self._dirty = True
                if topo.uplinks_per_pod > 1:
                    self._flows_dirty = True
                    self._pod_routes = None
                return
        raise ValueError(f"repair of healthy link pod{pod}")

    def _capacity(self, link: str) -> float:
        """Current (post-degrade) capacity of one link."""
        topo = self._require_attached()
        cap = topo.links[link].capacity_gbps
        if link != CORE:
            for frac in self._degraded.get(link, ()):
                cap *= frac
        return cap

    # ------------------------------------------------------------------ #
    # demands

    def _multislice_pods(self, job) -> Optional[Tuple[int, ...]]:
        """The pods a running job's allocation spans, or None when it is
        not a DCN-spanning gang (single-pod slices produce no elastic
        flow).  Overlay guests with their own multislice detail count —
        they share the base's uplinks and must share its bandwidth."""
        alloc = getattr(job, "allocation", None)
        detail = getattr(alloc, "detail", None)
        slices = getattr(detail, "slices", None)
        if not slices:
            return None
        return tuple(sorted({s.pod for s in slices}))

    def _demand_gbps(self) -> float:
        """Offered demand of one multislice flow: one full uplink, i.e.
        per-host nominal DCN_GBPS across all the pod's host NICs — the
        bandwidth the static model silently assumed."""
        topo = self._require_attached()
        return topo.uplink_gbps

    def _job_grad_bytes(self, job) -> float:
        """Gradient payload for one job's allreduce flow, cached per
        (model, tp): the resolved config never changes for a job, so the
        zoo lookup runs once per distinct model instead of per recompute
       ."""
        model = getattr(job, "model_name", None)
        tp = max(1, int(getattr(job, "tp", 1) or 1))
        key = (model, tp)
        cached = self._grad_bytes.get(key)
        if cached is None:
            cfg = resolve_model_config(model)
            cached = dp_gradient_bytes(cfg.param_count // tp)
            self._grad_bytes[key] = cached
        return cached

    def _factor(self, job, m: int, per_host_gbps: float) -> float:
        """The dynamic locality factor: the static formula with the job's
        actual per-host share in place of the nominal DCN_GBPS."""
        t_dcn = cross_pod_allreduce_seconds(
            self._job_grad_bytes(job), m, dcn_gbps=per_host_gbps
        )
        if math.isinf(t_dcn):
            return 0.0
        return self._t_step / (self._t_step + t_dcn)

    def _path(self, pods: Tuple[int, ...]):
        """Weighted link set for one (already sorted, de-duplicated) pods
        tuple, cached — topo.path re-validates and rebuilds per call."""
        path = self._paths.get(pods)
        if path is None:
            path = self._paths[pods] = self.topology.path(pods)
        return path

    def _ingest_gbps(self, pod: int) -> float:
        """Inelastic input-pipeline draw on one pod's uplink set, clamped
        to its total (post-degrade) capacity."""
        rate = self.config.ingest_gbps_per_chip
        if rate <= 0.0 or self._cluster is None:
            return 0.0
        used = self._cluster.pod_used_chips(pod)
        names = self._pod_links[pod]
        if len(names) == 1:
            cap = self._capacity(names[0])
        else:
            cap = sum(self._capacity(n) for n in names)
        return min(used * rate, cap)

    # ------------------------------------------------------------------ #
    # the dirty set: what invalidates the cached state

    def mark_dirty(self, job=None) -> None:
        """Engine-facing: a scheduler-visible mutation touched this job's
        allocation (bind or imminent free).  Two invalidation tiers:

        - a **multislice** bind/release (the job is in the current flow
          set, or its attached allocation spans pods) invalidates the
          flow cache too — the next recompute rebuilds flows from the
          running set;
        - any other allocation change matters only through the ingest
          term: with ingest armed it invalidates the cached *state*
          (capacities moved) but the flow set is reused; with ingest off
          it provably cannot perturb the fabric and the cache survives.

        Call with the allocation still attached; ``job=None`` marks
        everything unconditionally."""
        if self._dirty and self._flows_dirty:
            return
        if (
            job is not None
            and job.job_id not in self._state.shares
            and self._multislice_pods(job) is None
        ):
            if self.config.ingest_gbps_per_chip > 0.0:
                self._dirty = True
            return
        self._dirty = True
        self._flows_dirty = True

    def poll(self, now: float) -> Optional[NetState]:
        """Engine fast path: the cached state when nothing marked the
        model dirty since it was derived, else None (run
        :meth:`recompute`).  Integrates the utilization means either way,
        at the same instants a full pass would — the integral's float
        chunking is part of the byte-identity contract."""
        if self._dirty:
            return None
        self._integrate(now)
        self.cache_hits += 1
        return self._state

    def recompute(
        self, now: float, running_jobs: Iterable, *, reuse_flows: bool = False
    ) -> NetState:
        """Progressive-filling pass over the active flow set: derive every
        running multislice job's max-min fair share, its dynamic locality
        factor, and each link's load.  Deterministic — same running set,
        occupancy, and link health give identical floats.

        ``reuse_flows`` is the engine's second-tier fast path: when the
        flow cache is clean (no multislice bind/release since the last
        rebuild — see :meth:`mark_dirty`), the flow list a running-set
        scan would produce is the cached one verbatim, so the scan is
        skipped and only capacities/rates/factors re-derive.  Direct
        callers keep the default (False): a full rebuild every time, no
        marking discipline required."""
        topo = self._require_attached()
        self._integrate(now)
        self.recomputes += 1

        # effective (post-degrade) capacities, one map per pass: the
        # degradation stack is almost always empty, so start from the
        # attach-time base capacities and only touch degraded uplinks
        # (same multiplication order as _capacity — identical floats).
        # Built before the flow set because adaptive routing derives its
        # per-pod route weights from them.
        link_pod = self._link_pod
        caps = dict(self._base_caps)
        for name, stack in self._degraded.items():
            cap = caps[name]
            for frac in stack:
                cap *= frac
            caps[name] = cap

        routing = topo.uplinks_per_pod > 1
        pod_routes = self._pod_routes
        if routing and pod_routes is None:
            # Adaptive route choice: each pod's injection
            # spreads across its sibling uplinks IN PROPORTION TO their
            # surviving capacity, so every loaded sibling saturates at
            # the same flow rate and the pod's effective uplink budget is
            # exactly the sum of surviving sibling capacities — a
            # degraded sibling sheds load onto the healthy ones (jobs
            # slow by the lost fraction instead of stalling), a dead one
            # leaves the route entirely.  All siblings dead falls back to
            # an even spread over zero-capacity links: the flow stalls.
            # Routes are a pure function of link health: cached until the
            # next degrade/repair invalidates them.
            pod_routes = []
            for names in self._pod_links:
                total = 0.0
                caps_p = []
                for n in names:
                    c = caps[n]
                    caps_p.append((n, c))
                    total += c
                if total > 0.0:
                    pod_routes.append(tuple(
                        (n, c / total) for n, c in caps_p if c > 0.0
                    ))
                else:
                    w = 1.0 / len(names)
                    pod_routes.append(tuple((n, w) for n in names))
            self._pod_routes = pod_routes

        demand = self._demand_gbps()
        reused = reuse_flows and not self._flows_dirty
        if reused:
            self.flow_reuses += 1
            flows = self._flows
            meta = self._flow_meta
            job_by_id = self._flow_jobs
        else:
            self.flow_rebuilds += 1
            flows = []
            meta = {}
            job_by_id = {}
            for job in running_jobs:
                pods = self._multislice_pods(job)
                if pods is None:
                    continue
                if routing:
                    links = tuple(
                        item for p in pods for item in pod_routes[p]
                    ) + ((CORE, float(len(pods))),)
                else:
                    links = self._path(pods)
                flows.append(Flow(job.job_id, links, demand))
                meta[job.job_id] = pods
                job_by_id[job.job_id] = job
            if reuse_flows:
                # only the engine's marked path caches the rebuild — a
                # direct caller's ad-hoc running list must never leak
                # into a later engine reuse.  (Route weights are part of
                # the links, which is why degrade/repair invalidate the
                # flow cache on a redundant fabric.)
                self._flows, self._flow_meta, self._flow_jobs = (
                    flows, meta, job_by_id
                )
                self._flows_dirty = False

        rate = self.config.ingest_gbps_per_chip
        ingest_link: Dict[str, float] = {}
        if rate > 0.0:
            cluster = self._cluster
            if routing:
                # ingest follows the same proportional spread as the
                # elastic routes, clamped to the pod's surviving total
                ingest = {}
                for p, names in enumerate(self._pod_links):
                    pod_cap = sum(caps[n] for n in names)
                    amt = min(cluster.pod_used_chips(p) * rate, pod_cap)
                    ingest[p] = amt
                    for n, w in pod_routes[p]:
                        ingest_link[n] = amt * w
                ingest_total = sum(ingest.values())
                capacity: Dict[str, float] = {}
                for name in topo.links:
                    cap = caps[name]
                    if name == CORE:
                        capacity[name] = max(0.0, cap - ingest_total)
                    else:
                        capacity[name] = max(
                            0.0, cap - ingest_link.get(name, 0.0)
                        )
            else:
                ingest = {
                    p: min(cluster.pod_used_chips(p) * rate, caps[up])
                    for p, up in enumerate(self._uplinks)
                }
                ingest_total = sum(ingest.values())
                capacity = {}
                for name in topo.links:
                    cap = caps[name]
                    if name == CORE:
                        capacity[name] = max(0.0, cap - ingest_total)
                    else:
                        capacity[name] = max(0.0, cap - ingest[link_pod[name]])
        else:
            ingest = dict.fromkeys(range(topo.num_pods), 0.0)
            ingest_total = 0.0
            capacity = {name: max(0.0, cap) for name, cap in caps.items()}
        # a reused flow list was validated when it was built; skip the
        # well-formedness sweep (keys/links/weights), not any arithmetic
        if self._group_cache is not None:
            # bottleneck-group solve: group reuse only through
            # the cache; partial_cache=False solves every group fresh
            # with identical arithmetic (the equivalence comparator).
            # top=CORE arms the hierarchical tier: a contended
            # oversubscribed core no longer couples every flow into one
            # monolithic group — per-pod groups solve (and cache) beneath
            # it, with the core applied as an exact water-level clamp.
            rates = maxmin_allocate_grouped(
                flows, capacity,
                cache=self._group_cache if self.partial_cache else None,
                validate=not reused,
                top=CORE,
            )
        else:
            rates = maxmin_allocate(flows, capacity, validate=not reused)

        prev = self._state
        state = NetState()
        elastic: Dict[str, float] = dict.fromkeys(topo.links, 0.0)
        hosts_per_pod = topo.hosts_per_pod
        prev_shares = prev.shares
        for flow in flows:
            key = flow.key
            r = rates[key]
            for link, w in flow.links:
                elastic[link] += w * r
            share = prev_shares.get(key)
            route = flow.links[:-1] if routing else ()
            if share is None or share.gbps != r or share.pods != meta[key] or (
                routing and share.route != route
            ):
                # the factor is a pure function of (job model/tp, pod
                # set, share): an unchanged (rate, pods) pair reuses the
                # previous JobShare outright and skips the allreduce-term
                # call — same key with different pods (a rebind between
                # passes) re-derives.  A route change alone rebuilds too
                # (same factor, but the engine must see the new route to
                # emit its reroute event).
                pods = meta[key]
                share = JobShare(
                    gbps=r,
                    demand_gbps=demand,
                    factor=self._factor(
                        job_by_id[key], len(pods), r / hosts_per_pod
                    ),
                    pods=pods,
                    route=route,
                )
            state.shares[key] = share
        prev_links = prev.links
        for name in self._sorted_links:
            cap = caps[name]
            if name == CORE:
                used = ingest_total + elastic[name]
            elif routing:
                used = ingest_link.get(name, 0.0) + elastic[name]
            else:
                used = ingest[link_pod[name]] + elastic[name]
            sample = prev_links.get(name)
            if sample is None or (
                sample.used_gbps != used or sample.capacity_gbps != cap
            ):
                sample = LinkSample(used_gbps=used, capacity_gbps=cap)
            state.links[name] = sample
        self._elastic_used = elastic
        self._last_util = {n: s.util for n, s in state.links.items()}
        self._state = state
        self._dirty = False
        return state

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Unified cache telemetry: the incremental-pricing
        cache (poll hits vs full recomputes), the flow-list cache
        (reuses vs running-set rebuilds), and — when ``partial`` armed
        the bottleneck-group solver — group-solution reuses vs fresh
        group solves."""
        out = {
            "net_price": {"hit": self.cache_hits, "miss": self.recomputes},
            "net_flows": {
                "hit": self.flow_reuses, "miss": self.flow_rebuilds,
            },
        }
        if self._group_cache is not None:
            out["net_partial"] = {
                "hit": self._group_cache.reused,
                "miss": self._group_cache.solved,
            }
        return out

    @property
    def partial_solves(self) -> int:
        """Group re-solves avoided by the bottleneck-group cache (the
        non-vacuity signal): 0 whenever ``partial`` is off or nothing was
        ever reusable."""
        return self._group_cache.reused if self._group_cache is not None else 0

    def residual_gbps(self, pod: int) -> float:
        """Unallocated uplink bandwidth on pod ``pod`` right now: the
        (post-degrade) capacity minus live ingest minus the elastic load
        the last recompute granted — the contention placement scheme's
        scoring signal.  Summed across siblings on a redundant fabric."""
        names = self._pod_links[pod]
        if len(names) == 1:
            name = names[0]
            cap = self._capacity(name)
            used = self._ingest_gbps(pod) + self._elastic_used.get(name, 0.0)
            return max(0.0, cap - used)
        cap = sum(self._capacity(n) for n in names)
        used = self._ingest_gbps(pod) + sum(
            self._elastic_used.get(n, 0.0) for n in names
        )
        return max(0.0, cap - used)

    # ------------------------------------------------------------------ #
    # time-weighted link utilization (sweep / compare-topology reporting)

    def _integrate(self, now: float) -> None:
        if self._last_t is not None and now > self._last_t:
            dt = now - self._last_t
            self._horizon += dt
            for name, util in self._last_util.items():
                self._util_area[name] = self._util_area.get(name, 0.0) + util * dt
        self._last_t = now

    def close(self, now: float) -> None:
        """Close the utilization integrals at the end of a run."""
        self._integrate(now)

    def mean_utilization(self) -> Dict[str, float]:
        """Time-weighted mean utilization per link over the replay."""
        if self._horizon <= 0.0:
            return {}
        return {
            name: area / self._horizon
            for name, area in sorted(self._util_area.items())
        }
