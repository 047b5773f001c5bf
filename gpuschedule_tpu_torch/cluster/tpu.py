"""TPU torus topology + contiguous slice allocator.

The port's own copy of ``gpuschedule_tpu/cluster/tpu.py`` (the port imports
nothing of the JAX package): the interconnect constants and slice shapes
that the goodput curve synthesis reads, so that a curve written by this
package is the curve the simulator expects, and the slice allocator the
port's simulator (:mod:`gpuschedule_tpu_torch.sim`) replays traces on.
Tests hold the tables and the replays equal to the original's.

This replaces the reference's Switch → Node → GPU tree (SURVEY.md §2 "Cluster
model": NVLink/PCIe locality) with the TPU-native resource model: a pod is an
ICI torus — 2D for v5e (one pod = 16×16 = 256 chips), 3D for v5p — and an
allocation is a **slice**: an axis-aligned contiguous sub-mesh whose shape
comes from a power-of-two shape table (SURVEY.md §7 step 2, BASELINE.json
north_star "slice-shaped allocations").  Where a GPU scheduler asks "are k
GPUs free anywhere", a TPU scheduler must ask "is a contiguous k-chip box
free" — that geometric constraint is what makes fragmentation, migration and
topology-aware placement behave differently on pods, and it is the reason
this allocator exists as its own component.

Design notes
------------
- Occupancy is a tiny dense grid (≤ a few hundred cells for any one pod), so
  slice search is a vectorized sliding-window scan rather than a free-list:
  ``numpy.lib.stride_tricks.sliding_window_view`` gives every candidate
  origin's occupancy in one shot and first-fit picks the lexicographically
  smallest free origin.  Lexicographic first-fit packs slices toward the
  origin corner, which is the "consolidated" default; the placement package
  supplies other origin-selection orders (random / spread / best-fit).
- Shape choice prefers the *squarest* candidate (minimal surface area) —
  square/cube slices minimize ICI hop diameter and maximize wraparound
  usefulness, and leave rectangular free space in bigger contiguous blocks.
- A slice that spans a full torus axis gets that axis's wraparound links
  (``SliceGeometry.wrap_axes``); the profiler's ICI allreduce term uses this
  (ring bandwidth doubles on a wrapped axis).
- Multi-pod clusters (``num_pods > 1``) model a DCN-connected fleet: slices
  never span pods, which is exactly the ICI-within / DCN-across boundary
  (SURVEY.md §5 "Distributed comm backend").
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gpuschedule_tpu_torch.cluster.base import Allocation, ClusterBase, OverlayMixin

# sentinel for the per-(rows, shape) scan memo: a memoized None is a
# cached refusal, distinct from "not yet scanned"
_SCAN_MISS = object()

# Modeled per-generation interconnect constants consumed by the profiler's
# analytic allreduce term (SURVEY.md §7 "Step-time model fidelity").  Values
# are modeled approximations of public specs, calibrated away by measurement:
# what matters for policy comparisons is the *relative* ICI-vs-DCN and
# per-generation scaling, not the absolute GB/s.
GENERATIONS: Dict[str, dict] = {
    "v5e": {
        "torus_ndim": 2,
        "pod_dims": (16, 16),
        "ici_gbps_per_link": 400.0,     # per ICI link, per direction
        "hbm_gbps": 819.0 * 8,          # 819 GB/s HBM BW
        "bf16_tflops": 197.0,
        "chips_per_host": 8,
    },
    "v5p": {
        "torus_ndim": 3,
        "pod_dims": (8, 8, 4),          # 256-chip pod ("v5p-256" scale)
        "ici_gbps_per_link": 800.0,
        "hbm_gbps": 2765.0 * 8,
        "bf16_tflops": 459.0,
        "chips_per_host": 4,
    },
}

DCN_GBPS = 100.0  # modeled per-host DCN bandwidth (across-pod collectives)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (valid slice sizes are powers of two)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def valid_slice_shapes(num_chips: int, dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """All axis-aligned shapes for a ``num_chips`` slice inside ``dims``.

    A valid shape factors ``num_chips`` into one power-of-two extent per
    torus axis, each fitting its axis.  Sorted squarest-first: minimal
    max/min extent ratio, then minimal surface area — the ICI-friendly
    preference order.  Empty list when ``num_chips`` is not a power of two
    or exceeds what any box in ``dims`` can hold.
    """
    return list(_valid_slice_shapes(num_chips, tuple(dims)))


@functools.lru_cache(maxsize=4096)
def _valid_slice_shapes(num_chips: int, dims: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Cached core of :func:`valid_slice_shapes` — allocate/can_allocate hit
    this on every call with a handful of distinct (size, dims) pairs."""
    if not _is_pow2(num_chips):
        return ()
    ndim = len(dims)
    shapes = set()

    def rec(prefix: Tuple[int, ...], remaining: int) -> None:
        axis = len(prefix)
        if axis == ndim - 1:
            if remaining <= dims[axis]:
                shapes.add(prefix + (remaining,))
            return
        f = 1
        while f <= min(remaining, dims[axis]):
            if remaining % f == 0:
                rec(prefix + (f,), remaining // f)
            f <<= 1

    rec((), num_chips)

    def squareness(shape: Tuple[int, ...]) -> Tuple[float, int, Tuple[int, ...]]:
        ratio = max(shape) / min(shape)
        # surface area ~ sum over axes of (volume / extent): lower = squarer
        surface = sum(num_chips // s for s in shape)
        return (ratio, surface, shape)

    return tuple(sorted(shapes, key=squareness))


@dataclass(frozen=True)
class SliceGeometry:
    """Where a slice sits in its pod.

    ``wrap_axes[i]`` is True when the slice spans the full torus extent on
    axis ``i`` and therefore owns that axis's wraparound ICI links.
    """

    pod: int
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]
    wrap_axes: Tuple[bool, ...]

    @property
    def num_chips(self) -> int:
        return math.prod(self.shape)

    def chips(self) -> Iterator[Tuple[int, ...]]:
        """Yield the pod-local coordinates of every chip in the slice."""
        for offs in itertools.product(*[range(s) for s in self.shape]):
            yield tuple(o + d for o, d in zip(self.origin, offs))


@dataclass(frozen=True)
class MultiSliceGeometry:
    """A gang larger than one pod: whole pods joined over DCN (TPU
    multislice).  Per-pod collectives ride ICI; the cross-pod gradient
    sync crosses the datacenter network, which is what ``speed_factor``
    models — the engine multiplies a job's progress rate by it
    (``job.locality_factor``), so a DCN-spanning job runs measurably
    slower than the same gang inside one pod (the ICI-vs-DCN cliff)."""

    slices: Tuple[SliceGeometry, ...]
    speed_factor: float = 1.0

    @property
    def num_chips(self) -> int:
        return sum(s.num_chips for s in self.slices)

    @property
    def num_pods_spanned(self) -> int:
        return len(self.slices)


class TpuCluster(OverlayMixin, ClusterBase):
    """A fleet of identical TPU pods with contiguous slice allocation.

    ``allocate(k)`` grants an axis-aligned free box of a valid k-chip shape
    (all-or-nothing, like every ClusterBase flavor) or returns None; ``k``
    must be a power of two — trace loaders map raw GPU counts up via
    :func:`next_pow2` / :meth:`round_up` (SURVEY.md §7 "Philly trace
    fidelity": #GPU→valid-slice mapping happens at ingestion).
    """

    def __init__(
        self,
        generation: str = "v5e",
        *,
        dims: Optional[Sequence[int]] = None,
        num_pods: int = 1,
        dcn_step_seconds: float = 1.0,
    ):
        # dcn_step_seconds: nominal per-step compute+ICI time used to turn
        # the analytic cross-pod allreduce cost into a progress multiplier
        # for multislice jobs (speed_factor = t / (t + t_dcn)).  Bigger
        # models pay a bigger DCN toll automatically (payload scales with
        # param count); this knob sets what that toll is measured against.
        self.dcn_step_seconds = float(dcn_step_seconds)
        if generation not in GENERATIONS:
            raise ValueError(f"unknown TPU generation {generation!r}; known: {sorted(GENERATIONS)}")
        self.generation = generation
        self.spec = GENERATIONS[generation]
        self.dims: Tuple[int, ...] = tuple(dims) if dims is not None else self.spec["pod_dims"]
        if len(self.dims) != self.spec["torus_ndim"]:
            raise ValueError(
                f"{generation} is a {self.spec['torus_ndim']}D torus; got dims {self.dims}"
            )
        if any(d < 1 for d in self.dims):
            raise ValueError(f"bad pod dims {self.dims}")
        self.num_pods = int(num_pods)
        if self.num_pods < 1:
            raise ValueError("num_pods must be >= 1")
        self.pod_chips = math.prod(self.dims)
        self.total_chips = self.pod_chips * self.num_pods

        # occupancy[pod] is a dense int8 grid: 0 free, 1 occupied
        self._occ: List[np.ndarray] = [
            np.zeros(self.dims, dtype=np.int8) for _ in range(self.num_pods)
        ]
        # health[pod] counts overlapping outages per chip (faults/): a chip
        # is unhealthy while its count > 0.  _unhealthy_cells tracks how
        # many cells are nonzero so the fault-free hot path stays a single
        # int compare (no grid scan when nothing is broken).
        self._health: List[np.ndarray] = [
            np.zeros(self.dims, dtype=np.int16) for _ in range(self.num_pods)
        ]
        self._unhealthy_cells = 0
        # free-and-unhealthy cell count, maintained at every health and
        # occupancy write: `unhealthy_chips` used to re-scan
        # every pod's grids on each read, and with any outage live it is
        # read on every free_chips (so every allocate, every blame rule)
        # — O(fleet) per event.  The maintained count makes it O(1); a
        # brute-scan equivalence is pinned by tests.
        self._unhealthy_free = 0
        # straggler degrade mask (faults/): (pod, coord) -> stack of
        # residual-rate fractions (overlapping degradations multiply).  A
        # degraded chip stays allocatable — it is slow, not gone — so this
        # lives beside the health mask, not inside it.  Empty dict keeps
        # alloc_slow_factor at a single truthiness check on the hot path.
        self._chip_degrade: Dict[Tuple[int, Tuple[int, ...]], List[float]] = {}
        self._used = 0
        # per-pod occupied-chip counts, maintained at the four occupancy
        # writes (grant/free, single + multislice) so pod_used_chips is an
        # O(1) read instead of a grid sum — the net/ ingest term reads it
        # once per pod per re-price (hot path)
        self._pod_used: List[int] = [0] * self.num_pods
        self._ids = itertools.count()
        self._live: Dict[int, SliceGeometry] = {}
        self._init_overlays()
        # fragmentation accounting: allocation failures while enough chips
        # were free in aggregate (i.e. failures caused purely by geometry)
        self.fragmentation_failures = 0
        self.invalid_size_failures = 0
        self.allocation_attempts = 0
        # Directionally-versioned failure caches: a hint-free
        # ``allocate``/``can_allocate`` answer is a pure function of the
        # (occupancy, health) state, and state mutations move feasibility
        # MONOTONICALLY — a grant or an outage only removes capacity (a
        # size that failed still fails), a free or a repair only restores
        # it (a size that fit still fits).  ``_harden`` counts the former,
        # ``_ease`` the latter; failed sizes cached against ``_ease`` and
        # positive feasibility against ``_harden`` stay valid across the
        # other direction's churn, so the blocked FIFO head retried on
        # every event batch is refused in O(1) instead of re-running the
        # window search.  Hinted calls (placement schemes, overlays,
        # avoid masks) never consult the caches.  The degrade mask never
        # bumps either counter: hint-free searches ignore it entirely.
        self._ease = 0
        self._harden = 0
        self._fail_version = -1
        self._fail_sizes: Dict[int, str] = {}   # size -> failure kind
        self._can_true_version = -1
        self._can_true: set = set()
        self._can_false_version = -1
        self._can_false: set = set()
        # Cache telemetry: per-cache hit/miss/invalidate
        # counts behind :meth:`cache_stats` — plain int bumps at the
        # existing branch sites, so a cache that silently stops hitting
        # (a regression) shows up as a rate, not a hunch.
        self._cs_fail_hit = 0          # allocate failure-cache refusals
        self._cs_fail_miss = 0         # trivial allocates past the cache
        self._cs_fail_inval = 0        # _ease-driven cache clears
        self._cs_can_hit = 0           # can_allocate memo hits
        self._cs_can_miss = 0          # memoized fresh derivations
        self._cs_can_inval = 0         # directional memo clears
        self._cs_rows_hit = 0          # bitmask row-table reuses
        self._cs_rows_miss = 0         # row-table rebuilds
        self._cs_search_fallback = 0   # numpy window scans (hinted/avoid)
        # Bitmask row cache: each pod's blocked grid (occupancy
        # | health) packed as one int per torus row, rebuilt lazily after
        # any write to that pod.  The hint-free slice search runs on these
        # ints (AND rows, shift-AND for the run, lowest set bit for the
        # column) — the same lexicographic first-fit origin the numpy
        # sliding-window scan returns, at a fraction of the cost.
        self._rows: List[Optional[List[int]]] = [None] * self.num_pods
        self._row_len = self.dims[-1]
        self._row_grid = self.dims[:-1]  # outer axes of the row table
        # C-order strides over the outer axes: the row index of outer
        # coordinate (c0, .., ck) is sum(ci * stride_i) — what lets
        # grant/free update the packed rows in place instead
        # of invalidating and re-packing the whole pod grid
        strides: List[int] = []
        acc = 1
        for d in reversed(self._row_grid):
            strides.append(acc)
            acc *= d
        self._row_strides = tuple(reversed(strides))
        # Per-(rows, shape) scan memo: a bitmask first-fit
        # result is a pure function of the packed row list and the shape,
        # so each pod keeps {shape: origin|None} keyed to the IDENTITY of
        # its current row list — a rebuild swaps the list object, which
        # invalidates the memo with no extra bookkeeping at any write
        # site.  Pays in the blocked-FIFO steady state: one free in pod k
        # re-scans pod k's shapes only; the other pods' refusals replay
        # from the memo.
        self._scan_memo: List[Optional[tuple]] = [None] * self.num_pods
        self._cs_scan_hit = 0          # memoized first-fit answers
        self._cs_scan_miss = 0         # fresh bitmask scans

    # ------------------------------------------------------------------ #
    # engine snapshot support (sim/snapshot.py)

    # the snapshot contract's audit surface: every derived
    # cache listed here must be shed in __getstate__ or rebuilt in
    # restored(), and vice versa
    _DERIVED_CACHES = (
        "_rows",
        "_scan_memo",
        "_fail_version",
        "_fail_sizes",
        "_can_true_version",
        "_can_true",
        "_can_false_version",
        "_can_false",
    )

    def __getstate__(self):
        """Serialize for an engine snapshot: authoritative state only.
        The derived caches — bitmask row tables, scan memos, the
        directional failure/feasibility caches — are shed and rebuilt
        lazily after restore, so a resumed replay can never trust
        pre-snapshot geometry (and snapshots stay lean).  Dropping them
        is behavior-neutral by construction: every cache is a pure
        function of the occupancy/health grids that DO ride the
        snapshot."""
        state = self.__dict__.copy()
        state["_rows"] = [None] * self.num_pods
        state["_scan_memo"] = [None] * self.num_pods
        state["_fail_version"] = -1
        state["_fail_sizes"] = {}
        state["_can_true_version"] = -1
        state["_can_true"] = set()
        state["_can_false_version"] = -1
        state["_can_false"] = set()
        return state

    # ------------------------------------------------------------------ #
    # ClusterBase surface

    @property
    def used_chips(self) -> int:
        return self._used

    @property
    def unhealthy_chips(self) -> int:
        """Unoccupied chips currently inside an outage (free_chips subtracts
        these; occupied-and-unhealthy only exists transiently inside a fault
        event, before the engine revokes the victims).  O(1): the count is
        maintained at every health/occupancy write — it equals
        ``sum(((h > 0) & (o == 0)).sum())`` over the pods at all times,
        including mid-fault-event (the maintenance arithmetic masks on
        occupancy exactly as the old scan did)."""
        if self._unhealthy_cells == 0:
            return 0
        return self._unhealthy_free

    @property
    def free_chips(self) -> int:
        # Same arithmetic as the ClusterBase property with the O(1)
        # constituents inlined — allocate's capacity precheck and the
        # failure cache's frag/nofree re-derivation read this once or
        # twice per attempt, which at fleet scale made the base class's
        # nested property dispatch measurable.
        if self._unhealthy_cells == 0:
            return self.total_chips - self._used
        return self.total_chips - self._used - self._unhealthy_free

    # ------------------------------------------------------------------ #
    # fault health mask (faults/)

    def _fault_boxes(
        self, scope
    ) -> List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]]:
        """Normalize a fault scope to (pod, origin, shape) boxes."""
        kind = scope[0]
        if kind == "chip":
            coord = tuple(int(c) for c in scope[2])
            return [(int(scope[1]), coord, tuple(1 for _ in coord))]
        if kind == "box":
            return [(int(scope[1]), tuple(scope[2]), tuple(scope[3]))]
        if kind == "pod":
            return [(int(scope[1]), tuple(0 for _ in self.dims), self.dims)]
        raise ValueError(
            f"TpuCluster faults take chip/box/pod scopes, got {scope!r}"
        )

    @staticmethod
    def _boxes_overlap(o1, s1, o2, s2) -> bool:
        return all(
            a < b + t and b < a + s for a, s, b, t in zip(o1, s1, o2, s2)
        )

    def _geom_overlaps(self, geom, pod, origin, shape) -> bool:
        if isinstance(geom, MultiSliceGeometry):
            return any(
                s.pod == pod
                and self._boxes_overlap(s.origin, s.shape, origin, shape)
                for s in geom.slices
            )
        return geom.pod == pod and self._boxes_overlap(
            geom.origin, geom.shape, origin, shape
        )

    def mark_unhealthy(self, scope) -> List[int]:
        """Take a chip/box/pod offline; returns overlapping live alloc_ids
        (plus overlays packed onto them) for the engine to revoke.
        Victim selection is :meth:`peek_victims` (single owner — the spot
        pre-revoke warning must address exactly these gangs)."""
        victims = self.peek_victims(scope)
        for pod, origin, shape in self._fault_boxes(scope):
            h = self._box(self._health[pod], origin, shape)
            newly = h == 0
            self._unhealthy_cells += int(newly.sum())
            # only free cells join the unhealthy-free count; an occupied
            # victim cell joins later, when the revocation frees it
            o = self._box(self._occ[pod], origin, shape)
            self._unhealthy_free += int((newly & (o == 0)).sum())
            h += 1
            self._rows[pod] = None
        self._harden += 1
        return victims

    def repair(self, scope) -> None:
        for pod, origin, shape in self._fault_boxes(scope):
            h = self._box(self._health[pod], origin, shape)
            if (h <= 0).any():
                raise ValueError(f"repair of healthy chips: {scope!r}")
            h -= 1
            healed = h == 0
            self._unhealthy_cells -= int(healed.sum())
            o = self._box(self._occ[pod], origin, shape)
            self._unhealthy_free -= int((healed & (o == 0)).sum())
            self._rows[pod] = None
        self._ease += 1

    def peek_victims(self, scope) -> List[int]:
        """The alloc_ids :meth:`mark_unhealthy` WOULD return for this
        scope, without touching the mask — the spot pre-revoke warning's
        addressee list (faults/)."""
        victims = set()
        for pod, origin, shape in self._fault_boxes(scope):
            if not 0 <= pod < self.num_pods:
                raise ValueError(f"fault pod {pod} out of range for {self!r}")
            for aid, geom in self._live.items():
                if self._geom_overlaps(geom, pod, origin, shape):
                    victims.add(aid)
        victims |= {o for o, b in self._overlays.items() if b in victims}
        return sorted(victims)

    def failure_domains(self) -> List[Tuple[str, Tuple]]:
        """The correlated-failure hierarchy this torus geometry defines
        (faults/ ``domain_mtbf``), as ``(level, scope)`` pairs:

        - **host**: one ``chips_per_host`` box per tile position — the
          squarest valid slice shape for the host size, tiled across the
          pod (a host's chips are physically adjacent on the torus);
        - **rack**: four hosts' worth of chips as one larger box (the
          PDU/rack blast radius), same squarest-shape tiling;
        - **pod**: the whole pod (power/cooling events).

        Dims that a shape does not tile evenly contribute only the full
        tiles (the trailing chips simply belong to no rack).  Levels
        whose size reaches the whole pod collapse into the pod level
        rather than duplicating it."""
        domains: List[Tuple[str, Tuple]] = []
        host = self.spec["chips_per_host"]
        for level, size in (("host", host), ("rack", 4 * host)):
            if size >= self.pod_chips:
                continue
            shapes = valid_slice_shapes(size, self.dims)
            if not shapes:
                continue
            shape = shapes[0]
            origins = list(itertools.product(
                *[range(0, d - s + 1, s) for d, s in zip(self.dims, shape)]
            ))
            for pod in range(self.num_pods):
                domains += [
                    (level, ("box", pod, origin, shape)) for origin in origins
                ]
        domains += [("pod", ("pod", p)) for p in range(self.num_pods)]
        return domains

    # ------------------------------------------------------------------ #
    # straggler degrade mask (faults/)

    def _degrade_victims(self, pod: int, coord: Tuple[int, ...]) -> List[int]:
        """Live alloc_ids (bases + overlays riding them) whose geometry
        covers one chip — the gangs whose ``alloc_slow_factor`` can move
        when that chip's degrade stack does.  The engine re-derives slow
        factors for exactly these instead of sweeping the
        running set."""
        one = tuple(1 for _ in self.dims)
        hits = {
            aid for aid, geom in self._live.items()
            if self._geom_overlaps(geom, pod, coord, one)
        }
        hits |= {o for o, b in self._overlays.items() if b in hits}
        return sorted(hits)

    def mark_degraded(self, scope, factor: float) -> List[int]:
        """One chip turns straggler: ``("chip", pod, coord)`` drops to
        ``factor`` of its rate.  Overlapping degradations stack
        multiplicatively; the chip stays allocatable throughout.  Returns
        the live alloc_ids whose gangs hold the chip (the only gangs
        whose slow factor can change)."""
        if scope[0] != "chip":
            raise ValueError(
                f"TpuCluster stragglers take ('chip', pod, coord) scopes, "
                f"got {scope!r}"
            )
        pod, coord = int(scope[1]), tuple(int(c) for c in scope[2])
        if not 0 <= pod < self.num_pods or any(
            not 0 <= c < d for c, d in zip(coord, self.dims)
        ) or len(coord) != len(self.dims):
            raise ValueError(f"straggler scope out of range: {scope!r}")
        self._chip_degrade.setdefault((pod, coord), []).append(
            min(1.0, max(0.0, float(factor)))
        )
        return self._degrade_victims(pod, coord)

    def clear_degraded(self, scope, factor: float) -> List[int]:
        """Undo one :meth:`mark_degraded` of the same severity.  Returns
        the live alloc_ids holding the healed chip (the gangs that may
        now speed back up)."""
        pod, coord = int(scope[1]), tuple(int(c) for c in scope[2])
        stack = self._chip_degrade.get((pod, coord))
        frac = min(1.0, max(0.0, float(factor)))
        if not stack or frac not in stack:
            raise ValueError(f"recovery of healthy chip: {scope!r}")
        stack.remove(frac)
        if not stack:
            del self._chip_degrade[(pod, coord)]
        return self._degrade_victims(pod, coord)

    def degraded_chips(self) -> Dict[Tuple[int, Tuple[int, ...]], float]:
        """Straggler view for policies: ``(pod, coord) -> residual rate``
        (stacked degradations multiplied out)."""
        return {
            key: math.prod(stack)
            for key, stack in sorted(self._chip_degrade.items())
        }

    def alloc_slow_factor(self, allocation) -> float:
        """Min residual rate over an allocation's chips: the synchronous
        gang runs at its slowest chip.  Scans the (tiny) degraded set,
        not the geometry, so the straggler-free path is one dict check."""
        if not self._chip_degrade or allocation is None:
            return 1.0
        geom = allocation.detail
        if geom is None:
            return 1.0
        one = tuple(1 for _ in self.dims)
        factor = 1.0
        for (pod, coord), stack in self._chip_degrade.items():
            if self._geom_overlaps(geom, pod, coord, one):
                factor = min(factor, math.prod(stack))
        return factor

    def hazard_score(self, scope) -> float:
        """Hazard signal for a chip/box/pod scope (faults/hazard.py):
        the bound model's age/wear term plus this torus's degrade-mask
        penalty — every known-slow chip inside the scope adds its lost
        rate fraction, so a pod carrying stragglers outranks a clean pod
        of the same age.  Free (0.0) when nothing is armed or degraded."""
        score = super().hazard_score(scope)
        if self._chip_degrade:
            boxes = self._fault_boxes(scope)
            for (pod, coord), stack in self._chip_degrade.items():
                for b_pod, origin, shape in boxes:
                    if b_pod == pod and all(
                        o <= c < o + s
                        for c, o, s in zip(coord, origin, shape)
                    ):
                        score += 1.0 - math.prod(stack)
                        break
        return score

    def _blocked(self, pod: int) -> np.ndarray:
        """Grid the slice search scans: occupancy, plus the health mask
        when any chip is down (the fault-free path returns ``_occ``
        itself — zero copies, zero behavior change)."""
        occ = self._occ[pod]
        if self._unhealthy_cells == 0:
            return occ
        return occ + (self._health[pod] > 0)

    def _blocked_avoiding(self, pod: int) -> np.ndarray:
        """The blocked grid with this pod's degraded (straggler) chips
        additionally masked — the avoid-pass search grid of an
        ``avoid_degraded`` allocation hint.  Only called while the
        degrade set is non-empty; the grid is tiny, so the copy is
        cheap."""
        blocked = self._blocked(pod)
        coords = [c for (p, c) in self._chip_degrade if p == pod]
        if not coords:
            return blocked
        grid = blocked.copy()
        for coord in coords:
            grid[coord] = 1
        return grid

    def pod_free_chips(self, pod: int) -> int:
        """Healthy free chips in one pod (fault-evacuation planning)."""
        free = self._occ[pod] == 0
        if self._unhealthy_cells:
            free &= self._health[pod] == 0
        return int(free.sum())

    def pod_used_chips(self, pod: int) -> int:
        """Occupied chips in one pod (the net/ ingest-demand input: each
        running chip pulls training data over its pod's DCN uplink).
        O(1): the count is maintained at every occupancy write."""
        return self._pod_used[pod]

    def round_up(self, num_chips: int) -> int:
        """Smallest valid allocation size >= num_chips: a power-of-two
        slice within one pod, or — on a multi-pod fleet — a whole-pod
        multiple for gangs bigger than a pod (TPU multislice: per-pod
        slices joined over DCN)."""
        k = next_pow2(num_chips)
        if k <= self.pod_chips:
            return k
        pods_needed = math.ceil(num_chips / self.pod_chips)
        if pods_needed > self.num_pods:
            raise ValueError(
                f"{num_chips} chips cannot fit {self.num_pods} "
                f"{self.generation} pod(s) of {self.pod_chips}"
            )
        return pods_needed * self.pod_chips

    def allocate(self, num_chips: int, *, job=None, hint: Optional[dict] = None):
        """Grant a contiguous ``num_chips`` slice or return None.

        ``hint`` (from the placement layer):
          - ``shape``: exact shape tuple to use (must be a valid shape);
          - ``pod``: restrict search to one pod index;
          - ``origin_order``: callable mapping a list of candidate origins to
            the preferred order (placement schemes inject random/spread
            orders here; default is lexicographic first-fit);
          - ``pod_order``: callable mapping the list of candidate pod
            indices to the preferred search order (the contention scheme
            sorts pods by residual DCN uplink bandwidth; default is
            ascending pod index).  Also orders the empty pods a multislice
            claims.
        """
        self.allocation_attempts += 1
        if hint:  # _try_overlay is a no-op without a hint (hot path)
            overlay = self._try_overlay(num_chips, hint, job)
            if overlay is not None:
                return overlay
        if num_chips <= 0:
            return None
        # hint-free failure cache: grants and outages only make
        # allocation HARDER, so a failed size stays failed until a free
        # or repair (an _ease bump) restores capacity — refuse in O(1),
        # re-deriving the counter effect a fresh call would have (the
        # free-chip precheck is O(1), so 'nofree' vs geometric 'frag' is
        # still classified exactly).
        trivial = not hint
        if trivial:
            if self._fail_version != self._ease:
                self._fail_version = self._ease
                if self._fail_sizes:
                    self._cs_fail_inval += 1
                self._fail_sizes.clear()
            else:
                kind = self._fail_sizes.get(num_chips)
                if kind is not None:
                    self._cs_fail_hit += 1
                    if kind == "invalid":
                        self.invalid_size_failures += 1
                    elif num_chips <= self.free_chips:
                        # capacity exists in aggregate, geometry still
                        # blocks: exactly the fresh call's 'frag' path
                        self.fragmentation_failures += 1
                    return None
            self._cs_fail_miss += 1
        if num_chips > self.pod_chips:
            return self._allocate_multislice(
                num_chips, job=job, hint=hint, record_fail=trivial
            )
        shapes = valid_slice_shapes(num_chips, self.dims)
        if not shapes:
            # Grant-or-None contract (ClusterBase): a non-pow2 / oversized
            # request is unsatisfiable, never an exception — loaders are
            # expected to map raw GPU counts via round_up() at ingestion,
            # but an unmapped trace must not crash the engine mid-run.
            self.invalid_size_failures += 1
            if trivial:
                self._fail_sizes[num_chips] = "invalid"
            return None
        hint = hint or {}
        if "shape" in hint:
            want = tuple(hint["shape"])
            if want not in shapes:
                raise ValueError(f"hinted shape {want} invalid for {num_chips} chips on {self.dims}")
            shapes = [want]
        if "pod" in hint:
            p = hint["pod"]
            if not 0 <= p < self.num_pods:
                raise ValueError(f"hinted pod {p} out of range [0, {self.num_pods})")
            pods: Sequence[int] = [p]
        else:
            pods = range(self.num_pods)
            pod_order = hint.get("pod_order")
            if pod_order is not None:
                pods = pod_order(list(pods))
        origin_order = hint.get("origin_order")

        if num_chips > self.free_chips:
            if trivial:
                self._fail_sizes[num_chips] = "nofree"
            return None
        # Avoid-mask: an ``avoid_degraded`` hint first searches
        # with known-slow (straggler) chips masked out, so a gang never
        # lands on degraded hardware while a clean box exists.  The soft
        # form (True) falls back to the unrestricted search; "strict"
        # returns None instead (proactive migration must not re-grant the
        # degraded slice it is fleeing).  Free when nothing is degraded.
        avoid = hint.get("avoid_degraded") if self._chip_degrade else None
        if avoid == "strict":
            avoid_passes: Tuple[bool, ...] = (True,)
        elif avoid:
            avoid_passes = (True, False)
        else:
            avoid_passes = (False,)
        # fault-free fast path: a pod with fewer free chips than
        # the request can never fit the box — skip its numpy window scan
        # outright.  With any chip health-masked the blocked grid differs
        # from occupancy, so the full search runs (cold path).
        pod_used = self._pod_used if self._unhealthy_cells == 0 else None
        pod_cap = self.pod_chips
        for avoiding in avoid_passes:
            for pod in pods:
                if pod_used is not None and pod_cap - pod_used[pod] < num_chips:
                    continue
                if not avoiding and origin_order is None:
                    # bitmask first-fit: identical origin, no
                    # numpy window machinery
                    for shape in shapes:
                        origin = self._scan_pod_rows(pod, shape)
                        if origin is not None:
                            return self._grant(pod, origin, shape)
                    continue
                self._cs_search_fallback += 1
                blocked = (
                    self._blocked_avoiding(pod) if avoiding
                    else self._blocked(pod)
                )
                for shape in shapes:
                    origin = self._find_free_box(blocked, shape, origin_order)
                    if origin is not None:
                        return self._grant(pod, origin, shape)
        if avoid == "strict":
            # an avoid refusal, not geometric fragmentation: the
            # unrestricted search was never run
            return None
        if "pod" not in hint and "shape" not in hint:
            # enough chips in aggregate, full search space, still no box:
            # that is geometric fragmentation by definition
            self.fragmentation_failures += 1
            if trivial:
                self._fail_sizes[num_chips] = "frag"
        return None

    def _empty_pods(self) -> List[int]:
        """Indices of pods with no occupied cell — the only pods a
        multislice may claim (single source of the emptiness invariant).
        A pod with any unhealthy chip is not empty: a multislice per-pod
        slice is the full torus, so one broken chip disqualifies it."""
        pod_used = self._pod_used  # == occ.any() per pod: the counter is
        # maintained at every occupancy write (grant/free, single +
        # multislice), so the emptiness test is an int compare instead of
        # a numpy reduction per pod per multislice attempt
        return [
            p
            for p in range(self.num_pods)
            if pod_used[p] == 0
            and (self._unhealthy_cells == 0 or not self._health[p].any())
        ]

    def _allocate_multislice(
        self, num_chips: int, *, job=None, hint=None, record_fail=False
    ):
        """Grant a gang larger than one pod as whole empty pods joined
        over DCN, or None.  Only whole-pod multiples are valid multislice
        sizes (each per-pod slice is the full torus, so every pod keeps
        its wraparound ICI).  A ``pod_order`` hint decides which empty
        pods the gang claims first.  ``record_fail`` (hint-free calls
        only) feeds the failure cache."""
        m, rem = divmod(num_chips, self.pod_chips)
        if rem or m > self.num_pods:
            self.invalid_size_failures += 1
            if record_fail:
                self._fail_sizes[num_chips] = "invalid"
            return None
        if num_chips > self.free_chips:
            if record_fail:
                self._fail_sizes[num_chips] = "nofree"
            return None
        empty = self._empty_pods()
        hint = hint or {}
        pod_order = hint.get("pod_order")
        if pod_order is not None:
            allowed = set(empty)
            empty = [p for p in pod_order(list(empty)) if p in allowed]
        avoid = hint.get("avoid_degraded") if self._chip_degrade else None
        if avoid:
            # a multislice claims whole pods, so any degraded chip taints
            # the pod: clean pods first (soft), or clean pods only (strict)
            dirty = {p for p, _ in self._chip_degrade}
            clean = [p for p in empty if p not in dirty]
            if avoid == "strict":
                if len(clean) < m:
                    return None  # avoid refusal, not fragmentation
                empty = clean
            else:
                empty = clean + [p for p in empty if p in dirty]
        if len(empty) < m:
            # enough chips in aggregate but not enough whole pods free:
            # cross-pod fragmentation
            self.fragmentation_failures += 1
            if record_fail:
                self._fail_sizes[num_chips] = "frag"
            return None
        wrap = tuple(True for _ in self.dims)
        origin = tuple(0 for _ in self.dims)
        slices = tuple(
            SliceGeometry(pod=p, origin=origin, shape=self.dims, wrap_axes=wrap)
            for p in empty[:m]
        )
        for s in slices:
            self._occ[s.pod][...] = 1
            self._pod_used[s.pod] = self.pod_chips
            self._rows_mark(s.pod, origin, self.dims, True)
        self._harden += 1
        geom = MultiSliceGeometry(
            slices=slices, speed_factor=self._multislice_speed_factor(m, job)
        )
        alloc = Allocation(next(self._ids), num_chips, detail=geom)
        self._live[alloc.alloc_id] = geom
        self._used += num_chips
        return alloc

    def _multislice_speed_factor(self, num_pods_spanned: int, job) -> float:
        """Progress multiplier for a DCN-spanning gang: the cross-pod
        gradient allreduce stretches each nominal ``dcn_step_seconds``
        step.  Payload comes from the job's model config (param count);
        jobs without a known model pay a representative default."""
        # runtime import: profiler.ici imports this module for the
        # topology tables, so a top-level import would be circular
        from gpuschedule_tpu_torch.models.config import resolve_model_config
        from gpuschedule_tpu_torch.profiler.ici import (
            cross_pod_allreduce_seconds,
            dp_gradient_bytes,
        )

        # unknown models resolve through the shared zoo-median fallback, the
        # same phantom model that prices their checkpoint/restore cost
        # (sim/overhead.py) and network demand (net/)
        param_count = resolve_model_config(
            getattr(job, "model_name", None)
        ).param_count
        # tp-sharded params shrink the per-chip dp-sync payload by tp —
        # the same division profile_model applies to the curve's
        # dcn_grad_bytes, so the planner's cliff and this enacted toll
        # agree for parallelism-spec jobs
        tp = max(1, int(getattr(job, "tp", 1) or 1))
        t_dcn = cross_pod_allreduce_seconds(
            dp_gradient_bytes(param_count // tp), num_pods_spanned
        )
        return self.dcn_step_seconds / (self.dcn_step_seconds + t_dcn)

    def free(self, allocation: Optional[Allocation]) -> None:
        if allocation is None:
            return
        if self._free_with_overlays(allocation.alloc_id):
            return
        geom = self._live.pop(allocation.alloc_id, None)
        if geom is None:
            raise ValueError(f"double free of allocation {allocation.alloc_id}")
        count_unhealthy = self._unhealthy_cells > 0
        if isinstance(geom, MultiSliceGeometry):
            for s in geom.slices:
                if count_unhealthy:
                    # cells revoked mid-outage become free-and-unhealthy
                    # the moment the victim's box is released
                    self._unhealthy_free += int(
                        (self._health[s.pod] > 0).sum()
                    )
                self._occ[s.pod][...] = 0
                self._pod_used[s.pod] = 0
                self._rows_mark(
                    s.pod, tuple(0 for _ in self.dims), self.dims, False
                )
        else:
            if count_unhealthy:
                hbox = self._box(self._health[geom.pod], geom.origin, geom.shape)
                self._unhealthy_free += int((hbox > 0).sum())
            self._box(self._occ[geom.pod], geom.origin, geom.shape)[...] = 0
            self._pod_used[geom.pod] -= geom.num_chips
            self._rows_mark(geom.pod, geom.origin, geom.shape, False)
        self._used -= geom.num_chips
        self._ease += 1

    def _live_size(self, alloc_id: int) -> Optional[int]:
        geom = self._live.get(alloc_id)
        return None if geom is None else geom.num_chips

    def _live_detail(self, alloc_id: int):
        return self._live.get(alloc_id)

    def _overlay_detail(self, alloc_id: int, num_chips: int, job=None):
        """A guest on a multislice base only spans the pods its own size
        needs: a single-pod guest gets one of the base's per-pod slices
        (no DCN speed_factor), a smaller multi-pod guest gets a reduced
        multislice with ITS OWN model's DCN toll — never the base's."""
        geom = self._live.get(alloc_id)
        if isinstance(geom, MultiSliceGeometry):
            m = min(
                max(1, math.ceil(num_chips / self.pod_chips)),
                geom.num_pods_spanned,
            )
            if m == 1:
                return geom.slices[0]
            return MultiSliceGeometry(
                slices=geom.slices[:m],
                speed_factor=self._multislice_speed_factor(m, job),
            )
        return geom

    def _promote(self, old_base_id: int, new_base_id: int) -> None:
        self._live[new_base_id] = self._live.pop(old_base_id)

    def is_satisfiable(self, num_chips: int) -> bool:
        """True iff this size could EVER be granted: a valid power-of-two
        slice shape within one pod, or a whole-pod multiple on a multi-pod
        fleet (multislice over DCN) — regardless of current occupancy."""
        if num_chips <= 0:
            return False
        if num_chips > self.pod_chips:
            m, rem = divmod(num_chips, self.pod_chips)
            return rem == 0 and m <= self.num_pods
        return bool(valid_slice_shapes(num_chips, self.dims))

    def can_allocate(self, num_chips: int) -> bool:
        """Exact feasibility: is a free box of some valid shape available
        now (or, above pod size, enough whole empty pods)?  Memoized
        directionally: a True answer survives frees/repairs (a
        box that fit still fits) and is dropped on grants/outages; a
        False answer survives grants/outages and is dropped on frees/
        repairs.  Pure and side-effect-free, so the memo is invisible;
        tick-driven policies ask the same sizes on every batch."""
        if self._can_true_version != self._harden:
            self._can_true_version = self._harden
            if self._can_true:
                self._cs_can_inval += 1
            self._can_true.clear()
        if self._can_false_version != self._ease:
            self._can_false_version = self._ease
            if self._can_false:
                self._cs_can_inval += 1
            self._can_false.clear()
        if num_chips in self._can_true:
            self._cs_can_hit += 1
            return True
        if num_chips in self._can_false:
            self._cs_can_hit += 1
            return False
        self._cs_can_miss += 1
        result = self._can_allocate_uncached(num_chips)
        (self._can_true if result else self._can_false).add(num_chips)
        return result

    def _can_allocate_uncached(self, num_chips: int) -> bool:
        if num_chips <= 0 or num_chips > self.free_chips:
            return False
        if num_chips > self.pod_chips:
            m, rem = divmod(num_chips, self.pod_chips)
            if rem or m > self.num_pods:
                return False
            return len(self._empty_pods()) >= m
        shapes = valid_slice_shapes(num_chips, self.dims)
        return any(
            self._scan_pod_rows(pod, shape) is not None
            for pod in range(self.num_pods)
            for shape in shapes
        )

    # ------------------------------------------------------------------ #
    # geometry internals

    @staticmethod
    def _box(occ: np.ndarray, origin: Tuple[int, ...], shape: Tuple[int, ...]) -> np.ndarray:
        if len(origin) == 2:
            # 2D pod (the common fleet shape): direct slice expression —
            # grant/free build this view twice per job at fleet scale and
            # the generic tuple-of-slices genexpr was measurable
            o0, o1 = origin
            s0, s1 = shape
            return occ[o0:o0 + s0, o1:o1 + s1]
        return occ[tuple(slice(o, o + s) for o, s in zip(origin, shape))]

    def _rows_mark(
        self, pod: int, origin: Tuple[int, ...], shape: Tuple[int, ...],
        block: bool,
    ) -> None:
        """Fold one grant/free box into the pod's packed row table IN
        PLACE: the blocked grid is pure occupancy while no
        chip is health-masked, so setting/clearing the box's bits yields
        exactly the ints a full re-pack would — the steady-state
        grant/free churn stops paying a per-pod numpy re-pack.  Any
        unhealthy cell anywhere falls back to invalidation (health bits
        interleave with occupancy in the blocked grid; fault paths also
        invalidate at every mask transition), as does a not-yet-built
        table.  The scan memo is identity-keyed to the rows list, so an
        in-place content change must drop it explicitly."""
        rows = self._rows[pod]
        if rows is None:
            return
        if self._unhealthy_cells != 0:
            self._rows[pod] = None
            return
        self._scan_memo[pod] = None
        mask = ((1 << shape[-1]) - 1) << origin[-1]
        strides = self._row_strides
        if len(strides) == 1:
            # 2D pod (one outer axis — the common fleet shape): the row
            # indices are one arithmetic range, no nested expansion
            st = strides[0]
            start = origin[0] * st
            idxs: Iterable[int] = range(start, start + shape[0] * st, st)
        elif not strides:
            rows[0] = (rows[0] | mask) if block else (rows[0] & ~mask)
            return
        else:
            idxs = [0]
            for o, s, st in zip(origin[:-1], shape[:-1], strides):
                idxs = [base + (o + k) * st for base in idxs for k in range(s)]
        if block:
            for r in idxs:
                rows[r] |= mask
        else:
            inv = ~mask
            for r in idxs:
                rows[r] &= inv

    def _pod_rows(self, pod: int) -> List[int]:
        """The pod's blocked grid packed as one int per torus row (bit
        ``c`` of row ``r`` = cell blocked), rebuilt lazily after any
        occupancy/health write to the pod (bitmask search)."""
        rows = self._rows[pod]
        if rows is None:
            self._cs_rows_miss += 1
            blocked = self._blocked(pod)
            packed = np.packbits(
                blocked.astype(bool).reshape(-1, self._row_len),
                axis=1, bitorder="little",
            )
            rows = [
                int.from_bytes(packed[i].tobytes(), "little")
                for i in range(packed.shape[0])
            ]
            self._rows[pod] = rows
        else:
            self._cs_rows_hit += 1
        return rows

    def _scan_pod_rows(self, pod: int, shape: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        """Bitmask first-fit: the lexicographically smallest free origin
        for ``shape`` in ``pod``'s blocked grid — exactly the origin
        :meth:`_find_free_box` returns on the same grid (pinned by
        tests), found with row ANDs and a shift-AND run search instead
        of the numpy sliding-window machinery.  Hint-free searches only;
        custom origin orders and avoid-masks keep the numpy path."""
        dims = self.dims
        if any(s > d for s, d in zip(shape, dims)):
            return None
        rows = self._pod_rows(pod)
        # per-(rows, shape) memo: same row list object => same answer.
        # The sentinel distinguishes a memoized None (a cached refusal)
        # from an absent entry.
        memo = self._scan_memo[pod]
        if memo is None or memo[0] is not rows:
            memo = (rows, {})
            self._scan_memo[pod] = memo
        else:
            cached = memo[1].get(shape, _SCAN_MISS)
            if cached is not _SCAN_MISS:
                self._cs_scan_hit += 1
                return cached
        self._cs_scan_miss += 1
        origin = self._scan_rows_uncached(rows, shape)
        memo[1][shape] = origin
        return origin

    def _scan_rows_uncached(
        self, rows: List[int], shape: Tuple[int, ...]
    ) -> Optional[Tuple[int, ...]]:
        """The raw bitmask first-fit over a packed row list (the memo-free
        body of :meth:`_scan_pod_rows`; a pure function of its inputs)."""
        dims = self.dims
        w = shape[-1]
        W = self._row_len
        colmask = (1 << (W - w + 1)) - 1
        full = (1 << W) - 1
        if len(dims) == 2:
            h = shape[0]
            for r in range(dims[0] - h + 1):
                acc = rows[r]
                for i in range(1, h):
                    acc |= rows[r + i]
                x = ~acc & full
                for _ in range(w - 1):
                    x &= x >> 1
                x &= colmask
                if x:
                    return (r, (x & -x).bit_length() - 1)
            return None
        # generic ND (v5p 3D tori): rows are the C-order flattening of the
        # outer axes; iterate outer origins lexicographically
        outer_dims, outer_shape = dims[:-1], shape[:-1]
        strides = [1] * len(outer_dims)
        for i in range(len(outer_dims) - 2, -1, -1):
            strides[i] = strides[i + 1] * outer_dims[i + 1]
        offs = [
            sum(o * st for o, st in zip(off, strides))
            for off in itertools.product(*[range(s) for s in outer_shape])
        ]
        ranges = [range(d - s + 1) for d, s in zip(outer_dims, outer_shape)]
        for origin in itertools.product(*ranges):
            base = sum(o * st for o, st in zip(origin, strides))
            acc = 0
            for off in offs:
                acc |= rows[base + off]
            x = ~acc & full
            for _ in range(w - 1):
                x &= x >> 1
            x &= colmask
            if x:
                return origin + ((x & -x).bit_length() - 1,)
        return None

    def _find_free_box(self, occ, shape, origin_order) -> Optional[Tuple[int, ...]]:
        """First free origin for an axis-aligned ``shape`` box in ``occ``.

        Sliding-window view computes every origin's occupancy count at once;
        grids are <= a few hundred cells so this is microseconds.
        """
        if any(s > d for s, d in zip(shape, occ.shape)):
            return None
        windows = np.lib.stride_tricks.sliding_window_view(occ, shape)
        ndim = occ.ndim
        blocked = windows.sum(axis=tuple(range(ndim, 2 * ndim)))
        free = np.argwhere(blocked == 0)
        if free.size == 0:
            return None
        if origin_order is not None:
            candidates = origin_order([tuple(int(c) for c in row) for row in free])
            return candidates[0] if candidates else None
        return tuple(int(c) for c in free[0])  # lexicographic first-fit

    def _grant(self, pod: int, origin: Tuple[int, ...], shape: Tuple[int, ...]) -> Allocation:
        # granted boxes never cover unhealthy cells (the search grid masks
        # them), so _unhealthy_free needs no adjustment here
        n = math.prod(shape)
        self._box(self._occ[pod], origin, shape)[...] = 1
        self._pod_used[pod] += n
        self._rows_mark(pod, origin, shape, True)
        self._harden += 1
        wrap = tuple(s == d for s, d in zip(shape, self.dims))
        geom = SliceGeometry(pod=pod, origin=origin, shape=shape, wrap_axes=wrap)
        alloc = Allocation(next(self._ids), n, detail=geom)
        self._live[alloc.alloc_id] = geom
        self._used += n
        return alloc

    # ------------------------------------------------------------------ #
    # fragmentation / observability

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Unified cache telemetry: the directional allocate-
        failure cache, the can_allocate memo, and the bitmask row table
        (``fallback`` counts hinted/avoid-mask numpy window scans that
        bypass the bitmask search), as ``{cache: {outcome: count}}``."""
        return {
            "tpu_alloc_fail": {
                "hit": self._cs_fail_hit,
                "miss": self._cs_fail_miss,
                "invalidate": self._cs_fail_inval,
            },
            "tpu_can_allocate": {
                "hit": self._cs_can_hit,
                "miss": self._cs_can_miss,
                "invalidate": self._cs_can_inval,
            },
            "tpu_slice_rows": {
                "hit": self._cs_rows_hit,
                "miss": self._cs_rows_miss,
                "fallback": self._cs_search_fallback,
            },
            "tpu_scan_memo": {
                "hit": self._cs_scan_hit,
                "miss": self._cs_scan_miss,
            },
        }

    def _largest_free_box(self, blocked: np.ndarray, cap: int) -> int:
        """Largest power-of-two slice placeable in one pod's ``blocked``
        grid, descending from the largest pow2 <= cap (0 if none) — the
        shared core of global and per-pod fragmentation.  Starting from
        the pow2 *floor* matters: min(free, pod capacity) itself can be a
        non-pow2 that skips every real candidate below it."""
        if cap <= 0:
            return 0
        k = 1 << (cap.bit_length() - 1)
        while k >= 1:
            if any(
                self._find_free_box(blocked, shape, None) is not None
                for shape in valid_slice_shapes(k, self.dims)
            ):
                return k
            k >>= 1
        return 0

    def largest_allocatable(self) -> int:
        """Largest valid allocation grantable right now (0 if none): a
        multislice over every empty pod when more than one is empty, else
        the largest power-of-two box in any pod.  Without the multislice
        arm, ``fragmentation()`` would read 0.5 on a perfectly-compact
        two-pod fleet (free = 2 pods, 'largest' capped at 1)."""
        if self.free_chips == 0:
            return 0
        empty_pods = len(self._empty_pods())
        if empty_pods > 1:
            return empty_pods * self.pod_chips
        cap = min(self.free_chips, self.pod_chips)
        return max(
            self._largest_free_box(self._blocked(pod), cap)
            for pod in range(self.num_pods)
        )

    def fragmentation(self) -> float:
        """1 - largest_allocatable/free_chips: 0 = perfectly compact free
        space, →1 = free chips exist but only in small shards."""
        free = self.free_chips
        if free == 0:
            return 0.0
        return 1.0 - self.largest_allocatable() / free

    def pod_fragmentation(self, pod: int) -> float:
        """One pod's fragmentation: 1 - (largest free box)/(healthy free
        chips) within that pod alone.  0 when the pod's free space is one
        compact slice-shaped region; →1 when free chips survive only as
        shards no valid slice shape can cover."""
        free = self.pod_free_chips(pod)
        if free == 0:
            return 0.0
        largest = self._largest_free_box(
            self._blocked(pod), min(free, self.pod_chips)
        )
        return 1.0 - largest / free

    def sample_state(self) -> dict:
        state = super().sample_state()
        # per-pod physical occupancy and fragmentation: which pods are
        # shredded matters for multislice placement (only whole empty
        # pods can join a DCN gang).  One largest-free-box descent per
        # pod serves both the per-pod values and the global figure —
        # fragmentation() would re-run the identical descents.
        pods = []
        largest = 0
        # per-pod hazard scores ride the sample only when a hazard model
        # is bound: the watchtower's hazard-spike
        # detector and the Perfetto health counter track read risk
        # straight from the stream instead of re-deriving it from fault
        # records; hazard-free runs keep byte-identical sample payloads
        hazard_armed = getattr(self, "_hazard_model", None) is not None
        for p in range(self.num_pods):
            free_p = self.pod_free_chips(p)
            box = (
                self._largest_free_box(
                    self._blocked(p), min(free_p, self.pod_chips)
                )
                if free_p else 0
            )
            entry = {
                "used": self.pod_used_chips(p),
                "frag": 1.0 - box / free_p if free_p else 0.0,
            }
            if hazard_armed:
                entry["hazard"] = self.hazard_score(("pod", p))
            pods.append(entry)
            largest = max(largest, box)
        free = self.free_chips
        if free == 0:
            state["frag"] = 0.0
        else:
            empty = len(self._empty_pods())
            if empty > 1:  # the multislice arm of largest_allocatable()
                largest = empty * self.pod_chips
            state["frag"] = 1.0 - largest / free
        state["pods"] = pods
        if self._chip_degrade:
            # straggler chips (faults/): count only while any exist, so
            # straggler-free sample payloads stay byte-identical
            state["degraded"] = len(self._chip_degrade)
        return state

    def live_slices(self) -> List[SliceGeometry]:
        return list(self._live.values())

    def __repr__(self) -> str:
        return (
            f"TpuCluster({self.generation}, dims={self.dims}, pods={self.num_pods}, "
            f"used={self._used}/{self.total_chips})"
        )
