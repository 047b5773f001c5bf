"""GPU cluster model: switch → node → GPU tree with NVLink locality.

The port's own copy of ``gpuschedule_tpu/cluster/gpu.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.

This is the reference's cluster shape (SURVEY.md §2 "Cluster model":
switch/node/GPU hierarchy, NVLink vs PCIe distinction), kept in the TPU
framework for exactly one purpose: the BASELINE config #5 comparison —
**NVLink GPU nodes vs contiguous TPU slices** for topology-aware gang
scheduling.

The modeling contrast with :class:`~gpuschedule_tpu_torch.cluster.tpu.TpuCluster`:

- a GPU gang can always be *scattered* across nodes/switches, but pays for
  it — the allocation's ``speed_factor`` reflects its locality tier
  (single node via NVLink = 1.0, single switch = 0.9, cross-switch =
  0.75), and the engine multiplies job progress by it;
- a TPU slice is contiguous by construction, so its speed factor is always
  1.0 — geometry can *reject* an allocation but never degrade one.  That
  trade (fragmentation blocking vs locality degradation) is what config
  #5 measures.

Placement schemes (SURVEY.md §2 "Placement schemes") choose WHICH GPUs:
``consolidated`` (fewest nodes, YARN-ish), ``random``, ``greedy``
(first-fit scan), ``topology`` (strict NVLink islands: refuse allocations
that would cross a locality boundary).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from gpuschedule_tpu_torch.cluster.base import Allocation, ClusterBase

NodeId = Tuple[int, int]  # (switch, node)

DEFAULT_LOCALITY_SPEED = {"nvlink": 1.0, "switch": 0.9, "cross": 0.75}

SCHEMES = ("consolidated", "random", "greedy", "topology")


@dataclass(frozen=True)
class GpuPlacement:
    """Where a gang landed: per-node GPU counts + the locality tier."""

    nodes: Tuple[Tuple[NodeId, int], ...]
    locality: str           # nvlink | switch | cross
    speed_factor: float     # engine multiplies job progress by this


class GpuCluster(ClusterBase):
    """Switch → node → GPU tree with per-scheme placement."""

    def __init__(
        self,
        *,
        num_switches: int = 2,
        nodes_per_switch: int = 4,
        gpus_per_node: int = 8,
        scheme: str = "consolidated",
        locality_speed: Optional[Dict[str, float]] = None,
        seed: int = 0,
    ):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme!r}; known: {SCHEMES}")
        self.num_switches = num_switches
        self.nodes_per_switch = nodes_per_switch
        self.gpus_per_node = gpus_per_node
        self.scheme = scheme
        self.locality_speed = dict(locality_speed or DEFAULT_LOCALITY_SPEED)
        self.total_chips = num_switches * nodes_per_switch * gpus_per_node
        self._free: Dict[NodeId, int] = {
            (s, n): gpus_per_node
            for s in range(num_switches)
            for n in range(nodes_per_switch)
        }
        self._used = 0
        self._ids = itertools.count()
        self._live: Dict[int, GpuPlacement] = {}
        self._rng = random.Random(seed)
        self._down: Dict[NodeId, int] = {}  # node -> overlapping outage count
        # straggler degrade mask (faults/): node -> stack of residual-rate
        # fractions.  A degraded node stays allocatable — gangs on it just
        # run at its rate (the slowest member paces a synchronous gang).
        self._node_degrade: Dict[NodeId, List[float]] = {}
        self.fragmentation_failures = 0  # topology-strict refusals
        # Engine snapshot contract (sim/snapshot.py): every
        # field above is authoritative, picklable state with no derived
        # caches, so this flavor serializes wholesale.  ``_rng`` is part
        # of that contract — the ``random`` placement scheme's stream
        # state rides the snapshot, which is what keeps a resumed replay
        # placing gangs on byte-identical nodes.

    # ------------------------------------------------------------------ #

    @property
    def used_chips(self) -> int:
        return self._used

    @property
    def unhealthy_chips(self) -> int:
        # free GPUs on down nodes: occupied-and-down only exists transiently
        # inside a fault event, before the engine revokes the victims, so
        # counting the free side keeps free_chips consistent throughout
        return sum(self._free[nd] for nd in self._down)

    # ------------------------------------------------------------------ #
    # fault health mask (faults/)

    def _node_scope(self, scope) -> NodeId:
        if scope[0] != "node":
            raise ValueError(
                f"GpuCluster faults take ('node', switch, node) scopes, got {scope!r}"
            )
        nd = (int(scope[1]), int(scope[2]))
        if nd not in self._free:
            raise ValueError(f"fault node {nd} not in {self!r}")
        return nd

    def _scope_nodes(self, scope) -> List[NodeId]:
        """Normalize a health-mask scope to its node list: one host node,
        or — the rack-level correlated failure domain — every node under
        one switch (``("switch", s)``)."""
        if scope[0] == "switch":
            s = int(scope[1])
            if not 0 <= s < self.num_switches:
                raise ValueError(f"fault switch {s} not in {self!r}")
            return [(s, n) for n in range(self.nodes_per_switch)]
        return [self._node_scope(scope)]

    def sample_state(self) -> dict:
        state = super().sample_state()
        # node-granular facts: how many hosts are down, and how many are
        # entirely free (the consolidated scheme's placement currency —
        # a gang that fits one free node runs at full NVLink speed)
        state["nodes_down"] = len(self._down)
        state["free_nodes"] = sum(
            1
            for nd, free in self._free.items()
            if free == self.gpus_per_node and nd not in self._down
        )
        if self._node_degrade:
            # straggler nodes (faults/): present only while any exist so
            # straggler-free sample payloads stay byte-identical
            state["degraded"] = len(self._node_degrade)
        return state

    def mark_unhealthy(self, scope) -> list:
        """Take a host node — or, for ``("switch", s)`` domain scopes,
        every node under one switch at once — offline; returns the
        alloc_ids of gangs with any GPU on the downed nodes.  Victim
        selection is :meth:`peek_victims` (single owner — the spot
        pre-revoke warning must address exactly these gangs)."""
        victims = self.peek_victims(scope)
        for nd in self._scope_nodes(scope):
            self._down[nd] = self._down.get(nd, 0) + 1
        return victims

    def repair(self, scope) -> None:
        for nd in self._scope_nodes(scope):
            count = self._down.get(nd, 0)
            if count <= 0:
                raise ValueError(f"repair of healthy node {nd}")
            if count == 1:
                del self._down[nd]
            else:
                self._down[nd] = count - 1

    def peek_victims(self, scope) -> list:
        """The alloc_ids :meth:`mark_unhealthy` WOULD return, without
        mutating the mask (the spot pre-revoke warning's addressees)."""
        downed = set(self._scope_nodes(scope))
        return sorted(
            aid
            for aid, placement in self._live.items()
            if any(node in downed for node, _ in placement.nodes)
        )

    def failure_domains(self) -> List[tuple]:
        """The GPU tree's correlated-failure hierarchy (faults/): every
        host node (the Philly failure domain) and every switch — a
        switch outage is the rack-level blast radius that takes all its
        nodes down in one event."""
        return [
            ("host", ("node", s, n))
            for s in range(self.num_switches)
            for n in range(self.nodes_per_switch)
        ] + [
            ("rack", ("switch", s)) for s in range(self.num_switches)
        ]

    # ------------------------------------------------------------------ #
    # straggler degrade mask (faults/)

    def _degrade_victims(self, nd: NodeId) -> List[int]:
        """Live alloc_ids with any GPU on one node — the only gangs whose
        ``alloc_slow_factor`` can move when that node's degrade stack
        does (the engine's scoped slow-factor re-derivation)."""
        return sorted(
            aid for aid, placement in self._live.items()
            if any(node == nd for node, _ in placement.nodes)
        )

    def mark_degraded(self, scope, factor: float) -> List[int]:
        """One host node turns straggler: it keeps serving its GPUs at
        ``factor`` of their rate; gangs on it slow to match (never
        revoked).  Overlapping degradations stack multiplicatively.
        Returns the live alloc_ids holding GPUs on the node."""
        nd = self._node_scope(scope)
        self._node_degrade.setdefault(nd, []).append(
            min(1.0, max(0.0, float(factor)))
        )
        return self._degrade_victims(nd)

    def clear_degraded(self, scope, factor: float) -> List[int]:
        """Undo one :meth:`mark_degraded` of the same severity.  Returns
        the live alloc_ids holding GPUs on the healed node."""
        nd = self._node_scope(scope)
        stack = self._node_degrade.get(nd)
        frac = min(1.0, max(0.0, float(factor)))
        if not stack or frac not in stack:
            raise ValueError(f"recovery of healthy node {nd}")
        stack.remove(frac)
        if not stack:
            del self._node_degrade[nd]
        return self._degrade_victims(nd)

    def degraded_chips(self) -> Dict[NodeId, float]:
        """Straggler view for policies: ``(switch, node) -> residual
        rate`` (stacked degradations multiplied out)."""
        return {
            nd: math.prod(stack)
            for nd, stack in sorted(self._node_degrade.items())
        }

    def alloc_slow_factor(self, allocation) -> float:
        """Min residual rate over the gang's nodes (the slowest member
        paces a synchronous gang); one dict check when nothing is
        degraded."""
        if not self._node_degrade or allocation is None:
            return 1.0
        placement = allocation.detail
        nodes = getattr(placement, "nodes", None)
        if not nodes:
            return 1.0
        factor = 1.0
        for nd, _ in nodes:
            stack = self._node_degrade.get(nd)
            if stack:
                factor = min(factor, math.prod(stack))
        return factor

    def hazard_score(self, scope) -> float:
        """Hazard signal for a node/switch scope (faults/hazard.py): the
        bound model's age/wear term plus this tree's degrade-mask
        penalty — every known-slow node in the scope adds its lost rate
        fraction.  0.0 when nothing is armed or degraded."""
        score = super().hazard_score(scope)
        if self._node_degrade:
            nodes = set(self._scope_nodes(scope))
            for nd, stack in self._node_degrade.items():
                if nd in nodes:
                    score += 1.0 - math.prod(stack)
        return score

    def _avail(self) -> Dict[NodeId, int]:
        """Per-node free GPUs the placement schemes may use: ``_free``
        itself on a healthy fleet (zero-copy fault-free path), down nodes
        masked to zero otherwise."""
        if not self._down:
            return self._free
        return {
            nd: (0 if nd in self._down else f) for nd, f in self._free.items()
        }

    def is_satisfiable(self, num_chips: int) -> bool:
        if num_chips <= 0:
            return False
        if self.scheme == "topology":
            # strict locality never crosses a switch: a gang larger than one
            # switch can NEVER be placed and must be rejected at admission
            return num_chips <= self.nodes_per_switch * self.gpus_per_node
        return num_chips <= self.total_chips

    def allocate(self, num_chips: int, *, job=None, hint: Optional[dict] = None):
        if num_chips <= 0 or num_chips > self.free_chips:
            return None
        scheme = (hint or {}).get("scheme", self.scheme)
        sel = None
        # Avoid-mask: prefer nodes without straggler
        # degradation — soft (True) falls back to the full pool, "strict"
        # refuses rather than land on a known-slow node.  Free when
        # nothing is degraded.
        avoid = (hint or {}).get("avoid_degraded") if self._node_degrade else None
        if avoid:
            clean = {
                nd: (0 if nd in self._node_degrade else f)
                for nd, f in self._avail().items()
            }
            sel = self._select(num_chips, scheme, avail=clean)
            if sel is None and avoid == "strict":
                return None
        if sel is None:
            sel = self._select(num_chips, scheme)
        if sel is None:
            # enough chips in aggregate (guarded above), placement refused:
            # a locality/fragmentation failure by definition
            self.fragmentation_failures += 1
            return None
        for node, count in sel:
            self._free[node] -= count
        placement = self._placement(sel)
        alloc = Allocation(next(self._ids), num_chips, detail=placement)
        self._live[alloc.alloc_id] = placement
        self._used += num_chips
        return alloc

    def free(self, allocation: Optional[Allocation]) -> None:
        if allocation is None:
            return
        placement = self._live.pop(allocation.alloc_id, None)
        if placement is None:
            raise ValueError(f"double free of allocation {allocation.alloc_id}")
        for node, count in placement.nodes:
            self._free[node] += count
        self._used -= allocation.num_chips

    # ------------------------------------------------------------------ #
    # scheme implementations

    def _placement(self, sel: List[Tuple[NodeId, int]]) -> GpuPlacement:
        switches = {node[0] for node, _ in sel}
        if len(sel) == 1:
            locality = "nvlink"
        elif len(switches) == 1:
            locality = "switch"
        else:
            locality = "cross"
        return GpuPlacement(
            nodes=tuple(sorted(sel)),
            locality=locality,
            speed_factor=self.locality_speed[locality],
        )

    def _select(
        self, n: int, scheme: str, avail: Optional[Dict[NodeId, int]] = None
    ) -> Optional[List[Tuple[NodeId, int]]]:
        if avail is None:
            avail = self._avail()  # schemes never see GPUs on down nodes
        if scheme == "consolidated":
            return self._select_consolidated(n, avail)
        if scheme == "random":
            return self._select_random(n, avail)
        if scheme == "greedy":
            return self._select_greedy(n, avail)
        if scheme == "topology":
            return self._select_topology(n, avail)
        raise ValueError(f"unknown scheme {scheme!r}")

    def _fill_fullest_first(
        self, nodes: List[Tuple[NodeId, int]], n: int
    ) -> Optional[List[Tuple[NodeId, int]]]:
        sel, need = [], n
        for node, f in sorted(nodes, key=lambda kv: (-kv[1], kv[0])):
            if f <= 0:
                continue
            take = min(f, need)
            sel.append((node, take))
            need -= take
            if need == 0:
                return sel
        return None

    def _select_consolidated(
        self, n: int, avail: Dict[NodeId, int]
    ) -> Optional[List[Tuple[NodeId, int]]]:
        """Fewest nodes: best-fit a single node; else prefer a single-switch
        fill (the 0.9x tier) over an equally-compact cross-switch one."""
        fits = [(f, node) for node, f in avail.items() if f >= n]
        if fits:
            f, node = min(fits)  # tightest fit limits future fragmentation
            return [(node, n)]
        # same-switch candidates first: pick the switch needing fewest nodes
        best: Optional[List[Tuple[NodeId, int]]] = None
        for s in range(self.num_switches):
            nodes = [((s, i), avail[(s, i)]) for i in range(self.nodes_per_switch)]
            if sum(f for _, f in nodes) < n:
                continue
            sel = self._fill_fullest_first(nodes, n)
            if sel is not None and (best is None or len(sel) < len(best)):
                best = sel
        if best is not None:
            return best
        return self._fill_fullest_first(list(avail.items()), n)

    def _select_random(
        self, n: int, avail: Dict[NodeId, int]
    ) -> Optional[List[Tuple[NodeId, int]]]:
        nodes = [node for node, f in avail.items() if f > 0]
        self._rng.shuffle(nodes)
        sel, need = [], n
        for node in nodes:
            take = min(avail[node], need)
            sel.append((node, take))
            need -= take
            if need == 0:
                return sel
        return None

    def _select_greedy(
        self, n: int, avail: Dict[NodeId, int]
    ) -> Optional[List[Tuple[NodeId, int]]]:
        sel, need = [], n
        for node in sorted(avail):  # first-fit scan in tree order
            f = avail[node]
            if f <= 0:
                continue
            take = min(f, need)
            sel.append((node, take))
            need -= take
            if need == 0:
                return sel
        return None

    def _select_topology(
        self, n: int, avail: Dict[NodeId, int]
    ) -> Optional[List[Tuple[NodeId, int]]]:
        """Strict NVLink islands: a gang that fits one node must get one
        node; a bigger gang must stay on one switch; else refuse."""
        if n <= self.gpus_per_node:
            fits = [(f, node) for node, f in avail.items() if f >= n]
            if not fits:
                return None
            f, node = min(fits)
            return [(node, n)]
        for s in range(self.num_switches):
            nodes = [((s, i), avail[(s, i)]) for i in range(self.nodes_per_switch)]
            if sum(f for _, f in nodes) >= n:
                sel = self._fill_fullest_first(nodes, n)
                if sel is not None:
                    return sel
        return None

    def __repr__(self) -> str:
        return (
            f"GpuCluster({self.num_switches}sw x {self.nodes_per_switch}n x "
            f"{self.gpus_per_node}g, scheme={self.scheme}, used={self._used}/{self.total_chips})"
        )
