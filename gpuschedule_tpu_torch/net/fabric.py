"""Shared-fabric topology: per-pod DCN uplinks + an aggregation core.

The port's own copy of ``gpuschedule_tpu/net/fabric.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

The multislice speed model in :mod:`gpuschedule_tpu_torch.cluster.tpu` prices a
DCN-spanning gang *in isolation* — every job sees the full nominal
:data:`~gpuschedule_tpu_torch.cluster.tpu.DCN_GBPS` as if it owned the fabric.
This module is the shared fabric that isolation assumption ignores: a
capacitated graph the contention model (:mod:`gpuschedule_tpu_torch.net.model`)
allocates real bandwidth over.

The graph is deliberately the smallest one that exhibits contention
(TopoOpt/Blink model richer fabrics; see docs/network.md for the
omissions):

- one **uplink per pod**, capacity ``hosts_per_pod x dcn_gbps`` — every
  host in a pod has one ``dcn_gbps`` NIC toward the datacenter network,
  and a pod's aggregate DCN injection is bounded by the sum of its NICs.
  With ``uplinks_per_pod > 1`` (adaptive routing) that budget is
  split across ``k`` redundant **sibling uplinks** (independent failure
  domains at ``uplink_gbps / k`` each) the contention model can route
  around when one degrades;
- one **aggregation core** all cross-pod traffic traverses, capacity
  ``sum(uplinks) / oversubscription`` — the classic Clos oversubscription
  knob (1.0 = non-blocking, in which case disjoint-pod jobs never
  contend; the 4.0 default is the textbook 4:1 datacenter fabric).

Pure stdlib, host code (sim-core rule): the topology tables come from the
same ``GENERATIONS`` spec the allocator uses, via the cluster instance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

CORE = "core"


def uplink(pod: int) -> str:
    """Canonical link name for pod ``pod``'s DCN uplink (the single-
    uplink fabric; sibling ``i`` of a redundant set is
    :func:`sibling_uplink`)."""
    return f"uplink/pod{pod}"


def sibling_uplink(pod: int, idx: int, uplinks_per_pod: int) -> str:
    """Canonical name of sibling ``idx`` of pod ``pod``'s uplink set.
    With one uplink per pod this is exactly :func:`uplink` — the
    historical name, so single-uplink fabrics stay byte-identical."""
    if uplinks_per_pod == 1:
        return uplink(pod)
    return f"uplink/pod{pod}.{idx}"


@dataclass(frozen=True)
class Link:
    """One capacitated fabric edge."""

    name: str
    capacity_gbps: float


class FabricTopology:
    """The capacitated link set of one TPU fleet's shared DCN fabric."""

    def __init__(
        self,
        *,
        num_pods: int,
        hosts_per_pod: int,
        dcn_gbps: float,
        oversubscription: float = 4.0,
        uplinks_per_pod: int = 1,
    ):
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        if hosts_per_pod < 1:
            raise ValueError(f"hosts_per_pod must be >= 1, got {hosts_per_pod}")
        if dcn_gbps <= 0:
            raise ValueError(f"dcn_gbps must be > 0, got {dcn_gbps}")
        if oversubscription <= 0:
            raise ValueError(
                f"oversubscription must be > 0, got {oversubscription}"
            )
        if not 1 <= int(uplinks_per_pod) <= 8:
            # >1 is the redundant-uplink fabric: the pod's NIC
            # budget split across independent failure domains.  Capped
            # where real Clos designs live (and sibling names sort
            # lexicographically below 10).
            raise ValueError(
                f"uplinks_per_pod must be in [1, 8], got {uplinks_per_pod}"
            )
        self.num_pods = int(num_pods)
        self.hosts_per_pod = int(hosts_per_pod)
        self.dcn_gbps = float(dcn_gbps)
        self.oversubscription = float(oversubscription)
        self.uplinks_per_pod = int(uplinks_per_pod)
        # uplink_gbps stays the POD-TOTAL injection budget: redundant
        # siblings split it (hosts spread their NICs across the siblings)
        # rather than multiplying it, so turning the knob changes failure
        # behavior, not baseline capacity
        self.uplink_gbps = self.hosts_per_pod * self.dcn_gbps
        self.sibling_gbps = self.uplink_gbps / self.uplinks_per_pod
        self.core_gbps = self.num_pods * self.uplink_gbps / self.oversubscription
        self.links: Dict[str, Link] = {CORE: Link(CORE, self.core_gbps)}
        for p in range(self.num_pods):
            for i in range(self.uplinks_per_pod):
                name = sibling_uplink(p, i, self.uplinks_per_pod)
                self.links[name] = Link(name, self.sibling_gbps)

    def pod_uplinks(self, pod: int) -> Tuple[str, ...]:
        """The (ordered) sibling uplink names of one pod — a single
        historical ``uplink/podN`` name on a non-redundant fabric."""
        if not 0 <= pod < self.num_pods:
            raise ValueError(f"pod {pod} out of range [0, {self.num_pods})")
        return tuple(
            sibling_uplink(pod, i, self.uplinks_per_pod)
            for i in range(self.uplinks_per_pod)
        )

    @classmethod
    def from_cluster(
        cls, cluster, *, oversubscription: float = 4.0, uplinks_per_pod: int = 1
    ):
        """Build the fabric for a (possibly placement-wrapped) TpuCluster,
        reusing the allocator's own generation spec for hosts-per-pod and
        the nominal per-host DCN bandwidth."""
        from gpuschedule_tpu_torch.cluster.tpu import DCN_GBPS

        inner = getattr(cluster, "inner", cluster)
        if not hasattr(inner, "pod_chips") or not hasattr(inner, "spec"):
            raise ValueError(
                "the shared-fabric model needs a TpuCluster (per-pod DCN "
                f"uplinks); got {type(inner).__name__}"
            )
        hosts = max(1, math.ceil(inner.pod_chips / inner.spec["chips_per_host"]))
        return cls(
            num_pods=inner.num_pods,
            hosts_per_pod=hosts,
            dcn_gbps=DCN_GBPS,
            oversubscription=oversubscription,
            uplinks_per_pod=uplinks_per_pod,
        )

    def path(self, pods: Iterable[int]) -> Tuple[Tuple[str, float], ...]:
        """The weighted link set a ``pods``-spanning flow loads, as
        ``(link, weight)`` pairs: weight 1 on each pod's uplink (the flow
        rate is the per-pod injection rate) and weight ``m`` on the
        core — all ``m`` pods' injections cross the aggregation layer, so
        a flow at rate ``r`` consumes ``m * r`` of core capacity.

        On a redundant-uplink fabric this is the *healthy-fabric default
        route*: the injection spreads evenly (weight ``1/k``) across each
        pod's ``k`` siblings.  The contention model re-weights per link
        health on every recompute (the adaptive-routing rule in
        docs/network.md); direct callers get the symmetric split."""
        pods = sorted(set(pods))
        for p in pods:
            if not 0 <= p < self.num_pods:
                raise ValueError(f"pod {p} out of range [0, {self.num_pods})")
        k = self.uplinks_per_pod
        if k == 1:
            return tuple(
                (uplink(p), 1.0) for p in pods
            ) + ((CORE, float(len(pods))),)
        w = 1.0 / k
        return tuple(
            (name, w) for p in pods for name in self.pod_uplinks(p)
        ) + ((CORE, float(len(pods))),)

    def __repr__(self) -> str:
        sib = (
            f" x{self.uplinks_per_pod} siblings"
            if self.uplinks_per_pod > 1 else ""
        )
        return (
            f"FabricTopology(pods={self.num_pods}, "
            f"uplink={self.uplink_gbps:g} Gbps{sib}, "
            f"core={self.core_gbps:g} Gbps)"
        )
