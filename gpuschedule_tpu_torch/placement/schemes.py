"""Scheme wiring for both cluster flavors.

The port's own copy of ``gpuschedule_tpu/placement/schemes.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from gpuschedule_tpu_torch.cluster.gpu import SCHEMES as GPU_SCHEMES
from gpuschedule_tpu_torch.cluster.gpu import GpuCluster
from gpuschedule_tpu_torch.cluster.tpu import TpuCluster

TPU_SCHEMES = ("consolidated", "random", "spread", "contention", "health")

Origin = Tuple[int, ...]


class PlacedTpuCluster:
    """TpuCluster wrapper that injects an origin-order hint per scheme.

    Delegates everything else to the wrapped cluster, so it satisfies the
    ClusterBase surface (and OverlayMixin's) by forwarding.  Policy-supplied
    hints (overlay, shape, pod) always win over the scheme's origin order.

    The ``contention`` scheme is network-aware: it searches pods in order
    of residual DCN uplink bandwidth (highest first; see
    :meth:`~gpuschedule_tpu_torch.net.model.NetModel.residual_gbps`) before the
    allocator's lexicographic origin scan, steering new gangs away from
    uplinks already loaded with multislice allreduce or ingest traffic.
    Without a :class:`~gpuschedule_tpu_torch.net.model.NetModel` attached, every
    pod scores equally and the scheme degrades to consolidated's pod-index
    order — deterministic either way (no RNG involved).  When a hazard
    model is bound to the cluster (faults/hazard.py), the residual score
    is additionally discounted by ``1 + hazard`` per pod, so equal
    bandwidth goes to the healthier pod (hazard 0 everywhere divides by
    1.0 exactly — bit-identical orderings).

    The ``health`` scheme is failure-aware for *every* policy,
    not just Gandiva's post-hoc evacuation: pods are searched in
    ascending ``cluster.hazard_score(("pod", p))`` order (degraded-chip
    penalty plus the bound hazard model's age/wear term; pod index
    breaks ties) and every allocation carries a soft ``avoid_degraded``
    hint, so a gang never lands on a known-slow chip while a clean box
    exists anywhere.
    """

    def __init__(
        self,
        cluster: TpuCluster,
        scheme: str = "consolidated",
        seed: int = 0,
        net=None,
    ):
        if scheme not in TPU_SCHEMES:
            raise ValueError(f"unknown TPU scheme {scheme!r}; known: {TPU_SCHEMES}")
        self.inner = cluster
        self.scheme = scheme
        self.net = net
        self._rng = random.Random(seed)

    def _origin_order(self, origins: List[Origin]) -> List[Origin]:
        if self.scheme == "random":
            picked = list(origins)
            self._rng.shuffle(picked)
            return picked
        if self.scheme == "spread":
            return sorted(origins, reverse=True)  # far corner first
        return origins  # consolidated/contention: lexicographic first-fit

    def _pod_order(self, pods: List[int]) -> List[int]:
        """Contention scoring: most residual uplink bandwidth first, pod
        index as the deterministic tie-break (ties are the rule when no
        net model is attached or nothing is running).  A bound hazard
        model (faults/hazard.py — i.e. a hazard knob was armed)
        additionally discounts each pod's residual by ``1 + hazard``.
        The discount is gated on the BOUND MODEL, not on the score being
        nonzero: a pre-hazard config with stragglers (whose degrade
        penalty alone would make the score nonzero) must keep its pre-hazard
        pod orderings byte for byte."""
        if self.net is None:
            return sorted(pods)
        if getattr(self.inner, "_hazard_model", None) is None:
            return sorted(pods, key=lambda p: (-self.net.residual_gbps(p), p))
        return sorted(
            pods,
            key=lambda p: (
                -self.net.residual_gbps(p)
                / (1.0 + self.inner.hazard_score(("pod", p))),
                p,
            ),
        )

    def _health_pod_order(self, pods: List[int]) -> List[int]:
        """Health scoring: lowest hazard first — degraded-chip
        penalty plus the bound model's age/wear term — pod index as the
        deterministic tie-break (every pod ties at 0.0 on a healthy,
        hazard-free fleet, degrading to consolidated's order)."""
        return sorted(
            pods, key=lambda p: (self.inner.hazard_score(("pod", p)), p)
        )

    def allocate(self, num_chips: int, *, job=None, hint: Optional[dict] = None):
        if self.scheme == "consolidated":
            merged: dict = {}
        elif self.scheme == "contention":
            merged = {"pod_order": self._pod_order}
        elif self.scheme == "health":
            merged = {
                "pod_order": self._health_pod_order,
                "avoid_degraded": True,
            }
        else:
            merged = {"origin_order": self._origin_order}
        if hint:
            merged.update(hint)  # policy hints (overlay etc.) take precedence
        return self.inner.allocate(num_chips, job=job, hint=merged or None)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return f"PlacedTpuCluster({self.scheme}, {self.inner!r})"


def with_placement(cluster, scheme: str, *, seed: int = 0, net=None):
    """Attach a placement scheme to a cluster (flavor-appropriate).
    ``net`` (a :class:`~gpuschedule_tpu_torch.net.model.NetModel`) powers the
    TPU ``contention`` scheme's residual-bandwidth scoring; other schemes
    ignore it."""
    if isinstance(cluster, GpuCluster):
        if scheme not in GPU_SCHEMES:
            raise ValueError(f"unknown GPU scheme {scheme!r}; known: {GPU_SCHEMES}")
        cluster.scheme = scheme
        # the caller's seed must govern the scheme's randomness, or seed
        # sweeps through this entry point collapse to one replicate
        cluster._rng = random.Random(seed)
        return cluster
    if isinstance(cluster, TpuCluster):
        if scheme == "consolidated":
            return cluster  # the allocator default; no wrapper needed
        return PlacedTpuCluster(cluster, scheme, seed=seed, net=net)
    raise TypeError(f"no placement schemes for cluster type {type(cluster).__name__}")
