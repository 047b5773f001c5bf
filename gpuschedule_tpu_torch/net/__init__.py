"""Shared-fabric network contention model.

The port's own copy of ``gpuschedule_tpu/net/__init__.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

The simulator's multislice speed model priced every DCN-spanning gang in
isolation; this package models the *shared* fabric so contention becomes
a scheduling signal (the axis TopoOpt and Blink show changes placement
decisions at production scale):

- :mod:`gpuschedule_tpu_torch.net.fabric` — the capacitated topology graph:
  per-pod DCN uplinks (``hosts x DCN_GBPS``) feeding one aggregation
  core (``sum(uplinks) / oversubscription``);
- :mod:`gpuschedule_tpu_torch.net.maxmin` — the deterministic max-min fair
  allocator (progressive filling over the active flow set);
- :mod:`gpuschedule_tpu_torch.net.model` — ``NetModel``: per-job demands from
  the :mod:`~gpuschedule_tpu_torch.profiler.ici` analytic allreduce model,
  dynamic ``locality_factor`` re-pricing on every running-set change,
  ``("link", pod)`` fault degradation, residual-bandwidth scoring
  for the ``contention`` placement scheme, and — with redundant sibling
  uplinks (``uplinks_per_pod > 1``) — proportional-multipath
  adaptive routing around degraded links (``reroute`` events);
- :mod:`gpuschedule_tpu_torch.net.sweep` — the contention-vs-offered-load
  grid behind ``tools.net_sweep``.

Engine integration lives in :mod:`gpuschedule_tpu_torch.sim.engine`
(``Simulator(net=...)``, the ``net`` / ``netlink`` event kinds); the
link-utilization gauges are in :mod:`gpuschedule_tpu_torch.sim.metrics`.
Like the sim core, this package is host code.
"""

from gpuschedule_tpu_torch.net.fabric import (
    CORE,
    FabricTopology,
    Link,
    sibling_uplink,
    uplink,
)
from gpuschedule_tpu_torch.net.maxmin import Flow, maxmin_allocate
from gpuschedule_tpu_torch.net.model import (
    JobShare,
    LinkSample,
    NetConfig,
    NetModel,
    NetState,
    parse_net_spec,
)

__all__ = [
    "CORE",
    "FabricTopology",
    "Link",
    "sibling_uplink",
    "uplink",
    "Flow",
    "maxmin_allocate",
    "JobShare",
    "LinkSample",
    "NetConfig",
    "NetModel",
    "NetState",
    "parse_net_spec",
]
