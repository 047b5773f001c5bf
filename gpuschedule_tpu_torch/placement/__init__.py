"""Placement schemes (SURVEY.md §2 "Placement schemes", layer 7).

The port's own copy of ``gpuschedule_tpu/placement/__init__.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_topology.py`` holds its results equal
to the original's, to the bit.

One knob, two cluster flavors:

- **GpuCluster** implements consolidated / random / greedy / topology
  selection natively (which GPUs a gang gets decides its NVLink locality
  tier and therefore its speed factor) — ``with_placement`` just validates
  and sets the scheme.
- **TpuCluster** slices are contiguous whatever happens, so a scheme only
  chooses WHERE the box goes: the origin-order injection point the
  allocator exposes (``hint["origin_order"]``).  ``consolidated`` packs
  toward the origin corner (the allocator default), ``random`` picks a
  random free origin (seeded, deterministic), ``spread`` packs toward the
  far corner — keeping the origin region clear for large slices.
  ``contention`` (net/) searches pods by residual DCN uplink bandwidth
  (``hint["pod_order"]``), steering gangs away from loaded uplinks.

``with_placement(cluster, scheme, seed, net=...)`` is the single entry
point the CLI and experiments use.
"""

from gpuschedule_tpu_torch.placement.schemes import PlacedTpuCluster, with_placement

__all__ = ["with_placement", "PlacedTpuCluster"]
