"""Analytic ICI/DCN collective cost model.

Own copy of ``gpuschedule_tpu/profiler/ici.py``: the TPU interconnect model
that extends one measured step to larger slices, kept as it is so that a
curve written by this package is what the simulator expects (an H100
NVSwitch/InfiniBand model is an open question in ROADMAP.md).  A test holds
it equal to the original.

Ring allreduce of B bytes over k participants moves ``2(k-1)/k * B`` bytes
through each link; on a torus axis with wraparound the ring uses both
directions, doubling effective bandwidth.  Multi-axis slices allreduce
per-axis (the standard N-D torus decomposition), so axes contribute
additively with each axis reducing its own extent.
"""

from __future__ import annotations

import math

from gpuschedule_tpu_torch.cluster.tpu import DCN_GBPS, GENERATIONS, SliceGeometry

LATENCY_S = 1e-6  # per-hop launch latency floor per collective phase


def allreduce_seconds(
    bytes_per_chip: float,
    k: int,
    *,
    link_gbps: float,
    bidirectional: bool = False,
) -> float:
    """Ring-allreduce time for ``bytes_per_chip`` over ``k`` chips on one
    axis with per-link bandwidth ``link_gbps`` (Gbit/s)."""
    if k <= 1:
        return 0.0
    bw_bytes = link_gbps / 8.0 * 1e9 * (2.0 if bidirectional else 1.0)
    wire = 2.0 * (k - 1) / k * bytes_per_chip / bw_bytes
    return wire + (k - 1) * LATENCY_S


def slice_allreduce_seconds(
    bytes_per_chip: float,
    geom: SliceGeometry,
    *,
    generation: str,
) -> float:
    """Allreduce time over a granted slice, axis-decomposed.

    Each torus axis of extent > 1 runs a ring over that axis; the payload
    shrinks by the preceding axis's reduction factor as the N-D
    decomposition proceeds.  Wraparound axes (full torus extent) get the
    bidirectional ring.
    """
    spec = GENERATIONS[generation]
    total = 0.0
    remaining = float(bytes_per_chip)
    for extent, wraps in zip(geom.shape, geom.wrap_axes):
        if extent <= 1:
            continue
        total += allreduce_seconds(
            remaining,
            extent,
            link_gbps=spec["ici_gbps_per_link"],
            bidirectional=wraps,
        )
        remaining /= extent
    return total


def dp_gradient_bytes(param_count: int, *, dtype_bytes: int = 4) -> float:
    """Gradient payload per chip for data-parallel sync (f32 grads)."""
    return float(param_count) * dtype_bytes


def cross_pod_allreduce_seconds(
    bytes_per_chip: float, num_pods: int, *, dcn_gbps: float = DCN_GBPS
) -> float:
    """DCN-tier allreduce across pods (slices never span pods; multi-pod
    jobs sync over the datacenter network).

    ``dcn_gbps`` is the per-host DCN bandwidth the ring gets.
    ``dcn_gbps <= 0`` (a fully degraded uplink) returns ``inf``."""
    if num_pods <= 1:
        return 0.0
    if dcn_gbps <= 0.0:
        return math.inf
    bw_bytes = dcn_gbps / 8.0 * 1e9
    return 2.0 * (num_pods - 1) / num_pods * bytes_per_chip / bw_bytes + (
        num_pods - 1
    ) * 10 * LATENCY_S
