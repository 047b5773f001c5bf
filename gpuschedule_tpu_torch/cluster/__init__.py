"""Cluster models (own copies of the JAX package's): TPU pods as ICI tori
with contiguous slice allocation (``TpuCluster``), a flat counting pool
(``SimpleCluster``), and the interconnect constants and slice table that the
goodput curve synthesis reads.  The GPU node model waits for its slice."""

from gpuschedule_tpu_torch.cluster.base import Allocation, ClusterBase, SimpleCluster
from gpuschedule_tpu_torch.cluster.tpu import (
    DCN_GBPS,
    GENERATIONS,
    MultiSliceGeometry,
    SliceGeometry,
    TpuCluster,
    next_pow2,
    valid_slice_shapes,
)

__all__ = [
    "Allocation",
    "ClusterBase",
    "SimpleCluster",
    "TpuCluster",
    "SliceGeometry",
    "MultiSliceGeometry",
    "DCN_GBPS",
    "GENERATIONS",
    "next_pow2",
    "valid_slice_shapes",
]
