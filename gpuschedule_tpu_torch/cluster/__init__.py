"""Cluster models (own copies of the JAX package's): TPU pods as ICI tori
with contiguous slice allocation (``TpuCluster``), a flat counting pool
(``SimpleCluster``), a GPU node model (``GpuCluster``: switch, node and
GPU with NVLink locality) for the topology comparison, and the interconnect
constants and slice table that the goodput curve synthesis reads."""

from gpuschedule_tpu_torch.cluster.base import Allocation, ClusterBase, SimpleCluster
from gpuschedule_tpu_torch.cluster.gpu import GpuCluster, GpuPlacement
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
    "GpuCluster",
    "GpuPlacement",
    "TpuCluster",
    "SliceGeometry",
    "MultiSliceGeometry",
    "DCN_GBPS",
    "GENERATIONS",
    "next_pow2",
    "valid_slice_shapes",
]
