"""The TPU slice table and interconnect constants (own copy) that the goodput
curve synthesis reads."""

from gpuschedule_tpu_torch.cluster.tpu import (
    DCN_GBPS,
    GENERATIONS,
    SliceGeometry,
    valid_slice_shapes,
)

__all__ = ["DCN_GBPS", "GENERATIONS", "SliceGeometry", "valid_slice_shapes"]
