"""Track names of the replay timeline.

The port's own copy of ``track_label`` from ``gpuschedule_tpu/obs/perfetto.py``,
the one name the simulator's engine imports from there: every lifecycle
event it records carries the track of the job's allocation.  The Chrome
trace export around it comes with the events stream, in a later slice.
"""

from __future__ import annotations

from typing import Any


def track_label(detail: Any) -> str:
    """Human track name for an allocation's flavor-specific detail.

    Duck-typed on the detail dataclasses (SliceGeometry / MultiSliceGeometry
    / GpuPlacement / None) so the sim layer stays import-light."""
    if detail is None:
        return "pool"
    slices = getattr(detail, "slices", None)
    if slices is not None:  # multislice gang: one track spanning its pods
        return "dcn/" + "+".join(track_label(s) for s in slices)
    pod = getattr(detail, "pod", None)
    if pod is not None:
        shape = "x".join(str(s) for s in getattr(detail, "shape", ()))
        origin = ",".join(str(o) for o in getattr(detail, "origin", ()))
        return f"pod{pod}/{shape}@{origin}"
    nodes = getattr(detail, "nodes", None)
    if nodes is not None:  # GpuPlacement: (switch, node) ids
        return "gpu/" + "+".join(f"s{s}n{n}" for (s, n), _ in nodes)
    return str(detail)
