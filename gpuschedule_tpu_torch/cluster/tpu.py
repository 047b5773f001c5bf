"""TPU interconnect constants and slice shapes: what the curve synthesis reads.

Own copy of ``gpuschedule_tpu/cluster/tpu.py:58-156`` (``GENERATIONS``,
``DCN_GBPS``, ``valid_slice_shapes``, ``SliceGeometry``), so that a goodput
curve written by this package is the curve the simulator expects.  The
slice allocator stays in the JAX package.  A test holds this copy equal to
the original.

A pod is an ICI torus (2D for v5e, 3D for v5p) and an allocation is a
slice: an axis-aligned box whose extents are powers of two.  The
collective model (:mod:`gpuschedule_tpu_torch.profiler.ici`) prices an
allreduce over the squarest such box.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

# Modeled per-generation interconnect constants consumed by the profiler's
# analytic allreduce term.  Values are modeled approximations of public
# specs, calibrated away by measurement: what matters for policy
# comparisons is the *relative* ICI-vs-DCN and per-generation scaling, not
# the absolute GB/s.
GENERATIONS: Dict[str, dict] = {
    "v5e": {
        "torus_ndim": 2,
        "pod_dims": (16, 16),
        "ici_gbps_per_link": 400.0,     # per ICI link, per direction
        "hbm_gbps": 819.0 * 8,          # 819 GB/s HBM BW
        "bf16_tflops": 197.0,
        "chips_per_host": 8,
    },
    "v5p": {
        "torus_ndim": 3,
        "pod_dims": (8, 8, 4),          # 256-chip pod ("v5p-256" scale)
        "ici_gbps_per_link": 800.0,
        "hbm_gbps": 2765.0 * 8,
        "bf16_tflops": 459.0,
        "chips_per_host": 4,
    },
}

DCN_GBPS = 100.0  # modeled per-host DCN bandwidth (across-pod collectives)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def valid_slice_shapes(num_chips: int, dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """All axis-aligned shapes for a ``num_chips`` slice inside ``dims``.

    A valid shape factors ``num_chips`` into one power-of-two extent per
    torus axis, each fitting its axis.  Sorted squarest-first: minimal
    max/min extent ratio, then minimal surface area — the ICI-friendly
    preference order.  Empty list when ``num_chips`` is not a power of two
    or exceeds what any box in ``dims`` can hold.
    """
    return list(_valid_slice_shapes(num_chips, tuple(dims)))


@functools.lru_cache(maxsize=4096)
def _valid_slice_shapes(num_chips: int, dims: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Cached core of :func:`valid_slice_shapes`."""
    if not _is_pow2(num_chips):
        return ()
    ndim = len(dims)
    shapes = set()

    def rec(prefix: Tuple[int, ...], remaining: int) -> None:
        axis = len(prefix)
        if axis == ndim - 1:
            if remaining <= dims[axis]:
                shapes.add(prefix + (remaining,))
            return
        f = 1
        while f <= min(remaining, dims[axis]):
            if remaining % f == 0:
                rec(prefix + (f,), remaining // f)
            f <<= 1

    rec((), num_chips)

    def squareness(shape: Tuple[int, ...]) -> Tuple[float, int, Tuple[int, ...]]:
        ratio = max(shape) / min(shape)
        # surface area ~ sum over axes of (volume / extent): lower = squarer
        surface = sum(num_chips // s for s in shape)
        return (ratio, surface, shape)

    return tuple(sorted(shapes, key=squareness))


@dataclass(frozen=True)
class SliceGeometry:
    """Where a slice sits in its pod.

    ``wrap_axes[i]`` is True when the slice spans the full torus extent on
    axis ``i`` and therefore owns that axis's wraparound ICI links.
    """

    pod: int
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]
    wrap_axes: Tuple[bool, ...]

    @property
    def num_chips(self) -> int:
        return math.prod(self.shape)

    def chips(self) -> Iterator[Tuple[int, ...]]:
        """Yield the pod-local coordinates of every chip in the slice."""
        for offs in itertools.product(*[range(s) for s in self.shape]):
            yield tuple(o + d for o, d in zip(self.origin, offs))
