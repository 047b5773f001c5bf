"""Goodput curves: the Optimus-family step-time model, fitting, and cache.

Own copy of ``gpuschedule_tpu/profiler/goodput.py:42-295`` (numpy only), so
that a curve measured on the card lands in the ``CurveCache`` JSON that the
simulator's Optimus policy reads, in the same format byte for byte.  A test
holds it equal to the original.

The curve family is the data-parallel scaling law Optimus fits per model,
in alpha-beta form:

    step_time(k) = theta0 / k  +  theta1  +  theta2 * (k - 1)

theta0 = parallelizable compute, theta1 = serial work + the ring-allreduce
bandwidth asymptote, theta2 = per-hop collective latency.  The model is
linear in theta, so fitting is a non-negative least squares solved by
lstsq + active-set clipping.  ``synthesize_step_times`` extends one
measured step to larger k with the analytic TPU ICI/DCN term
(:mod:`gpuschedule_tpu_torch.profiler.ici`).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gpuschedule_tpu_torch.cluster.tpu import GENERATIONS, SliceGeometry, valid_slice_shapes
from gpuschedule_tpu_torch.profiler.ici import (
    cross_pod_allreduce_seconds,
    dp_gradient_bytes,
    slice_allreduce_seconds,
)


@dataclass(frozen=True)
class GoodputCurve:
    """Fitted step-time curve for one model.

    ``pod_chips``/``dcn_grad_bytes`` (optional) make the curve
    *multislice-aware*: the smooth three-parameter family is fit on
    intra-pod points only (it cannot represent the ICI→DCN cliff — a step
    discontinuity at the pod boundary), and :meth:`step_time_dcn` adds the
    analytic cross-pod allreduce phase for k beyond one pod.  Schedulers
    must plan with ``step_time_dcn`` but enact speed from the plain
    ``speed_factor``: the sim engine charges the DCN toll separately
    through ``job.locality_factor`` (``gpuschedule_tpu/cluster/tpu.py``
    ``_multislice_speed_factor``), so a DCN-aware enacted speed would
    double-count it.
    """

    theta: Tuple[float, float, float]
    pod_chips: Optional[int] = None      # multislice boundary (None: no DCN model)
    dcn_grad_bytes: Optional[float] = None  # per-chip dp-sync payload over DCN

    def step_time(self, k: int) -> float:
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        t0, t1, t2 = self.theta
        return t0 / k + t1 + t2 * (k - 1)

    @property
    def multislice_aware(self) -> bool:
        return self.pod_chips is not None and self.dcn_grad_bytes is not None

    def step_time_dcn(self, k: int, *, pod_chips: Optional[int] = None) -> float:
        """Planning-time step estimate including the DCN phase beyond one
        pod — the number marginal-gain decisions must use.  Falls back to
        the smooth family when the curve carries no multislice fields.

        ``pod_chips`` overrides the curve's own boundary: the cliff sits
        where the *cluster being scheduled* crosses pods (a curve profiled
        against the nominal v5e 256-chip pod would otherwise misplace the
        boundary on a custom-dims fleet)."""
        base = self.step_time(k)
        boundary = pod_chips if pod_chips is not None else self.pod_chips
        if boundary is not None and self.dcn_grad_bytes is not None and k > boundary:
            m = math.ceil(k / boundary)
            base += cross_pod_allreduce_seconds(self.dcn_grad_bytes, m)
        return base

    def throughput(self, k: int) -> float:
        """Steps per second at k chips."""
        return 1.0 / self.step_time(k)

    def speedup(self, k: int) -> float:
        """Throughput at k chips relative to one chip."""
        return self.step_time(1) / self.step_time(k)

    def speed_factor(self, k: int, ref_k: int) -> float:
        """Progress rate at k chips relative to the trace-declared ``ref_k``
        allocation — the engine's ``speed`` currency: wall time to finish
        W work on k chips = W * step_time(k) / step_time(ref_k)."""
        return self.step_time(ref_k) / self.step_time(k)

    def marginal_gain(self, k: int) -> float:
        """Throughput gained by the (k+1)-th chip — Optimus's allocation key."""
        return self.throughput(k + 1) - self.throughput(k)


def _design(ks: np.ndarray) -> np.ndarray:
    return np.stack([1.0 / ks, np.ones_like(ks), ks - 1.0], axis=1)


def fit_step_time_curve(
    ks: Sequence[int], times: Sequence[float]
) -> GoodputCurve:
    """Non-negative least squares fit of the curve family to measurements.

    lstsq first; any negative component is clamped to zero and the fit
    re-solved over the remaining features (one active-set pass per
    component, at most 3 — exact for this tiny, well-conditioned family).
    """
    ks_arr = np.asarray(ks, dtype=np.float64)
    ts = np.asarray(times, dtype=np.float64)
    if ks_arr.shape != ts.shape or ks_arr.size == 0:
        raise ValueError("ks and times must be equal-length, non-empty")
    if np.any(ks_arr < 1) or np.any(ts <= 0):
        raise ValueError("need k >= 1 and positive times")

    X = _design(ks_arr)
    active = [0, 1, 2]
    theta = np.zeros(3)
    for _ in range(3):
        sol, *_ = np.linalg.lstsq(X[:, active], ts, rcond=None)
        if np.all(sol >= 0):
            theta[:] = 0.0
            theta[active] = sol
            break
        # drop the most negative component and re-solve
        drop = active[int(np.argmin(sol))]
        active = [a for a in active if a != drop]
        if not active:
            theta[:] = 0.0
            break
    else:
        theta[:] = 0.0
        if active:
            sol, *_ = np.linalg.lstsq(X[:, active], ts, rcond=None)
            theta[active] = np.maximum(sol, 0.0)
    return GoodputCurve(tuple(float(t) for t in theta))


def mape(curve: GoodputCurve, ks: Sequence[int], times: Sequence[float]) -> float:
    """Mean absolute percentage error of the curve vs measurements —
    the BASELINE.json 10% contract metric."""
    errs = [
        abs(curve.step_time(k) - t) / t for k, t in zip(ks, times)
    ]
    return float(np.mean(errs))


# --------------------------------------------------------------------- #
# single-chip calibration + analytic extension


def synthesize_step_times(
    *,
    single_chip_step_s: float,
    param_count: int,
    generation: str,
    ks: Sequence[int],
    serial_fraction: float = 0.02,
    unit: int = 1,
) -> List[float]:
    """Predict step_time(k) from one measured baseline + the analytic ICI
    term.

    ``unit`` is how many chips the measured baseline spanned (1 for a
    plain single-chip measurement; sp*tp when the smallest model replica
    is itself sharded): compute scales as (1 - serial_fraction)/(k/unit)
    — adding replicas, data-parallel.  The collective term is the
    axis-decomposed ring allreduce of ``param_count`` f32 gradients per
    chip (callers divide by tp for tp-sharded params) over the squarest
    valid slice shape for k (what the allocator would grant).
    """
    spec = GENERATIONS[generation]
    dims = spec["pod_dims"]
    pod_chips = math.prod(dims)
    comp = single_chip_step_s * (1.0 - serial_fraction)
    serial = single_chip_step_s * serial_fraction
    grad_bytes = dp_gradient_bytes(param_count)
    full_pod = SliceGeometry(
        pod=0,
        origin=tuple(0 for _ in dims),
        shape=tuple(dims),
        wrap_axes=tuple(True for _ in dims),
    )
    out = []
    for k in ks:
        if k % unit:
            raise ValueError(f"k={k} is not a multiple of the measured unit {unit}")
        if k > pod_chips:
            # multislice: m whole pods — per-pod ICI allreduce, then the
            # cross-pod DCN phase on the already-reduced payload (this is
            # where the ICI-vs-DCN cliff enters the goodput curves)
            m, rem = divmod(k, pod_chips)
            if rem:
                raise ValueError(
                    f"{k} chips exceed one {generation} pod ({pod_chips}) "
                    "and are not a whole-pod multiple"
                )
            comm = slice_allreduce_seconds(
                grad_bytes, full_pod, generation=generation
            ) + cross_pod_allreduce_seconds(grad_bytes, m)
            out.append(comp / (k // unit) + serial + comm)
            continue
        shapes = valid_slice_shapes(k, dims)
        if not shapes:
            raise ValueError(f"{k} is not a valid slice size on {dims}")
        shape = shapes[0]
        geom = SliceGeometry(
            pod=0,
            origin=tuple(0 for _ in shape),
            shape=shape,
            wrap_axes=tuple(s == d for s, d in zip(shape, dims)),
        )
        comm = slice_allreduce_seconds(grad_bytes, geom, generation=generation)
        out.append(comp / (k // unit) + serial + comm)
    return out


# --------------------------------------------------------------------- #
# on-disk cache


class CurveCache:
    """JSON-backed store of fitted curves keyed by model name.

    Format: {model: {"theta": [t0, t1, t2], "source": "...", "points":
    {k: step_s}}} — points are kept so curves can be refit or audited.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._curves: Dict[str, GoodputCurve] = {}
        self._meta: Dict[str, dict] = {}
        if self.path.exists():
            self.load()

    def load(self) -> None:
        raw = json.loads(self.path.read_text())
        for name, entry in raw.items():
            ms = entry.get("multislice") or {}
            self._curves[name] = GoodputCurve(
                tuple(entry["theta"]),
                pod_chips=ms.get("pod_chips"),
                dcn_grad_bytes=ms.get("dcn_grad_bytes"),
            )
            self._meta[name] = {
                k: v for k, v in entry.items() if k not in ("theta", "multislice")
            }

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {}
        for name, curve in self._curves.items():
            entry = {"theta": list(curve.theta), **self._meta.get(name, {})}
            if curve.multislice_aware:
                entry["multislice"] = {
                    "pod_chips": curve.pod_chips,
                    "dcn_grad_bytes": curve.dcn_grad_bytes,
                }
            payload[name] = entry
        self.path.write_text(json.dumps(payload, indent=2, sort_keys=True))

    def put(
        self,
        model: str,
        curve: GoodputCurve,
        *,
        source: str = "measured",
        points: Optional[Dict[int, float]] = None,
    ) -> None:
        self._curves[model] = curve
        meta: dict = {"source": source}
        if points:
            meta["points"] = {str(k): v for k, v in points.items()}
        self._meta[model] = meta

    def get(self, model: str) -> Optional[GoodputCurve]:
        return self._curves.get(model)

    def __contains__(self, model: str) -> bool:
        return model in self._curves

    def models(self) -> List[str]:
        return sorted(self._curves)
