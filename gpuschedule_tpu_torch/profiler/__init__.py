"""Timing on the card, and the goodput curves the simulator reads."""

from gpuschedule_tpu_torch.profiler.goodput import CurveCache, GoodputCurve, fit_step_time_curve
from gpuschedule_tpu_torch.profiler.harness import (
    capture_trace,
    measure_step_time,
    profile_model,
    time_callable,
    time_steps,
)

__all__ = [
    "CurveCache", "GoodputCurve", "fit_step_time_curve", "capture_trace",
    "measure_step_time", "profile_model", "time_callable", "time_steps",
]
