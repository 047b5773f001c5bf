"""Timing on the card, and the goodput curves the simulator reads."""

from gpuschedule_tpu_torch.profiler.goodput import CurveCache, GoodputCurve, fit_step_time_curve
from gpuschedule_tpu_torch.profiler.harness import (
    capture_trace,
    device_ms_per_launch,
    device_window,
    host_us_per_call,
    measure_step_time,
    profile_model,
    time_callable,
    time_steps,
)

__all__ = [
    "CurveCache", "GoodputCurve", "fit_step_time_curve", "capture_trace",
    "device_ms_per_launch", "device_window", "host_us_per_call",
    "measure_step_time", "profile_model", "time_callable", "time_steps",
]
