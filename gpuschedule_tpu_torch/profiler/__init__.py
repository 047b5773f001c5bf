"""Timing on the card."""

from gpuschedule_tpu_torch.profiler.harness import measure_step_time, time_callable, time_steps

__all__ = ["measure_step_time", "time_callable", "time_steps"]
