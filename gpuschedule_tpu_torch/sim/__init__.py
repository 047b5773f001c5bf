"""Simulation core: job model, traces, discrete-event engine, metrics (own
copies of the JAX package's ``sim/``).

This layer runs no device code: trace replay runs end to end with no
accelerator in the loop.  The device is reached only through Optimus's
online profiling (:mod:`gpuschedule_tpu_torch.policies.optimus`).
"""

from gpuschedule_tpu_torch.sim.job import Job, JobState
from gpuschedule_tpu_torch.sim.jobset import JobSet
from gpuschedule_tpu_torch.sim.engine import Simulator, SimResult

__all__ = ["Job", "JobState", "JobSet", "Simulator", "SimResult"]
