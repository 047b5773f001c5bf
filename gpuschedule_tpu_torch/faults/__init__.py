"""Fault injection & recovery.

The port's own copy of ``gpuschedule_tpu/faults/__init__.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

A new axis of the simulation: hardware breaks.  The package splits into

- :mod:`gpuschedule_tpu_torch.faults.schedule` — deterministic seeded fault-
  schedule generators (per-chip MTBF exponential processes, planned
  maintenance windows, spot/preemptible revocation) emitting
  ``FaultRecord(time, scope, duration, kind)`` records, plus the CLI
  ``--faults`` spec parser and the seed-split rule shared with trace
  synthesis;
- :mod:`gpuschedule_tpu_torch.faults.recovery` — the victim recovery model
  (checkpoint-interval rollback + restore cost) and the ``FaultPlan``
  bundle the engine consumes;
- :mod:`gpuschedule_tpu_torch.faults.sweep` — the MTBF x policy robustness
  grid behind ``tools.fault_sweep`` and the CLI ``faults`` demo.

The engine side lives in :mod:`gpuschedule_tpu_torch.sim.engine` (``_FAULT`` /
``_REPAIR`` event kinds); the cluster side is the health mask each
flavor implements (``mark_unhealthy`` / ``repair`` / ``unhealthy_chips``
in :mod:`gpuschedule_tpu_torch.cluster`).  Like the sim core, this package is
host code.
"""

from gpuschedule_tpu_torch.faults.hazard import HazardConfig, HazardModel, hazard_config
from gpuschedule_tpu_torch.faults.recovery import FaultPlan, RecoveryModel, make_fault_plan
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    FaultRecord,
    fault_horizon,
    generate_fault_schedule,
    parse_fault_spec,
)

__all__ = [
    "FaultConfig",
    "FaultRecord",
    "FaultPlan",
    "RecoveryModel",
    "HazardConfig",
    "HazardModel",
    "fault_horizon",
    "generate_fault_schedule",
    "hazard_config",
    "make_fault_plan",
    "parse_fault_spec",
]
