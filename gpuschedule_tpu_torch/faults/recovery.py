"""Fault recovery model: checkpoint rollback + restore cost.

The port's own copy of ``gpuschedule_tpu/faults/recovery.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_faults.py`` holds its results equal
to the original's, to the bit.

What a fault costs a victim job is decided here, not in the engine: the
engine mechanically applies whatever this model says.  The model is the
standard periodic-checkpoint one (the Philly clusters checkpointed
long-running jobs; Gandiva's suspend/resume measurements are the cost
anchor this repo already models in :mod:`gpuschedule_tpu_torch.sim.overhead`):

- **lost progress**: a job checkpoints every ``ckpt_interval``
  reference-speed seconds of work (per-job ``Job.ckpt_interval`` wins over
  the model default), so a revocation rolls ``executed_work`` back to the
  last checkpoint multiple — ``executed_work % interval`` work-seconds are
  forfeited.  ``interval=inf`` means "never checkpoints" (all progress
  lost); ``interval<=0`` means continuous checkpointing (nothing lost).
- **restore cost**: seconds of ``overhead_remaining`` charged at
  revocation time and burned (at wall-clock rate, before any new work
  accrues) once the job next runs — the existing suspend/resume overhead
  path.  ``restore="auto"`` derives the cost from the job's model size and
  gang via :func:`gpuschedule_tpu_torch.sim.overhead.resolve_overhead`; a float
  is a flat cost in seconds.
- **checkpoint-write cost** (priced recovery): the periodic
  checkpoints themselves are no longer free.  ``ckpt_write`` is the
  seconds one write takes (``"auto"`` sizes it from the model's training
  state streaming out through the slice's hosts,
  :func:`gpuschedule_tpu_torch.sim.overhead.ckpt_write_seconds`; 0 keeps the
  historical free-write model).  The engine folds it into
  ``Job.advance`` as the write-time fraction of every productive
  interval — charged to the ``overhead`` leg of the goodput and
  attribution decompositions — so a short ``ckpt_interval`` now trades
  steady overhead against less lost work per revocation.
- **emergency checkpoints**: a spot revocation announced
  ``spot_warning`` seconds ahead lets a victim checkpoint *at the
  warning* when the window covers the write cost: the engine charges the
  write as overhead inside the window and the rollback floor rises to
  the warned watermark (``Job.ckpt_protected``), so only the window's
  tail of work is lost instead of a full checkpoint interval.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Union

from gpuschedule_tpu_torch.faults.hazard import HazardConfig, hazard_config
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    FaultRecord,
    generate_fault_schedule,
)
from gpuschedule_tpu_torch.sim.overhead import (
    ckpt_write_seconds as _ckpt_write_seconds,
    cluster_generation,
    resolve_overhead,
)


@dataclass
class RecoveryModel:
    """How a victim job recovers from a revocation — and what staying
    recoverable costs while nothing is failing (the checkpoint-write
    price)."""

    ckpt_interval: float = 1800.0           # work-seconds between checkpoints
    restore: Union[float, str] = "auto"     # seconds, or "auto" (sim/overhead.py)
    ckpt_write: Union[float, str] = 0.0     # seconds per periodic checkpoint
                                            # write ("auto" sizes it from model
                                            # state bytes; 0 = free, the unpriced
                                            # model — the regression default)

    def checkpoint_interval(self, job) -> float:
        ji = getattr(job, "ckpt_interval", None)
        return self.ckpt_interval if ji is None else float(ji)

    def writes_cost(self) -> bool:
        """True when checkpoint writes are priced (``ckpt_write`` armed)."""
        return self.ckpt_write == "auto" or float(self.ckpt_write) > 0.0

    def ckpt_write_seconds(self, job, cluster) -> float:
        """Seconds one checkpoint write (periodic or emergency) takes for
        this job: the flat knob, or the modeled state-streaming time."""
        if self.ckpt_write == "auto":
            return _ckpt_write_seconds(
                job.model_name,
                max(1, job.allocated_chips or job.num_chips),
                generation=cluster_generation(cluster),
            )
        return float(self.ckpt_write)

    def lost_progress(self, job, *, use_emergency: bool = True) -> float:
        """Reference-speed seconds of work rolled back by one revocation.

        The rollback floor is the newest of the periodic-checkpoint
        multiple and the emergency watermark a warned spot revocation
        wrote (``Job.ckpt_protected``); ``use_emergency=False`` reports
        the unwarned loss, which is how the engine tells warned from
        unwarned revocations in the event stream."""
        interval = self.checkpoint_interval(job)
        if interval <= 0.0:
            return 0.0
        if math.isinf(interval):
            lost = job.executed_work
        else:
            lost = math.fmod(job.executed_work, interval)
        if use_emergency:
            protected = getattr(job, "ckpt_protected", None)
            if protected is not None:
                lost = min(
                    lost,
                    job.executed_work - min(protected, job.executed_work),
                )
        return lost

    def restore_overhead(self, job, cluster) -> float:
        """Seconds of modeled restart cost charged to one victim."""
        return resolve_overhead(self.restore, job, cluster)


@dataclass
class FaultPlan:
    """Everything the engine needs to run a faulty replay: the (already
    generated, time-sorted) fault schedule plus the recovery model applied
    to every victim.  An empty ``records`` list is a valid plan — the
    fault path is armed but never fires (the ``mtbf=inf`` case).

    ``hazard`` is the armed hazard knobs when any is set: the
    engine builds a runtime :class:`~gpuschedule_tpu_torch.faults.hazard.
    HazardModel` from it, binds it to the cluster (so
    ``cluster.hazard_score`` answers), and arms the proactive
    checkpoint-and-migrate trigger.  None — the default — keeps the
    hazard machinery entirely out of the run."""

    records: List[FaultRecord] = field(default_factory=list)
    recovery: RecoveryModel = field(default_factory=RecoveryModel)
    hazard: Optional["HazardConfig"] = None


def make_fault_plan(
    cluster,
    config: Optional[FaultConfig] = None,
    recovery: Optional[RecoveryModel] = None,
    *,
    horizon: float,
    seed: int = 0,
) -> FaultPlan:
    """Convenience constructor: generate the schedule and bundle it with a
    recovery model (both defaulted) into one plan.  Hazard knobs on the
    config (``hazard_shape`` / ``hazard_util_weight`` /
    ``migrate_threshold``) ride along as ``plan.hazard``."""
    config = config or FaultConfig()
    return FaultPlan(
        records=generate_fault_schedule(
            cluster, config, horizon=horizon, seed=seed
        ),
        recovery=recovery or RecoveryModel(),
        hazard=hazard_config(config),
    )
