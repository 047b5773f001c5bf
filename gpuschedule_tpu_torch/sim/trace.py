"""Trace ingestion: synthetic Poisson workloads and CSV traces.

The port's own copy of ``gpuschedule_tpu/sim/trace.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_sim*.py`` hold its replays equal
to the original's, to the bit.

The reference replays Microsoft Philly traces and synthetic (Poisson) traces
(SURVEY.md §1 layer 4, §2 "Trace data").  This module provides:

- :func:`generate_poisson_trace` — synthetic open-arrival workload with
  Poisson inter-arrival times, mixed gang sizes, and heavy-tailed durations
  (the classic cluster-sim workload shape);
- :func:`load_trace_csv` / :func:`save_trace_csv` — the framework's native
  trace schema (one row per job);
- the Philly-schema loader lives in :mod:`gpuschedule_tpu_torch.sim.philly`.

Determinism: all randomness flows through a caller-supplied seed so a fixed
(trace, cluster, policy) triple reproduces identical JCT/makespan numbers
run-to-run — that reproducibility is the integration-test strategy
(SURVEY.md §4 "Deterministic replay as the integration test").
"""

from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from gpuschedule_tpu_torch.sim.job import Job

# Native trace schema, one row per job.
TRACE_FIELDS = [
    "job_id",
    "submit_time",
    "num_chips",
    "duration",
    "model_name",
    "iterations",
    "status",
    "user",
    "utilization",
]

# Default gang-size mix: mostly small jobs with a tail of large ones, the
# empirical shape of the Philly workload (most jobs are 1-GPU; a minority are
# distributed) [P: Philly ATC'19].  Sizes are powers of two so they map onto
# valid TPU slice shapes without rounding.
DEFAULT_SIZE_WEIGHTS: Sequence[tuple[int, float]] = (
    (1, 0.45),
    (2, 0.15),
    (4, 0.15),
    (8, 0.13),
    (16, 0.07),
    (32, 0.04),
    (64, 0.01),
)

DEFAULT_MODELS: Sequence[str] = (
    "transformer-tiny",
    "transformer-small",
    "transformer-base",
    "mlp-wide",
)


def generate_poisson_trace(
    num_jobs: int,
    *,
    seed: int = 0,
    arrival_rate: float = 1.0 / 60.0,     # jobs per second (mean interarrival 60s)
    mean_duration: float = 3600.0,        # seconds; lognormal heavy tail
    sigma: float = 1.2,                   # lognormal shape for durations
    size_weights: Sequence[tuple[int, float]] = DEFAULT_SIZE_WEIGHTS,
    models: Sequence[str] = DEFAULT_MODELS,
    failure_rate: float = 0.0,            # fraction of jobs ending Failed/Killed
    util_range: tuple[float, float] = (1.0, 1.0),  # uniform profiled-utilization
                                          # draw; widen (e.g. (0.3, 1.0)) to give
                                          # Gandiva packing candidates
) -> List[Job]:
    """Generate an open-arrival synthetic trace.

    Inter-arrival times are exponential(arrival_rate); durations are lognormal
    scaled to the requested mean; gang sizes are drawn from ``size_weights``.
    With ``failure_rate`` > 0 a matching fraction of jobs carries a
    Failed/Killed trace status (fault-injection path, SURVEY.md §5).
    """
    rng = random.Random(seed)
    sizes = [s for s, _ in size_weights]
    weights = [w for _, w in size_weights]
    # Scale the lognormal so its mean equals mean_duration.
    import math

    mu = math.log(mean_duration) - sigma * sigma / 2.0

    jobs: List[Job] = []
    t = 0.0
    for i in range(num_jobs):
        t += rng.expovariate(arrival_rate)
        duration = max(1.0, rng.lognormvariate(mu, sigma))
        status = "Pass"
        if failure_rate > 0.0 and rng.random() < failure_rate:
            status = rng.choice(["Failed", "Killed"])
        lo, hi = util_range
        jobs.append(
            Job(
                job_id=f"j{i:05d}",
                submit_time=round(t, 3),
                num_chips=rng.choices(sizes, weights=weights)[0],
                duration=round(duration, 3),
                model_name=rng.choice(list(models)),
                iterations=max(1, int(duration)),  # 1 it/s nominal
                status=status,
                utilization=round(rng.uniform(lo, hi), 3),
            )
        )
    return jobs


def save_trace_csv(jobs: Iterable[Job], path: str | Path) -> None:
    """Write jobs in the native trace schema."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_FIELDS)
        for j in jobs:
            w.writerow(
                [
                    j.job_id,
                    j.submit_time,
                    j.num_chips,
                    j.duration,
                    j.model_name,
                    j.iterations if j.iterations is not None else "",
                    j.status,
                    j.user,
                    j.utilization,
                ]
            )


def load_trace_csv(path: str | Path) -> List[Job]:
    """Load a native-schema trace CSV, sorted by submit time."""
    jobs: List[Job] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            jobs.append(
                Job(
                    job_id=row["job_id"],
                    submit_time=float(row["submit_time"]),
                    num_chips=int(row["num_chips"]),
                    duration=float(row["duration"]),
                    model_name=row.get("model_name") or "transformer-tiny",
                    iterations=int(row["iterations"]) if row.get("iterations") else None,
                    status=row.get("status") or "Pass",
                    user=row.get("user") or "",
                    utilization=float(row["utilization"]) if row.get("utilization") else 1.0,
                )
            )
    jobs.sort(key=lambda j: (j.submit_time, j.job_id))
    return jobs
