"""Contention-vs-offered-load sweep: what does multislice share cost?

The question the shared-fabric model exists to answer at the grid level:
as the *multislice share* of the workload rises (the fraction of jobs
that span pods and therefore compete for the aggregation core), how fast
do aggregate goodput and the slowdown tail degrade, and which policies
degrade most gracefully?  Mirrors :mod:`gpuschedule_tpu_torch.faults.sweep`
(the MTBF grid): one seeded Philly-like trace per cell, a deterministic
subset of jobs promoted to 2-pod multislice gangs, the same eight-policy
suite, one JSON-ready artifact.  ``python -m
gpuschedule_tpu_torch.tools.net_sweep`` is the CLI wrapper; the functions
are importable so a test can run one tiny cell end to end.  The port's
own copy of ``gpuschedule_tpu/net/sweep.py``: its artifacts are the JAX
package's, to the byte.
"""

from __future__ import annotations

import math
import random
from typing import Iterable, Optional, Sequence

from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.faults.sweep import POLICY_CONFIGS, jsonable  # noqa: F401
from gpuschedule_tpu_torch.net.model import NetConfig, NetModel
from gpuschedule_tpu_torch.obs.fleet import (
    task_profiler as _task_profiler,
    task_span as _task_span,
)
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace

# Default offered-load grid: the multislice share of the job mix.
DEFAULT_SHARES = (0.0, 0.05, 0.1, 0.2)


def promote_to_multislice(jobs, share: float, pod_chips: int, *, seed: int = 0):
    """Deterministically promote ``share`` of ``jobs`` to 2-pod multislice
    gangs (``2 * pod_chips`` chips, a gradient-heavy model so the DCN toll
    is visible).  Seeded independently of the trace stream (the same
    seed-split rule faults/ uses): the un-promoted jobs are byte-identical
    across shares, so cells differ only by the promotion itself."""
    k = round(share * len(jobs))
    if k <= 0:
        return jobs
    rng = random.Random(f"{seed}:net:share")
    for i in sorted(rng.sample(range(len(jobs)), k)):
        jobs[i].num_chips = 2 * pod_chips
        jobs[i].model_name = "transformer-base"
    return jobs


def run_cell(
    policy_key: str,
    *,
    multislice_share: float,
    num_jobs: int = 200,
    seed: int = 0,
    dims: Sequence[int] = (4, 4),
    num_pods: int = 4,
    oversubscription: float = 4.0,
    ingest: float = 0.05,
    max_time: Optional[float] = None,
    attribution: bool = False,
) -> dict:
    """One (policy, multislice-share) cell on a fresh cluster + trace +
    net model.  Deterministic per argument tuple.  ``attribution`` arms
    the causal layer: the cell then reports ``delay_by_cause``
    — in particular the ``net-degraded`` leg, the seconds the share's
    jobs lost to fabric contention rather than queueing."""
    if num_pods < 2:
        raise ValueError("the contention sweep needs num_pods >= 2")
    name, kwargs = POLICY_CONFIGS[policy_key]
    # same worker-side build/replay spans + per-cell engine
    # profiler as the MTBF grid; no-ops when no fleet harness is armed
    with _task_span("build", cat="sweep", policy=policy_key):
        cluster = TpuCluster("v5e", dims=tuple(dims), num_pods=num_pods)
        jobs = promote_to_multislice(
            generate_philly_like_trace(num_jobs, seed=seed),
            multislice_share, cluster.pod_chips, seed=seed,
        )
        net = NetModel(NetConfig(
            oversubscription=oversubscription, ingest_gbps_per_chip=ingest,
        ))
    metrics = MetricsLog(attribution=attribution) if attribution else None
    with _task_span("replay", cat="sweep", policy=policy_key,
                    share=multislice_share, seed=seed):
        res = Simulator(
            cluster, make_policy(name, **kwargs), jobs,
            metrics=metrics,
            net=net,
            max_time=max_time if max_time is not None else math.inf,
            profiler=_task_profiler(),
        ).run()
    cell_extra = (
        {"delay_by_cause": dict(res.delay_by_cause)}
        if res.delay_by_cause else {}
    )
    return {
        **cell_extra,
        "policy": policy_key,
        "multislice_share": multislice_share,
        "avg_jct": res.avg_jct,
        "p95_slowdown": res.p95_slowdown,
        "makespan": res.makespan,
        "num_finished": res.num_finished,
        "num_unfinished": res.num_unfinished,
        "net_reprices": int(res.counters.get("net_reprices", 0)),
        "goodput": dict(res.goodput),
        "mean_link_utilization": net.mean_utilization(),
    }


def _share_cell(key: str, share: float, cell_kwargs: dict) -> dict:
    """Module-level cell thunk (picklable for the process pool)."""
    return run_cell(key, multislice_share=share, **cell_kwargs)


def sweep(
    shares: Iterable[float] = DEFAULT_SHARES,
    policies: Optional[Iterable[str]] = None,
    *,
    workers: int = 1,
    fleet=None,
    **cell_kwargs,
) -> dict:
    """The full grid: ``{"multislice_share": [...], "policies": {name:
    [cell, ...]}}`` with each policy's cells ordered like the shares.

    ``workers`` > 1 fans the cells across a process pool (each cell is an
    isolated seeded replay — the faults/sweep.py grid_cells machinery);
    the reassembled artifact is byte-identical to the serial one.
    ``fleet`` arms cross-process tracing (see
    :func:`gpuschedule_tpu_torch.faults.sweep.grid_cells`)."""
    shares = list(shares)
    keys = list(policies) if policies is not None else list(POLICY_CONFIGS)
    unknown = [k for k in keys if k not in POLICY_CONFIGS]
    if unknown:
        raise ValueError(
            f"unknown policy configs {unknown}; known: {sorted(POLICY_CONFIGS)}"
        )
    from functools import partial

    from gpuschedule_tpu_torch.faults.sweep import grid_cells

    out = grid_cells(
        keys, shares, partial(_share_cell, cell_kwargs=cell_kwargs),
        workers=workers, fleet=fleet,
    )
    return {"multislice_share": shares, "policies": out}
