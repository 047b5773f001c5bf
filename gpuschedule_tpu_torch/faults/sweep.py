"""MTBF sweep harness: goodput-vs-failure-rate across the policy suite.

The robustness question the fault subsystem exists to answer is "which
policy degrades most gracefully as hardware gets flakier?".  This module
runs it as a grid: for each (policy config, MTBF) cell, replay the same
seeded Philly-like trace on a fresh cluster with a freshly generated
fault schedule, and report the goodput decomposition (useful / lost /
restart-overhead chip-seconds) next to the usual JCT/makespan headline
numbers.  ``python -m gpuschedule_tpu_torch.tools.fault_sweep`` writes the
JSON artifact; the functions here are importable so a test can run one
tiny cell end to end.  The port's own copy of
``gpuschedule_tpu/faults/sweep.py``: its artifacts are the JAX package's,
to the byte.

``POLICY_CONFIGS`` is the eight-point policy suite the sweep covers: the
six registered policies plus the two variants that change their failure
story (FIFO with backfill — head-of-line blocking interacts badly with
requeued victims — and SRTF with model-derived restart costs).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.faults.recovery import FaultPlan, RecoveryModel
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    fault_horizon,
    generate_fault_schedule,
    scope_capacity,
)

# Fault kinds that take capacity out of the pool (availability accounting);
# link and straggler records only degrade, they never remove chips.
_CAPACITY_KINDS = ("mtbf", "maintenance", "spot", "domain")
from gpuschedule_tpu_torch.obs.fleet import (
    task_profiler as _task_profiler,
    task_span as _task_span,
)
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace

# name -> (registry policy, constructor kwargs): the eight-policy suite.
POLICY_CONFIGS: Dict[str, Tuple[str, dict]] = {
    "fifo": ("fifo", {}),
    "fifo-backfill": ("fifo", {"backfill": True}),
    "srtf": ("srtf", {}),
    "srtf-ckpt": ("srtf", {"restart_overhead": "auto"}),
    "dlas": ("dlas", {}),
    "gandiva": ("gandiva", {}),
    "optimus": ("optimus", {}),
    "themis": ("themis", {}),
}

# Default sweep grid: one-failure-a-month-per-chip down to one-an-hour,
# plus inf (the fault-free control arm).
DEFAULT_MTBFS: Tuple[float, ...] = (
    math.inf, 30 * 86400.0, 7 * 86400.0, 86400.0, 6 * 3600.0, 3600.0
)


def jsonable(obj):
    """Strict-JSON projection: non-finite floats become the strings
    "inf"/"-inf"/"nan" (json.dumps would otherwise emit the non-standard
    ``Infinity`` token, which jq / JSON.parse / any spec-compliant reader
    rejects — and the inf control arm is on the DEFAULT grid)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return "nan" if math.isnan(obj) else ("inf" if obj > 0 else "-inf")
    if isinstance(obj, dict):
        return {k: jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    return obj


def availability_summary(cluster, records, end_time: float) -> dict:
    """Availability and MTTR columns for one cell, from the fault
    schedule the replay actually saw (records past ``end_time`` never
    fired).

    - ``availability``: 1 - (downed chip-seconds / total chip-seconds),
      summing each capacity-outage record's scope size times its
      horizon-capped duration.  Overlapping outages on the same chips
      are double-counted (the per-record sum is an upper bound on
      downtime, so this is a lower bound on availability — exact
      whenever outages don't overlap).
    - ``mttr_s``: mean repair time over the finite-duration capacity
      outages that fired (``nan`` when none did — the fault-free control
      arm; the JSON writers map it through the "inf"/"nan" string
      convention)."""
    downtime = 0.0
    repairs: List[float] = []
    for rec in records:
        if rec.time > end_time or rec.kind not in _CAPACITY_KINDS:
            continue
        span = max(0.0, min(rec.duration, end_time - rec.time))
        downtime += scope_capacity(cluster, rec.scope) * span
        if math.isfinite(rec.duration):
            repairs.append(rec.duration)
    cap = cluster.total_chips * end_time
    return {
        "availability": (
            max(0.0, 1.0 - downtime / cap) if cap > 0 else 1.0
        ),
        "mttr_s": sum(repairs) / len(repairs) if repairs else float("nan"),
    }


def run_cell(
    policy_key: str,
    *,
    mtbf: float,
    repair: float = 3600.0,
    ckpt: float = 1800.0,
    restore="auto",
    ckpt_write=0.0,
    num_jobs: int = 200,
    seed: int = 0,
    dims: Sequence[int] = (8, 8),
    num_pods: int = 1,
    max_time: Optional[float] = None,
    events_path=None,
    attribution: bool = False,
    sample_interval: Optional[float] = None,
    domain_mtbf: float = math.inf,
    domain_repair: float = 2 * 3600.0,
    domain_weights: Optional[Dict[str, float]] = None,
    hazard_shape: float = 1.0,
    hazard_util_weight: float = 0.0,
    migrate_threshold: float = math.inf,
    straggler_mtbf: float = math.inf,
    straggler_repair: float = 3600.0,
    straggler_degrade: float = 0.5,
    spot_fraction: float = 0.0,
    spot_mtbf: float = 4 * 3600.0,
    spot_outage: float = 1800.0,
    spot_warning: float = 0.0,
) -> dict:
    """Run one (policy, MTBF) cell on a fresh cluster + trace + schedule.

    Jobs are regenerated per cell (the engine mutates them), the fault
    schedule is regenerated from the same seed (seed-split rule in
    :mod:`gpuschedule_tpu_torch.faults.schedule`), so any two calls with the
    same arguments produce identical results.

    ``events_path`` streams the cell's transition log there as JSONL,
    opened with a schema header (the cell's identity; the config hash
    covers everything but the policy, so two cells at the same seed are
    `compare`-compatible) — the CLI ``faults --events DIR`` path.

    ``attribution`` / ``sample_interval`` arm the causal-attribution and
    cluster-sampling layers: the captured stream then carries
    blame/sample records and the cell reports ``delay_by_cause``, so a
    chaos sweep answers not just *how much* goodput each policy lost but
    *where its jobs' time went* — defaults keep every existing cell
    byte-identical.

    Fault knobs: ``domain_*`` (correlated host/rack/pod
    outages), ``straggler_*`` (slow chips), ``spot_*`` (+ the
    ``spot_warning`` pre-revoke window), and ``ckpt_write`` (priced
    checkpoint writes) — all defaulting off, so pre-existing grids stay
    byte-identical.  Every cell additionally reports ``availability``
    and ``mttr_s`` next to the goodput decomposition.

    Hazard knobs (same default-off, hash-gated contract):
    ``domain_weights`` (per-level outage-rate multipliers),
    ``hazard_shape`` / ``hazard_util_weight`` (Weibull-aged,
    wear-scored failure hazard), and ``migrate_threshold`` (proactive
    checkpoint-and-migrate trigger; arms ``plan.hazard``).
    """
    from gpuschedule_tpu_torch.faults.hazard import hazard_config

    name, kwargs = POLICY_CONFIGS[policy_key]
    # under a fleet task harness (pooled or serial sweep with
    # tracing armed) the cell's build/replay phases land as worker-side
    # spans and the engine runs a per-cell PhaseProfiler; all three hooks
    # are one-global-read no-ops disarmed, so bare cells stay identical
    with _task_span("build", cat="sweep", policy=policy_key):
        cluster = TpuCluster("v5e", dims=tuple(dims), num_pods=num_pods)
        jobs = generate_philly_like_trace(num_jobs, seed=seed)
        horizon = max_time if max_time is not None else fault_horizon(jobs)
        fconfig = FaultConfig(
            mtbf=mtbf, repair=repair,
            domain_mtbf=domain_mtbf, domain_repair=domain_repair,
            domain_weights=domain_weights,
            hazard_shape=hazard_shape,
            hazard_util_weight=hazard_util_weight,
            migrate_threshold=migrate_threshold,
            straggler_mtbf=straggler_mtbf,
            straggler_repair=straggler_repair,
            straggler_degrade=straggler_degrade,
            spot_fraction=spot_fraction, spot_mtbf=spot_mtbf,
            spot_outage=spot_outage, spot_warning=spot_warning,
        )
        plan = FaultPlan(
            records=generate_fault_schedule(
                cluster, fconfig, horizon=horizon, seed=seed,
            ),
            recovery=RecoveryModel(
                ckpt_interval=ckpt, restore=restore, ckpt_write=ckpt_write,
            ),
            hazard=hazard_config(fconfig),
        )
    metrics = MetricsLog(attribution=attribution)
    if events_path is not None:
        from gpuschedule_tpu_torch.obs import config_hash

        # new-knob keys enter the hash only when their process is armed:
        # knob-off cells keep their config hashes (and run_ids, and
        # events headers) byte for byte
        extra_cfg: dict = {}
        # arming predicates mirror generate_fault_schedule's exactly: a
        # knob value that generates zero records must not perturb the hash
        if domain_mtbf > 0 and math.isfinite(domain_mtbf):
            extra_cfg["domain"] = [domain_mtbf, domain_repair]
            if domain_weights:
                extra_cfg["domain_weights"] = dict(sorted(
                    domain_weights.items()
                ))
        if plan.hazard is not None:
            extra_cfg["hazard"] = [
                hazard_shape, hazard_util_weight, migrate_threshold,
            ]
        if straggler_mtbf > 0 and math.isfinite(straggler_mtbf):
            extra_cfg["straggler"] = [
                straggler_mtbf, straggler_repair, straggler_degrade
            ]
        if spot_fraction > 0:
            extra_cfg["spot"] = [
                spot_fraction, spot_mtbf, spot_outage, spot_warning
            ]
        if ckpt_write == "auto" or (
            isinstance(ckpt_write, (int, float)) and ckpt_write
        ):
            extra_cfg["ckpt_write"] = ckpt_write
        chash = config_hash({
            "cluster": "tpu-v5e", "dims": list(dims), "num_pods": num_pods,
            "trace": f"philly-like:{num_jobs}", "seed": seed,
            "mtbf": mtbf, "repair": repair, "ckpt": ckpt,
            "restore": restore, "max_time": max_time, **extra_cfg,
        })
        metrics = MetricsLog(events_sink=events_path, run_meta={
            "run_id": f"{policy_key}-s{seed}-{chash}",
            "seed": seed, "policy": policy_key, "config_hash": chash,
        }, attribution=attribution)
    with metrics:  # engine exceptions still flush the stream
        with _task_span("replay", cat="sweep", policy=policy_key,
                        mtbf=mtbf, seed=seed):
            res = Simulator(
                cluster, make_policy(name, **kwargs), jobs,
                metrics=metrics,
                faults=plan,
                max_time=max_time if max_time is not None else math.inf,
                sample_interval=sample_interval,
                profiler=_task_profiler(),
            ).run()
    cell = {
        "policy": policy_key,
        "mtbf_s": mtbf,
        "avg_jct": res.avg_jct,
        "makespan": res.makespan,
        "num_finished": res.num_finished,
        "num_unfinished": res.num_unfinished,
        "faults": int(res.counters.get("faults", 0)),
        "revocations": int(res.counters.get("fault_revocations", 0)),
        "goodput": dict(res.goodput),
        # availability / MTTR summary columns: what
        # fraction of fleet chip-time stayed in service, and how fast
        # outages healed, next to the goodput they cost
        **availability_summary(cluster, plan.records, res.end_time),
    }
    if res.delay_by_cause:
        cell["delay_by_cause"] = dict(res.delay_by_cause)
    if events_path is not None:
        cell["events"] = str(events_path)
    return cell


def grid_cells(
    keys: Sequence[str],
    points: Sequence,
    run_one,
    *,
    workers: int = 1,
    max_retries: int = 2,
    backoff_s: float = 1.0,
    retry_log: Optional[List[dict]] = None,
    fleet=None,
) -> Dict[str, List[dict]]:
    """Run a (policy x grid-point) matrix of independent seeded cells,
    serially or process-parallel, reassembling results in deterministic
    grid order either way (each cell regenerates its own trace /
    cluster / schedule from the seed, so cells are embarrassingly
    parallel and the parallel artifact is byte-identical to the serial
    one).  ``run_one(key, point)`` must be picklable (module-level) for
    ``workers > 1``.

    Crash resilience: a cell whose worker crashed or
    was killed (OOM-killer, a hard ``os._exit``) is retried up to
    ``max_retries`` times with exponential backoff
    (``backoff_s * 2^round``) before the grid fails; only the failed
    cells re-run, and results still reassemble in grid order, so a
    transiently-killed worker cannot perturb the artifact.  The serial
    path retries raising cells the same way.  ``retry_log`` (when given)
    collects one ``{"cell": [key, index], "round": n}`` record per
    retried cell — ``tools.fault_chaos`` reports them.

    The parallel path rides the shared persistent
    :class:`~gpuschedule_tpu_torch.sim.pool.WorkerPool` — one long-lived set
    of warm workers for the whole grid, a crash respawning exactly the
    dead worker instead of a fresh pool per retry round.  Cells are
    independent seeded replays either way, so the artifact stays
    byte-identical to the serial one.

    ``fleet`` (a :class:`gpuschedule_tpu_torch.obs.fleet.FleetCollector`)
    arms cross-process tracing: pooled cells ship a
    trace-context envelope and return spans / counters / engine-phase
    profiles alongside their results; serial cells run the identical
    harness in-process, so the federated telemetry is comparable across
    modes.  The pool's lifecycle counters land on ``fleet.registry``.
    Cell *results* are bytewise unaffected either way — telemetry
    travels out of band, and a failed attempt's partial telemetry never
    reaches the collector (it only rides a successful return)."""
    import time

    def note_retries(cells, rnd: int) -> None:
        if retry_log is not None:
            for key, i in cells:
                retry_log.append({"cell": [key, i], "round": rnd})

    if workers <= 1:
        out: Dict[str, List[dict]] = {}
        for k, key in enumerate(keys):
            row = []
            for i, pt in enumerate(points):
                for attempt in range(max_retries + 1):
                    try:
                        if fleet is None:
                            row.append(run_one(key, pt))
                        else:
                            # the serial half of the fleet contract: same
                            # harness, task-index key = grid-flat index
                            row.append(fleet.run_local(
                                run_one, k * len(points) + i, (key, pt),
                            ))
                        break
                    except Exception:
                        if attempt == max_retries:
                            raise
                        note_retries([(key, i)], attempt + 1)
                        time.sleep(backoff_s * (2 ** attempt))
            out[key] = row
        return out
    from gpuschedule_tpu_torch.sim.pool import WorkerPool

    cells = [(key, i) for key in keys for i in range(len(points))]
    tasks = [(key, points[i]) for key, i in cells]

    def on_retry(idx: int, attempt: int) -> None:
        note_retries([cells[idx]], attempt)

    with WorkerPool(
        workers, max_retries=max_retries, backoff_s=backoff_s,
        on_retry=on_retry,
        registry=fleet.registry if fleet is not None else None,
    ) as pool:
        if fleet is None:
            flat = pool.map(run_one, tasks)
        else:
            with fleet.span("dispatch", tasks=len(tasks)):
                flat = pool.map(run_one, tasks, fleet=fleet)
    results = dict(zip(cells, flat))
    return {
        key: [results[(key, i)] for i in range(len(points))] for key in keys
    }


def _mtbf_cell(key: str, mtbf: float, cell_kwargs: dict) -> dict:
    """Module-level cell thunk (picklable for the process pool)."""
    return run_cell(key, mtbf=mtbf, **cell_kwargs)


def sweep(
    mtbfs: Iterable[float] = DEFAULT_MTBFS,
    policies: Optional[Iterable[str]] = None,
    *,
    workers: int = 1,
    fleet=None,
    **cell_kwargs,
) -> dict:
    """The full grid as one JSON-ready artifact:
    ``{"mtbf_s": [...], "policies": {name: [cell, ...]}}`` with each
    policy's cells ordered like ``mtbf_s``.

    ``workers`` > 1 runs the cells across a process pool (each cell is an
    isolated seeded replay); results come back in grid order, so the
    artifact is byte-identical to the serial one.  ``fleet`` arms
    cross-process tracing (see :func:`grid_cells`) — the
    artifact itself is unchanged; the telemetry rides the collector."""
    mtbfs = list(mtbfs)
    keys = list(policies) if policies is not None else list(POLICY_CONFIGS)
    unknown = [k for k in keys if k not in POLICY_CONFIGS]
    if unknown:
        raise ValueError(
            f"unknown policy configs {unknown}; known: {sorted(POLICY_CONFIGS)}"
        )
    if workers > 1 and cell_kwargs.get("events_path") is not None:
        raise ValueError(
            "workers > 1 cannot share one events_path; capture streams "
            "per-cell (cli `faults --events DIR`) or run serially"
        )
    from functools import partial

    out = grid_cells(
        keys, mtbfs, partial(_mtbf_cell, cell_kwargs=cell_kwargs),
        workers=workers, fleet=fleet,
    )
    return {"mtbf_s": mtbfs, "policies": out}
