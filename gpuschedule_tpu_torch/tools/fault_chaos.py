#!/usr/bin/env python
"""Randomized fault-config chaos smoke: N seeded random fault configs x
the eight-policy suite, asserting on every cell that

- the replay does not crash (no stranded-event spin, no accounting
  blow-up — permanent outages, zero-length blips, stacked degradations,
  warned spot revocations and priced checkpoint writes are all in the
  draw space), and
- the analytics closures hold EXACTLY: the analyzer's goodput
  decomposition equals ``SimResult.goodput`` to the last float, and its
  ``delay_by_cause`` equals ``SimResult.delay_by_cause`` to the last
  float, on the captured event stream of that same run.

This is the fault subsystem's property test in tool form: the hand-
written tests pin specific arithmetic, the chaos sweep pins the
*contract* over a random walk of the whole knob space.  The port's copy
of the JAX package's ``tools/fault_chaos.py``.  Deterministic per --seed: config i draws from
``random.Random(f"{seed}:chaos:{i}")``, and each cell replays the usual
seeded Philly-like trace with its usual seed-split fault streams.

    python -m gpuschedule_tpu_torch.tools.fault_chaos
    python -m gpuschedule_tpu_torch.tools.fault_chaos --configs 3 --num-jobs 40 \
        --policies fifo,gandiva --out chaos.json
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
import tempfile
from pathlib import Path

from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.faults.recovery import FaultPlan, RecoveryModel
from gpuschedule_tpu_torch.faults.hazard import hazard_config
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    fault_horizon,
    generate_fault_schedule,
)
from gpuschedule_tpu_torch.net.model import NetConfig, NetModel
from gpuschedule_tpu_torch.faults.sweep import POLICY_CONFIGS, jsonable
from gpuschedule_tpu_torch.obs.analyze import analyze_file
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace


def _loguniform(rng: random.Random, lo: float, hi: float) -> float:
    return math.exp(rng.uniform(math.log(lo), math.log(hi)))


def draw_config(rng: random.Random):
    """One random point in the full fault knob space: every process can
    be on or off, repairs can be permanent, degradations can be total.
    widened the space with hazard knobs (Weibull shape, wear
    weighting, proactive-migrate threshold), per-level domain rate
    weights, link faults, and an optional redundant-uplink fabric
    (adaptive routing) — the closures must hold across all of it."""
    config = FaultConfig(
        mtbf=(math.inf if rng.random() < 0.25
              else _loguniform(rng, 3e3, 1e5)),
        repair=(math.inf if rng.random() < 0.1
                else rng.uniform(300.0, 7200.0)),
        maintenance_period=(0.0 if rng.random() < 0.5
                            else rng.uniform(2e4, 1e5)),
        maintenance_duration=rng.uniform(1800.0, 14400.0),
        spot_fraction=(0.0 if rng.random() < 0.5
                       else rng.uniform(0.1, 0.5)),
        spot_mtbf=_loguniform(rng, 5e3, 5e4),
        spot_outage=rng.uniform(600.0, 3600.0),
        spot_warning=(0.0 if rng.random() < 0.4
                      else rng.uniform(30.0, 900.0)),
        domain_mtbf=(math.inf if rng.random() < 0.4
                     else _loguniform(rng, 2e4, 3e5)),
        domain_repair=(math.inf if rng.random() < 0.05
                       else rng.uniform(600.0, 7200.0)),
        domain_weights=(None if rng.random() < 0.5 else {
            "host": rng.uniform(0.0, 4.0),
            "rack": rng.uniform(0.0, 2.0),
            "pod": rng.uniform(0.0, 1.0),
        }),
        hazard_shape=(1.0 if rng.random() < 0.5
                      else rng.uniform(0.6, 3.0)),
        hazard_util_weight=(0.0 if rng.random() < 0.5
                            else _loguniform(rng, 0.1, 10.0)),
        migrate_threshold=(math.inf if rng.random() < 0.5
                           else rng.uniform(0.2, 0.8)),
        straggler_mtbf=(math.inf if rng.random() < 0.4
                        else _loguniform(rng, 1e4, 2e5)),
        straggler_repair=rng.uniform(600.0, 7200.0),
        straggler_degrade=rng.uniform(0.0, 1.0),
        link_mtbf=(math.inf if rng.random() < 0.5
                   else _loguniform(rng, 1e4, 2e5)),
        link_repair=(math.inf if rng.random() < 0.05
                     else rng.uniform(600.0, 7200.0)),
        link_degrade=rng.uniform(0.0, 1.0),
    )
    recovery = RecoveryModel(
        ckpt_interval=rng.uniform(300.0, 3600.0),
        restore=rng.choice(["auto", rng.uniform(10.0, 120.0)]),
        ckpt_write=rng.choice([0.0, "auto", rng.uniform(5.0, 120.0)]),
    )
    # half the cells run a shared fabric too — with or without redundant
    # siblings, so link faults exercise stall, partial-degrade, AND
    # reroute behavior under the same closure assertions
    if rng.random() < 0.5:
        net = NetConfig(
            oversubscription=rng.choice([1.0, 2.0, 4.0]),
            ingest_gbps_per_chip=rng.choice([0.0, 0.05]),
            uplinks_per_pod=rng.choice([1, 2, 3]),
        )
    else:
        net = None
    return config, recovery, net


def run_cell(policy_key: str, config, recovery, *, num_jobs: int,
             seed: int, max_time: float, events_path: Path,
             net_config=None) -> dict:
    """One chaos cell: replay, capture, analyze, assert both closures."""
    name, kwargs = POLICY_CONFIGS[policy_key]
    cluster = TpuCluster("v5e", dims=(8, 8), num_pods=2)
    jobs = generate_philly_like_trace(num_jobs, seed=seed)
    horizon = min(max_time, fault_horizon(jobs))
    plan = FaultPlan(
        records=generate_fault_schedule(
            cluster, config, horizon=horizon, seed=seed,
        ),
        recovery=recovery,
        hazard=hazard_config(config),
    )
    metrics = MetricsLog(
        events_sink=events_path, attribution=True,
        run_meta={"run_id": f"chaos-{policy_key}", "seed": seed,
                  "policy": policy_key, "config_hash": "chaos"},
    )
    net = NetModel(net_config) if net_config is not None else None
    with metrics:
        res = Simulator(
            cluster, make_policy(name, **kwargs), jobs,
            metrics=metrics, faults=plan, max_time=max_time,
            net=net,
        ).run()
    analysis = analyze_file(events_path)
    failures = []
    if analysis.goodput() != res.goodput:
        failures.append(
            f"goodput closure broke: {analysis.goodput()} != {res.goodput}"
        )
    if analysis.delay_by_cause() != res.delay_by_cause:
        failures.append(
            f"delay_by_cause closure broke: "
            f"{analysis.delay_by_cause()} != {res.delay_by_cause}"
        )
    return {
        "policy": policy_key,
        "faults": int(res.counters.get("faults", 0)),
        "revocations": int(res.counters.get("fault_revocations", 0)),
        "straggler_reprices": int(
            res.counters.get("straggler_reprices", 0)
        ),
        "spot_warnings": int(res.counters.get("spot_warnings", 0)),
        "proactive_migrations": int(
            res.counters.get("proactive_migrations", 0)
        ),
        "reroutes": int(res.counters.get("reroutes", 0)),
        "goodput": dict(res.goodput),
        "failures": failures,
    }


def _chaos_cell(key: str, point, *, tmp: str, num_jobs: int, seed: int,
                max_time: float) -> dict:
    """Module-level cell thunk (picklable for the process pool): one
    (config index, policy) chaos cell writing/analyzing its own stream."""
    i, config, recovery, net_config = point
    return run_cell(
        key, config, recovery, num_jobs=num_jobs, seed=seed,
        max_time=max_time,
        events_path=Path(tmp) / f"c{i}-{key}.events.jsonl",
        net_config=net_config,
    )


def run_chaos(*, configs: int, num_jobs: int, seed: int,
              policies, max_time: float = 400_000.0,
              workers: int = 1) -> dict:
    """The full grid; raises nothing — failures are collected so one
    broken cell doesn't hide the rest.

    ``workers`` > 1 fans the (config x policy) cells across a process
    pool (the faults/sweep.py grid_cells machinery): every cell is an
    isolated seeded replay writing (and analyzing) its own stream file,
    and the configs are all drawn up front in the parent, so the
    assembled document is byte-identical to the serial run."""
    from functools import partial

    from gpuschedule_tpu_torch.faults.sweep import grid_cells

    keys = list(policies) if policies else list(POLICY_CONFIGS)
    unknown = [k for k in keys if k not in POLICY_CONFIGS]
    if unknown:
        raise ValueError(
            f"unknown policy configs {unknown}; known: {sorted(POLICY_CONFIGS)}"
        )
    out = {"seed": seed, "num_jobs": num_jobs, "configs": [], "cells": 0,
           "failed_cells": 0}
    drawn = []
    for i in range(configs):
        rng = random.Random(f"{seed}:chaos:{i}")
        drawn.append(draw_config(rng))
    points = [(i, config, recovery, net_config)
              for i, (config, recovery, net_config) in enumerate(drawn)]
    retry_log: list = []
    with tempfile.TemporaryDirectory(prefix="fault_chaos_") as tmp:
        cells = grid_cells(
            keys, points,
            partial(_chaos_cell, tmp=tmp, num_jobs=num_jobs, seed=seed,
                    max_time=max_time),
            workers=workers,
            retry_log=retry_log,
        )
    # crash-resilience visibility: which cells had a
    # crashed/killed worker and were re-run (empty on a clean grid)
    out["retried_cells"] = retry_log
    for i, (config, recovery, net_config) in enumerate(drawn):
        entry = {
            "index": i,
            "config": dict(config.__dict__),
            "recovery": {
                "ckpt_interval": recovery.ckpt_interval,
                "restore": recovery.restore,
                "ckpt_write": recovery.ckpt_write,
            },
            "net": (dict(net_config.__dict__)
                    if net_config is not None else None),
            "cells": [],
        }
        for key in keys:
            cell = cells[key][i]
            out["cells"] += 1
            if cell["failures"]:
                out["failed_cells"] += 1
            entry["cells"].append(cell)
        out["configs"].append(entry)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", type=int, default=5,
                   help="random fault configs to draw")
    p.add_argument("--num-jobs", type=int, default=60,
                   help="Philly-like trace length per cell")
    p.add_argument("--seed", type=int, default=0,
                   help="governs trace, fault streams AND the config draw")
    p.add_argument("--policies",
                   help=f"comma list from {sorted(POLICY_CONFIGS)} "
                        "(default: all eight)")
    p.add_argument("--max-time", type=float, default=400_000.0,
                   help="horizon cutoff per cell (bounds both the replay "
                        "and the schedule size under low-MTBF draws)")
    p.add_argument("--workers", type=int, default=1,
                   help="process-parallel chaos cells (isolated seeded "
                        "replays; the document is byte-identical to "
                        "--workers 1, the serial default)")
    p.add_argument("--out", help="also write the JSON document here")
    args = p.parse_args(argv)

    doc = jsonable(run_chaos(
        configs=args.configs,
        num_jobs=args.num_jobs,
        seed=args.seed,
        policies=args.policies.split(",") if args.policies else None,
        max_time=args.max_time,
        workers=args.workers,
    ))
    summary = {
        "cells": doc["cells"],
        "failed_cells": doc["failed_cells"],
        "configs": args.configs,
    }
    print(json.dumps(jsonable(summary), sort_keys=True))
    if args.out:
        out = Path(args.out)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    if doc["failed_cells"]:
        for entry in doc["configs"]:
            for cell in entry["cells"]:
                for f in cell["failures"]:
                    print(
                        f"config {entry['index']} x {cell['policy']}: {f}",
                        file=sys.stderr,
                    )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
