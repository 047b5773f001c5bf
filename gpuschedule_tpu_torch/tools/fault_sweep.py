#!/usr/bin/env python
"""MTBF x policy robustness sweep: goodput-vs-failure-rate JSON artifact.

Replays the same seeded Philly-like trace under every policy config in the
eight-point suite (``faults/sweep.py`` POLICY_CONFIGS), once per
MTBF grid point, and writes one JSON document::

    {"grid": {"mtbf_s": [...], "policies": {...}}, "params": {...}}

Each cell carries the headline avg-JCT/makespan numbers next to the goodput
decomposition (useful / lost-to-failure / restart-overhead chip-seconds), so
plotting useful_chip_s against mtbf_s answers "which policy degrades most
gracefully as hardware gets flakier".

Determinism: every cell regenerates trace, cluster, and fault schedule from
--seed (the seed-split rule in faults/schedule.py), so re-running the sweep
reproduces the artifact byte for byte, and the artifact is the JAX
package's ``tools/fault_sweep.py``'s for the same flags (the port's copy).

    python -m gpuschedule_tpu_torch.tools.fault_sweep --out results/fault_sweep.json
    python -m gpuschedule_tpu_torch.tools.fault_sweep --mtbfs inf,86400,3600 \
        --policies fifo,srtf --num-jobs 50 --max-time 200000 --out sweep.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gpuschedule_tpu_torch.faults.sweep import (
    DEFAULT_MTBFS,
    POLICY_CONFIGS,
    jsonable,
    sweep,
)


def _parse_dims(raw: str) -> tuple:
    return tuple(int(x) for x in raw.lower().split("x"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mtbfs",
                   help="comma list of per-chip MTBFs in seconds ('inf' is "
                        "the fault-free control arm); default: inf, monthly, "
                        "weekly, daily, 6h, hourly")
    p.add_argument("--policies",
                   help=f"comma list from {sorted(POLICY_CONFIGS)} "
                        "(default: all eight)")
    p.add_argument("--num-jobs", type=int, default=200,
                   help="Philly-like trace length per cell")
    p.add_argument("--seed", type=int, default=0,
                   help="governs trace AND fault streams (seed-split rule)")
    p.add_argument("--repair", type=float, default=3600.0)
    p.add_argument("--ckpt", type=float, default=1800.0)
    p.add_argument("--restore", default="auto",
                   help="seconds per revocation, or 'auto'")
    p.add_argument("--ckpt-write", default="0",
                   help="seconds per periodic checkpoint write, or 'auto' "
                        "to size from model state (0 = free, the "
                        "historical model)")
    p.add_argument("--domain-mtbf", type=float, default=float("inf"),
                   help="per-domain MTBF for correlated host/rack/pod "
                        "outages (inf = off)")
    p.add_argument("--domain-repair", type=float, default=2 * 3600.0)
    p.add_argument("--straggler-mtbf", type=float, default=float("inf"),
                   help="per-chip straggler-onset MTBF (inf = off)")
    p.add_argument("--straggler-repair", type=float, default=3600.0)
    p.add_argument("--straggler-degrade", type=float, default=0.5,
                   help="residual chip-rate fraction while degraded")
    p.add_argument("--spot", type=float, default=0.0,
                   help="trailing fraction of capacity that is spot")
    p.add_argument("--spot-mtbf", type=float, default=4 * 3600.0)
    p.add_argument("--spot-outage", type=float, default=1800.0)
    p.add_argument("--spot-warning", type=float, default=0.0,
                   help="pre-revoke notice lead time (emergency "
                        "checkpoints when it covers the write cost)")
    p.add_argument("--dims", default="8x8", help="TPU pod dims per cell")
    p.add_argument("--pods", type=int, default=1)
    p.add_argument("--max-time", type=float,
                   help="horizon cutoff per cell (bounds schedule size)")
    p.add_argument("--workers", type=int, default=1,
                   help="process-parallel sweep cells (each cell is an "
                        "isolated seeded replay; results reassemble in "
                        "grid order, so the artifact is byte-identical "
                        "to --workers 1, the serial default)")
    p.add_argument("--out", required=True, help="JSON artifact path")
    p.add_argument("--trace",
                   help="write ONE merged Perfetto/Chrome trace of the "
                        "sweep fleet here: a named track per "
                        "worker with each cell's build/replay spans and "
                        "engine-phase profile, linked to the parent "
                        "dispatch span by the propagated trace id.  The "
                        "sweep artifact itself is byte-identical with or "
                        "without this flag")
    args = p.parse_args(argv)

    mtbfs = (
        tuple(float(m) for m in args.mtbfs.split(","))
        if args.mtbfs else DEFAULT_MTBFS
    )
    policies = args.policies.split(",") if args.policies else None
    if args.restore == "auto":
        restore = "auto"
    else:
        try:
            restore = float(args.restore)
        except ValueError:
            p.error(f"--restore wants seconds or 'auto', got {args.restore!r}")
    if args.ckpt_write == "auto":
        ckpt_write = "auto"
    else:
        try:
            ckpt_write = float(args.ckpt_write)
        except ValueError:
            p.error(
                f"--ckpt-write wants seconds or 'auto', got {args.ckpt_write!r}"
            )
    fleet = None
    if args.trace:
        from gpuschedule_tpu_torch.obs import FleetCollector

        fleet = FleetCollector(f"fault-sweep-s{args.seed}", parent="sweep")
    grid = sweep(
        mtbfs,
        policies,
        workers=args.workers,
        fleet=fleet,
        repair=args.repair,
        ckpt=args.ckpt,
        restore=restore,
        ckpt_write=ckpt_write,
        num_jobs=args.num_jobs,
        seed=args.seed,
        dims=_parse_dims(args.dims),
        num_pods=args.pods,
        max_time=args.max_time,
        domain_mtbf=args.domain_mtbf,
        domain_repair=args.domain_repair,
        straggler_mtbf=args.straggler_mtbf,
        straggler_repair=args.straggler_repair,
        straggler_degrade=args.straggler_degrade,
        spot_fraction=args.spot,
        spot_mtbf=args.spot_mtbf,
        spot_outage=args.spot_outage,
        spot_warning=args.spot_warning,
    )
    # jsonable over the WHOLE document: inf can appear in the grid (control
    # arm, domain/straggler off values, MTTR of faultless cells) and in
    # params (--repair inf etc.); strict JSON throughout
    doc = jsonable({
        "grid": grid,
        "params": {
            "num_jobs": args.num_jobs,
            "seed": args.seed,
            "repair_s": args.repair,
            "ckpt_s": args.ckpt,
            "restore": restore,
            "ckpt_write": ckpt_write,
            "dims": list(_parse_dims(args.dims)),
            "pods": args.pods,
            "max_time": args.max_time,
            "domain_mtbf_s": args.domain_mtbf,
            "domain_repair_s": args.domain_repair,
            "straggler_mtbf_s": args.straggler_mtbf,
            "straggler_repair_s": args.straggler_repair,
            "straggler_degrade": args.straggler_degrade,
            "spot_fraction": args.spot,
            "spot_mtbf_s": args.spot_mtbf,
            "spot_outage_s": args.spot_outage,
            "spot_warning_s": args.spot_warning,
        },
    })
    out = Path(args.out)
    if out.parent and not out.parent.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    cells = sum(len(v) for v in grid["policies"].values())
    summary = {"out": str(out), "cells": cells,
               "mtbf_s": grid["mtbf_s"],
               "policies": sorted(grid["policies"])}
    if fleet is not None:
        tdoc = fleet.write(args.trace)
        summary["trace"] = {
            "out": args.trace,
            "tasks": tdoc["federation"]["tasks"],
            "workers": tdoc["federation"]["workers"],
        }
    print(json.dumps(jsonable(summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
