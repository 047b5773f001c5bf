#!/usr/bin/env python
"""Contention-vs-offered-load sweep: goodput & slowdown vs multislice share.

Replays the same seeded Philly-like trace under every policy config in the
eight-point suite (``faults/sweep.py`` POLICY_CONFIGS), once per
multislice-share grid point, with the shared-fabric contention model (net/)
enabled, and writes one JSON document::

    {"grid": {"multislice_share": [...], "policies": {...}}, "params": {...}}

Each cell carries aggregate goodput (useful / lost / restart-overhead
chip-seconds), the p95 slowdown tail, and the fabric's time-weighted mean
link utilization — plotting useful_chip_s and p95_slowdown against
multislice_share answers "how fast does the fabric become the bottleneck
as pod-spanning jobs take over the mix".

Determinism: every cell regenerates trace, cluster, promotion set, and net
model from --seed (the seed-split rule), so re-running the sweep
reproduces the artifact byte for byte, and the artifact is the JAX
package's ``tools/net_sweep.py``'s for the same flags (the port's copy).

    python -m gpuschedule_tpu_torch.tools.net_sweep --out results/net_sweep.json
    python -m gpuschedule_tpu_torch.tools.net_sweep --shares 0,0.1,0.3 \
        --policies fifo,srtf --num-jobs 50 --max-time 200000 --out sweep.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gpuschedule_tpu_torch.faults.sweep import POLICY_CONFIGS, jsonable
from gpuschedule_tpu_torch.net.sweep import DEFAULT_SHARES, sweep


def _parse_dims(raw: str) -> tuple:
    return tuple(int(x) for x in raw.lower().split("x"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shares",
                   help="comma list of multislice shares in [0, 1] "
                        "(default: 0, 0.05, 0.1, 0.2)")
    p.add_argument("--policies",
                   help=f"comma list from {sorted(POLICY_CONFIGS)} "
                        "(default: all eight)")
    p.add_argument("--num-jobs", type=int, default=200,
                   help="Philly-like trace length per cell")
    p.add_argument("--seed", type=int, default=0,
                   help="governs trace AND promotion streams (seed-split "
                        "rule)")
    p.add_argument("--dims", default="4x4", help="TPU pod dims per cell")
    p.add_argument("--pods", type=int, default=4)
    p.add_argument("--oversubscription", type=float, default=4.0,
                   help="core:uplink capacity ratio of the modeled fabric")
    p.add_argument("--ingest", type=float, default=0.05,
                   help="inelastic ingest Gbps per occupied chip")
    p.add_argument("--max-time", type=float,
                   help="horizon cutoff per cell")
    p.add_argument("--workers", type=int, default=1,
                   help="process-parallel sweep cells (isolated seeded "
                        "replays reassembled in grid order: byte-identical "
                        "to --workers 1, the serial default)")
    p.add_argument("--out", required=True, help="JSON artifact path")
    p.add_argument("--trace",
                   help="write ONE merged Perfetto/Chrome trace of the "
                        "sweep fleet here: a named track per "
                        "worker with each cell's build/replay spans and "
                        "engine-phase profile.  The sweep artifact itself "
                        "is byte-identical with or without this flag")
    args = p.parse_args(argv)

    shares = (
        tuple(float(s) for s in args.shares.split(","))
        if args.shares else DEFAULT_SHARES
    )
    policies = args.policies.split(",") if args.policies else None
    fleet = None
    if args.trace:
        from gpuschedule_tpu_torch.obs import FleetCollector

        fleet = FleetCollector(f"net-sweep-s{args.seed}", parent="sweep")
    grid = sweep(
        shares,
        policies,
        workers=args.workers,
        fleet=fleet,
        num_jobs=args.num_jobs,
        seed=args.seed,
        dims=_parse_dims(args.dims),
        num_pods=args.pods,
        oversubscription=args.oversubscription,
        ingest=args.ingest,
        max_time=args.max_time,
    )
    doc = jsonable({
        "grid": grid,
        "params": {
            "num_jobs": args.num_jobs,
            "seed": args.seed,
            "dims": list(_parse_dims(args.dims)),
            "pods": args.pods,
            "oversubscription": args.oversubscription,
            "ingest_gbps_per_chip": args.ingest,
            "max_time": args.max_time,
        },
    })
    out = Path(args.out)
    if out.parent and not out.parent.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    cells = sum(len(v) for v in grid["policies"].values())
    summary = {"out": str(out), "cells": cells,
               "multislice_share": list(shares),
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
