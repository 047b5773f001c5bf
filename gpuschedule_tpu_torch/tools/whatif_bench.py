#!/usr/bin/env python
"""What-if query serving bench: persistent fork-pool vs serial.

The port's copy of the JAX package's ``tools/whatif_bench.py``.  The
digital-twin numbers: on a mirrored 10k-job state, 16 concurrent
``admit`` queries served by a pool of 4 warm workers against serial
evaluation, and the single-query p50 latency, measured by the
interleaved before/after protocol (sides alternate per repeat, the
per-side minimum is kept: a shared host swings run to run).

Three arms, measured per repeat over identical queries:

- ``serial`` (one-shot, the *before* side): each query independently
  pays a baseline fork + bounded replay AND a variant fork + bounded
  replay, with no persistent state — what an ad-hoc "what if?" costs
  without the twin;
- ``serial_warm``: the baseline forked/replayed once up front (untimed),
  then one fork + replay per query — the warm-mirror win isolated from
  process parallelism;
- ``pool`` (the *after* side): the persistent
  :class:`~gpuschedule_tpu_torch.sim.pool.WorkerPool` — each worker restored
  the shipped mirror once and pre-warmed the baseline at load (reported
  separately as ``setup_s``), so the timed section is pure
  fork-per-query serving across processes.

Every arm computes byte-identical result documents (asserted), so the
speedup is never bought with a different answer.

    python -m gpuschedule_tpu_torch.tools.whatif_bench --out whatif_bench.json
    python -m gpuschedule_tpu_torch.tools.whatif_bench --jobs 2000 --queries 8 --pool 2
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import sys
import time
from pathlib import Path

from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace
from gpuschedule_tpu_torch.sim.whatif import (
    WhatIfService,
    baseline_doc,
    evaluate_query,
    latency_summary,
)

# the engine_bench fleet shape: 16 pods keep a deep pending queue under
# the Philly arrival rate — the steady-state regime a live twin mirrors
_DIMS = (4, 4)
_NUM_PODS = 16


def build_mirror(num_jobs: int, *, seed: int = 0):
    """One paused mid-replay engine: the Philly-like trace replayed to
    the midpoint job's arrival, attribution armed so deltas decompose."""
    cluster = TpuCluster("v5e", dims=_DIMS, num_pods=_NUM_PODS)
    jobs = generate_philly_like_trace(num_jobs, seed=seed)
    sim = Simulator(
        cluster, make_policy("fifo"), jobs,
        metrics=MetricsLog(attribution=True),
    )
    sim.run_until(sim.jobs[num_jobs // 2].submit_time)
    return sim


def admit_queries(n: int, *, chips: int, duration: float) -> list:
    """``n`` admit candidates, one per pod round-robin — the "admit this
    job WHERE?" fan-out."""
    return [
        {
            "kind": "admit", "chips": chips, "duration": duration,
            "pod": i % _NUM_PODS, "job_id": f"wifq{i}",
        }
        for i in range(n)
    ]


def _strip_latency(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "latency_s"}


def serial_oneshot(sim, queries, horizon: float):
    """The cold comparator: per query, baseline + variant both forked
    (full dump+load — no persistent state to cache bytes in) and
    replayed fresh."""
    out = []
    t0 = time.perf_counter()
    for q in queries:
        base = baseline_doc(sim.fork, horizon)
        q0 = time.perf_counter()
        doc = evaluate_query(sim.fork, q, horizon, base)
        doc["latency_s"] = time.perf_counter() - q0
        out.append(doc)
    return time.perf_counter() - t0, out


def serial_warm(fork_fn, queries, horizon: float, base: dict):
    """Warm-mirror serial: the pre-computed baseline and cached mirror
    bytes amortized, one unpickle-fork + replay per query."""
    out = []
    t0 = time.perf_counter()
    for q in queries:
        q0 = time.perf_counter()
        doc = evaluate_query(fork_fn, q, horizon, base)
        doc["latency_s"] = time.perf_counter() - q0
        out.append(doc)
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jobs", type=int, default=10_000,
                   help="trace length of the mirrored state")
    p.add_argument("--queries", type=int, default=16,
                   help="concurrent admit queries per round")
    p.add_argument("--pool", type=int, default=4,
                   help="worker processes in the persistent pool")
    p.add_argument("--chips", type=int, default=16)
    p.add_argument("--duration", type=float, default=7200.0,
                   help="injected job's service time (s)")
    p.add_argument("--horizon", type=float, default=43_200.0,
                   help="bounded speculative-replay horizon (s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3,
                   help="interleaved serial/pool rounds; min kept per side")
    p.add_argument("--speedup-floor", type=float, default=1.5,
                   help="gate: pool must beat one-shot serial by this "
                        "factor (the shipped CI floor; the JAX package's "
                        "acceptance target of 3x is recorded, not gated)")
    p.add_argument("--p50-floor-ms", type=float, default=1000.0,
                   help="gate: pooled single-query p50 must stay under "
                        "this (CI floor; the acceptance budget is 500)")
    p.add_argument("--no-gate", action="store_true")
    p.add_argument("--out", help="also write the JSON document here")
    args = p.parse_args(argv)

    sim = build_mirror(args.jobs, seed=args.seed)
    queries = admit_queries(
        args.queries, chips=args.chips, duration=args.duration
    )
    print(json.dumps({
        "mirrored_at_s": sim.now, "running": len(sim.running),
        "pending": len(sim.pending), "finished": len(sim.finished),
    }, sort_keys=True), file=sys.stderr)

    t0 = time.perf_counter()
    service = WhatIfService(sim, horizon=args.horizon, workers=args.pool)
    setup_s = time.perf_counter() - t0
    warm_base = service.warm()  # also caches the mirror bytes in-process

    serial_best = math.inf
    warm_best = math.inf
    pool_best = math.inf
    pool_docs = serial_docs = None
    try:
        for rep in range(max(1, args.repeats)):
            # interleave: alternate which side goes first each round, so
            # box-speed drift cannot systematically favor one side
            sides = ["serial", "pool"] if rep % 2 == 0 else ["pool", "serial"]
            for side in sides:
                if side == "serial":
                    elapsed, docs = serial_oneshot(sim, queries, args.horizon)
                    if elapsed < serial_best:
                        serial_best, serial_docs = elapsed, docs
                else:
                    e0 = time.perf_counter()
                    docs = service.evaluate(queries)
                    elapsed = time.perf_counter() - e0
                    if elapsed < pool_best:
                        pool_best, pool_docs = elapsed, docs
            elapsed, _ = serial_warm(
                service._fork, queries, args.horizon, warm_base
            )
            warm_best = min(warm_best, elapsed)
    finally:
        service.close()

    # identical answers on every arm — the speedup must never be bought
    # with a different result
    mismatch = [
        i for i, (a, b) in enumerate(zip(serial_docs, pool_docs))
        if _strip_latency(a) != _strip_latency(b)
    ]
    if mismatch:
        print(f"RESULT MISMATCH serial vs pool at queries {mismatch}",
              file=sys.stderr)
        return 2

    lat = latency_summary(pool_docs)
    speedup = serial_best / pool_best if pool_best > 0 else math.inf
    warm_speedup = warm_best / pool_best if pool_best > 0 else math.inf
    doc = {
        "params": {
            "jobs": args.jobs, "queries": args.queries, "pool": args.pool,
            "chips": args.chips, "duration_s": args.duration,
            "horizon_s": args.horizon, "seed": args.seed,
            "repeats": args.repeats, "dims": list(_DIMS),
            "pods": _NUM_PODS,
        },
        "mirror": {
            "at_s": sim.now, "running": len(sim.running),
            "pending": len(sim.pending), "finished": len(sim.finished),
        },
        "setup_s": round(setup_s, 4),
        "serial_s": round(serial_best, 4),
        "serial_warm_s": round(warm_best, 4),
        "pool_s": round(pool_best, 4),
        "speedup_vs_serial": round(speedup, 3),
        "speedup_vs_serial_warm": round(warm_speedup, 3),
        # parallelism-only efficiency: warm-serial / pooled / workers
        # (fork+replay are identical work on both sides; on a host with
        # fewer cores than workers the ceiling is cores/workers, not 1.0)
        "pool_scaling_efficiency": round(warm_speedup / args.pool, 3),
        "query_latency_ms": {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in lat.items()
        },
        "gate": {
            "speedup_floor": args.speedup_floor,
            "p50_floor_ms": args.p50_floor_ms,
            "speedup_ok": speedup >= args.speedup_floor,
            "p50_ok": lat.get("p50_ms", math.inf) <= args.p50_floor_ms,
        },
        "meta": {
            "python": platform.python_version(),
            "platform": platform.platform(),
            "cpus": os.cpu_count(),
        },
    }
    doc["gate"]["ok"] = doc["gate"]["speedup_ok"] and doc["gate"]["p50_ok"]
    if args.out:
        out = Path(args.out)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    print(json.dumps({
        "serial_s": doc["serial_s"], "serial_warm_s": doc["serial_warm_s"],
        "pool_s": doc["pool_s"], "speedup": doc["speedup_vs_serial"],
        "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
        "ok": doc["gate"]["ok"],
    }, sort_keys=True))
    if args.no_gate:
        return 0
    return 0 if doc["gate"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
