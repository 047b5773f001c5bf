#!/usr/bin/env python
"""Engine replay-speed ladder: jobs/sec + events/sec, with a pinned floor gate.

The fleet-scale question: how fast does the replay core chew through a
Philly-shaped trace with the realism stack (faults, fabric, attribution)
loaded?  The port's copy of the JAX package's ``tools/engine_bench.py``.  This tool runs a seeded ladder of replays — 1k/10k/100k jobs,
each under four configurations:

- ``plain``   — the bare engine (no faults, no net, no attribution);
- ``faults``  — seeded MTBF fault schedule + auto-priced recovery;
- ``net``     — shared-fabric contention (half the jobs promoted to
  2-pod multislice gangs, so the fabric sees steady-state contention —
  the regime where a full per-batch recompute dominates);
- ``attrib``  — causal attribution armed (per-interval blame + run legs).

and reports per rung: wall seconds, jobs/sec, and events/sec (heap events
processed).  Every rung is deterministic per ``--seed`` — identical trace,
cluster, schedule — so two invocations measure the same replay.

``FLOORS`` pins a jobs/sec budget per configuration (measured on the
host of the card this port runs on, set at ~25% of the observed rate so
slower boxes don't flake, while a real hot-path regression — an accidental O(n) in the batch
loop, a recompute cache that stopped hitting — still trips it).  Exit 0
within budget, 1 when any gated rung regresses below its floor.

    python -m gpuschedule_tpu_torch.tools.engine_bench --out engine_bench.json
    python -m gpuschedule_tpu_torch.tools.engine_bench --sizes 1000 --configs net --repeats 3
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import platform
import resource
import sys
import time
from pathlib import Path

from gpuschedule_tpu_torch.cluster.tpu import TpuCluster
from gpuschedule_tpu_torch.faults.recovery import FaultPlan, RecoveryModel
from gpuschedule_tpu_torch.faults.schedule import (
    FaultConfig,
    fault_horizon,
    generate_fault_schedule,
)
from gpuschedule_tpu_torch.net.model import NetConfig, NetModel
from gpuschedule_tpu_torch.net.sweep import promote_to_multislice
from gpuschedule_tpu_torch.policies import make_policy
from gpuschedule_tpu_torch.sim import Simulator
from gpuschedule_tpu_torch.sim.metrics import MetricsLog
from gpuschedule_tpu_torch.sim.philly import generate_philly_like_trace

LADDER_SIZES = (1_000, 10_000, 100_000)
# the 1M rung: minutes even on the optimized engine, so it is
# opt-in — `--million` appends it
MILLION = 1_000_000
CONFIGS = ("plain", "faults", "net", "attrib")
# v2-accounting rungs: any base config takes a ``-v2`` suffix
# (``--accounting v2`` rewrites a whole ladder); the default ladder
# carries the plain/attrib pair — the two rungs the >= 2x acceptance
# criterion is pinned on (FIFO never reads running progress, so v2 runs
# the fully-lazy path there)
V2_PAIR = ("plain-v2", "attrib-v2")
# the snapshot rung: write + restore + fork round-trip cost
# on a mid-replay engine — the what-if latency floor, gated like any
# other rung so fork cost cannot silently regress
SNAPSHOT = "snapshot"
DEFAULT_CONFIGS = CONFIGS + V2_PAIR + (SNAPSHOT,)

# Jobs/sec floors per configuration (the budget gate), pinned in
# engine_bench_floors.json beside this file (the port's own: the JAX
# package's were pinned on another machine).  Values are ~25% of the
# rate observed on the slowest rung: generous for a loaded box, tight
# enough that losing the allocate failure cache, the
# bitmask slice search, the lazy heap feed, or the re-pricing cache
# trips the gate.
FLOORS_PATH = Path(__file__).resolve().parent / "engine_bench_floors.json"
FLOORS = {
    k: float(v)
    for k, v in json.loads(FLOORS_PATH.read_text()).items()
    if not k.startswith("_")
}

# Ladder workload shape: one fleet for every configuration so the rungs
# differ only by which subsystem is armed.  16 pods x 16 chips keeps a
# deep pending queue under the Philly arrival rate (the steady-state
# regime million-job replays live in), and the net rung's 50% multislice
# share keeps ~8 pod-spanning flows contending over a 17-link fabric —
# the regime where the pre-incremental full recompute dominated.
_DIMS = (4, 4)
_NUM_PODS = 16
_MULTISLICE_SHARE = 0.5  # net rung: fraction promoted to 2-pod gangs


def build_sim(config: str, num_jobs: int, *, seed: int = 0) -> Simulator:
    """One fresh, fully seeded replay for a ladder rung.  Fresh Job
    objects every call — the engine mutates them in place.  A ``-v2``
    suffix (``plain-v2``) runs the same seeded world under v2 accounting
    — identical trace/cluster/schedule, closure-equivalent
    sums, so the v1/v2 rung pair isolates the accounting core."""
    accounting = "v1"
    if config.endswith("-v2"):
        accounting = "v2"
        config = config[: -len("-v2")]
    if config not in CONFIGS:
        raise ValueError(
            f"unknown config {config!r}; known: {CONFIGS} (+ '-v2' suffix)"
        )
    cluster = TpuCluster("v5e", dims=_DIMS, num_pods=_NUM_PODS)
    jobs = generate_philly_like_trace(num_jobs, seed=seed)
    policy = make_policy("fifo")
    kwargs: dict = {}
    if config == "faults":
        kwargs["faults"] = FaultPlan(
            records=generate_fault_schedule(
                cluster,
                FaultConfig(mtbf=86_400.0, repair=3600.0),
                horizon=fault_horizon(jobs),
                seed=seed,
            ),
            recovery=RecoveryModel(ckpt_interval=1800.0, restore="auto"),
        )
    elif config == "net":
        jobs = promote_to_multislice(
            jobs, _MULTISLICE_SHARE, cluster.pod_chips, seed=seed
        )
        kwargs["net"] = NetModel(
            NetConfig(oversubscription=4.0, ingest_gbps_per_chip=0.05)
        )
    elif config == "attrib":
        kwargs["metrics"] = MetricsLog(attribution=True)
    return Simulator(cluster, policy, jobs, accounting=accounting, **kwargs)


def run_rung(
    config: str, num_jobs: int, *, seed: int = 0, repeats: int = 1
) -> dict:
    """Time one ladder rung; with ``repeats`` > 1 the reported time is the
    per-rung minimum (the check_overhead.py fastest-observed-run
    estimator, robust to scheduling jitter on a noisy box)."""
    best = math.inf
    kept: dict = {}
    for _ in range(max(1, repeats)):
        sim = build_sim(config, num_jobs, seed=seed)
        t0 = time.perf_counter()
        res = sim.run()
        elapsed = time.perf_counter() - t0
        if elapsed < best:
            best = elapsed
            events = next(sim._seq) - 1  # heap events processed this run
            kept = {
                "finished": res.num_finished,
                "unfinished": res.num_unfinished,
                "events": events,
                "makespan_s": res.makespan,
            }
            net = sim.net
            if net is not None:
                kept["recomputes"] = net.recomputes
                kept["cache_hits"] = getattr(net, "cache_hits", 0)
            if config == "faults":
                kept["revocations"] = int(
                    res.counters.get("fault_revocations", 0)
                )
            # unified cache telemetry: flattened per-rung
            # counts, so a cache that stopped hitting is visible next to
            # the jobs/sec number it would otherwise only depress
            kept["caches"] = {
                f"{name}.{outcome}": int(n)
                for name, outcomes in sim.cache_stats().items()
                for outcome, n in sorted(outcomes.items())
                if n
            }
    return {
        "config": config,
        "num_jobs": num_jobs,
        "elapsed_s": round(best, 4),
        "jobs_per_s": round(num_jobs / best, 2),
        "events_per_s": round(kept["events"] / best, 2),
        # peak RSS of this process so far (ru_maxrss is monotonic — under
        # the default per-rung fork isolation each rung reports its own
        # true peak; with --no-isolate it is a high-water mark).
        # ru_maxrss is kilobytes on Linux but BYTES on Darwin.
        "rss_peak_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / (1024.0 * 1024.0 if sys.platform == "darwin" else 1024.0), 1
        ),
        **kept,
    }


def run_snapshot_rung(
    num_jobs: int, *, seed: int = 0, repeats: int = 1
) -> dict:
    """The ``snapshot`` rung: one plain replay paused mid-trace
    (the instant the midpoint job arrives — live running/pending sets,
    the state a digital twin mirrors), then the full persistence round
    trip — ``snapshot()`` to disk, ``Simulator.restore()`` in-process,
    and one in-memory ``fork()``.  Reported like the replay rungs:
    ``jobs_per_s`` is trace jobs carried per second of round trip, so
    the pinned floor gates fork cost — the what-if latency floor — the
    same way the other floors gate replay speed."""
    import tempfile

    from gpuschedule_tpu_torch.sim.snapshot import load_snapshot

    sim = build_sim("plain", num_jobs, seed=seed)
    sim.run_until(sim.jobs[num_jobs // 2].submit_time)
    best = math.inf
    kept: dict = {}
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "engine.snap"
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            sim.snapshot(path)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored = load_snapshot(path)
            t_restore = time.perf_counter() - t0
            t0 = time.perf_counter()
            fork = restored.fork()
            t_fork = time.perf_counter() - t0
            elapsed = t_write + t_restore + t_fork
            if elapsed < best:
                best = elapsed
                kept = {
                    "write_s": round(t_write, 4),
                    "restore_s": round(t_restore, 4),
                    "fork_s": round(t_fork, 4),
                    "snapshot_bytes": path.stat().st_size,
                    "paused_at_s": sim.now,
                    "running": len(sim.running),
                    "pending": len(sim.pending),
                    "finished": len(fork.finished),
                }
    return {
        "config": SNAPSHOT,
        "num_jobs": num_jobs,
        "elapsed_s": round(best, 4),
        "jobs_per_s": round(num_jobs / best, 2),
        "rss_peak_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            / (1024.0 * 1024.0 if sys.platform == "darwin" else 1024.0), 1
        ),
        **kept,
    }


def _rung_task(args) -> dict:
    """Picklable per-rung entry for the fork-isolated pool."""
    config, num_jobs, seed, repeats = args
    if config == SNAPSHOT:
        return run_snapshot_rung(num_jobs, seed=seed, repeats=repeats)
    return run_rung(config, num_jobs, seed=seed, repeats=repeats)


def run_ladder(
    sizes=LADDER_SIZES, configs=CONFIGS, *, seed: int = 0, repeats: int = 1,
    isolate: bool = True,
) -> list:
    """The full config x size grid.  ``isolate`` (default) forks a fresh
    child per rung, so each rung's ``rss_peak_mb`` is its own true peak
    RSS and no rung inherits another's allocator/GC state —
    falls back to in-process when fork is unavailable."""
    rungs = []
    pool = None
    if isolate and "fork" in multiprocessing.get_all_start_methods():
        ctx = multiprocessing.get_context("fork")
        # maxtasksperchild=1: every rung gets a brand-new child
        pool = ctx.Pool(processes=1, maxtasksperchild=1)
    try:
        for config in configs:
            for n in sizes:
                if pool is not None:
                    rung = pool.apply(_rung_task, ((config, n, seed, repeats),))
                else:
                    rung = _rung_task((config, n, seed, repeats))
                # record where the rung ran — 1 = its own forked
                # worker, 0 = in-process (--no-isolate).  An int, so the
                # --history metrics filter carries it and a cross-box
                # trend can split the two populations.
                rung["workers"] = 1 if pool is not None else 0
                print(json.dumps(rung, sort_keys=True), file=sys.stderr)
                rungs.append(rung)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    return rungs


def scale_ratios(rungs: list) -> dict:
    """Per-config jobs/sec ratio between consecutive ladder sizes — the
    scale-decay signal at a glance (a healthy engine holds
    ratios near 1.0 from 10k through 1M jobs; an engine that decays
    reads ~0.85 per decade)."""
    by_config: dict = {}
    for rung in rungs:
        by_config.setdefault(rung["config"], []).append(
            (rung["num_jobs"], rung["jobs_per_s"])
        )
    out: dict = {}
    for config, pairs in by_config.items():
        pairs.sort()
        ratios = {}
        for (n0, r0), (n1, r1) in zip(pairs, pairs[1:]):
            if r0 > 0:
                ratios[f"{n1}/{n0}"] = round(r1 / r0, 4)
        out[config] = ratios
    return out


def apply_gate(
    rungs: list, *, floors: dict = FLOORS, floor_scale: float = 1.0
) -> dict:
    """The budget gate: every rung whose config has a pinned floor must
    clear ``floor * floor_scale`` jobs/sec."""
    checked = []
    for rung in rungs:
        floor = floors.get(rung["config"])
        if floor is None:
            continue
        budget = floor * floor_scale
        checked.append({
            "config": rung["config"],
            "num_jobs": rung["num_jobs"],
            "jobs_per_s": rung["jobs_per_s"],
            "floor_jobs_per_s": budget,
            "ok": rung["jobs_per_s"] >= budget,
        })
    return {"ok": all(c["ok"] for c in checked), "checked": checked}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default=",".join(str(s) for s in LADDER_SIZES),
                   help="comma list of ladder trace lengths")
    p.add_argument("--configs", default=",".join(DEFAULT_CONFIGS),
                   help=f"comma list from {CONFIGS}, each optionally "
                        f"'-v2'-suffixed (v2 accounting); default adds "
                        f"the {V2_PAIR} pair")
    p.add_argument("--accounting", choices=("v1", "v2"), default=None,
                   help="force one accounting version across the whole "
                        "ladder: v2 rewrites every config to its '-v2' "
                        "form, v1 strips the suffix ("
                        "passthrough; default = run configs as named)")
    p.add_argument("--seed", type=int, default=0,
                   help="governs trace, promotion AND fault streams")
    p.add_argument("--repeats", type=int, default=1,
                   help="per-rung repeats; reported time is the minimum")
    p.add_argument("--floor-scale", type=float, default=1.0,
                   help="multiplier on the pinned jobs/sec floors (1.0 = "
                        "the shipped budget; raise it to tighten the gate "
                        "locally, e.g. after a machine upgrade)")
    p.add_argument("--no-gate", action="store_true",
                   help="measure only; always exit 0")
    p.add_argument("--no-isolate", action="store_true",
                   help="run rungs in-process instead of one forked child "
                        "per rung (rss_peak_mb then becomes a monotonic "
                        "high-water mark)")
    p.add_argument("--million", action="store_true",
                   help="append the slow 1M-job rung to the ladder (the "
                        "scale-decay headline; minutes per config)")
    p.add_argument("--out", help="also write the JSON document here")
    p.add_argument("--history", metavar="STORE",
                   help="append every rung to the sqlite history store "
                        "(label <config>/<size>) and print each rung's "
                        "jobs/sec against the median of its last N prior "
                        "entries — the 2x box noise read as a "
                        "distribution instead of one suspect number")
    p.add_argument("--history-last", type=int, default=5,
                   help="prior entries per rung the trend delta compares "
                        "against (default 5)")
    args = p.parse_args(argv)

    sizes = tuple(int(s) for s in args.sizes.split(","))
    if args.million and MILLION not in sizes:
        sizes = sizes + (MILLION,)
    configs = tuple(c.strip() for c in args.configs.split(",") if c.strip())
    if args.accounting == "v2":
        # the snapshot rung measures persistence, not accounting — it
        # has no -v2 form and rides every forced ladder unchanged
        configs = tuple(
            c if c.endswith("-v2") or c == SNAPSHOT else c + "-v2"
            for c in configs
        )
    elif args.accounting == "v1":
        configs = tuple(
            c[: -len("-v2")] if c.endswith("-v2") else c for c in configs
        )
    # a forced version can collapse pairs (plain + plain-v2 -> plain)
    configs = tuple(dict.fromkeys(configs))
    rungs = run_ladder(sizes, configs, seed=args.seed, repeats=args.repeats,
                       isolate=not args.no_isolate)
    gate = apply_gate(rungs, floor_scale=args.floor_scale)
    ratios = scale_ratios(rungs)
    trend = None
    if args.history:
        # cross-invocation memory: this ladder joins the
        # store, and each rung's number is positioned inside the
        # distribution of its own history — the honest read on a box
        # that swings 2x run to run
        from gpuschedule_tpu_torch.obs.history import HistoryStore, trend_delta

        trend = {}
        with HistoryStore(args.history) as store:
            for rung in rungs:
                label = f"{rung['config']}/{rung['num_jobs']}"
                store.append(
                    "bench", label=label, seed=args.seed,
                    metrics={
                        k: v for k, v in rung.items()
                        if isinstance(v, (int, float))
                    },
                )
                # same-seed rows only: a different --seed is a different
                # synthetic workload, whose jobs/sec distribution says
                # nothing about this one
                rows = [
                    r for r in store.rows(kind="bench", label=label)
                    if r.seed == args.seed
                ]
                d = trend_delta(rows, "jobs_per_s", last=args.history_last)
                if d is not None:
                    trend[label] = d
                    print(
                        f"trend {label}: jobs/s {d['value']:.1f} vs "
                        f"median-of-{d['n_prior']} {d['median']:.1f} "
                        f"({100.0 * d['delta_frac']:+.1f}%)"
                        if d["delta_frac"] is not None else
                        f"trend {label}: jobs/s {d['value']:.1f}",
                        file=sys.stderr,
                    )
    doc = {
        "ladder": rungs,
        "gate": gate,
        "scale_ratios": ratios,
        **({"history_trend": trend} if trend is not None else {}),
        "floors_jobs_per_s": {
            k: v * args.floor_scale for k, v in FLOORS.items() if k in configs
        },
        "params": {
            "sizes": list(sizes),
            "configs": list(configs),
            "seed": args.seed,
            "repeats": args.repeats,
            "floor_scale": args.floor_scale,
            "isolate": not args.no_isolate,
            "dims": list(_DIMS),
            "pods": _NUM_PODS,
            "multislice_share": _MULTISLICE_SHARE,
        },
        "meta": {
            "python": platform.python_version(),
            "platform": platform.platform(),
        },
    }
    if args.out:
        out = Path(args.out)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=2, sort_keys=True))
    # the scale-decay view at a glance: jobs/sec ratios between adjacent
    # ladder sizes per config (>= ~0.9 per decade = decay eliminated)
    for config in configs:
        if ratios.get(config):
            print(f"scale {config}: " + "  ".join(
                f"{k} = {v:.3f}" for k, v in sorted(ratios[config].items())
            ), file=sys.stderr)
    print(json.dumps({
        "ok": gate["ok"],
        "rungs": len(rungs),
        "jobs_per_s": {
            f"{r['config']}/{r['num_jobs']}": r["jobs_per_s"] for r in rungs
        },
        "scale_ratios": ratios,
    }, sort_keys=True))
    if args.no_gate:
        return 0
    return 0 if gate["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
