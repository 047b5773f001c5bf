"""The worker pool's contract, run by ``tests/test_torch_sweeps.py`` in a
process of its own (``python tests/torch_pool_worker.py SCENARIO DIR``):
the pool forks, and a pytest process that has run JAX and torch side by
side must not fork.  Each scenario runs through the port's
``sim/pool.py`` and ``obs/fleet.py`` and through the JAX package's (which
import no JAX), and prints one JSON line ``{"port": ..., "jax": ...}``.

The task functions are module-level, so a forked worker finds them.
"""

import json
import os
import pickle
import sys
from pathlib import Path

_CRASH_DIR = ""
_WARM_VALUE = None


def _echo(i):
    return i * 10


def _set_warm(v) -> bool:
    global _WARM_VALUE
    _WARM_VALUE = v
    return True


def _read_warm_crash_once(tag: str):
    """Hard-kills its worker on the first attempt (a marker file), then
    returns the warm state: a passing retry shows the respawned worker was
    warmed again before it served."""
    marker = Path(_CRASH_DIR) / f"{tag}.attempted"
    if not marker.exists():
        marker.write_text("1")
        os._exit(1)
    return _WARM_VALUE


def _raise_until(tag: str, ok_attempt: int):
    marker = Path(_CRASH_DIR) / f"{tag}.count"
    n = int(marker.read_text()) + 1 if marker.exists() else 1
    marker.write_text(str(n))
    if n < ok_attempt:
        raise ValueError(f"transient {tag} attempt {n}")
    return n


def _always_crashes(_):
    os._exit(1)


def _traced_square(i: int, fleet_mod) -> int:
    """Counts into the active task harness, then (task 1, first attempt
    only) kills its worker after counting: the crashed attempt's counts
    must never reach the merged registry."""
    h = fleet_mod.active()
    if h is not None:
        h.registry.counter("cells_total", "cells run").inc()
        h.registry.counter("cell_runs_total", "runs by index",
                           labelnames=("idx",)).labels(str(i)).inc()
    with fleet_mod.task_span("square", i=i):
        if i == 1 and _CRASH_DIR:
            marker = Path(_CRASH_DIR) / "square-1.attempted"
            if not marker.exists():
                marker.write_text("1")
                os._exit(1)
        return i * i


def _traced_square_port(i):
    from gpuschedule_tpu_torch.obs import fleet

    return _traced_square(i, fleet)


def _traced_square_jax(i):
    from gpuschedule_tpu.obs import fleet

    return _traced_square(i, fleet)


def _modules(side):
    if side == "port":
        from gpuschedule_tpu_torch.obs import fleet, metrics
        from gpuschedule_tpu_torch.sim import pool
        return pool, fleet, metrics, _traced_square_port
    from gpuschedule_tpu.obs import fleet, metrics
    from gpuschedule_tpu.sim import pool
    return pool, fleet, metrics, _traced_square_jax


def scenario(name: str, side: str, tmp: Path) -> dict:
    global _CRASH_DIR
    pool_mod, fleet_mod, metrics_mod, square = _modules(side)
    WorkerPool = pool_mod.WorkerPool
    _CRASH_DIR = str(tmp)
    if name == "order":
        with WorkerPool(3, backoff_s=0.01) as pool:
            out = pool.map(_echo, [(i,) for i in range(11)])
        return {"out": out, "respawns": pool.respawns, "retries": pool.retries}
    if name == "crash":
        retries = []
        reg = metrics_mod.MetricsRegistry()
        with WorkerPool(2, backoff_s=0.01, registry=reg) as pool:
            pool.broadcast(_set_warm, 42)
            out = pool.map(_read_warm_crash_once, [("t0",), ("t1",)],
                           on_retry=lambda idx, att: retries.append([idx, att]))
        return {"out": out, "respawns": pool.respawns, "retries": pool.retries,
                "on_retry": sorted(retries), "registry": reg.to_json()}
    if name == "errors":
        found = {}
        with WorkerPool(2, max_retries=2, backoff_s=0.01) as pool:
            found["transient"] = pool.map(_raise_until, [("a", 3), ("b", 1)])
            try:
                pool.map(_raise_until, [("c", 99)])
            except ValueError as e:
                found["exhausted"] = str(e)
            found["retries"] = pool.retries
        with WorkerPool(1, max_retries=1, backoff_s=0.01) as pool:
            try:
                pool.map(_always_crashes, [(0,)])
            except pool_mod.WorkerCrashError as e:
                found["crashes"] = str(e)
            found["respawns"] = pool.respawns
        try:
            WorkerPool(0)
        except ValueError as e:
            found["zero"] = str(e)
        return found
    if name == "fleet":
        # the serial arm, then the pooled arm whose task 1 kills its worker
        _CRASH_DIR = ""
        serial = fleet_mod.FleetCollector("crash-pin", parent="test")
        s_out = [serial.run_local(square, i, (i,)) for i in range(4)]
        _CRASH_DIR = str(tmp)
        pooled = fleet_mod.FleetCollector("crash-pin", parent="test")
        with WorkerPool(2, backoff_s=0.01, registry=pooled.registry) as pool:
            with pooled.span("dispatch", tasks=4):
                p_out = pool.map(square, [(i,) for i in range(4)], fleet=pooled)
        doc = pooled.document()
        spans = sorted([e["name"], e["args"]["task"], e["args"]["trace_id"],
                        e["args"]["parent_span_id"]]
                       for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] > 1)
        return {"serial": s_out, "pooled": p_out, "respawns": pool.respawns,
                "retries": pool.retries,
                "serial_registry": serial.merge_into(metrics_mod.MetricsRegistry()).to_json(),
                "pooled_registry": pooled.merge_into(metrics_mod.MetricsRegistry()).to_json(),
                "doc_registry": doc["registry"], "federation": doc["federation"],
                "worker_spans": spans, "exporter": doc["otherData"]["exporter"]}
    raise SystemExit(f"unknown scenario {name!r}")


def main(argv) -> int:
    name, tmp = argv[0], Path(argv[1])
    out = {}
    for side in ("port", "jax"):
        d = tmp / side
        d.mkdir(parents=True, exist_ok=True)
        out[side] = scenario(name, side, d)
    # every result crossed a process boundary: it pickles
    pickle.dumps(out)
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
