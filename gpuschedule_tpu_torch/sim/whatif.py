"""Interactive what-if replay: speculative queries against a live mirror
(the digital twin's question-answering layer).

The port's own copy of ``gpuschedule_tpu/sim/whatif.py``.  The replay core
is orders of magnitude faster than real time (``tools.engine_bench``);
this module spends that speed *online*.  A
paused engine (:meth:`Simulator.run_until`) is a mirror of cluster state
at some instant; each **query** forks it (:meth:`Simulator.fork`),
applies one speculative mutation, replays a bounded horizon, and returns
the **attributed delta** against a mutation-free baseline fork of the
same horizon — JCT, goodput decomposition, and (when attribution is
armed) the delay-by-cause split, so the answer is not just "admit
it to pod 3" but *what that choice costs and where the time goes*.

Query types (plain picklable dicts — they cross process boundaries):

- ``admit`` — "admit this job (where)?": a synthetic job spec, optionally
  pinned to a candidate pod (:meth:`Simulator.inject_admit`); candidates
  fan out as independent queries;
- ``drain`` — "drain this scope now or later?": a synthetic maintenance
  outage down the ordinary fault path (:meth:`Simulator.inject_drain`);
- ``policy-swap`` — "what if we ran SRTF instead?"
  (:meth:`Simulator.swap_policy`).

Concurrency (:class:`~gpuschedule_tpu_torch.sim.pool.WorkerPool`): each worker
restores the shipped mirror bytes ONCE, pre-warms the baseline for the
default horizon, then serves queries by in-memory fork — the
"restore once, fork many" contract that makes per-query latency the fork
+ bounded-replay cost instead of a full state ship.  ``workers=0`` (the
default) serves forks straight off the paused engine in-process: same
arithmetic, no processes — queries are deterministic, so serial and
pooled evaluation return identical result documents (modulo latency
readings; :func:`canonical_document` drops them).

Observability: per-query latency lands in the metrics-registry histogram
``whatif_query_latency_ms{kind}``, and :func:`append_history` writes one
history row per query (kind ``whatif``), so SLO trends of the twin
itself are one ``history trend`` away.
"""

from __future__ import annotations

import contextlib
import copy
import math
import threading
import time
from typing import Dict, List, Optional, Sequence

from gpuschedule_tpu_torch.sim.job import Job
from gpuschedule_tpu_torch.obs.fleet import (
    active as _fleet_active,
    task_span as _task_span,
)
from gpuschedule_tpu_torch.obs.tracer import NULL_SPAN as _NULL_SPAN

QUERY_KINDS = ("admit", "drain", "policy-swap")


class AdmissionError(RuntimeError):
    """Raised by :meth:`WhatIfService.admitted` when the bounded
    in-flight queue is full — the serving layer's backpressure signal
    (HTTP 429 at the edge)."""


# --------------------------------------------------------------------- #
# query evaluation core (shared by the serial path and pool workers)


def _result_doc(res) -> dict:
    """The picklable slice of one fork's SimResult a delta needs."""
    return {
        "avg_jct_s": res.avg_jct,
        "makespan_s": res.makespan,
        "p95_queueing_delay_s": res.p95_queueing_delay,
        "num_finished": res.num_finished,
        "num_unfinished": res.num_unfinished,
        "goodput": dict(res.goodput),
        "delay_by_cause": dict(res.delay_by_cause),
    }


def _delta_doc(base: dict, var: dict) -> dict:
    """Per-metric variant-minus-baseline diff; dict-valued metrics diff
    per key over the union (a cause/leg absent on one side reads 0)."""
    out: dict = {}
    for key, bv in base.items():
        vv = var[key]
        if isinstance(bv, dict):
            keys = sorted(set(bv) | set(vv))
            out[key] = {
                k: vv.get(k, 0.0) - bv.get(k, 0.0) for k in keys
            }
        else:
            out[key] = vv - bv
    return out


def _bound(fork, horizon: float) -> None:
    fork.max_time = min(fork.max_time, fork.now + horizon)


def validate_query(q: dict) -> dict:
    kind = q.get("kind")
    if kind not in QUERY_KINDS:
        raise ValueError(
            f"unknown what-if query kind {kind!r}; known: {QUERY_KINDS}"
        )
    if kind == "admit":
        if not int(q.get("chips", 0)) > 0:
            raise ValueError("admit query needs chips > 0")
        if not float(q.get("duration", 0.0)) > 0.0:
            raise ValueError("admit query needs duration > 0")
    elif kind == "drain":
        scope = q.get("scope")
        if not scope or len(scope) < 2:
            raise ValueError(
                "drain query needs a scope like ['pod', 7]"
            )
    elif kind == "policy-swap":
        if not q.get("policy"):
            raise ValueError("policy-swap query needs a policy name")
    return q


def normalize_query(q: dict) -> dict:
    """Coerce a wire-format query's numeric fields to the exact types
    the CLI spec parsers produce (chips int, duration/at float, scope
    members int), so a served result document — which echoes the query —
    never depends on whether the asker sent ``3600`` or ``3600.0``
    (the echo is part of the byte-identity surface)."""
    q = dict(q)
    kind = q.get("kind")
    if kind == "admit":
        if "chips" in q:
            q["chips"] = int(q["chips"])
        if "duration" in q:
            q["duration"] = float(q["duration"])
        if q.get("pod") is not None:
            q["pod"] = int(q["pod"])
        if q.get("at") is not None:
            q["at"] = float(q["at"])
    elif kind == "drain":
        scope = q.get("scope")
        if isinstance(scope, (list, tuple)) and scope:
            q["scope"] = [scope[0], *(int(s) for s in scope[1:])]
        if q.get("at") is not None:
            q["at"] = float(q["at"])
        if q.get("duration") is not None:
            q["duration"] = float(q["duration"])
    return q


def apply_query(fork, q: dict) -> Optional[Job]:
    """Apply one validated query's mutation to a fork; returns the
    injected job for ``admit`` (its outcome rides the result)."""
    kind = q["kind"]
    if kind == "admit":
        job = Job(
            q.get("job_id") or "whatif-admit",
            fork.now,
            num_chips=int(q["chips"]),
            duration=float(q["duration"]),
            model_name=q.get("model") or "transformer-tiny",
        )
        pod = q.get("pod")
        return fork.inject_admit(
            job,
            t=q.get("at"),
            pin={"pod": int(pod)} if pod is not None else None,
        )
    if kind == "drain":
        scope = q["scope"]
        fork.inject_drain(
            (scope[0], *(int(s) for s in scope[1:])),
            t=q.get("at"),
            duration=float(q.get("duration", math.inf)),
        )
        return None
    # policy-swap
    from gpuschedule_tpu_torch.policies import make_policy

    fork.swap_policy(make_policy(q["policy"], **(q.get("policy_args") or {})))
    return None


def evaluate_query(fork_fn, q: dict, horizon: float, base: dict) -> dict:
    """One speculative replay: ``fork_fn()`` yields a fresh independent
    clone of the mirror (``sim.fork`` for one-shot use; the service
    clones from cached mirror bytes — unpickle-only, half the fork
    cost); mutate it, run the bounded horizon, diff against the
    (already computed) baseline doc.

    When a fleet task harness is armed the phases land as
    child spans carrying the propagated trace context — fork / mutate /
    replay / diff, with ``restore`` nested under fork when the fork
    clones from mirror bytes — and the evaluation bumps the harness's
    ``whatif_queries_total{kind}`` counter.  Both hooks are no-ops when
    disarmed (one module-global read), and the counter lives on the
    harness registry precisely so that the serial and pooled merged
    registries come out identical: one increment per query, wherever
    the query ran."""
    harness = _fleet_active()
    if harness is not None:
        harness.registry.counter(
            "whatif_queries_total",
            "what-if queries evaluated",
            labelnames=("kind",),
        ).labels(q["kind"]).inc()
    with _task_span("fork", kind=q["kind"]):
        fork = fork_fn()
    at = fork.now
    _bound(fork, horizon)
    q_at = q.get("at")
    if q_at is not None and float(q_at) > fork.max_time:
        # past the cutoff the mutation would sit unapplied in the heap
        # and the delta read as a spurious ~zero ("admitting costs
        # nothing") instead of "outside the evaluated window"
        raise ValueError(
            f"query at={q_at} is beyond the bounded replay window "
            f"(ends at t={fork.max_time}); raise the horizon or move "
            "the query earlier"
        )
    with _task_span("mutate", kind=q["kind"]):
        injected = apply_query(fork, q)
    with _task_span("replay"):
        res = fork.run()
    with _task_span("diff"):
        var = _result_doc(res)
    doc = {
        "query": dict(q),
        "at_s": at,
        "horizon_s": horizon,
        "base": base,
        "variant": var,
        "delta": _delta_doc(base, var),
    }
    if injected is not None:
        out = {
            "job_id": injected.job_id,
            "end_state": injected.state.value,
            "executed_work_s": injected.executed_work,
        }
        if injected.first_start_time is not None:
            out["wait_s"] = injected.first_start_time - injected.submit_time
        if injected.end_time is not None:
            out["jct_s"] = injected.end_time - injected.submit_time
        if injected.attrib:
            out["blame"] = dict(injected.attrib)
        doc["admitted"] = out
    return doc


def baseline_doc(fork_fn, horizon: float) -> dict:
    """The mutation-free comparator: a bare fork run to the same bounded
    horizon.  Deterministic, so every evaluator (serial or any worker)
    derives the identical doc."""
    fork = fork_fn()
    _bound(fork, horizon)
    return _result_doc(fork.run())


# --------------------------------------------------------------------- #
# pool-worker half: module state warmed once per worker process

# lint: allow[GS601] deliberately process-local: each pool worker holds its own restored mirror bytes
_MIRROR_BYTES: Optional[bytes] = None
# lint: allow[GS601] deliberately process-local: each pool worker warms its own baseline cache after restoring the broadcast mirror
_BASELINES: Dict[float, dict] = {}


def _worker_fork():
    from gpuschedule_tpu_torch.sim.snapshot import clone_from_state_bytes

    with _task_span("restore"):
        return clone_from_state_bytes(_MIRROR_BYTES)


def _load_mirror(data: bytes, horizon: float) -> bool:
    """WorkerPool broadcast target: keep the shipped engine state bytes
    (each query clones from them — unpickle-only forks) and pre-warm
    the default-horizon baseline, so the first query pays only its own
    fork + replay."""
    global _MIRROR_BYTES
    _MIRROR_BYTES = data
    _BASELINES.clear()
    _BASELINES[horizon] = baseline_doc(_worker_fork, horizon)
    return True


def _eval_task(q: dict, horizon: float) -> dict:
    """WorkerPool map target: one query against this worker's mirror."""
    if _MIRROR_BYTES is None:
        raise RuntimeError("what-if worker has no mirror loaded")
    base = _BASELINES.get(horizon)
    if base is None:
        # lazy warm for a non-preloaded horizon: setup cost, untimed —
        # the same rule _eval_local follows
        base = _BASELINES[horizon] = baseline_doc(_worker_fork, horizon)
    # lint: allow[GS101] query-latency measurement is wall-clock by design; the replay itself never reads it
    t0 = time.perf_counter()
    doc = evaluate_query(_worker_fork, q, horizon, base)
    doc["latency_s"] = time.perf_counter() - t0  # lint: allow[GS101] same latency surface as above
    return doc


# --------------------------------------------------------------------- #
# the service


class WhatIfService:
    """Speculative-query front end over one paused engine.

    ``workers >= 1`` ships the mirror to a persistent
    :class:`~gpuschedule_tpu_torch.sim.pool.WorkerPool` (restore once per
    worker, fork per query, crash/retry per the pool contract);
    ``workers=0`` evaluates in-process off ``sim`` itself.  ``registry``
    (an obs MetricsRegistry) arms the per-query latency histogram, and
    hands the pool its lifecycle counters
    (``pool_worker_respawns_total`` / ``pool_task_retries_total``).

    ``fleet`` (a :class:`gpuschedule_tpu_torch.obs.fleet.FleetCollector`)
    arms cross-process tracing: each task ships a trace-context
    envelope, every worker (or the in-process evaluator) runs a child
    telemetry harness whose spans/counters ride back with the result,
    and :meth:`evaluate` wraps its own phases in parent spans
    (enqueue / dispatch / reassemble).  Result documents are bytewise
    unaffected — telemetry travels out of band.
    """

    def __init__(
        self,
        sim,
        *,
        horizon: float,
        workers: int = 0,
        registry=None,
        fleet=None,
        max_retries: int = 2,
        backoff_s: float = 1.0,
        max_inflight: Optional[int] = None,
    ):
        if not horizon > 0.0:
            raise ValueError(f"horizon must be > 0, got {horizon}")
        self.sim = sim
        self.horizon = float(horizon)
        self.queries_served = 0
        self.workers = int(workers) if workers and workers >= 1 else 0
        # admission control: the serving daemon bounds
        # concurrent askers to the pool's real capacity — default twice
        # the evaluator count (one in flight, one queued behind it)
        if max_inflight is None:
            max_inflight = 2 * max(1, self.workers)
        self.max_inflight = int(max_inflight)
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}"
            )
        self.rejections = 0
        self._inflight = 0
        self._adm_lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self._registry = registry
        self._rejected_counter = None
        self._fleet = fleet
        self._latency = None
        if registry is not None:
            from gpuschedule_tpu_torch.obs.metrics import LATENCY_BUCKETS_MS

            self._latency = registry.histogram(
                "whatif_query_latency_ms",
                "What-if query latency (milliseconds)",
                labelnames=("kind",),
                buckets=LATENCY_BUCKETS_MS,
            )
        self._pool = None
        self._baselines: Dict[float, dict] = {}
        self._bytes: Optional[bytes] = None
        if workers and workers >= 1:
            from gpuschedule_tpu_torch.sim.pool import WorkerPool
            from gpuschedule_tpu_torch.sim.snapshot import state_to_bytes

            # cache the serialized mirror for any later in-process
            # fork/warm too — the dump is the expensive half
            self._bytes = state_to_bytes(sim)
            self._pool = WorkerPool(
                workers, max_retries=max_retries, backoff_s=backoff_s,
                registry=registry,
            )
            self._pool.broadcast(_load_mirror, self._bytes, self.horizon)

    # ------------------------------------------------------------------ #

    def _fork(self):
        """In-process per-query fork, from cached mirror bytes (the
        paused engine's state is invariant between queries, so the dump
        half of the fork round trip happens once)."""
        from gpuschedule_tpu_torch.sim.snapshot import (
            clone_from_state_bytes,
            state_to_bytes,
        )

        if self._bytes is None:
            self._bytes = state_to_bytes(self.sim)
        with _task_span("restore"):
            return clone_from_state_bytes(self._bytes)

    def warm(self, horizon: Optional[float] = None) -> dict:
        """Ensure the in-process baseline for ``horizon`` exists (pool
        workers pre-warm at load time); returns the baseline doc."""
        h = self.horizon if horizon is None else float(horizon)
        base = self._baselines.get(h)
        if base is None:
            base = self._baselines[h] = baseline_doc(self._fork, h)
        return base

    def _eval_local(self, q: dict, horizon: float) -> dict:
        # warm OUTSIDE the timer: the one-off baseline replay is setup
        # cost (pool workers pre-warm at load), not this query's latency
        # — else the first serial query reports ~2x and the SLO
        # telemetry becomes mode-dependent
        base = self.warm(horizon)
        # lint: allow[GS101] query-latency measurement is wall-clock by design; the replay itself never reads it
        t0 = time.perf_counter()
        doc = evaluate_query(self._fork, q, horizon, base)
        doc["latency_s"] = time.perf_counter() - t0  # lint: allow[GS101] same latency surface as above
        return doc

    def evaluate(self, queries: Sequence[dict]) -> List[dict]:
        """Evaluate ``queries`` (result order = query order, whatever the
        pool interleaving), observing each latency into the histogram.

        With a fleet collector armed, the three parent phases land as
        spans on the collector's tracer — enqueue (validation / task
        building), dispatch (the pool map or in-process loop, with each
        task wrapped in a trace-context envelope), reassemble (latency
        observation over the ordered results) — and every evaluator-side
        span/counter rides back through the collector.  The result list
        itself is byte-identical either way."""
        fleet = self._fleet
        if fleet is None:
            tasks = [
                (validate_query(dict(q)), self.horizon) for q in queries
            ]
            if self._pool is not None:
                out = self._pool.map(_eval_task, tasks)
            else:
                out = [self._eval_local(q, h) for q, h in tasks]
        else:
            with fleet.span("enqueue", tasks=len(queries)):
                tasks = [
                    (validate_query(dict(q)), self.horizon) for q in queries
                ]
            with fleet.span("dispatch", tasks=len(tasks)):
                if self._pool is not None:
                    out = self._pool.map(_eval_task, tasks, fleet=fleet)
                else:
                    out = [
                        fleet.run_local(self._eval_local, i, (q, h))
                        for i, (q, h) in enumerate(tasks)
                    ]
        with (fleet.span("reassemble", tasks=len(out))
              if fleet is not None else _NULL_SPAN):
            self.queries_served += len(out)
            if self._latency is not None:
                for doc in out:
                    self._latency.labels(kind=doc["query"]["kind"]).observe(
                        1000.0 * doc["latency_s"]
                    )
        return out

    # ------------------------------------------------------------------ #
    # bounded admission: backpressure for concurrent askers

    @property
    def inflight(self) -> int:
        """Admitted-but-unfinished queries right now."""
        return self._inflight

    @contextlib.contextmanager
    def admitted(self):
        """Hold one slot in the bounded in-flight queue for the duration
        of the block; raises :class:`AdmissionError` (and counts the
        rejection into ``whatif_rejected_total``) when all
        ``max_inflight`` slots are taken.  Non-blocking by design — the
        serving edge turns the refusal into HTTP 429 rather than letting
        askers pile up behind a saturated pool."""
        with self._adm_lock:
            if self._inflight >= self.max_inflight:
                self.rejections += 1
                if self._registry is not None:
                    if self._rejected_counter is None:
                        self._rejected_counter = self._registry.counter(
                            "whatif_rejected_total",
                            "what-if queries refused by admission "
                            "control (in-flight queue full)",
                        )
                    self._rejected_counter.inc()
                raise AdmissionError(
                    f"what-if admission queue full "
                    f"({self.max_inflight} in flight); retry later"
                )
            self._inflight += 1
        try:
            yield self
        finally:
            with self._adm_lock:
                self._inflight -= 1

    def evaluate_admitted(self, queries: Sequence[dict]) -> List[dict]:
        """:meth:`evaluate` made safe for concurrent callers: dispatch is
        serialized under one lock (the pool map and the engine's
        in-process forks are not reentrant), and the bounded admission
        gate upstream keeps the wait behind it short by construction."""
        with self._dispatch_lock:
            return self.evaluate(queries)

    def pool_stats(self) -> dict:
        """Pool-lifecycle summary for the history "pool" row and the
        serving ``/status`` page: worker count plus the respawn / retry
        totals the pool counted across this service's queries.  In
        serial mode (``workers=0``) there is no pool to crash, so the
        counters read an honest zero rather than a blank (``/status``
        never blanks for workers=0)."""
        if self._pool is None:
            return {"workers": self.workers, "respawns": 0, "retries": 0}
        return {
            "workers": self.workers,
            "respawns": self._pool.respawns,
            "retries": self._pool.retries,
        }

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "WhatIfService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------- #
# CLI spec parsing (the `whatif` subcommand's query grammar)


def _pairs(spec: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError(f"bad what-if spec entry {pair!r} (want k=v)")
        out[key.strip().replace("-", "_")] = raw.strip()
    return out


def parse_admit_spec(spec: str) -> List[dict]:
    """``--admit chips=8,duration=3600[,model=M][,at=T][,pods=0:2:5]``
    — one unit query per candidate pod in ``pods`` (colon-separated),
    or a single unpinned query (the policy places it) without."""
    kv = _pairs(spec)
    known = {"chips", "duration", "model", "at", "pods", "job_id"}
    unknown = sorted(set(kv) - known)
    if unknown:
        raise ValueError(
            f"unknown --admit keys {unknown}; known: {sorted(known)}"
        )
    if "chips" not in kv or "duration" not in kv:
        raise ValueError("--admit needs at least chips= and duration=")
    base = {
        "kind": "admit",
        "chips": int(kv["chips"]),
        "duration": float(kv["duration"]),
    }
    if "model" in kv:
        base["model"] = kv["model"]
    if "at" in kv:
        base["at"] = float(kv["at"])
    if "job_id" in kv:
        base["job_id"] = kv["job_id"]
    pods = kv.get("pods")
    if pods is None:
        return [validate_query(base)]
    return [
        validate_query({**base, "pod": int(p)})
        for p in pods.split(":") if p != ""
    ]


def parse_drain_spec(spec: str) -> dict:
    """``--drain pod=7[,at=T][,duration=S]`` — duration defaults to a
    permanent drain (``inf``)."""
    kv = _pairs(spec)
    known = {"pod", "at", "duration"}
    unknown = sorted(set(kv) - known)
    if unknown:
        raise ValueError(
            f"unknown --drain keys {unknown}; known: {sorted(known)}"
        )
    if "pod" not in kv:
        raise ValueError("--drain needs pod=")
    q = {"kind": "drain", "scope": ["pod", int(kv["pod"])]}
    if "at" in kv:
        q["at"] = float(kv["at"])
    if "duration" in kv:
        q["duration"] = float(kv["duration"])
    return validate_query(q)


# --------------------------------------------------------------------- #
# observability plumbing


def result_document(sim, results: Sequence[dict], *,
                    requested_at: float, horizon: float, pool: int,
                    run_meta: dict) -> dict:
    """The what-if answer document — factored out of the ``whatif`` CLI
    so the serving daemon (the JAX package's ``serve``, not ported yet)
    and the offline command build the
    SAME structure from the same parts: mirror identity + position, the
    latency summary, and the ordered per-query delta docs.  Byte
    identity between the two paths (modulo the wall-clock latency
    readings — see :func:`canonical_document`) is the contract."""
    from gpuschedule_tpu_torch.faults.sweep import jsonable

    return jsonable({
        "at_s": sim.now,
        "requested_at_s": requested_at,
        "horizon_s": horizon,
        "pool": pool,
        "policy": run_meta["policy"],
        "run_id": run_meta["run_id"],
        "config_hash": run_meta["config_hash"],
        "mirror": {
            "running": len(sim.running),
            "pending": len(sim.pending),
            "finished": len(sim.finished),
        },
        "latency_ms": latency_summary(results),
        "queries": results,
    })


def canonical_document(doc: dict) -> dict:
    """The wall-clock-free projection of a result document: every field
    is a pure function of (world, mirror instant, queries) EXCEPT the
    latency readings, which are measurements of this host right now.
    Dropping them (the summary keeps its ``count``) leaves the byte
    surface the served-vs-offline identity contract compares."""
    out = copy.deepcopy(doc)
    out["latency_ms"] = {"count": out["latency_ms"]["count"]}
    for q in out["queries"]:
        q.pop("latency_s", None)
    return out


def latency_summary(results: Sequence[dict]) -> dict:
    """p50/p95/max over the per-query latencies, in milliseconds."""
    from gpuschedule_tpu_torch.obs.metrics import exact_quantile

    lats = sorted(1000.0 * r["latency_s"] for r in results)
    if not lats:
        return {"count": 0}
    return {
        "count": len(lats),
        "p50_ms": exact_quantile(lats, 0.50),
        "p95_ms": exact_quantile(lats, 0.95),
        "max_ms": lats[-1],
    }


def append_history(store_path, results: Sequence[dict], *,
                   run_meta: Optional[dict] = None,
                   pool_stats: Optional[dict] = None) -> int:
    """One history row per query (kind ``whatif``, label = query
    kind), so the twin's own serving latency and the deltas it reported
    trend across invocations like any other result.  ``pool_stats``
    (:meth:`WhatIfService.pool_stats`) appends one extra row
    labeled ``pool`` carrying the pool-lifecycle counters — worker
    count, respawns, retries — so fleet health trends beside query
    latency; ``None`` (the in-process path) adds nothing."""
    from gpuschedule_tpu_torch.obs.history import HistoryStore

    meta = run_meta or {}
    n = 0
    with HistoryStore(store_path) as store:
        for doc in results:
            q = doc["query"]
            metrics = {
                "latency_ms": 1000.0 * doc["latency_s"],
                "at_s": doc["at_s"],
                "horizon_s": doc["horizon_s"],
                "delta_avg_jct_s": doc["delta"]["avg_jct_s"],
                "delta_num_finished": doc["delta"]["num_finished"],
            }
            admitted = doc.get("admitted")
            if admitted is not None and "jct_s" in admitted:
                metrics["admit_jct_s"] = admitted["jct_s"]
            store.append(
                "whatif",
                run_id=meta.get("run_id", ""),
                config_hash=meta.get("config_hash", ""),
                policy=meta.get("policy", ""),
                seed=meta.get("seed"),
                label=q["kind"],
                metrics=metrics,
            )
            n += 1
        if pool_stats is not None:
            store.append(
                "whatif",
                run_id=meta.get("run_id", ""),
                config_hash=meta.get("config_hash", ""),
                policy=meta.get("policy", ""),
                seed=meta.get("seed"),
                label="pool",
                metrics={
                    "workers": pool_stats["workers"],
                    "respawns": pool_stats["respawns"],
                    "retries": pool_stats["retries"],
                    "queries": len(results),
                },
            )
            n += 1
    return n
