"""Persistent process worker pool.

The port's own copy of ``gpuschedule_tpu/sim/pool.py``.  A fresh
``ProcessPoolExecutor`` per call (and per *retry round*) is fine for
minutes-long sweep cells and hopeless for the digital twin's what-if
queries, where a worker must restore a mirrored engine snapshot ONCE and
then answer many sub-second queries against it.  This module is the
long-lived pool both callers share:

- **warm workers**: each worker is one long-lived process with its own
  request queue; :meth:`WorkerPool.broadcast` runs a load function on
  every worker (shipping e.g. snapshot bytes) and the pool remembers the
  load so a respawned worker is re-warmed before it serves anything;
- **deterministic reassembly**: :meth:`WorkerPool.map` returns results
  in task order whatever the completion interleaving — the serial-vs-
  parallel byte-identity rule of docs/performance.md;
- **crash/retry semantics**: a task whose worker
  crashed (OOM-kill, hard ``os._exit``) or raised is retried up to
  ``max_retries`` times with exponential backoff; only the failed task
  re-runs, on a freshly respawned (and re-warmed) worker when the old
  one died — no fresh-pool-per-round churn, surviving workers keep
  serving;
- **per-task fault isolation**: one dead worker takes down exactly its
  in-flight task, never its poolmates' (a ``ProcessPoolExecutor`` breaks
  the whole pool).

Tasks and their results cross process boundaries by pickle: task
functions must be module-level, and results must be picklable.  Pure
stdlib, host code.

Workers fork, as in the JAX package, unless torch has worked in this
process before the pool starts (Optimus profiling online, on the card or
the CPU): a forked child can use neither the parent's CUDA context nor
its torch thread pools (it fails, or hangs), so the pool then spawns its
workers (:func:`default_context`), and a worker that meets an unseen
model profiles it as the parent would.
"""

from __future__ import annotations

import itertools
import multiprocessing
import pickle
import queue as queue_mod
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class WorkerCrashError(RuntimeError):
    """A worker process died (hard exit / kill) while running a task."""


class RemoteError(RuntimeError):
    """A task raised an exception that could not itself be pickled back;
    carries the remote traceback text."""


_POLL_S = 0.05  # response-queue poll granularity (liveness check cadence)


def default_context():
    """The start method a pool takes when the caller names none: the
    platform's default (fork on Linux), or ``spawn`` once torch has a CUDA
    context in this process or the port's profiler harness has measured a
    step here (its thread pools): a forked child could use neither."""
    torch = sys.modules.get("torch")
    harness = sys.modules.get("gpuschedule_tpu_torch.profiler.harness")
    if ((torch is not None and torch.cuda.is_initialized())
            or getattr(harness, "STEPS_MEASURED", False)):
        return multiprocessing.get_context("spawn")
    return multiprocessing.get_context()


def _worker_main(wid: int, req_q, res_q) -> None:
    """Worker loop: apply ``fn(*args)`` per request, ship back
    ``(wid, task_id, ok, payload)``.  Warm state lives in the task
    functions' own module globals (see sim/whatif.py) — the pool itself
    is payload-agnostic."""
    while True:
        msg = req_q.get()
        if msg is None:
            break
        task_id, fn, args = msg
        try:
            out = fn(*args)
            ok = True
        except BaseException as e:  # noqa: BLE001 — everything crosses back
            out = e
            ok = False
        try:
            res_q.put((wid, task_id, ok, out))
        except Exception:
            # unpicklable result/exception: degrade to a text-carrying
            # error instead of wedging the parent's result loop
            res_q.put((wid, task_id, False, RemoteError(
                f"task {task_id} result not picklable: "
                f"{traceback.format_exc()}"
            )))


class _Worker:
    __slots__ = ("proc", "req_q")

    def __init__(self, proc, req_q):
        self.proc = proc
        self.req_q = req_q


class WorkerPool:
    """A persistent pool of ``workers`` warm processes.

    ``max_retries`` / ``backoff_s`` follow the grid semantics: a
    failed task (worker crash or task exception) is retried up to
    ``max_retries`` times, sleeping ``backoff_s * 2^(attempt-1)``
    between attempts; exhausting the budget re-raises the last error.
    ``on_retry(task_index, attempt)`` (when given) is invoked once per
    retry — the hook :func:`gpuschedule_tpu_torch.faults.sweep.grid_cells`
    adapts onto its ``retry_log`` contract.

    ``registry`` (any object with the ``MetricsRegistry.counter``
    surface; the pool stays import-free of the obs layer) surfaces pool
    lifecycle in the metrics plane:
    ``pool_worker_respawns_total`` counts dead workers respawned and
    ``pool_task_retries_total`` counts task attempts retried — the same
    events the ``retry_log`` records, now exportable via ``--prom`` and
    the history store.  ``self.respawns`` / ``self.retries`` mirror them
    as plain ints regardless.
    """

    def __init__(
        self,
        workers: int,
        *,
        max_retries: int = 2,
        backoff_s: float = 1.0,
        on_retry: Optional[Callable[[int, int], None]] = None,
        mp_context=None,
        registry=None,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._ctx = mp_context or default_context()
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.on_retry = on_retry
        self._res_q = self._ctx.Queue()
        self._task_ids = itertools.count()
        self._workers: Dict[int, _Worker] = {}
        # warm-state loads, replayed (in order) into every respawned
        # worker before it serves tasks: the "restore once" contract
        self._loads: List[Tuple[Callable, tuple]] = []
        self._closed = False
        self.respawns = 0
        self.retries = 0
        self._respawns_c = self._retries_c = None
        if registry is not None:
            self._respawns_c = registry.counter(
                "pool_worker_respawns_total",
                "dead pool workers respawned (and re-warmed)",
            )
            self._retries_c = registry.counter(
                "pool_task_retries_total",
                "pool task attempts retried after a crash or exception",
            )
        for wid in range(int(workers)):
            self._spawn(wid)

    # ------------------------------------------------------------------ #
    # lifecycle

    def _spawn(self, wid: int) -> None:
        req_q = self._ctx.Queue()
        proc = self._ctx.Process(
            target=_worker_main, args=(wid, req_q, self._res_q), daemon=True
        )
        proc.start()
        self._workers[wid] = _Worker(proc, req_q)

    def close(self) -> None:
        """Stop every worker (sentinel, then terminate stragglers)."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers.values():
            try:
                w.req_q.put(None)
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for w in self._workers.values():
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=1.0)
        self._workers.clear()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def workers(self) -> int:
        return len(self._workers)

    # ------------------------------------------------------------------ #
    # scheduling core

    def _send(self, wid: int, fn: Callable, args: tuple) -> int:
        task_id = next(self._task_ids)
        self._workers[wid].req_q.put((task_id, fn, args))
        return task_id

    def _revive(self, wid: int) -> None:
        """Respawn a dead worker and replay the warm-state loads into its
        queue ahead of any task (FIFO per worker: the loads run first).
        Load acks are awaited lazily by the caller's result loop."""
        w = self._workers.get(wid)
        if w is not None:
            w.proc.join(timeout=0.1)
        self._spawn(wid)
        self.respawns += 1
        if self._respawns_c is not None:
            self._respawns_c.inc()
        for fn, args in self._loads:
            # fire-and-forget: a failing replayed load surfaces when the
            # worker's next task crashes or errors, which retries it
            self._workers[wid].req_q.put((next(self._task_ids), fn, args))

    def _note_retry(self) -> None:
        self.retries += 1
        if self._retries_c is not None:
            self._retries_c.inc()

    def broadcast(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on EVERY worker (warm-state load), blocking
        until each acknowledged.  The load is remembered and replayed
        into any worker respawned later, so warm state survives crashes.
        A worker whose load keeps failing after ``max_retries`` respawns
        takes the pool down (without its state the pool would silently
        serve from cold workers)."""
        if self._closed:
            raise RuntimeError("broadcast on a closed pool")
        pending: Dict[int, int] = {}   # task_id -> wid
        attempts: Dict[int, int] = dict.fromkeys(self._workers, 0)
        for wid in sorted(self._workers):
            pending[self._send(wid, fn, args)] = wid
        while pending:
            try:
                wid, task_id, ok, payload = self._res_q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                for task_id, wid in list(pending.items()):
                    if not self._workers[wid].proc.is_alive():
                        del pending[task_id]
                        attempts[wid] += 1
                        if attempts[wid] > self.max_retries:
                            raise WorkerCrashError(
                                f"worker {wid} died {attempts[wid]}x "
                                "during warm-state load"
                            )
                        self._note_retry()
                        time.sleep(
                            self.backoff_s * (2 ** (attempts[wid] - 1))
                        )
                        self._revive(wid)
                        pending[self._send(wid, fn, args)] = wid
                continue
            if task_id not in pending:
                continue  # stale ack from a replaced incarnation
            del pending[task_id]
            if not ok:
                attempts[wid] += 1
                if attempts[wid] > self.max_retries:
                    raise payload
                self._note_retry()
                time.sleep(self.backoff_s * (2 ** (attempts[wid] - 1)))
                pending[self._send(wid, fn, args)] = wid
        self._loads.append((fn, args))

    def map(
        self,
        fn: Callable,
        items: Sequence[tuple],
        *,
        on_retry: Optional[Callable[[int, int], None]] = None,
        fleet=None,
    ) -> list:
        """``[fn(*item) for item in items]`` across the pool, results in
        item order.  Retries follow the pool's crash/retry semantics; a
        task exhausting its budget re-raises and abandons the rest.

        ``fleet`` (a :class:`gpuschedule_tpu_torch.obs.fleet.FleetCollector`,
        duck-typed so the pool stays obs-import-free) arms cross-process
        tracing: each task ships wrapped with its trace-context
        envelope via ``fleet.task(fn, idx, args)``, and each *successful*
        result is unwrapped through ``fleet.absorb(idx, wid, payload)``,
        which records the worker's telemetry keyed by task index.  The
        retry discipline is structural: a crashed attempt's telemetry
        died with its process, a raised attempt's is never returned, and
        a retired incarnation's late success is dropped right here (the
        ``running.get(task_id) is None`` guard) before it could reach the
        collector — merged telemetry never double-counts an attempt."""
        if self._closed:
            raise RuntimeError("map on a closed pool")
        on_retry = on_retry or self.on_retry
        n = len(items)
        results: list = [None] * n
        done = 0
        next_item = 0
        attempts = [0] * n
        running: Dict[int, Tuple[int, int]] = {}  # task_id -> (index, wid)
        busy: Dict[int, int] = {}                 # wid -> task_id
        retry_at: List[Tuple[float, int]] = []    # (eligible time, index)
        ready: List[int] = []                     # indices eligible now

        def fill_workers() -> None:
            nonlocal next_item
            now = time.monotonic()
            while retry_at and retry_at[0][0] <= now:
                ready.append(retry_at.pop(0)[1])
            for wid in sorted(self._workers):
                if wid in busy:
                    continue
                if ready:
                    idx = ready.pop(0)
                elif next_item < n:
                    idx = next_item
                    next_item += 1
                else:
                    return
                if fleet is None:
                    task_id = self._send(wid, fn, tuple(items[idx]))
                else:
                    wfn, wargs = fleet.task(fn, idx, tuple(items[idx]))
                    task_id = self._send(wid, wfn, wargs)
                running[task_id] = (idx, wid)
                busy[wid] = task_id

        def fail(task_id: int, idx: int, wid: int, error: Exception) -> None:
            running.pop(task_id, None)
            if busy.get(wid) == task_id:
                del busy[wid]
            attempts[idx] += 1
            if attempts[idx] > self.max_retries:
                raise error
            self._note_retry()
            if on_retry is not None:
                on_retry(idx, attempts[idx])
            delay = self.backoff_s * (2 ** (attempts[idx] - 1))
            retry_at.append((time.monotonic() + delay, idx))
            retry_at.sort()

        fill_workers()
        while done < n:
            try:
                wid, task_id, ok, payload = self._res_q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                for task_id, (idx, wid) in list(running.items()):
                    if not self._workers[wid].proc.is_alive():
                        fail(task_id, idx, wid, WorkerCrashError(
                            f"worker {wid} died running task {idx}"
                        ))
                        self._revive(wid)
                fill_workers()
                continue
            entry = running.get(task_id)
            if entry is None:
                continue  # warm-load ack or a retired incarnation's task
            idx, twid = entry
            if ok:
                del running[task_id]
                if busy.get(twid) == task_id:
                    del busy[twid]
                if fleet is None:
                    results[idx] = payload
                else:
                    results[idx] = fleet.absorb(idx, twid, payload)
                done += 1
            else:
                fail(task_id, idx, twid, payload)
            fill_workers()
        return results
