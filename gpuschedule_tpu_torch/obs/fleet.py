"""Cross-process observability: trace-context propagation + federation.

The port's own copy of ``gpuschedule_tpu/obs/fleet.py``: the layer that
makes the pooled twin observable end to end.  The tracer spans, metrics
registry, selfprof phases and Perfetto export are single-process, while
the system's parallelism lives in
:class:`~gpuschedule_tpu_torch.sim.pool.WorkerPool` child processes whose
restore/fork/replay time, crashes and retries would otherwise show only as
a terse ``retry_log``.  This module closes that gap with three pieces:

**Trace-context propagation.**  A :class:`FleetCollector` on the parent
side hands every pool task a picklable :class:`TaskContext` envelope
``(trace_id, parent_span_id, task)``.  The pool ships each task through
:func:`run_task`, which arms a per-task :class:`WorkerTelemetry` harness
in the child — a child :class:`~gpuschedule_tpu_torch.obs.tracer.Tracer`, a
child :class:`~gpuschedule_tpu_torch.obs.metrics.MetricsRegistry`, and (when the
task attaches one) a :class:`~gpuschedule_tpu_torch.obs.selfprof.PhaseProfiler`
— and returns the telemetry alongside the result.  Task code reaches the
active harness through :func:`task_span` / :func:`task_profiler` /
:func:`active`; all three are no-ops costing one module-global read when
no harness is armed, so the disarmed path stays byte-identical.

**Deterministic federation.**  The collector keys every returned payload
by *task index*, not arrival order: worker registries merge into the
parent's via :meth:`MetricsRegistry.merge` in task order, selfprof blocks
merge per worker via :func:`~gpuschedule_tpu_torch.obs.selfprof.merge_profiles`,
and the merged document is a pure function of the payloads — adversarial
completion order cannot change a byte of it.  The retry discipline is
structural: telemetry only travels with a *successful* result, so a
crashed attempt's partial telemetry dies with its process, a raised
attempt's telemetry is never returned, and a retired incarnation's late
success is dropped by the pool before it reaches the collector.  Nothing
double-counts, nothing is lost.

**One merged Perfetto document.**  :meth:`FleetCollector.document` emits
a single Chrome/Perfetto trace: the parent's enqueue/dispatch/reassemble
spans on process 1, one named process per worker, and every worker span
carrying ``trace_id`` / ``parent_span_id`` args linking it back to the
parent query — load it in ui.perfetto.dev and the whole fleet is one
timeline.  Per-process clocks are not comparable across processes (each
anchors at its own first-task origin), which is the standard multi-process
Chrome-trace situation; within a process, spans lay out in real order.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from gpuschedule_tpu_torch.obs.metrics import MetricsRegistry
from gpuschedule_tpu_torch.obs.tracer import NULL_SPAN, Tracer

# --------------------------------------------------------------------- #
# the propagated envelope


@dataclass(frozen=True)
class TaskContext:
    """The picklable trace-context envelope every fleet task ships:
    which trace it belongs to, which parent span dispatched it, and its
    task index (the deterministic federation key)."""

    trace_id: str
    parent_span_id: str
    task: int


# --------------------------------------------------------------------- #
# worker side: the per-task telemetry harness

# lint: allow[GS601] deliberately process-local: the active per-task harness of THIS worker process
_ACTIVE: Optional["WorkerTelemetry"] = None
# lint: allow[GS601] deliberately process-local: one wall anchor per worker process so its tasks lay out sequentially on one track
_PROC_ORIGIN: Optional[float] = None


class WorkerTelemetry:
    """One task's child telemetry: a tracer anchored at the worker
    process's first-task origin, a fresh registry, and an optional
    self-profiler the task may attach.  ``payload()`` is the picklable
    blob that rides home with the result."""

    def __init__(self, ctx: TaskContext):
        global _PROC_ORIGIN
        if _PROC_ORIGIN is None:
            # lint: allow[GS101] the wall anchor of this worker's trace track; replay output never reads it
            _PROC_ORIGIN = time.perf_counter()
        self.ctx = ctx
        self.tracer = Tracer(enabled=True, origin=_PROC_ORIGIN)
        self.registry = MetricsRegistry()
        self.profiler = None

    def attach_profiler(self):
        """A fresh :class:`PhaseProfiler` for this task (idempotent per
        task) — sweep cells hand it to their ``Simulator`` so every cell
        returns an engine-phase profile."""
        if self.profiler is None:
            from gpuschedule_tpu_torch.obs.selfprof import PhaseProfiler

            self.profiler = PhaseProfiler()
        return self.profiler

    def payload(self) -> dict:
        prof = None
        if self.profiler is not None and self.profiler.total_wall_s > 0:
            prof = self.profiler.profile()
        return {
            "trace_id": self.ctx.trace_id,
            "parent_span_id": self.ctx.parent_span_id,
            "task": self.ctx.task,
            "spans": _span_events(self.tracer, {
                "trace_id": self.ctx.trace_id,
                "parent_span_id": self.ctx.parent_span_id,
                "task": self.ctx.task,
            }),
            "registry": self.registry.snapshot(),
            "selfprof": prof,
        }


def active() -> Optional[WorkerTelemetry]:
    """The harness of the task currently executing in THIS process, or
    ``None`` — the one-global-read hook instrumented task code keys on."""
    return _ACTIVE


def task_span(name: str, **attrs):
    """A span on the active harness's tracer; :data:`NULL_SPAN` (free)
    when no harness is armed — call sites stay branch-free."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.tracer.span(name, **attrs)


def task_profiler():
    """A :class:`PhaseProfiler` attached to the active harness, or
    ``None`` when no harness is armed (the default-off path)."""
    t = _ACTIVE
    if t is None:
        return None
    return t.attach_profiler()


def run_task(fn, ctx: TaskContext, args: tuple) -> dict:
    """The module-level (picklable) wrapper the pool ships when a fleet
    collector is armed: arm a harness, run the task under a root span,
    and return ``{"result", "telemetry"}``.  Exceptions propagate with
    the harness already disarmed — a failed attempt returns no telemetry,
    which is the whole retry discipline."""
    global _ACTIVE
    telem = WorkerTelemetry(ctx)
    _ACTIVE = telem
    try:
        with telem.tracer.span("task", cat="fleet", task=ctx.task):
            result = fn(*args)
    finally:
        _ACTIVE = None
    return {"result": result, "telemetry": telem.payload()}


def _span_events(tracer: Tracer, extra_args: dict) -> List[dict]:
    """Serialize a tracer's spans to plain Chrome ``X`` events (ts/dur in
    µs), each stamped with ``extra_args`` — the propagated trace context.
    Sorted by (ts, depth, name) so the serialization is a pure function
    of the spans."""
    events = []
    for sp in sorted(
        tracer.spans, key=lambda s: (s.wall_start, s.depth, s.name)
    ):
        args: Dict[str, Any] = dict(sp.attrs)
        if sp.sim_start is not None:
            args["sim_start_s"] = sp.sim_start
        if sp.sim_end is not None:
            args["sim_end_s"] = sp.sim_end
        args.update(extra_args)
        events.append({
            "name": sp.name,
            "cat": sp.cat or "span",
            "ph": "X",
            "ts": round(max(0.0, sp.wall_start) * 1e6, 3),
            "dur": round(max(0.0, sp.wall_dur) * 1e6, 3),
            "args": args,
        })
    return events


# --------------------------------------------------------------------- #
# parent side: the collector


class FleetCollector:
    """Parent-side half of the layer: mints task envelopes, records the
    parent span tree (enqueue → dispatch → reassemble), absorbs worker
    payloads keyed by task index, and federates them into one registry /
    selfprof block / Perfetto document.

    ``registry`` is the collector's parent-side registry — hand it to
    :class:`WorkerPool` so ``pool_worker_respawns_total`` and
    ``pool_task_retries_total`` land next to the federated worker
    families in the merged document.
    """

    def __init__(self, trace_id, *, parent: str = "parent"):
        self.trace_id = str(trace_id)
        self.parent = parent
        self.tracer = Tracer(enabled=True)
        self.registry = MetricsRegistry()
        self._telemetry: Dict[int, dict] = {}
        self._worker_of: Dict[int, Any] = {}

    # -- parent spans / envelopes -------------------------------------- #

    def span(self, name: str, **attrs):
        """One parent-side span; its ``span_id`` arg is the name worker
        spans link back to via ``parent_span_id``."""
        return self.tracer.span(
            name, cat="fleet", trace_id=self.trace_id, span_id=name, **attrs
        )

    def envelope(self, task: int) -> TaskContext:
        return TaskContext(self.trace_id, "dispatch", int(task))

    def task(self, fn, idx: int, args: tuple):
        """The pool adapter: ``(wrapped_fn, wrapped_args)`` for task
        ``idx`` — what :meth:`WorkerPool.map` ships when armed."""
        return run_task, (fn, self.envelope(idx), tuple(args))

    # -- absorption ----------------------------------------------------- #

    def absorb(self, idx: int, worker, payload: dict):
        """Record one successful task's telemetry (keyed by task index —
        arrival order is irrelevant) and unwrap its result."""
        self._telemetry[idx] = payload["telemetry"]
        self._worker_of[idx] = worker
        return payload["result"]

    def run_local(self, fn, idx: int, args: tuple):
        """The serial counterpart of a pooled task: run ``fn`` in-process
        under the same harness, absorb under worker key ``"local"``."""
        return self.absorb(idx, "local", run_task(fn, self.envelope(idx), args))

    # -- federation ------------------------------------------------------ #

    @staticmethod
    def worker_key(worker) -> str:
        return "worker-local" if worker == "local" else f"worker-{worker}"

    def merge_into(self, registry: MetricsRegistry) -> MetricsRegistry:
        """Fold every absorbed worker registry into ``registry`` in task
        order — counter sums, bucket-wise histograms, label-family union
        (see :meth:`MetricsRegistry.merge`)."""
        for idx in sorted(self._telemetry):
            registry.merge(self._telemetry[idx]["registry"])
        return registry

    def merged_registry(self) -> MetricsRegistry:
        """Parent-side counters plus all worker registries, merged fresh
        (safe to call repeatedly — never mutates ``self.registry``)."""
        return self.merge_into(MetricsRegistry().merge(self.registry))

    def profiles(self) -> Dict[str, List[dict]]:
        """Selfprof blocks grouped by worker key, each worker's blocks in
        task order — the :func:`merge_profiles` input."""
        per: Dict[str, List[dict]] = {}
        for idx in sorted(self._telemetry):
            block = self._telemetry[idx].get("selfprof")
            if block:
                key = self.worker_key(self._worker_of[idx])
                per.setdefault(key, []).append(block)
        return per

    def worker_events(self) -> Dict[str, List[dict]]:
        per: Dict[str, List[dict]] = {}
        for idx in sorted(self._telemetry):
            key = self.worker_key(self._worker_of[idx])
            per.setdefault(key, []).extend(self._telemetry[idx]["spans"])
        return per

    # -- the merged document --------------------------------------------- #

    def document(self) -> dict:
        """One merged Perfetto/Chrome trace document: parent process +
        one named process per worker, plus the federated ``registry`` and
        per-worker ``selfprof`` blocks (Perfetto ignores extra keys)."""
        from gpuschedule_tpu_torch.obs.perfetto import fleet_trace_events

        workers = self.worker_events()
        doc: dict = {
            "traceEvents": fleet_trace_events(
                _span_events(self.tracer, {}), workers,
                parent_name=self.parent,
            ),
            "displayTimeUnit": "ms",
            "otherData": {
                "clock": "wall",
                "exporter": "gpuschedule_tpu.obs.fleet",
                "trace_id": self.trace_id,
            },
            "federation": {
                "tasks": len(self._telemetry),
                "workers": sorted(workers),
            },
        }
        reg_json = self.merged_registry().to_json()
        if reg_json:
            doc["registry"] = reg_json
        prof = self.profiles()
        if prof:
            from gpuschedule_tpu_torch.obs.selfprof import merge_profiles

            doc["selfprof"] = merge_profiles(prof)
        return doc

    def write(self, path) -> dict:
        doc = self.document()
        out = Path(path)
        if out.parent and not out.parent.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        return doc
