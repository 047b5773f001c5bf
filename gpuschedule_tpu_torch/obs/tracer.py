"""Span tracer: nested wall/sim-time spans with a zero-cost disabled path.

The port's own copy of ``gpuschedule_tpu/obs/tracer.py`` (which imports no
JAX, but the port imports nothing of the JAX package), cut to what the
port's spans use: ``Span`` (with its simulated clock, which the
simulator's traced loop stamps), ``Tracer`` (``span``, ``record``,
``spans``, ``summary``, the wall-clock Chrome export that ``run --spans``
writes), :data:`NULL_SPAN` and the ``GSTPU_TRACE`` switch, so a span the
port records has the name and attribute keys of the JAX package's span
for the same call, and the shared ``origin`` that the fleet layer
(:mod:`gpuschedule_tpu_torch.obs.fleet`) gives every per-task tracer of a
worker process.

A span is a context-managed interval with a name, a category and
attributes, on the wall clock and, when the caller passes ``sim_now``, on
the simulated one.  Spans nest: each thread keeps its own depth stack.

Cost:

- **disabled** (the default): a call site checks ``tracer.enabled`` (one
  attribute load) or receives the shared :data:`NULL_SPAN`, whose methods
  are empty: no allocation, no lock, no clock read, no device sync;
- **enabled**: one ``perf_counter`` pair, one small ``Span`` and one
  lock-guarded list append per span.  The train step's span is fenced by a
  readback of the loss (``ShardedTrainer.step``), which serialises the
  host with the device while tracing is on.

Enable programmatically (``get_tracer().enable()``) or with
``GSTPU_TRACE=1`` in the environment (read at import).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    """One finished (or in-flight) traced interval."""

    name: str
    cat: str = ""
    wall_start: float = 0.0          # perf_counter seconds, tracer-origin relative
    wall_dur: float = 0.0
    depth: int = 0                   # nesting level within the opening thread
    thread: int = 0                  # opening thread ident
    attrs: Dict[str, Any] = field(default_factory=dict)
    sim_start: Optional[float] = None   # simulated seconds, when the caller has a sim clock
    sim_end: Optional[float] = None

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (e.g. a result computed inside it)."""
        self.attrs.update(attrs)
        return self

    def end_sim(self, sim_now: float) -> "Span":
        """Stamp the simulated-clock end (wall end is stamped by ``__exit__``)."""
        self.sim_end = sim_now
        return self


class _NullSpan:
    """Shared no-op span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end_sim(self, sim_now: float) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager binding one live Span to the tracer's thread stack."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        tl = self._tracer._tl
        depth = getattr(tl, "depth", 0)
        self.span.depth = depth
        tl.depth = depth + 1
        self.span.wall_start = time.perf_counter() - self._tracer._origin
        return self.span

    def __exit__(self, *exc) -> bool:
        sp = self.span
        sp.wall_dur = (time.perf_counter() - self._tracer._origin) - sp.wall_start
        tl = self._tracer._tl
        tl.depth = max(0, getattr(tl, "depth", 1) - 1)
        self._tracer._append(sp)
        return False


class Tracer:
    """Collects spans; a process-wide singleton lives behind :func:`get_tracer`.

    ``enabled`` is the single switch every instrumented call site keys on;
    ``wall_start`` 0 is the tracer's creation (or last ``reset``), or
    ``origin`` when given: several tracers of one process then share a
    wall anchor (the fleet layer gives each per-task tracer its worker's
    first-task origin, so the worker's tasks lay out in sequence on its
    track)."""

    def __init__(self, *, enabled: bool = False,
                 origin: Optional[float] = None):
        self.enabled = bool(enabled)
        self._origin = time.perf_counter() if origin is None else origin
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._tl = threading.local()

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def reset(self) -> "Tracer":
        """Drop collected spans and re-anchor the wall origin."""
        with self._lock:
            self._spans = []
        self._origin = time.perf_counter()
        return self

    def span(self, name: str, *, cat: str = "", sim_now: Optional[float] = None, **attrs):
        """Open a span as a context manager; returns :data:`NULL_SPAN` when
        disabled so the call site stays branch-free."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanCtx(self, Span(name=name, cat=cat, sim_start=sim_now,
                                   thread=threading.get_ident(),
                                   attrs=dict(attrs) if attrs else {}))

    def record(
        self,
        name: str,
        *,
        wall_start: float,
        wall_dur: float,
        cat: str = "",
        **attrs,
    ) -> Optional[Span]:
        """Record a span measured by the caller (e.g. a fenced train step).
        ``wall_start`` is an absolute ``perf_counter`` reading, re-based to
        the tracer's origin.  No-op (returns None) when disabled."""
        if not self.enabled:
            return None
        sp = Span(
            name=name,
            cat=cat,
            wall_start=wall_start - self._origin,
            wall_dur=wall_dur,
            depth=getattr(self._tl, "depth", 0),
            thread=threading.get_ident(),
            attrs=dict(attrs) if attrs else {},
        )
        self._append(sp)
        return sp

    def _append(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    @property
    def spans(self) -> List[Span]:
        """Snapshot of finished spans (a copy: safe to iterate while tracing)."""
        with self._lock:
            return list(self._spans)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: count, total/mean/max wall seconds."""
        agg: Dict[str, Dict[str, float]] = {}
        for sp in self.spans:
            a = agg.setdefault(sp.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += sp.wall_dur
            a["max_s"] = max(a["max_s"], sp.wall_dur)
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"] if a["count"] else 0.0
        return agg

    def chrome_events(self) -> List[dict]:
        """Spans as Chrome trace-event dicts on the wall-clock timeline
        (``ts`` in microseconds since the tracer origin), one ``tid`` per
        opening thread; a span's simulated start and end ride its args."""
        tids: Dict[int, int] = {}
        out: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "tracer (wall clock)"}},
        ]
        # spans are collected in close order (inner before outer); the trace
        # format wants begin order
        for sp in sorted(self.spans, key=lambda s: s.wall_start):
            tid = tids.setdefault(sp.thread, len(tids) + 1)
            args = dict(sp.attrs)
            if sp.sim_start is not None:
                args["sim_start_s"] = sp.sim_start
            if sp.sim_end is not None:
                args["sim_end_s"] = sp.sim_end
            out.append({
                "name": sp.name,
                "cat": sp.cat or "span",
                "ph": "X",
                "ts": round(sp.wall_start * 1e6, 3),
                "dur": round(sp.wall_dur * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": args,
            })
        for thread, tid in tids.items():
            out.insert(1, {"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": f"thread-{thread}"}})
        return out

    def write_chrome(self, path) -> str:
        """Write the wall-clock span timeline as a ui.perfetto.dev-loadable
        JSON file; returns the path."""
        doc = {"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return str(path)


_TRACER = Tracer(
    enabled=os.environ.get("GSTPU_TRACE", "").strip().lower()
    not in ("", "0", "false", "no", "off")
)


def get_tracer() -> Tracer:
    """The process-wide tracer singleton every instrumented call site uses."""
    return _TRACER
