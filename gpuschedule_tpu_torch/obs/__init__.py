"""Observability: own copies of the JAX package's ``obs/`` modules.

- :mod:`gpuschedule_tpu_torch.obs.tracer` — nested wall/sim-time spans
  behind a process-wide singleton; disabled by default (``GSTPU_TRACE=1``
  or ``run --spans`` turns it on);
- :mod:`gpuschedule_tpu_torch.obs.metrics` — labeled counters, gauges and
  histograms with Prometheus text and JSON exposition, absorbed by
  ``MetricsLog``;
- :mod:`gpuschedule_tpu_torch.obs.perfetto` — Chrome trace-event export of
  a replay's event stream (``run --perfetto``, ``obs export``);
- :mod:`gpuschedule_tpu_torch.obs.analyze` — streaming per-job lifecycle
  reconstruction from the JSONL event log, in memory or spilled to sqlite
  (``low_memory``);
- :mod:`gpuschedule_tpu_torch.obs.compare` — the two-run regression gate
  and the n-way policy x metric matrix (``compare``);
- :mod:`gpuschedule_tpu_torch.obs.report` — one self-contained HTML report
  (``report``);
- :mod:`gpuschedule_tpu_torch.obs.selfprof` — wall-clock phase profiler of
  the replay loop (``run --self-profile``);
- :mod:`gpuschedule_tpu_torch.obs.history` — append-only sqlite store of
  run and compare summaries (``--history``, ``history list|trend``);
- :mod:`gpuschedule_tpu_torch.obs.fleet` — cross-process observability:
  trace-context envelopes through the worker pool, per-task child
  tracer, registry and profiler, their deterministic federation, and one
  merged Perfetto document with a track per worker (``whatif
  --trace-out``, the sweep tools' ``--trace``).

The JAX package's ``watch`` module is not ported yet.
Like the sim core, this package runs no device code.
"""

from gpuschedule_tpu_torch.obs.tracer import NULL_SPAN, Span, Tracer, get_tracer
from gpuschedule_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exact_quantile,
    get_registry,
    quantile_sorted,
)
from gpuschedule_tpu_torch.obs.analyze import (
    RunAnalysis,
    RunHeader,
    SchemaError,
    StreamCursor,
    StreamError,
    analyze_events,
    analyze_file,
    config_hash,
    iter_jsonl_items,
    iter_jsonl_records,
)
from gpuschedule_tpu_torch.obs.compare import (
    CompareResult,
    MatrixResult,
    compare_matrix,
    compare_runs,
    parse_thresholds,
    write_compare_json,
    write_matrix_json,
)
from gpuschedule_tpu_torch.obs.report import render_report, write_report
from gpuschedule_tpu_torch.obs.selfprof import (
    PHASES,
    PhaseProfiler,
    load_profile,
    merge_profiles,
)
from gpuschedule_tpu_torch.obs.fleet import (
    FleetCollector,
    TaskContext,
    WorkerTelemetry,
    task_profiler,
    task_span,
)
from gpuschedule_tpu_torch.obs.history import (
    HistoryRow,
    HistoryStore,
    render_trend,
    trend_delta,
)
from gpuschedule_tpu_torch.obs.perfetto import (
    export_chrome_trace,
    fleet_trace_events,
    load_events_jsonl,
    trace_events,
    track_label,
    validate_chrome_trace,
)

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "get_tracer",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "exact_quantile",
    "get_registry",
    "quantile_sorted",
    "RunAnalysis",
    "RunHeader",
    "SchemaError",
    "StreamCursor",
    "StreamError",
    "analyze_events",
    "analyze_file",
    "config_hash",
    "iter_jsonl_items",
    "iter_jsonl_records",
    "CompareResult",
    "MatrixResult",
    "compare_matrix",
    "compare_runs",
    "parse_thresholds",
    "write_compare_json",
    "write_matrix_json",
    "render_report",
    "write_report",
    "PHASES",
    "PhaseProfiler",
    "load_profile",
    "merge_profiles",
    "FleetCollector",
    "TaskContext",
    "WorkerTelemetry",
    "task_profiler",
    "task_span",
    "HistoryRow",
    "HistoryStore",
    "render_trend",
    "trend_delta",
    "export_chrome_trace",
    "fleet_trace_events",
    "load_events_jsonl",
    "trace_events",
    "track_label",
    "validate_chrome_trace",
]
