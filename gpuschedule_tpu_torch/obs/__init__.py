"""Observability: the span tracer, the metrics registry and the replay's
track names (own copies of the JAX package's)."""

from gpuschedule_tpu_torch.obs.metrics import MetricsRegistry
from gpuschedule_tpu_torch.obs.perfetto import track_label
from gpuschedule_tpu_torch.obs.tracer import NULL_SPAN, Span, Tracer, get_tracer

__all__ = ["MetricsRegistry", "NULL_SPAN", "Span", "Tracer", "get_tracer", "track_label"]
