"""Observability: the span tracer (own copy of the JAX package's)."""

from gpuschedule_tpu_torch.obs.tracer import NULL_SPAN, Span, Tracer, get_tracer

__all__ = ["NULL_SPAN", "Span", "Tracer", "get_tracer"]
