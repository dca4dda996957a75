"""Observability subsystem of the port (counterpart of ``repro/obs/``):
structured tracing, labeled metrics, and Eq.-3 model-vs-measurement
reconciliation.

Layers:
  trace.py      — nested spans + instant events (perf_counter), no-op
                  singleton when disabled, Chrome-trace/JSONL exporters,
                  optional torch.profiler.record_function pass-through
  registry.py   — labeled counters/gauges/histograms, snapshot/diff,
                  JSON + Prometheus text export
  reconcile.py  — measured per-layer fetch/compute/overlap vs the
                  modeled serial/overlapped Eq.-3 clocks
  validate.py   — Chrome trace-event schema validator (CLI for CI)

Enable tracing programmatically (``enable_tracing()``) or with the
``REPRO_TRACE=1`` environment variable; disabled tracing costs one
attribute check on the hot paths. On a CUDA device the offload engine
synchronizes at span boundaries while a tracer is enabled (and never
otherwise), so a span holds the device work it wraps.
"""
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .reconcile import (
    LayerReconciliation,
    ReconciliationReport,
    reconcile,
)
from .trace import (
    NULL_TRACER,
    InstantRecord,
    NullTracer,
    SpanRecord,
    Tracer,
    chrome_trace,
    clock_span,
    disable_tracing,
    enable_tracing,
    get_tracer,
)
from .validate import validate_chrome_trace

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LayerReconciliation",
    "ReconciliationReport",
    "reconcile",
    "NULL_TRACER",
    "InstantRecord",
    "NullTracer",
    "SpanRecord",
    "Tracer",
    "chrome_trace",
    "clock_span",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "validate_chrome_trace",
]
