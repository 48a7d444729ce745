"""repro_torch.obs — stdlib-only observability: metrics registry + span tracing.

A copy of the reference's ``repro.obs`` (the port imports nothing of
``repro``):

* :class:`MetricsRegistry` — thread-safe counters, gauges, and log-bucketed
  histograms with p50/p95/p99 export; :func:`merge_snapshots` aggregates
  many snapshots into one.
* :func:`span` — causal tracing context manager emitting JSONL records
  (trace/span/parent IDs + wall/CPU time + byte counts) when
  ``REPRO_TRACE`` is set; a shared no-op otherwise.  :func:`current_context`
  and :func:`scope` carry the causal chain across thread seams.
* :class:`PhaseClock` — exact wall-time partitioner behind the
  ``req.latency_s{op=,phase=}`` request histograms.
"""
from .metrics import (
    BUCKETS_PER_OCTAVE,
    MetricsRegistry,
    PhaseClock,
    bucket_index,
    bucket_value,
    labeled,
    merge_snapshots,
)
from .trace import TRACE_ENV, Span, current_context, enabled, scope, span

__all__ = [
    "BUCKETS_PER_OCTAVE",
    "MetricsRegistry",
    "PhaseClock",
    "Span",
    "TRACE_ENV",
    "bucket_index",
    "bucket_value",
    "current_context",
    "enabled",
    "labeled",
    "merge_snapshots",
    "scope",
    "span",
]
