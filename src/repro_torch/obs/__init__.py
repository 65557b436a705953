"""Observability: spans, events and always-on counters, and latency
summaries (the port of ``repro.obs`` without its kernel watch).

* **counters**: always-on monotonic integers (:func:`counter_inc` /
  :func:`counters`); ``ops.fallback_counts`` reads them.
* **spans / events**: structured JSONL tracing (:func:`span` /
  :func:`event`), a shared no-op when disabled; switch with
  :func:`enable` / :func:`disable` or the scoped :func:`capture`.
* **metrics**: :func:`percentile` and :func:`summarize` of latency
  samples.
"""

from repro_torch.obs.metrics import percentile, summarize
from repro_torch.obs.trace import (
    JsonlSink,
    ListSink,
    Span,
    capture,
    counter_inc,
    counters,
    disable,
    enable,
    enabled,
    event,
    reset_counters,
    span,
)

__all__ = [
    # trace
    "Span", "JsonlSink", "ListSink", "span", "event", "enable",
    "disable", "enabled", "capture", "counter_inc", "counters",
    "reset_counters",
    # metrics
    "percentile", "summarize",
]
