"""Observability: spans, events and always-on counters, kernel
utilization accounting, and latency summaries (the port of
``repro.obs``).

* **counters**: always-on monotonic integers (:func:`counter_inc` /
  :func:`counters`); ``ops.fallback_counts`` and ``tune.calls`` read
  them.
* **spans / events**: structured JSONL tracing (:func:`span` /
  :func:`event`), a shared no-op when disabled; switch with
  :func:`enable` / :func:`disable` or the scoped :func:`capture`.
* **regions**: :func:`region` names a stretch of the program; while a
  CUDA graph is captured (:func:`recording`, :class:`RegionRecorder`)
  each device node of the graph is mapped to its innermost region, and
  the map goes into the capture's record; a no-op outside a capture.
* **kernel watch**: per-dispatch :class:`OpRecord` accounting of the
  resolved :class:`~repro_torch.plan.KernelConfig`, joined with the
  Hopper model's prediction and an optional measurement on the card
  into :func:`utilization_table`.
* **metrics**: :func:`percentile` and :func:`summarize` of latency
  samples.
"""

from repro_torch.obs.kernel_watch import (
    OpRecord,
    measure_recorded,
    record_dispatch,
    recorded_ops,
    reset_records,
    utilization_table,
)
from repro_torch.obs.metrics import percentile, summarize
from repro_torch.obs.trace import (
    JsonlSink,
    ListSink,
    RegionRecorder,
    Span,
    capture,
    counter_inc,
    counters,
    disable,
    enable,
    enabled,
    event,
    first_in_session,
    recording,
    region,
    reset_counters,
    span,
)

__all__ = [
    # trace
    "Span", "JsonlSink", "ListSink", "span", "event", "enable",
    "disable", "enabled", "capture", "counter_inc", "counters",
    "reset_counters", "region", "RegionRecorder", "recording",
    "first_in_session",
    # metrics
    "percentile", "summarize",
    # kernel watch
    "OpRecord", "record_dispatch", "recorded_ops", "reset_records",
    "utilization_table", "measure_recorded",
]
