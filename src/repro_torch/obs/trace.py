"""Structured tracing core: spans, events, counters, JSONL sink.

The port's own copy of ``repro.obs.trace``: the same names, the same
JSONL records, the same process-global state.  It imports nothing of
the JAX package.

Design constraints, in priority order:

1. **Near-zero cost when disabled.**  The serving engine calls
   :func:`span` around every admission and block dispatch; with tracing
   off it costs one attribute read and returns a shared no-op context
   manager: no allocation, no clock read.
2. **Counters are always on.**  They are plain dict increments (the
   cheapest observable primitive) and back assertions like
   ``ops.fallback_counts() == {}`` in production runs and tests, so they
   do not ride the enable/disable switch.
3. **One sink, one format.**  Every span and event becomes one JSON
   object on its own line (JSONL): ``{"type": "span"|"event", "name":
   ..., "t": <perf_counter>, ...}``.  Spans add ``dur_s``; keyword
   attributes pass through verbatim, so downstream tooling is
   ``json.loads`` per line and nothing else.

State is process-global (like :mod:`logging`): kernels, the serving
engine and launchers all emit into whatever sink the entry point
configured, without threading a tracer handle through every call.
Times are host clock reads: a span around work on the card covers it
only where the work ends in a device->host read inside the span.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

__all__ = ["Span", "JsonlSink", "ListSink", "span", "event", "enable",
           "disable", "enabled", "capture", "counter_inc", "counters",
           "reset_counters"]

_LOCK = threading.Lock()


class _State:
    __slots__ = ("enabled", "sink", "owns_sink")

    def __init__(self):
        self.enabled = False
        self.sink = None
        self.owns_sink = False


_STATE = _State()
_COUNTERS: collections.Counter = collections.Counter()


# ----------------------------------------------------------------------
# sinks
# ----------------------------------------------------------------------
class JsonlSink:
    """One JSON object per line, appended to ``path`` (or a file-like)."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._file = path_or_file
            self._owns_file = False
        else:
            self._file = open(os.fspath(path_or_file), "a")
            self._owns_file = True

    def write(self, record: dict) -> None:
        self._file.write(json.dumps(record, sort_keys=True,
                                    default=str) + "\n")

    def close(self) -> None:
        self._file.flush()
        if self._owns_file:
            self._file.close()


class ListSink:
    """In-memory sink (tests, programmatic consumers)."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


# ----------------------------------------------------------------------
# spans and events
# ----------------------------------------------------------------------
class Span:
    """Timed context manager; emits one record on exit."""

    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        sink = _STATE.sink
        if sink is not None:
            record = {"type": "span", "name": self.name, "t": self.t0,
                      "dur_s": t1 - self.t0}
            record.update(self.attrs)
            with _LOCK:
                sink.write(record)
        return False


class _NullSpan:
    """The disabled-path span: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs) -> "Span | _NullSpan":
    """Timed span; ``with obs.span("serve.dispatch", k=4): ...``.

    Disabled (or sink-less) tracing returns the shared no-op span —
    the caller never pays for allocation or a clock read.
    """
    if not _STATE.enabled or _STATE.sink is None:
        return _NULL_SPAN
    return Span(name, attrs)


def event(name: str, **fields) -> None:
    """Emit one point-in-time record (no duration)."""
    if not _STATE.enabled or _STATE.sink is None:
        return
    record = {"type": "event", "name": name, "t": time.perf_counter()}
    record.update(fields)
    with _LOCK:
        _STATE.sink.write(record)


# ----------------------------------------------------------------------
# enable/disable
# ----------------------------------------------------------------------
def enabled() -> bool:
    """Master observability switch (spans and events)."""
    return _STATE.enabled


def enable(*, trace_path=None, sink=None) -> None:
    """Turn observability on.

    ``trace_path`` opens a :class:`JsonlSink` there (closed again by
    :func:`disable`); ``sink`` installs a caller-owned sink object.
    With neither, spans and events are dropped.
    """
    if trace_path is not None and sink is not None:
        raise ValueError("pass trace_path or sink, not both")
    disable()
    if trace_path is not None:
        _STATE.sink = JsonlSink(trace_path)
        _STATE.owns_sink = True
    elif sink is not None:
        _STATE.sink = sink
        _STATE.owns_sink = False
    _STATE.enabled = True


def disable() -> None:
    """Turn observability off and close an owned sink."""
    if _STATE.sink is not None and _STATE.owns_sink:
        _STATE.sink.close()
    _STATE.sink = None
    _STATE.owns_sink = False
    _STATE.enabled = False


@contextlib.contextmanager
def capture():
    """Scoped enable with an in-memory sink; yields the :class:`ListSink`.

    Restores the previous tracer state on exit (tests and programmatic
    consumers use this instead of mutating the globals)."""
    prev = (_STATE.enabled, _STATE.sink, _STATE.owns_sink)
    sink = ListSink()
    _STATE.sink = sink
    _STATE.owns_sink = False
    _STATE.enabled = True
    try:
        yield sink
    finally:
        _STATE.enabled, _STATE.sink, _STATE.owns_sink = prev


# ----------------------------------------------------------------------
# counters (always on)
# ----------------------------------------------------------------------
def counter_inc(name: str, n: int = 1) -> None:
    """Increment a monotonic process-global counter."""
    with _LOCK:
        _COUNTERS[name] += n


def counters(prefix: str = "") -> dict[str, int]:
    """Snapshot of counters whose name starts with ``prefix``."""
    with _LOCK:
        return {k: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero every counter whose name starts with ``prefix``."""
    with _LOCK:
        for k in [k for k in _COUNTERS if k.startswith(prefix)]:
            del _COUNTERS[k]
