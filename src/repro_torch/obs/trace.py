"""Structured tracing core: spans, events, counters, JSONL sink, and the
regions of a CUDA graph capture.

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

4. **Regions cost nothing outside a capture.**  :func:`region` names a
   stretch of the program (``attention.core``, ``moe.experts``, ...).
   Outside a CUDA graph capture it is the shared no-op span, one
   attribute read; while :func:`repro_torch.graphs.capture` records a
   graph it notes where the region opens and closes among the graph's
   nodes (:class:`RegionRecorder`), and the map of device nodes to
   regions goes into the capture's record.  A replay runs no Python, so
   a replayed graph pays nothing for its regions.

State is process-global (like :mod:`logging`): kernels, the serving
engine and launchers all emit into whatever sink the entry point
configured, without threading a tracer handle through every call.
Every record's ``t`` (and a span's ``dur_s``) is a reading of the
host's ``time.perf_counter``: a span around work on the card covers it
only where the work ends in a device->host read inside the span.  A
region's map is positional (the i-th device node of a graph), so it
needs no clock of its own.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Callable, Sequence

__all__ = ["Span", "JsonlSink", "ListSink", "span", "event", "enable",
           "disable", "enabled", "capture", "counter_inc", "counters",
           "reset_counters", "region", "RegionRecorder", "recording",
           "first_in_session"]

_LOCK = threading.Lock()


class _State:
    __slots__ = ("enabled", "sink", "owns_sink", "seen", "recorder")

    def __init__(self):
        self.enabled = False
        self.sink = None
        self.owns_sink = False
        self.seen = {}          # id -> token: first_in_session's tokens
        self.recorder = None    # the RegionRecorder of a capture running


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
    _STATE.seen = {}
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
    prev = (_STATE.enabled, _STATE.sink, _STATE.owns_sink, _STATE.seen)
    sink = ListSink()
    _STATE.sink = sink
    _STATE.owns_sink = False
    _STATE.seen = {}
    _STATE.enabled = True
    try:
        yield sink
    finally:
        _STATE.enabled, _STATE.sink, _STATE.owns_sink, _STATE.seen = prev


def first_in_session(token) -> bool:
    """True where tracing is on and ``token`` was not passed here since
    tracing was last switched on (:func:`enable`, :func:`capture`), for
    what a tracing session records once, as a graph's region map.  With
    tracing off it is False after one attribute read."""
    if not _STATE.enabled:
        return False
    if id(token) in _STATE.seen:
        return False
    _STATE.seen[id(token)] = token      # held, so its id is not reused
    return True


# ----------------------------------------------------------------------
# regions of a CUDA graph capture
# ----------------------------------------------------------------------
class _Region:
    """A region open while a recorder runs: notes the capture's position
    at its entry and its exit."""

    __slots__ = ("recorder", "name")

    def __init__(self, recorder: "RegionRecorder", name: str):
        self.recorder = recorder
        self.name = name

    def __enter__(self) -> "_Region":
        self.recorder.mark(self.name, True)
        return self

    def __exit__(self, *exc) -> bool:
        self.recorder.mark(self.name, False)
        return False


def region(name: str) -> "_Region | _NullSpan":
    """A named stretch of the program, for the map of a CUDA graph's
    device nodes: ``with obs.region("attention.core"): ...``.

    Outside a capture (no recorder installed by :func:`recording`) it is
    the shared no-op span, whether tracing is on or off: one attribute
    read, no allocation, no clock.  Inside one, every device node
    captured while the region is the innermost one open is labelled
    with its name."""
    rec = _STATE.recorder
    if rec is None:
        return _NULL_SPAN
    return _Region(rec, name)


class RegionRecorder:
    """Where each :func:`region` of a capture opens and closes among the
    graph's nodes, and the map it gives.

    ``boundary()`` returns the capture's position: the nodes the next
    captured operation will depend on (the last captured on the
    capturing stream; empty before the first).  :meth:`runs` takes the
    graph's nodes in order once the body is captured and labels each
    device node with its innermost open region (None where none is
    open)."""

    def __init__(self, boundary: Callable[[], Sequence]):
        self._boundary = boundary
        self.marks: list[tuple[str, bool, tuple]] = []

    def mark(self, name: str, opening: bool) -> None:
        self.marks.append((name, opening, tuple(self._boundary())))

    def runs(self, chain: Sequence[tuple[object, bool]]) -> dict:
        """``chain``: the graph's nodes in order, each ``(handle,
        runs_on_device)`` (kernel, memcpy and memset nodes run on the
        device) -> ``{"nodes": n, "runs": [[region, first, end], ...]}``
        over the n device nodes' positions, consecutive nodes of one
        region merged into one run."""
        index = {h: i for i, (h, _) in enumerate(chain)}
        # a mark made after node i applies from node i + 1 on; marks are
        # in capture order, and the capture only moves forward
        starts = [max((index[h] + 1 for h in deps), default=0)
                  for _, _, deps in self.marks]
        stack: list[str] = []
        runs: list[list] = []
        m = pos = 0
        for i, (_, on_device) in enumerate(chain):
            while m < len(self.marks) and starts[m] <= i:
                name, opening = self.marks[m][:2]
                if opening:
                    stack.append(name)
                else:
                    stack.pop()         # regions nest: it is the top
                m += 1
            if not on_device:
                continue
            label = stack[-1] if stack else None
            if runs and runs[-1][0] == label:
                runs[-1][2] = pos + 1
            else:
                runs.append([label, pos, pos + 1])
            pos += 1
        return {"nodes": pos, "runs": runs}


@contextlib.contextmanager
def recording(recorder: RegionRecorder):
    """Install ``recorder`` for the body (the capture of one graph), so
    that :func:`region` notes positions; the previous one is restored."""
    prev = _STATE.recorder
    _STATE.recorder = recorder
    try:
        yield recorder
    finally:
        _STATE.recorder = prev


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
