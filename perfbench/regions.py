"""The program's regions on the device trace: each device event of a traced
decode dispatch labelled with the region of the program that launched it.

The program maps each device node of a CUDA graph to its innermost region
when it captures the graph, and emits the map once a tracing session, at
the graph's first replay, as the event ``graphs.regions`` (``variant``,
``nodes``: the graph's device nodes, ``runs``: ``[region, first, end]``
over their positions); each ``serve.dispatch`` span names the
``variant`` it replayed.  The rule: a traced dispatch's device events are
those between its own copy in (the ``Memcpy HtoD`` that starts nearest
the span's start, within half the span) and the next copy out (a
``Memcpy DtoH``: the host's read of the token tile), in start order.
Where their count equals the map's ``nodes`` they are the graph's nodes
in order, and event i carries the region of position i; a dispatch whose
count differs is not matched, and is left out.  Where the program emits
no map or names no variant, nothing matches, and a reader returns None.

The copies, and not the span's bounds, delimit a dispatch because the
profiler's device clock, put on the host's by one marker
(:mod:`perfbench.devtrace`), drifts from it over a slice (a dispatch's
first kernel started up to 0.16 ms before its span on an H100): by the
span's bounds a dispatch then loses its first events, or gains the next
dispatch's copy in.
"""

from __future__ import annotations

import bisect

from perfbench import readers, roofline

__all__ = ["maps", "dispatches", "matched", "region_seconds",
           "expert_banks"]

_COPY_IN, _COPY_OUT = "Memcpy HtoD", "Memcpy DtoH"


def maps(run) -> dict[str, list]:
    """variant -> the region of each device node of its graph, from the
    run's ``graphs.regions`` events (the last one of a variant)."""
    out = {}
    for r in run.spans:
        if r.get("type") == "event" and r.get("name") == "graphs.regions":
            labels = []
            for name, first, end in r["runs"]:
                labels += [name] * (end - first)
            if len(labels) == r["nodes"]:
                out[r["variant"]] = labels
    return out


def _between_copies(device: list, copies: list, span: dict) -> list | None:
    """The events after the copy in nearest ``span``'s start (``copies``:
    the copies in, as (start, index in ``device``)) up to the next copy
    out, or None where no copy in lies within half the span or no copy
    out follows."""
    t, half = span["t"], span["dur_s"] / 2
    j = bisect.bisect_left(copies, (t,))
    near = [c for c in copies[max(0, j - 1):j + 1] if abs(c[0] - t) <= half]
    if not near:
        return None
    i = min(near, key=lambda c: abs(c[0] - t))[1]
    for k in range(i + 1, len(device)):
        if device[k][0].startswith(_COPY_OUT):
            return device[i + 1:k]
    return None


def dispatches(run) -> list[tuple[dict, list | None]]:
    """Every ``serve.dispatch`` span of the traced slice, each with its
    device events as ``(name, start, end, region)`` in start order where
    they match its graph's map, else None."""
    if run.trace_window is None:
        return []
    sp = readers.spans(run, "serve.dispatch", traced=True)
    device = sorted(run.device, key=lambda e: e[1])
    copies = [(e[1], i) for i, e in enumerate(device)
              if e[0].startswith(_COPY_IN)]
    by_variant = maps(run)
    out = []
    for s in sp:
        labels = by_variant.get(s.get("variant"))
        evs = None if labels is None else \
            _between_copies(device, copies, s)
        if evs is None or len(evs) != len(labels):
            out.append((s, None))
        else:
            out.append((s, [(n, a, b, lab)
                            for (n, a, b), lab in zip(evs, labels)]))
    return out


def matched(run) -> list[tuple[dict, list]]:
    """The traced dispatches whose events matched their graph's map."""
    return [(s, evs) for s, evs in dispatches(run) if evs is not None]


def region_seconds(events, region: str, pattern=None) -> float:
    """Device seconds of the labelled ``events`` in ``region`` (and, with
    ``pattern``, of the kernels it names)."""
    return sum(b - a for n, a, b, r in events
               if r == region and (pattern is None or pattern.search(n)))


def expert_banks(spec, rows: int) -> list:
    """(FLOPs, bytes) of the expert banks' three products in every layer
    at ``rows`` decode tokens: the entries of
    :func:`perfbench.roofline.step_products` past each layer's four
    projections (each bank read whole)."""
    prods = roofline.step_products(spec, rows, prefill=False)[:-1]
    per = len(prods) // spec.n_layers
    return [p for i, p in enumerate(prods) if i % per >= 4]
