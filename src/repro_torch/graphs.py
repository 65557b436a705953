"""CUDA graphs of static-buffer programs, where the JAX package jits.

A program here is a function of tensors whose addresses do not change
between calls (static buffers: the engine's cache and operands, a train
state and its batch buffers, the oracle's cache and token buffer).  On
the card its first call runs eagerly, which builds the kernels and
resolves a plan's call sites, then :func:`capture` records it once and
every later call is a :func:`replay`.  On the CPU the same body runs
eagerly on the same buffers, and nothing is captured.

A graph replays the launches it captured without calling a kernel
wrapper, and its capture ran none of them: :func:`capture` takes the
capture's launch counts back out and :func:`replay` adds them once a
replay (:mod:`repro_torch.kernels.launches`), so the counters stay one
a launch actually run.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import launches

__all__ = ["capture", "replay"]


def capture(body: Callable, device: torch.device, variant: str,
            records: list, *, pool=None) -> tuple:
    """Capture ``body()`` into a CUDA graph -> (graph, its outputs, the
    launches it replays), appending ``{"variant", "pool_bytes",
    "capture_s"}`` to ``records``.  The capture runs nothing: it advances
    no state.  ``pool`` is a graph pool handle shared with other graphs
    (None: a private pool)."""
    t0 = time.perf_counter()
    # torch.cuda.graph syncs and empties the cache again; done here
    # first, the growth of the reserved bytes is the graph's pool
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = launches.snapshot()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: collecting a dead object
    # that holds graphs would destroy them, a call that invalidates the
    # capture (torch.cuda.graph no longer collects before it begins)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = body()
    finally:
        if collecting:
            gc.enable()
    counts = launches.since(before)
    launches.add(counts, -1)
    records.append({
        "variant": variant,
        "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
        "capture_s": time.perf_counter() - t0})
    return graph, out, counts


def replay(captured: tuple):
    """Replay a :func:`capture` -> its outputs, rewritten in place."""
    graph, out, counts = captured
    graph.replay()
    launches.add(counts)
    return out
