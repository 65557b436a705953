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

A replay's kernels reach a profiler one by one with no call stack, so
:func:`capture` also maps each device node of the graph to the program's
region that launched it (:func:`repro_torch.obs.region`): at each
region's entry and exit the driver names the last node captured on the
capturing stream (``cuStreamGetCaptureInfo``), and once the body is
captured the graph's chain is walked and each kernel, memcpy and memset
node, in order, gets its innermost region.  The map,
``{"nodes": n, "runs": [[region, first, end], ...]}``, goes into the
capture's record, and the first replay of each graph in a tracing
session emits it as the event ``graphs.regions``.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import heapq
import time
from typing import Callable

import torch

from repro_torch.kernels import launches
from repro_torch.obs import trace

__all__ = ["capture", "replay"]

# CUgraphNodeType values of the nodes that run on the device
_DEVICE_NODES = (0, 1, 2)           # kernel, memcpy, memset
_CAPTURE_ACTIVE = 1                 # CU_STREAM_CAPTURE_STATUS_ACTIVE
# the driver ABI asked for: CUDA 12.3's, whose queries return the edge
# data of programmatic dependencies (paged attention's combine launch),
# which the older ones refuse as a lossy query
_ABI = 12030
_EDGE_DATA = 8                      # sizeof(CUgraphEdgeData)


@functools.cache
def _driver() -> dict:
    """The driver calls the region map needs, at the CUDA 12.3 ABI
    (``cuGetProcAddress``, so a newer driver's renamed entry points do
    not matter), bound with ctypes as the kernels are."""
    get = ctypes.CDLL("libcuda.so.1").cuGetProcAddress_v2
    get.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_int, ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_int)]
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    protos = {
        "cuStreamGetCaptureInfo": [
            vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(vp), ctypes.POINTER(ctypes.POINTER(vp)),
            ctypes.POINTER(vp), ctypes.POINTER(sz)],
        "cuGraphGetNodes": [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)],
        "cuGraphGetEdges": [vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                            vp, ctypes.POINTER(sz)],
        "cuGraphNodeGetType": [vp, ctypes.POINTER(ctypes.c_int)],
    }
    fns = {}
    for name, argtypes in protos.items():
        pfn = ctypes.c_void_p()
        rc = get(name.encode(), ctypes.byref(pfn), _ABI, 0,
                 ctypes.byref(ctypes.c_int()))
        if rc != 0 or not pfn.value:
            raise RuntimeError(f"cuGetProcAddress({name}) failed: {rc}")
        fns[name] = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(pfn.value)
    return fns


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


class _CaptureQuery:
    """The capture running on ``stream``, as the driver sees it: the
    nodes the next captured operation depends on, and, once the body is
    captured, the graph's nodes in order."""

    def __init__(self, stream: int):
        self._fns = _driver()
        self._stream = ctypes.c_void_p(stream)
        self._graph = None

    def dependencies(self) -> tuple:
        status, cid = ctypes.c_int(), ctypes.c_uint64()
        graph = ctypes.c_void_p()
        deps = ctypes.POINTER(ctypes.c_void_p)()
        edges, n = ctypes.c_void_p(), ctypes.c_size_t()
        _check(self._fns["cuStreamGetCaptureInfo"](
            self._stream, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges),
            ctypes.byref(n)), "cuStreamGetCaptureInfo")
        if status.value != _CAPTURE_ACTIVE:
            raise RuntimeError("the stream is not capturing")
        self._graph = graph
        return tuple(deps[i] for i in range(n.value))

    def chain(self) -> list[tuple[int, bool]]:
        """The graph's nodes in dependency order (ties in the driver's
        order of the nodes), each with whether it runs on the device."""
        self.dependencies()
        f, g = self._fns, self._graph
        n = ctypes.c_size_t()
        _check(f["cuGraphGetNodes"](g, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _check(f["cuGraphGetNodes"](g, nodes, ctypes.byref(n)),
               "cuGraphGetNodes")
        e = ctypes.c_size_t()
        _check(f["cuGraphGetEdges"](g, None, None, None, ctypes.byref(e)),
               "cuGraphGetEdges")
        src, dst = (ctypes.c_void_p * e.value)(), (ctypes.c_void_p * e.value)()
        data = (ctypes.c_uint8 * (_EDGE_DATA * e.value))()
        _check(f["cuGraphGetEdges"](g, src, dst, data, ctypes.byref(e)),
               "cuGraphGetEdges")
        order = {h: i for i, h in enumerate(nodes[:n.value])}
        after = {h: [] for h in order}
        need = dict.fromkeys(order, 0)
        for a, b in zip(src[:e.value], dst[:e.value]):
            after[a].append(b)
            need[b] += 1
        ready = [(order[h], h) for h, k in need.items() if k == 0]
        heapq.heapify(ready)
        out = []
        while ready:
            _, h = heapq.heappop(ready)
            kind = ctypes.c_int()
            _check(f["cuGraphNodeGetType"](h, ctypes.byref(kind)),
                   "cuGraphNodeGetType")
            out.append((h, kind.value in _DEVICE_NODES))
            for b in after[h]:
                need[b] -= 1
                if need[b] == 0:
                    heapq.heappush(ready, (order[b], b))
        return out


def capture(body: Callable, device: torch.device, variant: str,
            records: list, *, pool=None) -> tuple:
    """Capture ``body()`` into a CUDA graph -> (graph, its outputs, the
    launches it replays, its record), appending the record ``{"variant",
    "pool_bytes", "capture_s", "nodes", "runs"}`` to ``records``
    (``nodes`` and ``runs``: the map of the graph's device nodes to the
    regions of ``body``, in the module docstring).  The capture runs
    nothing: it advances no state.  ``pool`` is a graph pool handle
    shared with other graphs (None: a private pool)."""
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
            query = _CaptureQuery(torch.cuda.current_stream(device)
                                  .cuda_stream)
            recorder = trace.RegionRecorder(query.dependencies)
            with trace.recording(recorder):
                out = body()
            regions = recorder.runs(query.chain())
    finally:
        if collecting:
            gc.enable()
    counts = launches.since(before)
    launches.add(counts, -1)
    record = {
        "variant": variant,
        "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
        "capture_s": time.perf_counter() - t0, **regions}
    records.append(record)
    return graph, out, counts, record


def replay(captured: tuple):
    """Replay a :func:`capture` -> its outputs, rewritten in place.  The
    first replay of a graph in a tracing session emits its region map
    (``graphs.regions``: ``variant``, ``nodes``, ``runs``); with tracing
    off that costs one call of :func:`repro_torch.obs.first_in_session`."""
    graph, out, counts, record = captured
    graph.replay()
    launches.add(counts)
    if trace.first_in_session(record):
        trace.event("graphs.regions", variant=record["variant"],
                    nodes=record["nodes"], runs=record["runs"])
    return out
