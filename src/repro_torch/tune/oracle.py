"""Cost oracles: how the tuner scores a candidate configuration.

The port's counterpart of ``repro.tune.oracle``.  Two backends behind
one protocol (``estimate(c, p) -> seconds``; lower is better):

* :class:`AnalyticOracle`: the default.  Prices a candidate with
  :class:`~repro_torch.core.cyclemodel.HopperPipelineModel`, which
  prices the launch the wrapper would make (tiles, k splits, waves over
  the SMs, the ring's stages).  It costs nothing to evaluate and needs
  no card, so the search is exhaustive; this is what ``Ctx(plan="auto")``
  resolves through, on the CPU as on the card.
* :class:`MeasuredOracle`: the real kernel on the card, timed with CUDA
  events over a CUDA graph of many calls whose operands cycle past the
  L2 cache (``chip_smoke.py`` phase 6's method), so the time is the
  device's and not the host's launch rate.  It needs a CUDA device and
  raises without one; ``device="cpu"`` times the wrappers' plain
  versions on the host instead, and only when the caller names it
  (tests).  It never launches inside a CUDA-graph capture.

Every measurement emits a ``tune.measure`` event through
:mod:`repro_torch.obs`.
"""

from __future__ import annotations

import time
from typing import Protocol

import torch

from repro_torch import obs
from repro_torch.core.cyclemodel import HopperPipelineModel
from repro_torch.tune.space import Candidate, Problem

__all__ = ["CostOracle", "AnalyticOracle", "MeasuredOracle"]

_DTYPES = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}


class CostOracle(Protocol):
    def estimate(self, c: Candidate, p: Problem) -> float:
        """Predicted (or measured) seconds for running `p` with `c`."""
        ...


class AnalyticOracle:
    """:class:`HopperPipelineModel`-backed scoring (no card needed).

    Dtype-aware through ``Problem.dtype_bytes``: the model charges copies
    at the operand width and compute at the type's peak, so an int8
    candidate sees half the bytes a stage of a bf16 one of equal tiles
    carries.  The output is priced at the operand width (bf16 for an int8
    product, as the models ask for).
    """

    def __init__(self, model: HopperPipelineModel | None = None):
        self.model = model or HopperPipelineModel()

    def estimate(self, c: Candidate, p: Problem) -> float:
        return self.model.matmul(
            p.M, p.N, p.K, c.bm, c.bn, c.bk, dtype_bytes=p.dtype_bytes,
            slots=c.slots, groups=p.groups,
            out_bytes=2 if p.dtype_bytes == 1 else p.dtype_bytes,
            name=f"{p.op}_{c.bm}x{c.bn}x{c.bk}s{c.slots}").total_s

    def estimate_attention(self, bq: int, bkv: int, *, s_q: int, s_kv: int,
                           head_dim: int, dtype_bytes: int = 2,
                           batch_heads: int = 1) -> float:
        """Flash attention at tiles ``(bq, bkv)`` (causal, as prefill
        runs it)."""
        return self.model.attention(
            bq, bkv, s_q=s_q, s_kv=s_kv, head_dim=head_dim,
            dtype_bytes=dtype_bytes, batch_heads=batch_heads).total_s


def _refuse_in_capture() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("repro_torch.tune: a measurement was asked for "
                           "inside a CUDA-graph capture; resolve plans "
                           "before capturing")


class MeasuredOracle:
    """Times the real kernel (see the module docstring).

    ``device``: ``None`` or ``"cuda"`` for the card (raises when there is
    none), ``"cpu"`` for the plain versions on the host.  ``calls``
    launches are captured in one graph and the graph replayed
    ``repeats`` times; the best replay's time over ``calls`` is the
    estimate.  Operands are random, made from ``seed`` on the device,
    and enough copies of them that one replay streams past ``l2_bytes``;
    the last problem's operands are kept, so a search over one problem
    makes them once.  Launches the measurement makes are taken back out
    of the wrappers' counters (``kernels/launches.py``): they are not
    launches of a serving path.
    """

    def __init__(self, *, device=None, calls: int = 20, repeats: int = 3,
                 seed: int = 0, l2_bytes: int = 50 * 1024 * 1024):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MeasuredOracle: no CUDA device; pass "
                               "device='cpu' to time the plain versions")
        self.calls = int(calls)
        self.repeats = int(repeats)
        self.seed = int(seed)
        self.l2_bytes = int(l2_bytes)
        self._kept: tuple = (None, None)    # (problem, operand sets)

    # ------------------------------------------------------------------
    def _operands(self, problem, nbytes: int, make) -> list:
        """Copies of one call's operands: enough that a graph of
        ``calls`` launches cycles past L2 (one on the CPU); kept for the
        next call on the same ``problem``."""
        if self._kept[0] == problem:
            return self._kept[1]
        self._kept = (None, None)
        n = 1 if self.device.type == "cpu" else \
            max(1, min(self.calls, -(-2 * self.l2_bytes // max(1, nbytes))))
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        sets = [make(g) for _ in range(n)]
        self._kept = (problem, sets)
        return sets

    def _randn(self, g, shape, dtype):
        return torch.randn(shape, generator=g, device=self.device
                           ).to(dtype)

    def _codes(self, g, shape):
        """Contiguous int8 codes of ``shape``."""
        return torch.randint(-127, 128, shape, generator=g,
                             device=self.device, dtype=torch.int8)

    def _call(self, c: Candidate, p: Problem):
        """One zero-arg call of the problem's kernel a set of operands."""
        from repro_torch.kernels.grouped_matmul import grouped_zero_stall_matmul
        from repro_torch.kernels.quantized_matmul import (
            quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
        from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
        eb, G, M, N, K = p.dtype_bytes, p.groups, p.M, p.N, p.K
        kw = dict(bm=c.bm, bn=c.bn, bk=c.bk, slots=c.slots,
                  variant=c.variant)
        grouped = p.op == "grouped_matmul"
        lead = (G,) if grouped else ()
        nbytes = G * (M * K + K * N) * eb
        if eb == 1:
            def make(g):
                # B (.., K, N) K-major, as QTensor stores its codes
                return (self._codes(g, (*lead, M, K)),
                        self._codes(g, (*lead, N, K)).mT,
                        self._randn(g, (*lead, M, 1), torch.float32).abs(),
                        self._randn(g, (*lead, 1, N), torch.float32).abs())
            if grouped:
                def fn(a, b, sa, sb):
                    return quantized_grouped_zero_stall_matmul(
                        a, b, sa, sb, out_dtype=torch.bfloat16, **kw)
            else:
                def fn(a, b, sa, sb):
                    return quantized_zero_stall_matmul(
                        a, b, sa, sb, out_dtype=torch.bfloat16,
                        grid_order=c.grid_order, **kw)
        else:
            dtype = _DTYPES[eb]

            def make(g):
                return (self._randn(g, (*lead, M, K), dtype),
                        self._randn(g, (*lead, K, N), dtype))
            if grouped:
                def fn(a, b):
                    return grouped_zero_stall_matmul(a, b, **kw)
            else:
                def fn(a, b):
                    return zero_stall_matmul(a, b, grid_order=c.grid_order,
                                             **kw)
        sets = self._operands(p, nbytes, make)
        return [lambda ops=ops: fn(*ops) for ops in sets]

    def _time(self, fns) -> float:
        """Best seconds a call over ``repeats`` timings of ``calls``
        calls cycling through ``fns``."""
        _refuse_in_capture()
        seq = [fns[i % len(fns)] for i in range(self.calls)]
        if self.device.type == "cpu":
            best = float("inf")
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                for f in seq:
                    f()
                best = min(best, time.perf_counter() - t0)
            return best / len(seq)
        from repro_torch.kernels import launches
        before = launches.snapshot()
        for f in fns:            # build, bind and warm every operand set
            f()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for f in seq:
                f()
        # a measurement is not a launch of a path: take its counts back
        # out (the replays below call no wrapper)
        launches.add(launches.since(before), -1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(self.repeats):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        del graph
        return best / len(seq)

    def estimate(self, c: Candidate, p: Problem) -> float:
        secs = self._time(self._call(c, p))
        obs.event("tune.measure", op=p.op, M=p.M, N=p.N, K=p.K,
                  groups=p.groups, dtype_bytes=p.dtype_bytes,
                  config=f"{c.bm}x{c.bn}x{c.bk}/s{c.slots}/{c.grid_order}",
                  device=self.device.type, seconds=secs)
        return secs

    def estimate_attention(self, bq: int, bkv: int, *, s_q: int, s_kv: int,
                           head_dim: int, dtype_bytes: int = 2,
                           batch_heads: int = 1) -> float:
        """Flash attention at tiles ``(bq, bkv)``: ``batch_heads`` heads
        of one sequence, causal, lengths on the card."""
        from repro_torch.kernels.flash_attention import flash_attention
        dtype = _DTYPES[dtype_bytes]
        H, D = batch_heads, head_dim
        nbytes = H * (s_q + 2 * s_kv) * D * dtype_bytes

        def make(g):
            return tuple(self._randn(g, (1, H, s, D), dtype)
                         for s in (s_q, s_kv, s_kv))
        sets = self._operands(("attention", s_q, s_kv, H, D, dtype_bytes),
                              nbytes, make)
        lens = {name: torch.full((1,), n, dtype=torch.int32,
                                 device=self.device)
                for name, n in (("q_lens", s_q), ("kv_lens", s_kv),
                                ("q_offsets", 0))}
        fns = [lambda ops=ops: flash_attention(*ops, bq=bq, bkv=bkv,
                                               causal=True, **lens)
               for ops in sets]
        secs = self._time(fns)
        obs.event("tune.measure", op="attention", M=s_q, N=D, K=s_kv,
                  groups=1, dtype_bytes=dtype_bytes, config=f"{bq}x{bkv}",
                  device=self.device.type, seconds=secs)
        return secs
