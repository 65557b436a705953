"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, its device events put on the host's ``perf_counter`` clock.

The profiler stamps its events on its own clock; a marker recorded at a
known ``perf_counter`` time gives the offset.  The raw events are read
from the profiler's result list, not through ``prof.events()``, whose
tree building takes minutes over the hundreds of thousands of events a
few seconds of decode launch.
"""

from __future__ import annotations

import time

__all__ = ["DeviceTrace"]

_BEGIN, _END = "perfbench.trace_begin", "perfbench.trace_end"


class DeviceTrace:
    """``start()`` and ``stop()`` the profiler (``t_begin``: when it began
    recording, its own set-up past); afterwards ``events`` holds (name,
    start s, end s) of every device event between the two markers, on
    the ``perf_counter`` clock, and ``window`` the markers' times."""

    def __init__(self):
        self._prof = None
        self.events: list[tuple[str, float, float]] = []
        self.window: tuple[float, float] | None = None

    def _mark(self, name: str) -> int:
        from torch.profiler import record_function
        t = time.perf_counter_ns()
        with record_function(name):
            pass
        return t

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = self._mark(_BEGIN)
        self.t_begin = self._t0 * 1e-9

    @property
    def running(self) -> bool:
        return self._prof is not None and self.window is None

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        t1 = self._mark(_END)
        self._prof.__exit__(None, None, None)
        raw = self._prof.profiler.kineto_results.events()
        marks = {e.name(): e.start_ns() for e in raw
                 if e.name() in (_BEGIN, _END)}
        if _BEGIN not in marks:
            raise RuntimeError("the profiler recorded no begin marker")
        off = marks[_BEGIN] - self._t0
        lo, hi = self._t0 * 1e-9, t1 * 1e-9
        self.window = (lo, hi)
        for e in raw:
            if e.device_type() != DeviceType.CUDA:
                continue
            a = (e.start_ns() - off) * 1e-9
            b = a + e.duration_ns() * 1e-9
            if b > lo and a < hi:
                self.events.append((e.name(), max(a, lo), min(b, hi)))
        self._prof = None
