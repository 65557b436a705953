"""What the per-layer metric readers share: spans of the window, device
events inside them, and the roofline shares of the port's kernels.

A reader returns None where the run holds nothing for it to read (no
span of its kind, no device event of its kernels), never 0.
"""

from __future__ import annotations

import bisect
import re

from perfbench import roofline
from perfbench.spec import percentile

__all__ = ["spans", "device_in", "kernel_seconds", "roofline_share",
           "idle_pct", "median", "ZERO_STALL", "FLASH"]

# the device kernels of the port's zero-stall products (kernels 1 and 5
# share sm90_kernel; the fp32 and ragged shapes run ring_kernel) and of
# its flash attention (bf16 on the tensor cores, fp32 on the CUDA cores)
ZERO_STALL = re.compile(r"\bsm90_kernel<|\bsplitk_reduce<|\bring_kernel<")
FLASH = re.compile(r"\bflash_tc_kernel\b|\bflash_attention_kernel\b")


def spans(run, name: str, *, traced: bool = False) -> list[dict]:
    """The engine's ``name`` spans that lie inside the window, or with
    ``traced`` inside the device trace's slice."""
    lo, hi = run.trace_window if traced else run.window
    return [s for s in run.spans if s.get("type") == "span"
            and s["name"] == name and s["t"] >= lo
            and s["t"] + s["dur_s"] <= hi]


def device_in(run, sp: list[dict]) -> list[tuple]:
    """Device events of the traced slice whose midpoint lies inside one
    of the spans ``sp`` (every span ends at a host read of its results,
    so the device work it launched runs inside it)."""
    iv = sorted((s["t"], s["t"] + s["dur_s"]) for s in sp)
    starts = [a for a, _ in iv]
    out = []
    for ev in run.device:
        mid = (ev[1] + ev[2]) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= iv[i][1]:
            out.append(ev)
    return out


def kernel_seconds(events, pattern: re.Pattern) -> float:
    return sum(b - a for name, a, b in events if pattern.search(name))


def roofline_share(run, span_name: str, pattern: re.Pattern, cost):
    """100 x the least time of the work of the traced slice's
    ``span_name`` spans (``cost(span)``: the (FLOPs, bytes) list of the
    span's calls) over the device time of the kernels ``pattern`` names
    inside them; None where neither a span nor such a kernel was read."""
    if run.trace_window is None:
        return None
    sp = spans(run, span_name, traced=True)
    secs = kernel_seconds(device_in(run, sp), pattern)
    if not sp or secs <= 0:
        return None
    least = sum(roofline.least_time(f, b) for s in sp for f, b in cost(s))
    return 100.0 * least / secs


def idle_pct(run):
    """100 x the share of the traced slice in which no device event ran."""
    if run.trace_window is None or not run.device:
        return None
    lo, hi = run.trace_window
    busy = roofline.busy_union((a, b) for _, a, b in run.device)
    return 100.0 * (1.0 - busy / (hi - lo))


def median(values):
    return percentile(values, 50) if values else None
