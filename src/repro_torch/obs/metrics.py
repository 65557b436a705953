"""Latency-sample summaries (own copy of ``repro.obs.metrics``'s helpers)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["percentile", "summarize"]


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) of ``xs``; 0.0 on the empty input."""
    if not len(xs):
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def summarize(xs: Sequence[float]) -> dict[str, float]:
    """{n, mean, p50, p99, max} of a latency sample (zeros when empty)."""
    if not len(xs):
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    arr = np.asarray(xs, np.float64)
    return {
        "n": int(arr.size),
        "mean": float(arr.mean()),
        "p50": float(np.percentile(arr, 50)),
        "p99": float(np.percentile(arr, 99)),
        "max": float(arr.max()),
    }
