"""The launch counters of the kernel wrappers, read and added as one.

Each wrapper counts, on itself, the kernel launches it makes
(``.launches`` and, where it has designs, ``.launches_by_design``).  A
CUDA graph replays the launches it captured without calling a wrapper,
and its capture ran none of them.  So whoever captures a graph takes the
capture's counts back out (``add(counts, -1)``) and adds them once a
replay (``add(counts)``): the counters then stay one a launch actually
run.
"""

from __future__ import annotations

__all__ = ["snapshot", "since", "add"]


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_zero_stall_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.quantized_matmul import (
        quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
    from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
    return (zero_stall_matmul, flash_attention, paged_attention,
            quantized_zero_stall_matmul, grouped_zero_stall_matmul,
            quantized_grouped_zero_stall_matmul)


def snapshot() -> dict[str, int]:
    """Every counter: ``{"<wrapper>": n, "<wrapper>.<design>": n}``."""
    out = {}
    for fn in _wrappers():
        out[fn.__name__] = fn.launches
        for design, n in getattr(fn, "launches_by_design", {}).items():
            out[f"{fn.__name__}.{design}"] = n
    return out


def since(before: dict[str, int]) -> dict[str, int]:
    """The counts made since ``before`` (a :func:`snapshot`), nonzero
    ones only."""
    now = snapshot()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def add(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (a :func:`since`) to the counters."""
    fns = {fn.__name__: fn for fn in _wrappers()}
    for key, n in counts.items():
        name, _, design = key.partition(".")
        if design:
            fns[name].launches_by_design[design] += times * n
        else:
            fns[name].launches += times * n
