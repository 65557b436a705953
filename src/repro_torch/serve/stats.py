"""Typed engine statistics: aggregate counters, paged-cache gauges,
per-request latency samples, and derived throughput (port of
``repro.serve.stats`` without the deprecated dict-style access)."""

from __future__ import annotations

import dataclasses
from dataclasses import field

from repro_torch.obs.metrics import summarize

__all__ = ["EngineStats"]

_AGGREGATES = ("prefill_s", "decode_s", "prefill_tokens", "decode_tokens",
               "decode_steps", "dispatches", "admitted", "retired",
               "max_concurrent")


@dataclasses.dataclass
class EngineStats:
    """Serving-engine statistics."""

    num_slots: int = 0

    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0
    dispatches: int = 0
    admitted: int = 0
    retired: int = 0
    max_concurrent: int = 0

    # paged-KV gauges (peak values; they stay 0 when the engine runs the
    # contiguous per-slot cache) and the count of prefill chunks run
    pages_in_use: int = 0
    pages_shared: int = 0
    prefill_chunks: int = 0

    ttft_s: list[float] = field(default_factory=list)
    queue_wait_s: list[float] = field(default_factory=list)
    token_latency_s: list[float] = field(default_factory=list)
    dispatch_occupancy: list[float] = field(default_factory=list)

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-9)

    @property
    def mean_dispatch_occupancy(self) -> float:
        """Mean fraction of slots active per decode dispatch."""
        occ = self.dispatch_occupancy
        return sum(occ) / len(occ) if occ else 0.0

    def latency_summary(self) -> dict[str, dict[str, float]]:
        """{ttft, queue_wait, token_latency} -> {n, mean, p50, p99, max}."""
        return {
            "ttft": summarize(self.ttft_s),
            "queue_wait": summarize(self.queue_wait_s),
            "token_latency": summarize(self.token_latency_s),
        }

    def snapshot(self) -> dict:
        """One JSON-safe dict: aggregates, throughput, occupancy, page
        gauges, latency."""
        out = {k: getattr(self, k) for k in _AGGREGATES}
        out.update({
            "num_slots": self.num_slots,
            "prefill_tok_s": self.prefill_tok_s,
            "decode_tok_s": self.decode_tok_s,
            "mean_dispatch_occupancy": self.mean_dispatch_occupancy,
            "pages_in_use": self.pages_in_use,
            "pages_shared": self.pages_shared,
            "prefill_chunks": self.prefill_chunks,
        })
        out.update(self.latency_summary())
        return out
