"""Typed engine statistics: aggregate counters, paged-cache gauges,
per-request latency samples, and derived throughput (port of
``repro.serve.stats``).

:meth:`EngineStats.merge` folds the stats of a fleet's replicas into
one.  Dict-style access (``stats["decode_tokens"]``, ``dict(stats)``)
still works for the original nine keys but emits a
:class:`DeprecationWarning`, as in the JAX package; read the attributes
or :meth:`EngineStats.snapshot`.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import field

from repro_torch.obs.metrics import summarize

__all__ = ["EngineStats"]

# the raw dict's original key set; the deprecation shim serves exactly
# these, so `dict(engine.stats)` round-trips legacy consumers
_LEGACY_KEYS = ("prefill_s", "decode_s", "prefill_tokens", "decode_tokens",
                "decode_steps", "dispatches", "admitted", "retired",
                "max_concurrent")


def _warn_dict_access() -> None:
    warnings.warn(
        "dict-style access to ServeEngine.stats is deprecated; read the "
        "EngineStats attributes or use stats.snapshot()",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class EngineStats:
    """Serving-engine statistics.

    ``replica_id`` tags the stats of one engine behind a
    :class:`repro_torch.serve.Router` (None for a standalone engine or a
    fleet aggregate built by :meth:`merge`).
    """

    num_slots: int = 0
    replica_id: int | None = None

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
    # contiguous per-slot cache) and the count of prefill chunks run;
    # not in _LEGACY_KEYS
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

    @classmethod
    def merge(cls, parts: "list[EngineStats]") -> "EngineStats":
        """Fold per-replica stats into one fleet aggregate: counters, time
        totals and page gauges sum, the sample lists concatenate (so
        ``latency_summary()`` covers every request of the fleet), and
        ``max_concurrent`` sums too (the replicas run side by side).  The
        result's ``replica_id`` is None."""
        out = cls()
        for p in parts:
            out.num_slots += p.num_slots
            for k in _LEGACY_KEYS:
                setattr(out, k, getattr(out, k) + getattr(p, k))
            out.pages_in_use += p.pages_in_use
            out.pages_shared += p.pages_shared
            out.prefill_chunks += p.prefill_chunks
            out.ttft_s.extend(p.ttft_s)
            out.queue_wait_s.extend(p.queue_wait_s)
            out.token_latency_s.extend(p.token_latency_s)
            out.dispatch_occupancy.extend(p.dispatch_occupancy)
        return out

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
        out = {k: getattr(self, k) for k in _LEGACY_KEYS}
        out.update({
            "num_slots": self.num_slots,
            "replica_id": self.replica_id,
            "prefill_tok_s": self.prefill_tok_s,
            "decode_tok_s": self.decode_tok_s,
            "mean_dispatch_occupancy": self.mean_dispatch_occupancy,
            "pages_in_use": self.pages_in_use,
            "pages_shared": self.pages_shared,
            "prefill_chunks": self.prefill_chunks,
        })
        out.update(self.latency_summary())
        return out

    # -- deprecated dict-style access ------------------------------------
    def __getitem__(self, key: str):
        _warn_dict_access()
        if key not in _LEGACY_KEYS:
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value) -> None:
        _warn_dict_access()
        if key not in _LEGACY_KEYS:
            raise KeyError(key)
        setattr(self, key, value)

    def __contains__(self, key) -> bool:
        return key in _LEGACY_KEYS

    def keys(self):
        """The legacy keys; with :meth:`__getitem__` this makes
        ``dict(stats)`` reproduce the original dict."""
        _warn_dict_access()
        return iter(_LEGACY_KEYS)
