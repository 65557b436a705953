"""Persistent tuning cache: (op, shape-bucket, dtype, backend) → Candidate.

The port's copy of ``repro.tune.cache``, with the same key format
(``op|MxNxK[|gG]|dtype|backend``); the port tunes one backend, the CUDA
kernels, named ``"cuda"`` in its keys.

Tuning is pure function of the problem, so results are memoized to a
JSON file and shared across processes/runs.  Keys bucket the shape
(each dim rounded up to the next power of two) so e.g. a (4096, 11008,
4095) matmul reuses the (4096, 16384, 4096) entry instead of
re-searching per ragged shape — tile choice is insensitive at that
granularity, and padding already makes the kernels shape-agnostic.

Location: ``$REPRO_TORCH_TUNE_CACHE`` if set, else
``~/.cache/repro_torch/tune.json``: a file of the port's own, so that it
never reads the JAX package's (TPU) entries.  Writes are atomic (tmp + rename), loads
are lazy, and a corrupt/unreadable file degrades to an empty cache —
the tuner must never take the serving path down.  ``force=True`` on
:func:`repro_torch.tune.best_config` (or deleting the file) re-tunes.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from repro_torch.plan.config import _next_pow2  # ONE pow-2 bucketing
#                                                 rule: OpKey.bucketed and
#                                                 this cache agree exactly
from repro_torch.tune.space import Candidate, Problem

__all__ = ["TuneCache", "default_cache_path", "shape_bucket"]

_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def default_cache_path() -> Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "tune.json"


def shape_bucket(p: Problem) -> tuple[int, int, int]:
    """Power-of-two shape bucket (what the key is derived from)."""
    return (_next_pow2(p.M), _next_pow2(p.N), _next_pow2(p.K))


class TuneCache:
    """Lazy-loading, atomically-persisted JSON candidate cache."""

    SCHEMA = 1

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._entries: dict[str, dict] | None = None
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------
    @staticmethod
    def key(p: Problem, *, backend: str, dtype: str) -> str:
        bm, bn, bk = shape_bucket(p)
        g = f"|g{_next_pow2(p.groups)}" if p.groups > 1 else ""
        return f"{p.op}|{bm}x{bn}x{bk}{g}|{dtype}|{backend}"

    @staticmethod
    def parse_key(key: str) -> tuple[str, tuple[int, int, int], int,
                                     str, str]:
        """Inverse of :meth:`key`: ``(op, (M, N, K), groups, dtype,
        backend)`` with bucketed dims.  Lives next to ``key`` so the
        string format has exactly one home (``Plan.from_tune_cache``
        consumes this)."""
        op, dims, *rest = key.split("|")
        groups = 1
        if rest and rest[0].startswith("g") and rest[0][1:].isdigit():
            groups = int(rest.pop(0)[1:])
        dtype, backend = rest
        M, N, K = (int(d) for d in dims.split("x"))
        return op, (M, N, K), groups, dtype, backend

    # ------------------------------------------------------------------
    def _load(self) -> dict[str, dict]:
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    def get(self, key: str) -> Candidate | None:
        e = self._load().get(key)
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        return Candidate.from_json(e)

    def put(self, key: str, c: Candidate, *,
            predicted_s: float | None = None) -> None:
        entries = self._load()
        rec = c.to_json()
        if predicted_s is not None:
            rec["predicted_s"] = predicted_s
        entries[key] = rec
        self.save()

    def put_many(self, items) -> None:
        """Insert ``(key, Candidate)`` pairs with ONE disk write.

        ``put`` re-reads and atomically rewrites the whole file per
        call (concurrent-tuner merge); bulk seeding (e.g.
        :meth:`repro_torch.plan.Plan.seed_tune_cache`) would pay that O(N)
        cycle N times."""
        entries = self._load()
        for key, cand in items:
            entries[key] = cand.to_json()
        self.save()

    def _read_disk(self) -> dict[str, dict]:
        """Current on-disk entries (empty on missing/corrupt/old schema)."""
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("schema") == self.SCHEMA:
                return dict(raw.get("entries", {}))
        except (OSError, ValueError):
            pass
        return {}

    def save(self) -> None:
        """Atomic merge-write; failures are swallowed (cache is best-effort).

        The file is re-read and merged immediately before the write:
        concurrent tuners (e.g. several serving processes tuning
        disjoint shapes) each rewrite the whole file, and a plain dump
        of the in-memory dict would be last-writer-wins — dropping
        every entry the other processes added since our lazy load.
        Our own entries take precedence on key collisions (the search
        is deterministic, so collisions carry equal candidates anyway).
        """
        if self._entries is None:
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._entries = {**self._read_disk(), **self._entries}
            payload = json.dumps(
                {"schema": self.SCHEMA, "entries": self._entries},
                indent=1, sort_keys=True)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            pass

    def items(self):
        """Iterate ``(key, Candidate)`` pairs (Plan export interop)."""
        for key, rec in self._load().items():
            yield key, Candidate.from_json(rec)

    def clear(self) -> None:
        self._entries = {}
        try:
            self.path.unlink()
        except OSError:
            pass

    def __len__(self) -> int:
        return len(self._load())
