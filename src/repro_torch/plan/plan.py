"""`Plan`: a serializable OpKey -> KernelConfig execution schedule.

The port's copy of ``repro.plan.plan``.  A Plan is the whole-model
analogue of one KernelConfig: the plan-wide backend and
quantized-execution mode, a default policy for call sites it has no
entry for, and a bucketed ``OpKey -> KernelConfig`` table.  It is what
:func:`repro_torch.plan.trace_model` produces, what
``ServeEngine(plan=...)`` serves under, and what ``Plan.save`` /
``Plan.load`` round-trip through JSON, in the JAX package's schema (a
plan file moves between the two packages; see
:mod:`repro_torch.plan.config`).

Resolution (``Plan.resolve``): an entry hit returns the stored config
verbatim; a miss follows the default policy: ``"auto"`` resolves through
:mod:`repro_torch.tune` (the Hopper model) and memoizes the result into
the table, so the Nth call per shape bucket is a dict lookup and a
traced plan makes **zero** tuner calls at run time; a
:class:`KernelConfig` default applies unconditionally.  A miss inside a
CUDA-graph capture raises (:mod:`repro_torch.tune`): a plan is resolved
ahead of the capture, as the paper's loop nest is programmed ahead of
the loop.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Iterator, Mapping

from repro_torch.plan.config import (_JAX_BACKENDS, BACKENDS, KernelConfig,
                                     OpKey, dtype_name)

__all__ = ["Plan", "as_plan", "config_backend", "resolve"]

_SCHEMA = 1


def _tune_config(op: str, M: int, N: int, K: int, *, dtype,
                 groups: int = 1, batch_heads: int = 1) -> KernelConfig:
    """One tuner resolution -> KernelConfig (lazy tune import)."""
    from repro_torch import tune
    if op == "attention":
        bq, bkv = tune.best_attention_config(
            M, K, N, dtype=dtype, batch_heads=batch_heads)
        return KernelConfig(bq=bq, bkv=bkv)
    cand = tune.best_config(op, M, N, K, dtype=dtype, groups=groups)
    return KernelConfig.from_candidate(cand)


def _tiles_config(tiles, op: str | None = None) -> KernelConfig:
    """(bm, bn, bk) or (bq, bkv) tuple -> KernelConfig.

    With ``op`` given (an ops-level tuple), the arity must match the op:
    a 2-tuple on a matmul (or a triple on attention) is a typo whose
    tiles would otherwise be silently ignored.  Ctx-level tuples
    (op=None, via :func:`as_plan`) accept either arity: a (bm, bn, bk)
    plan leaves attention on its default (bq, bkv).
    """
    vals = tuple(int(t) for t in tiles)
    if op == "attention" and len(vals) != 2:
        raise ValueError(f"attention config tile tuple must be (bq, bkv), "
                         f"got {tiles!r}")
    if op in ("matmul", "grouped_matmul") and len(vals) != 3:
        raise ValueError(f"{op} config tile tuple must be (bm, bn, bk), "
                         f"got {tiles!r}")
    if len(vals) == 3:
        return KernelConfig(bm=vals[0], bn=vals[1], bk=vals[2])
    if len(vals) == 2:
        return KernelConfig(bq=vals[0], bkv=vals[1])
    raise ValueError(
        f"config tile tuple must be (bm, bn, bk) or (bq, bkv), got {tiles!r}")


class Plan:
    """Execution plan: backend + quant mode + default + OpKey table."""

    def __init__(self, *, backend: str = "auto", quant: str | None = None,
                 default: "KernelConfig | str | tuple | None" = "auto",
                 entries: Mapping[OpKey, KernelConfig] | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"Plan.backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if quant not in (None, "int8", "fp8"):
            raise ValueError(f"Plan.quant must be None, 'int8' or 'fp8', "
                             f"got {quant!r}")
        self.backend = backend
        self.quant = quant
        if default is None:
            default = KernelConfig()
        elif isinstance(default, (tuple, list)):
            default = _tiles_config(default)
        if default != "auto" and not isinstance(default, KernelConfig):
            raise ValueError(
                f"Plan.default must be 'auto', a KernelConfig, a tile "
                f"tuple or None, got {default!r}")
        self.default = default
        self.entries: dict[OpKey, KernelConfig] = {
            k.bucketed(): v for k, v in (entries or {}).items()}
        # call-site signature -> config: the hot path's one dict lookup
        self._memo: dict[tuple, KernelConfig] = {}

    # ------------------------------------------------------------------
    def lookup(self, key: OpKey) -> KernelConfig | None:
        return self.entries.get(key.bucketed())

    def add(self, key: OpKey, config: KernelConfig) -> None:
        self.entries[key.bucketed()] = config
        self._memo.clear()

    def resolve(self, op: str, M: int, N: int, K: int, *, dtype,
                groups: int = 1, batch_heads: int = 1) -> KernelConfig:
        """Concrete KernelConfig for one call site (see module doc)."""
        sig = (op, M, N, K, groups, batch_heads, dtype)
        hit = self._memo.get(sig)
        if hit is not None:
            return hit
        key = OpKey(op, int(M), int(N), int(K), groups=int(groups),
                    dtype=dtype_name(dtype)).bucketed()
        cfg = self.entries.get(key)
        if cfg is None:
            if isinstance(self.default, KernelConfig):
                cfg = self.default
            else:
                cfg = _tune_config(op, M, N, K, dtype=dtype, groups=groups,
                                   batch_heads=batch_heads)
                self.entries[key] = cfg   # programmed once, ahead of the loop
        self._memo[sig] = cfg
        return cfg

    def copy(self) -> "Plan":
        return Plan(backend=self.backend, quant=self.quant,
                    default=self.default, entries=dict(self.entries))

    # ------------------------------------------------------------------
    # JSON persistence (the JAX package's schema)
    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        default = (self.default if self.default == "auto"
                   else self.default.to_json())
        return {
            "schema": _SCHEMA,
            "backend": self.backend,
            "quant": self.quant,
            "default": default,
            "entries": {k.to_str(): v.to_json(k.dtype)
                        for k, v in sorted(self.entries.items())},
        }

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        """Read a plan of either package: the JAX package's backend names
        map to the port's (its kernel backends to ``"auto"``, ``"jnp"``
        to ``"torch"``)."""
        if d.get("schema") != _SCHEMA:
            raise ValueError(f"unknown plan schema {d.get('schema')!r}")
        default = d.get("default", "auto")
        if isinstance(default, dict):
            default = KernelConfig.from_json(default)
        backend = d.get("backend", "auto")
        return cls(
            backend=_JAX_BACKENDS.get(backend, backend), quant=d.get("quant"),
            default=default,
            entries={OpKey.from_str(k): KernelConfig.from_json(v)
                     for k, v in d.get("entries", {}).items()})

    def fingerprint(self) -> str:
        """Short content hash of the serialized plan (16 hex chars).

        Two plans fingerprint equal iff their JSON forms match.  An
        ``"auto"`` plan memoizes tuner results into its table, so its
        fingerprint can change as it resolves call sites; fingerprint a
        saved or traced plan when identity must be stable."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def save(self, path: str | os.PathLike) -> None:
        Path(path).write_text(
            json.dumps(self.to_json(), indent=1, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Plan":
        return cls.from_json(json.loads(Path(path).read_text()))

    # ------------------------------------------------------------------
    # TuneCache interop
    # ------------------------------------------------------------------
    @classmethod
    def from_tune_cache(cls, cache=None, *, backend: str | None = None,
                        quant: str | None = None) -> "Plan":
        """Export a tuned cache as a Plan.

        ``backend`` selects the cache entries tuned for that tune backend
        (the port tunes one, ``repro_torch.tune.BACKEND``); with
        ``backend=None`` the cache must hold one backend's entries, or
        this raises (OpKeys carry no backend, so entries of two backends
        at one shape would overwrite each other).  The plan's own backend
        is ``"auto"``: the kernels.
        """
        from repro_torch import tune
        cache = cache if cache is not None else tune.get_cache()
        plan = cls(quant=quant)
        seen_backends: set[str] = set()
        for key_str, cand in cache.items():
            op, (M, N, K), groups, dtype, kbackend = \
                tune.TuneCache.parse_key(key_str)
            if backend is not None and kbackend != backend:
                continue
            seen_backends.add(kbackend)
            if len(seen_backends) > 1:
                raise ValueError(
                    f"Plan.from_tune_cache: cache holds entries for "
                    f"multiple backends {sorted(seen_backends)}; pass "
                    f"backend= to select one")
            key = OpKey(op, M, N, K, groups=groups, dtype=dtype)
            if op == "attention":
                # best_attention_config stores (bq, bkv) in (bm, bn)
                plan.add(key, KernelConfig(bq=cand.bm, bkv=cand.bn))
            else:
                plan.add(key, KernelConfig.from_candidate(cand))
        return plan

    def seed_tune_cache(self, cache=None, *, backend: str | None = None):
        """Pre-seed a :class:`repro_torch.tune.TuneCache` from this plan,
        so ``"auto"`` call sites resolve to the plan's configs without
        searching.  Returns the cache."""
        from repro_torch import tune
        cache = cache if cache is not None else tune.get_cache()
        backend = backend or tune.BACKEND
        items = []
        for key, cfg in self.entries.items():
            problem = tune.Problem(op=key.op, M=key.M, N=key.N, K=key.K,
                                   dtype_bytes=key.dtype_bytes,
                                   groups=key.groups)
            if key.op == "attention":
                cand = tune.Candidate(bm=cfg.bq, bn=cfg.bkv, bk=key.N,
                                      slots=2, grid_order="ijk")
            else:
                cand = tune.Candidate(bm=cfg.bm, bn=cfg.bn,
                                      bk=cfg.resolved_bk(key.dtype),
                                      slots=cfg.resolved_slots,
                                      grid_order=cfg.grid_order)
            items.append((tune.TuneCache.key(problem, backend=backend,
                                             dtype=key.dtype), cand))
        cache.put_many(items)
        return cache

    # ------------------------------------------------------------------
    def items(self) -> Iterator[tuple[OpKey, KernelConfig]]:
        return iter(self.entries.items())

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Plan):
            return NotImplemented
        return (self.backend == other.backend and self.quant == other.quant
                and self.default == other.default
                and self.entries == other.entries)

    def __hash__(self) -> int:
        # ignores the (mutable, memoizing) entry table: stable over the
        # object's lifetime, and equal plans hash equal; keeps Ctx (a
        # frozen dataclass holding a Plan) hashable
        return hash((Plan, self.backend, self.quant,
                     self.default if isinstance(self.default, KernelConfig)
                     else str(self.default)))

    def __repr__(self) -> str:
        default = ("auto" if self.default == "auto"
                   else f"{type(self.default).__name__}(...)")
        return (f"Plan(backend={self.backend!r}, quant={self.quant!r}, "
                f"default={default}, entries={len(self.entries)})")


# ----------------------------------------------------------------------
# the `config` argument vocabulary
# ----------------------------------------------------------------------
def as_plan(config) -> Plan:
    """Normalize the Ctx-level config vocabulary to a Plan.

    ``"auto"`` (and a bare backend name) -> an auto-resolving plan;
    ``None`` -> the fixed default config; a tile tuple / KernelConfig ->
    that config for every op; a Plan passes through unchanged.
    """
    if isinstance(config, Plan):
        return config
    if config is None:
        return Plan(default=None)
    if isinstance(config, str):
        if config in BACKENDS:
            return Plan(backend=config)
        raise ValueError(
            f"Ctx plan string must be one of {BACKENDS} (got {config!r}); "
            f"pass a KernelConfig, Plan, tile tuple or None otherwise")
    if isinstance(config, KernelConfig):
        return Plan(backend=config.backend, quant=config.quant,
                    default=config)
    if isinstance(config, (tuple, list)):
        return Plan(default=_tiles_config(config))
    raise ValueError(
        f"cannot interpret {config!r} as an execution plan; expected a "
        f"Plan, KernelConfig, backend string, tile tuple or None")


def config_backend(config, op: str | None = None) -> str:
    """The backend a ``config`` argument implies.

    Also the vocabulary gate: every ``ops`` call funnels its config
    through here first (passing its ``op``), so a malformed config,
    a wrong-arity tile tuple included, fails loudly even on the
    ``"torch"`` path, which never resolves a schedule."""
    if isinstance(config, (Plan, KernelConfig)):
        return config.backend
    if config is None:
        return "auto"
    if isinstance(config, str):
        if config in BACKENDS:
            return config
    elif isinstance(config, (tuple, list)):
        _tiles_config(config, op)      # arity/type validation only
        return "auto"
    raise ValueError(
        f"config must be a KernelConfig, Plan, a backend name "
        f"{BACKENDS}, a tile tuple or None, got {config!r}")


def resolve(config, *, op: str, M: int, N: int, K: int, dtype,
            groups: int = 1, batch_heads: int = 1) -> KernelConfig:
    """Resolve an ``ops``-level ``config`` argument to a concrete
    KernelConfig for one call site.

    Vocabulary: a :class:`KernelConfig` is used verbatim; a :class:`Plan`
    looks up / memoizes by bucketed OpKey; ``"auto"`` resolves through
    :mod:`repro_torch.tune`; a tile tuple fixes the tiles; ``None`` is
    the fixed default ``KernelConfig()``.
    """
    if isinstance(config, Plan):
        return config.resolve(op, M, N, K, dtype=dtype, groups=groups,
                              batch_heads=batch_heads)
    if isinstance(config, KernelConfig):
        return config
    if config is None:
        return KernelConfig()
    if isinstance(config, (tuple, list)):
        return _tiles_config(config, op)
    if config == "auto":
        return _tune_config(op, M, N, K, dtype=dtype, groups=groups,
                            batch_heads=batch_heads)
    raise ValueError(
        f"ops.{op}: config must be a KernelConfig, Plan, 'auto', a tile "
        f"tuple or None, got {config!r}")
