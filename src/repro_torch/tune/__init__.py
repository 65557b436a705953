"""Model-guided kernel autotuning on Hopper (the port of ``repro.tune``).

Closes the loop between the Hopper pipeline model
(:class:`repro_torch.core.HopperPipelineModel`) and the port's CUDA
kernels: every kernel entry point can ask this package for the best
legal configuration of its problem shape instead of the fixed
``KernelConfig()``.

    from repro_torch import tune
    cand = tune.best_config("matmul", M, N, K, dtype=torch.bfloat16)
    # -> Candidate(bm, bn, bk, slots, grid_order)

or, one level up, ``ops.matmul(a, b, config="auto")``, and above that
:func:`repro_torch.plan.trace_model`, which freezes tuned resolutions
into a serializable :class:`repro_torch.plan.Plan`
(``Plan.from_tune_cache`` / ``Plan.seed_tune_cache`` convert both ways).

Pieces (each its own module):

* :mod:`.space`: ``KernelSpace``, the legal (bm, bn, bk, slots,
  grid_order) candidates of the port's kernels, and flash tiles.
* :mod:`.oracle`: ``AnalyticOracle`` (the Hopper model; the default, no
  card needed) and ``MeasuredOracle`` (the kernel on the card, CUDA
  events over a CUDA graph).
* :mod:`.search`: exhaustive and hill-climbing searches.
* :mod:`.cache`: the persistent JSON memo keyed by (op, shape bucket,
  dtype, backend); ``$REPRO_TORCH_TUNE_CACHE`` overrides its location.

The port tunes one backend, its CUDA kernels, named :data:`BACKEND` in
the cache's keys; the analytic search runs the same on the CPU as on
the card, so a plan traced on the CPU holds the card's configurations.
Every call of :func:`best_config` and :func:`best_attention_config`
adds one to the always-on ``tune.calls`` counter of
:mod:`repro_torch.obs`, so a run can show it never consulted the tuner.

A search keeps the default configuration unless its winner is priced at
least ``MIN_GAIN`` (5%) faster: the Hopper model is fitted to within
tens of percent of the card (``tests/test_torch_tune.py``), so a
smaller predicted gain is a tie, and a tie keeps the configuration the
card has run.  The searches themselves are the JAX package's.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.plan.config import dtype_bytes, dtype_name
from repro_torch.tune.cache import TuneCache, default_cache_path, shape_bucket
from repro_torch.tune.oracle import AnalyticOracle, CostOracle, MeasuredOracle
from repro_torch.tune.search import (SearchResult, exhaustive_search,
                                     hill_climb, search)
from repro_torch.tune.space import (DEFAULT_SPACE, SMALL_SPACE, Candidate,
                                    KernelSpace, Problem)

__all__ = [
    "Candidate", "Problem", "KernelSpace", "DEFAULT_SPACE", "SMALL_SPACE",
    "CostOracle", "AnalyticOracle", "MeasuredOracle",
    "SearchResult", "search", "exhaustive_search", "hill_climb",
    "TuneCache", "default_cache_path", "shape_bucket",
    "best_config", "best_attention_config", "autotune",
    "get_cache", "set_cache", "calls", "BACKEND", "MIN_GAIN",
]

#: The backend name of the port's kernels in tune-cache keys.
BACKEND = "cuda"
#: The least predicted gain over the default that a winner must show.
MIN_GAIN = 0.05
_CALLS = "tune.calls"
_CACHE: TuneCache | None = None


def get_cache() -> TuneCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = TuneCache()
    return _CACHE


def set_cache(cache: TuneCache | None) -> None:
    """Swap the process-wide cache (tests point it at a tmp path)."""
    global _CACHE
    _CACHE = cache


def calls() -> int:
    """Calls of :func:`best_config` and :func:`best_attention_config`
    since the last ``obs.reset_counters("tune.")``."""
    return obs.counters(_CALLS).get(_CALLS, 0)


def _refuse_in_capture() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "repro_torch.tune was called inside a CUDA-graph capture: a "
            "plan must resolve every call site before the capture (run the "
            "captured function once eagerly, or trace the plan)")


def autotune(problem: Problem, *, backend: str = BACKEND,
             dtype_name: str = "bfloat16",
             space: KernelSpace | None = None,
             oracle: CostOracle | None = None,
             cache: TuneCache | None = None,
             force: bool = False) -> Candidate:
    """Resolve ``problem`` to its best Candidate, through the cache."""
    space = space or DEFAULT_SPACE
    # an EMPTY cache passed explicitly is falsy (TuneCache defines
    # __len__), so test identity, not truth
    cache = cache if cache is not None else get_cache()
    key = TuneCache.key(problem, backend=backend, dtype=dtype_name)
    if not force:
        hit = cache.get(key)
        if hit is not None and space.feasible(hit, problem):
            return hit
    oracle = oracle or AnalyticOracle(space.model)
    res = search(space, oracle, problem)
    best, best_t = res.best, res.predicted_s
    default = space.default(problem)
    if best != default and space.feasible(default, problem):
        t = oracle.estimate(default, problem)
        if t <= best_t * (1 + MIN_GAIN):
            best, best_t = default, t
    cache.put(key, best, predicted_s=best_t)
    return best


def best_attention_config(s_q: int, s_kv: int, head_dim: int, *,
                          dtype, backend: str = BACKEND,
                          batch_heads: int = 1,
                          space: KernelSpace | None = None,
                          oracle=None, cache: TuneCache | None = None,
                          force: bool = False) -> tuple[int, int]:
    """Tuned ``(bq, bkv)`` for the flash-attention kernel over the legal
    tiles of :meth:`KernelSpace.attention_candidates` (the default
    first, so ties keep it).  The cache stores ``(bq, bkv)`` in a
    Candidate's ``(bm, bn)``, as the JAX package does."""
    obs.counter_inc(_CALLS)
    _refuse_in_capture()
    name = dtype_name(dtype)
    itemsize = dtype_bytes(name)
    space = space or DEFAULT_SPACE
    cache = cache if cache is not None else get_cache()
    problem = Problem(op="attention", M=int(s_q), N=int(head_dim),
                      K=int(s_kv), dtype_bytes=itemsize)
    key = TuneCache.key(problem, backend=backend, dtype=name)
    kw = dict(s_q=int(s_q), s_kv=int(s_kv), head_dim=int(head_dim),
              dtype_bytes=itemsize)
    if not force:
        hit = cache.get(key)
        if hit is not None and space.attention_feasible(hit.bm, hit.bn,
                                                        **kw):
            return hit.bm, hit.bn
    oracle = oracle or AnalyticOracle(space.model)
    scores = {tiles: oracle.estimate_attention(*tiles,
                                               batch_heads=batch_heads, **kw)
              for tiles in space.attention_candidates(**kw)}
    best, best_t = None, float("inf")
    for tiles, t in scores.items():
        if t < best_t:
            best, best_t = tiles, t
    if scores:
        default = next(iter(scores))        # the default comes first
        if scores[default] <= best_t * (1 + MIN_GAIN):
            best, best_t = default, scores[default]
    if best is None:
        raise ValueError(f"no flash-attention tile fits (Sq={s_q}, "
                         f"Skv={s_kv}, D={head_dim}, {name})")
    cache.put(key, Candidate(bm=best[0], bn=best[1], bk=int(head_dim),
                             slots=2, grid_order="ijk"), predicted_s=best_t)
    return best


def best_config(op: str, M: int, N: int, K: int, *, dtype,
                backend: str = BACKEND, groups: int = 1,
                space: KernelSpace | None = None,
                oracle: CostOracle | None = None,
                cache: TuneCache | None = None,
                force: bool = False) -> Candidate:
    """The ``ops`` entry point: shapes + dtype -> Candidate."""
    obs.counter_inc(_CALLS)
    _refuse_in_capture()
    name = dtype_name(dtype)
    problem = Problem(op=op, M=int(M), N=int(N), K=int(K),
                      dtype_bytes=dtype_bytes(name), groups=int(groups))
    return autotune(problem, backend=backend, dtype_name=name,
                    space=space, oracle=oracle, cache=cache, force=force)
