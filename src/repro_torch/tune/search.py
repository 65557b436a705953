"""Search strategies: exhaustive for small spaces, hill-climb for large.

The port's copy of ``repro.tune.search``; the searches take any space
with the :class:`~repro_torch.tune.space.KernelSpace` interface
(``candidates``, ``feasible``, ``default``, ``corners``, ``neighbors``).

The spaces here are small enough (a few hundred candidates) that
exhaustive search against the analytic oracle is usually the right
call; hill-climbing exists for the measured oracle, where each probe
costs a real kernel launch.  The climb follows the
``benchmarks/hillclimb.py`` idiom: start from the known-good default,
take the best single-axis move while it improves, restart from a few
scattered seeds so a bad basin does not trap the result.
"""

from __future__ import annotations

import dataclasses

from repro_torch.tune.oracle import CostOracle
from repro_torch.tune.space import Candidate, KernelSpace, Problem

__all__ = ["SearchResult", "search", "exhaustive_search", "hill_climb"]

#: Above this many candidates, `search` switches to hill-climbing.
EXHAUSTIVE_LIMIT = 512


@dataclasses.dataclass(frozen=True)
class SearchResult:
    best: Candidate
    predicted_s: float
    evaluated: int
    method: str                   # "exhaustive" | "hillclimb"


def exhaustive_search(space: KernelSpace, oracle: CostOracle,
                      problem: Problem,
                      candidates: list[Candidate] | None = None
                      ) -> SearchResult:
    if candidates is None:
        candidates = list(space.candidates(problem))
    best, best_t = None, float("inf")
    for c in candidates:
        t = oracle.estimate(c, problem)
        # strict < keeps the first (deterministically ordered) minimum
        if t < best_t:
            best, best_t = c, t
    if best is None:
        raise ValueError(f"no feasible candidate for {problem}")
    return SearchResult(best, best_t, len(candidates), "exhaustive")


def hill_climb(space: KernelSpace, oracle: CostOracle, problem: Problem,
               *, restarts: int = 3, max_steps: int = 64) -> SearchResult:
    """Greedy best-neighbor descent with scattered restarts."""
    seeds = [space.default(problem)]
    # scatter: extreme corners of the tile range make cheap extra seeds
    for c in space.corners(problem):
        if c not in seeds:
            seeds.append(c)
    seeds = seeds[:1 + restarts]

    scores: dict[Candidate, float] = {}

    def score(c: Candidate) -> float:
        if c not in scores:
            scores[c] = oracle.estimate(c, problem)
        return scores[c]

    best, best_t = None, float("inf")
    for seed in seeds:
        cur, cur_t = seed, score(seed)
        for _ in range(max_steps):
            moved = False
            for nb in space.neighbors(cur, problem):
                if not space.feasible(nb, problem):
                    continue
                t = score(nb)
                if t < cur_t:
                    cur, cur_t, moved = nb, t, True
            if not moved:
                break
        if cur_t < best_t:
            best, best_t = cur, cur_t
    if best is None:
        raise ValueError(f"no feasible candidate for {problem}")
    return SearchResult(best, best_t, len(scores), "hillclimb")


def search(space: KernelSpace, oracle: CostOracle, problem: Problem,
           *, exhaustive_limit: int = EXHAUSTIVE_LIMIT) -> SearchResult:
    """Resolve ``problem`` to its best candidate under ``oracle``.

    The single entry point the rest of :mod:`repro_torch.tune` calls
    (``autotune`` wraps it with the persistent cache): enumerates the
    legal space once — dtype-aware, so int8 problems see their larger
    tile space — and picks the strategy by size: exhaustive scoring when
    the space is small enough that every probe is cheap (always true
    for the analytic oracle), hill-climbing with scattered restarts
    when each probe costs a real kernel launch.  Deterministic given
    (space, oracle, problem); ties break toward the first candidate
    in enumeration order.
    """
    candidates = list(space.candidates(problem))   # enumerate once
    if len(candidates) <= exhaustive_limit:
        return exhaustive_search(space, oracle, problem, candidates)
    return hill_climb(space, oracle, problem)
