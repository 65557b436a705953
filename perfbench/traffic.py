"""The one traffic generator: a mix's data file in, a seeded schedule of
requests out.

A mix (``traffic/<name>.json``) states the loop and its load (``"closed"``
with ``clients``, or ``"open"`` with ``rate_per_s``), the prompt and
output length distributions (lognormal by median and ``sigma``, clipped
to ``min``..``max``), the sampling settings, the share of greedy
requests (the ones the output check reads), and the engine it is served
with.  Lengths and arrival gaps are drawn as stratified quantiles in
blocks of ``block`` requests: every block holds the same set of sizes
and gaps, and the seed draws each block's order of them, as it draws the
token ids, the sampling seeds and which requests are greedy.  So every
seed offers the same amount of work, in its own order; a smaller block
keeps the load steadier over short spans (at ``block`` 32 the order of
`mistral.long_prompt`'s requests moved its TTFT p95 by about 16% from
seed to seed, against 2-7% between two runs of one seed).
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

__all__ = ["Req", "Traffic", "quantiles"]

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass(frozen=True)
class Req:
    rid: int
    prompt: tuple
    max_new_tokens: int
    temperature: float
    top_p: float
    top_k: int
    seed: int


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` stratified draws of a clipped lognormal, the quantiles at
    (j + 0.5) / n, rounded to whole tokens."""
    z = np.array([_NORMAL.inv_cdf((j + 0.5) / n) for j in range(n)])
    v = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(v, dist["min"], dist["max"]).astype(np.int64)


def _exp_gaps(rate: float, n: int) -> np.ndarray:
    return np.array([-math.log(1.0 - (j + 0.5) / n) / rate
                     for j in range(n)])


class Traffic:
    """The seeded request schedule of one mix."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.block = int(mix["block"])
        self._rng = np.random.default_rng([self.seed, 0])
        self._prompt = quantiles(mix["prompt_len"], self.block)
        self._output = quantiles(mix["output_len"], self.block)
        n_greedy = round(mix["greedy_share"] * self.block)
        self._greedy = np.arange(self.block) < n_greedy
        self._gaps = (_exp_gaps(mix["rate_per_s"], self.block)
                      if mix["loop"] == "open" else None)
        self._order: dict[int, tuple] = {}

    def _block_order(self, b: int) -> tuple:
        """The seed's orders of block ``b``'s prompts, outputs, greedy
        flags and gaps, drawn in block order, so that a block's order does
        not depend on which blocks were asked for first."""
        while len(self._order) <= b:
            self._order[len(self._order)] = tuple(
                self._rng.permutation(self.block) for _ in range(4))
        return self._order[b]

    def request(self, i: int, *, residual: bool = False) -> Req:
        """Request ``i`` of the schedule; ``residual`` draws its output
        length uniformly up to its drawn length (a closed loop's first
        request a client, so that the loop starts in its steady state)."""
        b, j = divmod(int(i), self.block)
        po, oo, go, _ = self._block_order(b)
        rng = np.random.default_rng([self.seed, 1, int(i)])
        prompt = tuple(int(t) for t in
                       rng.integers(0, self.vocab, int(self._prompt[po[j]])))
        n_out = int(self._output[oo[j]])
        seed = int(rng.integers(0, 2 ** 31))
        if residual:
            n_out = int(rng.integers(1, n_out + 1))
        greedy = bool(self._greedy[go[j]])
        s = self.mix["sampling"]
        return Req(rid=int(i), prompt=prompt, max_new_tokens=n_out,
                   temperature=0.0 if greedy else float(s["temperature"]),
                   top_p=1.0 if greedy else float(s["top_p"]),
                   top_k=0 if greedy else int(s.get("top_k", 0)),
                   seed=seed)

    def arrival(self, i: int) -> float:
        """Seconds from the schedule's start to request ``i``'s due time
        (open loop)."""
        b, j = divmod(int(i), self.block)
        gaps = self._gaps[self._block_order(b)[3]]
        return float(b * gaps.sum() + gaps[:j + 1].sum())

    def prompt_range(self) -> tuple[int, int]:
        return int(self._prompt.min()), int(self._prompt.max())
