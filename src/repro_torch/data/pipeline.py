"""Deterministic, restartable, host-sharded synthetic-token pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy; the batches are
the JAX package's, bit for bit): a seeded token stream with Zipfian
unigram statistics and local n-gram structure (so the LM loss actually
decreases), sharded by host (data-parallel rank), keyed by (seed, step)
so a restart at step K reproduces exactly the batches a non-failed run
would have seen: checkpoint/restart resumes the *stream*, not a file
offset.  :meth:`SyntheticTokenPipeline.torch_batch` puts a batch on the
device as int64 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticTokenPipeline", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    ngram: int = 3          # tokens depend on the previous `ngram-1` tokens


class SyntheticTokenPipeline:
    """batch(step) -> {"tokens": (B_host, S), "targets": (B_host, S)}."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide by n_hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        # fixed "language": a seeded n-gram transition table
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._unigram = ranks ** (-cfg.zipf_a)
        self._unigram /= self._unigram.sum()
        # hash-based bigram shift gives local structure
        self._mix = rng.integers(1, cfg.vocab_size, size=4)

    def _batch_rng(self, step: int) -> np.random.Generator:
        # key by (seed, step, host): deterministic + restartable
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.host_id)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(step)
        B, S = self.host_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self._unigram)
        base = rng.choice(cfg.vocab_size, size=(B, S), p=self._unigram)
        for t in range(1, S + 1):
            # half the stream follows a deterministic bigram map (learnable
            # structure), half is zipf noise
            follow = rng.random(B) < 0.5
            mapped = (toks[:, t - 1] * self._mix[0] + self._mix[1]) % cfg.vocab_size
            toks[:, t] = np.where(follow, mapped, base[:, t - 1])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def torch_batch(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """:meth:`batch` as int64 tensors on ``device`` (None: the card)."""
        device = resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(device)
                for k, v in self.batch(step).items()}


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int,
                  *, seed: int = 0, n_hosts: int = 1, host_id: int = 0
                  ) -> SyntheticTokenPipeline:
    return SyntheticTokenPipeline(DataConfig(
        vocab_size=vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, n_hosts=n_hosts, host_id=host_id))
