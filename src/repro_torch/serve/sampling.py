"""Batched token sampling on the device (port of ``repro.serve.sampling``).

Per-row knobs are ``(B,)`` tensors: ``temperature`` (0 = exact greedy
argmax), ``top_k`` (0 disables; ties at the k-th value are kept) and
``top_p`` (1.0 disables; the argmax is always kept).  Top-k and nucleus
come from ONE descending sort.

Random draws use one ``torch.Generator`` per row (per engine slot),
seeded from ``Request.seed`` or from the engine seed and the rid; a draw
is Gumbel-max over the row's masked, tempered logits.  These are not
the JAX package's threefry bits.  What is kept is the contract: one draw
per emitted token from the request's own generator, so a request's
tokens depend neither on batch composition nor on the block size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["greedy", "sample", "make_generator", "request_seed"]

_NEG = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32 exact argmax (the first maximum, as
    ``jnp.argmax`` takes)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def request_seed(engine_seed: int, rid: int) -> int:
    """The generator seed of a request that brings none of its own."""
    state = np.random.SeedSequence([int(engine_seed), int(rid)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _mask_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Fused per-row top-k + nucleus mask off one descending sort: both
    keep a prefix of the sorted order, so one threshold realises both."""
    V = logits.shape[-1]
    k = torch.where((top_k <= 0) | (top_k >= V), V, top_k)
    srt = torch.sort(logits, dim=-1, descending=True).values
    ranks = torch.arange(V, device=logits.device)[None, :]
    in_k = ranks < k[:, None]
    # nucleus mass is measured on the top-k-truncated distribution
    probs = torch.softmax(torch.where(in_k, srt, _NEG), dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    kept = in_k & (before < top_p[:, None])
    thresh = torch.where(kept, srt, float("inf")).min(dim=-1).values
    return torch.where(logits >= thresh[:, None], logits, _NEG)


def sample(logits: torch.Tensor, generators: Sequence[torch.Generator | None],
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor) -> torch.Tensor:
    """Draw one token per row on the logits' device; (B,) int32.

    ``generators[i]`` is row i's generator, or ``None`` for a row that
    must not draw (a greedy or idle row).  Rows with ``temperature <= 0``
    return the exact argmax."""
    logits = logits.to(torch.float32)
    argmax = greedy(logits)
    t = temperature.to(device=logits.device, dtype=torch.float32)
    scaled = logits / torch.where(t > 0, t, 1.0)[:, None]
    scaled = _mask_top_k_top_p(
        scaled, top_k.to(device=logits.device, dtype=torch.int64),
        top_p.to(device=logits.device, dtype=torch.float32))
    drawn = argmax.clone()
    tiny = torch.finfo(torch.float32).tiny
    for i, g in enumerate(generators):
        if g is None:
            continue
        u = torch.rand(scaled.shape[-1], generator=g, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
        drawn[i] = torch.argmax(scaled[i] + gumbel).to(torch.int32)
    return torch.where(t > 0, drawn, argmax)
