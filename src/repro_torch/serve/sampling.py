"""Batched token sampling on the device (port of ``repro.serve.sampling``).

Per-row knobs are ``(B,)`` tensors: ``temperature`` (0 = exact greedy
argmax), ``top_k`` (0 disables; ties at the k-th value are kept) and
``top_p`` (1.0 disables; the argmax is always kept).  Top-k and nucleus
come from ONE descending sort.

Keys are the JAX package's raw ``(B, 2)`` threefry-2x32 key data, held
on the device as int64 tensors whose values are uint32 (torch has few
uint32 operations, so every sum and shift is masked to 32 bits).  The
bits are ``jax.random``'s with ``jax_threefry_partitionable`` on (the
default of the jax version the tests hold them against): ``PRNGKey``,
``fold_in``, ``split`` and the uniform and Gumbel draws of
``categorical``.  Each :func:`sample` call advances every row's key by
one split, and the engine freezes a finished row's key and token, so a
seeded request samples the tokens it samples in the JAX engine,
whatever the batch composition or the block size.  Everything here is
tensor operations with no host read, so a CUDA graph can hold a
sampled decode block.
"""

from __future__ import annotations

import torch

__all__ = ["greedy", "make_keys", "request_key", "fold_in", "split",
           "uniform_bits", "categorical", "sample"]

_NEG = -1e30
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32 exact argmax (the first maximum, as
    ``jnp.argmax`` takes)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``: int64 tensors (or ints) holding uint32
    values, broadcast against each other.  Returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def request_key(seed: int, device=None) -> torch.Tensor:
    """(2,) key data of ``jax.random.PRNGKey(seed)`` as JAX makes it
    without x64: a zero high word and the seed's low 32 bits."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def make_keys(num_slots: int, device=None) -> torch.Tensor:
    """Zeroed (num_slots, 2) key state (slots are overwritten at
    admission; an empty slot samples garbage that the host never
    reads)."""
    return torch.zeros((num_slots, 2), dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of (..., 2) key data with a uint32."""
    y0, y1 = _threefry2x32(keys[..., 0], keys[..., 1], 0, int(data) & _M32)
    return torch.stack([y0, y1], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of (..., 2) key data -> (..., num, 2); the
    i-th new key hashes the counter pair (0, i)."""
    i = torch.arange(num, device=keys.device)
    y0, y1 = _threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, i)
    return torch.stack([y0, y1], dim=-1)


def uniform_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2) keys -> (B, n) int64 holding the 32 random bits that
    ``jax.random`` draws for an n-element sample of each key: word 0
    xor word 1 of the hash of the counter pair (0, j)."""
    j = torch.arange(n, device=keys.device)[None, :]
    y0, y1 = _threefry2x32(keys[:, 0, None], keys[:, 1, None], 0, j)
    return y0 ^ y1


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in float32 from its
    bits: the top 23 bits become a mantissa of [1, 2), less 1, shifted
    by tiny and clamped to it (a draw of exactly 0 becomes tiny)."""
    tiny = torch.finfo(torch.float32).tiny
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f + tiny).clamp_min(tiny)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` of each row of (B, V) fp32 logits with
    its own key: the argmax of logits plus Gumbel noise -log(-log(u))."""
    u = _uniform(uniform_bits(keys, logits.shape[-1]))
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


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


def sample(logits: torch.Tensor, keys: torch.Tensor,
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw one token per row on the logits' device.

    logits (B, V); keys (B, 2) int64 key data; temperature / top_p (B,)
    float; top_k (B,) int.  Returns ``(new_keys, tokens)`` with tokens
    (B,) int32.  Rows with ``temperature <= 0`` return the exact argmax
    (key-independent); every row's key advances by one split a call (the
    first half of the split; the second draws), as in the JAX package."""
    logits = logits.to(torch.float32)
    argmax = greedy(logits)
    t = temperature.to(device=logits.device, dtype=torch.float32)
    scaled = logits / torch.where(t > 0, t, 1.0)[:, None]
    scaled = _mask_top_k_top_p(
        scaled, top_k.to(device=logits.device, dtype=torch.int64),
        top_p.to(device=logits.device, dtype=torch.float32))
    halves = split(keys)
    drawn = categorical(halves[:, 1], scaled).to(torch.int32)
    return halves[:, 0], torch.where(t > 0, drawn, argmax)
