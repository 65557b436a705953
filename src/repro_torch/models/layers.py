"""Model building blocks (plain functions on tensors).

The port of ``repro.models.layers`` for the dense decoder.  Every
matmul routes through :mod:`repro_torch.kernels.ops`, so the zero-stall
kernel is the compute path on the card.  Params are plain nested dicts
of tensors with the JAX package's names and ``(d_in, d_out)`` weight
layout; the tied embedding table stays ``(vocab, d_model)`` and the LM
head reads it through the kernel's transposed-B layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.plan.config import KernelConfig

__all__ = ["Ctx", "Params", "linear", "rms_norm", "rope", "attention",
           "attention_decode", "mlp", "embed", "unembed", "gather_last"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call execution context.

    ``plan`` is a backend name (``"auto"`` | ``"torch"``), a
    :class:`~repro_torch.plan.KernelConfig` or ``None``;
    it is normalised to a ``KernelConfig`` at construction.  ``dtype``
    is the compute dtype.
    """
    plan: Any = "auto"
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "plan", ops.as_config(self.plan))


def linear(p: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """x: (..., d_in) @ w -> (..., d_out) through the zero-stall engine.

    Parameters built by the port already hold the compute dtype, so the
    cast is a no-op on the serving path (the JAX code casts fp32
    parameters on every call)."""
    w = p["w"].to(ctx.dtype)
    lead = x.shape[:-1]
    y = ops.matmul(x.reshape(-1, x.shape[-1]), w, config=ctx.plan,
                   out_dtype=ctx.dtype)
    return y.reshape(*lead, w.shape[-1])


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x, ctx).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _lengths_mask(S: int, T: int, lengths: torch.Tensor, causal: bool,
                  offsets: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S, T) validity mask for per-sequence valid lengths, in
    absolute positions (query row i == position ``offsets[b] + i``)."""
    dev = lengths.device
    rows = torch.arange(S, device=dev)[:, None]
    if offsets is not None:
        rows = rows[None] + offsets[:, None, None]
    cols = torch.arange(T, device=dev)[None, :]
    m = (rows < lengths[:, None, None]) & (cols < lengths[:, None, None])
    if causal:
        m = m & (rows >= cols)
    return torch.broadcast_to(m, (lengths.shape[0], S, T))


def _gqa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, config: KernelConfig,
              lengths: torch.Tensor | None = None,
              q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,KV,D) -> (B,S,H,D).

    On the ``"auto"`` backend the KV heads are repeated up to H and the
    flash kernel runs in (B, H, S, D) layout with ``lengths`` as both its
    q and kv lengths.  On the ``"torch"`` backend the grouped einsum of
    the JAX package's plain path runs (no head materialisation).
    ``lengths``: optional (B,) valid lengths, rows/cols at >= length
    masked, fully-masked rows zero; ``q_offset``: optional (B,) absolute
    position of query row 0.
    """
    B, S, H, D = q.shape
    KV, T = k.shape[2], k.shape[1]
    rep = H // KV
    if config.backend == "auto":
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        o = ops.attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), config=config,
                          causal=causal, q_lens=lengths, kv_lens=lengths,
                          q_offsets=q_offset)
        return o.transpose(1, 2)
    qg = q.reshape(B, S, KV, rep, D)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32)) * (D ** -0.5)
    if lengths is not None:
        m = _lengths_mask(S, T, lengths, causal, q_offset)
        logits = torch.where(m[:, None, None], logits, NEG_INF)
    elif causal:
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrst,btkd->bskrd", probs.to(v.dtype), v)
    if lengths is not None:
        o = torch.where(m.any(-1)[:, :, None, None, None], o,
                        torch.zeros((), dtype=o.dtype, device=o.device))
    return o.reshape(B, S, H, D)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx, *,
              positions: torch.Tensor,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence causal attention (forward / prefill)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, ctx)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _gqa_full(q, k, v, causal=True, config=ctx.plan, lengths=lengths)
    return linear(p["wo"], o.reshape(B, S, cfg.n_heads * hd), ctx)


def _scatter_at(c: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """c: (B, S, KV, D); new: (B, 1, KV, D); write new at ``pos``.

    Updates ``c`` IN PLACE (the JAX version returns a new array that XLA
    updates in place on the donated cache) and returns it.  ``pos`` is a
    scalar (all rows at one step) or (B,) per-row positions; like the
    dynamic-update-slice it replaces, a position past the end is clamped
    to the last row, which is where a frozen, retired slot's writes land.
    """
    S = c.shape[1]
    pos = torch.as_tensor(pos, device=c.device).to(torch.long).clamp(0, S - 1)
    new = new[:, 0].to(c.dtype)
    if pos.dim() == 0:
        c[:, pos] = new
    else:
        c[torch.arange(c.shape[0], device=c.device), pos] = new
    return c


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                     *, cache: Params, pos: torch.Tensor
                     ) -> tuple[torch.Tensor, Params]:
    """One-token decode against a contiguous KV cache (plain torch, as in
    the reference).  x: (B, 1, d); cache: {"k": (B, S_max, KV, D), "v"};
    pos: (B,) or scalar write index.  The cache is updated in place."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, ctx)
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device), (B,))
    q = rope(q, pos_b[:, None], cfg.rope_theta)
    k = rope(k, pos_b[:, None], cfg.rope_theta)
    ck = _scatter_at(cache["k"], k, pos)
    cv = _scatter_at(cache["v"], v, pos)
    KV = ck.shape[2]
    rep = cfg.n_heads // KV
    qg = q.reshape(B, 1, KV, rep, hd)
    # the score product stays in the cache dtype; only the small logits
    # are upcast for the softmax (as in the reference)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.to(ck.dtype), ck)
    logits = scores.to(torch.float32) * (hd ** -0.5)
    t_idx = torch.arange(ck.shape[1], device=x.device)
    mask = t_idx[None, :] <= pos_b[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrst,btkd->bskrd", probs.to(cv.dtype), cv)
    o = o.reshape(B, 1, cfg.n_heads * hd).to(ctx.dtype)
    return linear(p["wo"], o, ctx), {"k": ck, "v": cv}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    h = linear(p["wi"], x, ctx)
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(p["wg"], x, ctx)) * h
    elif cfg.mlp_type == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p["wg"], x, ctx), approximate="tanh") * h
    else:
        raise ValueError(f"mlp_type {cfg.mlp_type!r} is not ported")
    return linear(p["wo"], h, ctx)


def embed(p: Params, tokens: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return p["tokens"].to(ctx.dtype)[tokens]


def unembed(p: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """(B, S, d) -> (B, S, V) fp32 logits through the zero-stall engine.

    A tied head reads the (V, d) embedding table in place through the
    kernel's transposed-B layout: no (d, V) copy is made per call."""
    B, S, d = x.shape
    if "lm_head" in p:
        w = p["lm_head"].to(ctx.dtype)
        logits = ops.matmul(x.reshape(B * S, d), w, config=ctx.plan,
                            out_dtype=torch.float32)
    else:
        w = p["tokens"].to(ctx.dtype)
        logits = ops.matmul(x.reshape(B * S, d), w, config=ctx.plan,
                            out_dtype=torch.float32, trans_b=True)
    return logits.reshape(B, S, logits.shape[-1])


def gather_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, 1, d): per-row x[b, lengths[b] - 1]."""
    idx = (lengths.to(torch.long) - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]
