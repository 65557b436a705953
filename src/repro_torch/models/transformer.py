"""Dense decoder-only LM with KV-cache decode (port of ``repro.models.transformer``).

A Python loop over layers replaces ``lax.scan``; there is no remat
(serving runs no backward pass).  Parameters are a dict with a list of
per-layer dicts under ``"layers"``; the KV cache keeps the JAX layout,
stacked ``(n_layers, B, max_len, KV, D)`` tensors, and is updated in
place by :func:`decode_step`.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, Params

__all__ = ["init_params", "forward", "init_cache", "prefill", "decode_step"]


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _dense(g: torch.Generator, d_in: int, d_out: int, dtype, device):
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=g)
    return (w * d_in ** -0.5).to(dtype)


def _layer_params(g, cfg: ModelConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def lin(d_in, d_out):
        return {"w": _dense(g, d_in, d_out, dtype, device)}

    attn = {"wq": lin(d, cfg.n_heads * hd), "wk": lin(d, cfg.n_kv_heads * hd),
            "wv": lin(d, cfg.n_kv_heads * hd), "wo": lin(cfg.n_heads * hd, d)}
    mlp = {"wi": lin(d, cfg.d_ff), "wg": lin(d, cfg.d_ff),
           "wo": lin(cfg.d_ff, d)}
    ones = torch.ones((d,), dtype=dtype, device=device)
    return {"attn_norm": {"scale": ones}, "attn": attn,
            "mlp_norm": {"scale": ones.clone()}, "mlp": mlp}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random parameters made from ``seed`` with a ``torch.Generator`` on
    the target device, each tensor drawn in fp32 and stored directly in
    ``dtype`` (no fp32 copy of the model is kept).  The distributions are
    the JAX package's (truncated normal * d_in^-0.5 for weights, normal *
    0.02 for the embedding, ones for norms); the numbers differ, since
    the generators differ."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    emb = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                      device=device)
    emb.normal_(0.0, 1.0, generator=g)
    embed = {"tokens": (emb * 0.02).to(dtype)}
    del emb
    if not cfg.tie_embeddings:
        embed["lm_head"] = _dense(g, cfg.d_model, cfg.vocab_size, dtype,
                                  device)
    return {"embed": embed,
            "layers": [_layer_params(g, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                               device=device)}}


# ----------------------------------------------------------------------
# forward (prefill logits)
# ----------------------------------------------------------------------
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            *, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V), or (B, 1, V) with last_only."""
    x = L.embed(params["embed"], tokens, ctx)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for lp in params["layers"]:
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        x = x + L.attention(lp["attn"], h, cfg, ctx, positions=positions)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.unembed(params["embed"], x, ctx)


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device=None) -> Params:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Ctx) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  The cache's K/V
    tensors are updated in place; the returned dict carries ``pos + 1``."""
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens, ctx)
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        a, _ = L.attention_decode(
            lp["attn"], h, cfg, ctx,
            cache={"k": cache["k"][i], "v": cache["v"][i]}, pos=pos)
        x = x + a
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, ctx)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            max_len: int, *, lengths: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Run the prompt in one pass: last-valid-position logits and a
    populated ``(n_layers, B, max_len, KV, D)`` cache in ``ctx.dtype``.

    ``lengths``: optional (B,) valid prompt lengths for ragged batches;
    attention is masked per sequence, each row's logits come from its
    own last valid position and ``cache["pos"]`` is the (B,) per-row
    write position.  Without ``lengths`` ``pos`` is the scalar S.
    """
    x = L.embed(params["embed"], tokens, ctx)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    hd = cfg.resolved_head_dim
    lens = None if lengths is None else \
        torch.as_tensor(lengths, device=x.device).to(torch.int32)
    # query row 0 sits at position 0; made once, not in every layer's call
    offs = None if lens is None else torch.zeros_like(lens)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, hd)
    ck = torch.zeros(shape, dtype=ctx.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=ctx.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], h, cfg, ctx)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        o = L._gqa_full(q, k, v, causal=True, config=ctx.plan, lengths=lens,
                        q_offset=offs)
        x = x + L.linear(lp["attn"]["wo"],
                         o.reshape(B, S, cfg.n_heads * hd), ctx)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if lens is None:
        x_last = x[:, -1:]
        pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    else:
        x_last = L.gather_last(x, lens)
        pos = lens
    logits = L.unembed(params["embed"], x_last, ctx)
    return logits, {"k": ck, "v": cv, "pos": pos}
