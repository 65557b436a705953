"""Encoder-decoder backbone (seamless-m4t style; port of ``repro.models.encdec``).

Encoder: bidirectional self-attention over a request's stub frame
embeddings (the speech frontend is replaced by precomputed embeddings).
Decoder: causal self-attention, then cross-attention to the encoder
output, then the MLP.  Decode is one decoder step against a self-K/V
cache plus the cross-attention K/V of the encoded source, computed once
at prefill.  Cross-attention takes no rope and runs through
:func:`~repro_torch.models.layers._gqa_full` non-causal with no
lengths, as in JAX: on the card it is the flash kernel at prefill (the
prompt bucket's queries against ``enc_len`` keys) and at every decode
step (one query row a slot).

Parameters are a dict with lists of per-layer dicts under ``"encoder"``
and ``"decoder"``; the caches keep the JAX layout, stacked
``(decoder_layers, B, ...)`` tensors, updated in place by
:func:`decode_step`.  Encoder and decoder layer bodies run under
:func:`~repro_torch.models.transformer.remat` when autograd records them,
as JAX checkpoints them.
"""

from __future__ import annotations

import torch

from repro_torch import make_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, Params
from repro_torch.models.transformer import (_kv_out, init_attention,
                                            init_embed, init_mlp, remat)
from repro_torch.runtime.sharding import unplace

__all__ = ["init_params", "encode", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step"]


def _norm(cfg: ModelConfig, dtype, device) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random parameters made from ``seed`` on the target device with the
    JAX package's distributions (see
    :func:`repro_torch.models.transformer.init_params`)."""
    device = resolve_device(device)
    g = make_generator(device, seed)
    embed = init_embed(g, cfg, dtype, device)
    enc = [{"attn_norm": _norm(cfg, dtype, device),
            "attn": init_attention(g, cfg, dtype, device),
            "mlp_norm": _norm(cfg, dtype, device),
            "mlp": init_mlp(g, cfg, dtype, device)}
           for _ in range(cfg.encoder_layers)]
    dec = [{"self_norm": _norm(cfg, dtype, device),
            "self_attn": init_attention(g, cfg, dtype, device),
            "cross_norm": _norm(cfg, dtype, device),
            "cross_attn": init_attention(g, cfg, dtype, device),
            "mlp_norm": _norm(cfg, dtype, device),
            "mlp": init_mlp(g, cfg, dtype, device)}
           for _ in range(cfg.decoder_layers)]
    return {"embed": embed, "encoder": enc, "decoder": dec,
            "enc_norm": _norm(cfg, dtype, device),
            "final_norm": _norm(cfg, dtype, device)}


def _cross_attention(p: Params, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor, cfg: ModelConfig,
                     ctx: Ctx) -> torch.Tensor:
    """Cross-attention without rope: q from x, k/v precomputed."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.linear(p["wq"], x, ctx).reshape(B, S, cfg.n_heads, hd)
    o = L._gqa_full(q, enc_k.to(q.dtype), enc_v.to(q.dtype), causal=False,
                    config=ctx.plan)
    return L.linear(p["wo"], o.reshape(B, S, cfg.n_heads * hd), ctx)


def _enc_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = L.linear(p["wk"], enc_out, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    v = L.linear(p["wv"], enc_out, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    return k, v


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: Ctx) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> the encoder output."""
    x = torch.as_tensor(frames).to(ctx.dtype)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)

    def layer(x, lp):
        x = L.shard_act(x, ctx)
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        x = x + L.attention(lp["attn"], h, cfg, ctx, positions=positions,
                            causal=False)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        return x + L.mlp(lp["mlp"], h, cfg, ctx)

    body = remat(layer, cfg, params["encoder"])
    for lp in params["encoder"]:
        x = body(x, lp)
    return L.rms_norm(params["enc_norm"], x, cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, ctx: Ctx, *,
            last_only: bool = False) -> torch.Tensor:
    """Teacher-forced decode over the whole target sequence: tokens
    (B, S) and frames (B, S_enc, d) -> logits (B, S, V), or (B, 1, V)
    with ``last_only``."""
    enc_out = encode(params, frames, cfg, ctx)
    x = L.embed(params["embed"], tokens, ctx)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)

    def layer(x, lp, enc_out):
        x = L.shard_act(x, ctx)
        h = L.rms_norm(lp["self_norm"], x, cfg.norm_eps)
        x = x + L.attention(lp["self_attn"], h, cfg, ctx,
                            positions=positions, causal=True)
        h = L.rms_norm(lp["cross_norm"], x, cfg.norm_eps)
        ek, ev = _enc_kv(lp["cross_attn"], enc_out, cfg, ctx)
        x = x + _cross_attention(lp["cross_attn"], h, ek, ev, cfg, ctx)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        return x + L.mlp(lp["mlp"], h, cfg, ctx)

    body = remat(layer, cfg, params["decoder"])
    for lp in params["decoder"]:
        x = body(x, lp, enc_out)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.unembed(params["embed"], x, ctx)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            ctx: Ctx) -> torch.Tensor:
    """The training objective: the cross entropy of the logits against
    ``batch["targets"]``, as the reference."""
    logits = forward(params, batch["tokens"], batch["frontend_embeds"],
                     cfg, ctx)
    return L.cross_entropy(logits, batch["targets"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               enc_len: int | None = None, device=None) -> Params:
    """Self-attention K/V ``(decoder_layers, batch, max_len, KV, D)`` and
    cross-attention K/V ``(decoder_layers, batch, enc_len, KV, D)``;
    ``enc_len`` defaults to ``max_len``, as in JAX (a serving engine
    shares one encoder length across its requests)."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    Ld = cfg.decoder_layers
    enc_len = enc_len or max_len

    def zeros(n):
        return torch.zeros((Ld, batch, n, cfg.n_kv_heads, hd), dtype=dtype,
                           device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(enc_len), "cross_v": zeros(enc_len),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, ctx: Ctx, max_len: int, *,
            lengths: torch.Tensor | None = None,
            cache: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Encode the source once, run the decoder prompt in one masked causal
    pass, and return the last-valid-position logits and a decode cache
    with the self- and cross-attention K/V populated (in ``ctx.dtype``).

    The cross-attention cache's length is ``frames.shape[1]``: serving,
    every request of an engine shares it (``init_cache(enc_len=...)``).
    ``lengths`` as in :func:`repro_torch.models.transformer.prefill`;
    the self-attention masks with them (the full S without), the
    cross-attention sees every frame from every query row.  ``cache``: an
    ``init_cache(B, max_len, enc_len=S_enc)`` whose leaves take the
    result in place of fresh ones (the same values), as a serving
    engine's static buffer.
    """
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    dev = tokens.device
    lens = (torch.full((B,), S, dtype=torch.int32, device=dev)
            if lengths is None else
            torch.as_tensor(lengths, device=dev).to(torch.int32))
    enc_out = encode(params, torch.as_tensor(frames, device=dev), cfg, ctx)
    S_enc = enc_out.shape[1]
    positions = _positions(B, S, dev)
    hd = cfg.resolved_head_dim
    Ld, KV = cfg.decoder_layers, cfg.n_kv_heads
    ck, cv = _kv_out(cache, (Ld, B, max_len, KV, hd), S, ctx.dtype, dev)
    if cache is None:
        xk = torch.empty((Ld, B, S_enc, KV, hd), dtype=ctx.dtype, device=dev)
        xv = torch.empty_like(xk)
    else:
        xk, xv = cache["cross_k"], cache["cross_v"]
    x = L.embed(params["embed"], tokens, ctx)
    for i, lp in enumerate(params["decoder"]):
        h = L.rms_norm(lp["self_norm"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["self_attn"], h, cfg, ctx)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        o = L._gqa_full(q, k, v, causal=True, config=ctx.plan, lengths=lens)
        x = x + L.linear(lp["self_attn"]["wo"],
                         o.reshape(B, S, cfg.n_heads * hd), ctx)
        h = L.rms_norm(lp["cross_norm"], x, cfg.norm_eps)
        ek, ev = _enc_kv(lp["cross_attn"], enc_out, cfg, ctx)
        x = x + _cross_attention(lp["cross_attn"], h, ek, ev, cfg, ctx)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
        # across ranks the batch's own cache takes its K/V whole (the
        # engine installs them into each rank's shards)
        ck[i, :, :S] = unplace(k)
        cv[i, :, :S] = unplace(v)
        xk[i] = unplace(ek)
        xv[i] = unplace(ev)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], L.gather_last(x, lens), ctx)
    pos = (torch.tensor(S, dtype=torch.int32, device=dev) if lengths is None
           else lens)
    return logits, {"k": ck, "v": cv, "cross_k": xk, "cross_v": xv,
                    "pos": pos}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Ctx) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache); the self K/V are
    updated in place.  A ``"page_table"`` leaf pages the decoder's
    self-attention K/V only; the cross-attention K/V stay per slot (their
    length is the fixed encoder extent, not the growing position)."""
    pos = cache["pos"]
    page_table = cache.get("page_table")
    x = L.embed(params["embed"], tokens, ctx)
    for i, lp in enumerate(params["decoder"]):
        h = L.rms_norm(lp["self_norm"], x, cfg.norm_eps)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        if page_table is None:
            a, _ = L.attention_decode(lp["self_attn"], h, cfg, ctx,
                                      cache=layer_cache, pos=pos)
        else:
            a, _ = L.attention_decode_paged(lp["self_attn"], h, cfg, ctx,
                                            cache=layer_cache,
                                            page_table=page_table, pos=pos)
        x = x + a
        h = L.rms_norm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + _cross_attention(lp["cross_attn"], h, cache["cross_k"][i],
                                 cache["cross_v"][i], cfg, ctx)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, ctx)
    out = {"k": cache["k"], "v": cache["v"], "cross_k": cache["cross_k"],
           "cross_v": cache["cross_v"], "pos": pos + 1}
    if page_table is not None:
        out["page_table"] = page_table
    return logits, out
