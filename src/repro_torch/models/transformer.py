"""Dense decoder-only LM with KV-cache decode (port of ``repro.models.transformer``).

Shared by the dense, vlm and MoE families (vlm prepends a request's
``frontend_embeds``; MoE swaps the MLP through the
``init_mlp_fn`` / ``mlp_fn`` hooks; ``mlp_fn`` has the JAX protocol
``(params, x) -> (y, aux_loss)``).  A Python loop over layers replaces
``lax.scan``; a layer body runs under :func:`remat` (``cfg.remat``, JAX's
``jax.checkpoint`` by ``remat_policy``) when autograd records it, so
training differentiates :func:`loss_fn` and serving runs the plain body.
Parameters are a dict with
a list of per-layer dicts under ``"layers"``; the KV cache keeps the JAX
layout, stacked ``(n_layers, B, max_len, KV, D)`` tensors (int8 codes
and scales with ``init_cache(quantize_kv=True)``), and is updated in
place by :func:`decode_step`.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import make_generator, obs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, Params
from repro_torch.quant.tensor import k_major
from repro_torch.runtime.sharding import unplace

__all__ = ["init_linear", "init_embed", "init_attention", "init_mlp",
           "init_params", "forward", "loss_fn",
           "init_cache", "prefill", "prefill_chunk", "decode_step",
           "remat_policy", "remat", "layer_fwd"]


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
# products without batch dimensions: what JAX's
# ``dots_with_no_batch_dims_saveable`` keeps (a bmm has a batch dim)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(cfg: ModelConfig) -> dict | None:
    """The checkpoint options of ``cfg.remat``, as JAX's policy: None for
    ``"none"`` (the plain body), the full checkpoint for ``"full"``
    (``nothing_saveable``), and for ``"dots"`` a selective checkpoint
    that saves the outputs of ``mm`` / ``addmm`` and recomputes the rest
    (``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {}
    if cfg.remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _records(tree) -> bool:
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(body: Callable, cfg: ModelConfig, params) -> Callable:
    """``body`` under ``remat_policy(cfg)`` when autograd records it
    (grad mode on and some leaf of ``params`` requiring grad), else
    ``body`` itself: serving, the decode graph's capture and the
    meta-device trace of :mod:`repro_torch.plan` run the plain body.  The
    bodies draw no random numbers, so no RNG state is kept for the
    recompute."""
    policy = remat_policy(cfg)
    if policy is None or not torch.is_grad_enabled() or not _records(params):
        return body
    return functools.partial(checkpoint, body, use_reentrant=False,
                             preserve_rng_state=False, **policy)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _dense(g: torch.Generator, d_in: int, d_out: int, dtype, device):
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=g)
    return (w * d_in ** -0.5).to(dtype)


def init_linear(g: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                device=None) -> Params:
    """A linear layer's params: ``w`` (d_in, d_out) drawn as ``_dense``,
    and with ``bias`` a ``b`` (d_out,) of zeros, as JAX's init_linear."""
    p = {"w": _dense(g, d_in, d_out, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_embed(g: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Params:
    """The token table (normal * 0.02, drawn in fp32) and, untied, the LM
    head, as JAX's init_embed.  The head keeps JAX's logical (d, V)
    shape, stored as the transposed view of a contiguous (V, d) buffer,
    the layout :func:`~repro_torch.models.layers.unembed` reads."""
    emb = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                      device=device)
    emb.normal_(0.0, 1.0, generator=g)
    embed = {"tokens": (emb * 0.02).to(dtype)}
    del emb
    if not cfg.tie_embeddings:
        embed["lm_head"] = k_major(_dense(g, cfg.d_model, cfg.vocab_size,
                                          dtype, device))
    return embed


def init_attention(g: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Params:
    """wq, wk, wv (biased with ``cfg.qkv_bias``) and wo, as JAX's
    init_attention."""
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def lin(d_in, d_out, bias=False):
        return init_linear(g, d_in, d_out, bias=bias, dtype=dtype,
                           device=device)

    return {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
            "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wo": lin(cfg.n_heads * hd, d)}


def init_mlp(g: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Params:
    """wi, wg and wo of a gated MLP, or wi and wo of the plain gelu one
    (``mlp_type="mlp"``), as JAX's init_mlp."""
    def lin(d_in, d_out):
        return init_linear(g, d_in, d_out, dtype=dtype, device=device)

    d = cfg.d_model
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi": lin(d, cfg.d_ff), "wg": lin(d, cfg.d_ff),
                "wo": lin(cfg.d_ff, d)}
    return {"wi": lin(d, cfg.d_ff), "wo": lin(cfg.d_ff, d)}


def _layer_params(g, cfg: ModelConfig, dtype, device,
                  init_mlp_fn: Callable | None = None) -> Params:
    attn = init_attention(g, cfg, dtype, device)
    mlp = (init_mlp(g, cfg, dtype, device) if init_mlp_fn is None
           else init_mlp_fn(g))
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return {"attn_norm": {"scale": ones}, "attn": attn,
            "mlp_norm": {"scale": ones.clone()}, "mlp": mlp}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32, device=None,
                init_mlp_fn: Callable | None = None) -> Params:
    """Random parameters made from ``seed`` with a ``torch.Generator`` on
    the target device, each tensor drawn in fp32 and stored directly in
    ``dtype`` (no fp32 copy of the model is kept).  The distributions are
    the JAX package's (truncated normal * d_in^-0.5 for weights, normal *
    0.02 for the embedding, ones for norms); the numbers differ, since
    the generators differ.  ``init_mlp_fn(generator) -> params`` replaces
    each layer's dense MLP (the MoE family's experts)."""
    device = resolve_device(device)
    g = make_generator(device, seed)
    return {"embed": init_embed(g, cfg, dtype, device),
            "layers": [_layer_params(g, cfg, dtype, device, init_mlp_fn)
                       for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                               device=device)}}


# ----------------------------------------------------------------------
# forward (prefill logits)
# ----------------------------------------------------------------------
def _mlp_fn(cfg: ModelConfig, ctx: Ctx,
            mlp_fn: Callable | None) -> Callable:
    """``mlp_fn``, or the dense MLP under the same protocol."""
    return mlp_fn or (lambda p, v: (L.mlp(p, v, cfg, ctx), 0.0))


def _prepend(x: torch.Tensor, frontend_embeds: torch.Tensor | None,
             ctx: Ctx) -> tuple[torch.Tensor, int]:
    """Prepend the (B, P, d) frontend embeddings (vlm), cast to the
    compute dtype, to the token embeddings: (x, P)."""
    if frontend_embeds is None:
        return x, 0
    fe = torch.as_tensor(frontend_embeds, device=x.device).to(ctx.dtype)
    return torch.cat([fe, x], dim=1), fe.shape[1]


def layer_fwd(cfg: ModelConfig, ctx: Ctx, mlp_fn: Callable | None,
              x: torch.Tensor, lp: Params, positions: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block (JAX's ``_layer_fwd``): ``(x, aux)``; ``mlp_fn``
    follows :func:`_mlp_fn`'s protocol, None for the dense MLP."""
    # the residual sequence-sharded, and the Megatron reduce-scatter
    # form at the TP block outputs (L.shard_seq); not around MoE
    # blocks, whose expert dispatch the reference found it fights
    x = L.shard_act(x, ctx)
    h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    x = x + L.shard_seq(
        L.attention(lp["attn"], h, cfg, ctx, positions=positions), ctx)
    h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
    y, aux = _mlp_fn(cfg, ctx, mlp_fn)(lp["mlp"], h)
    if mlp_fn is None:
        y = L.shard_seq(y, ctx)
    # the dense MLP's aux is the number 0.0: filled on the device, since
    # a host-to-device copy cannot be captured in a CUDA graph
    aux = (aux.to(torch.float32) if isinstance(aux, torch.Tensor)
           else torch.full((), aux, dtype=torch.float32, device=x.device))
    return x + y, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            *, frontend_embeds: torch.Tensor | None = None,
            mlp_fn: Callable | None = None, last_only: bool = False,
            return_aux: bool = False):
    """tokens: (B, S) -> logits (B, S, V), or (B, 1, V) with last_only.

    ``frontend_embeds`` (B, P, d) are prepended (vlm) at positions 0..P-1;
    logits are returned for the text positions only.  ``return_aux``
    also returns the mean over layers of ``mlp_fn``'s auxiliary loss
    (MoE load balancing; 0 for the dense MLP), as the reference."""
    x, n_front = _prepend(L.embed(params["embed"], tokens, ctx),
                          frontend_embeds, ctx)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    def layer(x, lp):
        return layer_fwd(cfg, ctx, mlp_fn, x, lp, positions)

    body = remat(layer, cfg, params["layers"])
    auxes = []
    for lp in params["layers"]:
        x, aux = body(x, lp)
        auxes.append(aux)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    x = x[:, n_front:]
    if last_only:
        x = x[:, -1:]
    logits = L.unembed(params["embed"], x, ctx)
    if return_aux:
        return logits, torch.stack(auxes).mean()
    return logits


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, ctx: Ctx, *,
            mlp_fn: Callable | None = None,
            aux_coef: float = 0.01) -> torch.Tensor:
    """The training objective: the next-token cross
    entropy of ``batch["tokens"]`` against ``batch["targets"]`` plus
    ``aux_coef`` x the layers' mean auxiliary loss (MoE), as the
    reference."""
    logits, aux = forward(params, batch["tokens"], cfg, ctx,
                          frontend_embeds=batch.get("frontend_embeds"),
                          mlp_fn=mlp_fn, return_aux=True)
    return L.cross_entropy(logits, batch["targets"]) + aux_coef * aux


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device=None,
               quantize_kv: bool = False) -> Params:
    """The decode cache: K/V (n_layers, B, max_len, KV, D) in ``dtype``,
    or with ``quantize_kv`` int8 K/V codes plus ``k_scale``/``v_scale``
    (n_layers, B, max_len, KV, 1) in ``dtype``, half the bytes of a bf16
    cache (:func:`~repro_torch.models.layers.attention_decode_quantized`
    reads it)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if quantize_kv:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=dtype, device=device),
                "v_scale": torch.zeros(sshape, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Ctx, *, mlp_fn: Callable | None = None
                ) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  The cache's K/V
    tensors are updated in place; the returned dict carries ``pos + 1``.

    A ``"page_table"`` leaf ((B, T) int32) switches every layer to the
    paged pool, ``cache["k"]``/``["v"]`` then being stacked
    ``(n_layers, P, ps, KV, D)`` pools
    (:func:`~repro_torch.models.layers.attention_decode_paged`); the
    table passes through unchanged (the engine rewrites it on admission
    and retirement).  A ``"k_scale"`` leaf (``init_cache(quantize_kv=
    True)``) switches every layer to the int8 cache
    (:func:`~repro_torch.models.layers.attention_decode_quantized`).

    Its regions (:func:`repro_torch.obs.region`): ``model.embed``,
    ``model.norm`` (each layer's two norms) and ``model.head`` (the final
    norm and the head); the residual adds fall to the caller's."""
    pos = cache["pos"]
    page_table = cache.get("page_table")
    quantized = "k_scale" in cache
    leaves = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    with obs.region("model.embed"):
        x = L.embed(params["embed"], tokens, ctx)
    fn = _mlp_fn(cfg, ctx, mlp_fn)
    for i, lp in enumerate(params["layers"]):
        with obs.region("model.norm"):
            h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        layer_cache = {name: cache[name][i] for name in leaves}
        if page_table is not None:
            a, _ = L.attention_decode_paged(lp["attn"], h, cfg, ctx,
                                            cache=layer_cache,
                                            page_table=page_table, pos=pos)
        elif quantized:
            a, _ = L.attention_decode_quantized(lp["attn"], h, cfg, ctx,
                                                cache=layer_cache, pos=pos)
        else:
            a, _ = L.attention_decode(lp["attn"], h, cfg, ctx,
                                      cache=layer_cache, pos=pos)
        x = x + a
        with obs.region("model.norm"):
            h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + fn(lp["mlp"], h)[0]
    with obs.region("model.head"):
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, ctx)
    out = {name: cache[name] for name in leaves}
    out["pos"] = pos + 1
    if page_table is not None:
        out["page_table"] = page_table
    return logits, out


def _kv_out(cache: Params | None, shape: tuple, S: int, dtype: torch.dtype,
            device) -> tuple[torch.Tensor, torch.Tensor]:
    """The K/V a prefill of S positions writes: fresh zeros of ``shape``,
    or ``cache``'s K/V with their rows from S on zeroed."""
    if cache is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    for t in (cache["k"], cache["v"]):
        t[:, :, S:].zero_()
    return cache["k"], cache["v"]


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            max_len: int, *, mlp_fn: Callable | None = None,
            lengths: torch.Tensor | None = None,
            frontend_embeds: torch.Tensor | None = None,
            cache: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Run the prompt in one pass: last-valid-position logits and a
    populated ``(n_layers, B, max_len, KV, D)`` cache in ``ctx.dtype``.

    ``lengths``: optional (B,) valid prompt lengths for ragged batches;
    attention is masked per sequence, each row's logits come from its
    own last valid position and ``cache["pos"]`` is the (B,) per-row
    write position.  Without ``lengths`` ``pos`` is the scalar S.
    ``frontend_embeds`` (B, P, d) are prepended (vlm): their P positions
    take rope positions 0..P-1 and count toward the cache, so the valid
    lengths become ``lengths + P``.  ``cache``: an ``init_cache(B,
    max_len)`` whose K/V take the prompt's in place of fresh zeros (rows
    past the prompt zeroed, so the result is the same), as a serving
    engine's static buffer.
    """
    x, n_front = _prepend(L.embed(params["embed"], tokens, ctx),
                          frontend_embeds, ctx)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    hd = cfg.resolved_head_dim
    lens = None if lengths is None else \
        torch.as_tensor(lengths, device=x.device).to(torch.int32) + n_front
    # query row 0 sits at position 0; made once, not in every layer's call
    offs = None if lens is None else torch.zeros_like(lens)
    ck, cv = _kv_out(cache, (cfg.n_layers, B, max_len, cfg.n_kv_heads, hd),
                     S, ctx.dtype, x.device)
    fn = _mlp_fn(cfg, ctx, mlp_fn)
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
        x = x + fn(lp["mlp"], h)[0]
        # the K/V of a model placed across ranks come whole into the
        # batch's own cache, which the engine installs into its placed one
        ck[i, :, :S] = unplace(k)
        cv[i, :, :S] = unplace(v)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if lens is None:
        x_last = x[:, -1:]
        pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    else:
        x_last = L.gather_last(x, lens)
        pos = lens
    logits = L.unembed(params["embed"], x_last, ctx)
    return logits, {"k": ck, "v": cv, "pos": pos}


def prefill_chunk(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: Ctx, *, cache: Params, offset: int | torch.Tensor,
                  lengths: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """Process one chunk of a long prompt against a KV stripe in place.

    tokens: (B, C), the chunk, zero-padded on the last call; cache: a
    contiguous ``init_cache(B, max_len)`` stripe (the engine pages it
    when the last chunk lands); ``offset``: absolute position of chunk
    row 0, a (1,) or (B,) int32 tensor on the tokens' device, as JAX
    traces it (an int is turned into one); ``lengths``: (B,) absolute
    valid end after this chunk (``<= offset + C``; less only on the
    final, padded chunk).

    Each chunk's K/V are written into the stripe at ``offset`` and its
    queries attend to the whole stripe, ``q_offset`` shifting the causal
    frontier and ``lengths`` masking rows and columns, so chunked
    prefill stays on the flash kernel.  Rows of a padded final chunk
    that would land past ``max_len`` are not written (they are padding:
    ``lengths <= max_len``): the write is masked on the device, so the
    host never reads the offset and a chunk can be captured as a CUDA
    graph.  Returns the logits at ``lengths - 1`` (only meaningful on
    the final chunk) and the stripe with ``pos = lengths``, the contract
    of :func:`prefill`.
    """
    x = L.embed(params["embed"], tokens, ctx)
    B, C, _ = x.shape
    dev = x.device
    lens = torch.as_tensor(lengths, device=dev).to(torch.int32)
    off_b = torch.as_tensor(offset, device=dev).to(torch.int32).reshape(
        -1).expand(B).contiguous()
    positions = off_b[:, None] + torch.arange(C, device=dev)[None, :]
    hd = cfg.resolved_head_dim
    # the write: a window of W stripe rows that always fits, from the
    # offset clamped into the stripe; a row takes chunk row ``src`` where
    # that row exists (offset <= row < offset + C) and keeps its value
    # elsewhere, so rows past max_len are dropped, not clamped onto
    # earlier positions
    T = cache["k"].shape[2]
    W = min(C, T)
    rows = off_b.clamp(0, T - W)[:, None] + torch.arange(W, device=dev)
    src = rows - off_b[:, None]
    keep = ((src >= 0) & (src < C))[..., None, None]
    src = src.clamp(0, C - 1).long()
    rows = rows.long()
    b_idx = torch.arange(B, device=dev)[:, None]

    def write(c: torch.Tensor, new: torch.Tensor) -> None:
        c[b_idx, rows] = torch.where(keep, new[b_idx, src].to(c.dtype),
                                     c[b_idx, rows])

    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], h, cfg, ctx)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        ck, cv = cache["k"][i], cache["v"][i]
        write(ck, k)
        write(cv, v)
        o = L._gqa_full(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                        config=ctx.plan, lengths=lens, q_offset=off_b)
        x = x + L.linear(lp["attn"]["wo"],
                         o.reshape(B, C, cfg.n_heads * hd), ctx)
        h = L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], h, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    x_last = L.gather_last(x, lens - off_b)
    logits = L.unembed(params["embed"], x_last, ctx)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": lens}
