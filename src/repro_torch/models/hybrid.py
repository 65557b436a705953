"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block
(port of ``repro.models.hybrid``).

The backbone is ``n_layers`` Mamba2 blocks; after every ``attn_every``
of them a single *shared* transformer block (one set of weights, invoked
``n_layers / attn_every`` times) attends over the sequence, taking
concat(hidden, original embedding) through an input projection
(arXiv:2411.15242).  Parameters keep the JAX grouping as lists:
``params["layers"]`` is ``n_groups`` lists of ``attn_every`` layer
dicts, ``params["shared"]`` the block (pre_proj, attn_norm, attn,
mlp_norm, mlp).

On the card every projection runs the zero-stall matmul kernel (the
shared block's on the int8 kernel under W8A8), prefill attention the
flash-attention kernel and paged decode attention the paged-attention
kernel.  The decode cache is the conv and ssm state, stacked ``(n_groups,
attn_every, B, ...)`` in fp32, and the shared block's K/V, stacked
``(n_groups, B, max_len, KV, D)`` (a page pool under a ``page_table``);
all of it is updated in place.  A mamba layer's body runs under
:func:`~repro_torch.models.transformer.remat` when autograd records it
(the shared block does not, as in JAX).
"""

from __future__ import annotations

import torch

from repro_torch import make_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.layers import Ctx, Params
from repro_torch.models.transformer import (_kv_out, _layer_params,
                                            init_embed, init_linear, remat)
from repro_torch.runtime.sharding import unplace, write_layers

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill"]


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError("n_layers must divide by attn_every")
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random parameters made from ``seed`` on the target device with the
    JAX package's distributions (see
    :func:`repro_torch.models.transformer.init_params`)."""
    device = resolve_device(device)
    g = make_generator(device, seed)
    embed = init_embed(g, cfg, dtype, device)
    layers = [[ssm.init_layer(g, cfg, dtype, device)
               for _ in range(cfg.attn_every)]
              for _ in range(_n_groups(cfg))]
    shared = {"pre_proj": init_linear(g, 2 * cfg.d_model, cfg.d_model,
                                      dtype=dtype, device=device),
              **_layer_params(g, cfg, dtype, device)}
    return {"embed": embed, "layers": layers, "shared": shared,
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                               device=device)}}


def _pre(sp: Params, x: torch.Tensor, x0: torch.Tensor, cfg: ModelConfig,
         ctx: Ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared block's input projection of concat(hidden, embedding)
    and its attention pre-norm: (h, normed h)."""
    h = L.linear(sp["pre_proj"], torch.cat([x, x0], dim=-1), ctx)
    return h, L.rms_norm(sp["attn_norm"], h, cfg.norm_eps)


def _post(sp: Params, x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
          ctx: Ctx) -> torch.Tensor:
    """The shared block's MLP sublayer and the residual into the
    backbone."""
    h = h + L.mlp(sp["mlp"], L.rms_norm(sp["mlp_norm"], h, cfg.norm_eps),
                  cfg, ctx)
    return x + h


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx, *, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V), or (B, 1, V) with last_only."""
    x0 = L.embed(params["embed"], tokens, ctx)
    B, S = tokens.shape
    positions = torch.arange(S, device=x0.device)[None, :].expand(B, S)
    sp = params["shared"]

    def mamba_layer(x, lp):
        x = L.shard_act(x, ctx)
        h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
        return x + ssm.mamba_forward(lp["mamba"], h, cfg, ctx)

    body = remat(mamba_layer, cfg, params["layers"])
    x = x0
    for group in params["layers"]:
        for lp in group:
            x = body(x, lp)
        h, hn = _pre(sp, x, x0, cfg, ctx)
        h = h + L.attention(sp["attn"], hn, cfg, ctx, positions=positions)
        x = _post(sp, x, h, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.unembed(params["embed"], x, ctx)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            ctx: Ctx) -> torch.Tensor:
    """The training objective: the cross entropy of the logits against
    ``batch["targets"]``, as the reference."""
    logits = forward(params, batch["tokens"], cfg, ctx)
    return L.cross_entropy(logits, batch["targets"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device=None) -> Params:
    """conv and ssm (n_groups, attn_every, B, ...) in fp32 whatever
    ``dtype``; the shared block's k and v (n_groups, B, max_len, KV, D)
    in ``dtype``."""
    device = resolve_device(device)
    ng = _n_groups(cfg)
    st = ssm.init_ssm_state(cfg, batch, torch.float32, device="meta")
    kv = (ng, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {name: torch.zeros((ng, cfg.attn_every) + tuple(t.shape),
                               dtype=torch.float32, device=device)
             for name, t in st.items()}
    cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            max_len: int, *, lengths: torch.Tensor | None = None,
            cache: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Fused prompt ingestion: a chunked-SSD pass per mamba layer and one
    masked full-sequence attention per shared-block invocation, whose
    K/V are captured into the decode cache.

    With ``lengths`` ((B,) ragged prompts) the SSD steps past each row's
    prefix are exact identities and attention is masked per sequence, so
    the states equal a per-row lock-step decode of the prompt.  The
    prompt is padded to a whole number of SSD chunks (see
    :func:`repro_torch.models.ssm.prefill`); the padding positions' K/V
    are dropped and the cache padded out to ``max_len``.  ``cache``: an
    ``init_cache(B, max_len)`` whose leaves take the result in place of
    fresh ones (the same values), as a serving engine's static buffer.
    """
    B, S0 = tokens.shape
    if S0 > max_len:
        raise ValueError(f"prompt length {S0} exceeds max_len {max_len}")
    lens = ssm._lengths(tokens, lengths)
    # query row 0 sits at position 0; made once, not in every group
    offs = torch.zeros_like(lens)
    x0 = L.embed(params["embed"], ssm._pad_to_chunk(tokens), ctx)
    S = x0.shape[1]
    positions = torch.arange(S, device=x0.device)[None, :].expand(B, S)
    sp = params["shared"]
    hd = cfg.resolved_head_dim
    ng = len(params["layers"])
    ck, cv = _kv_out(cache, (ng, B, max_len, cfg.n_kv_heads, hd), S0,
                     ctx.dtype, x0.device)
    convs, ssms = [], []
    x = x0
    for gi, group in enumerate(params["layers"]):
        for lp in group:
            h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
            y, st = ssm.mamba_prefill(lp["mamba"], h, cfg, ctx, lengths=lens)
            x = x + y
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        h, hn = _pre(sp, x, x0, cfg, ctx)
        q, k, v = L._qkv(sp["attn"], hn, cfg, ctx)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        o = L._gqa_full(q, k, v, causal=True, config=ctx.plan, lengths=lens,
                        q_offset=offs)
        h = h + L.linear(sp["attn"]["wo"],
                         o.reshape(B, S, cfg.n_heads * hd), ctx)
        x = _post(sp, x, h, cfg, ctx)
        # across ranks the batch's own cache takes its K/V whole (the
        # engine installs them into each rank's shards)
        ck[gi, :, :S0] = unplace(k)[:, :S0]
        cv[gi, :, :S0] = unplace(v)[:, :S0]
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], L.gather_last(x, lens), ctx)
    conv, ssm_state = ssm.stack_states(cache, convs, ssms,
                                       (ng, cfg.attn_every))
    return logits, {"conv": conv, "ssm": ssm_state, "k": ck, "v": cv,
                    "pos": ssm._pos(tokens, lengths, lens)}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Ctx) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache), every state leaf
    updated in place.  A ``"page_table"`` leaf pages the shared block's
    K/V (``cache["k"]``/``["v"]`` are then (n_groups, P, ps, KV, D)
    pools); the conv and ssm state are per slot and never paged."""
    pos = cache["pos"]
    page_table = cache.get("page_table")
    x0 = L.embed(params["embed"], tokens, ctx)
    sp = params["shared"]
    x = x0
    for gi, group in enumerate(params["layers"]):
        for li, lp in enumerate(group):
            h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
            y, st = ssm.mamba_decode(lp["mamba"], h, cfg, ctx,
                                     {"conv": cache["conv"][gi, li],
                                      "ssm": cache["ssm"][gi, li]})
            write_layers(cache, st, (gi, li))
            x = x + y
        h, hn = _pre(sp, x, x0, cfg, ctx)
        kv = {"k": cache["k"][gi], "v": cache["v"][gi]}
        if page_table is None:
            a, _ = L.attention_decode(sp["attn"], hn, cfg, ctx, cache=kv,
                                      pos=pos)
        else:
            a, _ = L.attention_decode_paged(sp["attn"], hn, cfg, ctx,
                                            cache=kv, page_table=page_table,
                                            pos=pos)
        x = _post(sp, x, h + a, cfg, ctx)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, ctx)
    out = {"conv": cache["conv"], "ssm": cache["ssm"], "k": cache["k"],
           "v": cache["v"], "pos": pos + 1}
    if page_table is not None:
        out["page_table"] = page_table
    return logits, out
