"""build_model: the uniform per-family bundle (port of ``repro.models.model``).

    init(seed=, dtype=, device=)             -> params
    loss(params, batch, ctx)                 -> scalar training loss
    init_cache(batch, max_len, dtype, device=) -> decode cache
    decode(params, cache, tokens, ctx)       -> (logits, cache)
    prefill_logits(params, batch, ctx)       -> (B, 1, V) logits
    prefill(params, batch, ctx, max_len, cache=None)
                                             -> (logits, populated cache)
    prefill_chunk(params, tokens, ctx, *, cache, offset, lengths)
                                             -> (logits, cache), or None
    quantize_weights(params, fmt="int8")     -> params with QTensor weights

``batch`` is a dict with ``tokens`` (B, S), optional ``lengths``
((B,) ragged valid prefixes) and optional ``frontend_embeds`` (the vlm
prefix (B, P, d), or the encdec source frames (B, S_enc, d), which that
family requires); ``loss`` also reads ``targets`` (B, S).
``prefill``'s ``cache``, an ``init_cache(B, max_len, ctx.dtype)``, takes
the populated cache in place of fresh tensors (the same values): a
serving engine's static buffer, which its prefill graphs write.
``loss`` is differentiable: ``repro_torch.launch.train`` takes its
gradients.  The
dense, vlm and MoE ``init_cache`` take ``quantize_kv`` (the int8 cache);
the encdec, SSM and hybrid ones do not, as in the JAX package.  Every
family of the JAX package is ported: dense, vlm, MoE, SSM (mamba2),
hybrid (zamba2) and encdec (seamless).
``quantize_weights`` is one generic walk for every family
(:func:`repro_torch.quant.quantize_tree`); pair it with
``Ctx(plan=KernelConfig(quant="int8"))`` for the W8A8 kernels.
``prefill_chunk`` is None for every family but dense and vlm (whose
engine never chunks a request that carries a frontend), as in the JAX
package: MoE's batch-global routing (the expert capacity depends on
every token of the call) is not chunk-invariant, and no chunked form of
the SSM and hybrid prefill (carrying the conv window and SSD state from
chunk to chunk) is written, in the JAX package or here; an encdec
prompt's every position also depends on the encoded source.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, moe, ssm, transformer
from repro_torch.models.layers import Ctx, Params
from repro_torch.quant.tensor import quantize_tree

__all__ = ["Model", "build_model", "Ctx"]


def _quantize_weights(params: Params, fmt: str = "int8") -> Params:
    """Family-agnostic weight quantization (see :mod:`repro_torch.quant`)."""
    return quantize_tree(params, fmt=fmt)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]
    loss: Callable[..., torch.Tensor]
    init_cache: Callable[..., Params]
    decode: Callable[..., tuple]
    prefill_logits: Callable[..., Any]
    prefill: Callable[..., tuple]
    quantize_weights: Callable[..., Params] = _quantize_weights
    # chunked prefill; None where the prompt state is not chunk-invariant
    prefill_chunk: Callable[..., tuple] | None = None


def _moe_mlp_fn(cfg: ModelConfig, ctx: Ctx, token_mask=None) -> Callable:
    def fn(p, x):
        return moe.moe_mlp(p, x, cfg, ctx, return_aux=True,
                           token_mask=token_mask)
    return fn


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        def loss(params, batch, ctx):
            return transformer.loss_fn(params, batch, cfg, ctx)

        def prefill_logits(params, batch, ctx):
            return transformer.forward(
                params, batch["tokens"], cfg, ctx,
                frontend_embeds=batch.get("frontend_embeds"), last_only=True)

        def prefill_fn(params, batch, ctx, max_len, *, cache=None):
            return transformer.prefill(
                params, batch["tokens"], cfg, ctx, max_len,
                lengths=batch.get("lengths"),
                frontend_embeds=batch.get("frontend_embeds"), cache=cache)

        def prefill_chunk_fn(params, tokens, ctx, *, cache, offset,
                             lengths):
            return transformer.prefill_chunk(params, tokens, cfg, ctx,
                                             cache=cache, offset=offset,
                                             lengths=lengths)

        return Model(
            cfg=cfg,
            init=functools.partial(transformer.init_params, cfg),
            loss=loss,
            init_cache=functools.partial(transformer.init_cache, cfg),
            decode=lambda params, cache, tokens, ctx: transformer.decode_step(
                params, cache, tokens, cfg, ctx),
            prefill_logits=prefill_logits,
            prefill=prefill_fn,
            prefill_chunk=prefill_chunk_fn,
        )
    if fam == "moe":
        def init(*, seed=0, dtype=torch.float32, device=None):
            device = resolve_device(device)
            return transformer.init_params(
                cfg, seed=seed, dtype=dtype, device=device,
                init_mlp_fn=lambda g: moe.init_moe_mlp(g, cfg, dtype,
                                                       device))

        def loss(params, batch, ctx):
            return transformer.loss_fn(params, batch, cfg, ctx,
                                       mlp_fn=_moe_mlp_fn(cfg, ctx))

        def prefill_logits(params, batch, ctx):
            return transformer.forward(params, batch["tokens"], cfg, ctx,
                                       mlp_fn=_moe_mlp_fn(cfg, ctx),
                                       last_only=True)

        def decode(params, cache, tokens, ctx):
            # every slot's token is routed, live or not, as in JAX
            return transformer.decode_step(params, cache, tokens, cfg, ctx,
                                           mlp_fn=_moe_mlp_fn(cfg, ctx))

        def prefill_fn(params, batch, ctx, max_len, *, cache=None):
            tokens, lens = batch["tokens"], batch.get("lengths")
            mask = None
            if lens is not None:
                # padding rows of a ragged batch take no expert capacity
                lens = torch.as_tensor(lens, device=tokens.device)
                mask = (torch.arange(tokens.shape[1], device=tokens.device)
                        [None, :] < lens.to(torch.int32)[:, None])
            return transformer.prefill(params, tokens, cfg, ctx, max_len,
                                       mlp_fn=_moe_mlp_fn(cfg, ctx, mask),
                                       lengths=lens, cache=cache)

        return Model(cfg=cfg, init=init, loss=loss,
                     init_cache=functools.partial(transformer.init_cache, cfg),
                     decode=decode, prefill_logits=prefill_logits,
                     prefill=prefill_fn)
    if fam in ("ssm", "hybrid"):
        mod = ssm if fam == "ssm" else hybrid

        def prefill_logits(params, batch, ctx):
            return mod.forward(params, batch["tokens"], cfg, ctx,
                               last_only=True)

        def prefill_fn(params, batch, ctx, max_len, *, cache=None):
            return mod.prefill(params, batch["tokens"], cfg, ctx, max_len,
                               lengths=batch.get("lengths"), cache=cache)

        return Model(
            cfg=cfg,
            init=functools.partial(mod.init_params, cfg),
            loss=lambda params, batch, ctx: mod.loss_fn(params, batch, cfg,
                                                        ctx),
            init_cache=functools.partial(mod.init_cache, cfg),
            decode=lambda params, cache, tokens, ctx: mod.decode_step(
                params, cache, tokens, cfg, ctx),
            prefill_logits=prefill_logits,
            prefill=prefill_fn,
        )
    if fam == "encdec":
        return Model(
            cfg=cfg,
            init=functools.partial(encdec.init_params, cfg),
            loss=lambda params, batch, ctx: encdec.loss_fn(params, batch, cfg,
                                                           ctx),
            init_cache=functools.partial(encdec.init_cache, cfg),
            decode=lambda params, cache, tokens, ctx: encdec.decode_step(
                params, cache, tokens, cfg, ctx),
            prefill_logits=lambda params, batch, ctx: encdec.forward(
                params, batch["tokens"], batch["frontend_embeds"], cfg, ctx,
                last_only=True),
            prefill=lambda params, batch, ctx, max_len, *, cache=None:
            encdec.prefill(params, batch["tokens"], batch["frontend_embeds"],
                           cfg, ctx, max_len, lengths=batch.get("lengths"),
                           cache=cache),
        )
    raise ValueError(f"unknown family {fam!r}")
