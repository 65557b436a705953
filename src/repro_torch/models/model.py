"""build_model: the uniform per-family bundle (port of ``repro.models.model``).

    init(seed=, dtype=, device=)             -> params
    init_cache(batch, max_len, dtype, device=) -> decode cache
    decode(params, cache, tokens, ctx)       -> (logits, cache)
    prefill_logits(params, batch, ctx)       -> (B, 1, V) logits
    prefill(params, batch, ctx, max_len)     -> (logits, populated cache)

``batch`` is a dict with ``tokens`` (B, S) and optional ``lengths``
((B,) ragged valid prefixes).  Only the dense family is ported so far.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx, Params

__all__ = ["Model", "build_model", "Ctx"]

# where each family not ported yet stands in ROADMAP.md (queue 1)
_LATER = {
    "vlm": "queue 1 item 4 (dense/vlm: the vlm frontend)",
    "moe": "queue 1 item 9 (MoE)",
    "ssm": "queue 1 item 10 (the SSM, hybrid and encdec families)",
    "hybrid": "queue 1 item 10 (the SSM, hybrid and encdec families)",
    "encdec": "queue 1 item 10 (the SSM, hybrid and encdec families)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]
    init_cache: Callable[..., Params]
    decode: Callable[..., tuple]
    prefill_logits: Callable[..., Any]
    prefill: Callable[..., tuple]


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam == "dense":
        def prefill_logits(params, batch, ctx):
            return transformer.forward(params, batch["tokens"], cfg, ctx,
                                       last_only=True)

        def prefill_fn(params, batch, ctx, max_len):
            return transformer.prefill(params, batch["tokens"], cfg, ctx,
                                       max_len, lengths=batch.get("lengths"))

        return Model(
            cfg=cfg,
            init=functools.partial(transformer.init_params, cfg),
            init_cache=functools.partial(transformer.init_cache, cfg),
            decode=lambda params, cache, tokens, ctx: transformer.decode_step(
                params, cache, tokens, cfg, ctx),
            prefill_logits=prefill_logits,
            prefill=prefill_fn,
        )
    if fam in _LATER:
        raise NotImplementedError(
            f"family {fam!r} is not ported to repro_torch yet; see "
            f"ROADMAP.md {_LATER[fam]}")
    raise ValueError(f"unknown family {fam!r}")
