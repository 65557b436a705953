"""Model configuration dataclass and the architecture registry.

The port's own copy of ``repro.configs.base`` limited to what the dense,
MoE, SSM and hybrid families read (the JAX module imports jax for its
input specs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid (encdec and
    #                               vlm: a later slice)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"      # swiglu | geglu
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    # hybrid (zamba2-style shared attention)
    attn_every: int = 0           # shared attn block every N mamba layers
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:
            return 0  # attention-free (pure SSM)
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Total parameters of the dense, MoE, SSM and hybrid families
        (analytic, the JAX package's formulas)."""
        if self.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(self.family)
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mamba_layer = self._mamba_params() + d
        if self.family == "ssm":
            return self.n_layers * mamba_layer + emb + d
        if self.family == "hybrid":
            # one shared block: attention, MLP, two norms and the
            # (2d, d) input projection of concat(hidden, embedding)
            shared = qkv + mlp + 2 * d + 2 * d * d
            return self.n_layers * mamba_layer + shared + emb + d
        if self.family == "moe":
            mlp = self.n_experts * mlp + d * self.n_experts   # + router
        per_layer = qkv + mlp + 2 * d
        return self.n_layers * per_layer + emb + d

    def _mamba_params(self) -> int:
        d, di, n, h = (self.d_model, self.d_inner, self.ssm_state,
                       self.ssm_heads)
        g = self.ssm_groups
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.conv_kernel
        out = di * d + di  # out_proj + gated norm
        return in_proj + conv + out + 3 * h  # A_log, D, dt_bias


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = ["gemma_7b", "deepseek_coder_33b", "olmoe_1b_7b",
                 "granite_moe_1b_a400m", "mamba2_130m", "zamba2_2_7b"]


def register(name: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def _ensure_loaded() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
