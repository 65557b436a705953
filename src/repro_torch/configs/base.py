"""Model configuration dataclass and the architecture registry.

The port's own copy of ``repro.configs.base`` limited to what the dense
and MoE families read (the JAX module imports jax for its input specs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe (other families: later slices)
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
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters of the dense and MoE families (analytic)."""
        if self.family not in ("dense", "moe"):
            raise ValueError(self.family)
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = self.n_experts * mlp + d * self.n_experts   # + router
        per_layer = qkv + mlp + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = ["gemma_7b", "deepseek_coder_33b", "olmoe_1b_7b",
                 "granite_moe_1b_a400m"]


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
