"""Config system: model and run dataclasses, the shape registry, the
architecture registry.

The port's own copy of ``repro.configs.base`` (which imports jax for its
input specs): ``ModelConfig`` with every field, ``remat`` included,
``RunConfig``, ``ShapeSpec`` / ``SHAPES``, ``token_count`` and
``input_specs``, whose ``meta`` tensors stand in for JAX's
``ShapeDtypeStruct`` inputs of the dry run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

__all__ = ["ModelConfig", "RunConfig", "ShapeSpec", "SHAPES", "register",
           "get_config", "list_configs", "token_count", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"      # swiglu | geglu | mlp (gelu)
    qkv_bias: bool = False
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
    # enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0
    # modality frontend stub: requests carry precomputed embeddings
    frontend: str = ""            # "" | "patch" | "audio"
    frontend_tokens: int = 0      # patch/frame positions prepended to text
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: str = "dots"           # none | dots | full
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

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (SSM and hybrid only)"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (analytic, the JAX package's formulas)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        mlp = gates * d * self.d_ff
        norms = 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            per_layer = qkv + self.n_experts * mlp + d * self.n_experts \
                + norms
        elif self.family == "ssm":
            per_layer = self._mamba_params() + d
        elif self.family == "hybrid":
            # one shared block: attention, MLP, two norms and the
            # (2d, d) input projection of concat(hidden, embedding)
            shared = qkv + mlp + norms + 2 * d * d
            return (self.n_layers * (self._mamba_params() + d) + shared
                    + emb + d)
        elif self.family == "encdec":
            enc = self.encoder_layers * (qkv + mlp + norms)
            dec = self.decoder_layers * (2 * qkv + mlp + 3 * d)
            return enc + dec + emb + 2 * d
        elif self.family in ("dense", "vlm"):
            per_layer = qkv + mlp + norms
        else:
            raise ValueError(self.family)
        return self.n_layers * per_layer + emb + d

    def _mamba_params(self) -> int:
        d, di, n, h = (self.d_model, self.d_inner, self.ssm_state,
                       self.ssm_heads)
        g = self.ssm_groups
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.conv_kernel
        out = di * d + di  # out_proj + gated norm
        return in_proj + conv + out + 3 * h  # A_log, D, dt_bias

    def active_param_count(self) -> int:
        """Active params per token (MoE: the top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        inactive = (self.n_experts - self.experts_per_token) * gates \
            * self.d_model * self.d_ff * self.n_layers
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving hyperparameters."""
    seq_len: int = 1024
    global_batch: int = 8
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    seed: int = 0
    microbatches: int = 1          # >1 enables grad accumulation
    grad_compression: str = "none"  # none | int8 | topk
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 100
    keep_ckpts: int = 3


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def token_count(shape: ShapeSpec) -> int:
    if shape.kind == "decode":
        return shape.global_batch  # one new token per sequence
    return shape.global_batch * shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype: torch.dtype = torch.bfloat16
                ) -> dict[str, torch.Tensor]:
    """``meta`` tensors of JAX's input shapes for every model input (no
    allocation).

    train / prefill: token ids (+ stub frontend embeddings in ``dtype``
    for vlm and encdec; ``targets`` for train only).  decode: one new
    token per sequence (the populated caches are built by the launcher
    from the model).  Token ids are ``torch.int64`` where JAX's are
    ``int32``: int64 is the index dtype the port's data pipeline feeds
    its embedding gather.
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    ids = torch.int64
    specs: dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        s_text = S
        if cfg.family == "encdec":
            # the encoder consumes stub audio frames, the decoder text
            specs["frontend_embeds"] = meta((B, S, cfg.d_model), dtype)
        elif cfg.frontend:
            s_text = S - cfg.frontend_tokens
            specs["frontend_embeds"] = meta(
                (B, cfg.frontend_tokens, cfg.d_model), dtype)
        specs["tokens"] = meta((B, s_text), ids)
        if shape.kind == "train":
            specs["targets"] = meta((B, s_text), ids)
    else:  # decode
        specs["tokens"] = meta((B, 1), ids)
    return specs


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = ["gemma_7b", "deepseek_coder_33b", "olmoe_1b_7b",
                 "granite_moe_1b_a400m", "mamba2_130m", "zamba2_2_7b",
                 "qwen1_5_32b", "mistral_large_123b",
                 "seamless_m4t_large_v2", "llava_next_34b"]


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
