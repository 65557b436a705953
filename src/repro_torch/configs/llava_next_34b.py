"""llava-next-34b [vlm] — anyres tiling backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
Backbone only; the anyres vision frontend is a stub: each request
carries precomputed patch embeddings (frontend_tokens, d_model).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000,
        mlp_type="swiglu", frontend="patch", frontend_tokens=2880,
        rope_theta=5e6,
        remat="full",
        notes="anyres patch embeds stubbed; 56H pads on 16-way TP (GSPMD)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        mlp_type="swiglu", frontend="patch", frontend_tokens=8,
    )


register("llava-next-34b", full, reduced)
