"""granite-moe-1b-a400m [moe] — 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        n_experts=32, experts_per_token=8,
        mlp_type="swiglu", tie_embeddings=True,
        remat="full",
        notes="EP: 32 experts / 16-way model axis = 2 per device",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=256,
        n_experts=4, experts_per_token=2,
        mlp_type="swiglu", tie_embeddings=True,
    )


register("granite-moe-1b-a400m", full, reduced)
