"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, experts_per_token=8,
        mlp_type="swiglu",
        remat="full",
        notes="EP: 64 experts / 16-way model axis = 4 per device",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=256,
        n_experts=8, experts_per_token=2,
        mlp_type="swiglu",
    )


register("olmoe-1b-7b", full, reduced)
