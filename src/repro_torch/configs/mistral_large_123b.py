"""mistral-large-123b [dense].

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=28672, vocab_size=32768,
        mlp_type="swiglu", rope_theta=1e6,
        remat="full",
        notes="largest assigned arch; needs FSDP(data)+TP(model) 2D sharding",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=256, mlp_type="swiglu",
    )


register("mistral-large-123b", full, reduced)
