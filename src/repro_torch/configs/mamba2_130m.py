"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True,
        remat="full",
        notes="attention-free; long_500k runs (O(1) state decode)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2,
        tie_embeddings=True,
    )


register("mamba2-130m", full, reduced)
