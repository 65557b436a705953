"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        attn_every=6, mlp_type="geglu", tie_embeddings=True,
        remat="full",
        notes="54 mamba2 layers; one shared attn+MLP block invoked every 6",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2,
        attn_every=2, mlp_type="geglu", tie_embeddings=True,
    )


register("zamba2-2.7b", full, reduced)
