"""deepseek-coder-33b [dense] — llama-arch. [arXiv:2401.14196; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=19200, vocab_size=32256,
        mlp_type="swiglu", rope_theta=1e5,
        remat="full",
        notes="56H -> GSPMD pad on 16-way TP",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=256, mlp_type="swiglu",
    )


register("deepseek-coder-33b", full, reduced)
