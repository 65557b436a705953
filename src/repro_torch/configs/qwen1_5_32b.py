"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064,
        mlp_type="swiglu", qkv_bias=True, rope_theta=1e6,
        remat="full",
        notes="40H non-divisible by 16-way TP -> GSPMD pad",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, mlp_type="swiglu", qkv_bias=True,
    )


register("qwen1.5-32b", full, reduced)
