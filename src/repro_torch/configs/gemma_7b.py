"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        mlp_type="geglu", tie_embeddings=True,
        notes="GeGLU; big tied vocab; MQA variant is the 2b config",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=128, vocab_size=256,
        mlp_type="geglu", tie_embeddings=True,
    )


register("gemma-7b", full, reduced)
