"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal.

[arXiv:2308.11596; hf]
Transformer backbone only; the speech frontend is a stub: each request
carries precomputed frame embeddings for the encoder.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=48, encoder_layers=24, decoder_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        mlp_type="mlp", frontend="audio",
        remat="full",
        notes="enc-dec; decode = decoder step with self+cross KV caches",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="encdec",
        n_layers=4, encoder_layers=2, decoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        mlp_type="mlp", frontend="audio",
    )


register("seamless-m4t-large-v2", full, reduced)
