"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer.

The conv waveform frontend is a stub, as in the reference: a batch carries
precomputed 512-d frame features, which the model projects to d_model.
vocab=504 is the masked-prediction cluster codebook. Bidirectional
attention at hd 80 (1280 / 16); RoPE stands in for the original conv
positional embedding.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    causal=False,
    mlp_gated=False,
    mlp_act="gelu",
    frontend="frame",
    frontend_dim=512,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=64, frontend_dim=32)
