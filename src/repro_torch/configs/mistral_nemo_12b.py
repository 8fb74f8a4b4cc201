"""Mistral-Nemo-Base-2407 (12B dense, 128k ctx) [hf:mistralai].

head_dim is 128 (explicit: 32 heads x 128 = 4096 != d_model 5120).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256, remat="none")
