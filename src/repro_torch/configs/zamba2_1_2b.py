"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

38 Mamba2 layers (d_state 64, expand 2, headdim 64 -> 64 SSM heads) with one
weight-shared attention+FFN block applied every 6 layers (6 applications).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    ssm_variant="mamba2",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    shared_attn_every=6,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=256, ssm_state=16,
                          ssm_headdim=16, shared_attn_every=2)
