"""StarCoder2-7B [arXiv:2402.19173]: GQA kv=4, RoPE, plain-GELU 4x FFN."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_gated=False,
    mlp_act="gelu",
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=256, vocab_size=256, remat="none")
