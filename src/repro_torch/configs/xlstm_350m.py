"""xLSTM-350M-class [arXiv:2405.04517]: alternating sLSTM + mLSTM blocks.

24 blocks = 12 (mLSTM, sLSTM) pairs, d_model 1024, 4 heads. Recurrent state
is O(1) in sequence length.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    ssm_variant="xlstm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                          head_dim=16, vocab_size=256)
