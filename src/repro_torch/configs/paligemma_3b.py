"""PaliGemma-3B [arXiv:2407.07726]: SigLIP patch frontend (stub) + Gemma LM.

MQA (kv=1), head_dim 256, tied embeddings over the 257k vocab. The SigLIP
tower is a stub, as in the reference: a batch may carry 256 precomputed
1152-d patch embeddings, which are linearly projected and put in front of
the text sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_act="gelu",
    tie_embeddings=True,
    frontend="patch",
    frontend_dim=1152,
    frontend_len=256,
    remat="full",
    logit_chunk=640,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
                          head_dim=16, d_ff=128, vocab_size=512,
                          frontend_dim=32, frontend_len=8)
