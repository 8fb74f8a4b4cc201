"""Snowflake Arctic-base (480B MoE): 128 experts top-2 + dense residual branch.

[hf:Snowflake/snowflake-arctic-base]. 35L, d_model 7168, 56 heads (GQA kv=8),
expert d_ff 4864, vocab 32000. The dense residual FFN (Arctic's
"dense-MoE hybrid") uses 2*d_model = 14336, bringing the total to ~484B.
At these widths one layer holds 14.27 B parameters with the embeddings
(28.5 GB in bf16), so one 80 GB card serves it at depth 1.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_ff=14336,
    # The reference's training state: bf16 parameters (with int8 moments)
    # to fit 480B on its TPU mesh; serving stores weights in ``dtype``.
    param_dtype="bfloat16",
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=96, moe_dense_ff=128, num_experts=8, experts_per_token=2,
        moe_group_size=64, vocab_size=256, param_dtype="float32", remat="none")
