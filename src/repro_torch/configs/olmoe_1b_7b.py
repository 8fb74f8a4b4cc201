"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts, top-8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=64, num_experts=8, experts_per_token=4, moe_group_size=64,
        vocab_size=256, remat="none")
