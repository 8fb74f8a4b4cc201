from .kernel import flash_attention_bwd, flash_attention_fwd
from .ops import FlashAttention, flash_attention
from .ref import (attention_bwd_reference, attention_lse_reference,
                  attention_reference)

__all__ = ["FlashAttention", "attention_bwd_reference",
           "attention_lse_reference", "attention_reference",
           "flash_attention", "flash_attention_bwd", "flash_attention_fwd"]
