from .kernel import flash_attention_fwd
from .ops import flash_attention
from .ref import attention_reference

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd"]
