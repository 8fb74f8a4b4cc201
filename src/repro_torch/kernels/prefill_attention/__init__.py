from .kernel import flash_prefill_fwd
from .ops import paged_prefill_attention
from .ref import paged_prefill_reference

__all__ = ["flash_prefill_fwd", "paged_prefill_attention",
           "paged_prefill_reference"]
