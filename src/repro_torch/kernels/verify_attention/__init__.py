from .kernel import flash_verify_fwd
from .ops import paged_verify_attention
from .ref import paged_verify_reference

__all__ = ["flash_verify_fwd", "paged_verify_attention",
           "paged_verify_reference"]
