from .kernel import flash_decode_fwd
from .ops import default_num_splits, paged_decode_attention
from .ref import dequant_pages, gather_pages, paged_decode_reference

__all__ = ["flash_decode_fwd", "paged_decode_attention",
           "paged_decode_reference", "gather_pages", "dequant_pages",
           "default_num_splits"]
