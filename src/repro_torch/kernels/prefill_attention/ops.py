"""Public entry of paged chunked-prefill attention, dispatched by device:
a CUDA tensor launches the kernel or raises, a CPU tensor takes the plain
version."""
from __future__ import annotations

import torch

from .kernel import flash_prefill_fwd
from .ref import paged_prefill_reference


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_start, *,
                            k_scale=None, v_scale=None):
    """Paged chunked-prefill GQA attention: (B,C,H,hd) queries at positions
    ``q_start .. q_start+C-1`` over the pool."""
    if q.is_cuda:
        return flash_prefill_fwd(q, k_pages, v_pages,
                                 page_table.to(torch.int32).contiguous(),
                                 q_start.to(torch.int32).contiguous(),
                                 k_scale=k_scale, v_scale=v_scale)
    return paged_prefill_reference(q, k_pages, v_pages, page_table, q_start,
                                   k_scale=k_scale, v_scale=v_scale)
