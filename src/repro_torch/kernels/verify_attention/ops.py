"""Public entry of paged speculative-verify attention, dispatched by device:
a CUDA tensor launches the kernel or raises, a meta tensor takes the
wrapper's meta route (``kernels/_meta.py``: the plain version for shapes,
no launch), a CPU tensor takes the plain version."""
from __future__ import annotations

import torch

from .._meta import on_kernel_route
from ..decode_attention.ops import default_num_splits
from .kernel import flash_verify_fwd
from .ref import paged_verify_reference


def paged_verify_attention(q, k_pages, v_pages, page_table, pos, *,
                           k_scale=None, v_scale=None,
                           split_budget: int = 32):
    """Paged multi-query GQA attention: (B,T,H,hd) window queries at
    positions ``pos .. pos+T-1`` over the pool."""
    if on_kernel_route(q):
        splits = default_num_splits(page_table.shape[1],
                                    batch=page_table.shape[0],
                                    split_budget=split_budget)
        return flash_verify_fwd(q, k_pages, v_pages,
                                page_table.to(torch.int32).contiguous(),
                                pos.to(torch.int32).contiguous(),
                                k_scale=k_scale, v_scale=v_scale,
                                num_splits=splits)
    return paged_verify_reference(q, k_pages, v_pages, page_table, pos,
                                  k_scale=k_scale, v_scale=v_scale)
