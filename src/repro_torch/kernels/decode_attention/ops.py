"""Public entry of paged GQA decode attention, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises; a
meta tensor takes the wrapper's meta route (``kernels/_meta.py``: the plain
version for shapes, no launch); a CPU tensor takes the plain version
(``ref.py``). There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .._meta import on_kernel_route
from .kernel import flash_decode_fwd
from .ref import paged_decode_reference


def default_num_splits(npages: int, target: int = 4, *, batch: int = 0,
                       split_budget: int = 0) -> int:
    """Largest split count <= target that divides the page-table width.

    When ``batch`` and ``split_budget`` are given, the target adapts to
    occupancy: ``batch * splits`` is held near the budget (32/8/1 splits at
    batch 1/4/32 for the default budget of 32).
    """
    if split_budget and batch:
        target = max(1, split_budget // batch)
    for s in range(min(target, npages), 0, -1):
        if npages % s == 0:
            return s
    return 1


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scale=None, v_scale=None,
                           split_budget: int = 32):
    """Paged GQA decode attention: (B,H,hd) queries over the pool.

    ``k_scale``/``v_scale``: per-row scale pages of an int8 pool; both the
    kernel and the plain version dequantize with the same f32 arithmetic.
    """
    if on_kernel_route(q):
        splits = default_num_splits(page_table.shape[1],
                                    batch=page_table.shape[0],
                                    split_budget=split_budget)
        return flash_decode_fwd(q, k_pages, v_pages,
                                page_table.to(torch.int32).contiguous(),
                                lengths.to(torch.int32).contiguous(),
                                k_scale=k_scale, v_scale=v_scale,
                                num_splits=splits)
    return paged_decode_reference(q, k_pages, v_pages, page_table, lengths,
                                  k_scale=k_scale, v_scale=v_scale)
