"""Plain PyTorch version of paged chunked-prefill GQA attention.

A prefill chunk is ``C`` consecutive prompt tokens whose KV rows are already
scattered into the pool. Query ``i`` of request ``b`` sits at global position
``q_start[b] + i`` and attends every pooled row at a position <= its own:
history pages plus the causal triangle of its own chunk.
"""
from __future__ import annotations

import torch

from ..decode_attention.ref import gather_kv, masked_attention


def paged_prefill_reference(q, k_pages, v_pages, page_table, q_start,
                            k_scale=None, v_scale=None):
    """q: (B, C, H, hd); k/v_pages: (KV, P, ps, hd) with the chunk's own rows
    written; page_table: (B, npages) int32; q_start: (B,) position of
    ``q[:, 0]``. Returns (B, C, H, hd); rows past a prompt's end are garbage
    (their keys went to the sink page) and callers discard them."""
    c = q.shape[1]
    k, v = gather_kv(k_pages, v_pages, page_table, k_scale, v_scale)
    q_pos = q_start.long()[:, None] + torch.arange(c, device=q.device)[None]
    return masked_attention(q, k, v, q_pos)
