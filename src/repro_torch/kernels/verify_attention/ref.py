"""Plain PyTorch version of paged multi-query (speculative-verify) attention.

A verify step scores T = K+1 candidates per slot: the verified current token
plus K drafts at positions ``pos[b] .. pos[b]+T-1``, whose KV rows are already
in the pool. Query ``i`` attends every pooled row at a position
<= ``pos[b] + i``. T=1 is decode attention with ``lengths = pos + 1``.
"""
from __future__ import annotations

import torch

from ..decode_attention.ref import gather_kv, masked_attention


def paged_verify_reference(q, k_pages, v_pages, page_table, pos,
                           k_scale=None, v_scale=None):
    """q: (B, T, H, hd); k/v_pages: (KV, P, ps, hd) with the window's rows
    written; page_table: (B, npages) int32; pos: (B,) position of
    ``q[:, 0]``. Returns (B, T, H, hd)."""
    t = q.shape[1]
    k, v = gather_kv(k_pages, v_pages, page_table, k_scale, v_scale)
    q_pos = pos.long()[:, None] + torch.arange(t, device=q.device)[None]
    return masked_attention(q, k, v, q_pos)
