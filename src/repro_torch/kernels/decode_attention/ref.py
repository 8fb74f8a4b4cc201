"""Plain PyTorch version of paged GQA flash-decode.

The cache is a block-paged pool of ``page_size``-row pages addressed per
request through a page table. This version gathers each request's logical KV
stream into a dense (B, T, KV, hd) view and runs masked f32 attention: the
semantics the CUDA kernel must reproduce. It is what the CPU path runs.

Page-table entries are clamped to [0, P-1] before the gather, as the kernel
clamps them (torch would raise on an out-of-range index where JAX clamps).
"""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(KV, P, ps, hd), (B, npages) -> dense (B, T, KV, hd), T = npages*ps."""
    nkv, num_pages, ps, hd = pages.shape
    b, npages = page_table.shape
    pt = page_table.long().clamp(0, num_pages - 1)
    seq = pages[:, pt]                               # (KV, B, npages, ps, hd)
    seq = seq.permute(1, 2, 3, 0, 4)                 # (B, npages, ps, KV, hd)
    return seq.reshape(b, npages * ps, nkv, hd)


def dequant_pages(pages: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize an int8 pool up front: (KV,P,ps,hd) int8 * (KV,P,ps) f32."""
    return pages.float() * scale.float()[..., None]


def masked_attention(q, k, v, q_pos):
    """Shared body of the three plain versions.

    q: (B, C, H, hd); k/v: (B, T, KV, hd) gathered; q_pos: (B, C) the last
    key position each query may see. Returns (B, C, H, hd) in q's dtype.
    """
    b, c, h, hd = q.shape
    nkv = k.shape[2]
    t = k.shape[1]
    qg = q.reshape(b, c, nkv, h // nkv, hd).float()
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k.float()) / math.sqrt(hd)
    kv_pos = torch.arange(t, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]               # (B, C, T)
    s = torch.where(mask[:, None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def gather_kv(k_pages, v_pages, page_table, k_scale=None, v_scale=None):
    """Dequantize (int8 pools) and gather both K and V streams."""
    if k_scale is not None:
        k_pages = dequant_pages(k_pages, k_scale)
        v_pages = dequant_pages(v_pages, v_scale)
    return gather_pages(k_pages, page_table), gather_pages(v_pages, page_table)


def paged_decode_reference(q, k_pages, v_pages, page_table, lengths,
                           k_scale=None, v_scale=None):
    """Single-step GQA attention over a paged KV cache.

    q: (B, H, hd); k/v_pages: (KV, P, page_size, hd); page_table: (B, npages)
    int32; lengths: (B,) valid KV rows per request (rows >= length masked);
    k_scale/v_scale: optional (KV, P, page_size) f32 scales of an int8 pool.
    Returns (B, H, hd).
    """
    k, v = gather_kv(k_pages, v_pages, page_table, k_scale, v_scale)
    out = masked_attention(q[:, None], k, v, (lengths.long() - 1)[:, None])
    return out[:, 0]
