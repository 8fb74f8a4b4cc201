"""Wrapper of the paged chunked-prefill GQA flash-attention CUDA kernel.

Replaces ``repro/kernels/prefill_attention/kernel.py::flash_prefill_fwd``.
The TPU kernel keeps all C*G query rows of a KV head (256 at C=32, G=8, with
128 KB of f32 accumulators) in VMEM; one Hopper block cannot hold that in
registers, so the kernel (``csrc/paged_attention.cu``, entry
``paged_prefill_fwd``) tiles the rows over a third grid axis, at most 32 rows
a block, skips the pages past each tile's last position and normalises in
the block with l floored at 1e-20. There is no split.
"""
from __future__ import annotations

import torch

from .. import _cuda


def flash_prefill_fwd(q, k_pages, v_pages, page_table, q_start, *,
                      k_scale=None, v_scale=None):
    """q: (B,C,H,hd) f32/bf16; k/v_pages: (KV,P,ps,hd) f32/bf16, or int8
    with (KV,P,ps) f32 scales; page_table: (B,npages) int32; q_start: (B,)
    int32 -> (B,C,H,hd) in q's dtype. CUDA tensors only."""
    _cuda.check_paged("flash_prefill_fwd", q, k_pages, v_pages, page_table,
                      q_start, k_scale, v_scale, q_ndim=4)
    b, c, h, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _cuda.library().paged_prefill_fwd(
        q.data_ptr(), _cuda.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _cuda.DTYPE_CODES[k_pages.dtype],
        _cuda.ptr(k_scale), _cuda.ptr(v_scale), page_table.data_ptr(),
        q_start.data_ptr(), b, c, h, nkv, num_pages, ps, hd,
        page_table.shape[1], out.data_ptr(), _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_prefill_fwd")
    flash_prefill_fwd.launches += 1
    return out


flash_prefill_fwd.launches = 0
