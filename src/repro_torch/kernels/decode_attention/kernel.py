"""Wrapper of the split-KV paged GQA flash-decode CUDA kernel.

Replaces ``repro/kernels/decode_attention/kernel.py::flash_decode_fwd``. The
kernel (``csrc/paged_attention.cu``, entry ``paged_decode_fwd``) runs one
block per (request, KV head, split), loops over the split's pages, keeps the
f32 online softmax on chip and skips pages wholly past ``length``; with more
than one split a second small kernel combines the unnormalised partials.
It is bound by the bytes of the pages it reads (see the source's notes).
"""
from __future__ import annotations

import torch

from .. import _cuda


def flash_decode_fwd(q, k_pages, v_pages, page_table, lengths, *,
                     k_scale=None, v_scale=None, num_splits: int = 1):
    """q: (B,H,hd) f32/bf16; k/v_pages: (KV,P,ps,hd) f32/bf16, or int8 with
    (KV,P,ps) f32 ``k_scale``/``v_scale``; page_table: (B,npages) int32;
    lengths: (B,) int32 -> (B,H,hd) in q's dtype. CUDA tensors only."""
    _cuda.check_paged("flash_decode_fwd", q, k_pages, v_pages, page_table,
                      lengths, k_scale, v_scale, q_ndim=3)
    b, h, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    npages = page_table.shape[1]
    if num_splits < 1 or npages % num_splits:
        raise ValueError(f"npages {npages} % num_splits {num_splits}")
    out = torch.empty_like(q)
    part_o = part_m = part_l = None
    if num_splits > 1:
        rows = h // nkv
        part_o = torch.empty((b, nkv, num_splits, rows, hd),
                             dtype=torch.float32, device=q.device)
        part_m = torch.empty((b, nkv, num_splits, rows), dtype=torch.float32,
                             device=q.device)
        part_l = torch.empty_like(part_m)
    rc = _cuda.library().paged_decode_fwd(
        q.data_ptr(), _cuda.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _cuda.DTYPE_CODES[k_pages.dtype],
        _cuda.ptr(k_scale), _cuda.ptr(v_scale), page_table.data_ptr(),
        lengths.data_ptr(), b, h, nkv, num_pages, ps, hd, npages, num_splits,
        out.data_ptr(), _cuda.ptr(part_o), _cuda.ptr(part_m),
        _cuda.ptr(part_l), _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_decode_fwd")
    flash_decode_fwd.launches += 1
    return out


flash_decode_fwd.launches = 0
