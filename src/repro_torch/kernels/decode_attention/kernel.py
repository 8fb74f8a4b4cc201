"""Wrapper of the split-KV paged GQA flash-decode CUDA kernels.

Replaces ``repro/kernels/decode_attention/kernel.py::flash_decode_fwd``.
One block runs per (request, KV head, split), walks the split's pages,
keeps the f32 online softmax on chip and skips pages wholly past
``length``; with more than one split a second small kernel combines the
unnormalised partials. The kernel is chosen by dtype
(``_cuda.paged_route``), never by trying one and then the other:

- bf16 q over a bf16 or int8 pool -> ``csrc/paged_attention_sm90.cu``, the
  paged prefill's wgmma + TMA kernel with C = 1 and the query at
  ``lengths - 1`` (the kernel takes a shift of -1; no op on the host): the
  G rows of a (b, kv) in one 64-row tile, 64-key tiles of pages gathered
  by TMA, partials combined in the exp2 domain; hd in (64, 128, 192, 256),
  page_size in (8, 16, 32, 64), G <= 64, anything else raises.
- f32 q, or an f32 pool -> ``csrc/paged_attention.cu`` entry
  ``paged_decode_fwd``: the CUDA-core kernel (wgmma has no full-f32 mode).

Both are bound by the bytes of the pages they read (see the sources'
notes).
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
    route = _cuda.paged_route("flash_decode_fwd", q, k_pages)
    if route == "sm90":
        out = _cuda.paged_sm90("flash_decode_fwd", q[:, None], k_pages,
                               v_pages, page_table, lengths, -1, k_scale,
                               v_scale, num_splits)[:, 0]
    else:
        out = torch.empty_like(q)
        part_o = part_m = part_l = None
        if num_splits > 1:
            rows = h // nkv
            part_o = torch.empty((b, nkv, num_splits, rows, hd),
                                 dtype=torch.float32, device=q.device)
            part_m = torch.empty((b, nkv, num_splits, rows),
                                 dtype=torch.float32, device=q.device)
            part_l = torch.empty_like(part_m)
        rc = _cuda.library().paged_decode_fwd(
            q.data_ptr(), _cuda.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
            v_pages.data_ptr(), _cuda.DTYPE_CODES[k_pages.dtype],
            _cuda.ptr(k_scale), _cuda.ptr(v_scale), page_table.data_ptr(),
            lengths.data_ptr(), b, h, nkv, num_pages, ps, hd, npages,
            num_splits, out.data_ptr(), _cuda.ptr(part_o), _cuda.ptr(part_m),
            _cuda.ptr(part_l), _cuda.stream_of(q))
        _cuda.raise_on(rc, "flash_decode_fwd")
    flash_decode_fwd.launches += 1
    flash_decode_fwd.launches_by_route[route] += 1
    return out


flash_decode_fwd.launches = 0
flash_decode_fwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
