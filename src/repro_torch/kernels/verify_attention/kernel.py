"""Wrapper of the split-KV paged multi-query (verify) CUDA kernels.

Replaces ``repro/kernels/verify_attention/kernel.py::flash_verify_fwd``: the
decode kernel's split-KV dataflow with T*G query rows per KV head (40 at
K=4, G=8) and the prefill kernel's positional mask ``kv_pos <= pos + r//G``.
Pages past a row tile's last position are skipped; with more than one
split a second kernel combines the partials. The kernel is chosen by dtype
(``_cuda.paged_route``), never by trying one and then the other:

- bf16 q over a bf16 or int8 pool -> ``csrc/paged_attention_sm90.cu``, the
  paged prefill's wgmma + TMA kernel with C = T and ``q_start = pos``: the
  T*G rows of a (b, kv) in one 64-row tile while T*G <= 64, so each page
  is read once per split; hd in (64, 128, 192, 256), page_size in (8, 16,
  32, 64), G <= 64, anything else raises.
- f32 q, or an f32 pool -> ``csrc/paged_attention.cu`` entry
  ``paged_verify_fwd``: the CUDA-core kernel (wgmma has no full-f32 mode).
"""
from __future__ import annotations

import torch

from .. import _cuda


def flash_verify_fwd(q, k_pages, v_pages, page_table, pos, *,
                     k_scale=None, v_scale=None, num_splits: int = 1):
    """q: (B,T,H,hd) f32/bf16; k/v_pages: (KV,P,ps,hd) f32/bf16, or int8
    with (KV,P,ps) f32 scales; page_table: (B,npages) int32; pos: (B,) int32
    -> (B,T,H,hd) in q's dtype. CUDA tensors only."""
    _cuda.check_paged("flash_verify_fwd", q, k_pages, v_pages, page_table,
                      pos, k_scale, v_scale, q_ndim=4)
    b, t, h, hd = q.shape
    nkv, num_pages, ps, _ = k_pages.shape
    npages = page_table.shape[1]
    if num_splits < 1 or npages % num_splits:
        raise ValueError(f"npages {npages} % num_splits {num_splits}")
    route = _cuda.paged_route("flash_verify_fwd", q, k_pages)
    if route == "sm90":
        out = _cuda.paged_sm90("flash_verify_fwd", q, k_pages, v_pages,
                               page_table, pos, 0, k_scale, v_scale,
                               num_splits)
    else:
        out = torch.empty_like(q)
        part_o = part_m = part_l = None
        if num_splits > 1:
            rows = t * (h // nkv)
            part_o = torch.empty((b, nkv, num_splits, rows, hd),
                                 dtype=torch.float32, device=q.device)
            part_m = torch.empty((b, nkv, num_splits, rows),
                                 dtype=torch.float32, device=q.device)
            part_l = torch.empty_like(part_m)
        rc = _cuda.library().paged_verify_fwd(
            q.data_ptr(), _cuda.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
            v_pages.data_ptr(), _cuda.DTYPE_CODES[k_pages.dtype],
            _cuda.ptr(k_scale), _cuda.ptr(v_scale), page_table.data_ptr(),
            pos.data_ptr(), b, t, h, nkv, num_pages, ps, hd, npages,
            num_splits, out.data_ptr(), _cuda.ptr(part_o), _cuda.ptr(part_m),
            _cuda.ptr(part_l), _cuda.stream_of(q))
        _cuda.raise_on(rc, "flash_verify_fwd")
    flash_verify_fwd.launches += 1
    flash_verify_fwd.launches_by_route[route] += 1
    return out


flash_verify_fwd.launches = 0
flash_verify_fwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
