"""Wrapper of the paged chunked-prefill GQA flash-attention CUDA kernels.

Replaces ``repro/kernels/prefill_attention/kernel.py::flash_prefill_fwd``.
The TPU kernel keeps all C*G query rows of a KV head in VMEM; a Hopper
block cannot, so the rows are tiled over the grid, each tile skipping the
pages past its own last position and normalising itself (l floored at
1e-20); there is no split. The kernel is chosen by dtype
(``_cuda.paged_route``), never by trying one and then the other:

- bf16 q over a bf16 or int8 pool -> ``csrc/paged_attention_sm90.cu``: a
  warpgroup a 64-row tile (64/G queries x G heads), wgmma for QK^T and PV,
  pages gathered by TMA through a two-stage mbarrier ring, int8 pages
  converted to bf16 in shared memory with their scales folded into S and
  P; hd in (64, 128, 192, 256), page_size in (8, 16, 32, 64), G <= 64,
  anything else raises.
- f32 q, or an f32 pool -> ``csrc/paged_attention.cu`` entry
  ``paged_prefill_fwd``: the CUDA-core kernel (wgmma has no full-f32 mode),
  32-row tiles.
"""
from __future__ import annotations

import torch

from .. import _cuda, _meta
from .ref import paged_prefill_reference


@_meta.route(paged_prefill_reference)
def flash_prefill_fwd(q, k_pages, v_pages, page_table, q_start, *,
                      k_scale=None, v_scale=None):
    """q: (B,C,H,hd) f32/bf16; k/v_pages: (KV,P,ps,hd) f32/bf16, or int8
    with (KV,P,ps) f32 scales; page_table: (B,npages) int32; q_start: (B,)
    int32 -> (B,C,H,hd) in q's dtype.
    CUDA tensors, or meta ones (``_meta``)."""
    _cuda.check_paged("flash_prefill_fwd", q, k_pages, v_pages, page_table,
                      q_start, k_scale, v_scale, q_ndim=4)
    route = _cuda.paged_route("flash_prefill_fwd", q, k_pages)
    if route == "sm90":
        out = _cuda.paged_sm90("flash_prefill_fwd", q, k_pages, v_pages,
                               page_table, q_start, 0, k_scale, v_scale, 1)
    else:
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
    flash_prefill_fwd.launches_by_route[route] += 1
    return out


flash_prefill_fwd.launches = 0
flash_prefill_fwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
