"""Wrapper of the dense causal GQA flash-attention forward CUDA kernel.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``.
The TPU kernel carries the online softmax across the sequential KV grid
axis in VMEM scratch; the kernel (``csrc/flash_attention.cu``) runs one
block a (32-row q tile, head, batch) that loops over 32-key KV tiles up to
the diagonal itself, with (m, l) in registers and the f32 accumulator split
over the block's threads. It masks the ragged edges itself: no ``S % block``
contract.
"""
from __future__ import annotations

import torch

from .. import _cuda


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd), one dtype (f32/bf16) ->
    (B,Sq,H,hd). hd % 32 == 0, 32 <= hd <= 256, H % KV == 0. CUDA tensors
    only."""
    _cuda.check_cuda("flash_attention_fwd", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, skv, nkv, khd = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype} {k.dtype} "
                         f"{v.dtype}; need one of f32/bf16")
    if k.shape[0] != b or khd != hd or h % nkv or hd % 32 \
            or not 32 <= hd <= 256:
        raise ValueError(f"flash_attention_fwd: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}; contract is H % KV == 0, "
                         "hd % 32 == 0, 32 <= hd <= 256")
    out = torch.empty_like(q)
    rc = _cuda.library("flash_attention.cu").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _cuda.DTYPE_CODES[q.dtype],
        out.data_ptr(), b, sq, skv, h, nkv, hd, int(causal),
        _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
