"""Wrapper of the dense causal GQA flash-attention forward CUDA kernels.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``.
The TPU kernel carries the online softmax across the sequential KV grid
axis in VMEM scratch; here one block loops over the KV tiles up to the
diagonal itself (``csrc/flash_attention.cu``). The kernel is chosen by
dtype (``_cuda.attention_route``), never by trying one and then the other:

- bf16 -> ``flash_attention_sm90_fwd``: a warpgroup a 64-row q tile, wgmma
  for QK^T and PV, K/V tiles by TMA through a two-stage mbarrier ring; hd
  in (64, 128, 192, 256), any other hd raises.
- f32 -> ``flash_attention_f32_fwd``: the CUDA-core kernel (wgmma has no
  full-f32 mode), 32-row q tiles; hd % 32 == 0, 32 <= hd <= 256.

Both mask the ragged edges themselves: no ``S % block`` contract.
"""
from __future__ import annotations

import torch

from .. import _cuda


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd), one dtype (f32/bf16) ->
    (B,Sq,H,hd). H % KV == 0; hd per route (module docstring). CUDA
    tensors only."""
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
    if k.shape[0] != b or khd != hd or h % nkv:
        raise ValueError(f"flash_attention_fwd: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}; contract is H % KV == 0")
    route = _cuda.attention_route(q.dtype, k.dtype, hd)
    if route == "cuda_core" and (hd % 32 or not 32 <= hd <= 256):
        raise ValueError(f"flash_attention_fwd: the f32 kernel's contract is "
                         f"hd % 32 == 0, 32 <= hd <= 256; got hd={hd}")
    lib = _cuda.library("flash_attention.cu")
    fn = (lib.flash_attention_sm90_fwd if route == "sm90"
          else lib.flash_attention_f32_fwd)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, nkv, hd, int(causal), _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
