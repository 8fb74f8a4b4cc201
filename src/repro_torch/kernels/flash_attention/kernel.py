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

Both mask the ragged edges themselves: no ``S % block`` contract. With
``return_lse`` both also write each row's log-sum-exp (B,H,Sq) f32, which
``flash_attention_bwd`` reads: the port's own backward (no TPU counterpart
-- the reference differentiates its jnp attention with XLA), no atomics,
chosen by dtype (``_cuda.attention_bwd_route``):

- bf16 -> ``flash_attention_bwd_sm90`` (``csrc/flash_attention_bwd_sm90.cu``):
  a dK/dV kernel (a warpgroup a 64-key tile, Q and dO streamed by TMA) and a
  dQ kernel (a warpgroup a 64-row query tile, K and V streamed), every
  product a wgmma; hd 64 or 128, any other hd raises.
- f32 -> ``flash_attention_f32_bwd`` (``csrc/flash_attention_bwd.cu``): the
  CUDA-core kernels; hd % 32 == 0, 32 <= hd <= 256.
"""
from __future__ import annotations

import torch

from .. import _cuda


def _check(name, q, k, v):
    """The shapes and dtypes both directions take; raises otherwise."""
    _cuda.check_cuda(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype} {k.dtype} {v.dtype}; "
                         f"need one of f32/bf16")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"{name}: q{tuple(q.shape)} k{tuple(k.shape)}; "
                         f"contract is H % KV == 0")


def _check_cuda_core_hd(name, hd):
    if hd % 32 or not 32 <= hd <= 256:
        raise ValueError(f"{name}: the CUDA-core kernel's contract is "
                         f"hd % 32 == 0, 32 <= hd <= 256; got hd={hd}")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        return_lse: bool = False):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd), one dtype (f32/bf16) ->
    (B,Sq,H,hd), and with ``return_lse`` also the rows' natural
    log-sum-exp of the scaled scores (B,H,Sq) f32. H % KV == 0; hd per
    route (module docstring). CUDA tensors only."""
    _check("flash_attention_fwd", q, k, v)
    b, sq, h, hd = q.shape
    _, skv, nkv, _ = k.shape
    route = _cuda.attention_route(q.dtype, k.dtype, hd)
    if route == "cuda_core":
        _check_cuda_core_hd("flash_attention_fwd", hd)
    lib = _cuda.library("flash_attention.cu")
    fn = (lib.flash_attention_sm90_fwd if route == "sm90"
          else lib.flash_attention_f32_fwd)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, nkv, hd, int(causal), _cuda.ptr(lse), _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = {"sm90": 0, "cuda_core": 0}


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True):
    """Gradients of ``flash_attention_fwd`` (q, k, v, its ``out`` and
    ``lse``) for the output gradient ``dout`` -> (dq, dk, dv) in q's dtype.
    Three launches (the delta = rowsum(dout * out) pass, then the dK/dV and
    dQ kernels), counted as one, on the route of q's dtype (module
    docstring); any S and G; CUDA tensors only."""
    _check("flash_attention_bwd", q, k, v)
    _cuda.check_cuda("flash_attention_bwd", q, out, dout, lse)
    b, sq, h, hd = q.shape
    _, skv, nkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: out{tuple(out.shape)} "
                         f"{out.dtype}, dout{tuple(dout.shape)} {dout.dtype}, "
                         f"lse{tuple(lse.shape)} {lse.dtype} for "
                         f"q{tuple(q.shape)} {q.dtype}")
    route = _cuda.attention_bwd_route(q.dtype, hd)
    if route == "cuda_core":
        _check_cuda_core_hd("flash_attention_bwd", hd)
        fn = _cuda.library("flash_attention_bwd.cu").flash_attention_f32_bwd
    else:
        # TMA and the 16-byte loads of the delta pass need aligned rows.
        if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
            raise ValueError("flash_attention_bwd: bf16 inputs must be "
                             "16-byte aligned")
        fn = _cuda.library(
            "flash_attention_bwd_sm90.cu").flash_attention_bwd_sm90
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, nkv, hd, int(causal),
            _cuda.stream_of(q))
    _cuda.raise_on(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
