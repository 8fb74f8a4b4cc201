"""Wrapper of the fused RMSNorm CUDA kernel.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm_fused``. The kernel
(``csrc/rmsnorm.cu``) runs one block a row: it reads each element once into
shared memory as f32 while summing squares, and writes each once. It is
bound by those bytes. Any row count works (no ``rows % block_rows``
contract).
"""
from __future__ import annotations

import torch

from .. import _cuda

MAX_D = 32768            # the row is staged in shared memory as f32


def rmsnorm_fused(x, weight, eps: float = 1e-6):
    """x: (..., D) f32/bf16; weight: (D,) -> same shape and dtype as x.
    CUDA tensors only."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    w = weight.float().contiguous()
    _cuda.check_cuda("rmsnorm_fused", x2, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm_fused: dtype {x.dtype} not f32/bf16")
    if w.shape != (d,) or not 1 <= d <= MAX_D or x2.shape[0] < 1:
        raise ValueError(f"rmsnorm_fused: x{tuple(x.shape)} weight"
                         f"{tuple(weight.shape)}; need 1 <= D <= {MAX_D}")
    out = torch.empty_like(x2)
    rc = _cuda.library("rmsnorm.cu").rmsnorm_fwd(
        x2.data_ptr(), _cuda.DTYPE_CODES[x.dtype], w.data_ptr(),
        out.data_ptr(), x2.shape[0], d, float(eps), _cuda.stream_of(x2))
    _cuda.raise_on(rc, "rmsnorm_fused")
    rmsnorm_fused.launches += 1
    return out.reshape(x.shape)


rmsnorm_fused.launches = 0
