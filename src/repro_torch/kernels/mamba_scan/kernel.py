"""Wrapper of the Mamba2 SSD chunked-scan CUDA kernel.

Replaces ``repro/kernels/mamba_scan/kernel.py::ssd_scan``. The TPU kernel
carries the SSM state across the sequential chunk grid axis in VMEM
scratch; the kernel (``csrc/ssd_scan.cu``) runs one block a (batch, head)
that walks the chunks in order with the (N,P) f32 state in shared memory,
and, unlike the TPU kernel, writes the final state out: the serve engine
keeps it as the decode cache.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import check_chunk

MAX_CHUNK = MAX_STATE = 128      # rows a block's 8 warps cover, 16 each
MAX_SMEM = 232448                # bytes of shared memory a Hopper block may use


def _smem_bytes(chunk: int, n: int, p: int) -> int:
    """csrc/ssd_scan.cu smem_bytes: state, B (padded), C, x, W, 3 vectors."""
    return 4 * (n * p + chunk * (n + 1) + chunk * n + chunk * p
                + chunk * chunk + 3 * chunk)


def ssd_scan(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """x: (B,S,H,P) f32/bf16; dt: (B,S,H); a_log: (H,); bmat/cmat: (B,S,N)
    in x's dtype -> (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32), the
    state starting at zero. Chunks of ``min(chunk, S)`` steps; S must be a
    multiple of it. CUDA tensors only."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = check_chunk(s, chunk)
    dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    _cuda.check_cuda("ssd_scan", x, bmat, cmat, dt, a_log)
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x {x.dtype}, B {bmat.dtype}, C "
                         f"{cmat.dtype}; need one of f32/bf16")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n) \
            or dt.shape != (b, s, h) or a_log.shape != (h,):
        raise ValueError(f"ssd_scan: shapes x{tuple(x.shape)} "
                         f"B{tuple(bmat.shape)} C{tuple(cmat.shape)} "
                         f"dt{tuple(dt.shape)} a_log{tuple(a_log.shape)} "
                         "disagree")
    if chunk > MAX_CHUNK or n > MAX_STATE \
            or _smem_bytes(chunk, n, p) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, N {n}, P {p} exceed the "
                         f"kernel's contract (chunk, N <= {MAX_CHUNK}, one "
                         "chunk staged in 227 KB of shared memory)")
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    rc = _cuda.library("ssd_scan.cu").ssd_scan_fwd(
        x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        _cuda.DTYPE_CODES[x.dtype], dt.data_ptr(), a_log.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), b, s, h, p, n, chunk,
        _cuda.stream_of(x))
    _cuda.raise_on(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
