"""Wrapper of the Mamba2 SSD chunked-scan CUDA kernels.

Replaces ``repro/kernels/mamba_scan/kernel.py::ssd_scan``. The TPU kernel
carries the SSM state across the sequential chunk grid axis in VMEM
scratch; here a block walks its chunks in order itself
(``csrc/ssd_scan.cu``) and, unlike the TPU kernel, writes the final state
out: the serve engine keeps it as the decode cache. The kernel is chosen by
dtype (``_cuda.ssd_route``), never by trying one and then the other:

- bf16 -> ``ssd_scan_sm90_fwd``: a block a (batch, group of
  ``head_block`` heads), C B^T once a chunk for the group, the products on
  wgmma, x, B and C by TMA through a two-stage mbarrier ring; N = P = 64,
  any other width raises.
- f32 -> ``ssd_scan_f32_fwd``: the CUDA-core kernel (wgmma has no
  full-f32 mode), a block a (batch, head); N <= 128 and one chunk staged
  in 227 KB of shared memory.

Both take any chunk from 1 to 128 and any S: when S is not a multiple of
the chunk, the last chunk has ``S - c0`` rows.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import check_chunk

MAX_CHUNK = MAX_STATE = 128      # rows a block covers (both kernels)
MAX_SMEM = 232448                # bytes of shared memory a Hopper block may use
MIN_BLOCKS = 128                 # about one wave of an H100's 132 SMs


def _smem_bytes(chunk: int, n: int, p: int) -> int:
    """csrc/ssd_scan.cu smem_bytes (the f32 kernel): state, B (padded), C,
    x, W, 3 vectors."""
    return 4 * (n * p + chunk * (n + 1) + chunk * n + chunk * p
                + chunk * chunk + 3 * chunk)


def head_block(b: int, h: int) -> int:
    """Heads a block of the tensor-core kernel walks (1, 2 or 4): the
    largest that divides H and still leaves B*H/HB >= MIN_BLOCKS blocks
    (HB 4 at B 8, H 64: 128 blocks); shared memory holds at most four
    heads' states."""
    for hb in (4, 2):
        if h % hb == 0 and b * h // hb >= MIN_BLOCKS:
            return hb
    return 1


def ssd_scan(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """x: (B,S,H,P) f32/bf16; dt: (B,S,H); a_log: (H,); bmat/cmat: (B,S,N)
    in x's dtype -> (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32), the
    state starting at zero. Chunks of ``min(chunk, S)`` steps, the last
    one ragged when S is not a multiple. Contract per route in the module
    docstring. CUDA tensors only."""
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
    route = _cuda.ssd_route(x.dtype, n, p)
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} exceeds the kernels' "
                         f"contract (chunk <= {MAX_CHUNK})")
    if route == "cuda_core" and (n > MAX_STATE
                                 or _smem_bytes(chunk, n, p) > MAX_SMEM):
        raise ValueError(f"ssd_scan: chunk {chunk}, N {n}, P {p} exceed the "
                         f"f32 kernel's contract (N <= {MAX_STATE}, one "
                         "chunk staged in 227 KB of shared memory)")
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    lib = _cuda.library("ssd_scan.cu")
    args = (x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, s, h, p,
            n, chunk)
    if route == "sm90":
        rc = lib.ssd_scan_sm90_fwd(*args, head_block(b, h),
                                   _cuda.stream_of(x))
    else:
        rc = lib.ssd_scan_f32_fwd(*args, _cuda.stream_of(x))
    _cuda.raise_on(rc, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[route] += 1
    return y, h_final


ssd_scan.launches = 0
ssd_scan.launches_by_route = {"sm90": 0, "cuda_core": 0}
