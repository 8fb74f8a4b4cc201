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

``ssd_scan_bwd`` wraps the port's own backward (the TPU package
differentiates its jnp scan with XLA), chosen by dtype
(``_cuda.ssd_route``) as the forward's is:

- bf16 -> ``ssd_scan_bwd_sm90`` (``csrc/ssd_scan_bwd_sm90.cu``): a walk
  over the chunks that writes the state entering each chunk and the
  state gradient leaving it (wgmma), then a block a (batch, chunk, group
  of ``bwd_head_block`` heads) that runs every L x L and L x N x P product
  on wgmma with x, dy, B, C and the states by TMA and sums dB and dC over
  the group's heads, then the sums over head groups;
- f32 -> ``ssd_scan_bwd_f32`` (``csrc/ssd_scan_bwd.cu``): CUDA cores, a
  block a (batch, head) walking the chunks in reverse with dh in shared
  memory.

Both sum dB, dC and da_log over heads and batch in a fixed order, so two
calls give equal bits. Contract: N = P = 64 (compile-time widths, the
tensor-core forward's; a bf16 call off it raises before any launch), chunk
1 to 128, any S; an optional f32 ``dh_final``.
"""
from __future__ import annotations

import torch

from .. import _cuda, _meta
from .ref import (check_chunk, ssd_chunked_backward_reference,
                  ssd_chunked_reference)

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


def bwd_head_block(h: int) -> int:
    """Heads a chunk-body block of the tensor-core backward takes (8, 4, 2
    or 1): the largest that divides H. The block sums dB and dC over them,
    so the f32 partials are (B, S, H / HB, N); at B 8, S 1024, H 64, chunk
    128 the grid is 8 x 8 x 8 = 512 blocks (on an H100 there, HB 8 took
    0.28-0.29 ms of body time against HB 4's 0.30-0.32: fewer partial
    bytes, B and C loaded once for 8 heads)."""
    for hb in (8, 4, 2):
        if h % hb == 0:
            return hb
    return 1


@_meta.route(ssd_chunked_reference)
def ssd_scan(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """x: (B,S,H,P) f32/bf16; dt: (B,S,H); a_log: (H,); bmat/cmat: (B,S,N)
    in x's dtype -> (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32), the
    state starting at zero. Chunks of ``min(chunk, S)`` steps, the last
    one ragged when S is not a multiple. Contract per route in the module
    docstring. CUDA tensors, or meta ones (``_meta``)."""
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


@_meta.route(ssd_chunked_backward_reference)
def ssd_scan_bwd(x, dt, a_log, bmat, cmat, dy, dh_final=None, *,
                 chunk: int = 128):
    """The gradient of ``ssd_scan``'s (y, h_final) for the cotangents dy (x's
    shape and dtype) and ``dh_final`` ((B,H,N,P) f32, zero if None) ->
    (dx, ddt (B,S,H) f32, da_log (H,) f32, dB, dC), dx, dB and dC in x's
    dtype. Contract in the module docstring; CUDA tensors, or meta ones
    (``_meta``). One launch counted on its route (three kernels each: on
    sm90 the state walks, the chunk body, the sums; on cuda_core the
    states, the reverse walk, the sums)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = check_chunk(s, chunk)
    dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    given = (x, bmat, cmat, dy, dt, a_log)
    _cuda.check_cuda("ssd_scan_bwd", *given,
                     *(() if dh_final is None else (dh_final,)))
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != x.dtype for t in (bmat, cmat, dy)):
        raise ValueError(f"ssd_scan_bwd: x {x.dtype}, B {bmat.dtype}, C "
                         f"{cmat.dtype}, dy {dy.dtype}; need one of f32/bf16")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n) \
            or dy.shape != x.shape or dt.shape != (b, s, h) \
            or a_log.shape != (h,) or (dh_final is not None and (
                dh_final.shape != (b, h, n, p)
                or dh_final.dtype != torch.float32)):
        raise ValueError(f"ssd_scan_bwd: shapes x{tuple(x.shape)} "
                         f"B{tuple(bmat.shape)} C{tuple(cmat.shape)} "
                         f"dy{tuple(dy.shape)} dt{tuple(dt.shape)} "
                         f"a_log{tuple(a_log.shape)} dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)}"
                         " disagree (dh_final f32)")
    route = _cuda.ssd_route(x.dtype, n, p)
    width = _cuda.SM90_SSD_WIDTH
    if chunk > MAX_CHUNK or n != width or p != width:
        raise ValueError(f"ssd_scan_bwd: chunk {chunk}, N {n}, P {p} are "
                         f"outside the kernel's contract (chunk <= "
                         f"{MAX_CHUNK}, N = P = {width})")
    nc = -(-s // chunk)
    if route == "sm90":
        hb = bwd_head_block(h)
        bhnc = b * h * nc
        size = bhnc * 8193 + 128 * b * s * (h // hb)
    else:
        size = b * h * nc * n * p + 2 * b * s * h * n + b * h
    work = torch.empty(size, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    da_log = torch.empty((h,), dtype=torch.float32, device=x.device)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    args = (x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), dy.data_ptr(), _cuda.ptr(dh_final),
            work.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
            db.data_ptr(), dc.data_ptr(), b, s, h, p, n, chunk)
    if route == "sm90":
        rc = _cuda.library("ssd_scan_bwd_sm90.cu").ssd_scan_bwd_sm90(
            *args, hb, _cuda.stream_of(x))
    else:
        rc = _cuda.library("ssd_scan_bwd.cu").ssd_scan_bwd_f32(
            *args, _cuda.stream_of(x))
    _cuda.raise_on(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.launches_by_route[route] += 1
    return dx, ddt, da_log, db, dc


ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_route = {"sm90": 0, "cuda_core": 0}
