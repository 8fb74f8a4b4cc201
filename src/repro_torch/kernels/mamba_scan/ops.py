"""Public entry of the Mamba2 SSD chunked scan, dispatched by device: a
CUDA tensor launches the kernel or raises, a meta tensor takes the same
path through the wrappers' meta route (``kernels/_meta.py``: the plain
version for shapes, no launch), a CPU tensor takes the plain chunked
version, which autograd differentiates.

Where a gradient is wanted (autograd on, an input that requires grad), a
CUDA call goes through ``SSDScan``: the forward kernel with its inputs
saved, and in backward ``ssd_scan_bwd``. There is no fallback to the plain
version on the card: a build or launch failure raises. Calls without a
gradient (the serve paths) launch the forward alone and save nothing.
"""
from __future__ import annotations

import torch

from .._meta import on_kernel_route
from .kernel import ssd_scan, ssd_scan_bwd
from .ref import ssd_chunked_reference


class SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, bmat, cmat, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, bmat, cmat)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a_log, bmat, cmat, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a_log, bmat, cmat = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        dx, ddt, da_log, db, dc = ssd_scan_bwd(x, dt, a_log, bmat, cmat, dy,
                                               dh_final, chunk=ctx.chunk)
        return dx, ddt.to(dt.dtype), da_log.to(a_log.dtype), db, dc, None


def mamba_chunk_scan(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """-> (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32); the state
    starts at zero; no D-skip. A ``None`` gradient of h_final is zero."""
    if not on_kernel_route(x):
        return ssd_chunked_reference(x, dt, a_log, bmat, cmat, chunk=chunk)
    x, bmat, cmat = x.contiguous(), bmat.contiguous(), cmat.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log, bmat, cmat)):
        return SSDScan.apply(x, dt, a_log, bmat, cmat, chunk)
    return ssd_scan(x, dt, a_log, bmat, cmat, chunk=chunk)
