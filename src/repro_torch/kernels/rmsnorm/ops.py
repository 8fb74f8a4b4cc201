"""Public entry of RMSNorm, dispatched by device: a CUDA tensor launches the
kernel or raises, a meta tensor takes the same path through the wrappers'
meta route (``kernels/_meta.py``: the plain version for shapes, no
launch), a CPU tensor takes the plain version, which autograd
differentiates.

Where a gradient is wanted (autograd on, x or the weight requiring grad), a
CUDA call goes through ``RMSNorm``: the forward kernel, and in backward the
backward kernel; no fallback to the plain version on the card.
"""
from __future__ import annotations

import torch

from .._meta import on_kernel_route
from .kernel import rmsnorm_bwd, rmsnorm_fused
from .ref import rmsnorm_reference


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fused(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def rmsnorm(x, weight, eps: float = 1e-6):
    if on_kernel_route(x):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or weight.requires_grad):
            return RMSNorm.apply(x, weight, eps)
        return rmsnorm_fused(x, weight, eps)
    return rmsnorm_reference(x, weight, eps)
