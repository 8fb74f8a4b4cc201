"""Plain PyTorch version of fused RMSNorm: what the CPU path runs."""
from __future__ import annotations

import torch


def rmsnorm_reference(x, weight, eps: float = 1e-6):
    """f32 mean square and rsqrt, times the f32 weight, cast back to x's
    dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm_bwd_reference(x, weight, g, eps: float = 1e-6):
    """(dx, dw) of ``rmsnorm_reference`` for the output gradient ``g``, by
    autograd: the plain version of the backward kernel."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(),
                  weight.detach().requires_grad_()]
        out = rmsnorm_reference(*leaves, eps)
        return torch.autograd.grad(out, leaves, g)
