"""Public entry of dense GQA flash attention, dispatched by device: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version, which autograd differentiates.

Where a gradient is wanted (autograd on, an input that requires grad), a
CUDA call goes through ``FlashAttention``: the forward kernel with its row
log-sum-exp saved, and in backward the backward kernel. There is no
fallback to the plain version on the card: a build or launch failure
raises. Calls without a gradient (the serve paths) launch the forward alone
and save nothing.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bwd, flash_attention_fwd
from .ref import attention_reference


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    if q.is_cuda:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal)
        return flash_attention_fwd(q, k, v, causal=causal)
    return attention_reference(q, k, v, causal=causal)
