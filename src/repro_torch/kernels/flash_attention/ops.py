"""Public entry of dense GQA flash attention, dispatched by device: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version."""
from __future__ import annotations

from .kernel import flash_attention_fwd
from .ref import attention_reference


def flash_attention(q, k, v, *, causal: bool = True):
    if q.is_cuda:
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal)
    return attention_reference(q, k, v, causal=causal)
