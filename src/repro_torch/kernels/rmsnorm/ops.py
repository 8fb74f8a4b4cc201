"""Public entry of RMSNorm, dispatched by device: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version."""
from __future__ import annotations

from .kernel import rmsnorm_fused
from .ref import rmsnorm_reference


def rmsnorm(x, weight, eps: float = 1e-6):
    if x.is_cuda:
        return rmsnorm_fused(x, weight, eps)
    return rmsnorm_reference(x, weight, eps)
