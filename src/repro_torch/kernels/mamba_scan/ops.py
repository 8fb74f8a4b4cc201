"""Public entry of the Mamba2 SSD chunked scan, dispatched by device: a
CUDA tensor launches the kernel or raises, a CPU tensor takes the plain
chunked version."""
from __future__ import annotations

from .kernel import ssd_scan
from .ref import ssd_chunked_reference


def mamba_chunk_scan(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """-> (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) f32); the state
    starts at zero; no D-skip."""
    if x.is_cuda:
        return ssd_scan(x.contiguous(), dt, a_log, bmat.contiguous(),
                        cmat.contiguous(), chunk=chunk)
    return ssd_chunked_reference(x, dt, a_log, bmat, cmat, chunk=chunk)
