"""Plain PyTorch version of the Mamba2 SSD scan: the chunked SSD algorithm
the CUDA kernel uses (intra-chunk masked contraction, inter-chunk term
from the carried state, state update), with each chunk's y cast to x's
dtype. It is what the CPU path runs; the tests hold it against the
reference's sequential oracle. No D-skip.
"""
from __future__ import annotations

import torch


def check_chunk(s: int, chunk: int) -> int:
    """The chunk length the scan uses, ``min(chunk, S)``, at least 1. S
    need not be a multiple of it: the last chunk then has ``S - c0`` rows
    (the reference asserts a multiple, models/ssm.py; the port serves the
    batches that assertion refuses)."""
    chunk = min(chunk, s)
    if chunk < 1:
        raise ValueError(f"ssd scan: chunk {chunk} (sequence {s}) must be "
                         ">= 1")
    return chunk


def ssd_chunked_reference(x, dt, a_log, bmat, cmat, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); bmat/cmat: (B,S,N). Chunks
    of ``min(chunk, S)`` steps, the last one shorter when S is not a
    multiple; the f32 state carried from zero. Returns (y (B,S,H,P) in x's
    dtype, h_final (B,H,N,P) f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = check_chunk(s, chunk)
    a = -torch.exp(a_log.float())                                  # (H,)
    above = ~torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    hs = torch.zeros(b, h, n, p, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        # The slices, the mask and la[:, -1] (the state decay) all take
        # this chunk's own L rows: the last chunk is short when S is not a
        # multiple of the chunk.
        ln = min(chunk, s - c0)
        x_ = x[:, c0:c0 + chunk].float()                           # (B,L,H,P)
        dt_ = dt[:, c0:c0 + chunk].float()                         # (B,L,H)
        b_ = bmat[:, c0:c0 + chunk].float()                        # (B,L,N)
        c_ = cmat[:, c0:c0 + chunk].float()
        la = torch.cumsum(dt_ * a, dim=1)                          # (B,L,H)
        cb = torch.einsum("bln,bmn->blm", c_, b_)
        seg = la[:, :, None, :] - la[:, None, :, :]                # (B,L,M,H)
        decay = torch.exp(seg.masked_fill(above[None, :ln, :ln, None],
                                          float("-inf")))
        y = torch.einsum("blmh,bmhp->blhp", cb[..., None] * decay,
                         dt_[..., None] * x_)
        y = y + torch.einsum("bln,blh,bhnp->blhp", c_, torch.exp(la), hs)
        w_state = torch.exp(la[:, -1:, :] - la) * dt_              # (B,L,H)
        st = torch.einsum("bln,blh,blhp->bhnp", b_, w_state, x_)
        hs = torch.exp(la[:, -1, :])[:, :, None, None] * hs + st
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), hs
