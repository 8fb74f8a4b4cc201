"""Plain PyTorch versions of the Mamba2 SSD scan and its backward: the
chunked SSD algorithm the CUDA kernels use (intra-chunk masked contraction,
inter-chunk term from the carried state, state update), with each chunk's
y cast to x's dtype, and its gradient by the reverse walk over chunks that
``csrc/ssd_scan_bwd.cu`` takes. The forward is what the CPU path runs
(autograd differentiates it there); the tests hold it against the
reference's sequential oracle, and the backward against ``jax.vjp`` of the
reference's ``ssd_chunked`` and autograd of the forward. No D-skip.
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


def ssd_chunked_backward_reference(x, dt, a_log, bmat, cmat, dy,
                                   dh_final=None, *, chunk: int = 128):
    """The gradient of ``ssd_chunked_reference``'s (y, h_final) for the
    cotangents dy (B,S,H,P) and ``dh_final`` (B,H,N,P), zero if None.
    Returns (dx, ddt, da_log, dB, dC): dx, dB and dC in the inputs'
    dtypes, ddt (B,S,H) and da_log (H,) in f32.

    Written out, not ``torch.autograd.grad``: a first walk keeps the state
    entering each chunk, then the chunks in reverse, carrying dh (the
    gradient of the state leaving the chunk). With G[l,m] = exp(la_l -
    la_m) on and below the diagonal (exp taken only there), CBG = (C_l .
    B_m) G, Q = (dy_l . x_m) G dt_m, R = CBG (dy_l . x_m) and s_m =
    exp(la_last - la_m) dt_m, per (batch, head):
    dx_m = dt_m sum_l CBG[l,m] dy_l + s_m (B dh)_m; dC_l = exp(la_l) h dy_l
    + sum_m Q[l,m] B_m; dB_m = sum_l Q[l,m] C_l + s_m dh x_m; the direct
    ddt_m = sum_l R[l,m] + U_m with U_m = exp(la_last - la_m) x_m . (B
    dh)_m; the gradient of la, pushed back through its cumulative sum
    (ddt_k += a sum_{l>=k} dla_l, da_log = a sum_k dt_k sum_{l>=k} dla_l);
    dh <- exp(la_last) dh + sum_l exp(la_l) C_l dy_l^T. dB and dC are
    summed over heads, da_log over batch and sequence."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = check_chunk(s, chunk)
    a = -torch.exp(a_log.float())                                  # (H,)
    above = ~torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    below = torch.tril(torch.ones(chunk, chunk, device=x.device), -1)

    def load(c0):
        sl = slice(c0, c0 + chunk)
        dt_ = dt[:, sl].float()
        return (x[:, sl].float(), dt_, bmat[:, sl].float(),
                cmat[:, sl].float(), torch.cumsum(dt_ * a, dim=1))

    starts = list(range(0, s, chunk))
    states, hs = [], torch.zeros(b, h, n, p, device=x.device)
    for c0 in starts:
        states.append(hs)
        x_, dt_, b_, _, la = load(c0)
        w_state = torch.exp(la[:, -1:, :] - la) * dt_
        hs = torch.exp(la[:, -1, :])[:, :, None, None] * hs \
            + torch.einsum("bln,blh,blhp->bhnp", b_, w_state, x_)

    dh = (torch.zeros(b, h, n, p, device=x.device) if dh_final is None
          else dh_final.float())
    dxs, ddts, dbs, dcs = [], [], [], []
    da = torch.zeros(h, device=x.device)
    for c0, h_in in zip(reversed(starts), reversed(states)):
        x_, dt_, b_, c_, la = load(c0)
        ln = la.shape[1]
        dy_ = dy[:, c0:c0 + chunk].float()
        la_last = la[:, -1, :]                                     # (B,H)
        seg = la[:, :, None, :] - la[:, None, :, :]                # (B,L,M,H)
        g = torch.exp(seg.masked_fill(above[None, :ln, :ln, None],
                                      float("-inf")))
        ela = torch.exp(la)
        sv = torch.exp(la_last[:, None, :] - la) * dt_             # (B,L,H)
        cbg = torch.einsum("bln,bmn->blm", c_, b_)[..., None] * g
        xdy = torch.einsum("blhp,bmhp->blmh", dy_, x_)
        q = xdy * g * dt_[:, None, :, :]
        r = cbg * xdy
        bdh = torch.einsum("bmn,bhnp->bmhp", b_, dh)
        dxs.append(torch.einsum("blmh,blhp->bmhp", cbg, dy_)
                   * dt_[..., None] + sv[..., None] * bdh)
        dys = torch.einsum("blhp,bhnp->blhn", dy_, h_in) * ela[..., None]
        dcs.append(dys.sum(2) + torch.einsum("blmh,bmn->bln", q, b_))
        dbs.append(torch.einsum("blmh,bln->bmn", q, c_)
                   + torch.einsum("bmh,bmhp,bhnp->bmn", sv, x_, dh))
        u = torch.exp(la_last[:, None, :] - la) \
            * torch.einsum("bmhp,bmhp->bmh", x_, bdh)
        # R's diagonal enters dla twice with opposite signs, and so does
        # dt_last U_last: both are left out rather than added and taken
        # away, which in f32 leaves the rounding of large terms (dt ~ 20).
        strict = r * below[None, :ln, :ln, None]                   # l > m
        col = strict.sum(1)                                        # (B,M,H)
        dtu = dt_ * u
        dla = (torch.einsum("blmh,bmh->blh", strict, dt_) - dt_ * col
               + torch.einsum("bln,blhn->blh", c_, dys))
        dla[:, :-1] -= dtu[:, :-1]
        dla[:, -1] += torch.exp(la_last) * (h_in * dh).sum((2, 3)) \
            + dtu[:, :-1].sum(1)
        cum = torch.flip(torch.cumsum(torch.flip(dla, [1]), 1), [1])
        diag = torch.diagonal(r, dim1=1, dim2=2).transpose(1, 2)   # (B,L,H)
        ddts.append(col + diag + u + a * cum)
        da = da + a * (dt_ * cum).sum((0, 1))
        dh = torch.exp(la_last)[:, :, None, None] * dh \
            + torch.einsum("bln,blh,blhp->bhnp", c_, ela, dy_)
    return (torch.cat(dxs[::-1], 1).to(x.dtype), torch.cat(ddts[::-1], 1),
            da, torch.cat(dbs[::-1], 1).to(bmat.dtype),
            torch.cat(dcs[::-1], 1).to(cmat.dtype))
