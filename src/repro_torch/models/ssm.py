"""Mamba2 (state-space duality / SSD) blocks.

Prefill runs the chunked SSD algorithm (Dao & Gu, arXiv:2405.21060) through
the scan op: on a CUDA tensor the hand-written SSD kernel, on the CPU its
plain chunked version. Decode keeps the recurrent state h (B,H,N,P) plus a
short-conv tail and steps it in plain PyTorch, as the reference does in jnp.

Single SSM parameter group (n_groups=1): B/C projections are shared across
heads, as in the released Mamba2 models.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_chunk_scan
from .layers import norm_spec, rmsnorm
from .params import ParamSpec


def mamba_param_specs(cfg) -> dict:
    """The reference's layout. ``dt_bias``, ``A_log`` and ``D`` are stored
    in f32: the reference leaves their dtype unset (f32 parameters) and casts
    them to f32 at every use; the port would otherwise store them in
    ``cfg.dtype``. ``conv_w``/``conv_b`` are cast to ``cfg.dtype`` at use, so
    storing them in it is the same."""
    d, din = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n  # conv over (x, B, C) as in Mamba2
    return {
        "norm": norm_spec(d),
        "w_in": ParamSpec((d, 2 * din + 2 * n + h)),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch)),
        "conv_b": ParamSpec((conv_ch,), init="zeros"),
        "dt_bias": ParamSpec((h,), init="zeros", dtype="float32"),
        "A_log": ParamSpec((h,), init="ones", dtype="float32"),
        "D": ParamSpec((h,), init="ones", dtype="float32"),
        "gate_norm": ParamSpec((din,), init="ones", dtype="float32"),
        "w_out": ParamSpec((din, d)),
    }


def _split_in(cfg, proj):
    """Split the fused input projection into (z, x, B, C, dt)."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [din, din, n, n, h], dim=-1)


def _conv1d(seq, w, b, cache=None):
    """Causal depthwise conv. seq: (B,S,C); w: (K,C); cache: (B,K-1,C).
    Returns (silu(out), the last K-1 rows of [cache | seq])."""
    k = w.shape[0]
    if cache is None:
        pad = seq.new_zeros((seq.shape[0], k - 1, seq.shape[2]))
    else:
        pad = cache.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    out = sum(full[:, i:i + seq.shape[1]] * w[i] for i in range(k)) + b
    new_cache = full[:, full.shape[1] - (k - 1):]
    return F.silu(out), new_cache


def ssd_chunked(xh, dt, a_log, bmat, cmat, d_skip, chunk: int):
    """Chunked SSD scan from a zero state, plus the D-skip.

    xh: (B,S,H,P); dt: (B,S,H) positive step sizes; a_log: (H,), A =
    -exp(a_log); bmat/cmat: (B,S,N) shared across heads. The scan's y comes
    back in xh's dtype (each chunk cast, as the reference casts it); the
    D-skip is added in f32 and cast again. Returns (y (B,S,H,P),
    h_final (B,H,N,P) f32). When S is not a multiple of ``chunk`` the last
    chunk is shorter; the reference asserts a multiple (models/ssm.py) and
    so cannot prefill those lengths.
    """
    y, h_final = mamba_chunk_scan(xh, dt, a_log, bmat, cmat, chunk=chunk)
    y = y.float() + d_skip.float()[None, None, :, None] * xh.float()
    return y.to(xh.dtype), h_final


def ssd_step(xh, dt, a_log, bmat, cmat, d_skip, h_prev):
    """Single decode step. xh: (B,1,H,P); h_prev: (B,H,N,P)."""
    a = -torch.exp(a_log.float())
    dtf = dt[:, 0].float()                                       # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dtf, bmat[:, 0].float(),
                       xh[:, 0].float())
    h_new = torch.exp(dtf * a)[:, :, None, None] * h_prev.float() + upd
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h_new)
    y = y + d_skip.float()[None, :, None] * xh[:, 0].float()
    return y[:, None].to(xh.dtype), h_new


def mamba_block(cfg, p, x, *, cache=None):
    """Pre-norm Mamba2 residual block.

    cache: None (prefill from scratch) or dict(conv=(B,K-1,C), ssm=(B,H,N,P))
    for decode; returns (y, new_cache)."""
    dt_ = cfg.cdtype
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    proj = xn @ p["w_in"].to(dt_)
    z, xs, bmat, cmat, dtp = _split_in(cfg, proj)

    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out, conv_cache = _conv1d(conv_in, p["conv_w"].to(dt_),
                                   p["conv_b"].to(dt_),
                                   None if cache is None else cache["conv"])
    xs, bmat, cmat = torch.split(conv_out, [din, n, n], dim=-1)

    dtv = F.softplus(dtp.float() + p["dt_bias"].float())         # (B,S,H)
    xh = xs.reshape(*xs.shape[:2], h, cfg.ssm_headdim)
    if cache is None:
        y, h_final = ssd_chunked(xh, dtv, p["A_log"], bmat, cmat, p["D"],
                                 min(cfg.ssm_chunk, xs.shape[1]))
    else:
        y, h_final = ssd_step(xh, dtv, p["A_log"], bmat, cmat, p["D"],
                              cache["ssm"])

    y = y.reshape(*y.shape[:2], din)
    # gated RMSNorm (Mamba2's norm-before-out with SiLU(z) gate)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(dt_)
    return x + out, {"conv": conv_cache.to(dt_), "ssm": h_final}


def mamba_cache_shapes(cfg, batch: int) -> dict:
    """Decode-cache shapes and dtypes for one layer (before stacking)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_ch), cfg.cdtype),
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                torch.float32),
    }
