"""Mamba2 (state-space duality / SSD) blocks.

Training and prefill run the chunked SSD algorithm (Dao & Gu,
arXiv:2405.21060) through the scan op: on a CUDA tensor the hand-written
SSD kernel, differentiated by the port's backward kernel where a gradient
is wanted, on the CPU its plain chunked version under autograd. The
D-skip, conv, softplus and gate stay plain torch under autograd, as in the
reference. Decode keeps the recurrent state h (B,H,N,P) plus a short-conv
tail and steps it in plain PyTorch, as the reference does in jnp.

Single SSM parameter group (n_groups=1): B/C projections are shared across
heads, as in the released Mamba2 models.

Under the sharded train step (``distributed/collectives.py``) the block
takes this rank's shards, and the compute split follows the placements,
not the mesh: where the ``ssm_heads`` leaves are sharded over "model" the
rank runs the SSD over its heads, on its z, x and dt columns and the whole
B and C, else every model rank runs all of them; the gated RMSNorm spans
all of ``d_inner``, so it runs on whole rows (the gated activation
gathered over "model"), and the output projection is row-parallel over
the rank's block of ``w_out``'s rows (``_mamba_sharded``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import (copy_to, current_sharded,
                                       gather_repeated, reduce_from,
                                       take_block)
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
        "w_in": ParamSpec((d, 2 * din + 2 * n + h), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), ("conv", "mlp")),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), init="zeros"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros",
                             dtype="float32"),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="ones",
                           dtype="float32"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "gate_norm": ParamSpec((din,), ("mlp",), init="ones",
                               dtype="float32"),
        "w_out": ParamSpec((din, d), ("mlp", "embed")),
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


class _Take(torch.autograd.Function):
    """The blocks ``pieces`` ((start, length), ...) of ``x`` along ``dim``,
    concatenated; backward one zero-filled gradient of ``x`` with each
    block's gradient copied into its place (disjoint: no sums)."""

    @staticmethod
    def forward(ctx, x, dim, pieces):
        ctx.dim, ctx.pieces, ctx.shape = dim, pieces, x.shape
        return torch.cat([x.narrow(dim, a, n) for a, n in pieces], dim)

    @staticmethod
    def backward(ctx, g):
        out, at = g.new_zeros(ctx.shape), 0
        for a, n in ctx.pieces:
            out.narrow(ctx.dim, a, n).copy_(g.narrow(ctx.dim, at, n))
            at += n
        return out, None, None


def take(x, dim: int, pieces):
    """``_Take``, or ``x`` itself where ``pieces`` cover it in order (one
    rank's split: the replicated block's ops)."""
    at = 0
    for a, n in pieces:
        if a != at:
            return _Take.apply(x, dim, tuple(pieces))
        at += n
    return x if at == x.shape[dim] else _Take.apply(x, dim, tuple(pieces))


def _mamba_sharded(cfg, p, x):
    """The training block under the sharded step (module docstring); ``p``
    is this rank's shards, whole over "data". The heads' leaves decide the
    split: sharded, the rank's heads, with the normed input entering
    through ``copy_to`` and every leaf whose blocks do not follow the heads
    made whole over "model" with their gradients summed
    (``ShardedParams.model_whole``), the gated activation then gathered;
    whole, every model rank repeats the SSD and the leaves are gathered
    without a sum. Either way every rank runs the gated norm on whole rows
    and ``take_block`` hands its columns to the row-parallel ``w_out``.
    Where ``w_out``'s rows stay whole too, the replicated block runs on
    every model rank."""
    sh, specs = current_sharded(), mamba_param_specs(cfg)
    if not sh.split(specs["w_out"], 0):
        return _mamba_block(cfg, {k: sh.model_whole(v, specs[k],
                                                     repeated=True)
                                  for k, v in p.items()}, x, None)[0]
    dt_ = cfg.cdtype
    group, rank = sh.group("model"), sh.coord("model")
    din, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    heads_split = sh.split(specs["dt_bias"], 0)
    hl = p["dt_bias"].shape[0]          # this rank's heads
    d0, dl = rank * hl * hd if heads_split else 0, hl * hd
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if heads_split:
        xn = copy_to(xn, group)
    rep = not heads_split
    # z, x, B, C and dt columns of the fused projection; x, B and C channels
    # of the conv
    w_in = take(sh.model_whole(p["w_in"], specs["w_in"], repeated=rep), 1,
                ((d0, dl), (din + d0, dl), (2 * din, 2 * n),
                 (2 * din + 2 * n + d0 // hd, hl)))
    channels = ((d0, dl), (din, 2 * n))
    conv_w = take(sh.model_whole(p["conv_w"], specs["conv_w"], repeated=rep),
                  1, channels)
    conv_b = take(sh.model_whole(p["conv_b"], specs["conv_b"], repeated=rep),
                  0, channels)
    z, xs, bmat, cmat, dtp = torch.split(xn @ w_in.to(dt_),
                                         [dl, dl, n, n, hl], dim=-1)
    conv_out, _ = _conv1d(torch.cat([xs, bmat, cmat], dim=-1),
                          conv_w.to(dt_), conv_b.to(dt_))
    xs, bmat, cmat = torch.split(conv_out, [dl, n, n], dim=-1)
    dtv = F.softplus(dtp.float() + p["dt_bias"].float())
    xh = xs.reshape(*xs.shape[:2], hl, hd)
    y, _ = ssd_chunked(xh, dtv, p["A_log"], bmat, cmat, p["D"],
                       min(cfg.ssm_chunk, xs.shape[1]))
    g = y.reshape(*y.shape[:2], dl) * F.silu(z)
    if heads_split:
        g = gather_repeated(g, g.ndim - 1, group)
    y = rmsnorm(g, sh.model_whole(p["gate_norm"], specs["gate_norm"],
                                  repeated=True), cfg.norm_eps)
    y = take_block(y, y.ndim - 1, group)
    return x + reduce_from(y @ p["w_out"].to(dt_), group)


def mamba_block(cfg, p, x, *, cache=None):
    """Pre-norm Mamba2 residual block.

    cache: None (train/prefill from scratch) or dict(conv=(B,K-1,C),
    ssm=(B,H,N,P)) for decode; returns (y, new_cache). Under the sharded
    step (``cache`` None) the sharded block, whose result is ``(y, None)``:
    training keeps no cache."""
    if cache is None and current_sharded() is not None:
        return _mamba_sharded(cfg, p, x), None
    return _mamba_block(cfg, p, x, cache)


def _mamba_block(cfg, p, x, cache):
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


#: The logical axes of one layer's decode-cache leaves (before stacking).
MAMBA_CACHE_AXES = {"conv": ("batch", None, "mlp"),
                    "ssm": ("batch", "ssm_heads", None, None)}


def mamba_cache_shapes(cfg, batch: int) -> dict:
    """Decode-cache shapes and dtypes for one layer (before stacking)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_ch), cfg.cdtype),
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                torch.float32),
    }
