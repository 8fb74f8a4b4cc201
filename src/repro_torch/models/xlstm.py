"""xLSTM blocks (Beck et al., arXiv:2405.04517): alternating mLSTM (matrix
memory, covariance update) and sLSTM (scalar memory, recurrent gates) blocks.

Both use exponential gating with the paper's log-space stabilizer state m.
Prefill and training run the mLSTM in its chunkwise-parallel form and the
sLSTM as a loop over time; decode is the single-step form. The blocks own
their projections (mLSTM: 2x up-projection, sLSTM: a 4/3-factor gated FFN
after the cell), as in the paper.

The matrix products stay ``torch.matmul`` (the reference's ``mlstm_tile``
region is jnp, outside any kernel); the block norms go through the RMSNorm
kernel's ``ops`` entry. A ragged last mLSTM chunk is scanned at its own
length, where the reference requires a multiple of the chunk.

Under the sharded train step (``distributed/collectives.py``) the blocks
take this rank's shards. The mLSTM's ``"mlp"`` width split over "model"
makes its up projections and conv column-parallel and its q, k, v and
gate projections row-parallel (partial sums reduced over "model"); every
model rank then runs the recurrence over all heads, and the output norm's
columns, the gate and the down projection's rows are the rank's again.
The sLSTM runs its rank's heads where they are sharded (the heads are
independent), and its FFN is column- then row-parallel where its width is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import (copy_to, current_sharded, gather,
                                       gather_repeated, reduce_from,
                                       take_block)
from .layers import _proj, norm_spec, rmsnorm
from .params import ParamSpec
from .ssm import _conv1d

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_param_specs(cfg) -> dict:
    """The reference's layout. The gate biases are stored in f32: the
    reference casts them to f32 at every use."""
    d, h = cfg.d_model, cfg.num_heads
    din = 2 * d                     # paper: projection factor 2
    hd = din // h
    return {
        "norm": norm_spec(d),
        "w_up_x": ParamSpec((d, din), ("embed", "mlp")),
        "w_up_z": ParamSpec((d, din), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, din), ("conv", "mlp")),
        "conv_b": ParamSpec((din,), ("mlp",), init="zeros"),
        "wq": ParamSpec((din, h, hd), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((din, h, hd), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((din, h, hd), ("mlp", "heads", "head_dim")),
        "w_i": ParamSpec((din, h), ("mlp", "heads")),
        "w_f": ParamSpec((din, h), ("mlp", "heads")),
        "b_i": ParamSpec((h,), ("heads",), init="zeros", dtype="float32"),
        "b_f": ParamSpec((h,), ("heads",), init="ones", dtype="float32"),
        "out_norm": ParamSpec((din,), ("mlp",), init="ones",
                              dtype="float32"),
        "w_down": ParamSpec((din, d), ("mlp", "embed")),
    }


def _mlstm_state(b, h, hd, device, state):
    if state is None:
        return (torch.zeros((b, h, hd, hd), device=device),
                torch.zeros((b, h, hd), device=device),
                torch.full((b, h), -1e30, device=device))
    return tuple(x.float() for x in state)


def mlstm_scan(q, k, v, log_i, log_f, state=None):
    """Stabilized mLSTM recurrence over time.

    q,k,v: (B,S,H,hd); log_i/log_f: (B,S,H).
    state: None or (C:(B,H,hd,hd), n:(B,H,hd), m:(B,H)).
    Returns (h: (B,S,H,hd) in q's dtype, final state in f32).
    """
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    c, n, m = _mlstm_state(b, h, hd, q.device, state)
    hs = []
    for t in range(s):
        li, lf = log_i[:, t], log_f[:, t]                        # (B,H)
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        kt = k[:, t].float() * scale
        c = f_[..., None, None] * c + i_[..., None, None] * (
            v[:, t].float()[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        qf = q[:, t].float()
        num = (c @ qf[..., None])[..., 0]                        # (B,H,hd)
        den = torch.maximum((n * qf).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), (c, n, m)


def _mlstm_chunk(c, n, m, q, k, v, li, lf, scale):
    """One chunk of L rows. c: (B,H,hd,hd), n: (B,H,hd), m: (B,H); q/k/v:
    (B,H,L,hd) f32; li/lf: (B,H,L). Returns (h (B,H,L,hd), c, n, m)."""
    ln = q.shape[2]
    tri = torch.ones((ln, ln), dtype=torch.bool, device=q.device).tril()
    # inclusive cumulative sum as a product with the lower triangle: CUDA's
    # cumsum is refused under torch.use_deterministic_algorithms
    bcum = (tri.to(lf.dtype) @ lf[..., None])[..., 0]            # (B,H,L)
    # intra-chunk log weights: b_l - b_m + li_m   (l >= m)
    g = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
    g = torch.where(tri, g, float("-inf"))                       # (B,H,L,M)
    m_intra = g.amax(dim=-1)                                     # (B,H,L)
    m_l = torch.maximum(m[..., None] + bcum, m_intra)
    d_intra = torch.exp(g - m_l[..., None])
    d_inter = torch.exp(bcum + m[..., None] - m_l)               # (B,H,L)

    w = (q @ k.transpose(-1, -2)) * scale * d_intra              # (B,H,L,M)
    num = w @ v + d_inter[..., None] * (q @ c.transpose(-1, -2))
    den = w.sum(-1) + d_inter * (q @ n[..., None])[..., 0]
    hout = num / torch.maximum(den.abs(), torch.exp(-m_l))[..., None]

    # chunk-boundary state update; the reference's three-operand einsum
    # "blh,blhv,blhk->bhvk" as one batched product over the chunk's rows
    b_last = bcum[..., -1]                                       # (B,H)
    g_last = b_last[..., None] - bcum + li                       # (B,H,L)
    m_next = torch.maximum(m + b_last, g_last.amax(dim=-1))
    w_state = torch.exp(g_last - m_next[..., None])[..., None]   # (B,H,L,1)
    kf = k * scale
    decay = torch.exp(m + b_last - m_next)
    c_new = decay[..., None, None] * c + (w_state * v).transpose(-1, -2) @ kf
    n_new = decay[..., None] * n + (w_state * kf).sum(-2)
    return hout, c_new, n_new, m_next


def mlstm_chunked(q, k, v, log_i, log_f, state=None, chunk: int = 64):
    """Chunkwise-parallel mLSTM (the paper's training form; GLA-style):
    the math of :func:`mlstm_scan` with an (L,L) decay-masked intra-chunk
    contraction and (C, n, m) carried across chunks. When S is not a
    multiple of ``chunk`` the last chunk is shorter; the reference raises
    there."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    c, n, m = _mlstm_state(b, h, hd, q.device, state)
    # (B,S,H,...) -> (B,H,S,...), the products in f32 as the reference's
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    lif, lff = log_i.transpose(1, 2), log_f.transpose(1, 2)
    hs = []
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        hout, c, n, m = _mlstm_chunk(c, n, m, qf[:, :, sl], kf[:, :, sl],
                                     vf[:, :, sl], lif[..., sl], lff[..., sl],
                                     scale)
        hs.append(hout.to(q.dtype))
    return torch.cat(hs, dim=2).transpose(1, 2), (c, n, m)


def _mlstm_sharded(cfg, p, x):
    """The training block under the sharded step (module docstring); ``p``
    is this rank's shards, whole over "data". The normed input enters the
    column-parallel up projections through ``copy_to``; every model rank
    runs the recurrence and the output norm (its statistic spans the
    width, its weight gathered whole) on the whole output, and
    ``take_block`` hands the rank's columns to the gate and the
    row-parallel down projection. Where the ``"mlp"`` width stays whole,
    the replicated block runs on every model rank."""
    sh, specs = current_sharded(), mlstm_param_specs(cfg)
    if not sh.split(specs["w_up_x"], 1):
        return _mlstm_block(cfg, {k: sh.model_whole(v, specs[k],
                                                     repeated=True)
                                  for k, v in p.items()}, x, None)[0]
    dt_ = cfg.cdtype
    group = sh.group("model")
    xn = copy_to(rmsnorm(x, p["norm"], cfg.norm_eps), group)
    xin = xn @ p["w_up_x"].to(dt_)
    z = xn @ p["w_up_z"].to(dt_)
    conv_out, _ = _conv1d(xin, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    q = reduce_from(_proj(conv_out, p["wq"]), group)
    k = reduce_from(_proj(conv_out, p["wk"]), group)
    v = reduce_from(_proj(xin, p["wv"]), group)
    b_i, b_f = (sh.model_whole(p[n], specs[n], repeated=True)
                for n in ("b_i", "b_f"))
    log_i = reduce_from(conv_out @ p["w_i"].to(dt_), group).float() \
        + b_i.float()
    log_f = F.logsigmoid(reduce_from(conv_out @ p["w_f"].to(dt_),
                                     group).float() + b_f.float())
    hs, _ = mlstm_chunked(q, k, v, log_i, log_f, None, min(64, q.shape[1]))
    hs = rmsnorm(hs.reshape(*hs.shape[:2], -1),
                 sh.model_whole(p["out_norm"], specs["out_norm"],
                                repeated=True), cfg.norm_eps)
    hs = take_block(hs, hs.ndim - 1, group)
    out = (hs * F.silu(z)) @ p["w_down"].to(dt_)
    return x + reduce_from(out, group)


def mlstm_block(cfg, p, x, *, cache=None):
    """Pre-norm mLSTM residual block. cache: None (prefill from scratch) or
    dict(conv, C, n, m); returns (y, new_cache). Under the sharded step
    (``cache`` None) the sharded block, whose result is ``(y, None)``."""
    if cache is None and current_sharded() is not None:
        return _mlstm_sharded(cfg, p, x), None
    return _mlstm_block(cfg, p, x, cache)


def _mlstm_block(cfg, p, x, cache):
    dt_ = cfg.cdtype
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    xin = xn @ p["w_up_x"].to(dt_)
    z = xn @ p["w_up_z"].to(dt_)
    conv_out, conv_cache = _conv1d(xin, p["conv_w"].to(dt_),
                                   p["conv_b"].to(dt_),
                                   None if cache is None else cache["conv"])
    q = _proj(conv_out, p["wq"])
    k = _proj(conv_out, p["wk"])
    v = _proj(xin, p["wv"])
    log_i = (conv_out @ p["w_i"].to(dt_)).float() + p["b_i"].float()
    log_f = F.logsigmoid((conv_out @ p["w_f"].to(dt_)).float()
                         + p["b_f"].float())

    state = None if cache is None else (cache["C"], cache["n"], cache["m"])
    if q.shape[1] > 1:
        hs, (c, n, m) = mlstm_chunked(q, k, v, log_i, log_f, state,
                                      min(64, q.shape[1]))
    else:
        hs, (c, n, m) = mlstm_scan(q, k, v, log_i, log_f, state)
    hs = hs.reshape(*hs.shape[:2], -1)
    hs = rmsnorm(hs, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = hs @ p["w_down"].to(dt_)
    return x + out, {"conv": conv_cache.to(dt_), "C": c, "n": n, "m": m}


#: The logical axes of one mLSTM block's decode-cache leaves.
MLSTM_CACHE_AXES = {"conv": ("batch", None, "mlp"),
                    "C": ("batch", "heads", None, None),
                    "n": ("batch", "heads", None),
                    "m": ("batch", "heads")}


def mlstm_cache_shapes(cfg, batch: int) -> dict:
    """Decode-cache shapes and dtypes for one mLSTM block."""
    h = cfg.num_heads
    din = 2 * cfg.d_model
    hd = din // h
    return {
        "conv": ((batch, cfg.ssm_conv - 1, din), cfg.cdtype),
        "C": ((batch, h, hd, hd), torch.float32),
        "n": ((batch, h, hd), torch.float32),
        "m": ((batch, h), torch.float32),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_param_specs(cfg) -> dict:
    """The reference's layout. The recurrent weights and gate biases are
    stored in f32: the reference casts them to f32 at every use."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    f = int(d * 8 / 3) // 64 * 64   # post-cell GLU FFN, 4/3 factor x 2
    return {
        "norm": norm_spec(d),
        # input weights for the four gates (z, i, f, o)
        "w_gates": ParamSpec((d, 4, h, hd),
                             ("embed", None, "heads", "head_dim")),
        # block-diagonal recurrent weights per head, per gate
        "r_gates": ParamSpec((4, h, hd, hd),
                             (None, "heads", "head_dim", None),
                             dtype="float32"),
        "b_gates": ParamSpec((4, h, hd), (None, "heads", "head_dim"),
                             init="zeros", dtype="float32"),
        "ffn_gate": ParamSpec((d, f), ("embed", "mlp")),
        "ffn_up": ParamSpec((d, f), ("embed", "mlp")),
        "ffn_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def slstm_scan(gates_in, r, b, state=None):
    """sLSTM recurrence. gates_in: (B,S,4,H,hd); r: (4,H,hd,hd); b:
    (4,H,hd). Returns (h: (B,S,H,hd) f32, state (c, n, m, h) each (B,H,hd)
    f32).

    The loop runs head-major, (H,B,...): a step's block-diagonal
    recurrent product "bhk,ghkj->bghj" and its gate inputs are one batched
    product, (H,B,hd) @ (H,hd,4*hd) added to (H,B,4*hd)."""
    bsz, s, _, h, hd = gates_in.shape
    if state is None:
        zeros = torch.zeros((h, bsz, hd), device=gates_in.device)
        c, n, m, h_prev = zeros, zeros + 1e-6, zeros - 1e30, zeros
    else:
        c, n, m, h_prev = (x.float().transpose(0, 1) for x in state)
    r2 = r.float().permute(1, 2, 0, 3).reshape(h, hd, 4 * hd)
    pre_in = (gates_in.float() + b.float()).permute(1, 3, 0, 2, 4).reshape(
        s, h, bsz, 4 * hd)
    hs = []
    for pre_t in pre_in.unbind(0):
        z, i, f, o = torch.baddbmm(pre_t, h_prev, r2).view(
            h, bsz, 4, hd).unbind(2)
        lf_m = F.logsigmoid(f) + m
        m_new = torch.maximum(lf_m, i)
        i_ = torch.exp(i - m_new)
        f_ = torch.exp(lf_m - m_new)
        c = f_ * c + i_ * torch.tanh(z)
        n = f_ * n + i_
        h_prev = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h_prev)
    return (torch.stack(hs).permute(2, 0, 1, 3),
            tuple(x.transpose(0, 1) for x in (c, n, m, h_prev)))


def slstm_block(cfg, p, x, *, cache=None):
    """Pre-norm sLSTM residual block with its gated FFN. cache: None or
    dict(c, n, m, h); returns (y, new_cache).

    Under the sharded step (``cache`` None; ``p`` this rank's shards,
    whole over "data"; the result ``(y, None)``): where the heads are
    sharded over "model" the rank runs its heads' recurrence from the
    normed input through ``copy_to``, and its output is gathered once for
    each use: for the residual, which every model rank repeats, its
    gradient the rank's block (``gather_repeated``), and for an FFN whose
    width is sharded, which the ranks partition, its gradient summed
    (``gather``). With the heads whole the output enters a sharded FFN
    through ``copy_to``; a sharded FFN's partial sums are reduced."""
    dt_ = cfg.cdtype
    sh = current_sharded() if cache is None else None
    heads = ffn = None
    if sh is not None:
        specs = slstm_param_specs(cfg)
        if sh.split(specs["w_gates"], 2):
            heads = sh.group("model")
        if sh.split(specs["ffn_gate"], 1):
            ffn = sh.group("model")
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if heads is not None:
        xn = copy_to(xn, heads)
    gates_in = _proj(xn, p["w_gates"])                      # (B,S,4,H,hd)
    state = (None if cache is None else
             (cache["c"], cache["n"], cache["m"], cache["h"]))
    hs, (c, n, m, hl) = slstm_scan(gates_in, p["r_gates"], p["b_gates"],
                                   state)
    hs = hs.reshape(*hs.shape[:2], -1).to(dt_)
    res = hs_ffn = hs
    if heads is not None:
        res = hs_ffn = gather_repeated(hs, hs.ndim - 1, heads)
        if ffn is not None:
            hs_ffn = gather(hs, hs.ndim - 1, heads)
    elif ffn is not None:
        hs_ffn = copy_to(hs, ffn)
    y = x + res
    # gated FFN (GLU, 4/3 factor)
    gate = hs_ffn @ p["ffn_gate"].to(dt_)
    up = hs_ffn @ p["ffn_up"].to(dt_)
    hf = F.gelu(gate, approximate="tanh") * up
    down = hf @ p["ffn_down"].to(dt_)
    y = y + (down if ffn is None else reduce_from(down, ffn))
    if sh is not None:
        return y, None
    return y, {"c": c, "n": n, "m": m, "h": hl}


#: The logical axes of one sLSTM block's decode-cache leaves.
SLSTM_CACHE_AXES = {k: ("batch", "heads", None) for k in ("c", "n", "m", "h")}


def slstm_cache_shapes(cfg, batch: int) -> dict:
    """Decode-cache shapes and dtypes for one sLSTM block."""
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    shp = ((batch, h, hd), torch.float32)
    return {"c": shp, "n": shp, "m": shp, "h": shp}
