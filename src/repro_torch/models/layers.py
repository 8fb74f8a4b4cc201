"""The serving subset of the reference's layers: RMSNorm, RoPE, the q/k/v
projections, the three paged attention blocks, the gated FFN, embedding and
logits.

Matrix products stay ``torch.matmul`` (the reference leaves them to XLA);
attention goes through the paged kernels' ``ops`` entries, which launch the
CUDA kernels for CUDA tensors and run the plain versions for CPU tensors.
The pool is updated IN PLACE: where the reference returns a new pool (and
the engine donates the old one), the port writes new KV rows into the
pool's tensors with indexed assignment and returns the same dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import paged_decode_attention
from ..kernels.kv_quant import quantize_rows
from ..kernels.prefill_attention import paged_prefill_attention
from ..kernels.verify_attention import paged_verify_attention
from .params import ParamSpec

# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-6):
    """f32 mean square and rsqrt, times the f32 weight, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="ones", dtype="float32")


def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates the
    two halves of hd (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention blocks over the paged pool
# ---------------------------------------------------------------------------


def attention_param_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d)),
        "norm": norm_spec(d),
    }


def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _qkv_proj(cfg, p, x, positions):
    """Pre-norm q/k/v projections with RoPE, shared by the paged blocks."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = apply_rope(_proj(xn, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj(xn, p["wk"]), positions, cfg.rope_theta)
    return q, k, _proj(xn, p["wv"])


def _out_proj(o, wo):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _scatter_pool(pool, name, rows, page, off):
    """Write KV rows into one pool leaf in place, quantizing for int8 pools.

    pool: this layer's pool dict, ``{"k","v"}`` (KV,P,ps,hd) plus
    ``{"k_scale","v_scale"}`` (KV,P,ps) for an int8 pool; rows: (KV, ...,
    hd); page/off: matching (...,) integer index tensors.
    """
    scale_name = name + "_scale"
    if scale_name in pool:
        q8, s = quantize_rows(rows)
        pool[name][:, page, off] = q8
        pool[scale_name][:, page, off] = s
    else:
        pool[name][:, page, off] = rows.to(pool[name].dtype)
    return pool


def _pool_scales(pool):
    return dict(k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))


def _table_pages(page_table, positions, ps):
    """``page_table[b, positions // ps]`` with the logical page clamped to
    the table's width, as the reference's gather clamps (torch would raise
    on CPU and assert on the device)."""
    npages = page_table.shape[1]
    bidx = torch.arange(page_table.shape[0], device=page_table.device)
    bidx = bidx.reshape(-1, *([1] * (positions.dim() - 1)))
    return page_table[bidx, (positions // ps).clamp(0, npages - 1)].long()


def paged_attention_block(cfg, p, x, *, pool, page_table, pos):
    """Decode: x (B,1,d) at positions ``pos`` (B,). The new KV row is written
    at ``page_table[b, pos // ps]``, offset ``pos % ps``, BEFORE attention,
    which then runs over ``lengths = pos + 1``. Returns (y, pool)."""
    ps = pool["k"].shape[2]
    q, k, v = _qkv_proj(cfg, p, x, pos[:, None])
    page = _table_pages(page_table, pos, ps)                      # (B,)
    off = (pos % ps).long()
    # (B,1,KV,hd) -> (KV,B,hd) rows written at [kv, page_b, off_b].
    _scatter_pool(pool, "k", k[:, 0].transpose(0, 1), page, off)
    _scatter_pool(pool, "v", v[:, 0].transpose(0, 1), page, off)
    o = paged_decode_attention(q[:, 0], pool["k"], pool["v"], page_table,
                               pos + 1, **_pool_scales(pool),
                               split_budget=cfg.decode_split_budget)
    return x + _out_proj(o[:, None], p["wo"]), pool


def paged_verify_attention_block(cfg, p, x, *, pool, page_table, pos,
                                 write_limit):
    """Speculative verify: x (B,T,d) at positions ``pos .. pos+T-1``. KV
    writes at positions >= ``write_limit`` go to the sink page 0, so a window
    past the slot's budget cannot clobber live or shared pages. Returns
    (y, pool)."""
    t = x.shape[1]
    ps = pool["k"].shape[2]
    positions = pos[:, None] + torch.arange(t, device=x.device)[None]
    q, k, v = _qkv_proj(cfg, p, x, positions)
    valid = positions < write_limit[:, None]                      # (B, T)
    page = torch.where(valid, _table_pages(page_table, positions, ps), 0)
    off = (positions % ps).long()
    # (B,T,KV,hd) -> (KV,B,T,hd) rows written at [kv, page_bt, off_bt].
    _scatter_pool(pool, "k", k.permute(2, 0, 1, 3), page, off)
    _scatter_pool(pool, "v", v.permute(2, 0, 1, 3), page, off)
    o = paged_verify_attention(q, pool["k"], pool["v"], page_table, pos,
                               **_pool_scales(pool),
                               split_budget=cfg.decode_split_budget)
    return x + _out_proj(o, p["wo"]), pool


def paged_prefill_attention_block(cfg, p, x, *, pool, page_table, q_start,
                                  kv_len):
    """One prefill chunk: x (B,C,d) at positions ``q_start .. q_start+C-1``.
    Positions >= ``kv_len`` (the prompt length) are padding and write to the
    sink page 0. Returns (y, pool)."""
    c = x.shape[1]
    ps = pool["k"].shape[2]
    positions = q_start[:, None] + torch.arange(c, device=x.device)[None]
    q, k, v = _qkv_proj(cfg, p, x, positions)
    valid = positions < kv_len[:, None]                           # (B, C)
    page = torch.where(valid, _table_pages(page_table, positions, ps), 0)
    off = (positions % ps).long()
    _scatter_pool(pool, "k", k.permute(2, 0, 1, 3), page, off)
    _scatter_pool(pool, "v", v.permute(2, 0, 1, 3), page, off)
    o = paged_prefill_attention(q, pool["k"], pool["v"], page_table, q_start,
                                **_pool_scales(pool))
    return x + _out_proj(o, p["wo"]), pool


# ---------------------------------------------------------------------------
# FFN, embedding, logits
# ---------------------------------------------------------------------------


def mlp_param_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    specs = {"w_up": ParamSpec((d, f)), "w_down": ParamSpec((f, d)),
             "norm": norm_spec(d)}
    if cfg.mlp_gated:
        specs["w_gate"] = ParamSpec((d, f))
    return specs


def _act(name: str, x):
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp_block(cfg, p, x):
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"]
    h = _act(cfg.mlp_act, xn @ p["w_gate"]) * up if cfg.mlp_gated \
        else _act(cfg.mlp_act, up)
    return x + h @ p["w_down"]


def embed_param_specs(cfg) -> dict:
    specs = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                    init="embed")}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    return specs


def embed_tokens(cfg, p, tokens):
    return p["embedding"].to(cfg.cdtype)[tokens.long()]


def logits_fn(cfg, p, x):
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w.to(cfg.cdtype)
