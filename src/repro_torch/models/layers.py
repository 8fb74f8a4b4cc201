"""The reference's layers for the dense transformer: RMSNorm, RoPE, the q/k/v
projections, the dense attention block (prefill, training and decode over
a dense per-request cache), the three paged attention blocks, the gated
FFN, embedding, logits and the training losses.

Every weight is cast to the activation dtype at its use, as the reference
casts: training holds f32 master weights and computes in ``cfg.dtype``;
serving stores weights in ``cfg.dtype``, where the cast is a no-op.

Matrix products stay ``torch.matmul`` (the reference leaves them to XLA);
RMSNorm, prefill attention and the paged attention go through the kernels'
``ops`` entries, which launch the CUDA kernels for CUDA tensors and run the
plain versions for CPU tensors (RMSNorm and dense attention with their
backward kernels where a gradient is wanted). Caches are updated IN PLACE:
where the reference returns a new pool or cache (and the engine donates
the old one), the port writes new KV rows into the tensors with indexed
assignment and returns the same objects.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import paged_decode_attention
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention.ref import MASK_VALUE
from ..kernels.kv_quant import quantize_rows
from ..kernels.prefill_attention import paged_prefill_attention
from ..kernels.rmsnorm import rmsnorm as _rmsnorm_op
from ..kernels.verify_attention import paged_verify_attention
from .params import ParamSpec

# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-6):
    """f32 mean square and rsqrt, times the f32 weight, cast back: the fused
    RMSNorm kernel on a CUDA tensor, its plain version on the CPU."""
    return _rmsnorm_op(x, weight, eps)


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
# Dense attention
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, causal: bool = True):
    """Memory-efficient GQA attention, q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) ->
    (B,Sq,H,hd). The reference runs an online softmax over (q_chunk,
    kv_chunk) tiles in XLA; here a CUDA tensor launches the flash-attention
    kernel (the same dataflow, fused) and a CPU tensor takes its plain
    version. Both keep p in f32 where the reference rounds it to v's dtype
    before the PV product: equal in f32, within bf16 rounding otherwise."""
    return flash_attention(q, k, v, causal=causal)


def dense_attention(q, k, v, *, causal: bool = True, q_positions=None,
                    kv_positions=None):
    """O(S^2)-memory attention with the reference's roundings (p cast to
    v's dtype before the PV product): an oracle for tests."""
    b, sq, h, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, h // nkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        / math.sqrt(hd)
    if causal:
        qp = (torch.arange(sq, device=q.device) if q_positions is None
              else q_positions)
        kp = (torch.arange(k.shape[1], device=q.device)
              if kv_positions is None else kv_positions)
        s = torch.where(qp[:, None] >= kp[None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-step attention against a dense KV cache, plain PyTorch (the
    reference's is jnp, outside any kernel).

    q: (B,1,H,hd); caches: (B,Smax,KV,hd); pos: (B,) the new token's
    position; cache rows past it are masked."""
    b, _, h, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(b, nkv, h // nkv, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) \
        / math.sqrt(hd)
    idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = idx[None, :] <= pos[:, None]                         # (B,Smax)
    s = torch.where(mask[:, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", p.float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _scatter_cache(cache, k, v, pos):
    """Write one new (k, v) row per batch element at ``pos``, in place. A
    row at ``pos >= Smax`` is dropped, as the reference's scatter drops it
    (the row at the clamped index is written back unchanged)."""
    k_cache, v_cache = cache
    smax = k_cache.shape[1]
    bidx = torch.arange(k.shape[0], device=k.device)
    idx = pos.long().clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    for c, new in ((k_cache, k), (v_cache, v)):
        c[bidx, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, idx])
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Attention blocks
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
    """x (..., d) @ w (d, *out) -> (..., *out), w cast to x's dtype."""
    w2 = w.to(x.dtype).reshape(w.shape[0], -1)
    return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def _qkv_proj(cfg, p, x, positions):
    """Pre-norm q/k/v projections with RoPE, shared by the paged blocks."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = apply_rope(_proj(xn, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj(xn, p["wk"]), positions, cfg.rope_theta)
    return q, k, _proj(xn, p["wv"])


def _out_proj(o, wo):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d), wo cast to o's dtype."""
    return o.reshape(*o.shape[:2], -1) @ wo.to(o.dtype).reshape(
        -1, wo.shape[-1])


def attention_block(cfg, p, x, positions, *, cache=None, decode_pos=None):
    """Pre-norm attention residual block over a dense cache.

    Prefill: ``cache is None`` -> (y, (k, v)) so prefill can emit the cache.
    Decode: ``cache=(k_cache, v_cache)`` (B,Smax,KV,hd) and ``decode_pos``
    (B,) -> (y, (k_cache, v_cache)), the new row written in place."""
    q, k, v = _qkv_proj(cfg, p, x, positions)
    if cache is None:
        o = chunked_attention(q, k, v,
                              causal=cfg.causal and not cfg.encoder_only)
        new_cache = (k, v)
    else:
        new_cache = _scatter_cache(cache, k, v, decode_pos)
        o = decode_attention(q, *new_cache, decode_pos)
    return x + _out_proj(o, p["wo"]), new_cache


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
    dt = cfg.cdtype
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"].to(dt)
    h = _act(cfg.mlp_act, xn @ p["w_gate"].to(dt)) * up if cfg.mlp_gated \
        else _act(cfg.mlp_act, up)
    return x + h @ p["w_down"].to(dt)


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


def _label_logits(lg, labels):
    """``lg[..., labels]`` as a masked sum over the vocabulary: exact (one
    term is not zero), and its backward is elementwise, where a gather's is
    a scatter-add that deterministic mode refuses on the card."""
    hit = torch.arange(lg.shape[-1], device=lg.device) == labels[..., None]
    return torch.where(hit, lg, 0.0).sum(-1)


def softmax_xent(logits, labels, logit_dtype=torch.float32):
    """Mean token cross-entropy, stats in float32."""
    lg = logits.to(logit_dtype)
    return torch.mean(torch.logsumexp(lg, dim=-1)
                      - _label_logits(lg, labels.long()))


def chunked_xent(cfg, p, x, labels, chunk: int):
    """Loss without materializing full-seq logits: one sequence chunk at a
    time, each chunk's logits recomputed in backward
    (``torch.utils.checkpoint``). Falls back to the whole sequence when the
    chunk does not divide it, as the reference does."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        return softmax_xent(logits_fn(cfg, p, x), labels)

    def one(xs, ys):
        return softmax_xent(logits_fn(cfg, p, xs), ys) * chunk

    parts = [checkpoint(one, x[:, i:i + chunk], labels[:, i:i + chunk],
                        use_reentrant=False) for i in range(0, s, chunk)]
    return torch.stack(parts).sum() / s
