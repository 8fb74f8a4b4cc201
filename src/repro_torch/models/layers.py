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

Under the sharded steps (``distributed/collectives.py``'s
``activate_sharded``) the training and prefill functions take this rank's
weights, placed by each leaf's spec: the attention block projects the
rank's query heads and, where the KV heads are whole over ``"model"``,
only the KV head its query heads use (a head count that the model
dimension does not divide runs the whole block on every model rank; the
prefill projects every KV head, for its cache); the FFN is column- then
row-parallel; the embedding lookup, the logits and the cross-entropy are
vocab-parallel. Where a dimension stays whole the function is the
replicated one, op for op. The sharded decode step's attention runs over
this rank's block of a cache split by sequence (``CacheBlock``): each
rank's partial softmax over its positions, combined over the sequence's
ranks (``combine_partials``), and the new K/V row written only by the
rank whose block holds its position; ``global_argmax`` takes the greedy
token over vocab-parallel logits.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import (activate_batch_split,
                                       activate_sharded, all_gather_dim,
                                       all_max, copy_to, current_batch_split,
                                       current_sharded, reduce_from)
from ..distributed.ring_attention import ring_attention_sharded
from ..distributed.sharding import activate_rules, current_rules
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
    return ParamSpec((d,), ("embed",), init="ones", dtype="float32")


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


def _decode_softmax_pv(q, k_cache, v_cache, pos, start: int = 0):
    """The decode softmax and PV over cache rows at global positions
    ``start``, ``start + 1``, ...: the masked scores s (B,KV,G,Smax) f32
    (rows past ``pos`` out) and the attention (B,KV,G,hd) f32, p cast to
    v's dtype before the product as the reference casts it."""
    b, _, h, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(b, nkv, h // nkv, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) \
        / math.sqrt(hd)
    idx = start + torch.arange(k_cache.shape[1], device=q.device)
    mask = idx[None, :] <= pos[:, None]                         # (B,Smax)
    s = torch.where(mask[:, None, None, :], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return s, torch.einsum("bkgs,bskh->bkgh", p.float(), v_cache.float())


def decode_attention(q, k_cache, v_cache, pos):
    """Single-step attention against a dense KV cache, plain PyTorch (the
    reference's is jnp, outside any kernel).

    q: (B,1,H,hd); caches: (B,Smax,KV,hd); pos: (B,) the new token's
    position; cache rows past it are masked."""
    _, out = _decode_softmax_pv(q, k_cache, v_cache, pos)
    return out.reshape(q.shape).to(q.dtype)


def _scatter_cache(cache, k, v, pos, start: int = 0):
    """Write one new (k, v) row per batch element at ``pos``, in place,
    into a cache whose first row is global position ``start`` (a block of
    a cache split by sequence). A row outside the block (``pos >= Smax``,
    or another rank's block) is dropped, as the reference's scatter drops
    one past the cache: the row at the clamped index is written back
    unchanged, with no host sync."""
    k_cache, v_cache = cache
    smax = k_cache.shape[1]
    bidx = torch.arange(k.shape[0], device=k.device)
    local = pos.long() - start
    idx = local.clamp(0, smax - 1)
    keep = ((local >= 0) & (local < smax))[:, None, None]
    for c, new in ((k_cache, k), (v_cache, v)):
        c[bidx, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, idx])
    return k_cache, v_cache


class CacheBlock(NamedTuple):
    """This rank's block of a dense (L, B, Smax, KV, hd) decode cache under
    the sharded decode step: the process groups its sequence is split over
    (the first dimension major; none where it is whole), the first global
    position of its block, and whether its KV heads are split over
    ``"model"``."""
    seq_groups: tuple
    seq_start: int
    kv_split: bool


def decode_attention_partial(q, k_cache, v_cache, pos, start: int):
    """One rank's part of ``decode_attention`` over its block of the cache,
    whose first row is global position ``start``: (row max m, row sum of
    exp(s - m) l, the block's attention o), m and l (B,KV,G) f32, o
    (B,KV,G,hd) f32 (``_decode_softmax_pv`` over the block, the mask in
    global positions). A block wholly past ``pos`` has m = MASK_VALUE,
    which the combine weighs by exp(MASK_VALUE - max) = 0 (position 0 is
    never masked)."""
    s, o = _decode_softmax_pv(q, k_cache, v_cache, pos, start)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1), o


def combine_partials(m, l, o, groups):
    """The attention output (B,KV,G,hd) f32 from every rank's
    ``decode_attention_partial`` over ``groups`` (the cache's sequence
    split, the first dimension major), as a split-KV decode combines its
    splits: the partials are all-gathered (one collective a group) and
    summed in rank order, rank r's block attention weighted by its share
    w_r l_r / sum_r' w_r' l_r' of the softmax's mass, w_r = exp(m_r -
    max m), so every rank holds the same bits. Over one rank the weight is
    l / l = 1 and the sum that block's attention, bit for bit."""
    part = torch.cat([m[..., None], l[..., None], o], dim=-1)[None]
    for group in reversed(groups):              # the minor dimension first
        part = all_gather_dim(part, 0, group)
    mass = torch.exp(part[..., 0] - part[..., 0].amax(dim=0)) * part[..., 1]
    total = mass[0]
    for r in range(1, part.shape[0]):           # rank order: deterministic
        total = total + mass[r]
    out = (mass[0] / total)[..., None] * part[0, ..., 2:]
    for r in range(1, part.shape[0]):
        out = out + (mass[r] / total)[..., None] * part[r, ..., 2:]
    return out


def _decode_attention_sharded(cfg, p, x, pos, cache, block: CacheBlock):
    """The decode attention block under the sharded decode step over this
    rank's cache block (``CacheBlock``). The new K/V row is written by the
    rank whose block holds ``pos`` (``_scatter_cache``; every KV head of the
    block's: gathered over "model" where the weights split them and the
    cache does not). Where the block holds every KV head and the query
    heads are split over "model", the query heads are gathered whole. Each
    rank takes its partial softmax over its positions; the partials are
    combined over the cache's sequence groups (``combine_partials``); this
    rank's heads of the result enter the row-parallel output projection,
    whose partial sums are reduced over "model" (heads whole: every model
    rank runs the whole block). Weights are this rank's, gathered over
    "data" by the caller."""
    sh = current_sharded()
    specs = attention_param_specs(cfg)
    group = sh.group("model")
    heads_split = sh.split(specs["wq"], 1)
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, xn, p["wq"], p["wk"], p["wv"], pos[:, None])
    if sh.split(specs["wk"], 1) and not block.kv_split:
        k, v = all_gather_dim(k, 2, group), all_gather_dim(v, 2, group)
    _scatter_cache(cache, k, v, pos, block.seq_start)
    local_heads = q.shape[2]
    if heads_split and not block.kv_split:
        q = all_gather_dim(q, 2, group)
    o = combine_partials(*decode_attention_partial(q, *cache, pos,
                                                   block.seq_start),
                         block.seq_groups)
    o = o.reshape(q.shape).to(q.dtype)
    if o.shape[2] != local_heads:
        first = sh.coord("model") * local_heads
        o = o[:, :, first:first + local_heads]
    y = _out_proj(o, p["wo"])
    return x + (reduce_from(y, group) if heads_split else y), cache


# ---------------------------------------------------------------------------
# Attention blocks
# ---------------------------------------------------------------------------


def attention_param_specs(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
        "norm": norm_spec(d),
    }


def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out), w cast to x's dtype."""
    w2 = w.to(x.dtype).reshape(w.shape[0], -1)
    return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def _qkv_proj(cfg, p, x, positions):
    """Pre-norm q/k/v projections with RoPE, shared by the paged blocks."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    return _qkv(cfg, xn, p["wq"], p["wk"], p["wv"], positions)


def _qkv(cfg, xn, wq, wk, wv, positions):
    q = apply_rope(_proj(xn, wq), positions, cfg.rope_theta)
    k = apply_rope(_proj(xn, wk), positions, cfg.rope_theta)
    return q, k, _proj(xn, wv)


def _model_group(spec: Callable[[], ParamSpec], dim: int):
    """The ``"model"`` process group when the sharded step is active and
    dimension ``dim`` of the leaf ``spec()`` is sharded over it, else None.
    ``spec`` is called only under the sharded step: the replicated path
    builds no spec."""
    sh = current_sharded()
    return sh.group("model") if sh is not None and sh.split(spec(), dim) \
        else None


def carry_context(fn):
    """``fn`` run under the sharding rules, the sharded step's context and
    the batch split active where this is called: they are thread-local,
    and autograd runs a CUDA backward, and so a checkpoint's recompute, on
    a thread of its own."""
    rules, sh, split = current_rules(), current_sharded(), \
        current_batch_split()

    def run(*args):
        with activate_rules(rules), activate_sharded(sh), \
                activate_batch_split(split):
            return fn(*args)
    return run


def _kv_head_of(cfg, local_heads: int, rank: int) -> int:
    """The one KV head that a model rank's ``local_heads`` query heads use
    when the KV heads stay whole; raises where they straddle two groups."""
    group = cfg.num_heads // cfg.num_kv_heads
    if group % local_heads:
        raise ValueError(f"{cfg.name}: {local_heads} query heads a rank "
                         f"straddle the KV groups of {group} heads")
    return rank * local_heads // group


def _attention_sharded(cfg, p, x, positions, causal, all_kv=False):
    """The training and prefill attention block under the sharded step
    (module docstring): the rank's query heads; its KV heads, or where
    those are whole the one KV head its query heads use (whose weights'
    gradient is summed over "model"); the output projection's partial sums
    reduced. Heads whole: the replicated block on every model rank.
    ``all_kv`` (the prefill, no gradient): where the KV heads are whole,
    every KV head's k and v are projected and returned (the cache's), and
    the rank attends with its one."""
    specs = attention_param_specs(cfg)
    group = _model_group(lambda: specs["wq"], 1)
    if group is None:
        q, k, v = _qkv_proj(cfg, p, x, positions)
        return x + _out_proj(chunked_attention(q, k, v, causal=causal),
                             p["wo"]), (k, v)
    xn = copy_to(rmsnorm(x, p["norm"], cfg.norm_eps), group)
    wk, wv, kv = p["wk"], p["wv"], None
    if _model_group(lambda: specs["wk"], 1) is None:
        kv = _kv_head_of(cfg, p["wq"].shape[1],
                         current_sharded().coord("model"))
        if not all_kv:
            wk = copy_to(wk, group)[:, kv:kv + 1]
            wv = copy_to(wv, group)[:, kv:kv + 1]
    q, k, v = _qkv(cfg, xn, p["wq"], wk, wv, positions)
    if all_kv and kv is not None:
        o = chunked_attention(q, k[:, :, kv:kv + 1], v[:, :, kv:kv + 1],
                              causal=causal)
    else:
        o = chunked_attention(q, k, v, causal=causal)
    return x + reduce_from(_out_proj(o, p["wo"]), group), (k, v)


def _out_proj(o, wo):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d), wo cast to o's dtype."""
    return o.reshape(*o.shape[:2], -1) @ wo.to(o.dtype).reshape(
        -1, wo.shape[-1])


def attention_block(cfg, p, x, positions, *, cache=None, decode_pos=None,
                    block: Optional[CacheBlock] = None, all_kv=False):
    """Pre-norm attention residual block over a dense cache.

    Prefill: ``cache is None`` -> (y, (k, v)) so prefill can emit the cache;
    with ``cfg.attn_impl == "ring"`` under sharding rules whose mesh has a
    ``"model"`` axis, the attention is ``ring_attention_sharded`` over it.
    Decode: ``cache=(k_cache, v_cache)`` (B,Smax,KV,hd) and ``decode_pos``
    (B,) -> (y, (k_cache, v_cache)), the new row written in place.

    Under the sharded step: prefill and training take
    ``_attention_sharded`` (``all_kv``: every KV head's k and v for the
    cache); decode takes ``_decode_attention_sharded`` over this rank's
    cache block ``block``."""
    if current_sharded() is not None:
        if cache is None:
            return _attention_sharded(cfg, p, x, positions,
                                      cfg.causal and not cfg.encoder_only,
                                      all_kv)
        return _decode_attention_sharded(cfg, p, x, decode_pos, cache, block)
    q, k, v = _qkv_proj(cfg, p, x, positions)
    if cache is None:
        causal = cfg.causal and not cfg.encoder_only
        rules = current_rules()
        if (cfg.attn_impl == "ring" and rules is not None
                and "model" in rules.axis_sizes):
            # sequence-sharded ring attention over the model axis, for head
            # counts the axis does not divide
            o = ring_attention_sharded(q, k, v, rules.mesh, causal=causal)
        else:
            o = chunked_attention(q, k, v, causal=causal)
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
    specs = {"w_up": ParamSpec((d, f), ("embed", "mlp")),
             "w_down": ParamSpec((f, d), ("mlp", "embed")),
             "norm": norm_spec(d)}
    if cfg.mlp_gated:
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def _act(name: str, x):
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp_block(cfg, p, x):
    """The gated (or plain) FFN residual block; column-parallel up and gate
    and row-parallel down under the sharded step where the FFN width is
    sharded over "model"."""
    dt = cfg.cdtype
    group = _model_group(lambda: mlp_param_specs(cfg)["w_up"], 1)
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if group is not None:
        xn = copy_to(xn, group)
    up = xn @ p["w_up"].to(dt)
    h = _act(cfg.mlp_act, xn @ p["w_gate"].to(dt)) * up if cfg.mlp_gated \
        else _act(cfg.mlp_act, up)
    y = h @ p["w_down"].to(dt)
    return x + (y if group is None else reduce_from(y, group))


def embed_param_specs(cfg) -> dict:
    specs = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return specs


def _vocab_group(cfg):
    """The ``"model"`` group when the sharded step shards the vocabulary of
    the output projection (the embedding's rows when tied), else None."""
    if cfg.tie_embeddings:
        return _model_group(lambda: embed_param_specs(cfg)["embedding"], 0)
    return _model_group(lambda: embed_param_specs(cfg)["unembed"], 1)


def _vocab_offset(rows: int) -> int:
    """The first vocabulary row of this model rank's shard of ``rows``."""
    return current_sharded().coord("model") * rows


def embed_tokens(cfg, p, tokens):
    """The token embeddings; vocab-parallel under the sharded step (a masked
    lookup in the rank's rows, summed over "model")."""
    group = _model_group(lambda: embed_param_specs(cfg)["embedding"], 0)
    if group is None:
        return p["embedding"].to(cfg.cdtype)[tokens.long()]
    rows = p["embedding"].shape[0]
    local = tokens.long() - _vocab_offset(rows)
    hit = (local >= 0) & (local < rows)
    e = p["embedding"].to(cfg.cdtype)[local.clamp(0, rows - 1)]
    return reduce_from(torch.where(hit[..., None], e, 0), group)


def logits_fn(cfg, p, x):
    """x @ the output projection; under the sharded step with the vocabulary
    sharded, this rank's vocabulary columns."""
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    group = _vocab_group(cfg)
    if group is not None:
        x = copy_to(x, group)
    return x @ w.to(cfg.cdtype)


def global_argmax(cfg, logits):
    """The greedy tokens (int32) of ``logits_fn``'s logits (B,V'). Under
    the sharded step with the vocabulary split, each rank's row maximum and
    its first global index are gathered over "model" and the first index
    among the equal maxima is taken (the lowest rank's: the shards are in
    vocabulary order), as ``argmax`` over the whole row picks; every rank
    gets the same tokens."""
    idx = torch.argmax(logits, dim=-1)
    group = _vocab_group(cfg)
    if group is None:
        return idx.to(torch.int32)
    idx = idx + _vocab_offset(logits.shape[-1])
    tops = all_gather_dim(logits.amax(dim=-1).float()[None], 0, group)
    idxs = all_gather_dim(idx[None], 0, group)
    first = (tops == tops.amax(dim=0)).to(torch.int32).argmax(dim=0)
    return idxs.gather(0, first[None])[0].to(torch.int32)


def _label_logits(lg, labels):
    """``lg[..., labels]`` as a masked sum over the vocabulary: exact (one
    term is not zero), and its backward is elementwise, where a gather's is
    a scatter-add that deterministic mode refuses on the card."""
    hit = torch.arange(lg.shape[-1], device=lg.device) == labels[..., None]
    return torch.where(hit, lg, 0.0).sum(-1)


def token_nll(logits, labels, logit_dtype=torch.float32, cfg=None):
    """Every token's log-sum-exp less its label's logit, in ``logit_dtype``.
    Given ``cfg``, under the sharded step with the vocabulary sharded,
    ``logits`` are the rank's columns (``logits_fn``): the row maximum of
    the shards' log-sum-exps and their sum of exponentials are reduced over
    "model", as is the label's logit (one shard holds it). On one rank this
    is ``torch.logsumexp``'s result bit for bit: exp(0) = 1, log(1) = 0."""
    lg = logits.to(logit_dtype)
    labels = labels.long()
    group = None if cfg is None else _vocab_group(cfg)
    if group is None:
        return torch.logsumexp(lg, dim=-1) - _label_logits(lg, labels)
    part = torch.logsumexp(lg, dim=-1)
    top = all_max(part, group)
    # torch.logsumexp shifts by 0 where the maximum is infinite
    top = torch.where(top.abs() == math.inf, 0.0, top)
    lse = torch.log(reduce_from(torch.exp(part - top), group)) + top
    local = labels - _vocab_offset(lg.shape[-1])
    return lse - reduce_from(_label_logits(lg, local), group)


def softmax_xent(logits, labels, logit_dtype=torch.float32, cfg=None):
    """Mean token cross-entropy, stats in float32 (``token_nll``)."""
    return torch.mean(token_nll(logits, labels, logit_dtype, cfg))


def chunked_xent(cfg, p, x, labels, chunk: int):
    """Loss without materializing full-seq logits: one sequence chunk at a
    time, each chunk's logits recomputed in backward
    (``torch.utils.checkpoint``). Falls back to the whole sequence when the
    chunk does not divide it, as the reference does."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        return softmax_xent(logits_fn(cfg, p, x), labels, cfg=cfg)

    def one(xs, ys):
        return softmax_xent(logits_fn(cfg, p, xs), ys, cfg=cfg) * chunk

    one = carry_context(one)
    parts = [checkpoint(one, x[:, i:i + chunk], labels[:, i:i + chunk],
                        use_reentrant=False) for i in range(0, s, chunk)]
    return torch.stack(parts).sum() / s
