"""Model families: the dense transformer (with or without experts) and the
Zamba2 hybrid.

All families expose the surface the static ``ServeEngine`` calls:
``layout``, ``prefill``, ``decode``, ``cache_layout`` and
``grown_cache_leaves`` (the decode-cache leaves whose axis 2 is the
sequence, which the engine grows to ``max_len``), and ``train_loss``
(dense and MoE transformers; the Zamba2 hybrid's raises until the SSD scan
has a backward kernel). ``TransformerFamily``
adds the continuous-batching engine's surface: ``prefill_ragged`` (dense
admission), ``prefill_paged``, ``decode_paged``, ``decode_verify``,
``paged_pool_shape`` and ``paged_pool``. Every dense path runs the MoE FFN
(``models/moe.py``) in place of the dense one when ``cfg.num_experts`` is
set. The reference's ``lax.scan`` over the stacked layers becomes a loop
over the layer axis. Pools and decode caches are dicts of stacked tensors
updated in place; each method returns the same dict.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .moe import moe_block, moe_param_specs
from .params import stack_specs
from .ssm import mamba_block, mamba_cache_shapes, mamba_param_specs


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or pool) tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _ffn(cfg, p, x):
    """The layer's FFN block: the MoE block with experts (its aux losses
    are for training, ``train_loss``), else the dense one."""
    if cfg.num_experts:
        return moe_block(cfg, p, x)[0]
    return L.mlp_block(cfg, p, x)


AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _unbind_layers(tree) -> list[dict]:
    """Every layer of a stacked parameter tree, by one ``torch.unbind`` a
    leaf: its backward stacks the layers' gradients once, where indexing a
    layer at a time would add a zero-filled stack a layer."""
    flat = {k: (_unbind_layers(v) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _remat(cfg, fn):
    """``cfg.remat``: "full" recomputes each layer in backward (one
    non-reentrant ``torch.utils.checkpoint`` a layer, the reference's
    ``nothing_saveable``); "none" keeps its activations."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"{cfg.name}: remat='dots' (save the matmul outputs) is not "
            "ported yet (ROADMAP.md, Queue 1, item 5)")
    if cfg.remat != "none":
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    return fn


class TransformerFamily:
    name = "transformer"
    grown_cache_leaves = ("k", "v")

    # -- params ---------------------------------------------------------------
    def layer_specs(self, cfg) -> dict:
        return {"attn": L.attention_param_specs(cfg),
                "ffn": (moe_param_specs(cfg) if cfg.num_experts
                        else L.mlp_param_specs(cfg))}

    def layout(self, cfg) -> dict:
        return {
            **L.embed_param_specs(cfg),
            "layers": stack_specs(self.layer_specs(cfg), cfg.num_layers),
            "final_norm": L.norm_spec(cfg.d_model),
        }

    # -- token embedding ------------------------------------------------------
    def _embed(self, cfg, params, batch):
        """Returns (x, positions): tokens only. The reference's audio and
        VLM frontends (``frames``, ``patches``) are not ported yet."""
        if cfg.family in ("audio", "vlm") or "tokens" not in batch:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} frontend is not ported yet "
                "(ROADMAP.md, Queue 1, item 2b)")
        x = L.embed_tokens(cfg, params, batch["tokens"])
        return x, torch.arange(x.shape[1], device=x.device)

    # -- training loss ----------------------------------------------------------
    def train_loss(self, cfg, params, batch):
        """batch: tokens and labels (B,S), optionally loss_mask (B,S).
        Returns (total loss, metrics): the mean token cross-entropy plus, with
        experts, ``load_balance_loss * moe_lb_loss + router_z_loss *
        moe_z_loss``, each aux the mean over layers (zeros without
        experts)."""
        x, positions = self._embed(cfg, params, batch)
        moe = bool(cfg.num_experts)

        def layer(h, lp):
            h, _ = L.attention_block(cfg, lp["attn"], h, positions)
            if moe:
                h, aux = moe_block(cfg, lp["ffn"], h)
                return (h, *(torch.as_tensor(aux[k], dtype=torch.float32,
                                             device=h.device)
                             for k in AUX_KEYS))
            return (L.mlp_block(cfg, lp["ffn"], h),)

        body = _remat(cfg, layer)
        auxes = []
        for lp in _unbind_layers(params["layers"]):
            x, *aux = body(x, lp)
            auxes.append(aux)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        aux = ({k: torch.stack(v).mean() for k, v in zip(AUX_KEYS,
                                                          zip(*auxes))}
               if moe else {k: torch.zeros((), device=x.device)
                            for k in AUX_KEYS})
        labels = batch["labels"].long()
        if cfg.logit_chunk:
            loss = L.chunked_xent(cfg, params, x, labels, cfg.logit_chunk)
        else:
            logits = L.logits_fn(cfg, params, x)
            if "loss_mask" in batch:
                m = batch["loss_mask"].float()
                lg = logits.float()
                nll = torch.logsumexp(lg, dim=-1) - L._label_logits(lg, labels)
                loss = (nll * m).sum() / m.sum().clamp_min(1.0)
            else:
                loss = L.softmax_xent(logits, labels)
        total = (loss + cfg.load_balance_loss * aux["moe_lb_loss"]
                 + cfg.router_z_loss * aux["moe_z_loss"])
        return total, {"loss": loss, **aux}

    # -- full forward over a dense cache --------------------------------------
    def _stack_forward(self, cfg, params, x, positions):
        """Every layer at ``positions``; returns (final-normed x, (k, v)
        stacked (L,B,S,KV,hd))."""
        ks, vs = [], []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            x, (k, v) = L.attention_block(cfg, lp["attn"], x, positions)
            x = _ffn(cfg, lp["ffn"], x)
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, (torch.stack(ks), torch.stack(vs))

    def prefill(self, cfg, params, batch):
        """batch: tokens (B,S) at positions 0..S-1. Returns (logits (B,V) at
        the last position, cache {"k","v"} (L,B,S,KV,hd))."""
        x, positions = self._embed(cfg, params, batch)
        x, (k, v) = self._stack_forward(cfg, params, x, positions)
        return L.logits_fn(cfg, params, x[:, -1:])[:, 0], {"k": k, "v": v}

    def decode(self, cfg, params, batch, cache):
        """batch: tokens (B,1), pos (B,) the token's position. Writes its
        K/V row into ``cache`` (L,B,Smax,KV,hd) in place; returns (logits
        (B,V), cache)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        pos = batch["pos"]
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            x, _ = L.attention_block(cfg, lp["attn"], x, pos[:, None],
                                     cache=(cache["k"][i], cache["v"][i]),
                                     decode_pos=pos)
            x = _ffn(cfg, lp["ffn"], x)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return L.logits_fn(cfg, params, x)[:, 0], cache

    def prefill_ragged(self, cfg, params, batch):
        """Right-padded prompts, batch tokens (B,S) and length (B,): logits
        at ``length - 1`` and the whole (L,B,S,KV,hd) cache. Causal masking
        keeps rows below a prompt's length independent of its pad (the
        experts' capacity aside: pad tokens take part in routing)."""
        x, positions = self._embed(cfg, params, batch)
        x, (k, v) = self._stack_forward(cfg, params, x, positions)
        idx = batch["length"].long() - 1
        last = x[torch.arange(x.shape[0], device=x.device), idx]     # (B,d)
        return L.logits_fn(cfg, params, last), {"k": k, "v": v}

    def cache_layout(self, cfg, batch: int, cache_len: int) -> dict:
        """Decode-cache leaves as (shape, dtype), keyed as the cache is."""
        kv = ((cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
               cfg.head_dim), cfg.cdtype)
        return {"k": kv, "v": kv}

    # -- the paged paths ----------------------------------------------------------
    def _stack(self, cfg, params, x, pool, attn):
        """Run every layer: ``attn(layer_attn_params, h, layer_pool)`` then
        the FFN; returns the final-normed activations."""
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            x, _ = attn(lp["attn"], x, _layer(pool, i))
            x = _ffn(cfg, lp["ffn"], x)
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    # -- paged chunked prefill ----------------------------------------------------
    def prefill_paged(self, cfg, params, batch, pool):
        """One chunked-prefill step: C prompt tokens written straight into
        pool pages, attended against the already-written context.

        batch: tokens (B,C), q_start (B,), kv_len (B,) true prompt length
        (positions >= kv_len are pad and write to the sink page),
        page_table (B,npages) int32, logit_idx (B,) in-chunk index to read
        logits at (clamped to the chunk). Returns (logits (B,V), pool).
        """
        x = L.embed_tokens(cfg, params, batch["tokens"])
        x = self._stack(cfg, params, x, pool, lambda p, h, pl:
                        L.paged_prefill_attention_block(
                            cfg, p, h, pool=pl,
                            page_table=batch["page_table"],
                            q_start=batch["q_start"],
                            kv_len=batch["kv_len"]))
        idx = batch["logit_idx"].long().clamp(0, x.shape[1] - 1)
        last = x[torch.arange(x.shape[0], device=x.device), idx]    # (B,d)
        return L.logits_fn(cfg, params, last), pool

    # -- paged decode ---------------------------------------------------------------
    def decode_paged(self, cfg, params, batch, pool):
        """One decode step over the shared paged pool.

        batch: tokens (B,1), pos (B,), page_table (B,npages) int32. Returns
        (logits (B,V), pool)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        x = self._stack(cfg, params, x, pool, lambda p, h, pl:
                        L.paged_attention_block(
                            cfg, p, h, pool=pl,
                            page_table=batch["page_table"], pos=batch["pos"]))
        return L.logits_fn(cfg, params, x)[:, 0], pool

    # -- paged speculative verify ------------------------------------------------------
    def decode_verify(self, cfg, params, batch, pool):
        """Score a T-token window per slot (the verified current token and
        T-1 drafts) in one pass.

        batch: tokens (B,T), pos (B,) position of tokens[:,0], page_table
        (B,npages) int32, write_limit (B,): KV writes at positions >=
        write_limit go to the sink page. Returns (logits (B,T,V), pool)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        x = self._stack(cfg, params, x, pool, lambda p, h, pl:
                        L.paged_verify_attention_block(
                            cfg, p, h, pool=pl,
                            page_table=batch["page_table"], pos=batch["pos"],
                            write_limit=batch["write_limit"]))
        return L.logits_fn(cfg, params, x), pool

    # -- the pool ----------------------------------------------------------------------
    def paged_pool_shape(self, cfg, num_pages: int):
        return (cfg.num_layers, cfg.num_kv_heads, num_pages, cfg.page_size,
                cfg.head_dim)

    def paged_pool(self, cfg, num_pages: int,
                   kv_cache_dtype: str | None = None, *, device="cuda"):
        """Allocate the zeroed pool dict on ``device``.

        ``"f32"`` stores K/V rows in ``cfg.dtype``; ``"int8"`` stores them as
        int8 with (L,KV,P,ps) f32 per-row scale pages ``k_scale``/``v_scale``.
        """
        dev = resolve_device(device)
        shape = self.paged_pool_shape(cfg, num_pages)
        dtype = kv_cache_dtype or cfg.kv_cache_dtype
        if dtype == "int8":
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(shape[:-1], device=dev),
                    "v_scale": torch.zeros(shape[:-1], device=dev)}
        if dtype == "f32":
            return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                    "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev)}
        raise ValueError(f"unknown kv_cache_dtype {dtype!r}")


# ===========================================================================
# Zamba2 hybrid (Mamba2 backbone + shared attention block)
# ===========================================================================

class ZambaFamily:
    name = "zamba"
    grown_cache_leaves = ("attn_k", "attn_v")

    def train_loss(self, cfg, params, batch):
        raise NotImplementedError(
            f"{cfg.name}: training the Zamba2 hybrid needs a backward kernel "
            "for the SSD scan (csrc/ssd_scan.cu), which is not written yet "
            "(ROADMAP.md, Queue 1, item 5)")

    def group_sizes(self, cfg) -> list[int]:
        k, n = cfg.shared_attn_every, cfg.num_layers
        sizes = [k] * (n // k)
        if n % k:
            sizes.append(n % k)
        return sizes

    def n_shared_applications(self, cfg) -> int:
        return cfg.num_layers // cfg.shared_attn_every

    def layout(self, cfg) -> dict:
        return {
            **L.embed_param_specs(cfg),
            "mamba": stack_specs(mamba_param_specs(cfg), cfg.num_layers),
            "shared": {"attn": L.attention_param_specs(cfg),
                       "ffn": L.mlp_param_specs(cfg)},
            "final_norm": L.norm_spec(cfg.d_model),
        }

    def _forward(self, cfg, params, x, positions, caches=None,
                 decode_pos=None):
        """The Mamba groups, with the shared attention + FFN block applied
        after each full group of ``shared_attn_every`` layers (none after a
        shorter last group). Prefill (``caches is None``) returns a new
        stacked cache; decode writes every leaf of ``caches`` in place and
        returns it."""
        layer = app = 0
        mamba, kv = [], []
        for gi, size in enumerate(self.group_sizes(cfg)):
            for _ in range(size):
                c_in = None if caches is None else _layer(caches["mamba"],
                                                          layer)
                x, c = mamba_block(cfg, _layer(params["mamba"], layer), x,
                                   cache=c_in)
                if caches is None:
                    mamba.append(c)
                else:
                    for name, leaf in c.items():
                        c_in[name].copy_(leaf)
                layer += 1
            if (gi + 1) * cfg.shared_attn_every <= cfg.num_layers \
                    and app < self.n_shared_applications(cfg):
                kv_in = None if caches is None else (caches["attn_k"][app],
                                                     caches["attn_v"][app])
                x, new_kv = L.attention_block(
                    cfg, params["shared"]["attn"], x, positions,
                    cache=kv_in, decode_pos=decode_pos)
                x = L.mlp_block(cfg, params["shared"]["ffn"], x)
                kv.append(new_kv)
                app += 1
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            return x, caches
        cache = {"mamba": {name: torch.stack([c[name] for c in mamba])
                           for name in mamba[0]}}
        if kv:
            cache["attn_k"] = torch.stack([k for k, _ in kv])
            cache["attn_v"] = torch.stack([v for _, v in kv])
        return x, cache

    def prefill(self, cfg, params, batch):
        """batch: tokens (B,S) at positions 0..S-1. Returns (logits (B,V) at
        the last position, cache): ``mamba`` conv (L,B,K-1,C) and ssm
        (L,B,H,N,P) f32, ``attn_k``/``attn_v`` (apps,B,S,KV,hd)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, cache = self._forward(cfg, params, x, positions)
        return L.logits_fn(cfg, params, x[:, -1:])[:, 0], cache

    def decode(self, cfg, params, batch, cache):
        """batch: tokens (B,1), pos (B,) the token's position. Returns
        (logits (B,V), cache updated in place)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        pos = batch["pos"]
        x, cache = self._forward(cfg, params, x, pos[:, None], caches=cache,
                                 decode_pos=pos)
        return L.logits_fn(cfg, params, x)[:, 0], cache

    def cache_layout(self, cfg, batch: int, cache_len: int) -> dict:
        """Decode-cache leaves as (shape, dtype), keyed as the cache is."""
        n = cfg.num_layers
        kv = ((self.n_shared_applications(cfg), batch, cache_len,
               cfg.num_kv_heads, cfg.head_dim), cfg.cdtype)
        return {"mamba": {k: ((n,) + shape, dt) for k, (shape, dt)
                          in mamba_cache_shapes(cfg, batch).items()},
                "attn_k": kv, "attn_v": kv}
