"""Model families: the transformer (dense, with experts, and with the audio
and VLM frontends), the xLSTM stack of (mLSTM, sLSTM) pairs and the Zamba2
hybrid.

All families expose the surface the static ``ServeEngine`` calls:
``layout``, ``prefill``, ``decode``, ``cache_layout`` (and the logical
axes of its leaves, ``cache_axes``) and ``grown_cache_leaves`` (the
decode-cache leaves whose axis 2 is the sequence, which the engine grows
to ``max_len``), and ``train_loss``
(every family; the Zamba2 hybrid's differentiates the SSD scan through
its backward kernel on the card). The transformer's frontends are the
reference's stubs: an audio config (HuBERT, ``frontend="frame"``) takes
precomputed frame features (B,S,frontend_dim) in ``batch["frames"]`` in
place of tokens and is encoder-only (``prefill`` returns every position's
logits and no cache); a VLM config (PaliGemma, ``frontend="patch"``) may
take patch embeddings (B,P,frontend_dim) in ``batch["patches"]``, which
are projected and put in front of the text, so the cache's rows and
``decode``'s ``pos`` count from the first patch. ``TransformerFamily``
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
from ..distributed.collectives import current_sharded, entry_axes
from . import layers as L
from .moe import moe_block, moe_param_specs
from .params import ParamSpec, stack_specs
from .ssm import (MAMBA_CACHE_AXES, mamba_block, mamba_cache_shapes,
                  mamba_param_specs)
from .xlstm import (MLSTM_CACHE_AXES, SLSTM_CACHE_AXES, mlstm_block,
                    mlstm_cache_shapes, mlstm_param_specs, slstm_block,
                    slstm_cache_shapes, slstm_param_specs)


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


#: The logical axes of a dense K or V cache (L, B, S, KV, hd).
KV_CACHE_AXES = ("layers", "batch", "cache_seq", "kv_heads", None)


def _stacked(axes: dict) -> dict:
    """One layer's cache axes with the leading ``"layers"`` axis."""
    return {k: ("layers",) + a for k, a in axes.items()}


def _gather_top(sh, params, *stacks):
    """``params`` with every leaf outside the subtrees ``stacks`` gathered
    over "data" (``ShardedParams.gather_data``); the subtrees as they
    are, gathered where their layers run."""
    top = {k: v for k, v in params.items() if k not in stacks}
    return {**sh.gather_data(top, sh.layout),
            **{k: params[k] for k in stacks}}


def _remat(cfg, fn):
    """``cfg.remat``: "full" recomputes each layer in backward (one
    non-reentrant ``torch.utils.checkpoint`` a layer, the reference's
    ``nothing_saveable``); "none" keeps its activations.

    The recompute runs under the sharding rules and the sharded step's
    context that were active when the layer ran (``layers.carry_context``):
    they are thread-local, and autograd runs a CUDA backward on a thread of
    its own, where none are active (a ring layer would otherwise be
    recomputed as the chunked one, a sharded one as the replicated one)."""
    if cfg.remat == "full":
        def run(*args):
            return checkpoint(L.carry_context(fn), *args,
                              use_reentrant=False)
        return run
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
        layout = {
            **L.embed_param_specs(cfg),
            "layers": stack_specs(self.layer_specs(cfg), cfg.num_layers),
            "final_norm": L.norm_spec(cfg.d_model),
        }
        if cfg.frontend:
            layout["frontend_proj"] = ParamSpec(
                (cfg.frontend_dim, cfg.d_model), ("frontend", "embed"))
        return layout

    # -- embedding / frontend -------------------------------------------------
    def _embed(self, cfg, params, batch):
        """Returns (x, positions, text_offset): ``frames`` (B,S,F) @
        ``frontend_proj`` for a frame frontend (no token embedding); else the
        token embeddings, after the projected ``patches`` (B,P,F) when a
        patch frontend is given them (text_offset P)."""
        dt = cfg.cdtype
        offset = 0
        if cfg.frontend == "frame":
            x = batch["frames"].to(dt) @ params["frontend_proj"].to(dt)
        else:
            x = L.embed_tokens(cfg, params, batch["tokens"])
            if cfg.frontend == "patch" and "patches" in batch:
                px = batch["patches"].to(dt) @ params["frontend_proj"].to(dt)
                x = torch.cat([px, x], dim=1)
                offset = px.shape[1]
        return x, torch.arange(x.shape[1], device=x.device), offset

    # -- training loss ----------------------------------------------------------
    def train_loss(self, cfg, params, batch):
        """batch: tokens and labels (B,S), optionally loss_mask (B,S) (and a
        frontend's ``frames`` or ``patches``; labels cover the text only).
        Returns (total loss, metrics): the mean token cross-entropy plus, with
        experts, ``load_balance_loss * moe_lb_loss + router_z_loss *
        moe_z_loss``, each aux the mean over layers (zeros without
        experts).

        Under the sharded step (``distributed/collectives.py``) ``params``
        are this rank's shards: the leaves outside the layer stack are
        gathered over "data" once, and each layer's inside its remat body,
        so the recompute gathers them again and the whole weights are freed
        with the layer."""
        sh = current_sharded()
        if sh is not None:
            params = _gather_top(sh, params, "layers")
            layer_specs = self.layer_specs(cfg)
        x, positions, _ = self._embed(cfg, params, batch)
        moe = bool(cfg.num_experts)

        def layer(h, lp):
            if sh is not None:
                lp = sh.gather_data(lp, layer_specs)
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
        if cfg.frontend == "patch":
            # the loss is over the text: drop the patch rows (the reference
            # drops frontend_len rows whether or not patches were given)
            x = x[:, cfg.frontend_len:]
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
                nll = L.token_nll(logits, labels, cfg=cfg)
                loss = (nll * m).sum() / m.sum().clamp_min(1.0)
            else:
                loss = L.softmax_xent(logits, labels, cfg=cfg)
        total = (loss + cfg.load_balance_loss * aux["moe_lb_loss"]
                 + cfg.router_z_loss * aux["moe_z_loss"])
        return total, {"loss": loss, **aux}

    # -- full forward over a dense cache --------------------------------------
    def _stack_forward(self, cfg, params, x, positions, want_cache=True):
        """Every layer at ``positions``; returns (final-normed x, (k, v)
        stacked (L,B,S,KV,hd), or None without ``want_cache``). Under the
        sharded step each layer's weights are gathered over "data" where it
        runs, and the cache holds every KV head its rank's block holds."""
        sh = current_sharded()
        specs = self.layer_specs(cfg) if sh is not None else None
        ks = vs = None
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            if sh is not None:
                lp = sh.gather_data(lp, specs)
            x, (k, v) = L.attention_block(cfg, lp["attn"], x, positions,
                                          all_kv=want_cache)
            x = _ffn(cfg, lp["ffn"], x)
            if want_cache:
                if ks is None:
                    ks = k.new_empty((cfg.num_layers, *k.shape))
                    vs = v.new_empty((cfg.num_layers, *v.shape))
                ks[i].copy_(k)
                vs[i].copy_(v)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, ((ks, vs) if want_cache else None)

    def prefill(self, cfg, params, batch):
        """batch: tokens (B,S) at positions 0..S-1 (a frame frontend's
        ``frames``, or patches before the tokens). Returns (logits (B,V) at
        the last position, cache {"k","v"} (L,B,S,KV,hd)); encoder-only:
        (logits (B,S,V) at every position, {}).

        Under the sharded step (no gradient) ``params`` are this rank's
        shards and ``batch`` its rows: the leaves outside the layer stack
        are gathered over "data" once, each layer's where it runs; the
        logits are this rank's vocabulary columns where the vocabulary is
        split, and the cache its block under the prefill cell's rules
        (``KV_CACHE_AXES``, the sequence whole): its rows, and its KV heads
        where they are split over "model", else every KV head
        (``attention_block``'s ``all_kv``)."""
        sh = current_sharded()
        if sh is not None:
            params = _gather_top(sh, params, "layers")
        x, positions, _ = self._embed(cfg, params, batch)
        x, kv = self._stack_forward(cfg, params, x, positions,
                                    want_cache=not cfg.encoder_only)
        if cfg.encoder_only:
            return L.logits_fn(cfg, params, x), {}
        k, v = kv
        return L.logits_fn(cfg, params, x[:, -1:])[:, 0], {"k": k, "v": v}

    def decode(self, cfg, params, batch, cache, block=None):
        """batch: tokens (B,1), pos (B,) the token's position (counted from
        the first patch after a prefill with patches). Writes its K/V row
        into ``cache`` (L,B,Smax,KV,hd) in place; returns (logits (B,V),
        cache).

        Under the sharded step (no gradient) ``params`` are this rank's
        shards, ``batch`` its rows and ``cache`` its block, ``block``
        (``cache_block``) its place: each layer's weights are gathered over
        "data" where it runs and its attention is
        ``layers._decode_attention_sharded``."""
        sh = current_sharded()
        pos = batch["pos"]
        if sh is not None:
            params = _gather_top(sh, params, "layers")
            specs = self.layer_specs(cfg)
        x = L.embed_tokens(cfg, params, batch["tokens"])
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            if sh is not None:
                lp = sh.gather_data(lp, specs)
            x, _ = L.attention_block(cfg, lp["attn"], x, pos[:, None],
                                     cache=(cache["k"][i], cache["v"][i]),
                                     decode_pos=pos, block=block)
            x = _ffn(cfg, lp["ffn"], x)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return L.logits_fn(cfg, params, x)[:, 0], cache

    def cache_block(self, cfg, sh, global_batch: int,
                    cache_len: int) -> L.CacheBlock:
        """This rank's place in the decode cache of ``global_batch`` rows of
        ``cache_len`` positions under ``sh``'s rules (``KV_CACHE_AXES``):
        the groups its sequence is split over, its first position, and
        whether its KV heads are split."""
        spec = sh.rules.spec_for((cfg.num_layers, global_batch, cache_len,
                                  cfg.num_kv_heads, cfg.head_dim),
                                 KV_CACHE_AXES)
        axes = entry_axes(spec[2])
        index, n = 0, 1
        for a in axes:                    # the first dimension major
            index = index * sh.rules.axis_sizes[a] + sh.coord(a)
            n *= sh.rules.axis_sizes[a]
        return L.CacheBlock(tuple(sh.group(a) for a in axes),
                            index * (cache_len // n),
                            bool(entry_axes(spec[3])))

    def prefill_ragged(self, cfg, params, batch):
        """Right-padded prompts, batch tokens (B,S) and length (B,): logits
        at ``length - 1`` and the whole (L,B,S,KV,hd) cache. Causal masking
        keeps rows below a prompt's length independent of its pad (the
        experts' capacity aside: pad tokens take part in routing)."""
        x, positions, _ = self._embed(cfg, params, batch)
        x, (k, v) = self._stack_forward(cfg, params, x, positions)
        idx = batch["length"].long() - 1
        last = x[torch.arange(x.shape[0], device=x.device), idx]     # (B,d)
        return L.logits_fn(cfg, params, last), {"k": k, "v": v}

    def cache_layout(self, cfg, batch: int, cache_len: int) -> dict:
        """Decode-cache leaves as (shape, dtype), keyed as the cache is."""
        kv = ((cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
               cfg.head_dim), cfg.cdtype)
        return {"k": kv, "v": kv}

    def cache_axes(self, cfg) -> dict:
        """The logical axes of ``cache_layout``'s leaves, keyed as it is."""
        return {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES}

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
# xLSTM (alternating mLSTM / sLSTM pairs)
# ===========================================================================

class XLSTMFamily:
    """``num_layers // 2`` (mLSTM, sLSTM) pairs, stacked under ``pairs``.
    Its decode cache holds recurrent state and a conv tail, none of it along
    the sequence, so the static engine grows no leaf; the reference's engine
    grows every leaf whose axis 2 equals the prompt length (ROADMAP.md,
    Queue 3)."""
    name = "xlstm"
    grown_cache_leaves = ()

    def n_pairs(self, cfg) -> int:
        return cfg.num_layers // 2

    def layout(self, cfg) -> dict:
        n = self.n_pairs(cfg)
        return {
            **L.embed_param_specs(cfg),
            "pairs": {
                "m": stack_specs(mlstm_param_specs(cfg), n),
                "s": stack_specs(slstm_param_specs(cfg), n),
            },
            "final_norm": L.norm_spec(cfg.d_model),
        }

    def train_loss(self, cfg, params, batch):
        """batch: tokens and labels (B,S). Returns (mean token
        cross-entropy, {"loss": it}); each pair runs under ``_remat``, as
        the reference's scan body does.

        Under the sharded step ``params`` are this rank's shards: the
        leaves outside the pairs are gathered over "data" once, each
        pair's inside its remat body (``models/xlstm.py`` splits the
        blocks over "model"), and the embedding and loss are
        vocab-parallel."""
        sh = current_sharded()
        if sh is not None:
            params = _gather_top(sh, params, "pairs")
            specs = {"m": mlstm_param_specs(cfg), "s": slstm_param_specs(cfg)}
        x = L.embed_tokens(cfg, params, batch["tokens"])

        def pair(h, pm, ps):
            if sh is not None:
                pm = sh.gather_data(pm, specs["m"])
                ps = sh.gather_data(ps, specs["s"])
            h, _ = mlstm_block(cfg, pm, h)
            return slstm_block(cfg, ps, h)[0]

        body = _remat(cfg, pair)
        for pm, ps in zip(_unbind_layers(params["pairs"]["m"]),
                          _unbind_layers(params["pairs"]["s"])):
            x = body(x, pm, ps)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        loss = L.softmax_xent(L.logits_fn(cfg, params, x),
                              batch["labels"].long(), cfg=cfg)
        return loss, {"loss": loss}

    def _forward(self, cfg, params, x, caches=None):
        """Every pair. Prefill (``caches is None``) returns a new stacked
        cache; decode writes every leaf of ``caches`` in place and returns
        it."""
        new = {"m": [], "s": []}
        for i in range(self.n_pairs(cfg)):
            for kind, block in (("m", mlstm_block), ("s", slstm_block)):
                c_in = None if caches is None else _layer(caches[kind], i)
                x, c = block(cfg, _layer(params["pairs"][kind], i), x,
                             cache=c_in)
                if caches is None:
                    new[kind].append(c)
                else:
                    for name, leaf in c.items():
                        c_in[name].copy_(leaf)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            return x, caches
        return x, {kind: {name: torch.stack([c[name] for c in cs])
                          for name in cs[0]} for kind, cs in new.items()}

    def prefill(self, cfg, params, batch):
        """batch: tokens (B,S). Returns (logits (B,V) at the last position,
        cache): ``m`` conv (P,B,K-1,2d) and C (P,B,H,hd,hd), n (P,B,H,hd),
        m (P,B,H) in f32; ``s`` c, n, m, h (P,B,H,hd) in f32, P pairs."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        x, cache = self._forward(cfg, params, x)
        return L.logits_fn(cfg, params, x[:, -1:])[:, 0], cache

    def decode(self, cfg, params, batch, cache):
        """batch: tokens (B,1) (``pos`` is not read: the state carries the
        position). Returns (logits (B,V), cache updated in place)."""
        x = L.embed_tokens(cfg, params, batch["tokens"])
        x, cache = self._forward(cfg, params, x, caches=cache)
        return L.logits_fn(cfg, params, x)[:, 0], cache

    def cache_layout(self, cfg, batch: int, cache_len: int) -> dict:
        """Decode-cache leaves as (shape, dtype), keyed as the cache is;
        ``cache_len`` is not read."""
        n = self.n_pairs(cfg)

        def stk(entries):
            return {k: ((n,) + shape, dt) for k, (shape, dt) in entries.items()}

        return {"m": stk(mlstm_cache_shapes(cfg, batch)),
                "s": stk(slstm_cache_shapes(cfg, batch))}

    def cache_axes(self, cfg) -> dict:
        """The logical axes of ``cache_layout``'s leaves, keyed as it is."""
        return {"m": _stacked(MLSTM_CACHE_AXES),
                "s": _stacked(SLSTM_CACHE_AXES)}


# ===========================================================================
# Zamba2 hybrid (Mamba2 backbone + shared attention block)
# ===========================================================================

class ZambaFamily:
    name = "zamba"
    grown_cache_leaves = ("attn_k", "attn_v")

    def group_sizes(self, cfg) -> list[int]:
        k, n = cfg.shared_attn_every, cfg.num_layers
        sizes = [k] * (n // k)
        if n % k:
            sizes.append(n % k)
        return sizes

    def n_shared_applications(self, cfg) -> int:
        return cfg.num_layers // cfg.shared_attn_every

    def _schedule(self, cfg):
        """The blocks in order: ("mamba", layer) for each Mamba layer, and
        ("shared", application) after each full group of
        ``shared_attn_every`` layers (none after a shorter last group)."""
        layer = 0
        for app, size in enumerate(self.group_sizes(cfg)):
            for _ in range(size):
                yield "mamba", layer
                layer += 1
            if size == cfg.shared_attn_every:
                yield "shared", app

    def train_loss(self, cfg, params, batch):
        """batch: tokens and labels (B,S). Returns (mean token
        cross-entropy, {"loss": it}); each Mamba layer runs under
        ``_remat``, the shared attention + FFN block outside it, as the
        reference's scan body does.

        Under the sharded step ``params`` are this rank's shards: the
        embedding, unembedding and final norm are gathered over "data"
        once, each Mamba layer's leaves inside its remat body
        (``models/ssm.py`` splits the block over "model"), and the shared
        block's at each application, whose attention and FFN are the
        transformer's sharded ones; autograd sums the applications'
        gradients of the shared shards."""
        sh = current_sharded()
        if sh is not None:
            params = _gather_top(sh, params, "mamba", "shared")
            specs = mamba_param_specs(cfg)
        x = L.embed_tokens(cfg, params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)

        def layer(h, lp):
            if sh is not None:
                lp = sh.gather_data(lp, specs)
            return mamba_block(cfg, lp, h)[0]

        body = _remat(cfg, layer)
        layers = _unbind_layers(params["mamba"])
        for kind, i in self._schedule(cfg):
            if kind == "mamba":
                x = body(x, layers[i])
                continue
            shared = params["shared"]
            if sh is not None:
                shared = sh.gather_data(shared, sh.layout["shared"])
            x, _ = L.attention_block(cfg, shared["attn"], x, positions)
            x = L.mlp_block(cfg, shared["ffn"], x)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        loss = L.softmax_xent(L.logits_fn(cfg, params, x),
                              batch["labels"].long(), cfg=cfg)
        return loss, {"loss": loss}

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
        mamba, kv = [], []
        for kind, i in self._schedule(cfg):
            if kind == "mamba":
                c_in = None if caches is None else _layer(caches["mamba"], i)
                x, c = mamba_block(cfg, _layer(params["mamba"], i), x,
                                   cache=c_in)
                if caches is None:
                    mamba.append(c)
                else:
                    for name, leaf in c.items():
                        c_in[name].copy_(leaf)
                continue
            kv_in = None if caches is None else (caches["attn_k"][i],
                                                 caches["attn_v"][i])
            x, new_kv = L.attention_block(
                cfg, params["shared"]["attn"], x, positions, cache=kv_in,
                decode_pos=decode_pos)
            x = L.mlp_block(cfg, params["shared"]["ffn"], x)
            kv.append(new_kv)
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

    def cache_axes(self, cfg) -> dict:
        """The logical axes of ``cache_layout``'s leaves, keyed as it is."""
        return {"mamba": _stacked(MAMBA_CACHE_AXES),
                "attn_k": KV_CACHE_AXES, "attn_v": KV_CACHE_AXES}
