"""Step construction: the training step (microbatched gradient accumulation
in f32, AdamW), and the serving steps: the static engine's dense prefill
and decode steps, the continuous engine's dense (ragged) admission step,
its steps over the shared paged KV pool, and the encoder-only encode
step.

The train step runs replicated (every parameter whole on every rank,
data parallel under rules that split the batch) or, chosen by its caller
with ``sharded=True``, on this rank's shards (``distributed/sharding.py``'s
``shard_params``, ``distributed/collectives.py``): FSDP over "data",
tensor parallelism over "model", for MoE configs expert parallelism
over "model" (``models/moe.py``), and for the Zamba2 and xLSTM families
their blocks split over "model" (``models/ssm.py``,
``models/xlstm.py``). Either way a split batch is the reference's global
batch to the MoE block: its groups are the global batch's and its aux
losses global (``BatchSplit``).

The transformer's dense prefill, encode and decode steps run replicated
or, with ``sharded=True`` (``sharded_serve_gap``), on this rank's shards
without autograd: the train step's sharded forward, the cache this rank's
block of the reference's ``KV_CACHE_AXES`` placement (at decode split by
sequence, ``models/layers.py``'s ``CacheBlock``), the next token a global
argmax over the vocabulary shards, and a MoE group that spans data ranks
gathered and routed whole on each.

Each builder returns a plain function that runs one model pass and, for
the decode-like steps, takes the greedy argmax over the compute-dtype
logits (ties resolve to the first index, as in the reference). Pools and
decode caches are updated in place and returned.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from ..distributed.collectives import (BatchSplit, ShardedParams,
                                       activate_batch_split,
                                       activate_sharded, all_reduce_sum,
                                       entry_axes)
from ..distributed.sharding import current_rules, shard_tree
from ..models import get_family
from ..models import layers as L
from ..models.transformer import (TransformerFamily, XLSTMFamily,
                                  ZambaFamily)
from . import adamw


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _split(batch, n: int):
    """The batch's leading dim cut into n microbatches: [{k: (B/n, ...)}]."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} ({k}) % microbatches {n} "
                             f"!= 0")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _token_count(batch):
    """The tokens a batch's loss averages over, as an f32 scalar tensor:
    its ``loss_mask``'s sum, or every label."""
    if "loss_mask" in batch:
        return batch["loss_mask"].float().sum()
    labels = batch["labels"]
    return torch.full((), float(labels.numel()), device=labels.device)


def _data_parallel(rules):
    """(process groups, this rank's batch slice, slice count) over the
    active rules' batch dimensions (the ``"batch"`` rule's) of extent > 1,
    or None."""
    axes = () if rules is None else tuple(
        a for a in rules.mesh_axes_for("batch") if rules.axis_sizes[a] > 1)
    if not axes:
        return None
    index = 0
    for a in axes:          # the spec's order: the first dimension major
        index = index * rules.axis_sizes[a] + rules.mesh.get_local_rank(a)
    return ([rules.mesh.get_group(a) for a in axes], index,
            math.prod(rules.axis_sizes[a] for a in axes))


def _rows(x, index: int, size: int):
    if x.shape[0] % size:
        raise ValueError(f"batch {x.shape[0]} % data-parallel ranks {size} "
                         f"!= 0")
    n = x.shape[0] // size
    return x[index * n:(index + 1) * n]


def local_batch(batch, microbatches: int = 1):
    """This rank's rows of a global batch for the sharded step, under the
    active rules: its block of the ``"batch"`` dimensions, as the
    reference's ``input_sharding`` places the batch; with ``microbatches``,
    its block of each of the reference's microbatches in turn, so that the
    step's own split gives each microbatch's rows to their ranks."""
    _, index, size = _data_parallel(current_rules()) or (None, 0, 1)
    return {k: torch.cat([_rows(mb[k], index, size)
                          for mb in _split(batch, microbatches)])
            for k in batch}


def local_serve_batch(batch):
    """This rank's block of a sharded serve step's global batch under the
    active rules: every leaf's rows by the ``"batch"`` rule, as the
    reference's ``input_sharding`` places them, a batch that the batch
    dimensions do not divide whole on every rank (``shard_tree``)."""
    rules = current_rules()
    return shard_tree(batch, {k: ("batch",) + (None,) * (x.ndim - 1)
                              for k, x in batch.items()}, rules)


def sharded_serve_gap(cfg) -> str:
    """Why the sharded prefill, encode and decode steps do not cover
    ``cfg``, or "" where they do: the transformer, dense or with experts
    and with either frontend, attention chunked. The dry-run places every
    prefill and decode cell by it (``launch/input_specs.py``)."""
    if not isinstance(get_family(cfg), TransformerFamily):
        return (f"the {cfg.family} family serves replicated (its sharded "
                "serve steps wait)")
    if cfg.attn_impl != "chunked":
        return (f"attn_impl {cfg.attn_impl!r} serves replicated (the sharded "
                "serve steps' attention is chunked)")
    return ""


def sharded_step_gap(cfg) -> str:
    """Why the sharded train step does not cover ``cfg``, or "" where it
    does: the transformer, dense or with experts (expert parallelism over
    "model"), the Zamba2 hybrid and the xLSTM stack, attention chunked."""
    if not isinstance(get_family(cfg), (TransformerFamily, ZambaFamily,
                                        XLSTMFamily)):
        return (f"the {cfg.family} family trains replicated (its sharded "
                "step waits)")
    if cfg.attn_impl != "chunked":
        return (f"attn_impl {cfg.attn_impl!r} trains replicated (the sharded "
                "step's attention is chunked)")
    return ""


class _ShardedContext:
    """The sharded step's ``ShardedParams`` for the active rules, built once
    a rules object; ``gap``: the predicate that refuses ``cfg``."""

    def __init__(self, cfg, gap=sharded_step_gap):
        gap = gap(cfg)
        if gap:
            raise NotImplementedError(f"{cfg.name}: {gap}")
        self.layout = get_family(cfg).layout(cfg)
        self.rules, self.sh = None, None

    def __call__(self) -> ShardedParams:
        rules = current_rules()
        if rules is None:
            raise ValueError("the sharded step runs under active sharding "
                             "rules (activate_rules)")
        if rules is not self.rules:
            self.rules, self.sh = rules, ShardedParams(rules, self.layout)
        return self.sh


def _sharded_loss_and_grads(cfg, microbatches: int, context):
    """``build_loss_and_grads``' sharded step: ``params`` are this rank's
    shards, ``batch`` its rows (``local_batch``). Each microbatch's loss is
    weighted by the rank's share of the microbatch's tokens, the global
    count all-reduced over the batch dimensions, before its backward: the
    weight gathers' reduce-scatters then sum the ranks' shares over
    "data", and only a leaf whole over a batch dimension is all-reduced
    over it afterwards. Every collective is issued, over groups of one
    rank too."""
    family = get_family(cfg)

    def loss_and_grads(params, batch):
        sh = context()
        leaves = adamw.tree_leaves(params)
        split = sh.batch_split()
        groups = split.groups
        mbs = [batch] if microbatches == 1 else _split(batch, microbatches)
        g_acc, v_acc, names = None, None, None
        for mb in mbs:
            count = _token_count(mb)
            total = count
            for group in groups:
                total = all_reduce_sum(total, group)
            w = count / total.clamp_min(1.0)
            with activate_sharded(sh), activate_batch_split(split):
                loss, metrics = family.train_loss(cfg, params, mb)
                g = torch.autograd.grad(loss * w, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(leaves, g)]
            names = list(metrics)
            vec = torch.stack([loss.detach().float()] + [
                torch.as_tensor(metrics[k]).detach().float()
                for k in names]) * w
            g_acc = g if g_acc is None else [a + x.float()
                                             for a, x in zip(g_acc, g)]
            v_acc = vec if v_acc is None else v_acc + vec
        for group in groups:
            v_acc = all_reduce_sum(v_acc, group)
        for i, axes in enumerate(sh.leaf_axes()):
            for a in sh.batch_axes():
                if a not in axes:
                    g_acc[i] = all_reduce_sum(g_acc[i], sh.group(a))
        v_acc, g_acc = v_acc / len(mbs), [g / len(mbs) for g in g_acc]
        return v_acc[0], dict(zip(names, v_acc[1:])), g_acc

    return loss_and_grads


def build_loss_and_grads(cfg, microbatches: int = 1, *,
                         sharded: bool = False) -> Callable:
    """``loss_and_grads(params, batch) -> (loss, metrics, grads)``: the loss
    and gradients of ``family.train_loss`` over ``microbatches`` slices of
    the batch (f32 gradient sums divided by their count, the losses and
    metrics averaged); ``grads`` follows ``adamw.tree_leaves(params)``,
    zeros for a leaf the loss does not reach. ``params``' leaves must
    require grad.

    Data parallel: under active sharding rules whose batch dimensions
    (``"pod"``, ``"data"``) have extent > 1, every rank is given the global
    batch, as the reference's step is, and trains on its own rows of each
    microbatch. Its loss (before the backward) and metrics are weighted by
    its share of the microbatch's tokens (the ``loss_mask``'s sum, or every
    label); they and the gradients are summed over those dimensions' groups
    in f32: the reference's token mean over the global microbatch, not a
    mean of the ranks' means. The
    MoE block sees the split (``BatchSplit``): it cuts the reference's
    groups of the global microbatch and takes its aux losses over every
    rank's tokens (``models/moe.py``). With no such rules the step is the
    single-process one, op for op.

    ``sharded=True`` (a config that ``sharded_step_gap`` passes, under
    active rules):
    ``params`` are this rank's shards (``shard_params``) and ``batch`` its
    rows (``local_batch``); ``grads`` are the shards' gradients
    (``_sharded_loss_and_grads``)."""
    if sharded:
        return _sharded_loss_and_grads(cfg, microbatches, _ShardedContext(cfg))
    family = get_family(cfg)

    def grads_of(params, leaves, mb, w=None):
        loss, metrics = family.train_loss(cfg, params, mb)
        grads = torch.autograd.grad(loss if w is None else loss * w, leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: torch.as_tensor(v).detach()
                               for k, v in metrics.items()}, grads

    def local(params, leaves, batch):
        if microbatches == 1:
            return grads_of(params, leaves, batch)
        g_acc, l_acc, mets = None, 0.0, []
        for mb in _split(batch, microbatches):
            loss, metrics, g = grads_of(params, leaves, mb)
            g_acc = ([x.float() for x in g] if g_acc is None
                     else [a + x.float() for a, x in zip(g_acc, g)])
            l_acc = l_acc + loss
            mets.append(metrics)
        metrics = {k: torch.stack([m[k] for m in mets]).float().mean()
                   for k in mets[0]}
        return l_acc / microbatches, metrics, [g / microbatches
                                               for g in g_acc]

    def data_parallel(params, leaves, batch, dp):
        groups, index, size = dp
        g_acc, v_acc, names = None, None, None
        mbs = [batch] if microbatches == 1 else _split(batch, microbatches)
        for mb in mbs:
            rows = {k: _rows(x, index, size) for k, x in mb.items()}
            w = _token_count(rows) / _token_count(mb).clamp_min(1.0)
            # the loss is weighted before its backward, so the MoE aux
            # losses' all_reduce sums the ranks' weighted upstream gradients
            with activate_batch_split(BatchSplit(tuple(groups), size)):
                loss, metrics, g = grads_of(params, leaves, rows, w)
            names = list(metrics)
            vec = torch.stack([loss.float()] + [metrics[k].float()
                                                for k in names]) * w
            g = [x.float() for x in g]
            g_acc = g if g_acc is None else [a + x for a, x in zip(g_acc, g)]
            v_acc = vec if v_acc is None else v_acc + vec
        for t in [v_acc, *g_acc]:
            for group in groups:
                dist.all_reduce(t, group=group)
        v_acc, g_acc = v_acc / len(mbs), [g / len(mbs) for g in g_acc]
        return v_acc[0], dict(zip(names, v_acc[1:])), g_acc

    def loss_and_grads(params, batch):
        leaves = adamw.tree_leaves(params)
        dp = _data_parallel(current_rules())
        if dp is None:
            return local(params, leaves, batch)
        return data_parallel(params, leaves, batch, dp)

    return loss_and_grads


def build_train_step(cfg, opt_cfg: adamw.AdamWConfig,
                     microbatches: int = 1, *,
                     sharded: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``build_loss_and_grads``' loss and gradients (data
    parallel under rules that split the batch), then ``adamw.update``,
    which writes the parameters in place. ``params``' leaves must require
    grad. Metrics: ``total_loss``, the family's metrics, ``grad_norm`` and
    ``lr``, as 0-d tensors.

    ``sharded=True``: every argument is this rank's shard (parameters from
    ``shard_params``, the optimizer state from ``adamw.init`` with the
    whole shapes, the batch from ``local_batch``), the gradient norm
    counts every element once (``ShardedParams.reduce_sq``), and an int8
    moment held at the reference's placement takes its gradient's last
    dimension gathered whole (``ShardedParams.last_gathers``)."""
    context = _ShardedContext(cfg) if sharded else None
    loss_and_grads = (_sharded_loss_and_grads(cfg, microbatches, context)
                      if sharded else build_loss_and_grads(cfg, microbatches))

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch)
        it = iter(grads)
        grad_tree = adamw.tree_map(lambda _: next(it), params)
        sh = context() if sharded else None
        params, opt_state, opt_metrics = adamw.update(
            opt_cfg, grad_tree, opt_state, params,
            reduce_sq=sh and sh.reduce_sq, gather_last=sh and sh.last_gathers)
        return params, opt_state, {"total_loss": loss, **metrics,
                                   **opt_metrics}

    return train_step


def _serve_split(sh, global_batch: int):
    """The sharded serve step's ``BatchSplit``: the batch dimensions that
    split the global batch of ``global_batch`` rows by the reference's rule
    (``local_serve_batch``'s), groups that split a MoE group gathered
    (``gather_groups``)."""
    axes = entry_axes(sh.rules.spec_for((global_batch,), ("batch",))[0])
    return BatchSplit(tuple(sh.group(a) for a in axes),
                      math.prod(sh.rules.axis_sizes[a] for a in axes),
                      gather_groups=True)


def _sharded_serve(cfg, global_batch, run):
    """A sharded serve step: ``run(sh, params, batch, *rest)`` under this
    rank's ``ShardedParams`` and the batch split, without autograd."""
    context = _ShardedContext(cfg, sharded_serve_gap)
    if global_batch is None:
        raise ValueError("a sharded serve step needs global_batch: the "
                         "batch's placement depends on it")

    def step(params, batch, *rest):
        sh = context()
        with torch.no_grad(), activate_sharded(sh), \
                activate_batch_split(_serve_split(sh, global_batch)):
            return run(sh, params, batch, *rest)

    return step


def build_prefill_step(cfg, *, sharded: bool = False,
                       global_batch: int | None = None) -> Callable:
    """Dense prefill: batch tokens (B,S) -> (logits (B,V), cache).

    ``sharded=True`` (a config that ``sharded_serve_gap`` passes, under
    active rules): ``params`` are this rank's shards (``shard_params`` of
    the ``cfg.dtype`` weights) and ``batch`` its rows
    (``local_serve_batch`` of a global batch of ``global_batch`` rows,
    which it needs: a batch that the batch dimensions do not divide is
    whole on every rank); the logits are its rows' (its vocabulary columns
    where the vocabulary is split) and the cache its block under the rules
    (``KV_CACHE_AXES``)."""
    family = get_family(cfg)
    if sharded:
        return _sharded_serve(cfg, global_batch, lambda sh, params, batch:
                              family.prefill(cfg, params, batch))

    def prefill_step(params, batch):
        return family.prefill(cfg, params, batch)

    return prefill_step


def build_decode_step(cfg, *, sharded: bool = False,
                      global_batch: int | None = None,
                      cache_len: int | None = None) -> Callable:
    """Decode over a dense cache: batch tokens (B,1), pos (B,) ->
    (next_token (B,), logits (B,V), cache).

    ``sharded=True`` (a config that ``sharded_serve_gap`` passes, under
    active rules): ``params`` are this rank's shards, ``batch`` its rows
    of a global batch of ``global_batch`` rows (``local_serve_batch``) and
    ``cache`` its block (``shard_tree`` by ``cache_axes``) of a cache of
    ``cache_len`` positions: the cache split by sequence
    (``cache_seq``) is attended with partial softmaxes combined over its
    ranks, the new K/V row written by its owner alone
    (``layers._decode_attention_sharded``). ``next_token`` is the global
    argmax over the vocabulary shards (``layers.global_argmax``, the same
    on every rank), ``logits`` this rank's rows and vocabulary columns."""
    family = get_family(cfg)
    if sharded:
        def run(sh, params, batch, cache):
            block = family.cache_block(cfg, sh, global_batch, cache_len)
            logits, cache = family.decode(cfg, params, batch, cache,
                                          block=block)
            return L.global_argmax(cfg, logits), logits, cache

        step = _sharded_serve(cfg, global_batch, run)
        if cache_len is None:
            raise ValueError("the sharded decode step needs cache_len: the "
                             "cache's placement depends on it")
        return step

    def decode_step(params, batch, cache):
        logits, cache = family.decode(cfg, params, batch, cache)
        return _argmax(logits), logits, cache

    return decode_step


def build_prefill_ragged_step(cfg) -> Callable:
    """Dense admission of right-padded prompts: batch tokens (B,S), length
    (B,) -> (next_token (B,) from the logits at ``length - 1``, logits
    (B,V), cache {"k","v"} (L,B,S,KV,hd))."""
    family = get_family(cfg)

    def prefill_ragged_step(params, batch):
        logits, cache = family.prefill_ragged(cfg, params, batch)
        return _argmax(logits), logits, cache

    return prefill_ragged_step


def build_paged_decode_step(cfg) -> Callable:
    """Decode step: batch tokens (B,1), pos (B,), page_table (B,npages) ->
    (next_token (B,), logits (B,V), pool)."""
    family = get_family(cfg)

    def paged_decode_step(params, batch, pool):
        logits, pool = family.decode_paged(cfg, params, batch, pool)
        return _argmax(logits), logits, pool

    return paged_decode_step


def build_paged_prefill_step(cfg) -> Callable:
    """Chunked-prefill step: C prompt tokens per request scattered straight
    into pool pages -> (next_token (B,), logits (B,V), pool)."""
    family = get_family(cfg)

    def paged_prefill_step(params, batch, pool):
        logits, pool = family.prefill_paged(cfg, params, batch, pool)
        return _argmax(logits), logits, pool

    return paged_prefill_step


def build_paged_verify_step(cfg) -> Callable:
    """Speculative-verify step: the greedy next token at EVERY window
    position -> (next_tokens (B,T), logits (B,T,V), pool)."""
    family = get_family(cfg)

    def paged_verify_step(params, batch, pool):
        logits, pool = family.decode_verify(cfg, params, batch, pool)
        return _argmax(logits), logits, pool

    return paged_verify_step


def build_fused_spec_step(cfg, draft_fn) -> Callable:
    """Draft + multi-query verify in one step (speculative decode).

    ``draft_fn(hist, cur, pos) -> (S, K)`` proposes drafts (e.g.
    :func:`repro_torch.serve.drafting.build_ngram_draft`). batch: cur (S,),
    pos (S,), hist (S, hlen), page_table (S, npages), write_limit (S,).
    Returns ``(window, drafts, next_tokens, pool)`` with window = [cur |
    drafts] and next_tokens[:, i] the greedy token after window[:, :i+1].
    """
    family = get_family(cfg)

    def fused_spec_step(params, batch, pool):
        drafts = draft_fn(batch["hist"], batch["cur"], batch["pos"])
        window = torch.cat([batch["cur"][:, None], drafts], dim=1)
        vbatch = {"tokens": window, "pos": batch["pos"],
                  "page_table": batch["page_table"],
                  "write_limit": batch["write_limit"]}
        logits, pool = family.decode_verify(cfg, params, vbatch, pool)
        return window, drafts, _argmax(logits), pool

    return fused_spec_step


def build_encode_step(cfg, *, sharded: bool = False,
                      global_batch: int | None = None) -> Callable:
    """Encoder-only serve step (HuBERT): batch frames (B,S,frontend_dim) ->
    per-frame logits (B,S,V). ``sharded=True``: as ``build_prefill_step``'s;
    the logits are this rank's rows (and vocabulary columns where the
    vocabulary is split)."""
    family = get_family(cfg)
    if sharded:
        return _sharded_serve(cfg, global_batch, lambda sh, params, batch:
                              family.prefill(cfg, params, batch)[0])

    def encode_step(params, batch):
        logits, _ = family.prefill(cfg, params, batch)
        return logits

    return encode_step
