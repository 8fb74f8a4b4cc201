"""Step construction: the training step (microbatched gradient accumulation
in f32, AdamW), and the serving steps: the static engine's dense prefill
and decode steps, the continuous engine's dense (ragged) admission step,
its steps over the shared paged KV pool, and the encoder-only encode
step.

Each builder returns a plain function that runs one model pass and, for
the decode-like steps, takes the greedy argmax over the compute-dtype
logits (ties resolve to the first index, as in the reference). Pools and
decode caches are updated in place and returned.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import get_family
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


def build_train_step(cfg, opt_cfg: adamw.AdamWConfig,
                     microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and gradients of ``family.train_loss`` over
    ``microbatches`` slices of the batch (f32 gradient sums divided by
    their count, the losses and metrics averaged), then ``adamw.update``,
    which writes the parameters in place. ``params``' leaves must require
    grad. Metrics: ``total_loss``, the family's metrics, ``grad_norm`` and
    ``lr``, as 0-d tensors."""
    family = get_family(cfg)

    def grads_of(params, leaves, mb):
        loss, metrics = family.train_loss(cfg, params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: torch.as_tensor(v).detach()
                               for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        leaves = adamw.tree_leaves(params)
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
        else:
            g_acc, l_acc, mets = None, 0.0, []
            for mb in _split(batch, microbatches):
                loss, metrics, g = grads_of(params, leaves, mb)
                g_acc = ([x.float() for x in g] if g_acc is None
                         else [a + x.float() for a, x in zip(g_acc, g)])
                l_acc = l_acc + loss
                mets.append(metrics)
            grads = [g / microbatches for g in g_acc]
            loss = l_acc / microbatches
            metrics = {k: torch.stack([m[k] for m in mets]).float().mean()
                       for k in mets[0]}
        it = iter(grads)
        grad_tree = adamw.tree_map(lambda _: next(it), params)
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grad_tree,
                                                      opt_state, params)
        return params, opt_state, {"total_loss": loss, **metrics,
                                   **opt_metrics}

    return train_step


def build_prefill_step(cfg) -> Callable:
    """Dense prefill: batch tokens (B,S) -> (logits (B,V), cache)."""
    family = get_family(cfg)

    def prefill_step(params, batch):
        return family.prefill(cfg, params, batch)

    return prefill_step


def build_decode_step(cfg) -> Callable:
    """Decode over a dense cache: batch tokens (B,1), pos (B,) ->
    (next_token (B,), logits (B,V), cache)."""
    family = get_family(cfg)

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


def build_encode_step(cfg) -> Callable:
    """Encoder-only serve step (HuBERT): batch frames (B,S,frontend_dim) ->
    per-frame logits (B,S,V)."""
    family = get_family(cfg)

    def encode_step(params, batch):
        logits, _ = family.prefill(cfg, params, batch)
        return logits

    return encode_step
