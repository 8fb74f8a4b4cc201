"""Plain PyTorch version of dense GQA attention (causal optional): the
oracle of the flash-attention kernel and what the CPU path runs."""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def _scores(q, k, causal: bool):
    """The scaled, masked f32 scores (B,KV,G,Sq,Skv) of q (B,Sq,H,hd) against
    k (B,Skv,KV,hd): key j is visible to query i when j <= i if causal."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, h // nkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, MASK_VALUE)
    return s


def _weighted(s, v, q):
    """softmax(``s``) applied to v -> (B,Sq,H,hd) in q's dtype."""
    out = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(q.shape).to(q.dtype)


def attention_reference(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd) in q's dtype. f32
    scores and softmax; key j is visible to query i when j <= i if causal."""
    return _weighted(_scores(q, k, causal), v, q)


def attention_lse_reference(q, k, v, *, causal: bool = True):
    """The rows' natural log-sum-exp of the scaled scores (B,H,Sq) f32: what
    the forward kernel writes for the backward."""
    b, sq, h, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(b, h, sq)


def attention_out_lse_reference(q, k, v, *, causal: bool = True):
    """(``attention_reference``'s output, ``attention_lse_reference``'s
    log-sum-exp) from one score matrix, as the forward kernel writes them
    with ``return_lse``."""
    b, sq, h, _ = q.shape
    s = _scores(q, k, causal)
    return (_weighted(s, v, q),
            torch.logsumexp(s, dim=-1).reshape(b, h, sq))


def attention_bwd_reference(q, k, v, dout, *, causal: bool = True):
    """(dq, dk, dv) of ``attention_reference`` for the output gradient
    ``dout``, by autograd: the plain version of the backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_reference(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def attention_bwd_lse_reference(q, k, v, out, dout, lse, *,
                                causal: bool = True):
    """(dq, dk, dv) of one attention block under the backward kernel's own
    contract: the probabilities exp(s - ``lse``) and delta =
    rowsum(``dout`` * ``out``) are built from the ``out`` (B,Sq,H,hd) and
    ``lse`` (B,H,Sq) given, not recomputed. A ring block passes the merged
    output and log-sum-exp of every block a query row sees, so the result
    is that block's share of the whole gradient. f32 arithmetic, results
    in q's dtype."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = h // nkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, nkv, g, hd).float()
    dog = dout.reshape(b, sq, nkv, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, MASK_VALUE)
    p = torch.exp(s - lse.reshape(b, nkv, g, sq, 1))
    delta = (dout.float() * out.float()).sum(-1)                # (B,Sq,H)
    delta = delta.permute(0, 2, 1).reshape(b, nkv, g, sq, 1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
