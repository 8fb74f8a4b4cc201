"""Plain PyTorch version of dense GQA attention (causal optional): the
oracle of the flash-attention kernel and what the CPU path runs."""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def attention_reference(q, k, v, *, causal: bool = True):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd) in q's dtype. f32
    scores and softmax; key j is visible to query i when j <= i if causal."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, h // nkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention_lse_reference(q, k, v, *, causal: bool = True):
    """The rows' natural log-sum-exp of the scaled scores (B,H,Sq) f32: what
    the forward kernel writes for the backward."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, h // nkv, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, MASK_VALUE)
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_bwd_reference(q, k, v, dout, *, causal: bool = True):
    """(dq, dk, dv) of ``attention_reference`` for the output gradient
    ``dout``, by autograd: the plain version of the backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_reference(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)
