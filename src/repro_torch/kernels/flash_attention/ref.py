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
