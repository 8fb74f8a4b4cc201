"""Mixture-of-Experts FFN with GShard-style capacity-bounded dispatch.

The reference's ``moe_block``: tokens are cut into groups of
``moe_group_size``; each token's router picks its top-k experts; every
expert takes at most ``expert_capacity`` assignments a group, the first
choices of all tokens before any second choice, and the rest are dropped.
The expert FFNs are three batched products over expert-stacked weights,
cast to the compute dtype at their use.
Arctic's dense residual branch (a dense FFN beside the routed experts) runs
under ``cfg.moe_dense_ff``. Aux outputs: the Switch load-balance loss, the
router z-loss and the dropped share of assignments.

Two dispatches with the same drops: ``"einsum"`` (the default, the GShard
one-hot dispatch and combine tensors) and ``"sort"`` (gather and scatter by
slot index). Neither is a Pallas kernel in the reference, so both stay
plain tensor products and indexing here.

A ragged last group (tokens not a multiple of the group size) is routed as
a group of its own size, with that size's capacity. The reference asserts
a whole number of groups there; the port departs on purpose
(src/repro_torch/README.md).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _act, norm_spec, rmsnorm
from .params import ParamSpec


def moe_param_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "norm": norm_spec(d),
        "router": ParamSpec((d, e), dtype="float32", experts=True),
        "we_gate": ParamSpec((e, d, f), experts=True),
        "we_up": ParamSpec((e, d, f), experts=True),
        "we_down": ParamSpec((e, f, d), experts=True),
    }
    if cfg.moe_dense_ff:
        fd = cfg.moe_dense_ff
        specs["dense_gate"] = ParamSpec((d, fd))
        specs["dense_up"] = ParamSpec((d, fd))
        specs["dense_down"] = ParamSpec((fd, d))
    return specs


def expert_capacity(cfg, group_size: int) -> int:
    return max(1, math.ceil(group_size * cfg.experts_per_token
                            / cfg.num_experts * cfg.capacity_factor))


def _route(cfg, p, xg):
    """f32 router over xg (g,s,d): (logits, probs, gate_vals, sel), the
    top-k gates renormalised to sum to one."""
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, sel


def _priority(t):
    """(g,s,k,...) -> (g,k*s,...): every token's first choice ahead of any
    token's second choice."""
    g, s, k = t.shape[:3]
    return t.transpose(1, 2).reshape(g, k * s, *t.shape[3:])


def _einsum_dispatch(cfg, xg, gate_vals, sel, cap):
    """One-hot dispatch and combine tensors (g,s,e,c): returns (ein
    (e,g,c,d), undispatch, kept assignments)."""
    dt = xg.dtype
    g, gs, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    flat = _priority(F.one_hot(sel, e).float())                # (g,ks,e)
    pos = torch.cumsum(flat, dim=1) - flat                    # slots before me
    keep = (pos < cap).float() * flat
    slot_1h = (pos[..., None] == torch.arange(cap, device=xg.device)
               ).float() * keep[..., None]                    # (g,ks,e,c)
    gate_flat = _priority(gate_vals)                          # (g,ks)
    combine = (gate_flat[:, :, None, None] * slot_1h).reshape(
        g, k, gs, e, cap).sum(dim=1)                          # (g,s,e,c)
    dispatch = (combine > 0.0).to(dt)
    ein = torch.einsum("gsec,gsd->egcd", dispatch, xg)

    def undispatch(eo):
        return torch.einsum("gsec,egcd->gsd", combine.to(dt), eo)

    return ein, undispatch, keep.sum()


def _sort_dispatch(cfg, xg, gate_vals, sel, cap):
    """Scatter token rows into (e,g,c,d) expert buffers by slot index, with
    the einsum dispatch's drops; the combine gathers them back and sums a
    token's k rows."""
    dt = xg.dtype
    g, gs, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    sel_flat = _priority(sel)                                 # (g,ks)
    gate_flat = _priority(gate_vals)
    tok_idx = torch.arange(gs, device=xg.device).repeat(k)    # (ks,)
    sel_1h = F.one_hot(sel_flat, e).float()                   # (g,ks,e)
    pos = ((torch.cumsum(sel_1h, dim=1) - sel_1h) * sel_1h).sum(-1).long()
    keep = pos < cap
    slot = torch.where(keep, sel_flat * cap + pos, e * cap)   # dropped: sentinel
    gidx = torch.arange(g, device=xg.device)[:, None]
    buf = xg.new_zeros((g, e * cap + 1, d))
    buf[gidx, slot] = xg[:, tok_idx]
    ein = buf[:, :-1].reshape(g, e, cap, d).transpose(0, 1)

    def undispatch(eo):
        flat_eo = eo.transpose(0, 1).reshape(g, e * cap, d)
        rows = flat_eo[gidx, slot.clamp(max=e * cap - 1)]
        rows = torch.where(keep[..., None], rows, 0.0)
        contrib = rows * gate_flat[..., None].to(dt)          # (g,ks,d)
        return contrib.reshape(g, k, gs, d).sum(dim=1)

    return ein, undispatch, keep.sum()


def _groups(cfg, tokens: int):
    """[(groups, group size)]: whole groups of ``min(moe_group_size,
    tokens)``, then a ragged last group of its own size, if any."""
    gs = min(cfg.moe_group_size, tokens)
    n, rest = divmod(tokens, gs)
    return [(n, gs)] + ([(1, rest)] if rest else [])


def moe_block(cfg, p, x):
    """x: (B,S,D) -> (x + y, aux). Pre-norm block, residual added inside."""
    b, s, d = x.shape
    e, dt = cfg.num_experts, cfg.cdtype
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    dispatch_fn = (_sort_dispatch if cfg.moe_impl == "sort"
                   else _einsum_dispatch)
    xs = xn.reshape(b * s, d)
    ys, logits_all, probs_all, top1 = [], [], [], []
    kept, start = 0.0, 0
    for n, gs in _groups(cfg, b * s):
        xg = xs[start:start + n * gs].reshape(n, gs, d)
        start += n * gs
        logits, probs, gate_vals, sel = _route(cfg, p, xg)
        ein, undispatch, n_kept = dispatch_fn(cfg, xg, gate_vals, sel,
                                              expert_capacity(cfg, gs))
        # expert FFNs: (e, g*c, d) batched over experts
        h_in = ein.reshape(e, -1, d)
        hg = torch.bmm(h_in, p["we_gate"].to(dt))
        hu = torch.bmm(h_in, p["we_up"].to(dt))
        eo = torch.bmm(_act(cfg.mlp_act, hg) * hu, p["we_down"].to(dt))
        ys.append(undispatch(eo.reshape(ein.shape)).reshape(-1, d))
        logits_all.append(logits.reshape(-1, e))
        probs_all.append(probs.reshape(-1, e))
        top1.append(sel[..., 0].reshape(-1))
        kept = kept + n_kept
    y = torch.cat(ys).reshape(b, s, d)

    if cfg.moe_dense_ff:                       # Arctic's dense residual branch
        h = _act(cfg.mlp_act, xn @ p["dense_gate"].to(dt)) \
            * (xn @ p["dense_up"].to(dt))
        y = y + h @ p["dense_down"].to(dt)

    # Switch load balance: e * sum_e f_e P_e (f = share routed top-1).
    logits, probs = torch.cat(logits_all), torch.cat(probs_all)
    f_e = F.one_hot(torch.cat(top1), e).float().mean(dim=0)
    lb_loss = e * torch.sum(f_e * probs.mean(dim=0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    assignments = b * s * cfg.experts_per_token
    aux = {"moe_lb_loss": lb_loss,
           "moe_z_loss": z_loss,
           "moe_drop_frac": 1.0 - kept / max(assignments, 1)}
    return x + y, aux
