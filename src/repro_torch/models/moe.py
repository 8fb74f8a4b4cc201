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

Training splits the batch over data-parallel ranks (either train step,
under a ``BatchSplit``, ``distributed/collectives.py``). The groups are
then the reference's: ``min(moe_group_size, global tokens)``, whole groups
a rank (a rank whose rows split a group raises; the reference would
replicate the groups instead). The aux losses are the reference's global
ones: their token sums are all-reduced over the batch dimensions before
the products and means, so the load-balance loss is the product of the
global batch's means, not a mean of the ranks' products. The sharded
serve steps split the batch too; where a rank's rows split a group (a
``decode_32k`` step's 128 tokens, 8 a data rank, are one group of 128),
the normed tokens of the global batch are gathered over the batch
dimensions and every rank routes and dispatches them all, as the
reference replicates them, keeping its rows of the output (the aux
losses are then the gathered batch's, with no all-reduce).

The sharded train step places the experts over ``"model"`` (expert
parallelism) and FSDP over ``"data"``: ``moe_block`` routes every token
on every model rank with the whole router, then dispatches, runs and
combines only the rank's experts; the partial outputs (and Arctic's
column- then row-parallel dense branch) are summed by one ``reduce_from``.
On one rank every step reduces to the replicated block's operations.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed.collectives import (all_reduce, copy_to,
                                       current_batch_split, current_sharded,
                                       gather_repeated, reduce_from)
from .layers import _act, _model_group, norm_spec, rmsnorm
from .params import ParamSpec


def moe_param_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "norm": norm_spec(d),
        "router": ParamSpec((d, e), ("embed", "experts"), dtype="float32"),
        "we_gate": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "we_up": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "we_down": ParamSpec((e, f, d), ("experts", "moe_mlp", "embed")),
    }
    if cfg.moe_dense_ff:
        fd = cfg.moe_dense_ff
        specs["dense_gate"] = ParamSpec((d, fd), ("embed", "mlp"))
        specs["dense_up"] = ParamSpec((d, fd), ("embed", "mlp"))
        specs["dense_down"] = ParamSpec((fd, d), ("mlp", "embed"))
    return specs


def expert_capacity(cfg, group_size: int) -> int:
    return max(1, math.ceil(group_size * cfg.experts_per_token
                            / cfg.num_experts * cfg.capacity_factor))


def _route(cfg, p, xg):
    """f32 router ``p["router"]`` over xg (g,s,d): (logits, probs,
    gate_vals, sel), the top-k gates renormalised to sum to one."""
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


def _positions(one_hot):
    """Each assignment's slot in its expert (g,ks,e): the assignments to
    that expert ahead of it, an integer cumulative sum (exact, and
    deterministic on CUDA, where a floating one is not)."""
    return torch.cumsum(one_hot, dim=1, dtype=torch.int32) - one_hot


def _einsum_dispatch(cfg, xg, gate_vals, sel, cap, experts=None):
    """One-hot dispatch and combine tensors (g,s,e',c) for the experts
    ``[e0, e1)`` (e' of them; default all): returns (ein (e',g,c,d),
    undispatch, kept assignments over every expert). The positions and
    drops are taken over every expert; only the experts' own slots are
    built."""
    dt = xg.dtype
    g, gs, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e0, e1 = experts or (0, e)
    flat = _priority(F.one_hot(sel, e).to(torch.int32))      # (g,ks,e)
    pos = _positions(flat)
    keep = (pos < cap) & (flat > 0)
    kept = keep.sum()
    pos, keep = pos[..., e0:e1], keep[..., e0:e1].float()
    slot_1h = (pos[..., None] == torch.arange(cap, device=xg.device)
               ).float() * keep[..., None]                    # (g,ks,e',c)
    gate_flat = _priority(gate_vals)                          # (g,ks)
    combine = (gate_flat[:, :, None, None] * slot_1h).reshape(
        g, k, gs, e1 - e0, cap).sum(dim=1)                    # (g,s,e',c)
    dispatch = (combine > 0.0).to(dt)
    ein = torch.einsum("gsec,gsd->egcd", dispatch, xg)

    def undispatch(eo):
        return torch.einsum("gsec,egcd->gsd", combine.to(dt), eo)

    return ein, undispatch, kept


def _sort_dispatch(cfg, xg, gate_vals, sel, cap, experts=None):
    """Scatter token rows into (e',g,c,d) buffers of the experts ``[e0,
    e1)`` (default all) by slot index, with the einsum dispatch's drops
    (taken over every expert); the combine gathers them back and sums a
    token's rows."""
    dt = xg.dtype
    g, gs, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e0, e1 = experts or (0, e)
    n = (e1 - e0) * cap                                       # local slots
    sel_flat = _priority(sel)                                 # (g,ks)
    gate_flat = _priority(gate_vals)
    tok_idx = torch.arange(gs, device=xg.device).repeat(k)    # (ks,)
    sel_1h = F.one_hot(sel_flat, e).to(torch.int32)           # (g,ks,e)
    pos = (_positions(sel_1h) * sel_1h).sum(-1)
    keep = pos < cap
    kept = keep.sum()
    mine = keep & (sel_flat >= e0) & (sel_flat < e1)
    slot = torch.where(mine, (sel_flat - e0) * cap + pos, n)  # else: sentinel
    gidx = torch.arange(g, device=xg.device)[:, None]
    buf = xg.new_zeros((g, n + 1, d))
    buf[gidx, slot] = xg[:, tok_idx]
    ein = buf[:, :-1].reshape(g, e1 - e0, cap, d).transpose(0, 1)

    def undispatch(eo):
        flat_eo = eo.transpose(0, 1).reshape(g, n, d)
        rows = flat_eo[gidx, slot.clamp(max=n - 1)]
        rows = torch.where(mine[..., None], rows, 0.0)
        contrib = rows * gate_flat[..., None].to(dt)          # (g,ks,d)
        return contrib.reshape(g, k, gs, d).sum(dim=1)

    return ein, undispatch, kept


def _whole_groups(cfg, tokens: int, ranks: int) -> bool:
    """This rank's ``tokens`` hold whole groups of the global batch
    (``ranks`` row blocks of ``tokens``), or one rank holds it all."""
    return ranks == 1 or tokens % min(cfg.moe_group_size, tokens * ranks) == 0


def _groups(cfg, tokens: int, ranks: int = 1):
    """[(groups, group size)] of this rank's ``tokens``, ``ranks`` of which
    hold other rows of the batch: the reference's groups of
    ``min(moe_group_size, tokens * ranks)`` of the global batch, whole
    groups a rank (raises where a rank's rows split a group). On one rank,
    a ragged last group of its own size follows the whole ones, if any."""
    gs = min(cfg.moe_group_size, tokens * ranks)
    n, rest = divmod(tokens, gs)
    if not _whole_groups(cfg, tokens, ranks):
        raise ValueError(
            f"{cfg.name}: {tokens} tokens a rank, {ranks} ranks, do not hold "
            f"whole MoE groups of {gs} (moe_group_size "
            f"{cfg.moe_group_size}): each rank's rows must hold whole groups "
            f"of the global batch")
    return [(n, gs)] + ([(1, rest)] if rest else [])


def moe_block(cfg, p, x):
    """x: (B,S,D) -> (x + y, aux). Pre-norm block, residual added inside.

    Under the sharded step with the experts split over ``"model"``
    (``distributed/collectives.py``): the router is gathered whole
    (``gather_repeated``) and every model rank routes every token; the
    expert input and the gates enter the rank's experts through
    ``copy_to``; the dispatch, the FFNs and the combine cover only the
    rank's experts; Arctic's dense branch is column- then row-parallel;
    one ``reduce_from`` sums the experts' and the dense branch's partial
    outputs. Under a ``BatchSplit`` (either train step, data parallel) the
    groups are the global batch's and the aux losses are global: token
    sums all-reduced over the batch dimensions (``all_reduce``). A serve
    step's split (``gather_groups``) whose rows split a group gathers the
    global batch's normed tokens, routes them all and keeps this rank's
    rows of the output."""
    b, s, d = x.shape
    e, dt = cfg.num_experts, cfg.cdtype
    # the specs only under the sharded step: the replicated path builds none
    specs = moe_param_specs(cfg) if current_sharded() is not None else None
    split = current_batch_split()
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    rows = None
    if (split is not None and split.gather_groups
            and not _whole_groups(cfg, b * s, split.ranks)):
        # a serve step whose rows split a group: every rank of the batch
        # group routes the whole global batch, as the reference replicates
        # it, and keeps its rows of the output
        rows = slice(split.index() * b, (split.index() + 1) * b)
        xn = split.gather_rows(xn)
        b, split = xn.shape[0], None
    egroup = _model_group(lambda: specs["we_gate"], 0)
    dgroup = (_model_group(lambda: specs["dense_gate"], 1)
              if cfg.moe_dense_ff else None)
    router, experts, xe, xd = p, None, xn, xn
    if egroup is not None:
        router = {"router": gather_repeated(p["router"], 1, egroup)}
        experts = current_sharded().expert_range(specs["we_gate"])
        xe = copy_to(xn, egroup)
    if dgroup is not None:
        xd = xe if egroup is not None else copy_to(xn, dgroup)
    dispatch_fn = (_sort_dispatch if cfg.moe_impl == "sort"
                   else _einsum_dispatch)
    xs, xes = xn.reshape(b * s, d), xe.reshape(b * s, d)
    ys, logits_all, probs_all, top1 = [], [], [], []
    kept, start = 0, 0
    for n, gs in _groups(cfg, b * s, split.ranks if split else 1):
        xg = xs[start:start + n * gs].reshape(n, gs, d)
        xeg = xes[start:start + n * gs].reshape(n, gs, d)
        start += n * gs
        logits, probs, gate_vals, sel = _route(cfg, router, xg)
        if egroup is not None:
            gate_vals = copy_to(gate_vals, egroup)
        ein, undispatch, n_kept = dispatch_fn(
            cfg, xeg, gate_vals, sel, expert_capacity(cfg, gs), experts)
        # expert FFNs: (e', g*c, d) batched over this rank's experts
        h_in = ein.reshape(ein.shape[0], -1, d)
        hg = torch.bmm(h_in, p["we_gate"].to(dt))
        hu = torch.bmm(h_in, p["we_up"].to(dt))
        eo = torch.bmm(_act(cfg.mlp_act, hg) * hu, p["we_down"].to(dt))
        ys.append(undispatch(eo.reshape(ein.shape)).reshape(-1, d))
        logits_all.append(logits.reshape(-1, e))
        probs_all.append(probs.reshape(-1, e))
        top1.append(sel[..., 0].reshape(-1))
        kept = kept + n_kept
    y = torch.cat(ys).reshape(b, s, d)
    if rows is not None:
        y, xd = y[rows], xd[rows]
    # the partial sums over "model" (the rank's experts, the dense branch's
    # columns) are reduced once, after the two are added where both are
    group = egroup if egroup is not None else dgroup
    if cfg.moe_dense_ff:                       # Arctic's dense residual branch
        h = _act(cfg.mlp_act, xd @ p["dense_gate"].to(dt)) \
            * (xd @ p["dense_up"].to(dt))
        yd = h @ p["dense_down"].to(dt)
        if (egroup is None) != (dgroup is None):   # one partial, one whole
            if egroup is not None:
                y = reduce_from(y, group)
            else:
                yd = reduce_from(yd, group)
            group = None
        y = y + yd
    if group is not None:
        y = reduce_from(y, group)
    aux = _aux_losses(cfg, torch.cat(logits_all), torch.cat(probs_all),
                      torch.cat(top1), kept, split)
    return x + y, aux


def _aux_losses(cfg, logits, probs, top1, kept, split):
    """The Switch load-balance loss ``e * sum_e f_e P_e`` (f the share of
    tokens routed top-1 to e, P the mean router probability), the router
    z-loss and the dropped share of assignments, each over every token of
    the global batch: this rank's token sums, all-reduced over ``split``'s
    groups (``all_reduce``: the gradient of P and of the z-loss counted
    once over the ranks), divided by the global token count."""
    e = cfg.num_experts
    tokens = logits.shape[0] * (split.ranks if split else 1)
    sums = torch.cat([
        probs.sum(dim=0),
        (torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
        F.one_hot(top1, e).float().sum(dim=0),
        torch.as_tensor(kept, device=probs.device).float()[None]])
    if split is not None:
        for group in split.groups:
            sums = all_reduce(sums, group)
    p_e, z, f_e, kept = (sums / tokens).split([e, 1, e, 1])
    lb_loss = e * torch.sum(f_e.detach() * p_e)
    drop = 1.0 - kept.detach()[0] / cfg.experts_per_token
    return {"moe_lb_loss": lb_loss, "moe_z_loss": z[0],
            "moe_drop_frac": drop}
