"""Ring attention over the ``"model"`` dimension of a DeviceMesh (Liu et
al., arXiv:2310.01889: blockwise ring attention), the counterpart of the
reference's ``ring_attention`` / ``ring_attention_sharded``.

It exists for architectures whose head count does not divide the model
axis (Arctic 56H, StarCoder2 36H, PaliGemma 8H): instead of replicating
attention over that axis, each of its R ranks holds one sequence shard of
Q, K and V. In R steps a rank attends its Q shard to the K/V block it
holds, then passes that block to the next rank, so every Q shard meets
every K/V block once and the full K/V never sits on one rank.

- Block step: one launch of the flash-attention forward kernel with its
  row log-sum-exp (``flash_attention_fwd(..., return_lse=True)``) on a CUDA
  tensor, its plain version on a CPU one; ``causal=True`` on the diagonal
  block (the kernel's mask is top-left aligned, which is right there
  because both shards start at the same offset), ``causal=False`` below
  it. A block entirely in the future of the Q shard is skipped: in the
  reference's merge its weight is exactly 0, since step 0 is always the
  diagonal block and every query row sees itself.
- Merge: the partial outputs combine in f32 through their log-sum-exps,
  the reference's online-softmax merge (``_merge``) in normalised form.
- Backward (``torch.autograd.Function``): the ring again, each visible
  block through the backward kernel (``flash_attention_bwd``, or
  ``attention_bwd_lse_reference`` on the CPU) with the MERGED output and
  log-sum-exp, which makes its result that block's share of the gradient.
  dQ accumulates on its rank in f32; dK and dV accumulate in f32 beside
  the K/V block they belong to, travel with it and arrive home after R
  hops. The order of every sum is fixed and nothing is atomic, so a run
  repeats bit for bit.

``ring_attention_sharded`` runs this across ranks: K/V move to the next
rank of the model dimension's group with ``batch_isend_irecv`` (no P2P call
when R = 1, where the reference's ``ppermute`` to self is the identity).
``ring_attention_single_device`` runs the same steps for R shards on one
device, the P2P replaced by a rotation of a list: NCCL cannot place two
ranks on one GPU, so this is how R > 1 runs through the kernels on one
card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels._meta import on_kernel_route
from ..kernels.flash_attention import (attention_bwd_lse_reference,
                                       attention_out_lse_reference,
                                       flash_attention_bwd,
                                       flash_attention_fwd)


def _block_fwd(q, k, v, causal):
    """(out in q's dtype, lse (B,H,Sq) f32) of one block."""
    if on_kernel_route(q):
        return flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    return attention_out_lse_reference(q, k, v, causal=causal)


def _block_bwd(q, k, v, out, dout, lse, causal):
    if on_kernel_route(q):
        return flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    return attention_bwd_lse_reference(q, k, v, out, dout, lse,
                                       causal=causal)


def _merge(o1, l1, o2, l2):
    """Two normalised partials (out (B,S,H,hd), lse (B,H,S)) -> the merged
    pair, in f32."""
    lse = torch.logaddexp(l1, l2)
    w1 = torch.exp(l1 - lse).transpose(1, 2)[..., None]
    w2 = torch.exp(l2 - lse).transpose(1, 2)[..., None]
    return o1.float() * w1 + o2.float() * w2, lse


def _steps(ring, causal):
    """Per step t, (position in ``ring.ranks``, diagonal?) of each visible
    block: rank i holds at step t the block of rank j = i - t (mod R),
    visible unless causal and j > i."""
    for t in range(ring.r):
        blocks = []
        for a, i in enumerate(ring.ranks):
            j = (i - t) % ring.r
            if not (causal and j > i):
                blocks.append((a, causal and j == i))
        yield t, blocks


def _ring_fwd(ring, qs, ks, vs, causal):
    outs, lses = [None] * len(qs), [None] * len(qs)
    kv = list(zip(ks, vs))
    for t, blocks in _steps(ring, causal):
        for a, diag in blocks:
            o, lse = _block_fwd(qs[a], *kv[a], diag)
            if outs[a] is None:            # step 0: the diagonal block
                outs[a], lses[a] = o, lse
            else:
                outs[a], lses[a] = _merge(outs[a], lses[a], o, lse)
        if t < ring.r - 1:
            kv = ring.rotate(kv)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_bwd(ring, qs, ks, vs, outs, douts, lses, causal):
    def f32_zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    dqs = [f32_zeros(q) for q in qs]
    travel = [(k, v, f32_zeros(k), f32_zeros(v)) for k, v in zip(ks, vs)]
    for t, blocks in _steps(ring, causal):
        for a, diag in blocks:
            k, v, dk, dv = travel[a]
            gq, gk, gv = _block_bwd(qs[a], k, v, outs[a], douts[a], lses[a],
                                    diag)
            dqs[a].add_(gq)
            dk.add_(gk)
            dv.add_(gv)
        if t < ring.r - 1:
            travel = ring.rotate(travel)
    # one more hop takes every dK/dV accumulator home
    home = ring.rotate([(dk, dv) for _, _, dk, dv in travel])
    return (dqs, [dk for dk, _ in home], [dv for _, dv in home])


class _LocalRing:
    """R sequence shards on one device: every rank's step runs here, and a
    hop rotates the list of blocks (rank a receives rank a - 1's)."""

    def __init__(self, r: int):
        self.r, self.ranks = r, list(range(r))

    def split(self, x):
        return [_shard(x, self.r, i) for i in self.ranks]

    def rotate(self, items):
        return items[-1:] + items[:-1]

    def gather(self, parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class _GroupRing:
    """This rank's place in the model dimension's process group: its own
    shard, P2P hops to rank i + 1 (receiving from i - 1), and all-gathers
    over the group."""

    def __init__(self, group):
        self.group = group
        self.r = dist.get_world_size(group)
        self.i = dist.get_rank(group)
        self.ranks = [self.i]

    def split(self, x):
        return [_shard(x, self.r, self.i)]

    def rotate(self, items):
        if self.r == 1:
            return items
        dst = dist.get_global_rank(self.group, (self.i + 1) % self.r)
        src = dist.get_global_rank(self.group, (self.i - 1) % self.r)
        (sent,) = items
        got = tuple(torch.empty_like(x) for x in sent)
        ops = []
        for tag, (x, buf) in enumerate(zip(sent, got)):
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dst,
                                  self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]

    def gather(self, parts):
        (x,) = parts
        if self.r == 1:
            return x
        out = [torch.empty_like(x) for _ in range(self.r)]
        # not torch.distributed.nn's all_gather: its backward sums over the
        # ranks, which would scale a replicated loss's gradient by R
        dist.all_gather(out, x.contiguous(), group=self.group)
        return torch.cat(out, dim=1)


def _shard(x, r: int, i: int):
    """Sequence shard i of r of x (B,S,...), contiguous (the bf16 kernels'
    TMA needs 16-byte aligned rows)."""
    s = x.shape[1]
    if s % r:
        raise ValueError(f"ring attention: sequence {s} is not a multiple "
                         f"of the ring's {r} shards")
    return x[:, i * (s // r):(i + 1) * (s // r)].contiguous()


class RingAttention(torch.autograd.Function):
    """(B,S,H,hd) q and (B,S,KV,hd) k, v, whole on every rank of the ring
    -> the whole (B,S,H,hd) output; in backward, the whole dQ, dK, dV on
    every rank (each rank's slice of the output gradient is its own
    shard's, the rest reach it by all-gather)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        outs, lses = _ring_fwd(ring, qs, ks, vs, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ring, ctx.causal = ring, causal
        return ring.gather(outs)

    @staticmethod
    def backward(ctx, dout):
        ring, n = ctx.ring, len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * n:(i + 1) * n])
                                  for i in range(5))
        dqs, dks, dvs = _ring_bwd(ring, qs, ks, vs, outs, ring.split(dout),
                                  lses, causal=ctx.causal)
        return (ring.gather([d.to(q.dtype) for d, q in zip(dqs, qs)]),
                ring.gather([d.to(k.dtype) for d, k in zip(dks, ks)]),
                ring.gather([d.to(v.dtype) for d, v in zip(dvs, vs)]),
                None, None)


def ring_attention_sharded(q, k, v, mesh, *, axis_name: str = "model",
                           causal: bool = True):
    """Ring attention over ``mesh``'s ``axis_name`` dimension. q (B,S,H,hd)
    and k, v (B,S,KV,hd) are this rank's whole (replicated) tensors; the
    rank takes its sequence shard, runs the ring with the other ranks of
    that dimension, and all-gathers the output (B,S,H,hd) over them. S must
    be a multiple of the dimension's size."""
    return RingAttention.apply(q, k, v, _GroupRing(mesh.get_group(axis_name)),
                               causal)


def ring_attention_single_device(q, k, v, *, shards: int,
                                 causal: bool = True):
    """The ring of ``shards`` sequence shards run on one device (module
    docstring): the same block steps, merge and backward as
    ``ring_attention_sharded`` with R = ``shards``."""
    return RingAttention.apply(q, k, v, _LocalRing(shards), causal)
