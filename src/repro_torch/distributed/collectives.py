"""Autograd collectives and the context of the sharded train step.

The sharded step (``train/train_step.py``, ``sharded=True``) holds every
parameter, gradient and AdamW moment as this rank's shard, placed by the
reference's rules (``ShardingRules.spec_for``): FSDP over ``"data"`` on
the ``"embed"`` dimension, tensor parallelism over ``"model"`` on heads,
KV heads, SSM heads, the FFN and recurrent blocks' widths and the
vocabulary. The reference leaves the data
movement to GSPMD; here it is explicit, and every collective is one of
these deterministic ``torch.autograd.Function``s on plain tensors, so the
kernels take the local shards as they take whole tensors:

- ``gather(x, dim, group)``: all-gather along ``dim``
  (``all_gather_into_tensor``); backward a sum reduce-scatter
  (``reduce_scatter_tensor``). A layer's weights are gathered over
  ``"data"`` where they are used, and every data rank's gradient of the
  whole weight lands, summed, on the rank that holds its shard;
- ``copy_to(x, group)``: identity forward, all-reduce (sum) backward. It
  stands where a tensor that every model rank holds whole (a normed
  activation, a weight whole over ``"model"``) enters work that the model
  ranks partition (their heads, their FFN columns, their vocabulary rows):
  its gradient is the sum of the ranks' parts;
- ``reduce_from(x, group)``: all-reduce (sum) forward, identity backward:
  the partial sums of a row-parallel product (the attention output
  projection, the FFN down projection, the vocab-parallel lookup and the
  loss's partial sums) become the whole on every model rank;
- ``all_max(x, group)``: all-reduce (max), no gradient (the loss's row
  maximum over the vocabulary shards);
- ``all_reduce(x, group)``: all-reduce (sum) forward and backward: a sum
  over ranks that every rank's loss then uses whole, each weighted by its
  token share (the MoE aux losses' global token sums over the batch
  dimensions, ``models/moe.py``). Rank r's loss is w_r * f(S) with
  S = sum_r' s_r' and sum_r w_r = 1, so the gradient of s_r is the sum
  over ranks of their upstream gradients: neither ``copy_to`` nor
  ``reduce_from``;
- ``gather_repeated(x, dim, group)``: all-gather along ``dim`` forward;
  backward this rank's block of the gradient, not summed. It stands where
  every rank of ``group`` repeats the same use of a weight it holds a block
  of, so the gradient of the whole weight is already equal on every rank:
  the MoE router ``(d, e)``, its experts over ``"model"``, whose logits,
  softmax and top-k every model rank computes whole;
- ``take_block(x, dim, group)``: this rank's block of ``dim`` forward;
  backward the blocks' gradients all-gathered. It stands where a tensor
  that every rank of ``group`` computes whole and equal enters work they
  partition along ``dim`` (a norm over whole rows before a row-parallel
  projection, ``models/ssm.py``, ``models/xlstm.py``): every rank then
  holds the whole gradient, each block computed once, and the work before
  it repeats with no partial sums.

Nothing is atomic and the order of every sum is fixed, so a run repeats
bit for bit; a collective over one rank leaves its values as they are,
and an all-reduce's result keeps the layout of the tensor it stands in
for (a transposed gradient stays transposed, so the reductions after it
add in the same order), which makes the sharded step on a (1, 1) mesh
the replicated step's bits.

``ShardedParams`` is the step's context: the rules, the spec of every
parameter leaf of the layout and one process group a mesh dimension
(``mesh.get_group(name)``), this rank's range of experts
(``expert_range``), and a leaf made whole over "model" for work whose
split does not follow its blocks (``model_whole``). ``activate_sharded``
makes it current for the model
code (thread-local, as the rules are; ``models/transformer.py``'s
``_remat`` carries it into the recompute).

``BatchSplit`` is the data-parallel context of either train step and of
the sharded serve steps: the process groups whose ranks hold other rows
of the batch, and their count. ``activate_batch_split`` makes it current;
the MoE block then cuts the global batch into the reference's groups
(gathering a group that spans ranks, at serve time) and takes its aux
losses over every rank's tokens (``models/moe.py``).
"""
from __future__ import annotations

import functools
import math
import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

#: The mesh dimensions the sharded step shards a parameter over: FSDP and
#: tensor parallelism. Rules that place a parameter on another (say
#: ``"embed"`` over ``("pod", "data")``) are refused.
PARAM_AXES = ("data", "model")


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh dimensions of one spec entry (``None``, a name or a
    tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# The collectives (plain functions, no autograd)
# ---------------------------------------------------------------------------

def all_gather_dim(x, dim: int, group):
    """``x`` from every rank of ``group`` concatenated along ``dim`` (rank
    order), contiguous."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x, dim: int, group):
    """The sum over ``group`` of ``x``, this rank's block of ``dim``
    (``all_gather_dim``'s adjoint), contiguous."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def all_reduce_sum(x, group):
    """A new tensor: the sum of ``x`` over ``group``."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _laid_out_as(x, like):
    """``x`` (a collective's contiguous result) with ``like``'s strides
    where ``like`` is dense and laid out otherwise: the tensor the
    collective stands in for keeps its layout, so the reductions after it
    run in the order they run without it (on one rank, the replicated
    step's bits)."""
    if x.stride() == like.stride():
        return x
    return torch.empty_like(like).copy_(x)


# ---------------------------------------------------------------------------
# The autograd collectives
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _laid_out_as(all_reduce_sum(g, ctx.group), g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _laid_out_as(all_reduce_sum(x, group), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _laid_out_as(all_reduce_sum(x, group), x)

    @staticmethod
    def backward(ctx, g):
        return _laid_out_as(all_reduce_sum(g, ctx.group), g), None


class _GatherRepeated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


def gather(x, dim: int, group):
    return _Gather.apply(x, dim, group)


def all_reduce(x, group):
    return _AllReduce.apply(x, group)


def gather_repeated(x, dim: int, group):
    return _GatherRepeated.apply(x, dim, group)


def take_block(x, dim: int, group):
    return _TakeBlock.apply(x, dim, group)


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def all_max(x, group):
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ---------------------------------------------------------------------------
# The sharded step's context
# ---------------------------------------------------------------------------

class ShardedParams:
    """The placement of every leaf of ``layout`` under ``rules`` (whose
    ``mesh`` is a ``DeviceMesh`` over an initialised process group), and one
    process group a mesh dimension. Raises if a parameter would be sharded
    over a dimension other than ``PARAM_AXES``."""

    def __init__(self, rules, layout):
        from ..models.params import tree_map_specs   # lazy: no import cycle
        self.rules = rules
        mesh = rules.mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.groups = {a: mesh.get_group(a) for a in self.names}
        self.coords = {a: mesh.get_local_rank(a) for a in self.names}
        self.layout = layout
        self.specs = tree_map_specs(self.spec, layout)
        self.last_gathers = _map_specs(
            lambda spec: functools.partial(self._gather_last,
                                           entry_axes(spec[-1])), self.specs)

    def spec(self, pspec) -> tuple:
        """A ``ParamSpec``'s mesh placement, one entry a dimension."""
        spec = self.rules.spec_for(pspec.shape, pspec.axes)
        for entry in spec:
            bad = [a for a in entry_axes(entry) if a not in PARAM_AXES]
            if bad:
                raise ValueError(f"a parameter {pspec.shape} {pspec.axes} "
                                 f"sharded over {bad}: the sharded step "
                                 f"shards parameters over {PARAM_AXES}")
        return spec

    def split(self, pspec, dim: int, axis: str = "model") -> bool:
        """Dimension ``dim`` of the leaf ``pspec`` is sharded over ``axis``."""
        return axis in entry_axes(self.spec(pspec)[dim])

    def group(self, axis: str):
        return self.groups[axis]

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def batch_axes(self) -> tuple[str, ...]:
        """The mesh dimensions of the ``"batch"`` rule: every rank of one of
        their groups holds other rows."""
        return self.rules.mesh_axes_for("batch")

    def batch_split(self) -> "BatchSplit":
        """The ``BatchSplit`` of the batch dimensions, groups of one rank
        included (every collective is issued)."""
        return BatchSplit(tuple(self.groups[a] for a in self.batch_axes()),
                          math.prod(self.rules.axis_sizes[a]
                                    for a in self.batch_axes()))

    def expert_range(self, pspec) -> tuple[int, int]:
        """This rank's experts ``[first, last)`` of the leaf ``pspec``
        (whose dimension 0 is its experts): its block over ``"model"`` where
        they are sharded there, else all of them."""
        e = pspec.shape[0]
        if not self.split(pspec, 0):
            return 0, e
        n = e // self.rules.axis_sizes["model"]
        return self.coord("model") * n, (self.coord("model") + 1) * n

    # -- a leaf whole over "model" ------------------------------------------
    def model_whole(self, x, pspec, *, repeated: bool):
        """``x``, this rank's block of the leaf ``pspec`` (whole over
        "data"), whole over ``"model"``, for work whose split does not
        follow the leaf's blocks (the Mamba2 block's fused projection and
        conv, a norm over whole rows, heads whole over a split leaf).
        ``repeated``: every model rank repeats the work that uses it, so
        each holds the whole gradient and keeps its block (``gather_repeated``,
        or the leaf as it is where it is whole); else each does its part,
        and the ranks' gradients are summed (``gather``, or ``copy_to``
        where the leaf is whole)."""
        for dim, entry in enumerate(self.spec(pspec)):
            if "model" in entry_axes(entry):
                gather_fn = gather_repeated if repeated else gather
                return gather_fn(x, dim, self.groups["model"])
        return x if repeated else copy_to(x, self.groups["model"])

    # -- FSDP ----------------------------------------------------------------
    def gather_data(self, tree, specs):
        """Every leaf of ``tree`` whole over ``"data"``: leaves sharded over
        it are gathered along their data dimension (``gather``), the others
        returned as they are. ``specs``: the matching subtree of
        ``ParamSpec``s (without the ``"layers"`` axis for one layer)."""
        if isinstance(tree, dict):
            return {k: self.gather_data(v, specs[k]) for k, v in tree.items()}
        spec = self.spec(specs)
        for dim, entry in enumerate(spec):
            if "data" in entry_axes(entry):
                return gather(tree, dim, self.groups["data"])
        return tree

    # -- gradients and the norm ------------------------------------------------
    def leaf_axes(self) -> list[tuple[str, ...]]:
        """Per leaf (the layout's order), the mesh dimensions it is sharded
        over."""
        return [tuple(a for e in spec for a in entry_axes(e))
                for spec in _spec_leaves(self.specs)]

    def reduce_sq(self, sq):
        """``sq`` (one sum of squares a leaf, stacked) summed over the mesh
        dimensions each leaf is sharded over, so every element counts once:
        a leaf that is whole over a dimension keeps its value on that
        dimension's coordinate 0 and zero elsewhere before the sum."""
        leaf_axes = self.leaf_axes()
        for axis in self.names:
            keep = torch.tensor([axis in ax or self.coord(axis) == 0
                                 for ax in leaf_axes], device=sq.device)
            sq = all_reduce_sum(torch.where(keep, sq, 0.0),
                                self.groups[axis])
        return sq

    # -- int8 moments at the reference's placement ------------------------
    def _gather_last(self, axes: tuple[str, ...], x):
        """``x``, a shard of a leaf whose last dimension is sharded over
        ``axes``, with that dimension all-gathered whole (no autograd), and
        this rank's offset in it. ``last_gathers`` holds one of these a
        leaf, ``axes`` bound."""
        n, block = x.shape[-1], 0
        for a in axes:                # the first dimension major
            block = block * self.rules.axis_sizes[a] + self.coord(a)
        for a in reversed(axes):      # the minor dimension first
            x = all_gather_dim(x, x.ndim - 1, self.groups[a])
        return x, block * n


def _spec_leaves(tree) -> list:
    """The spec tuples of a tree of specs, in the layout's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _spec_leaves(v)]
    return [tree]


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


class BatchSplit(NamedTuple):
    """The process groups over which a step splits the batch's rows
    (``groups``, the first dimension major) and the number of row blocks
    (``ranks``, the product of their sizes). ``gather_groups``: where a
    rank's rows split a group of the MoE block, the group's tokens are
    gathered over ``groups`` and routed whole on every rank (the serve
    steps); else that raises (the train steps)."""
    groups: tuple
    ranks: int
    gather_groups: bool = False

    def index(self) -> int:
        """This rank's row block among ``ranks``."""
        index = 0
        for group in self.groups:
            index = (index * dist.get_world_size(group)
                     + dist.get_rank(group))
        return index

    def gather_rows(self, x):
        """``x`` (this rank's rows, dimension 0) from every rank of
        ``groups``, in row order (no gradient)."""
        for group in reversed(self.groups):     # the minor dimension first
            x = all_gather_dim(x, 0, group)
        return x


_tls = threading.local()


def current_sharded() -> Optional[ShardedParams]:
    return getattr(_tls, "sharded", None)


@contextmanager
def activate_sharded(ctx: Optional[ShardedParams]):
    prev = current_sharded()
    _tls.sharded = ctx
    try:
        yield ctx
    finally:
        _tls.sharded = prev


def current_batch_split() -> Optional[BatchSplit]:
    return getattr(_tls, "batch_split", None)


@contextmanager
def activate_batch_split(split: Optional[BatchSplit]):
    prev = current_batch_split()
    _tls.batch_split = split
    try:
        yield split
    finally:
        _tls.batch_split = prev
