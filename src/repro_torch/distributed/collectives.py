"""Autograd collectives and the context of the sharded train step.

The sharded step (``train/train_step.py``, ``sharded=True``) holds every
parameter, gradient and AdamW moment as this rank's shard, placed by the
reference's rules (``ShardingRules.spec_for``): FSDP over ``"data"`` on
the ``"embed"`` dimension, tensor parallelism over ``"model"`` on heads,
KV heads, the FFN width and the vocabulary. The reference leaves the data
movement to GSPMD; here it is explicit, and every collective is one of
four deterministic ``torch.autograd.Function``s on plain tensors, so the
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
  maximum over the vocabulary shards).

Nothing is atomic and the order of every sum is fixed, so a run repeats
bit for bit; a collective over one rank leaves its values as they are,
which makes the sharded step on a (1, 1) mesh the replicated step's bits.

``ShardedParams`` is the step's context: the rules, the spec of every
parameter leaf of the layout and one process group a mesh dimension
(``mesh.get_group(name)``). ``activate_sharded`` makes it current for the
model code (thread-local, as the rules are; ``models/transformer.py``'s
``_remat`` carries it into the recompute).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

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
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x, dim: int, group):
    return _Gather.apply(x, dim, group)


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
        """Per leaf (``tree_leaves`` order), the mesh dimensions it is
        sharded over."""
        from ..train.adamw import tree_leaves   # lazy: no import cycle
        return [tuple(a for e in spec for a in entry_axes(e))
                for spec in tree_leaves(self.specs)]

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
