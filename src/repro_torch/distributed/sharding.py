"""Logical-axis sharding rules over a ``torch.distributed`` DeviceMesh.

Model layouts name their dimensions with *logical* axes (``"batch"``,
``"heads"``, ``"experts"`` ...; ``models/params.py``). A ``ShardingRules``
maps those names to mesh dimensions, with the reference's divisibility
fallback: a dimension whose size the mesh extent does not divide stays
unsharded (Arctic's 56 query heads on a 16-way model axis), each mesh
dimension is used once, and rules naming a dimension the mesh lacks drop
it, so one rule set serves a ``("data",)`` host mesh and the (pod, data,
model) production meshes.

``spec_for`` returns the reference's ``PartitionSpec`` as plain data: one
entry a dimension, ``None``, a mesh-dimension name or a tuple of names.
``placements_for`` turns it into DTensor placements, one a mesh dimension.

The port applies the placements at run time to the train step
(``train/train_step.py``, ``sharded=True``) of the transformer, dense or
with experts, of Zamba2 and of xLSTM, and to the transformer's prefill,
encode and decode steps:
``shard_params`` cuts every leaf to this rank's shard (``local_shape``;
an expert stack ``(e, d, f)`` to the rank's ``e / M`` experts of ``d /
D`` rows), the step runs on the shards, and ``gather_params`` puts the
whole leaves back together (for tests and checks); ``shard_tree`` and
``gather_tree`` do the same for a serve step's batch and decode cache by
their logical axes. Shards are plain
tensors, not DTensors: the data movement is explicit, in the autograd
collectives of ``distributed/collectives.py``, where the reference
leaves it to GSPMD.
Everything else (the other families' serve steps, the replicated train
step with its data-parallel all-reduce and the ring attention's P2P) holds
plain tensors whole on every rank, and ``shard`` therefore acts only on a
DTensor.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Union

AxisRule = Union[None, str, tuple[str, ...]]

#: logical axis -> mesh dimension (or tuple of them). Dimensions absent from
#: the active mesh are dropped, so one rule set serves 1-pod and 2-pod
#: meshes.
DEFAULT_RULES: dict[str, AxisRule] = {
    "batch": ("pod", "data"),
    "moe_groups": ("pod", "data"),
    "vocab": "model",
    "embed": "data",          # FSDP over parameter rows
    "heads": "model",
    "kv_heads": "model",
    # context parallelism for archs whose head count does not divide the
    # model axis (arctic 56H, starcoder2 36H, paligemma 8H)
    "attn_seq": None,
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "moe_mlp": None,
    "layers": None,
    "seq": None,
    "cache_seq": None,        # long-context decode overrides this to "data"
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "frontend": None,
}

_tls = threading.local()


@dataclass
class ShardingRules:
    """``mesh``: a ``DeviceMesh``, or any object with its ``shape`` and
    ``mesh_dim_names`` (rule resolution reads only those, so the production
    meshes' specs can be computed without their 256 or 512 ranks);
    ``rules`` override ``DEFAULT_RULES``."""
    mesh: object
    rules: dict[str, AxisRule] = field(default_factory=dict)

    def __post_init__(self):
        merged = dict(DEFAULT_RULES)
        merged.update(self.rules)
        self.rules = merged
        self.axis_sizes = dict(zip(self.mesh.mesh_dim_names,
                                   tuple(self.mesh.shape)))

    # -- resolution ------------------------------------------------------------
    def mesh_axes_for(self, logical: Optional[str]) -> tuple[str, ...]:
        rule = self.rules.get(logical) if logical else None
        if rule is None:
            return ()
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        return tuple(a for a in axes if a in self.axis_sizes)

    def _extent(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.axis_sizes[a] for a in axes)

    def spec_for(self, shape: tuple[int, ...],
                 axes: tuple[Optional[str], ...]) -> tuple:
        """One entry a dimension (``None``, a mesh dimension or a tuple of
        them) with divisibility fallback; mesh dimensions used once."""
        used: set[str] = set()
        entries = []
        for dim, logical in zip(shape, axes):
            mesh_axes = tuple(a for a in self.mesh_axes_for(logical)
                              if a not in used)
            if mesh_axes and dim % self._extent(mesh_axes) == 0:
                entries.append(mesh_axes[0] if len(mesh_axes) == 1
                               else mesh_axes)
                used.update(mesh_axes)
            else:
                entries.append(None)
        return tuple(entries)

    def placements_for(self, shape: tuple[int, ...],
                       axes: tuple[Optional[str], ...]) -> list:
        """DTensor placements of ``spec_for``: one a mesh dimension,
        ``Shard(d)`` where tensor dimension d is split over it, else
        ``Replicate()``."""
        return self.placements_of(self.spec_for(shape, axes))

    def placements_of(self, spec: tuple) -> list:
        """DTensor placements of a spec (one entry a tensor dimension)."""
        from torch.distributed.tensor import Replicate, Shard
        owner = {}
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                owner[a] = d
        return [Shard(owner[a]) if a in owner else Replicate()
                for a in self.mesh.mesh_dim_names]


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextmanager
def activate_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def shard(x, axes: tuple[Optional[str], ...]):
    """Place ``x`` by its logical axes under the active rules.

    Outside a rules context: ``x`` unchanged. A DTensor is redistributed to
    ``placements_for(x.shape, axes)``. A plain tensor is returned unchanged:
    it is this rank's whole, replicated value (module docstring), and the
    port's collectives are explicit, so a layout hint has nothing to act
    on."""
    rules = current_rules()
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} vs rank-{x.ndim} tensor")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(rules.mesh,
                          rules.placements_for(tuple(x.shape), axes))


def _coord(rules: ShardingRules, axes: tuple[str, ...]) -> int:
    """This rank's block index over ``axes`` (the first dimension major)."""
    index = 0
    for a in axes:
        index = index * rules.axis_sizes[a] + rules.mesh.get_local_rank(a)
    return index


def local_shape(rules: ShardingRules, shape: tuple[int, ...],
                axes: tuple[Optional[str], ...]) -> tuple[int, ...]:
    """A leaf's shape on one rank under ``spec_for``: each sharded dimension
    divided by its mesh extent."""
    from .collectives import entry_axes
    return tuple(d // rules._extent(entry_axes(e))
                 for d, e in zip(shape, rules.spec_for(shape, axes)))


def shard_leaf(x, shape: tuple[int, ...], axes: tuple[Optional[str], ...],
               rules: ShardingRules):
    """This rank's block of ``x`` (a whole tensor of ``shape`` whose
    dimensions are named ``axes``) under ``spec_for``: a contiguous copy,
    ``requires_grad`` as ``x``'s."""
    from .collectives import entry_axes
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"leaf {tuple(x.shape)} vs layout {tuple(shape)}")
    index = []
    for d, e in zip(shape, rules.spec_for(tuple(shape), axes)):
        n = d // rules._extent(entry_axes(e))
        i = _coord(rules, entry_axes(e))
        index.append(slice(i * n, (i + 1) * n))
    out = x.detach()[tuple(index)].contiguous().clone()
    return out.requires_grad_(x.requires_grad)


def gather_leaf(x, shape: tuple[int, ...], axes: tuple[Optional[str], ...],
                rules: ShardingRules):
    """The whole tensor of ``shape`` from every rank's ``shard_leaf`` block
    ``x``: all-gathers over each sharded dimension, no gradient. Every rank
    of the mesh must call it."""
    import torch
    from .collectives import all_gather_dim, entry_axes
    with torch.no_grad():
        out = x.detach()
        for dim, e in enumerate(rules.spec_for(tuple(shape), axes)):
            for a in reversed(entry_axes(e)):      # the minor dimension first
                out = all_gather_dim(out, dim, rules.mesh.get_group(a))
    return out


def shard_params(params, layout, rules: ShardingRules):
    """This rank's shard of every leaf of ``params`` (whole tensors shaped as
    ``layout``'s specs): a contiguous copy of its block of each sharded
    dimension, ``requires_grad`` as the leaf's. The sharded steps'
    parameters."""
    return _map2(lambda p, spec: shard_leaf(p, spec.shape, spec.axes, rules),
                 params, layout)


def gather_params(params, layout, rules: ShardingRules):
    """The whole leaves from every rank's shards (``shard_params``' inverse):
    all-gathers over each sharded dimension, no gradient. Every rank of
    the mesh must call it."""
    return _map2(lambda p, spec: gather_leaf(p, spec.shape, spec.axes, rules),
                 params, layout)


def shard_tree(tree, axes, rules: ShardingRules):
    """This rank's block of every leaf of ``tree`` (whole tensors; ``axes``
    a matching tree of logical-axes tuples), as the reference's
    ``NamedSharding`` of each places it: a sharded serve step's batch
    (``("batch", None, ...)``: a batch the batch dimensions do not divide
    stays whole on every rank) and decode cache (``cache_axes``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, axes[k], rules) for k, v in tree.items()}
    return shard_leaf(tree, tuple(tree.shape), axes, rules)


def gather_tree(tree, shapes, axes, rules: ShardingRules):
    """``shard_tree``'s inverse: the whole leaves, of ``shapes`` (a matching
    tree of whole shapes), from every rank's blocks."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, shapes[k], axes[k], rules)
                for k, v in tree.items()}
    return gather_leaf(tree, shapes, axes, rules)


def _map2(fn, tree, layout):
    if isinstance(tree, dict):
        missing = set(tree) ^ set(layout)
        if missing:
            raise ValueError(f"keys differ from the layout: {sorted(missing)}")
        return {k: _map2(fn, v, layout[k]) for k, v in tree.items()}
    return fn(tree, layout)


def param_sharding(layout, rules: ShardingRules):
    """The placements tree of a parameter layout (``distribute_tensor``'s
    argument a leaf)."""
    from ..models.params import tree_map_specs   # lazy: no import cycle
    return tree_map_specs(lambda s: rules.placements_for(s.shape, s.axes),
                          layout)


def input_sharding(rules: ShardingRules, shape: tuple[int, ...],
                   axes: tuple[Optional[str], ...]) -> list:
    return rules.placements_for(shape, axes)

