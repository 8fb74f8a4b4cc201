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

In this slice parameters and activations stay plain tensors, replicated on
every rank: the layer that moves data across ranks is explicit (the ring
attention's P2P and gathers, the data-parallel reduction of the train
step), where the reference leaves it to GSPMD. ``shard`` therefore acts
only on a DTensor.
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


def param_sharding(layout, rules: ShardingRules):
    """The placements tree of a parameter layout (``distribute_tensor``'s
    argument a leaf)."""
    from ..models.params import tree_map_specs   # lazy: no import cycle
    return tree_map_specs(lambda s: rules.placements_for(s.shape, s.axes),
                          layout)


def input_sharding(rules: ShardingRules, shape: tuple[int, ...],
                   axes: tuple[Optional[str], ...]) -> list:
    return rules.placements_for(shape, axes)

