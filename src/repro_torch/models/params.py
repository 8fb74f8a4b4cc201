"""Parameter layout, on-device init, and conversion from the reference.

A model is a nested dict of ``ParamSpec`` leaves, as in the reference;
layer weights carry a leading ``L`` axis (``stack_specs``) and the model
loops over it. Parameters are a nested dict of tensors of the same shape.
Matrix weights are stored in the compute dtype ``cfg.dtype`` for serving
(cast once at load, which equals the reference's cast at every use), or in
the ``dtype=`` given, e.g. ``cfg.pdtype`` for training's master weights;
leaves whose spec names a dtype (the f32 norm weights) keep it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import torch_dtype
from ..device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override for "normal"/"embed"
    dtype: Optional[str] = None    # override the model dtype (f32 norms)
    # The leaf has an experts axis (the reference's "experts" logical axis):
    # the routed experts' weights and the router.
    experts: bool = False


def tree_map_specs(fn: Callable[[ParamSpec], object], layout):
    if isinstance(layout, ParamSpec):
        return fn(layout)
    if isinstance(layout, dict):
        return {k: tree_map_specs(fn, v) for k, v in layout.items()}
    raise TypeError(f"bad layout node {type(layout)}")


def stack_specs(layer_specs, n: int):
    """Add a leading layer axis of extent ``n`` to every leaf."""
    return tree_map_specs(
        lambda s: ParamSpec((n,) + s.shape, s.init, s.scale, s.dtype,
                            s.experts),
        layer_specs)


def count_params_in_layout(layout, predicate=None) -> int:
    """Elements of every leaf (that ``predicate`` accepts), from the specs
    alone: nothing is allocated."""
    total = 0

    def add(spec: ParamSpec):
        nonlocal total
        if predicate is None or predicate(spec):
            total += int(np.prod(spec.shape))

    tree_map_specs(add, layout)
    return total


def _leaf_dtype(spec: ParamSpec, cfg, dtype=None) -> torch.dtype:
    if spec.dtype:
        return torch_dtype(spec.dtype)
    if dtype is None:
        return cfg.cdtype
    return torch_dtype(dtype) if isinstance(dtype, str) else dtype


def _std(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    if spec.init == "embed":
        return 1.0
    # The reference's fan-in: every axis but the last, the layer axis
    # included, so the port's weights have the reference's magnitudes.
    fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 \
        else max(spec.shape[-1], 1)
    return (fan_in or 1) ** -0.5


# Largest layer part drawn through one f32 scratch (1 GiB of f32).
SCRATCH_ELEMS = 1 << 28


def init_params(cfg, layout, *, seed: int = 0, device="cuda", dtype=None):
    """Materialize ``layout`` on ``device`` from a ``torch.Generator``, matrix
    weights in ``dtype`` (default ``cfg.dtype``).

    Normal leaves are truncated at two standard deviations, as in the
    reference (whose ``jax.random`` bits this does not reproduce). Stacked
    leaves are drawn one layer at a time, and a layer's part of more than
    ``SCRATCH_ELEMS`` elements one slice of its first axis at a time (an
    Arctic expert stack: 128 x 7168 x 4864 per layer, 17.8 GB of f32
    scratch whole), so the f32 scratch stays at one such piece's size.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def leaf(spec: ParamSpec):
        dt = _leaf_dtype(spec, cfg, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        out = torch.empty(spec.shape, dtype=dt, device=dev)
        std = _std(spec)
        for layer in (out if len(spec.shape) > 2 else [out]):
            big = layer.dim() > 2 and layer.numel() > SCRATCH_ELEMS
            for part in (layer if big else [layer]):
                tmp = torch.empty(part.shape, dtype=torch.float32, device=dev)
                torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                            generator=gen)
                part.copy_(tmp.mul_(std))
        return out

    return tree_map_specs(leaf, layout)


def params_from_reference(cfg, layout, np_tree, *, device="cuda",
                          dtype=None):
    """The reference's parameters (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``, matrix weights in ``dtype`` (default ``cfg.dtype``), each
    checked against ``layout``'s shape."""
    dev = resolve_device(device)

    def go(node, tree, path):
        if isinstance(node, ParamSpec):
            arr = np.array(tree, dtype=np.float32)      # a writable copy
            if tuple(arr.shape) != node.shape:
                raise ValueError(f"{path}: reference shape {arr.shape} != "
                                 f"layout {node.shape}")
            return torch.from_numpy(arr).to(
                device=dev, dtype=_leaf_dtype(node, cfg, dtype))
        missing = set(node) ^ set(tree)
        if missing:
            raise ValueError(f"{path}: keys differ from the layout: "
                             f"{sorted(missing)}")
        return {k: go(v, tree[k], f"{path}/{k}") for k, v in node.items()}

    return go(layout, np_tree, "")

