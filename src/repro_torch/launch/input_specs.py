"""Meta-tensor stand-ins and their placements for every (arch x shape) cell,
the counterpart of the reference's ``launch/input_specs.py``.

Nothing is allocated on a device: parameters, optimizer state, batches and
decode caches are tensors on the ``meta`` device, which the cell's step
(``train/train_step.py``) runs on for the dry-run (``launch/dryrun.py``,
``launch/step_analysis.py``). Placements are DTensor placements, one a
mesh dimension, from the sharding rules (``distributed/sharding.py``), as
``param_sharding`` gives a parameter's.

The train cells of the transformer, dense or with experts, of Zamba2 and of
xLSTM, and the prefill, encode and decode cells of the transformer, dense,
with experts and with either frontend (``cell_placement``), are the
sharded steps' (``train/train_step.py``, ``sharded=True``): their
parameters, optimizer state, batch and decode cache are stand-ins at one
rank's local shapes (``distributed.sharding.local_shape``), as the
placements place them (the decode cache split by sequence under
``shape_rule_overrides``' ``cache_seq``); an int8 moment whose shard's
last dimension is not a multiple of ``QBLOCK`` is held at the reference's
placement, its last dimension whole (``adamw.moment_shape``). Every other
cell (ring attention, Zamba2's and xLSTM's prefill and decode) holds its
tensors whole on every rank, as the port still runs it.

Training takes the master weights in ``cfg.param_dtype``, as the trainer
holds them; prefill, encode and decode take them in ``cfg.dtype``, as the
port's serve engines store them (the reference's stand-ins are
``param_dtype`` for every cell).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import ShardingRules, local_shape, param_sharding
from ..models import get_family
from ..models.params import abstract_params, tree_map_specs
from ..train import adamw
from ..train.train_step import (build_decode_step, build_encode_step,
                                build_prefill_step, build_train_step,
                                sharded_serve_gap, sharded_step_gap)

BATCH_AXES = ("batch", None)


def _struct(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(meta tensors, logical axes) of the input batch of this cell."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        if cfg.frontend == "frame":
            structs = {"frames": _struct((b, s, cfg.frontend_dim), f32),
                       "labels": _struct((b, s), i32),
                       "loss_mask": _struct((b, s), f32)}
            axes = {"frames": ("batch", None, None), "labels": BATCH_AXES,
                    "loss_mask": BATCH_AXES}
        elif cfg.frontend == "patch":
            text = s - cfg.frontend_len
            structs = {"tokens": _struct((b, text), i32),
                       "labels": _struct((b, text), i32),
                       "patches": _struct((b, cfg.frontend_len,
                                           cfg.frontend_dim), f32)}
            axes = {"tokens": BATCH_AXES, "labels": BATCH_AXES,
                    "patches": ("batch", None, None)}
        else:
            structs = {"tokens": _struct((b, s), i32),
                       "labels": _struct((b, s), i32)}
            axes = {"tokens": BATCH_AXES, "labels": BATCH_AXES}
        return structs, axes

    if shape.kind == "prefill":
        if cfg.frontend == "frame":
            structs = {"frames": _struct((b, s, cfg.frontend_dim), f32)}
            axes = {"frames": ("batch", None, None)}
        elif cfg.frontend == "patch":
            structs = {"tokens": _struct((b, s - cfg.frontend_len), i32),
                       "patches": _struct((b, cfg.frontend_len,
                                           cfg.frontend_dim), f32)}
            axes = {"tokens": BATCH_AXES, "patches": ("batch", None, None)}
        else:
            structs = {"tokens": _struct((b, s), i32)}
            axes = {"tokens": BATCH_AXES}
        return structs, axes

    if shape.kind == "decode":
        structs = {"tokens": _struct((b, 1), i32), "pos": _struct((b,), i32)}
        axes = {"tokens": BATCH_AXES, "pos": ("batch",)}
        return structs, axes

    raise ValueError(shape.kind)


def _place_tree(rules: ShardingRules, structs, axes):
    if isinstance(structs, dict):
        return {k: _place_tree(rules, v, axes[k]) for k, v in structs.items()}
    return rules.placements_for(tuple(structs.shape), axes)


def optimizer_state_sharding(opt_cfg: adamw.AdamWConfig, abs_params, layout,
                             rules: ShardingRules):
    """(placements as an ``AdamWState``, the abstract state). f32 moments
    take their parameter's placements; an int8 ``QTensor`` moment's codes
    and scales keep the parameter's sharding of every dim but the last and
    leave their (blocks, QBLOCK) dims whole, as the reference's do."""
    st = adamw.init(opt_cfg, abs_params)
    specs = tree_map_specs(lambda s: rules.spec_for(s.shape, s.axes), layout)

    def moment(spec, leaf):
        if isinstance(leaf, adamw.QTensor):
            entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
            q = rules.placements_of(entries[:-1] + (None, None))
            return adamw.QTensor(q, q, leaf.shape)
        return rules.placements_of(spec)

    def moments(tree):
        return adamw.tree_map(moment, specs, tree)

    scalar = rules.placements_of(())
    return adamw.AdamWState(scalar, moments(st.m), moments(st.v)), st


def default_opt_cfg(cfg: ModelConfig) -> adamw.AdamWConfig:
    # bf16-param archs (Arctic) pair with int8 moments
    state_dtype = "int8" if cfg.param_dtype == "bfloat16" else "float32"
    return adamw.AdamWConfig(state_dtype=state_dtype)


def cell_placement(cfg: ModelConfig, shape: ShapeConfig) -> tuple[str, str]:
    """("sharded", "") for the train cells that ``sharded_step_gap``
    passes and the prefill and decode cells that ``sharded_serve_gap``
    passes, else ("replicated", why)."""
    gap = (sharded_step_gap if shape.kind == "train"
           else sharded_serve_gap)(cfg)
    return ("replicated", gap) if gap else ("sharded", "")


def _local_structs(rules: ShardingRules, structs, axes):
    """Meta stand-ins at one rank's local shapes."""
    if isinstance(structs, dict):
        return {k: _local_structs(rules, v, axes[k])
                for k, v in structs.items()}
    return _struct(local_shape(rules, tuple(structs.shape), axes),
                   structs.dtype)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
               opt_cfg: adamw.AdamWConfig | None = None,
               microbatches: int = 1, placement: str = "replicated"):
    """-> (the port's step function, its arguments as meta tensors, their
    placements), as the reference's ``build_cell`` returns (step, abstract
    arguments, in_shardings). ``placement="sharded"`` (a cell that
    ``cell_placement`` calls sharded): the arguments are one rank's
    shards (the serve cells' parameters in ``cfg.dtype``, their batch's
    rows and decode cache's block) and the step ``sharded=True``; the
    placements returned are the reference's either way."""
    family = get_family(cfg)
    layout = family.layout(cfg)
    p_sh = param_sharding(layout, rules)
    structs, axes = batch_specs(cfg, shape)
    b_sh = _place_tree(rules, structs, axes)
    if placement == "sharded" and cell_placement(cfg, shape)[0] != placement:
        raise ValueError(f"{cfg.name} {shape.name}: "
                         f"{cell_placement(cfg, shape)[1]}")

    b = shape.global_batch
    if placement == "sharded" and shape.kind == "prefill":
        step = (build_encode_step if cfg.encoder_only
                else build_prefill_step)(cfg, sharded=True, global_batch=b)
        return step, (abstract_params(cfg, layout, rules=rules),
                      _local_structs(rules, structs, axes)), (p_sh, b_sh)

    if placement == "sharded" and shape.kind == "decode":
        cache = _cache_structs(family.cache_layout(cfg, b, shape.seq_len))
        c_axes = family.cache_axes(cfg)
        step = build_decode_step(cfg, sharded=True, global_batch=b,
                                 cache_len=shape.seq_len)
        return step, (abstract_params(cfg, layout, rules=rules),
                      _local_structs(rules, structs, axes),
                      _local_structs(rules, cache, c_axes)), \
            (p_sh, b_sh, _place_tree(rules, cache, c_axes))

    if placement == "sharded":
        abs_params = abstract_params(cfg, layout, cfg.pdtype, rules)
        for p in adamw.tree_leaves(abs_params):
            p.requires_grad_(True)
        opt_cfg = opt_cfg or default_opt_cfg(cfg)
        abs_opt = adamw.init(opt_cfg, abs_params,
                             tree_map_specs(lambda s: s.shape, layout))
        o_sh, _ = optimizer_state_sharding(opt_cfg, abstract_params(
            cfg, layout, cfg.pdtype), layout, rules)
        step = build_train_step(cfg, opt_cfg, microbatches, sharded=True)
        return step, (abs_params, abs_opt,
                      _local_structs(rules, structs, axes)), (p_sh, o_sh,
                                                              b_sh)

    if shape.kind == "train":
        abs_params = abstract_params(cfg, layout, cfg.pdtype)
        for p in adamw.tree_leaves(abs_params):
            p.requires_grad_(True)
        opt_cfg = opt_cfg or default_opt_cfg(cfg)
        o_sh, abs_opt = optimizer_state_sharding(opt_cfg, abs_params, layout,
                                                 rules)
        step = build_train_step(cfg, opt_cfg, microbatches)
        return step, (abs_params, abs_opt, structs), (p_sh, o_sh, b_sh)

    abs_params = abstract_params(cfg, layout)
    if shape.kind == "prefill":
        step = (build_encode_step(cfg) if cfg.encoder_only
                else build_prefill_step(cfg))
        return step, (abs_params, structs), (p_sh, b_sh)

    if shape.kind == "decode":
        cache = _cache_structs(family.cache_layout(cfg, shape.global_batch,
                                                   shape.seq_len))
        c_sh = _place_tree(rules, cache, family.cache_axes(cfg))
        step = build_decode_step(cfg)
        return step, (abs_params, structs, cache), (p_sh, b_sh, c_sh)

    raise ValueError(shape.kind)


def _cache_structs(layout):
    if isinstance(layout, dict):
        return {k: _cache_structs(v) for k, v in layout.items()}
    shape, dtype = layout
    return _struct(shape, dtype)


def shape_rule_overrides(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Per-cell sharding-rule tweaks (e.g. sequence-shard huge KV caches)."""
    overrides: dict[str, Any] = {}
    if shape.kind == "decode":
        if shape.global_batch < 8:
            # batch=1 long-context decode: batch unshardable; shard the cache
            # sequence over data (flash-decoding style partial softmax).
            overrides["cache_seq"] = "data"
        else:
            # GQA KV heads rarely divide the 16-way model axis; shard the
            # cache sequence over "model" instead so the KV cache fits.
            overrides["cache_seq"] = "model"
    return overrides

