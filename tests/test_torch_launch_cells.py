"""The port's launch layer against the reference's: the 40 (arch x shape)
cells' ``runnable`` verdicts, every arch's parameter counts, ``_model_flops``
of every runnable cell, ``batch_specs``, the decode caches' shapes and
logical axes, and ``build_cell``'s placements as per-device shapes on both
production meshes.

Rule resolution reads only a mesh's shape and names, so stand-ins carry
them on both sides (no 256- or 512-device mesh): the port's rules take a
namespace with ``shape`` and ``mesh_dim_names``, the reference's one with a
``shape`` dict, and its ``NamedSharding`` is replaced, in the two modules
that build one, by a stand-in that keeps only the ``PartitionSpec``. All
comparisons are exact: they are shapes, counts and names.
"""
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import all_cells as jax_all_cells  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import runnable as jax_runnable  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.launch import input_specs as jax_specs  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.train.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.adamw import QTensor as JaxQTensor  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES, all_cells,  # noqa: E402
                                 get_config, runnable)
from repro_torch.core.cost import H100_SXM  # noqa: E402
from repro_torch.distributed import ShardingRules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import input_specs as specs  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_MESHES  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.train import adamw  # noqa: E402


def _jax_model_flops():
    """The reference's ``_model_flops``. Its module sets ``XLA_FLAGS`` (512
    host devices) at import; the variable is put back, so that processes
    this one starts later see what they saw before."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import _model_flops
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return _model_flops


def test_cells_and_runnable_verdicts_match_reference():
    mine = {(a, s): (ok, why) for a, s, ok, why in all_cells()}
    ref = {(a, s): (ok, why) for a, s, ok, why in jax_all_cells()}
    assert len(mine) == 40 and mine == ref
    assert sum(ok for ok, _ in mine.values()) == 31
    assert set(ARCH_NAMES) == {a for a, _ in ref}
    for name, shape in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (shape.kind, shape.seq_len, shape.global_batch,
                shape.is_decode) == (j.kind, j.seq_len, j.global_batch,
                                     j.is_decode)
    for arch in ARCH_NAMES:
        for shape in SHAPES.values():
            assert runnable(get_config(arch), shape) == jax_runnable(
                jax_config(arch), JAX_SHAPES[shape.name])


def test_param_counts_and_model_flops_match_reference():
    model_flops = _jax_model_flops()
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        for name, shape in SHAPES.items():
            if runnable(cfg, shape)[0]:
                assert dryrun._model_flops(cfg, shape) == model_flops(
                    jcfg, JAX_SHAPES[name]), (arch, name)
    # MoE counts only the routed experts
    olmoe = get_config("olmoe-1b-7b")
    assert olmoe.active_param_count() < olmoe.param_count()


def test_h100_spec():
    assert H100_SXM.name == "NVIDIA H100 80GB HBM3"
    assert H100_SXM.power_w == 700.0
    assert H100_SXM.peak_bf16_flops == 989.4e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.hbm_bytes == 80e9
    assert H100_SXM.nvlink_bandwidth == 450e9
    with pytest.raises(Exception):
        H100_SXM.hbm_bytes = 1


def _shapes_and_axes(structs, axes):
    return {k: (tuple(v.shape), axes[k]) for k, v in structs.items()}


def test_batch_specs_match_reference():
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for name, shape in SHAPES.items():
            if not runnable(cfg, shape)[0]:
                continue
            structs, axes = specs.batch_specs(cfg, shape)
            jstructs, jaxes = jax_specs.batch_specs(jcfg, JAX_SHAPES[name])
            assert all(t.is_meta for t in structs.values())
            assert _shapes_and_axes(structs, axes) == _shapes_and_axes(
                jstructs, jaxes), (arch, name)
            assert {k: str(t.dtype).split(".")[-1]
                    for k, t in structs.items()} == {
                k: str(t.dtype) for k, t in jstructs.items()}, (arch, name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _dtype_name(dt) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dt]


@pytest.mark.parametrize("arch", ["yi-6b", "xlstm-350m", "zamba2-1.2b"])
def test_decode_cache_shapes_and_axes_match_reference(arch):
    """Every family: the transformer's K/V, xLSTM's mLSTM and sLSTM
    leaves, Zamba2's Mamba2 leaves and shared-attention K/V."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    layout = get_family(cfg).cache_layout(cfg, 3, 40)
    axes = get_family(cfg).cache_axes(cfg)
    jstructs, jaxes = jax_family(jcfg).cache_layout(jcfg, 3, 40)
    mine = {k: (shape, _dtype_name(dt)) for k, (shape, dt)
            in _flat(layout, "").items()}
    ref = {k: (tuple(s.shape), str(s.dtype))
           for k, s in _flat(jstructs, "").items()}
    assert mine == ref
    assert _flat(axes) == _flat(jaxes)


def _jax_mesh(shape, names):
    return SimpleNamespace(shape=dict(zip(names, shape)))


def _port_mesh(shape, names):
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(names))


def _ref_local(shape, spec, mesh_shape, names):
    extent = dict(zip(names, mesh_shape))
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= extent[a]
    return tuple(out)


def _per_device_shape(shape, placements, mesh_shape):
    out = list(shape)
    for place, extent in zip(placements, mesh_shape):
        if place.is_shard():
            out[place.dim] //= extent
    return tuple(out)


def _local_shapes(args, placements, mesh_shape):
    """{leaf path: per-device shape} of the port's (args, placements)."""
    out = {}

    def walk(a, p, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], p[k], f"{path}/{k}")
        elif isinstance(a, adamw.QTensor):
            walk(a.q, p.q, path + ".q")
            walk(a.scale, p.scale, path + ".scale")
        elif isinstance(a, (tuple, list)) and not isinstance(a, torch.Size):
            for i, (x, y) in enumerate(zip(a, p)):
                walk(x, y, f"{path}/{i}")
        else:
            out[path] = _per_device_shape(tuple(a.shape), p, mesh_shape)

    walk(args, placements, "")
    return out


def _ref_local_shapes(args, shardings, mesh_shape, names):
    out = {}

    def walk(a, s, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k], f"{path}/{k}")
        elif isinstance(a, JaxQTensor):
            walk(a.q, s.q, path + ".q")
            walk(a.scale, s.scale, path + ".scale")
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, s)):
                walk(x, y, f"{path}/{i}")
        else:
            out[path] = _ref_local(tuple(a.shape), s.spec, mesh_shape,
                                   names)

    walk(args, shardings, "")
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_build_cell_placements_match_reference(multi_pod, monkeypatch):
    """Per-device shapes of the parameters, the batch, the decode cache and
    the int8-moment optimizer leaves of every runnable cell."""
    def named(mesh, spec):
        return SimpleNamespace(spec=spec)
    monkeypatch.setattr(jax_sharding, "NamedSharding", named)
    monkeypatch.setattr(jax_specs, "NamedSharding", named)
    mesh_shape, names = PRODUCTION_MESHES[multi_pod]
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for name, shape in SHAPES.items():
            if not runnable(cfg, shape)[0]:
                continue
            jshape = JAX_SHAPES[name]
            rules = ShardingRules(_port_mesh(mesh_shape, names), {
                **cfg.sharding_overrides,
                **specs.shape_rule_overrides(cfg, shape)})
            jrules = jax_sharding.ShardingRules(
                _jax_mesh(mesh_shape, names), {
                    **jcfg.sharding_overrides,
                    **jax_specs.shape_rule_overrides(jcfg, jshape)})
            _, args, places = specs.build_cell(
                cfg, shape, rules, opt_cfg=adamw.AdamWConfig(
                    state_dtype="int8"))
            _, jargs, jshards = jax_specs.build_cell(
                jcfg, jshape, jrules,
                opt_cfg=JaxAdamWConfig(state_dtype="int8"))
            if shape.kind == "train":     # the state's step: a scalar
                args = (args[0], (args[1].m, args[1].v), args[2])
                places = (places[0], (places[1].m, places[1].v), places[2])
                jargs = (jargs[0], (jargs[1].m, jargs[1].v), jargs[2])
                jshards = (jshards[0], (jshards[1].m, jshards[1].v),
                           jshards[2])
            mine = _local_shapes(args, places, mesh_shape)
            ref = _ref_local_shapes(jargs, jshards, mesh_shape, names)
            assert mine == ref, (arch, name)
            if shape.kind == "train":
                assert any(k.endswith(".q") for k in mine), arch
