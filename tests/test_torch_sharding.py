"""The port's sharding rule engine and logical axes against the reference's.

The reference's tests/test_sharding.py cases on the port's
``ShardingRules``; every leaf's ``axes`` of every arch's layout equal to
the reference layout's; ``spec_for`` equal to the reference's for every
leaf of every arch on the production meshes (16, 16) and (2, 16, 16)
(rule resolution reads only the mesh's shape and names, so stand-ins
carry them: no 256-device mesh on either side); the placements, ``shard``
on a DTensor over a one-process gloo group, and the meshes' refusals.
"""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.distributed.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.distributed import (DEFAULT_RULES, ShardingRules,  # noqa: E402
                                     activate_rules, current_rules,
                                     input_sharding, param_sharding, shard)
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models.params import ParamSpec, stack_specs  # noqa: E402


def _mesh(shape, names):
    """What rule resolution reads of a DeviceMesh."""
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(names))


def _jax_mesh(shape, names):
    """What the reference's rule resolution reads of a jax Mesh."""
    return SimpleNamespace(shape=dict(zip(names, shape)))


def _rules(shape=(2, 2), names=("data", "model"), overrides=None):
    return ShardingRules(_mesh(shape, names), overrides or {})


# The reference's tests/test_sharding.py cases: (mesh shape, names, dims,
# logical axes, spec).
RULE_CASES = {
    "basic": ((2, 2), ("data", "model"), (64, 128), ("vocab", "embed"),
              ("model", "data")),
    # 7 heads do not divide the 2-way model axis (the Arctic case)
    "fallback": ((2, 2), ("data", "model"), (64, 7, 16),
                 ("embed", "heads", "head_dim"), ("data", None, None)),
    # both map to "model"; only the first dim gets it
    "used_once": ((2, 2), ("data", "model"), (64, 64), ("vocab", "mlp"),
                  ("model", None)),
    # "pod" and "model" absent from the mesh
    "missing": ((4,), ("data",), (8, 64), ("batch", "mlp"), ("data", None)),
    "tuple": ((2, 2, 2), ("pod", "data", "model"), (8, 64),
              ("batch", None), (("pod", "data"), None)),
}


def test_reference_rule_cases():
    for name, (shape, names, dims, axes, want) in RULE_CASES.items():
        assert _rules(shape, names).spec_for(dims, axes) == want, name
        ref = JaxRules(_jax_mesh(shape, names), {}).spec_for(dims, axes)
        assert ref == P(*want), name


def test_shard_noop_outside_context_and_rules_are_thread_local():
    x = torch.ones(4, 4)
    assert current_rules() is None
    assert shard(x, ("batch", None)) is x
    rules = _rules()
    with activate_rules(rules):
        assert current_rules() is rules
        assert shard(x, ("batch", None)) is x        # a plain tensor
        with pytest.raises(ValueError, match="rank-2"):
            shard(x, ("batch",))
    assert current_rules() is None
    assert rules.rules == {**DEFAULT_RULES}


def _leaf_pairs(arch):
    """[(path, port spec, reference spec)] of the arch's full layout."""
    mine, ref = {}, {}

    def walk(tree, out, prefix, is_leaf):
        for k, v in tree.items():
            if is_leaf(v):
                out[prefix + k] = v
            else:
                walk(v, out, prefix + k + "/", is_leaf)

    cfg, jcfg = get_config(arch), jax_config(arch)
    walk(get_family(cfg).layout(cfg), mine, "",
         lambda v: isinstance(v, ParamSpec))
    walk(jax_family(jcfg).layout(jcfg), ref, "",
         lambda v: not isinstance(v, dict))
    assert sorted(mine) == sorted(ref), arch
    return [(k, mine[k], ref[k]) for k in sorted(mine)]


def test_layout_axes_match_reference():
    """Every leaf of every arch: the reference's shape and axes; stacked
    leaves lead with "layers"; ``experts`` marks exactly the leaves with an
    experts axis."""
    for arch in ARCH_NAMES:
        for path, mine, ref in _leaf_pairs(arch):
            assert (mine.shape, mine.axes) == (ref.shape, ref.axes), \
                (arch, path)
            assert mine.experts == ("experts" in ref.axes)
            if path.startswith(("layers/", "mamba/", "pairs/")):
                assert mine.axes[0] == "layers", (arch, path)


def test_spec_for_matches_reference_on_production_meshes():
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        for arch in ARCH_NAMES:
            overrides = jax_config(arch).sharding_overrides
            assert get_config(arch).sharding_overrides == overrides
            rules = ShardingRules(_mesh(shape, names), overrides)
            ref = JaxRules(_jax_mesh(shape, names), overrides)
            for path, mine, _ in _leaf_pairs(arch):
                assert rules.spec_for(mine.shape, mine.axes) \
                    == tuple(ref.spec_for(mine.shape, mine.axes)), \
                    (shape, arch, path)


def test_param_spec_axes_and_placements():
    with pytest.raises(ValueError, match="axes"):
        ParamSpec((4, 4), ("embed",))
    stacked = stack_specs({"w": ParamSpec((8, 6), ("embed", "experts"))}, 3)
    assert stacked["w"].shape == (3, 8, 6)
    assert stacked["w"].axes == ("layers", "embed", "experts")
    assert stacked["w"].experts
    from torch.distributed.tensor import Replicate, Shard
    rules = _rules((2, 2, 2), ("pod", "data", "model"))
    assert input_sharding(rules, (8, 64), ("batch", None)) \
        == [Shard(0), Shard(0), Replicate()]
    cfg = get_config("starcoder2-7b")
    layout = get_family(cfg).layout(cfg)
    placed = param_sharding(layout, _rules((16, 16)))
    # 36 heads do not divide 16: wq's heads stay whole, embed over data
    assert placed["layers"]["attn"]["wq"] == [Shard(1), Replicate()]
    assert placed["embedding"] == [Shard(1), Shard(0)]


@pytest.fixture
def host_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_and_shard_on_a_dtensor(host_group):
    """``make_host_mesh("cpu")`` starts a one-process gloo group; ``shard``
    redistributes a DTensor to the rules' placements; the production mesh
    refuses a group of the wrong size."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(ValueError, match="none is initialised"):
        make_production_mesh()
    mesh = make_host_mesh(device="cpu")
    assert dist.get_world_size() == 1 and mesh.mesh_dim_names == ("data",)
    x = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh,
                          [Replicate()])
    with activate_rules(ShardingRules(mesh)):
        y = shard(x, ("batch", None))
    assert y.placements == (Shard(0),)
    assert torch.equal(y.full_tensor(), x.full_tensor())
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_meshes_default_to_cuda():
    """Without CUDA the mesh functions raise unless asked for the CPU, and
    start no process group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    assert not dist.is_initialized()
