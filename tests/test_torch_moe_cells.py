"""The MoE train cells of the dry-run under expert parallelism, on rank 0 of
the single-pod (16, 16) ("data", "model") mesh (a fake process group), and
the step analysis of the collectives that expert parallelism adds.

olmoe-1b-7b and arctic-480b ``train_4k`` (B 256 x S 4096) trace the
sharded step: the experts over "model", FSDP over "data", Arctic's
attention whole over "model" (56 heads on a 16-way axis) and its dense
branch tensor parallel. Arctic's int8 moments of a shard whose last
dimension is not a multiple of QBLOCK are held at the reference's
placement (the last dimension whole). Nothing here spawns a process.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch.dryrun import analyze_cell, fake_mesh  # noqa: E402
from repro_torch.launch.input_specs import build_cell  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models.params import tree_map_specs  # noqa: E402
from repro_torch.train import adamw  # noqa: E402

#: the arch -> its layers
LAYERS = {"olmoe-1b-7b": 16, "arctic-480b": 35}


@pytest.fixture(scope="module")
def records():
    train = get_shape("train_4k")
    return {arch: analyze_cell(get_config(arch), train, "single")
            for arch in LAYERS}


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_moe_train_cell_is_sharded(records, arch):
    """The record says "sharded" and gives no reason to be replicated; both
    cells fit the H100's 80 GB (arctic at 74.08 GiB a device on rank 0, as
    PERF.md records it)."""
    rec = records[arch]
    assert rec["status"] == "ok" and rec["param_placement"] == "sharded"
    assert "replicated_because" not in rec
    assert rec["memory"]["fits_hbm"] is True, rec["memory"]


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_moe_train_cell_kernel_regions(records, arch):
    """Remat "full": each layer's flash forward runs twice (forward and
    recompute) and its backward once; RMSNorm 4L + 1 and 2L + 1."""
    n = LAYERS[arch]
    assert records[arch]["hlo"]["kernel_regions"] == {
        "flash_attention_fwd": 2 * n, "flash_attention_bwd": n,
        "rmsnorm_fused": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1}


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_moe_train_cell_collectives(records, arch):
    """The sharded MoE step gathers over "data" and "model" (the router),
    reduce-scatters the gathers' gradients and all-reduces over "model"
    and "data" (the partial outputs, the aux losses' token sums)."""
    hlo = records[arch]["hlo"]["collective_by_op"]
    for op in ("all-gather", "all-reduce", "reduce-scatter"):
        assert hlo[op] > 0, (op, hlo)


def test_arctic_int8_moments_at_reference_placement():
    """Arctic's train_4k stand-ins (bf16 shards, int8 moments) on rank 0
    of the (16, 16) mesh: a moment whose shard's last dimension is a
    multiple of QBLOCK holds the shard's blocks; any other int8 moment the
    reference's placement, the parameter's leading dimensions sharded and
    the last whole. The leaves of 7168 columns sharded to 448 (``wo``,
    ``we_down``, ``dense_down``, the embedding) are among the latter."""
    cfg = get_config("arctic-480b")
    layout = get_family(cfg).layout(cfg)
    with fake_mesh("single") as mesh:
        rules = ShardingRules(mesh, cfg.sharding_overrides)
        _, (params, opt, _), _ = build_cell(cfg, get_shape("train_4k"),
                                            rules, placement="sharded")
    whole = tree_map_specs(lambda s: s.shape, layout)
    int8, placed = adamw.AdamWConfig(state_dtype="int8"), []

    def check(path, p, m, shape):
        if not isinstance(m, adamw.QTensor):
            assert not adamw._quantized(int8, shape), path
            return
        local = tuple(p.shape)
        last = local[-1] if local[-1] % adamw.QBLOCK == 0 else shape[-1]
        assert m.shape == local[:-1] + (last,), (path, m.shape, local)
        assert tuple(m.q.shape) == local[:-1] + (last // adamw.QBLOCK,
                                                 adamw.QBLOCK), path
        if last != local[-1]:
            placed.append(path)

    def walk(p, m, s, path=""):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], m[k], s[k], f"{path}/{k}")
        else:
            check(path, p, m, tuple(s))

    walk(params, opt.m, whole)
    assert set(placed) >= {"/layers/attn/wo", "/layers/ffn/we_down",
                           "/layers/ffn/dense_down", "/embedding"}, placed


def test_expert_collectives_counted_with_wire_bytes():
    """``gather_repeated`` (all-gather forward, no collective backward) and
    ``all_reduce`` (all-reduce both ways) traced by the step analysis over
    a fake group of 4: all-gather |result|·3/4, all-reduce 2·|result|·3/4
    each way, by the reference's ring conventions."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import all_reduce, gather_repeated
    from repro_torch.launch.step_analysis import StepAnalysis
    with fake_mesh(((4,), ("model",))):
        group = dist.group.WORLD
        w = torch.empty((64, 8), device="meta", requires_grad=True)
        s = torch.empty((130,), device="meta", requires_grad=True)
        with StepAnalysis([w, s]) as mode:
            whole = gather_repeated(w, 1, group)
            total = all_reduce(s, group)
            (whole.sum() + total.sum()).backward()
        rep = mode.report
    gathered = 64 * 32 * 4
    summed = 130 * 4
    assert rep.collective_by_op["all-gather"] == gathered * 3 / 4
    assert rep.collective_by_op["all-reduce"] == 2 * (2 * summed * 3 / 4)
    assert rep.collective_by_op["reduce-scatter"] == 0
    assert tuple(w.grad.shape) == (64, 8) and rep.collective_count == 3
    assert math.isclose(rep.collective_wire_bytes, gathered * 3 / 4
                        + 2 * (2 * summed * 3 / 4))
