"""The port's step analysis and dry-run: ``step_analysis``' matmul FLOPs of
a reduced yi-6b and a reduced zamba2-1.2b train step against the
reference's ``analyze_hlo`` of its compiled step for the same cell, the
all-reduce wire bytes of a 4-rank data-parallel step, the meta route of
every kernel entry, the accounting conventions on a small step, and the
dry-run CLI for one full-size cell.

Tolerance of the FLOPs: 10% relative. Not 0, because the two programs
are not the same dots: the port's trace counts the eager ops it runs
(the plain versions of its kernels, whose attention backward recomputes
the scores, and the SSD scan's per-chunk products), XLA's the dots left
after its own autodiff, common-subexpression elimination and dot
rewriting. At these cells the two differ by -2.4% (yi-6b) and +4.8%
(zamba2-1.2b).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ShapeConfig as JaxShape  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.distributed.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.distributed.sharding import activate_rules as jax_activate  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.input_specs import build_cell as jax_build_cell  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 get_reduced_config, get_shape, runnable)
from repro_torch.distributed import ShardingRules, activate_rules  # noqa: E402
from repro_torch.kernels import _meta  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.input_specs import build_cell  # noqa: E402
from repro_torch.launch.step_analysis import (StepAnalysis,  # noqa: E402
                                              analyze_step)
from repro_torch.models import get_family, init_params  # noqa: E402
from repro_torch.train import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MINI_TRAIN = ("mini_train", "train", 64, 8)
FLOPS_RTOL = 0.10


@pytest.fixture(autouse=True)
def _fresh_counts():
    kernels.reset_launch_counts()
    yield


def _reference_dot_flops(arch):
    cfg, shape = jax_reduced(arch), JaxShape(*MINI_TRAIN)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    rules = JaxRules(mesh, {})
    step, args, shardings = jax_build_cell(cfg, shape, rules)
    with jax.set_mesh(mesh), jax_activate(rules):
        hlo = jax.jit(step, in_shardings=shardings).lower(
            *args).compile().as_text()
    return analyze_hlo(hlo).dot_flops


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b"])
def test_dot_flops_against_reference_analyze_hlo(arch):
    rec = dryrun.analyze_cell(get_reduced_config(arch),
                              ShapeConfig(*MINI_TRAIN), "card")
    want = _reference_dot_flops(arch)
    got = rec["hlo"]["dot_flops"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    assert rec["param_placement"] == "replicated"
    assert "meta" in rec["hlo"]["devices_seen"]
    assert "cuda" not in rec["hlo"]["devices_seen"]
    assert rec["hlo"]["collective_count"] == 0
    assert not any(kernels.launch_counts().values())
    assert rec["hlo"]["kernel_region_flops"] > 0


def test_data_parallel_allreduce_wire_bytes():
    """4 ranks over ("data",): the step all-reduces every f32 gradient and
    the loss-and-metrics vector, 2·|t|·3/4 bytes each."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_reduced_config("internlm2-1.8b")
    shape = ShapeConfig(*MINI_TRAIN)
    fam = get_family(cfg)
    layout = fam.layout(cfg)
    params = init_params(cfg, layout, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    _, metrics = fam.train_loss(cfg, params, batch)
    leaves = adamw.tree_leaves(params)
    want = sum(2 * 4 * t.numel() * 3 / 4 for t in leaves) \
        + 2 * 4 * (1 + len(metrics)) * 3 / 4
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        rules = ShardingRules(mesh, {})
        step, args, _ = build_cell(cfg, shape, rules)
        with activate_rules(rules):
            _, rep, _ = analyze_step(step, args)
    assert rep.collective_wire_bytes == want
    assert rep.collective_by_op["all-reduce"] == want
    assert rep.collective_count == len(leaves) + 1
    # each rank trains on its own quarter of the batch's rows
    single = dryrun.analyze_cell(cfg, shape, "card")
    assert rep.dot_flops < single["hlo"]["dot_flops"] / 2


def _meta_like(*tensors):
    return [t.to("meta") for t in tensors]


def _same_shapes(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


def test_kernel_entries_meta_route():
    """Every ``ops`` entry on meta tensors: the plain version's shapes and
    dtypes, no launch, one kernel region a wrapper call (the backward
    kernels' through their autograd Functions); a plain version that needs
    the data raises with the kernel's name."""
    from repro_torch.kernels import (flash_attention, mamba_chunk_scan,
                                     paged_decode_attention,
                                     paged_prefill_attention,
                                     paged_verify_attention, rmsnorm)
    g = torch.Generator().manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    pool = (rn(2, 6, 8, 16), rn(2, 6, 8, 16))
    pt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    at = torch.tensor([9, 17], dtype=torch.int32)
    cases = {
        "flash_attention_fwd": (flash_attention, (
            rn(2, 24, 4, 16, dtype=torch.bfloat16),
            rn(2, 24, 2, 16, dtype=torch.bfloat16),
            rn(2, 24, 2, 16, dtype=torch.bfloat16))),
        "rmsnorm_fused": (rmsnorm, (rn(3, 5, 64, dtype=torch.bfloat16),
                                    rn(64))),
        "ssd_scan": (lambda *a: mamba_chunk_scan(*a, chunk=8), (
            rn(2, 20, 3, 16), rn(2, 20, 3).abs(), rn(3), rn(2, 20, 16),
            rn(2, 20, 16))),
        "flash_decode_fwd": (paged_decode_attention,
                             (rn(2, 4, 16), *pool, pt, at)),
        "flash_prefill_fwd": (paged_prefill_attention,
                              (rn(2, 5, 4, 16), *pool, pt, at)),
        "flash_verify_fwd": (paged_verify_attention,
                             (rn(2, 3, 4, 16), *pool, pt, at)),
    }
    for name, (fn, inputs) in cases.items():
        want = fn(*inputs)
        with StepAnalysis() as mode:
            got = fn(*_meta_like(*inputs))
        _same_shapes(got, want)
        assert all(t.is_meta for t in (got if isinstance(got, tuple)
                                       else (got,)))
        assert mode.report.kernel_regions == {name: 1}, name
    # with a gradient: the forward and the backward wrapper, each a region
    grads = {"flash_attention_fwd": "flash_attention_bwd",
             "rmsnorm_fused": "rmsnorm_bwd", "ssd_scan": "ssd_scan_bwd"}
    for name, bwd in grads.items():
        fn, inputs = cases[name]
        metas = [t.requires_grad_() for t in _meta_like(
            *(t for t in inputs if t.is_floating_point()))]
        with StepAnalysis() as mode:
            out = fn(*metas)
            out = out[0] if isinstance(out, tuple) else out
            dx = torch.autograd.grad(out.float().sum(), metas)
        assert mode.report.kernel_regions == {name: 1, bwd: 1}, name
        _same_shapes(dx, metas)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(RuntimeError, match="ssd_scan: its plain version "
                                           "cannot run on meta"):
        _meta.run_plain("ssd_scan", lambda t: t.sum().item(),
                        torch.empty(3, device="meta"))


def test_step_analysis_accounting():
    """Views write nothing, an in-place op its target, an indexed write its
    values, ``empty`` nothing; a kernel region's intermediates are its own
    bytes and leave the live peak, its output does not; matmul FLOPs."""
    x = torch.empty(16, 32, device="meta")
    w = torch.empty(32, device="meta")
    idx = torch.zeros(4, dtype=torch.long, device="meta")

    def step(x, w):
        v = x.view(32, 16)                          # a view: nothing
        y = x @ v                                   # 16 x 16 f32, 2·16·16·32
        y.add_(1.0)                                 # in place: 16 x 16
        y[idx] = torch.empty(4, 16, device="meta")  # empty: 0; values 4 x 16
        with _meta.kernel_region("rmsnorm_fused"):
            t = x * x                               # 16 x 32, intermediate
            out = t.mean(-1, keepdim=True) * w      # 16 x 32, the output
            del t
        return y, out

    out, rep, mem = analyze_step(step, (x, w))
    f = 4
    assert rep.dot_flops == 2 * 16 * 16 * 32 and rep.dot_count == 1
    assert rep.kernel_region_bytes == (16 * 32 + 16) * f
    assert rep.bytes_written == (16 * 16 + 16 * 16 + 4 * 16 + 16 * 32
                                 + 16 + 16 * 32) * f
    assert rep.bytes_accessed == 2 * rep.bytes_written
    assert rep.bytes_accessed_fused == 2 * (rep.bytes_written
                                            - rep.kernel_region_bytes)
    assert rep.kernel_regions == {"rmsnorm_fused": 1}
    assert mem["argument_bytes"] == (16 * 32 + 32) * f
    assert mem["output_bytes"] == (16 * 16 + 16 * 32) * f
    assert mem["alias_bytes"] == 0
    # live at the peak: y and the region's output (the 4 x 16 values are
    # freed after their write, the region's intermediate is on chip)
    assert rep.peak_live_bytes == (16 * 16 + 16 * 32) * f
    assert mem["per_device_total"] == mem["argument_bytes"] \
        + rep.peak_live_bytes


def test_train_cell_memory_holds_its_state():
    """A reduced internlm2-1.8b train cell with int8 moments: the arguments
    are the f32 parameters, both moments (int8 codes and f32 block scales
    where a leaf quantizes, f32 elsewhere), the step counter and the batch,
    byte for byte; the parameters come back in place; the new moments are
    the step's own outputs; and every f32 gradient is live at once on top
    of the arguments."""
    cfg = get_reduced_config("internlm2-1.8b")
    shape = ShapeConfig(*MINI_TRAIN)
    rec = dryrun.analyze_cell(cfg, shape, "card",
                              opt_cfg=adamw.AdamWConfig(state_dtype="int8"))
    mem = rec["memory"]
    fam = get_family(cfg)
    params = init_params(cfg, fam.layout(cfg), device="cpu",
                         dtype=torch.float32)
    leaves = adamw.tree_leaves(params)
    _, step_metrics = fam.train_loss(
        cfg, params, {"tokens": torch.zeros(2, 8, dtype=torch.int32),
                      "labels": torch.zeros(2, 8, dtype=torch.int32)})

    def moment_bytes(t):
        if t.numel() >= adamw.QUANT_MIN_SIZE \
                and t.shape[-1] % adamw.QBLOCK == 0:
            return t.numel() + t.numel() // adamw.QBLOCK * 4
        return t.numel() * 4

    assert any(moment_bytes(t) < t.numel() * 4 for t in leaves)
    param_bytes = sum(t.numel() * 4 for t in leaves)
    grad_bytes = param_bytes
    moments = 2 * sum(moment_bytes(t) for t in leaves) + 4   # + step
    batch = 2 * shape.global_batch * shape.seq_len * 4       # tokens, labels
    # 0-d f32 metrics: total_loss, the family's, grad_norm and lr
    metrics = 4 * (3 + len(step_metrics))
    assert mem["argument_bytes"] == param_bytes + moments + batch
    assert mem["alias_bytes"] == param_bytes
    assert mem["output_bytes"] == param_bytes + moments + metrics
    assert mem["per_device_total"] >= mem["argument_bytes"] + grad_bytes
    assert mem["per_device_total"] == (mem["argument_bytes"]
                                       + mem["temp_bytes"]
                                       + mem["output_bytes"]
                                       - mem["alias_bytes"])


def test_collective_conventions_under_a_fake_group():
    """The reference's ring conventions for a group of g = 4."""
    import torch.distributed as dist
    t = torch.empty(10, 8, device="meta")                # 320 bytes
    with dryrun.fake_world(4):
        with StepAnalysis() as mode:
            dist.all_reduce(t)
            dist.all_gather([torch.empty_like(t) for _ in range(4)], t)
            dist.reduce_scatter(t, [torch.empty_like(t) for _ in range(4)])
            dist.all_to_all([torch.empty_like(t) for _ in range(4)],
                            [t] * 4)
            dist.send(t, 1)
    rep = mode.report
    assert rep.collective_by_op == {
        "all-reduce": 2 * 320 * 3 / 4, "all-gather": 4 * 320 * 3 / 4,
        "reduce-scatter": 320 * 3, "all-to-all": 4 * 320 * 3 / 4,
        "collective-permute": 320}
    assert rep.collective_count == 5
    assert not dist.is_initialized()


def test_run_cell_skips_as_the_reference():
    for arch, shape in (("hubert-xlarge", "decode_32k"),
                        ("yi-6b", "long_500k")):
        rec = dryrun.run_cell(arch, shape, "single")
        assert rec["status"] == "skipped"
        assert rec["reason"] == runnable(get_config(arch),
                                         get_shape(shape))[1]


def test_dryrun_cli_one_full_size_cell(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-6b", "--shape", "decode_32k", "--mesh", "single", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[ok]   yi-6b" in out.stdout
    rec = json.loads((tmp_path / "yi-6b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["param_placement"] == "sharded"
    assert rec["chip"] == "NVIDIA H100 80GB HBM3"
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert r["model_flops"] == 2.0 * 128 * get_config(
        "yi-6b").active_param_count()
    assert rec["hlo"]["kernel_regions"] == {"rmsnorm_fused": 65}
    # rank 0's block of the K/V cache (split by batch over "data" and by
    # sequence over "model") fits one card; the whole cache would not
    assert rec["memory"]["fits_hbm"] is True
    assert np.isfinite(rec["memory"]["per_device_total"])
