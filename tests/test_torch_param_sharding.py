"""The sharded train step (FSDP over "data", tensor parallelism over "model")
against the reference on the CPU.

Once for the module, 4 gloo ranks (separate processes on a ``FileStore``)
on a (2, 2) ("data", "model") mesh in f32, one JAX process running the
reference's ``build_train_step`` on the same weights and global batch, and
one JAX process with 4 forced host devices compiling the reference's
sharded train cell, all at once. Each rank takes the weights through
``params_from_reference`` and ``shard_params``, its rows through
``local_batch``, and runs 2 AdamW steps of the sharded step for:

- reduced internlm2 (4 heads over 2 KV heads: both sharded);
- reduced paligemma (4 heads over 1 KV head: the heads sharded, the KV
  head whole; patches, the tied embedding, ``logit_chunk`` 8 over 16 text
  tokens);
- reduced internlm2 with 3 heads over 1 (the heads whole: attention
  replicated over "model") and d_model 65 (no dimension of it sharded
  over "data": data parallel without FSDP);
- reduced hubert (frames, ``loss_mask``) with ``microbatches=2``;
- reduced internlm2 with ``d_ff`` 256 and int8 moments (the FFN and
  unembedding shards' last dimensions 128);
- reduced olmoe (8 experts top 4, experts over "model") with
  ``moe_group_size`` 16 (4 global groups, 2 a data rank), the einsum
  dispatch and the load-balance and z-loss weights at 1.0, so that the aux
  losses' share of the router's gradient would show a miscount;
- reduced arctic with the sort dispatch and a dense branch of 129
  columns, whole over "model" (8 heads over 2 KV heads: both sharded);
- reduced arctic with ``d_model`` 128 and int8 moments: ``wo``,
  ``we_down``, the dense branch (sharded over "model": one reduce of the
  experts' and its partial sums) and the embedding have whole last
  dimensions of 128 and shards of 64, so their moments are held at the
  reference's placement (the last dimension whole);
- reduced zamba2 (8 SSM heads, 4 a rank: the fused input projection's
  and the conv's blocks cross the z/x/B/C/dt boundaries, so they are
  gathered whole over "model") and zamba2 with ``d_model`` 96 and
  ``ssm_headdim`` 64 (3 heads whole, every model rank runs the SSD; the
  gated norm's weight split mid-head);
- reduced xlstm (the sLSTM's 4 heads over 2) and xlstm with ``d_model``
  96 and 3 heads (every heads dimension whole, the "mlp" ones split: the
  production pattern).

Held: losses and ``grad_norm`` within 1e-5 relative of the reference's;
the gathered parameters after 2 steps within 1e-5 of the reference's,
equal on every rank; the gathered first-step gradients within 1e-6 of the
port's own replicated step's (of each leaf's largest, rank 0; of the
step's largest for the Zamba2 and xLSTM cases, ``SSM_CASES``) and the
losses within 1e-6 relative; every rank's shard shapes equal to the
reference's
``NamedSharding(...).shard_shape`` over an ``AbstractMesh``. In process:
the sharded step on a one-process (1, 1) mesh equal to the replicated step
bit for bit, the dry-run's sharded argument bytes against the reference's
compiled ones, internlm2-1.8b ``train_4k`` on the single-pod mesh sharded
and fitting, and the cells that stay replicated. The ranks also run the
replicated data-parallel step (whole parameters, each data rank its rows)
on the olmoe case: its load-balance loss is the global batch's, held to
the reference within 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 get_reduced_config, get_shape)
from repro_torch.distributed import ShardingRules, activate_rules  # noqa: E402
from repro_torch.distributed.sharding import (gather_params,  # noqa: E402
                                              shard_params)
from repro_torch.launch.dryrun import analyze_cell  # noqa: E402
from repro_torch.launch.input_specs import cell_placement  # noqa: E402
from repro_torch.models import get_family, init_params  # noqa: E402
from repro_torch.models.params import tree_map_specs  # noqa: E402
from repro_torch.train import adamw  # noqa: E402
from repro_torch.train.train_step import (build_train_step,  # noqa: E402
                                          local_batch)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
REF_TOL = 1e-5          # losses and grad_norm (relative), parameters (abs)
SELF_TOL = 1e-6         # the sharded step against the port's replicated one
ARG_TOL = 0.01          # the dry-run's argument bytes against the reference
SPAWN_TIMEOUT_S = 240   # each process; all finish in ~10-20 s here
B, S = 4, 16
# eps 1e-6, not AdamW's 1e-8: a gradient element near eps turns f32
# rounding (~1e-9 here, the gradients agree to ~5e-7 of each leaf's
# largest) into up to lr / 4 of its update, which 1e-5 on the parameters
# cannot hold at eps 1e-8 (5e-5 seen on paligemma's w_gate).
OPT = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=20, eps=1e-6)
#: case -> (arch, config overrides, microbatches, state dtype)
CASES = {
    "heads_and_kv_sharded": ("internlm2-1.8b", {}, 1, "float32"),
    "kv_whole": ("paligemma-3b", {"logit_chunk": 8}, 1, "float32"),
    # d_model 65: every "embed" dimension whole over "data" (the leaves'
    # gradients all-reduced there, their norm counted on one data rank)
    "heads_whole": ("internlm2-1.8b", {"num_heads": 3, "num_kv_heads": 1,
                                       "d_model": 65}, 1, "float32"),
    "hubert_microbatched": ("hubert-xlarge", {}, 2, "float32"),
    "int8_moments": ("internlm2-1.8b", {"d_ff": 256}, 1, "int8"),
    "moe_einsum_aux": ("olmoe-1b-7b", {"moe_group_size": 16,
                                       "load_balance_loss": 1.0,
                                       "router_z_loss": 1.0}, 1, "float32"),
    # the dense branch's 129 columns stay whole over "model": the experts'
    # partial sums are reduced alone and the whole branch added after
    "moe_sort_dense": ("arctic-480b", {"moe_impl": "sort",
                                       "moe_group_size": 32,
                                       "moe_dense_ff": 129}, 1, "float32"),
    "moe_int8_reference_placement": ("arctic-480b", {
        "d_model": 128, "moe_group_size": 16}, 1, "int8"),
    # 8 SSM heads, 4 a rank: w_in's 296 columns (z 128, x 128, B 16, C 16,
    # dt 8) split 148 a rank and conv_w's 160 split 80, across the
    # boundaries: both gathered whole over "model"
    "zamba_heads_sharded": ("zamba2-1.2b", {}, 1, "float32"),
    # 3 SSM heads whole over "model" (every rank runs the SSD), w_in's 419
    # columns whole, gate_norm's 192 split mid-head (96 a rank) and
    # w_out's rows with it
    "zamba_heads_whole": ("zamba2-1.2b", {"d_model": 96, "ssm_headdim": 64},
                          1, "float32"),
    # the sLSTM's 4 heads over 2; the mLSTM's width over "model", its
    # heads whole in wq (the "mlp" rows took "model") and split in b_i/b_f
    "xlstm_heads_sharded": ("xlstm-350m", {}, 1, "float32"),
    # 3 heads: every "heads" dimension whole, the "mlp" ones split (the
    # production pattern of xlstm-350m on a 16-way "model" axis)
    "xlstm_heads_whole": ("xlstm-350m", {"d_model": 96, "num_heads": 3,
                                         "num_kv_heads": 3}, 1, "float32"),
}
#: the case the replicated data-parallel step also runs
DP_CASE = "moe_einsum_aux"
#: The cases whose first-step gradients are held to 1e-6 of the step's
#: largest gradient, not of each leaf's: the gradients of Mamba2's per-head
#: A_log, dt_bias and D and of the recurrent blocks' gates and norms are
#: small sums of large terms of both signs, so rounding at f32's level in
#: the inputs moves them by more than 1e-6 of their own largest: in the
#: port's replicated f32 step on the zamba cases' configs and seeds,
#: scaling the embedding by 1 + 1e-7 * N(0, 1) moves A_log's gradient by
#: 3.1-4.8e-6 of its largest and dt_bias's by 0.7-2.7e-6. The partial sums
#: that tensor parallelism adds land there too, and so does the data
#: ranks' row split alone (A_log 1.9e-6 on a (4, 1) mesh).
SSM_CASES = ("zamba_heads_sharded", "zamba_heads_whole",
             "xlstm_heads_sharded", "xlstm_heads_whole")
# The reduced train cell of the dry-run comparison: the reference's
# tests/test_sharding.py shape.
DRY_ARCH, DRY_SHAPE = "internlm2-1.8b", ShapeConfig("mini_train", "train",
                                                    64, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process: at these widths 8 threads under
    xdist's workers made the in-process step ~30x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_cfg(case):
    arch, kw, _, _ = CASES[case]
    return get_reduced_config(arch).replace(dtype="float32", **kw)


def _inputs(path):
    """Every case's weights (the port's init, seed i) and global batch."""
    arrays = {}
    for i, case in enumerate(CASES):
        cfg = _port_cfg(case)
        params = init_params(cfg, get_family(cfg).layout(cfg), seed=i,
                             device="cpu", dtype=torch.float32)
        arrays.update({f"{case}/p/{k}": v.numpy()
                       for k, v in _flat(params).items()})
        rng = np.random.default_rng(i)
        text = S - cfg.frontend_len if cfg.frontend == "patch" else S
        labels = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
        batch = {"labels": labels}
        if cfg.frontend == "frame":
            batch["frames"] = rng.standard_normal((B, S, cfg.frontend_dim),
                                                  dtype=np.float32)
            batch["loss_mask"] = (rng.random((B, S)) < 0.3).astype(
                np.float32)
        else:
            batch["tokens"] = rng.integers(0, cfg.vocab_size,
                                           (B, text)).astype(np.int32)
        if cfg.frontend == "patch":
            batch["patches"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32)
        if case == DP_CASE:
            # the two data ranks' rows hold 64 and 48 of the loss's tokens:
            # their weights in the data-parallel step are not 1/2
            mask = np.ones((B, text), np.float32)
            mask[B // 2:, :text // 4] = 0.0
            batch["loss_mask"] = mask
        arrays.update({f"{case}/b/{k}": v for k, v in batch.items()})
    np.savez(path, **arrays)


_COMMON = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
CASES = %r
OPT = %r
DP_CASE = %r
inp = dict(np.load(sys.argv[2]))

def tree_of(case, kind, conv):
    out = {}
    for key, val in inp.items():
        c, k, path = key.split("/", 2)
        if c != case or k != kind:
            continue
        node = out
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = conv(val)
    return out

def flat(tree, prefix, out, conv):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/", out, conv)
        else:
            out[prefix + k] = conv(v)
    return out
"""

_JAX_SIDE = _COMMON.replace("DP_CASE = %r\n", "") + r"""
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.train import adamw
from repro.train.train_step import build_train_step
FAST_XLA = {"xla_backend_optimization_level": 0}
out = {}
for case, (arch, kw, mb, state) in CASES.items():
    cfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    opt = adamw.AdamWConfig(state_dtype=state, **OPT)
    params = tree_of(case, "p", jnp.asarray)
    batch = tree_of(case, "b", jnp.asarray)
    st = adamw.init(opt, params)
    step = jax.jit(build_train_step(cfg, opt, mb)).lower(
        params, st, batch).compile(FAST_XLA)
    for i in range(2):
        params, st, m = step(params, st, batch)
        out[f"{case}/loss{i}"] = m["total_loss"]
        out[f"{case}/gnorm{i}"] = m["grad_norm"]
    flat(params, case + "/p/", out, np.asarray)
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
print("JAX-SIDE-OK")
"""

_TORCH_RANK = _COMMON + r"""
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[5], 4),
                        rank=rank, world_size=4)
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import ShardingRules, activate_rules
from repro_torch.distributed.sharding import (gather_params, local_shape,
                                              shard_params)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_family, params_from_reference
from repro_torch.models.params import tree_map_specs
from repro_torch.train import adamw
from repro_torch.train.train_step import (build_loss_and_grads,
                                          build_train_step, local_batch)

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
rules = ShardingRules(mesh)
out = {}
for case, (arch, kw, mb, state) in CASES.items():
    cfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    layout = get_family(cfg).layout(cfg)
    shapes = tree_map_specs(lambda s: s.shape, layout)
    opt = adamw.AdamWConfig(state_dtype=state, **OPT)
    batch = tree_of(case, "b", torch.from_numpy)

    def whole():
        whole = params_from_reference(cfg, layout,
                                      tree_of(case, "p", np.asarray),
                                      device="cpu", dtype=torch.float32)
        return adamw.tree_map(lambda p: p.requires_grad_(), whole)

    with activate_rules(rules):
        params = shard_params(whole(), layout, rules)
        flat(params, case + "/shape/", out, lambda t: np.array(t.shape))
        mine = local_batch(batch, mb)
        grads = iter(build_loss_and_grads(cfg, mb, sharded=True)(
            params, mine)[2])
        flat(gather_params(adamw.tree_map(lambda _: next(grads), params),
                           layout, rules), case + "/g/", out, lambda t: t)
        st = adamw.init(opt, params, shapes)
        flat(st.m, case + "/mq/", out, lambda t: np.array(
            t.q.shape if isinstance(t, adamw.QTensor) else ()))
        step = build_train_step(cfg, opt, mb, sharded=True)
        for i in range(2):
            params, st, m = step(params, st, mine)
            out[f"{case}/loss{i}"] = m["total_loss"]
            out[f"{case}/gnorm{i}"] = m["grad_norm"]
        flat(gather_params(params, layout, rules), case + "/p/", out,
             lambda t: t)
    if case == DP_CASE:
        params = whole()
        step, st = build_train_step(cfg, opt, mb), adamw.init(opt, params)
        with activate_rules(rules):
            for i in range(2):
                params, st, m = step(params, st, batch)
                out[f"{case}/dp_loss{i}"] = m["total_loss"]
                out[f"{case}/dp_gnorm{i}"] = m["grad_norm"]
        flat(params, case + "/dp_p/", out, lambda t: t)
    if rank == 0:
        params = whole()
        grads = iter(build_loss_and_grads(cfg, mb)(params, batch)[2])
        flat(adamw.tree_map(lambda _: next(grads), params), case + "/rep_g/",
             out, lambda t: t)
        step, st = build_train_step(cfg, opt, mb), adamw.init(opt, params)
        for i in range(2):
            params, st, m = step(params, st, batch)
            out[f"{case}/rep_loss{i}"] = m["total_loss"]
    if case == "int8_moments":
        narrow = cfg.replace(d_ff=128)
        nl = get_family(narrow).layout(narrow)
        small = tree_map_specs(lambda s: torch.zeros(
            local_shape(rules, s.shape, s.axes)), nl)
        m = adamw.init(opt, small, tree_map_specs(lambda s: s.shape, nl)).m
        w_up = m["layers"]["ffn"]["w_up"]
        out["int8_narrow_w_up"] = np.array(
            [small["layers"]["ffn"]["w_up"].shape, w_up.shape])
np.savez(sys.argv[3], **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                             else v) for k, v in out.items()})
dist.destroy_process_group()
print("RANK-OK")
"""

_JAX_DRYRUN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax
from repro.configs import ShapeConfig, get_reduced_config
from repro.distributed.sharding import ShardingRules, activate_rules
from repro.launch.input_specs import build_cell
cfg = get_reduced_config(%r)
shape = ShapeConfig("mini_train", "train", %d, %d)
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
rules = ShardingRules(mesh, {})
step, args, sh = build_cell(cfg, shape, rules)
with jax.set_mesh(mesh), activate_rules(rules):
    compiled = jax.jit(step, in_shardings=sh).lower(*args).compile()
print("ARG", compiled.memory_analysis().argument_size_in_bytes)
"""


def _wait(proc, what):
    try:
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} did not finish in {SPAWN_TIMEOUT_S} s")
    assert proc.returncode == 0, f"{what}: {stderr[-3000:]}"
    return stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, every rank's npz, the reference dry-run's
    stdout): every process started at once."""
    tmp = tmp_path_factory.mktemp("param_sharding")
    inp = tmp / "inputs.npz"
    _inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def spawn(code, *args):
        return subprocess.Popen([sys.executable, "-c", code, SRC, *args],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    # the reference's steps in two processes: compiling them is its time
    names = list(CASES)
    halves = [{k: CASES[k] for k in names[i::3]} for i in range(3)]
    procs = [(spawn(_JAX_DRYRUN % (DRY_ARCH, DRY_SHAPE.seq_len,
                                   DRY_SHAPE.global_batch)),
              "the reference's dry-run")]
    procs += [(spawn(_JAX_SIDE % (half, OPT), str(inp),
                     str(tmp / f"jax{i}.npz")), f"the JAX side {i}")
              for i, half in enumerate(halves)]
    for r in range(4):
        procs.append((spawn(_TORCH_RANK % (CASES, OPT, DP_CASE), str(inp),
                            str(tmp / f"rank{r}.npz"), str(r),
                            str(tmp / "store")), f"gloo rank {r}"))
    outs = [_wait(proc, what) for proc, what in procs]
    ref = {k: v for i in range(len(halves))
           for k, v in np.load(tmp / f"jax{i}.npz").items()}
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return ref, ranks, outs[0]


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_losses_and_grad_norm_match_reference(runs):
    """Both steps' total loss and gradient norm, every case and rank, within
    1e-5 relative of the reference's; every rank reports the same."""
    ref, ranks, _ = runs
    for case in CASES:
        for i in range(2):
            for kind in ("loss", "gnorm"):
                key = f"{case}/{kind}{i}"
                assert _rel(ranks[0][key], ref[key]) <= REF_TOL, \
                    (key, float(ranks[0][key]), float(ref[key]))
                for other in ranks[1:]:
                    assert other[key] == ranks[0][key], key


def test_gathered_params_match_reference(runs):
    """The parameters gathered after 2 steps within 1e-5 of the reference's,
    equal on every rank."""
    ref, ranks, _ = runs
    for case in CASES:
        keys = sorted(k for k in ref if k.startswith(case + "/p/"))
        assert keys == sorted(k for k in ranks[0]
                              if k.startswith(case + "/p/"))
        errs = {k: float(np.abs(ranks[0][k] - ref[k]).max()) for k in keys}
        assert max(errs.values()) <= REF_TOL, (case, errs)
        for other in ranks[1:]:
            for k in keys:
                np.testing.assert_array_equal(other[k], ranks[0][k])


def test_sharded_step_matches_replicated_step(runs):
    """The first step's gradients, gathered, within 1e-6 of the port's own
    replicated step's on the global batch (of each leaf's largest
    gradient; of the step's largest for ``SSM_CASES``), equal on every
    rank, and both steps' losses within 1e-6 relative."""
    _, ranks, _ = runs
    mine = ranks[0]
    for case in CASES:
        for i in range(2):
            assert _rel(mine[f"{case}/loss{i}"],
                        mine[f"{case}/rep_loss{i}"]) <= SELF_TOL, case
        keys = [k for k in mine if k.startswith(case + "/rep_g/")]
        assert len(keys) == len([k for k in mine
                                 if k.startswith(case + "/p/")])
        step_scale = max(float(np.abs(mine[k]).max()) for k in keys)
        for k in keys:
            want, got = mine[k], mine[k.replace("/rep_g/", "/g/")]
            scale = step_scale if case in SSM_CASES else max(
                float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= SELF_TOL * scale, k
            for other in ranks[1:]:
                np.testing.assert_array_equal(
                    other[k.replace("/rep_g/", "/g/")], got)


def test_shard_shapes_match_reference_and_int8_refusal(runs):
    """Every rank's shard of every leaf is the reference's ``shard_shape``
    over an AbstractMesh((2, 2)). Int8 moments of a shard whose last
    dimension is not a multiple of QBLOCK, once refused, are held at the
    reference's placement: every such moment's codes are the shard of the
    reference's codes (the parameter's leading dimensions sharded, the
    (blocks, QBLOCK) dimensions whole), and a ``d_ff`` 128 internlm2's
    ``w_up`` shard (L, 32, 64) holds a moment of (L, 32, 128)."""
    _, ranks, _ = runs
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    P = jax.sharding.PartitionSpec
    held = 0
    for case, (arch, kw, _, _) in CASES.items():
        jcfg = jax_reduced(arch).replace(dtype="float32", **kw)
        layout = jax_family(jcfg).layout(jcfg)
        placed = _flat(jax_sharding.param_sharding(
            layout, jax_sharding.ShardingRules(mesh, {})))
        want = {n: tuple(placed[n].shard_shape(spec.shape))
                for n, spec in _flat(layout).items()}
        for rank in ranks:
            got = {n: tuple(int(d) for d in rank[f"{case}/shape/{n}"])
                   for n in want}
            assert got == want, (case, got, want)
            for n, spec in _flat(layout).items():
                q = tuple(int(d) for d in rank[f"{case}/mq/{n}"])
                whole_last = want[n][-1] == spec.shape[-1]
                if not q or q[:-2] != want[n][:-1] or whole_last \
                        or want[n][-1] % 128 == 0:
                    continue
                entries = tuple(placed[n].spec) + (None,) * (
                    len(spec.shape) - len(tuple(placed[n].spec)))
                qspec = jax.sharding.NamedSharding(
                    mesh, P(*entries[:-1], None, None))
                whole = spec.shape[:-1] + (spec.shape[-1] // 128, 128)
                assert q == tuple(qspec.shard_shape(whole)), (case, n, q)
                held += 1
    # wo, we_down, dense_{gate,up,down} and the embedding, on every rank
    assert held == 6 * len(ranks), held
    for rank in ranks:
        local, moment = (tuple(int(d) for d in x)
                         for x in rank["int8_narrow_w_up"])
        assert local[-1] == 64 and moment == local[:-1] + (128,), \
            (local, moment)


def test_replicated_data_parallel_moe_matches_reference(runs):
    """The replicated data-parallel step (whole parameters on every rank,
    each data rank training on its rows) on the reduced olmoe case, its
    load-balance and z-loss weights 1.0 and a ``loss_mask`` that gives its
    two data ranks unequal token shares: losses and ``grad_norm`` within
    1e-5 relative of the reference's, the parameters after 2 steps within
    1e-5, equal on every rank. The load-balance loss is the product of the
    global batch's means, as the reference's, not a mean of the ranks'
    products."""
    ref, ranks, _ = runs
    case = DP_CASE
    for i in range(2):
        for kind in ("loss", "gnorm"):
            key = f"{case}/{kind}{i}"
            got = ranks[0][f"{case}/dp_{kind}{i}"]
            assert _rel(got, ref[key]) <= REF_TOL, \
                (key, float(got), float(ref[key]))
            for other in ranks[1:]:
                assert other[f"{case}/dp_{kind}{i}"] == got, key
    keys = sorted(k for k in ref if k.startswith(case + "/p/"))
    errs = {k: float(np.abs(ranks[0][k.replace("/p/", "/dp_p/")]
                            - ref[k]).max()) for k in keys}
    assert max(errs.values()) <= REF_TOL, errs
    for other in ranks[1:]:
        for k in keys:
            k = k.replace("/p/", "/dp_p/")
            np.testing.assert_array_equal(other[k], ranks[0][k])


def test_one_rank_mesh_is_replicated_step_bit_for_bit():
    """On a one-process (1, 1) mesh, every collective issued over one rank,
    the sharded step (bf16 compute over f32 masters, remat full, int8
    moments) equals the replicated step bit for bit over 3 steps: losses,
    every metric and every parameter. For reduced internlm2, reduced olmoe
    (8 experts top 4, 4 groups of 16: the local-expert dispatch on all
    experts, the router gathered over one rank), reduced zamba2 (the
    Mamba2 block's leaves gathered over one rank, all its columns taken)
    and reduced xlstm (the sLSTM's output gathered once for each use)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    cfgs = [get_reduced_config("internlm2-1.8b").replace(d_ff=256),
            get_reduced_config("olmoe-1b-7b").replace(moe_group_size=16,
                                                      remat="full"),
            get_reduced_config("zamba2-1.2b"),
            get_reduced_config("xlstm-350m")]
    opt = adamw.AdamWConfig(state_dtype="int8", **OPT)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        rules = ShardingRules(mesh)
        for cfg in cfgs:
            layout = get_family(cfg).layout(cfg)
            base = init_params(cfg, layout, seed=0, device="cpu",
                               dtype=torch.float32)
            gen = torch.Generator().manual_seed(1)
            batch = {n: torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=gen)
                     for n in ("tokens", "labels")}

            def fresh():
                return adamw.tree_map(
                    lambda p: p.detach().clone().requires_grad_(), base)

            params, step = fresh(), build_train_step(cfg, opt)
            st, want = adamw.init(opt, params), []
            for _ in range(3):
                params, st, m = step(params, st, batch)
                want.append(m)
            with activate_rules(rules):
                shards = shard_params(fresh(), layout, rules)
                sst = adamw.init(opt, shards,
                                 tree_map_specs(lambda s: s.shape, layout))
                sstep, got = build_train_step(cfg, opt, sharded=True), []
                for _ in range(3):
                    shards, sst, m = sstep(shards, sst, local_batch(batch))
                    got.append(m)
                full = gather_params(shards, layout, rules)
            if "layers" in layout and not cfg.num_experts:
                assert isinstance(sst.m["layers"]["ffn"]["w_up"],
                                  adamw.QTensor)
            for a, b in zip(want, got):
                assert a.keys() == b.keys()
                assert all(torch.equal(a[k], b[k]) for k in a), \
                    (cfg.name, a, b)
            for a, b in zip(adamw.tree_leaves(params),
                            adamw.tree_leaves(full)):
                assert torch.equal(a, b), cfg.name
    finally:
        dist.destroy_process_group()


def test_dryrun_sharded_argument_bytes_match_reference(runs):
    """The sharded ``analyze_cell`` of reduced internlm2's mini train cell
    (B 8 x S 64) on a fake (2, 2) world: its argument bytes (rank 0's
    parameter, AdamW and batch shards) within 1% of the reference's
    compiled ``argument_size_in_bytes`` on 4 host devices. The two count
    the same tensors at the same shard shapes: they agree to the byte."""
    _, _, out = runs
    want = int(next(line.split()[1] for line in out.splitlines()
                    if line.startswith("ARG")))
    rec = analyze_cell(get_reduced_config(DRY_ARCH), DRY_SHAPE,
                       ((2, 2), ("data", "model")))
    assert rec["param_placement"] == "sharded"
    got = rec["memory"]["argument_bytes"]
    assert abs(got - want) <= ARG_TOL * want, (got, want)
    assert got == want, f"the port counts {got} bytes, the reference {want}"
    hlo = rec["hlo"]["collective_by_op"]
    assert hlo["all-gather"] > 0 and hlo["reduce-scatter"] > 0


def test_full_size_internlm2_train_4k_is_sharded_and_fits():
    """internlm2-1.8b ``train_4k`` (B 256 x S 4096) on the single-pod
    (16, 16) mesh: the sharded step, rank 0 within the H100's HBM."""
    rec = analyze_cell(get_config("internlm2-1.8b"), get_shape("train_4k"),
                       "single")
    assert rec["param_placement"] == "sharded"
    assert rec["memory"]["fits_hbm"], rec["memory"]
    regions = rec["hlo"]["kernel_regions"]
    assert regions["flash_attention_fwd"] == 2 * 24
    assert regions["flash_attention_bwd"] == 24


def test_other_cells_stay_replicated():
    """A ring-attention train cell and Zamba2's and xLSTM's serve cells say
    "replicated" and why; the sharded step refuses ring attention for the
    same reason. The MoE train cells (olmoe, arctic), the Zamba2 and xLSTM
    ones and the transformer's 15 serve cells are sharded now, and a
    reduced olmoe whose data ranks' rows would split a group of the global
    batch raises in training, naming the sizes."""
    from repro_torch.distributed.collectives import (BatchSplit,
                                                     activate_batch_split)
    from repro_torch.train.train_step import sharded_step_gap
    train = get_shape("train_4k")
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        assert sharded_step_gap(get_config(arch)) == "", arch
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            placement, why = cell_placement(get_config(arch),
                                            get_shape(shape))
            assert placement == "replicated" and why, (arch, shape)
    serve = 0
    for arch in ("internlm2-1.8b", "yi-6b", "mistral-nemo-12b",
                 "starcoder2-7b", "hubert-xlarge", "paligemma-3b",
                 "olmoe-1b-7b", "arctic-480b"):
        for shape in ("prefill_32k", "decode_32k"):
            if arch == "hubert-xlarge" and shape == "decode_32k":
                continue                 # encoder-only: no decode cell
            assert cell_placement(get_config(arch), get_shape(shape)) == (
                "sharded", ""), (arch, shape)
            serve += 1
    assert serve == 15
    for arch in ("internlm2-1.8b", "yi-6b", "mistral-nemo-12b",
                 "starcoder2-7b", "hubert-xlarge", "paligemma-3b",
                 "olmoe-1b-7b", "arctic-480b", "zamba2-1.2b",
                 "xlstm-350m"):
        assert cell_placement(get_config(arch), train) == ("sharded", "")
    ring = get_reduced_config("internlm2-1.8b").replace(attn_impl="ring")
    placement, why = cell_placement(ring, get_shape("prefill_32k"))
    assert placement == "replicated" and "ring" in why
    placement, why = cell_placement(ring, train)
    assert placement == "replicated" and "ring" in why
    with pytest.raises(NotImplementedError) as err:
        build_train_step(ring, adamw.AdamWConfig(), sharded=True)
    assert why in str(err.value), (why, str(err.value))
    # reduced olmoe: B 4 x S 16 is one global group of 64 tokens, which two
    # data ranks' 32 tokens each would split
    cfg = get_reduced_config("olmoe-1b-7b")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cpu", dtype=torch.float32)
    batch = {n: torch.zeros((2, S), dtype=torch.int64)
             for n in ("tokens", "labels")}
    # the groups are cut before any collective: no process group needed
    with activate_batch_split(BatchSplit((), 2)), \
            pytest.raises(ValueError) as err:
        get_family(cfg).train_loss(cfg, params, batch)
    msg = str(err.value)
    assert cfg.name in msg and "32 tokens" in msg and "of 64" in msg, msg
