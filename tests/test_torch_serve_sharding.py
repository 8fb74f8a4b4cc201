"""The sharded prefill, encode and decode steps (FSDP over "data", tensor
and expert parallelism over "model", the decode cache split by sequence)
against the reference on the CPU.

Once for the module, 4 gloo ranks (separate processes on a ``FileStore``)
on a (2, 2) ("data", "model") mesh in f32, one JAX process running the
reference's ``build_prefill_step`` / ``build_encode_step`` /
``build_decode_step`` on the same weights, global batch and decode cache,
and one JAX process with 4 forced host devices compiling the reference's
sharded prefill and decode cells, all at once. Each rank takes the
weights through ``params_from_reference`` and ``shard_params``, its rows
through ``local_serve_batch`` and its block of the decode cache through
``shard_tree``, then runs the prefill (or encode) under the prefill
cell's rules and 4 decode steps under the decode cell's (``cache_seq``
over "model", or over "data" at B 1, as ``shape_rule_overrides`` says),
the tokens of each step given (the same on both sides, so a near tie
cannot fork the runs), for:

- reduced internlm2 (4 heads over 2 KV heads: both sharded; at decode
  the cache's KV heads whole, the new rows gathered over "model");
- reduced paligemma (4 heads over 1 KV head: the heads sharded, the KV
  head whole; patches, the tied vocabulary);
- reduced starcoder2 with 3 heads over 1 (the heads whole: the attention
  replicated over "model", its decode partials combined over it);
- reduced hubert encode (frames, bidirectional, the vocabulary split);
- reduced olmoe (8 experts top 4 over "model"): its one group of 64
  prefill tokens and its 4 decode tokens span both data ranks, so each
  gathers the group and routes it whole;
- reduced internlm2 at B 1, the batch whole, the cache's sequence over
  "data" and its KV heads over "model";
- reduced olmoe at B 1, the batch whole on every rank, capacity factor
  0.5 so that experts drop tokens: its 16 prefill tokens, less than a
  group, are routed as they are, not gathered from both data ranks (a
  duplicated group would double every expert's capacity).

The decode positions cross the blocks' boundary (12 of 24) and run past
the cache (24, 25: the rows dropped). Held: prefill and encode logits and
the gathered prefill cache within 1e-5 of the reference's (of its largest
magnitude); every decode step's logits within 1e-5 relative, its tokens
equal where the reference's top-1 margin exceeds 1e-4, the gathered cache
after 4 steps within 1e-5; every rank the same; every rank's parameter,
batch and cache shard shapes equal to the reference's
``NamedSharding(...).shard_shape`` over an ``AbstractMesh``. In process:
the steps on a one-process (1, 1) mesh against the replicated ones (bit
for bit), the dry-run's sharded argument bytes of a prefill and a decode
cell against the reference's compiled ones, mistral-nemo-12b's
``decode_32k`` on the single-pod mesh sharded and fitting, and the
builders' refusals.
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
from repro_torch.distributed.sharding import (shard_params,  # noqa: E402
                                              shard_tree)
from repro_torch.launch.dryrun import analyze_cell  # noqa: E402
from repro_torch.launch.input_specs import cell_placement  # noqa: E402
from repro_torch.models import get_family, init_params  # noqa: E402
from repro_torch.train.train_step import (build_decode_step,  # noqa: E402
                                          build_encode_step,
                                          build_prefill_step,
                                          local_serve_batch,
                                          sharded_serve_gap)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
REF_TOL = 1e-5          # logits and caches against the reference (relative)
MARGIN = 1e-4           # tokens are held where the top-1 margin exceeds it
SPAWN_TIMEOUT_S = 240   # each process; all finish in ~10-20 s here
S, SMAX, STEPS = 16, 24, 4
#: case -> (arch, config overrides, global batch, the decode cache's
#: sequence axis (None: encode only), the first decode positions)
CASES = {
    "heads_and_kv_sharded": ("internlm2-1.8b", {}, 4, "model",
                             [16, 9, 10, 22]),
    "kv_whole": ("paligemma-3b", {}, 4, "model", [16, 3, 11, 22]),
    "heads_whole": ("starcoder2-7b", {"num_heads": 3, "num_kv_heads": 1},
                    4, "model", [16, 9, 10, 22]),
    "encode": ("hubert-xlarge", {}, 4, None, None),
    "moe_group_spans_ranks": ("olmoe-1b-7b", {}, 4, "model",
                              [16, 9, 10, 22]),
    "batch1_seq_over_data": ("internlm2-1.8b", {}, 1, "data", [10]),
    "moe_batch1": ("olmoe-1b-7b", {"capacity_factor": 0.5}, 1, "data",
                   [10]),
}
# The reduced cells of the dry-run comparison (the reference's
# tests/test_sharding.py widths): B 8, so the decode cache's sequence
# splits over "model" (shape_rule_overrides).
DRY_ARCH = "internlm2-1.8b"
DRY_SHAPES = (ShapeConfig("mini_prefill", "prefill", 64, 8),
              ShapeConfig("mini_decode", "decode", 64, 8))
LOGIT_AXES = ("batch", "vocab")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process, as the other sharding files."""
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
    arch, kw = CASES[case][:2]
    return get_reduced_config(arch).replace(dtype="float32", **kw)


def _prefill_batch(cfg, rng, b):
    text = S - cfg.frontend_len if cfg.frontend == "patch" else S
    if cfg.frontend == "frame":
        return {"frames": rng.standard_normal((b, S, cfg.frontend_dim),
                                              dtype=np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
        np.int32)}
    if cfg.frontend == "patch":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32)
    return batch


def _inputs(path):
    """Every case's weights (the port's init, seed i), prefill batch and,
    for decode, a whole (L, B, SMAX, KV, hd) cache, the tokens of every
    step and the first positions."""
    arrays = {}
    for i, (case, (_, _, b, seq_axis, pos)) in enumerate(CASES.items()):
        cfg = _port_cfg(case)
        params = init_params(cfg, get_family(cfg).layout(cfg), seed=i,
                             device="cpu", dtype=torch.float32)
        arrays.update({f"{case}/p/{k}": v.numpy()
                       for k, v in _flat(params).items()})
        rng = np.random.default_rng(i)
        arrays.update({f"{case}/b/{k}": v
                       for k, v in _prefill_batch(cfg, rng, b).items()})
        if seq_axis is None:
            continue
        shape = (cfg.num_layers, b, SMAX, cfg.num_kv_heads, cfg.head_dim)
        for k in ("k", "v"):
            arrays[f"{case}/c/{k}"] = rng.standard_normal(
                shape, dtype=np.float32)
        arrays[f"{case}/tokens"] = rng.integers(
            0, cfg.vocab_size, (STEPS, b, 1)).astype(np.int32)
        arrays[f"{case}/pos"] = np.array(pos, np.int32)
    np.savez(path, **arrays)


_COMMON = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
CASES = %r
S, SMAX, STEPS = %r
inp = dict(np.load(sys.argv[2]))

def tree_of(case, kind, conv):
    out = {}
    for key, val in inp.items():
        parts = key.split("/", 2)
        if len(parts) < 3 or parts[0] != case or parts[1] != kind:
            continue
        node = out
        *dirs, leaf = parts[2].split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = conv(val)
    return out
"""

_JAX_SIDE = _COMMON + r"""
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.train.train_step import (build_decode_step, build_encode_step,
                                    build_prefill_step)
FAST_XLA = {"xla_backend_optimization_level": 0}
out = {}
for case, (arch, kw, b, seq_axis, _) in CASES.items():
    cfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    params = tree_of(case, "p", jnp.asarray)
    batch = tree_of(case, "b", jnp.asarray)
    if cfg.encoder_only:
        out[f"{case}/logits"] = jax.jit(build_encode_step(cfg))(params, batch)
        continue
    logits, cache = jax.jit(build_prefill_step(cfg))(params, batch)
    out[f"{case}/logits"] = logits
    for k, v in cache.items():
        out[f"{case}/cache/{k}"] = v
    cache = tree_of(case, "c", jnp.asarray)
    pos = jnp.asarray(inp[f"{case}/pos"])
    step = jax.jit(build_decode_step(cfg))
    for i in range(STEPS):
        tok, logits, cache = step(params, {
            "tokens": jnp.asarray(inp[f"{case}/tokens"][i]),
            "pos": pos + i}, cache)
        out[f"{case}/d{i}/logits"] = logits
        out[f"{case}/d{i}/tokens"] = tok
    for k, v in cache.items():
        out[f"{case}/dcache/{k}"] = v
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
from repro_torch.distributed.sharding import (gather_leaf, gather_tree,
                                              shard_params, shard_tree)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_family, params_from_reference
from repro_torch.train.train_step import (build_decode_step,
                                          build_encode_step,
                                          build_prefill_step,
                                          local_serve_batch)

def shapes(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            shapes(v, prefix + k + "/", out)
        else:
            out[prefix + k] = np.array(v.shape)

def cache_shapes(cfg, b, s):
    whole = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": whole, "v": whole}

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
out = {}
for case, (arch, kw, b, seq_axis, _) in CASES.items():
    cfg = get_reduced_config(arch).replace(dtype="float32", **kw)
    family = get_family(cfg)
    layout = family.layout(cfg)
    whole = params_from_reference(cfg, layout, tree_of(case, "p", np.asarray),
                                  device="cpu", dtype=torch.float32)
    batch = tree_of(case, "b", torch.from_numpy)
    rules = ShardingRules(mesh)
    with activate_rules(rules):
        params = shard_params(whole, layout, rules)
        shapes(params, case + "/shape/p/", out)
        mine = local_serve_batch(batch)
        shapes(mine, case + "/shape/b/", out)
        if cfg.encoder_only:
            logits = build_encode_step(cfg, sharded=True, global_batch=b)(
                params, mine)
            out[f"{case}/logits"] = gather_leaf(
                logits, (b, S, cfg.vocab_size), ("batch", None, "vocab"),
                rules)
            continue
        logits, cache = build_prefill_step(cfg, sharded=True,
                                           global_batch=b)(params, mine)
        out[f"{case}/logits"] = gather_leaf(logits, (b, cfg.vocab_size),
                                            ("batch", "vocab"), rules)
        shapes(cache, case + "/shape/cache/", out)
        for k, v in gather_tree(cache, cache_shapes(cfg, b, S),
                                family.cache_axes(cfg), rules).items():
            out[f"{case}/cache/{k}"] = v
    rules = ShardingRules(mesh, {"cache_seq": seq_axis})
    with activate_rules(rules):
        params = shard_params(whole, layout, rules)
        cache = shard_tree(tree_of(case, "c", torch.from_numpy),
                           family.cache_axes(cfg), rules)
        shapes(cache, case + "/shape/dcache/", out)
        step = build_decode_step(cfg, sharded=True, global_batch=b,
                                 cache_len=SMAX)
        pos = torch.from_numpy(inp[f"{case}/pos"])
        for i in range(STEPS):
            mine = local_serve_batch({
                "tokens": torch.from_numpy(inp[f"{case}/tokens"][i]),
                "pos": pos + i})
            tok, logits, cache = step(params, mine, cache)
            out[f"{case}/d{i}/logits"] = gather_leaf(
                logits, (b, cfg.vocab_size), ("batch", "vocab"), rules)
            out[f"{case}/d{i}/tokens"] = gather_leaf(tok, (b,), ("batch",),
                                                     rules)
        for k, v in gather_tree(cache, cache_shapes(cfg, b, SMAX),
                                family.cache_axes(cfg), rules).items():
            out[f"{case}/dcache/{k}"] = v
np.savez(sys.argv[3], **{k: (v.numpy() if isinstance(v, torch.Tensor)
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
from repro.launch.input_specs import build_cell, shape_rule_overrides
cfg = get_reduced_config(%r).replace(dtype="float32")
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
for shape in %r:
    shape = ShapeConfig(*shape)
    rules = ShardingRules(mesh, shape_rule_overrides(cfg, shape))
    step, args, sh = build_cell(cfg, shape, rules)
    with jax.set_mesh(mesh), activate_rules(rules):
        compiled = jax.jit(step, in_shardings=sh).lower(*args).compile()
    print("ARG", shape.name, compiled.memory_analysis().argument_size_in_bytes)
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
    tmp = tmp_path_factory.mktemp("serve_sharding")
    inp = tmp / "inputs.npz"
    _inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def spawn(code, *args):
        return subprocess.Popen([sys.executable, "-c", code, SRC, *args],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    names = list(CASES)
    halves = [{k: CASES[k] for k in names[i::2]} for i in range(2)]
    procs = [(spawn(_JAX_DRYRUN % (DRY_ARCH, [
        (s.name, s.kind, s.seq_len, s.global_batch) for s in DRY_SHAPES])),
        "the reference's dry-run")]
    procs += [(spawn(_JAX_SIDE % (half, (S, SMAX, STEPS)), str(inp),
                     str(tmp / f"jax{i}.npz")), f"the JAX side {i}")
              for i, half in enumerate(halves)]
    for r in range(4):
        procs.append((spawn(_TORCH_RANK % (CASES, (S, SMAX, STEPS)),
                            str(inp), str(tmp / f"rank{r}.npz"), str(r),
                            str(tmp / "store")), f"gloo rank {r}"))
    outs = [_wait(proc, what) for proc, what in procs]
    ref = {k: v for i in range(len(halves))
           for k, v in np.load(tmp / f"jax{i}.npz").items()}
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return ref, ranks, outs[0]


def _err(got, want) -> float:
    """max|got - want| over max|want|."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _same_on_every_rank(ranks, key):
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[key], ranks[0][key], err_msg=key)


def test_prefill_and_encode_match_reference(runs):
    """The prefill's last-position logits (the encode's every position's)
    and the gathered prefill cache within 1e-5 of the reference's, equal on
    every rank."""
    ref, ranks, _ = runs
    for case in CASES:
        keys = [f"{case}/logits"] + [k for k in ref
                                     if k.startswith(f"{case}/cache/")]
        assert len(keys) == (1 if CASES[case][3] is None else 3), keys
        for key in keys:
            assert ranks[0][key].shape == ref[key].shape, key
            assert _err(ranks[0][key], ref[key]) <= REF_TOL, \
                (key, _err(ranks[0][key], ref[key]))
            _same_on_every_rank(ranks, key)


def test_decode_over_sequence_split_cache_matches_reference(runs):
    """4 decode steps over a cache split by sequence (over "model", and
    over "data" at B 1), positions crossing the blocks' boundary and
    running past the cache: every step's logits within 1e-5 relative of
    the reference's, its tokens equal where the reference's top-1 margin
    exceeds 1e-4 (every token here), and the gathered cache after the last
    step within 1e-5, the rows past the cache dropped; every rank the
    same. The olmoe case routes its one group of 4 tokens, which spans
    both data ranks, as the reference does."""
    ref, ranks, _ = runs
    held = 0
    for case, (_, _, _, seq_axis, _) in CASES.items():
        if seq_axis is None:
            continue
        for i in range(STEPS):
            key = f"{case}/d{i}/logits"
            assert _err(ranks[0][key], ref[key]) <= REF_TOL, \
                (key, _err(ranks[0][key], ref[key]))
            top2 = np.sort(ref[key], axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > MARGIN
            tok = f"{case}/d{i}/tokens"
            np.testing.assert_array_equal(ranks[0][tok][clear],
                                          ref[tok][clear], err_msg=tok)
            held += int(clear.sum())
            _same_on_every_rank(ranks, key)
            _same_on_every_rank(ranks, tok)
        for k in ("k", "v"):
            key = f"{case}/dcache/{k}"
            assert _err(ranks[0][key], ref[key]) <= REF_TOL, key
            _same_on_every_rank(ranks, key)
    assert held == STEPS * (4 * 4 + 2), held


def test_shard_shapes_match_reference(runs):
    """Every rank's parameter, batch, prefill-cache and decode-cache shards
    are the reference's ``shard_shape`` over an AbstractMesh((2, 2)), under
    the prefill cell's rules and the decode cell's (``cache_seq``)."""
    _, ranks, _ = runs
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    for case, (arch, kw, b, seq_axis, _) in CASES.items():
        jcfg = jax_reduced(arch).replace(dtype="float32", **kw)
        fam = jax_family(jcfg)
        rules = jax_sharding.ShardingRules(mesh, {})
        want = {f"p/{n}": tuple(sh.shard_shape(spec.shape)) for (n, sh), spec
                in zip(_flat(jax_sharding.param_sharding(
                    fam.layout(jcfg), rules)).items(),
                    _flat(fam.layout(jcfg)).values())}
        rng = np.random.default_rng(0)
        for n, x in _prefill_batch(_port_cfg(case), rng, b).items():
            axes = ("batch",) + (None,) * (x.ndim - 1)
            want[f"b/{n}"] = tuple(rules.named(x.shape, axes).shard_shape(
                x.shape))
        if seq_axis is not None:
            structs, axes = fam.cache_layout(jcfg, b, S)
            for n in ("k", "v"):
                want[f"cache/{n}"] = tuple(rules.named(
                    structs[n].shape, axes[n]).shard_shape(structs[n].shape))
            drules = jax_sharding.ShardingRules(mesh, {"cache_seq": seq_axis})
            structs, axes = fam.cache_layout(jcfg, b, SMAX)
            for n in ("k", "v"):
                want[f"dcache/{n}"] = tuple(drules.named(
                    structs[n].shape, axes[n]).shard_shape(structs[n].shape))
        for rank in ranks:
            got = {k.split("/shape/", 1)[1]: tuple(int(d) for d in v)
                   for k, v in rank.items()
                   if k.startswith(f"{case}/shape/")}
            assert got == want, (case, got, want)
    # the decode cells' blocks: the sequence split, the KV heads whole
    # (over "model") or split (B 1, over "data")
    assert tuple(ranks[3]["heads_and_kv_sharded/shape/dcache/k"]) == (
        2, 2, SMAX // 2, 2, 16)
    assert tuple(ranks[3]["batch1_seq_over_data/shape/dcache/k"]) == (
        2, 1, SMAX // 2, 1, 16)


def _step_inputs(cfg, b, seed):
    gen = torch.Generator().manual_seed(seed)
    if cfg.frontend == "frame":
        return {"frames": torch.randn(b, S, cfg.frontend_dim, generator=gen)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, S),
                                    generator=gen)}


def test_one_rank_mesh_is_replicated_steps_bit_for_bit():
    """On a one-process (1, 1) mesh, every collective issued over its one
    rank: the sharded prefill of reduced internlm2 (bf16, its default) and
    the sharded encode of reduced hubert equal the replicated steps bit
    for bit (logits and cache); 4 sharded decode steps of reduced
    internlm2 and reduced olmoe in f32, the cache's sequence over the
    one-rank "model" (the partial softmax and its combine run), equal the
    replicated decode's logits (held within 1e-5 relative, seen equal bit
    for bit: over one rank the combine's weight is l / l = 1), tokens and
    caches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    b = 4
    try:
        rules = ShardingRules(mesh)
        for arch, dtype in (("internlm2-1.8b", None),
                            ("hubert-xlarge", None),
                            ("internlm2-1.8b", "float32"),
                            ("olmoe-1b-7b", "float32")):
            cfg = get_reduced_config(arch)
            cfg = cfg.replace(dtype=dtype) if dtype else cfg
            fam = get_family(cfg)
            layout = fam.layout(cfg)
            params = init_params(cfg, layout, seed=0, device="cpu")
            batch = _step_inputs(cfg, b, 1)
            with activate_rules(rules):
                shards = shard_params(params, layout, rules)
            if cfg.encoder_only:
                want = build_encode_step(cfg)(params, batch)
                with activate_rules(rules):
                    got = build_encode_step(cfg, sharded=True,
                                            global_batch=b)(
                        shards, local_serve_batch(batch))
                assert torch.equal(want, got), arch
                continue
            want = build_prefill_step(cfg)(params, batch)
            with activate_rules(rules):
                got = build_prefill_step(cfg, sharded=True, global_batch=b)(
                    shards, local_serve_batch(batch))
            assert torch.equal(want[0], got[0]), arch
            assert all(torch.equal(want[1][k], got[1][k]) for k in "kv")
            if dtype is None:
                continue
            rep = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, SMAX - S))
                   for k, v in want[1].items()}
            drules = ShardingRules(mesh, {"cache_seq": "model"})
            with activate_rules(drules):
                cache = shard_tree({k: v.clone() for k, v in rep.items()},
                                   fam.cache_axes(cfg), drules)
            step = build_decode_step(cfg)
            sstep = build_decode_step(cfg, sharded=True, global_batch=b,
                                      cache_len=SMAX)
            gen = torch.Generator().manual_seed(2)
            pos = torch.tensor([16, 9, 11, 22])
            for i in range(STEPS):
                one = {"tokens": torch.randint(0, cfg.vocab_size, (b, 1),
                                               generator=gen),
                       "pos": pos + i}
                t0, l0, rep = step(params, one, rep)
                with activate_rules(drules):
                    t1, l1, cache = sstep(shards, local_serve_batch(one),
                                          cache)
                assert _err(l1.numpy(), l0.numpy()) <= REF_TOL, arch
                assert torch.equal(l1, l0), (arch, i)
                assert torch.equal(t0, t1), (arch, i)
                assert all(torch.equal(rep[k], cache[k]) for k in "kv")
    finally:
        dist.destroy_process_group()


def test_dryrun_serve_argument_bytes_match_reference(runs):
    """The sharded ``analyze_cell`` of reduced internlm2's mini prefill and
    decode cells (B 8, S 64; decode's cache split by sequence over "model")
    on a fake (2, 2) world: the argument bytes (rank 0's parameter, batch
    and cache shards) equal to the reference's compiled
    ``argument_size_in_bytes`` on 4 host devices; the decode step gathers
    each layer's weights over "data" and combines its partials over
    "model" (all-gathers), and reduces its row-parallel sums."""
    _, _, out = runs
    want = {line.split()[1]: int(line.split()[2])
            for line in out.splitlines() if line.startswith("ARG")}
    cfg = get_reduced_config(DRY_ARCH).replace(dtype="float32")
    for shape in DRY_SHAPES:
        rec = analyze_cell(cfg, shape, ((2, 2), ("data", "model")))
        assert rec["param_placement"] == "sharded", rec
        got = rec["memory"]["argument_bytes"]
        assert got == want[shape.name], (shape.name, got, want)
        hlo = rec["hlo"]["collective_by_op"]
        assert hlo["all-gather"] > 0 and hlo["all-reduce"] > 0, hlo


def test_full_size_mistral_nemo_decode_32k_is_sharded_and_fits():
    """mistral-nemo-12b ``decode_32k`` (B 128, a 32,768-position cache) on
    the single-pod (16, 16) mesh: the sharded step, rank 0 within the
    H100's HBM (696.1 GiB replicated), 81 RMSNorms and no flash attention
    a step, the weights' gathers over "data" on the wire."""
    rec = analyze_cell(get_config("mistral-nemo-12b"), get_shape("decode_32k"),
                       "single")
    assert rec["param_placement"] == "sharded"
    assert rec["memory"]["fits_hbm"], rec["memory"]
    assert rec["hlo"]["kernel_regions"] == {"rmsnorm_fused": 81}
    assert rec["hlo"]["collective_by_op"]["all-gather"] > 0


def test_serve_builders_refuse_replicated_cells():
    """The Zamba2 and xLSTM serve cells and a ring-attention transformer
    stay replicated; each sharded serve builder refuses them naming the
    reason the placement gives, and refuses a covered config without the
    global batch. The transformer's 15 serve cells are sharded."""
    from repro_torch.configs import SHAPES, runnable
    for cfg in (get_reduced_config("zamba2-1.2b"),
                get_reduced_config("xlstm-350m"),
                get_reduced_config("internlm2-1.8b").replace(
                    attn_impl="ring")):
        why = sharded_serve_gap(cfg)
        assert why, cfg.name
        for shape in ("prefill_32k", "decode_32k"):
            assert cell_placement(cfg, get_shape(shape)) == (
                "replicated", why)
        for build, kw in ((build_prefill_step, {}), (build_encode_step, {}),
                          (build_decode_step, dict(global_batch=4,
                                                   cache_len=SMAX))):
            with pytest.raises(NotImplementedError) as err:
                build(cfg, sharded=True, **kw)
            assert why in str(err.value), (why, str(err.value))
    # a batch of one row is whole on every rank, so its split is not the
    # step's rows times the batch dimensions: every builder needs it
    ok = get_reduced_config("internlm2-1.8b")
    for build, kw in ((build_prefill_step, {}), (build_encode_step, {}),
                      (build_decode_step, dict(cache_len=SMAX))):
        with pytest.raises(ValueError, match="global_batch"):
            build(ok, sharded=True, **kw)
    sharded = [(arch, shape.name)
               for arch in ("arctic-480b", "olmoe-1b-7b", "mistral-nemo-12b",
                            "starcoder2-7b", "yi-6b", "internlm2-1.8b",
                            "paligemma-3b", "hubert-xlarge")
               for shape in SHAPES.values()
               if shape.kind != "train" and runnable(get_config(arch),
                                                     shape)[0]
               and cell_placement(get_config(arch), shape)[0] == "sharded"]
    assert len(sharded) == 15, sharded
