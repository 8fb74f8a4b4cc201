"""The port's distributed layer against the reference's on the CPU.

One gloo group of 4 ranks (separate processes on a ``FileStore``) runs,
from the same numpy inputs as one JAX process on 4 forced host devices:

- ``ring_attention_sharded`` at R = 4 (a (1, 4) ("data", "model") mesh),
  causal and full, forward and the gradients of sum(out * dout), against
  the reference's ``ring_attention_sharded`` and ``jax.vjp`` (2e-5, the
  reference's own tolerance); ``ring_attention_single_device`` with 4
  shards on rank 0 equal to the gloo ring bit for bit;
- reduced starcoder2 (6 heads over 3 KV heads, hd 16, f32; the case of
  tests/test_ring_model.py) with ``attn_impl="ring"`` on a (2, 2) mesh:
  ``build_loss_and_grads`` (data parallel over "data", the ring over
  "model") against the reference's ring-model loss (1e-5 relative) and
  ``jax.grad`` (1e-4), every rank holding the same loss and gradients;
- ``compressed_psum`` over the world against the reference's inside
  ``shard_map`` on a 4-way "pod" mesh, and equal to the mean of the ranks'
  ``ef_step`` outputs.

In process: the lse-taking plain backward, the single-device ring against
the reference's dense attention, the train step with no rules and on a
one-process mesh, and ``compressed_psum`` over one rank.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers import dense_attention as jax_dense  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.distributed import (ShardingRules, activate_rules,  # noqa: E402
                                     current_rules,
                                     ring_attention_single_device)
from repro_torch.kernels import (attention_bwd_lse_reference,  # noqa: E402
                                 attention_lse_reference,
                                 attention_reference)
from repro_torch.models import get_family, init_params  # noqa: E402
from repro_torch.train import adamw  # noqa: E402
from repro_torch.train.grad_compress import (CompressorState,  # noqa: E402
                                             compressed_psum, ef_step)
from repro_torch.train.train_step import (build_loss_and_grads,  # noqa: E402
                                          build_train_step)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RING_TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# Each side of the 4-rank comparison; both finish in ~5-15 s here.
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_cfg():
    return get_reduced_config("starcoder2-7b").replace(
        dtype="float32", num_heads=6, num_kv_heads=3, head_dim=16)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _inputs(path):
    """Every input of the 4-rank comparison, from seed 0, into ``path``."""
    rng = np.random.default_rng(0)

    def rn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    cfg = _ring_cfg()
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cpu", dtype=torch.float32)
    arrays = {"q": rn(2, 128, 6, 16), "k": rn(2, 128, 3, 16),
              "v": rn(2, 128, 3, 16), "dout": rn(2, 128, 6, 16),
              "tokens": rng.integers(0, cfg.vocab_size, (2, 64)),
              "labels": rng.integers(0, cfg.vocab_size, (2, 64)),
              "cg": rn(4, 2, 256), "cr": 0.01 * rn(4, 2, 256)}
    arrays.update({"p/" + k: v.numpy() for k, v in _flat(params).items()})
    np.savez(path, **arrays)


_JAX_SIDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_reduced_config
from repro.distributed.ring_attention import ring_attention_sharded
from repro.distributed.sharding import ShardingRules, activate_rules
from repro.models import get_family
from repro.train.grad_compress import CompressorState, compressed_psum

inp = dict(np.load(sys.argv[2]))
out = {}
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(auto,) * 2)
q, k, v, dout = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "dout"))
for causal in (True, False):
    fn = jax.jit(lambda q, k, v: ring_attention_sharded(
        q, k, v, mesh, causal=causal, batch_axes=("data",)))
    o, vjp = jax.vjp(fn, q, k, v)
    out[f"out_{causal}"] = o
    for n, g in zip("qkv", vjp(dout)):
        out[f"d{n}_{causal}"] = g

params = {}
for key, val in inp.items():
    if key.startswith("p/"):
        node = params
        *path, leaf = key[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
cfg = get_reduced_config("starcoder2-7b").replace(
    dtype="float32", num_heads=6, num_kv_heads=3, head_dim=16,
    attn_impl="ring")
fam = get_family(cfg)
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
mesh2 = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
with jax.set_mesh(mesh2), activate_rules(ShardingRules(mesh2, {})):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: fam.train_loss(cfg, p, b)[0]))(params, batch)
out["loss"] = loss

def flat(tree, prefix):
    for k, val in tree.items():
        if isinstance(val, dict):
            flat(val, prefix + k + "/")
        else:
            out["g/" + prefix + k] = val
flat(grads, "")

pod = jax.make_mesh((4,), ("pod",), axis_types=(auto,))
def one(g, s):
    red, ns = compressed_psum({"w": g["w"][0]}, "pod",
                              CompressorState({"w": s.residual["w"][0]}))
    return {"w": red["w"][None]}, {"w": ns.residual["w"][None]}
red, res = jax.shard_map(one, mesh=pod, in_specs=(P("pod"), P("pod")),
                         out_specs=(P("pod"), P("pod")))(
    {"w": jnp.asarray(inp["cg"])},
    CompressorState({"w": jnp.asarray(inp["cr"])}))
out["psum"], out["resid"] = red["w"], res["w"]
np.savez(sys.argv[3], **{k: np.asarray(val) for k, val in out.items()})
print("JAX-SIDE-OK")
"""

_TORCH_RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[5], 4),
                        rank=rank, world_size=4)
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import (ShardingRules, activate_rules,
                                     ring_attention_sharded,
                                     ring_attention_single_device)
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import adamw
from repro_torch.train.grad_compress import (CompressorState,
                                             compressed_psum, ef_step)
from repro_torch.train.train_step import build_loss_and_grads

inp = dict(np.load(sys.argv[2]))
out = {}
ring = make_mesh((1, 4), ("data", "model"), device="cpu")
for causal in (True, False):
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_() for n in "qkv")
    dout = torch.from_numpy(inp["dout"])
    for tag, fn in (("", lambda: ring_attention_sharded(
                        q, k, v, ring, causal=causal)),
                    ("single_", lambda: ring_attention_single_device(
                        q, k, v, shards=4, causal=causal))):
        if tag and rank:
            continue
        o = fn()
        out[f"{tag}out_{causal}"] = o.detach()
        for n, g in zip("qkv", torch.autograd.grad(o, (q, k, v), dout)):
            out[f"{tag}d{n}_{causal}"] = g

cfg = get_reduced_config("starcoder2-7b").replace(
    dtype="float32", num_heads=6, num_kv_heads=3, head_dim=16,
    attn_impl="ring")
params = {}
for key, val in inp.items():
    if key.startswith("p/"):
        node = params
        *path, leaf = key[2:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(val).requires_grad_()
batch = {"tokens": torch.from_numpy(inp["tokens"]),
         "labels": torch.from_numpy(inp["labels"])}
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
with activate_rules(ShardingRules(mesh)):
    loss, _, grads = build_loss_and_grads(cfg)(params, batch)
out["loss"] = loss
names = []
def walk(tree, prefix):
    for k, val in tree.items():
        if isinstance(val, dict):
            walk(val, prefix + k + "/")
        else:
            names.append(prefix + k)
walk(params, "")
for name, g in zip(names, grads):
    out["g/" + name] = g

state = CompressorState({"w": torch.from_numpy(inp["cr"][rank])})
g = {"w": torch.from_numpy(inp["cg"][rank])}
out["ef"] = ef_step(g, state)[0]["w"]
red, ns = compressed_psum(g, None, state)
out["psum"], out["resid"] = red["w"], ns.residual["w"]
np.savez(sys.argv[3], **{k: v.detach().numpy() for k, v in out.items()})
dist.destroy_process_group()
print("RANK-OK")
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


def test_gloo_ring_model_and_compressed_psum_match_reference(tmp_path):
    inp = tmp_path / "inputs.npz"
    _inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_out = tmp_path / "jax.npz"
    procs = [(subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, SRC, str(inp), str(jax_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "the JAX side")]
    store = tmp_path / "store"
    for r in range(4):
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _TORCH_RANK, SRC, str(inp),
             str(tmp_path / f"rank{r}.npz"), str(r), str(store)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), f"gloo rank {r}"))
    for proc, what in procs:
        _wait(proc, what)
    ref = np.load(jax_out)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    mine = ranks[0]
    for causal in (True, False):
        for n in ("out", "dq", "dk", "dv"):
            key = f"{n}_{causal}"
            np.testing.assert_allclose(mine[key], ref[key], rtol=RING_TOL,
                                       atol=RING_TOL, err_msg=key)
            np.testing.assert_array_equal(mine["single_" + key], mine[key],
                                          err_msg="single device " + key)
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[key], mine[key])
    np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=LOSS_TOL)
    gkeys = sorted(k for k in ref.files if k.startswith("g/"))
    assert gkeys == sorted(k for k in mine.files if k.startswith("g/"))
    errs = {k: float(np.abs(mine[k] - ref[k]).max()) for k in gkeys}
    assert max(errs.values()) < GRAD_TOL, errs
    for other in ranks[1:]:
        assert other["loss"] == mine["loss"]
        for k in gkeys:
            np.testing.assert_array_equal(other[k], mine[k])
    mean_ef = np.mean([r["ef"] for r in ranks], axis=0)
    for r, other in enumerate(ranks):
        np.testing.assert_allclose(other["psum"], ref["psum"][r], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(other["psum"], mean_ef, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(other["resid"], ref["resid"][r],
                                   rtol=1e-6, atol=1e-7)


def test_attention_bwd_lse_reference_matches_jax_vjp():
    """The plain backward with the given out and lse equals ``jax.vjp`` of
    the reference's dense attention, causal and full, G 2."""
    rng = np.random.default_rng(1)
    q, k, v, dout = (rng.standard_normal(s, dtype=np.float32) for s in
                     ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16),
                      (2, 40, 4, 16)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    for causal in (True, False):
        out = attention_reference(tq, tk, tv, causal=causal)
        lse = attention_lse_reference(tq, tk, tv, causal=causal)
        got = attention_bwd_lse_reference(tq, tk, tv, out, tdo, lse,
                                          causal=causal)
        _, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for g, want in zip(got, vjp(jnp.asarray(dout))):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=RING_TOL, atol=RING_TOL)


def test_single_device_ring_matches_reference_attention():
    """``ring_attention_single_device`` at 1, 2 and 4 shards, causal and
    full: the output and its gradients against the reference's dense
    attention and ``jax.vjp``."""
    rng = np.random.default_rng(2)
    q, k, v, dout = (rng.standard_normal(s, dtype=np.float32) for s in
                     ((2, 64, 6, 16), (2, 64, 3, 16), (2, 64, 3, 16),
                      (2, 64, 6, 16)))
    for causal in (True, False):
        want, vjp = jax.vjp(
            lambda a, b, c: jax_dense(a, b, c, causal=causal),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        dwant = vjp(jnp.asarray(dout))
        for shards in (1, 2, 4):
            tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                          for x in (q, k, v))
            out = ring_attention_single_device(tq, tk, tv, shards=shards,
                                               causal=causal)
            np.testing.assert_allclose(out.detach().numpy(),
                                       np.asarray(want), rtol=RING_TOL,
                                       atol=RING_TOL)
            got = torch.autograd.grad(out, (tq, tk, tv),
                                      torch.from_numpy(dout))
            for g, w in zip(got, dwant):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RING_TOL, atol=RING_TOL)
    with pytest.raises(ValueError, match="multiple"):
        ring_attention_single_device(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), shards=3)


@pytest.fixture
def host_mesh():
    """A one-process gloo group and its ("data", "model") (1, 1) mesh,
    destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    yield make_mesh((1, 1), ("data", "model"), device="cpu")
    dist.destroy_process_group()


def _fresh(params):
    """A copy of ``params`` whose leaves require grad."""
    return adamw.tree_map(lambda p: p.detach().clone().requires_grad_(),
                          params)


def _step(cfg, params, batch, microbatches=1):
    opt = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=1)
    params = _fresh(params)
    step = build_train_step(cfg, opt, microbatches)
    params, _, metrics = step(params, adamw.init(opt, params), batch)
    return adamw.tree_leaves(params), metrics


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_step_unchanged_without_data_parallel_rules(host_mesh):
    """No rules: ``attn_impl="ring"`` changes nothing, bit for bit, with and
    without microbatches. Rules on a one-process mesh (no batch dimension
    above 1): the step is the single-process one, bit for bit; with
    ``attn_impl="ring"`` it runs the ring at R = 1, within f32 rounding."""
    cfg = _ring_cfg()
    ring = cfg.replace(attn_impl="ring")
    params = init_params(cfg, get_family(cfg).layout(cfg), seed=0,
                         device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    batch = {n: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
             for n in ("tokens", "labels")}
    for mb in (1, 2):
        p0, m0 = _step(cfg, params, batch, mb)
        p1, m1 = _step(ring, params, batch, mb)
        assert _same(p0, p1) and _same(m0.values(), m1.values())
        want, _, wgrads = build_loss_and_grads(cfg, mb)(_fresh(params),
                                                        batch)
        with activate_rules(ShardingRules(host_mesh)):
            p1, m1 = _step(cfg, params, batch, mb)
            assert _same(p0, p1) and _same(m0.values(), m1.values())
            loss, _, grads = build_loss_and_grads(ring, mb)(_fresh(params),
                                                            batch)
        assert abs(loss.item() - want.item()) <= LOSS_TOL * abs(want.item())
        assert max((a - b).abs().max().item()
                   for a, b in zip(grads, wgrads)) < GRAD_TOL


def test_compressed_psum_over_one_rank_is_ef_step(host_mesh):
    import torch.distributed as dist
    gen = torch.Generator().manual_seed(4)
    grads = {"w": torch.randn(2, 256, generator=gen),
             "b": {"x": torch.randn(384, generator=gen)}}
    state = CompressorState(adamw.tree_map(
        lambda g: 0.01 * torch.randn(g.shape, generator=gen), grads))
    want, wstate = ef_step(grads, state)
    got, gstate = compressed_psum(grads, dist.group.WORLD, state)
    for a, b in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(adamw.tree_leaves(gstate.residual),
                    adamw.tree_leaves(wstate.residual)):
        assert torch.equal(a, b)


def test_remat_recomputes_under_the_forward_rules():
    """A remat layer's recompute, run by a backward on another thread (as
    autograd runs a CUDA backward), sees the rules active at its forward:
    the ring layer is recomputed as the ring."""
    import threading
    from repro_torch.models import transformer
    seen = []

    def layer(x):
        seen.append(current_rules())
        return x.sin()

    body = transformer._remat(_ring_cfg().replace(remat="full"), layer)
    rules = ShardingRules(SimpleNamespace(shape=(1,), mesh_dim_names=(
        "model",)))
    x = torch.ones(3, requires_grad=True)
    with activate_rules(rules):
        y = body(x).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == [rules, rules]
    assert torch.allclose(x.grad, torch.ones(3).cos())
