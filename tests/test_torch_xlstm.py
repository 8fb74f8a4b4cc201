"""The port's xLSTM family against the reference on shared inputs: reduced
xlstm-350m in float32 (d_model 64, 4 heads, 2 pairs), weights from the
reference's ``init_params`` carried over by ``params_from_reference``,
inputs drawn with numpy from a seed; the kernels' plain versions run on the
CPU.

- the layout leaf for leaf and ``count_params`` of the full config;
- ``mlstm_scan`` (from a zero and a given state), ``mlstm_chunked`` (S 128,
  chunk 64), ``slstm_scan``, ``mlstm_block`` and ``slstm_block`` (prefill
  and one decode step): outputs and every state within 1e-5 of the
  largest magnitude (float32, sums in another order);
- a ragged last mLSTM chunk (S 70: chunks of 64 and 6) against the
  reference's ``mlstm_scan``, which takes any S; the reference's
  ``mlstm_chunked`` raises there;
- ``XLSTMFamily.prefill`` (S 13 and 128) and three ``decode`` steps: logits
  and every cache leaf; the port's prefill at S 70 against the reference's
  prefill of 64 followed by 6 of its decode steps;
- ``ServeEngine.generate`` tokens equal to the reference engine's at
  padded prompt lengths 5 to 13; at 3 and 4, where the reference's engine
  grows the state along axis 2 (the conv tail at 3, the head axis at 4:
  a ``TypeError`` in decode), the port's tokens equal the argmax of a full
  prefill over the prompt and the tokens before it (ROADMAP.md, Queue 3);
- ``train_loss`` and every gradient against the reference's
  ``jax.value_and_grad`` (remat "full": each pair under one
  torch.utils.checkpoint as the reference's scan body is under
  jax.checkpoint), B 2, S 128: the loss within 1e-5 relative, each
  gradient leaf within 1e-5 of its max |value| and none of it NaN (the
  masked intra-chunk weights are -inf before exp);
- the serve and training launchers with ``--arch xlstm-350m``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.models.params import tree_map_specs as jax_map_specs  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import count_params, get_family  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.params import tree_map_specs  # noqa: E402
from repro_torch.models.transformer import XLSTMFamily  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import adamw  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

REL = 1e-5                     # of the largest magnitude, float32
B, H, MHD = 2, 4, 32           # batch; heads; mLSTM head dim (2 * 64 / 4)
MAX_LEN = 40
MARGIN = 1e-4                  # top-1 minus top-2 logit worth comparing at
# The reference's functions compile with XLA's backend optimisations off:
# on these widths that takes a fraction of the compile time and leaves the
# float32 results within the tests' tolerances.
FAST_XLA = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced model is a few KB wide: one intra-op thread a test
    process runs it fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn, static_argnums=()):
    """``jax.jit(fn, static_argnums)`` compiled with FAST_XLA, once for each
    set of argument shapes (and static values)."""
    compiled = {}

    def call(*args):
        static = tuple(args[i] for i in static_argnums)
        dynamic = [a for i, a in enumerate(args) if i not in static_argnums]
        leaves, tree = jax.tree.flatten(dynamic)
        key = (static, tree, tuple((np.shape(x), np.result_type(x))
                                   for x in leaves))
        if key not in compiled:
            compiled[key] = jax.jit(fn, static_argnums=static_argnums).lower(
                *args).compile(FAST_XLA)
        return compiled[key](*dynamic)
    return call


@pytest.fixture(scope="module")
def model():
    """Both configs, both parameter trees and the reference's compiled
    prefill and decode steps (each compiled once a shape, shared)."""
    jcfg = jax_reduced("xlstm-350m").replace(dtype="float32")
    tcfg = get_reduced_config("xlstm-350m").replace(dtype="float32")
    layout = jax_family(jcfg).layout(jcfg)
    # one compiled init: eagerly, each leaf's shape compiles on its own
    jparams = _jit(lambda key: jax_init(layout, key, "float32"))(
        jax.random.PRNGKey(0))
    tparams = params_from_reference(tcfg, get_family(tcfg).layout(tcfg),
                                    jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    steps = (_jit(jts.build_prefill_step(jcfg)),
             _jit(jts.build_decode_step(jcfg)))
    return jcfg, tcfg, jparams, tparams, steps


def _close(got, want, what=""):
    """Within REL of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _tree_close(got, want, what=""):
    for name, leaf in got.items():
        if isinstance(leaf, dict):
            _tree_close(leaf, want[name], f"{what}/{name}")
        else:
            _close(leaf, want[name], f"{what}/{name}")


def _gates(rng, s, h=H, hd=MHD):
    """mLSTM inputs (B,S,H,hd) x3 and log gates (B,S,H), f32 numpy."""
    q, k, v = (rng.randn(B, s, h, hd).astype(np.float32) for _ in range(3))
    log_i = rng.randn(B, s, h).astype(np.float32)
    log_f = -np.log1p(np.exp(-(rng.randn(B, s, h) + 2.0))).astype(np.float32)
    return q, k, v, log_i, log_f


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _mlstm_state(rng, h=H, hd=MHD):
    return (rng.randn(B, h, hd, hd).astype(np.float32),
            rng.randn(B, h, hd).astype(np.float32),
            rng.randn(B, h).astype(np.float32))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def test_layout_and_count_match_reference():
    jcfg, tcfg = jax_config("xlstm-350m"), get_config("xlstm-350m")
    jfam, fam = jax_family(jcfg), get_family(tcfg)
    assert isinstance(fam, XLSTMFamily) and fam.n_pairs(tcfg) == 12
    assert fam.grown_cache_leaves == ()
    shapes = jax_map_specs(lambda s: s.shape, jfam.layout(jcfg))
    assert tree_map_specs(lambda s: s.shape, fam.layout(tcfg)) == shapes
    assert count_params(tcfg) == 440_427_616
    jcache = jfam.cache_layout(jcfg, 8, 256)[0]
    cache = fam.cache_layout(tcfg, 8, 256)
    for kind in ("m", "s"):
        assert {k: v[0] for k, v in cache[kind].items()} \
            == {k: v.shape for k, v in jcache[kind].items()}
    # mLSTM inner width 2048, head dim 512; sLSTM head dim 256, FFN 2688
    pm, ps = fam.layout(tcfg)["pairs"]["m"], fam.layout(tcfg)["pairs"]["s"]
    assert pm["wq"].shape == (12, 2048, 4, 512)
    assert ps["r_gates"].shape == (12, 4, 4, 256, 256)
    assert ps["ffn_up"].shape == (12, 1024, 2688)


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["zero", "given"])
def test_mlstm_scan_matches_reference(start):
    rng = np.random.RandomState(1)
    inputs = _gates(rng, 9)
    state = None if start == "zero" else _mlstm_state(rng)
    jh, jstate = _jit(jx.mlstm_scan)(*inputs, state)
    th, tstate = xlstm.mlstm_scan(*_t(inputs),
                                  None if state is None else _t(state))
    _close(th, jh, "h")
    for got, want, name in zip(tstate, jstate, "Cnm"):
        _close(got, want, name)


@pytest.mark.parametrize("start", ["zero", "given"])
def test_mlstm_chunked_matches_reference(start):
    """S 128 in two chunks of 64, as the reference runs it."""
    rng = np.random.RandomState(2)
    inputs = _gates(rng, 128)
    state = None if start == "zero" else _mlstm_state(rng)
    chunked = _jit(jx.mlstm_chunked, static_argnums=(6,))
    jh, jstate = chunked(*inputs, state, 64)
    th, tstate = xlstm.mlstm_chunked(*_t(inputs),
                                     None if state is None else _t(state), 64)
    _close(th, jh, "h")
    for got, want, name in zip(tstate, jstate, "Cnm"):
        _close(got, want, name)


def test_mlstm_ragged_chunk_matches_reference_scan():
    """S 70 at chunk 64: the port scans chunks of 64 and 6; the reference's
    ``mlstm_chunked`` raises and its ``mlstm_scan`` (any S) is the
    oracle."""
    rng = np.random.RandomState(3)
    inputs = _gates(rng, 70)
    state = _mlstm_state(rng)
    with pytest.raises(ValueError, match="seq 70 % chunk 64"):
        jx.mlstm_chunked(*inputs, state, 64)
    jh, jstate = _jit(jx.mlstm_scan)(*inputs, state)
    th, tstate = xlstm.mlstm_chunked(*_t(inputs), _t(state), 64)
    _close(th, jh, "h")
    for got, want, name in zip(tstate, jstate, "Cnm"):
        _close(got, want, name)


@pytest.mark.parametrize("start", ["zero", "given"])
def test_slstm_scan_matches_reference(start):
    rng = np.random.RandomState(4)
    hd = 16
    gates = rng.randn(B, 11, 4, H, hd).astype(np.float32)
    r = (rng.randn(4, H, hd, hd) / 4).astype(np.float32)
    b = rng.randn(4, H, hd).astype(np.float32)
    state = None if start == "zero" else (
        rng.randn(B, H, hd).astype(np.float32),
        np.abs(rng.randn(B, H, hd)).astype(np.float32) + 0.5,
        rng.randn(B, H, hd).astype(np.float32),
        rng.randn(B, H, hd).astype(np.float32))
    jh, jstate = _jit(jx.slstm_scan)(gates, r, b, state)
    th, tstate = xlstm.slstm_scan(*_t((gates, r, b)),
                                  None if state is None else _t(state))
    _close(th, jh, "h")
    for got, want, name in zip(tstate, jstate, ("c", "n", "m", "h")):
        _close(got, want, name)


@pytest.mark.parametrize("kind", ["m", "s"])
def test_block_matches_reference(model, kind):
    """``mlstm_block`` / ``slstm_block`` of pair 0: a prefill of 20 rows,
    then one decode step from its cache; y and every cache leaf."""
    jcfg, tcfg, jparams, tparams, _ = model
    rng = np.random.RandomState(5)
    x = rng.randn(B, 20, tcfg.d_model).astype(np.float32)
    x1 = rng.randn(B, 1, tcfg.d_model).astype(np.float32)
    jblock = {"m": jx.mlstm_block, "s": jx.slstm_block}[kind]
    tblock = {"m": xlstm.mlstm_block, "s": xlstm.slstm_block}[kind]
    jp = {k: v[0] for k, v in jparams["pairs"][kind].items()}
    tp = {k: v[0] for k, v in tparams["pairs"][kind].items()}
    block = _jit(lambda p, x, c: jblock(jcfg, p, x, cache=c))
    jy, jc = block(jp, jnp.asarray(x), None)
    ty, tc = tblock(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy, "prefill y")
    _tree_close(tc, jc, "prefill")
    jy, jc = block(jp, jnp.asarray(x1), jc)
    ty, tc = tblock(tcfg, tp, torch.from_numpy(x1), cache=tc)
    _close(ty, jy, "decode y")
    _tree_close(tc, jc, "decode")


# ---------------------------------------------------------------------------
# the family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [13, 128])
def test_prefill_and_decode_match_reference(model, seq):
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    toks = np.random.RandomState(6).randint(
        0, tcfg.vocab_size, size=(B, seq)).astype(np.int32)
    prefill, decode = tts.build_prefill_step(tcfg), tts.build_decode_step(tcfg)
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = prefill(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, "prefill logits")
    _tree_close(tcache, jcache, "prefill cache")
    layout = get_family(tcfg).cache_layout(tcfg, B, seq)
    assert {kind: {k: (tuple(t.shape), t.dtype) for k, t in c.items()}
            for kind, c in tcache.items()} == layout
    jtok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for step in range(3):
        pos = np.full((B,), seq + step, np.int32)
        jnext, jlogits, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(jtok)[:, None],
                      "pos": jnp.asarray(pos)}, jcache)
        _, tlogits, same = decode(
            tparams, {"tokens": torch.from_numpy(jtok)[:, None],
                      "pos": torch.from_numpy(pos)}, tcache)
        assert same is tcache                 # written in place
        _close(tlogits, jlogits, f"decode {step} logits")
        jtok = np.array(jnext)
    _tree_close(tcache, jcache, "decode cache")


def test_ragged_prefill_matches_prefill_then_decode(model):
    """The port's prefill at S 70 (mLSTM chunks of 64 and 6) against the
    reference's prefill of the first 64 tokens and 6 of its decode steps
    over the rest: the last logits and every state. The reference's own
    prefill at S 70 raises."""
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    toks = np.random.RandomState(7).randint(
        0, tcfg.vocab_size, size=(B, 70)).astype(np.int32)
    with pytest.raises(ValueError, match="seq 70 % chunk 64"):
        jprefill(jparams, {"tokens": jnp.asarray(toks)})
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :64])})
    for t in range(64, 70):
        _, jlogits, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                      "pos": jnp.full((B,), t, jnp.int32)}, jcache)
    tlogits, tcache = get_family(tcfg).prefill(
        tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, "logits")
    _tree_close(tcache, jcache, "cache")


def _left_padded(prompts):
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


@pytest.mark.parametrize("plen", range(5, 14))
def test_serve_engine_matches_reference(model, plen):
    """Two prompts padded to ``plen`` (5 to 13: none is the conv tail's 3
    rows or the 4 heads, where the reference's engine misgrows its state),
    6 new tokens each: the port's tokens equal the reference's."""
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    rng = np.random.RandomState(100 + plen)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (plen, plen - 2)]
    jeng = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN)
    jeng._prefill, jeng._decode = jprefill, jdecode
    want = jeng.generate(prompts, max_new=6).tokens
    got = ServeEngine(tcfg, tparams, max_len=MAX_LEN,
                      device="cpu").generate(prompts, max_new=6).tokens
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plen", [3, 4])
def test_engine_grows_no_state_leaf(model, plen):
    """Prompts padded to 3 (the conv tail's rows) or 4 (the head count):
    the reference's engine grows the conv tail to ``max_len`` rows at 3 and
    the head axis at 4, where decode raises a ``TypeError``; the port grows
    nothing, and each greedy token is the argmax of a full prefill over the
    prompt and the tokens before it, wherever that argmax has a margin."""
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = model
    rng = np.random.RandomState(200 + plen)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (plen, plen - 1)]
    toks = _left_padded(prompts)
    jeng = JaxServeEngine(jcfg, jparams, max_len=16)
    jeng._prefill, jeng._decode = jprefill, jdecode
    if plen == 4:
        with pytest.raises(TypeError, match="incompatible shapes"):
            jeng.generate(prompts, max_new=2)
    else:
        _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
        grown = jeng._pad_cache(jcache, plen)
        assert grown["m"]["conv"].shape[2] == 16      # 3 rows grown to 16
    max_new = 4
    out = ServeEngine(tcfg, tparams, max_len=16, device="cpu").generate(
        prompts, max_new=max_new).tokens
    fam = get_family(tcfg)
    compared = 0
    for t in range(max_new):
        seq = torch.from_numpy(np.concatenate([toks, out[:, :t]], axis=1))
        logits, _ = fam.prefill(tcfg, tparams, {"tokens": seq})
        top2 = torch.topk(logits.double(), 2).values
        for i in range(B):
            if top2[i, 0] - top2[i, 1] > MARGIN:
                assert out[i, t] == int(logits[i].argmax())
                compared += 1
    assert compared >= out.size // 2


def test_static_launcher_and_devices(model, capsys):
    _, tcfg, _, tparams, _ = model
    from repro_torch.launch.serve import main
    main(["--arch", "xlstm-350m", "--device", "cpu", "--batch", "4",
          "--max-new", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "engine: static (cpu)" and len(lines) == 5
    with pytest.raises(SystemExit, match="requires a paged-decode family"):
        main(["--arch", "xlstm-350m", "--engine", "continuous", "--device",
              "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(tcfg, tparams)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_train_loss_and_grads_match_reference(model):
    jcfg, tcfg, jparams, _, _ = model
    assert jcfg.remat == tcfg.remat == "full"
    jfam, tfam = jax_family(jcfg), get_family(tcfg)
    tp = params_from_reference(tcfg, tfam.layout(tcfg),
                               jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=tcfg.pdtype)
    rng = np.random.RandomState(8)
    batch = {k: rng.randint(0, tcfg.vocab_size, (B, 128)).astype(np.int32)
             for k in ("tokens", "labels")}

    def loss_fn(params, b):
        return jfam.train_loss(jcfg, params, b)[0]

    jloss, jgrads = _jit(jax.value_and_grad(loss_fn))(jparams, batch)
    leaves = adamw.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = tfam.train_loss(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == {"loss"} and metrics["loss"] is loss
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)
    it = iter(grads)
    got = _flat(adamw.tree_map(lambda _: next(it), tp))
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for name, g in got.items():
        _close(g, want[name], name)


def test_train_launcher(capsys):
    train_launch.main(["--arch", "xlstm-350m", "--steps", "4",
                       "--checkpoint-every", "2", "--batch", "4",
                       "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("xlstm-350m (reduced):")
    assert out[0].endswith("(cpu)")
    assert out[-1].startswith("steps=4 loss ")
    assert out[-1].endswith("checkpoints [2, 4]")
