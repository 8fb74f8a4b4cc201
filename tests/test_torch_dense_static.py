"""The dense transformer's static serve paths in the port, with and without
experts, against the reference on shared weights: reduced internlm2-1.8b,
mistral-nemo-12b, starcoder2-7b (plain GELU FFN), olmoe-1b-7b and
arctic-480b (MoE, Arctic with its dense residual branch) in float32,
weights from the reference's ``init_params`` carried over by
``params_from_reference``.

- ``prefill``, three ``decode`` steps over the grown dense cache and
  ``prefill_ragged``: logits within 1e-4, the K/V caches within 1e-4;
- ``ServeEngine.generate``: tokens equal the reference engine's at every
  step whose top-1 logit margin (the reference's own logits along its own
  tokens) exceeds 1e-4, up to the first that does not;
- the continuous engine's ``prefill_mode="dense"`` admission: tokens
  identical to paged admission on a dense config (MoE output depends on
  the batch, so the identity is not asserted there), its re-laid pages
  equal to the ragged prefill's cache, and the reference's refusals (int8
  pool, prefix cache);
- the static engine grows the family's ``k``/``v`` leaves to ``max_len``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.models.transformer import TransformerFamily  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               EngineRequest, ServeEngine)
from repro_torch.train import train_step as tts  # noqa: E402

ARCHS = ["internlm2-1.8b", "mistral-nemo-12b", "starcoder2-7b",
         "olmoe-1b-7b", "arctic-480b"]
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-4
B, S, MAX_LEN = 2, 24, 32          # 48 prefill tokens: one MoE group


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, tcfg, jparams, tparams, jitted reference prefill and
    decode steps), built once a module."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jax_reduced(arch).replace(dtype="float32")
            tcfg = get_reduced_config(arch).replace(dtype="float32")
            jparams = jax_init(jax_family(jcfg).layout(jcfg),
                               jax.random.PRNGKey(0), jcfg.param_dtype)
            tparams = params_from_reference(
                tcfg, get_family(tcfg).layout(tcfg),
                jax.tree.map(np.asarray, jparams), device="cpu")
            steps = (jax.jit(jts.build_prefill_step(jcfg)),
                     jax.jit(jts.build_decode_step(jcfg)))
            built[arch] = (jcfg, tcfg, jparams, tparams, steps)
        return built[arch]

    return get


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL,
                               err_msg=what)


def _grow(cache, rows):
    """Zero rows appended to every leaf's axis 2 (the reference's pad)."""
    return {k: (jnp.pad(v, [(0, 0), (0, 0), (0, rows), (0, 0), (0, 0)])
                if isinstance(v, jax.Array)
                else torch.nn.functional.pad(v, (0, 0, 0, 0, 0, rows)))
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_ragged_match_reference(models, arch):
    jcfg, tcfg, jparams, tparams, (jprefill, jdecode) = models(arch)
    toks = np.random.RandomState(1).randint(0, tcfg.vocab_size,
                                            size=(B, S)).astype(np.int32)
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tts.build_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlogits, jlogits, "prefill logits")
    layout = get_family(tcfg).cache_layout(tcfg, B, S)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} \
        == layout
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], f"prefill {name}")
    jcache, tcache = _grow(jcache, MAX_LEN - S), _grow(tcache, MAX_LEN - S)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    decode = tts.build_decode_step(tcfg)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        jnext, jlogits, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(tok)[:, None],
                      "pos": jnp.asarray(pos)}, jcache)
        _, tlogits, tcache = decode(
            tparams, {"tokens": torch.from_numpy(tok)[:, None],
                      "pos": torch.from_numpy(pos)}, tcache)
        _close(tlogits, jlogits, f"decode {step} logits")
        tok = np.array(jnext)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], f"decode {name}")

    # right-padded prompts of 16 and 9 tokens, logits at length - 1
    lens = np.array([16, 9], np.int32)
    rtoks = np.where(np.arange(16)[None] < lens[:, None], toks[:, :16], 0)
    jlog, jc = jax.jit(lambda p, b: jax_family(jcfg).prefill_ragged(
        jcfg, p, b))(jparams, {"tokens": jnp.asarray(rtoks, jnp.int32),
                               "length": jnp.asarray(lens)})
    tnext, tlog, tc = tts.build_prefill_ragged_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(rtoks),
                  "length": torch.from_numpy(lens)})
    _close(tlog, jlog, "prefill_ragged logits")
    np.testing.assert_array_equal(tnext.numpy(), tlog.argmax(-1).numpy())
    for name in ("k", "v"):
        _close(tc[name], jc[name], f"prefill_ragged {name}")


def _reference_margins(jcfg, jparams, steps, prompts, max_new):
    """The reference static engine's loop, run by hand: its tokens and the
    top-1 minus top-2 logit at each step along them."""
    jprefill, jdecode = steps
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    logits, cache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = _grow(cache, MAX_LEN - plen)
    out, margins = [], []
    pos = np.full((len(prompts),), plen - 1, np.int32)
    for _ in range(max_new):
        lg = np.asarray(logits, np.float64)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = np.array(jnp.argmax(logits, -1), np.int32)
        out.append(nxt)
        pos = pos + 1
        _, logits, cache = jdecode(jparams, {"tokens": jnp.asarray(nxt)[:, None],
                                             "pos": jnp.asarray(pos)}, cache)
    return np.stack(out, 1), np.stack(margins, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_against_reference(models, arch):
    jcfg, tcfg, jparams, tparams, steps = models(arch)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (S, 17)]
    max_new = MAX_LEN - S
    jeng = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN)
    jeng._prefill, jeng._decode = steps                 # compiled already
    jtok = jeng.generate(prompts, max_new=max_new).tokens
    want, margins = _reference_margins(jcfg, jparams, steps, prompts, max_new)
    np.testing.assert_array_equal(want, jtok)
    ttok = ServeEngine(tcfg, tparams, max_len=MAX_LEN,
                       device="cpu").generate(prompts,
                                              max_new=max_new).tokens
    assert ttok.shape == jtok.shape == (B, max_new)
    compared = 0
    for got, ref, margin in zip(ttok, jtok, margins):
        for i in range(max_new):
            if margin[i] <= MARGIN:
                break
            assert got[i] == ref[i]
            compared += 1
    assert compared >= jtok.size // 2


def test_serve_engine_grows_the_dense_cache(models):
    """``k``/``v`` (L,B,S,KV,hd) grow to ``max_len`` rows along axis 2: the
    prefill rows unchanged, the rest zero."""
    _, tcfg, _, tparams, _ = models("mistral-nemo-12b")
    eng = ServeEngine(tcfg, tparams, max_len=MAX_LEN, device="cpu")
    assert eng.family.grown_cache_leaves == ("k", "v")
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(B, S)))
    _, cache = eng._prefill(tparams, {"tokens": toks})
    before = {k: v.clone() for k, v in cache.items()}
    cache = eng._pad_cache(cache, S)
    for name in ("k", "v"):
        assert cache[name].shape == (tcfg.num_layers, B, MAX_LEN,
                                     tcfg.num_kv_heads, tcfg.head_dim)
        assert torch.equal(cache[name][:, :, :S], before[name])
        assert not cache[name][:, :, S:].any()


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-7b"])
def test_dense_prefill_admission_equals_paged(models, arch):
    """Six prompts over four slots (two admission waves), five pad buckets
    at page size 8: the dense-prefill engine's tokens equal the paged
    engine's exactly."""
    _, tcfg, _, tparams, _ = models(arch)
    tcfg = tcfg.replace(page_size=8)
    prompts = _prompts(tcfg.vocab_size, (13, 6, 21, 8, 30, 17), seed=6)
    out = {}
    for mode in ("paged", "dense"):
        eng = ContinuousBatchingEngine(tcfg, tparams, max_len=48,
                                       max_slots=4, prefill_mode=mode,
                                       device="cpu")
        assert (eng.prefix_cache is None) == (mode == "dense")
        out[mode] = eng.generate(prompts, max_new=10).tokens
    np.testing.assert_array_equal(out["dense"], out["paged"])


def test_dense_admission_lays_the_prompt_cache_into_pages(models):
    """After a dense admission wave each request's pages hold its prompt's
    K/V rows: the ragged prefill's cache, row for row, and the first token
    is its argmax at ``length - 1``."""
    _, tcfg, _, tparams, _ = models("mistral-nemo-12b")
    tcfg = tcfg.replace(page_size=8)
    prompts = _prompts(tcfg.vocab_size, (13, 11), seed=7)
    eng = ContinuousBatchingEngine(tcfg, tparams, max_len=32, max_slots=2,
                                   prefill_mode="dense", device="cpu")
    for rid, p in enumerate(prompts):
        eng.enqueue(EngineRequest(rid, p, 4))
    assert eng.admit() == 2
    toks = np.zeros((2, 16), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    nxt, _, cache = tts.build_prefill_ragged_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks),
                  "length": torch.tensor([13, 11])})
    for slot, live in eng._live.items():
        i = live.req.rid
        assert eng._cur[slot] == int(nxt[i])
        for name in ("k", "v"):
            got = eng.pool[name][:, :, live.pages[:2]]       # (L,KV,2,ps,hd)
            got = got.permute(0, 2, 3, 1, 4).reshape(
                tcfg.num_layers, 16, tcfg.num_kv_heads, tcfg.head_dim)
            assert torch.equal(got, cache[name][:, i])


def test_prefill_mode_refusals_match_reference(models):
    jcfg, tcfg, jparams, tparams, _ = models("internlm2-1.8b")
    cases = [(dict(kv_cache_dtype="int8"), "requires prefill_mode='paged'"),
             (dict(enable_prefix_cache=True),
              "requires prefill_mode='paged'")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JaxEngine(jcfg, jparams, prefill_mode="dense", **kw)
        with pytest.raises(ValueError, match=match):
            ContinuousBatchingEngine(tcfg, tparams, prefill_mode="dense",
                                     device="cpu", **kw)
    with pytest.raises(ValueError, match="prefill_mode"):
        ContinuousBatchingEngine(tcfg, tparams, prefill_mode="ragged",
                                 device="cpu")


def test_moe_dense_admission_serves(models):
    """olmoe's dense admission runs its pad buckets through the MoE block
    (pad tokens take part in routing, so its tokens are not held to paged
    admission's): valid tokens, one pad bucket a distinct page count."""
    _, tcfg, _, tparams, _ = models("olmoe-1b-7b")
    tcfg = tcfg.replace(page_size=8)
    prompts = _prompts(tcfg.vocab_size, (13, 6, 21), seed=8)
    eng = ContinuousBatchingEngine(tcfg, tparams, max_len=40, max_slots=4,
                                   prefill_mode="dense", device="cpu")
    out = eng.generate(prompts, max_new=6).tokens
    assert out.shape == (3, 6)
    assert out.min() >= 0 and out.max() < tcfg.vocab_size


def test_frontend_configs_are_refused(models):
    """The frontend families run on the transformer; an encoder-only
    (audio) config is refused by both engines, as the reference's are, and
    a frame frontend reads ``frames``, not tokens."""
    _, tcfg, _, tparams, _ = models("internlm2-1.8b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for family in ("audio", "vlm"):
        assert isinstance(get_family(tcfg.replace(family=family)),
                          TransformerFamily)
    enc = tcfg.replace(family="audio", encoder_only=True, causal=False)
    for engine in (ServeEngine, ContinuousBatchingEngine):
        with pytest.raises(ValueError, match="encoder-only"):
            engine(enc, tparams, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        TransformerFamily()._embed(enc.replace(frontend="frame"), tparams,
                                   {"tokens": tokens})


def test_launcher_new_archs_and_prefill_mode(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "mistral-nemo-12b", "--device", "cpu", "--batch", "2",
          "--max-new", "3", "--prefill-mode", "dense"])
    main(["--arch", "olmoe-1b-7b", "--engine", "static", "--device", "cpu",
          "--batch", "2", "--max-new", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "engine: continuous (cpu)" and len(lines) == 6
    assert lines[3] == "engine: static (cpu)"
    with pytest.raises(SystemExit, match="requires the continuous engine"):
        main(["--arch", "arctic-480b", "--engine", "static",
              "--prefill-mode", "dense", "--device", "cpu"])
    with pytest.raises(SystemExit, match="gateway"):
        main(["--arch", "olmoe-1b-7b", "--gateway", "--prefill-mode",
              "dense", "--device", "cpu"])
