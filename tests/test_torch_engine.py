"""The port's continuous-batching engine on the CPU.

Within torch, greedy tokens are identical (exactly) across plain decode,
speculative decode (fixed and adaptive window, bigram and trigram keys) and
the f32 and int8 pool layouts, on the configurations and prompts the
reference's suites use for the same assertions (tests/test_kv_parity.py,
tests/test_serve_engine.py). Against the reference engine, on shared
weights: the prefix-cache counters are equal, and tokens are identical at
every step whose top-1 logit margin in a teacher-forced reference pass
exceeds 1e-4, up to the first step that does not (after it the two streams
may legitimately part)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, EngineRequest  # noqa: E402

MARGIN = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced("yi-6b").replace(dtype="float32", page_size=8)
    tcfg = get_reduced_config("yi-6b").replace(dtype="float32", page_size=8)
    jparams = jax_init(jax_family(jcfg).layout(jcfg), jax.random.PRNGKey(0),
                       jcfg.param_dtype)
    tparams = params_from_reference(tcfg, get_family(tcfg).layout(tcfg),
                                    jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


def _engine(tcfg, tparams, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("max_slots", 4)
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)


# ---------------------------------------------------------------------------
# token identity within torch
# ---------------------------------------------------------------------------

def test_int8_plain_decode_token_identity(model):
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg.vocab_size, [5, 9, 12, 7], seed=60)
    gold = _engine(tcfg, tparams, kv_cache_dtype="f32").generate(
        prompts, max_new=12).tokens
    got = _engine(tcfg, tparams, kv_cache_dtype="int8").generate(
        prompts, max_new=12).tokens
    np.testing.assert_array_equal(gold, got)


@pytest.mark.parametrize("adaptive", [False, True])
def test_int8_spec_decode_token_identity(model, adaptive):
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg.vocab_size, [4, 11, 8, 6], seed=61)
    gold = _engine(tcfg, tparams).generate(prompts, max_new=12).tokens
    eng = _engine(tcfg, tparams, kv_cache_dtype="int8", decode_chunk=2,
                  enable_spec_decode=True, spec_tokens=4,
                  spec_adaptive_k=adaptive)
    np.testing.assert_array_equal(gold, eng.generate(prompts,
                                                     max_new=12).tokens)
    assert eng.stats["spec_steps"] > 0
    assert 0.0 <= eng.mean_accept_ema <= 1.0 and eng.slot_spec_state() == {}
    eng._debug_check_refcounts()


@pytest.mark.parametrize("spec_tokens,ngram", [(1, 2), (4, 2), (4, 3)])
def test_spec_decode_token_identical_with_queued_waves(model, spec_tokens,
                                                       ngram):
    """2 slots for 5 prompts: queued admission, page-boundary crossings."""
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg.vocab_size, [3, 7, 12, 5, 17], seed=24)
    kw = dict(max_slots=2, prefill_chunk=8, decode_chunk=4)
    gold = _engine(tcfg, tparams, **kw).generate(prompts, max_new=12).tokens
    eng = _engine(tcfg, tparams, enable_spec_decode=True,
                  spec_tokens=spec_tokens, spec_ngram=ngram, **kw)
    np.testing.assert_array_equal(gold, eng.generate(prompts,
                                                     max_new=12).tokens)
    assert eng.stats["spec_emitted"] >= eng.stats["spec_steps"] > 0
    assert 0.0 <= eng.mean_accepted_len <= spec_tokens
    eng._debug_check_refcounts()


def test_budget_overshoot_cannot_corrupt_shared_prefix(model):
    """prompt 61 + max_new 3 fills the page-table row exactly; the spent
    slot's overshoot steps must write the sink page, so a later request
    sharing the prompt still decodes the same tokens."""
    _, tcfg, _, tparams = model
    prompt = _prompts(tcfg.vocab_size, [61], seed=5)[0]
    eng = _engine(tcfg, tparams, max_slots=2, decode_chunk=16)
    first = eng.generate([prompt], max_new=3).tokens
    again = eng.generate([prompt], max_new=3).tokens
    np.testing.assert_array_equal(first, again)
    assert eng.stats["cached_tokens"] == 60
    eng._debug_check_refcounts()


def test_stepped_api_and_validation(model):
    _, tcfg, _, tparams = model
    eng = _engine(tcfg, tparams, max_slots=2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.enqueue(EngineRequest("x", [], 4))
    with pytest.raises(ValueError, match="exceed max_len"):
        eng.enqueue(EngineRequest("x", [1] * 60, 8))
    prompts = _prompts(tcfg.vocab_size, [5, 6, 7], seed=8)
    for i, p in enumerate(prompts):
        eng.enqueue(EngineRequest(i, p, 3 + i))
    assert eng.admit() == 2 and eng.queued == 1 and eng.live == 2
    assert sorted(eng.remaining_tokens()) == [3, 4] and eng.open_slots == -1
    assert [r.rid for r in eng.drop_queued()] == [2] and eng.open_slots == 0
    eng.enqueue(EngineRequest(2, prompts[2], 5))
    dropped = eng.abort()
    assert [r.rid for r in dropped] == [0, 1, 2]
    assert not eng.has_work and eng.free_slots == 2
    eng._debug_check_refcounts()


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

def _teacher_forced_margins(jcfg, jparams, prompts, tokens):
    """Top-1 minus top-2 logit of the reference model at each generated
    step, with the reference's own tokens fed back (right-padded batch;
    causality keeps pads out of earlier positions)."""
    fam = jax_family(jcfg)
    seqs = [list(p) + list(t) for p, t in zip(prompts, tokens)]
    width = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    x, pos, _ = fam._embed(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    x, _, _ = fam._stack_forward(jcfg, jparams, x, pos, want_cache=False)
    logits = np.asarray(jax_layers.logits_fn(jcfg, jparams, x), np.float64)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    return [margin[i, len(p) - 1:len(p) - 1 + len(t)]
            for i, (p, t) in enumerate(zip(prompts, tokens))]


def test_against_reference_engine(model):
    """Shared-prefix prompts over two admission waves (2 slots): equal
    prefix-cache counters, and tokens equal wherever the margin allows."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(3)
    shared = rng.randint(0, tcfg.vocab_size, size=20).tolist()
    prompts = [shared + rng.randint(0, tcfg.vocab_size, size=n).tolist()
               for n in (4, 7, 2, 5)]
    kw = dict(max_len=64, max_slots=2, prefill_chunk=8, decode_chunk=4)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
    jtok = jeng.generate(prompts, max_new=10).tokens
    ttok = teng.generate(prompts, max_new=10).tokens
    for key in ("admitted", "prefill_tokens", "cached_tokens", "cow_copies"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["cached_tokens"] > 0
    compared = 0
    margins = _teacher_forced_margins(jcfg, jparams, prompts, jtok)
    for want, got, margin in zip(jtok, ttok, margins):
        for i in range(len(want)):
            if margin[i] <= MARGIN:
                break
            assert got[i] == want[i]
            compared += 1
    assert compared >= jtok.size // 2


def test_engine_needs_a_device_it_can_use(model):
    """Entry points default to CUDA and raise without it; nothing falls
    back to the CPU unless the caller asks."""
    _, tcfg, _, tparams = model
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from repro_torch.launch.serve import main
    from repro_torch.models import init_params
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(tcfg, get_family(tcfg).layout(tcfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--batch", "1", "--max-new", "1"])
