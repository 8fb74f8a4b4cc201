"""The port's residency surface and tiered KV store on the CPU.

The reference's scenarios (tests/test_serve_engine.py preemption,
tests/test_fleet.py and tests/test_faults.py page shipping,
tests/test_kv_store.py tiering), run against torch engines on the reduced
yi-6b in float32 (page_size 8, max_len 48, 2 slots, prefill_chunk 8,
decode_chunk 4): greedy tokens are identical, exactly, across
preempt/resume, export/import and demote/restore, for f32 and int8 pools,
plain and speculative. Against the reference engine on shared weights, the
same prompts exported at the same step carry equal tokens, cursors and
positions, f32 content pages within 1e-5 (the same f32 arithmetic summed in
another order), int8 data pages equal and scale pages within 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import EngineRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               EngineRequest, ExportReason, PageResidency,
                               StorageBudgetExceeded, Tier, TieredKVStore)
from repro_torch.serve.kv_store import _deserialize, _serialize  # noqa: E402

MAX_LEN = 48
SLOTS = 2
NS = ("alice", "public")
SPEC = dict(enable_spec_decode=True, spec_tokens=4)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are a few KB wide: one intra-op thread a test process
    runs them fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


def _engine(model, **kw):
    _, tcfg, _, tparams = model
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("decode_chunk", 4)
    return ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=n).tolist()


def _finish(eng, max_steps=200):
    """Admit + decode until idle; returns {rid: emitted tokens}."""
    out = {}
    for _ in range(max_steps):
        if not eng.has_work:
            return out
        eng.admit()
        for req, toks in eng.decode_step():
            out[req.rid] = list(toks)
        eng._debug_check_refcounts()
    raise RuntimeError("engine did not drain")


def _gold(model, prompts, max_new, **kw):
    return _engine(model, **kw).generate(prompts, max_new=max_new).tokens


# ---------------------------------------------------------------------------
# preemption (tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True])
def test_preempt_resume_token_identity_zero_reprefill(model, spec):
    prompts = [_prompt(n, 40 + n) for n in (5, 9, 13)]
    kw = dict(max_len=64, decode_chunk=2, **(SPEC if spec else {}))
    gold = _gold(model, prompts, 10, max_len=64, decode_chunk=2)
    eng = _engine(model, **kw)
    for rid, p in enumerate(prompts[:2]):
        eng.enqueue(EngineRequest(rid, list(p), 10))
    eng.admit()
    done = {req.rid: toks for req, toks in eng.decode_step()}
    slot0 = next(s for s, l in eng._live.items() if l.req.rid == 0)
    paused = eng.preempt(slot0)
    assert 0 < paused.emitted < 10
    assert eng.free_slots == 1 and eng.paused == 1
    assert (paused.hist is not None) == spec
    eng._debug_check_refcounts()            # pinned pages are counted
    eng.enqueue(EngineRequest(2, list(prompts[2]), 10))
    eng.admit()
    assert eng.live == 2
    pf_mark = eng.stats["prefill_tokens"]
    resumed = False
    for _ in range(200):
        for req, toks in eng.decode_step():
            done[req.rid] = toks
        if not resumed and eng.free_slots > 0:
            eng.resume(paused)
            resumed = True
            assert eng.stats["prefill_tokens"] == pf_mark
            assert eng.stats["resumed"] == 1 and eng.stats["preempted"] == 1
        eng._debug_check_refcounts()
        if len(done) == 3 and not eng.has_work:
            break
    assert resumed and len(done) == 3
    got = np.stack([np.asarray(done[i], np.int32) for i in range(3)])
    np.testing.assert_array_equal(gold, got)
    assert eng.alloc.available() == eng.num_pages - 1


def test_preempted_pages_pinned_under_eviction_pressure(model):
    rng = np.random.RandomState(41)
    donor = rng.randint(0, 256, size=10).tolist()
    gold = _gold(model, [donor], 6, max_len=32, decode_chunk=2)[0]
    # 8 usable pages: the donor pins 2, each flusher takes 3-4, so two
    # flusher rounds recycle every free page.
    eng = _engine(model, max_len=32, num_pages=8, decode_chunk=2)
    eng.enqueue(EngineRequest("donor", list(donor), 6))
    eng.admit()
    eng.decode_step()
    paused = eng.preempt(next(iter(eng._live)))
    pinned = list(paused.pages)
    assert all(eng.alloc.refs[p] == 1 for p in pinned)
    first_flush = None
    for i in range(3):
        flush = rng.randint(0, 256, size=20 + i % 2).tolist()
        first_flush = first_flush or flush
        eng.enqueue(EngineRequest(f"flush{i}", flush, 4))
        eng.admit()
        while eng.live:
            eng.decode_step()
            eng._debug_check_refcounts()
        assert all(eng.alloc.refs[p] >= 1 for p in pinned)
    assert eng.prefix_cache.lookup(first_flush)[1] == 0
    chain = eng.prefix_cache.lookup(donor)[0]
    assert chain and chain == pinned[:len(chain)]
    eng.resume(paused)
    done = _finish(eng)
    np.testing.assert_array_equal(gold, np.asarray(done["donor"]))
    assert eng.alloc.available() == eng.num_pages - 1


def test_preempt_resume_errors_and_abort_releases_pins(model):
    eng = _engine(model, max_len=64, decode_chunk=2)
    with pytest.raises(KeyError, match="no live request"):
        eng.preempt(0)
    prompts = [_prompt(6, 42), _prompt(9, 43)]
    for rid, p in enumerate(prompts):
        eng.enqueue(EngineRequest(rid, p, 8))
    eng.admit()
    eng.decode_step()
    paused = eng.preempt(0)
    eng.resume(paused)
    with pytest.raises(KeyError, match="not paused"):
        eng.resume(paused)
    paused = eng.preempt(next(iter(eng._live)))
    eng.enqueue(EngineRequest(2, prompts[0], 8))
    eng.enqueue(EngineRequest(3, prompts[1], 8))
    eng.admit()
    assert eng.free_slots == 0
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.resume(paused)
    pinned = list(paused.pages)
    assert all(eng.alloc.refs[p] >= 1 for p in pinned)
    dropped = eng.abort()                   # the paused request included
    assert sorted(r.rid for r in dropped) == [0, 1, 2, 3]
    assert not eng.has_work and eng.paused == 0
    assert all(eng.alloc.refs[p] == 0 for p in pinned)
    assert eng.alloc.available() == eng.num_pages - 1
    eng._debug_check_refcounts()


def test_refcount_check_counts_paused_holders(model):
    """A paused request's pinned pages are references: the check passes
    with one parked, and catches a pin dropped behind its back."""
    eng = _engine(model)
    eng.enqueue(EngineRequest("p", _prompt(12, 44), 8))
    eng.admit()
    eng.decode_step()
    paused = eng.preempt(next(iter(eng._live)))
    assert not eng._live and eng.paused == 1
    eng._debug_check_refcounts()
    eng.alloc.release(paused.pages[0])
    with pytest.raises(AssertionError, match="refcount drift"):
        eng._debug_check_refcounts()


# ---------------------------------------------------------------------------
# page shipping (tests/test_fleet.py, tests/test_faults.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_ship_token_identity(model, kv_dtype):
    _, tcfg, _, _ = model
    prompts = [_prompt(13, 21), _prompt(8, 22)]
    gold = _gold(model, prompts, 12, kv_cache_dtype=kv_dtype)
    pre = _engine(model, role="prefill", kv_cache_dtype=kv_dtype,
                  prefill_chunk=16)
    dec = _engine(model, role="decode", kv_cache_dtype=kv_dtype)
    for i, p in enumerate(prompts):
        pre.enqueue(EngineRequest(i, p, 12))
    assert pre.admit() == 2
    payloads = [pre.export_pages(s) for s in sorted(pre._live)]
    assert pre.live == 0 and pre.stats["page_exports"] == 2
    assert pre.alloc.available() == pre.num_pages - 1
    pre._debug_check_refcounts()
    for pl, p in zip(payloads, prompts):
        assert pl.emitted == 0 and pl.pos == len(p)
        assert pl.n_content == -(-len(p) // tcfg.page_size)
        assert pl.nbytes == sum(a.numel() * a.element_size()
                                for a in pl.content.values()) > 0
        assert all(a.device.type == "cpu" for a in pl.content.values())
        want = {"k", "v", "k_scale", "v_scale"} if kv_dtype == "int8" \
            else {"k", "v"}
        assert set(pl.content) == want
        dec.import_pages(pl)
    assert dec.live == 2 and dec.stats["page_imports"] == 2
    assert dec.stats["prefill_tokens"] == 0
    dec._debug_check_refcounts()
    done = _finish(dec)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(gold[i], np.asarray(done[i], np.int32))


def test_ship_into_spec_decode_engine(model):
    """A payload from a non-speculative prefill engine lands in a
    speculative one: the rebuilt drafting history gives the tokens of a
    unified speculative run."""
    prompt = ([5, 6, 7, 8] * 5)[:18]
    gold = _gold(model, [prompt], 14, **SPEC)[0]
    pre = _engine(model, role="prefill")
    dec = _engine(model, role="decode", **SPEC)
    pre.enqueue(EngineRequest(0, prompt, 14))
    pre.admit()
    dec.import_pages(pre.export_pages(next(iter(pre._live))))
    done = _finish(dec)
    np.testing.assert_array_equal(gold, np.asarray(done[0], np.int32))
    assert dec.stats["spec_steps"] > 0


def test_import_reregisters_prefix_in_destination_cache(model):
    prompt = _prompt(16, 30)                    # 2 full pages
    pre = _engine(model, role="prefill")
    dec = _engine(model, role="decode")
    pre.enqueue(EngineRequest(0, prompt, 8))
    pre.admit()
    dec.import_pages(pre.export_pages(next(iter(pre._live))))
    chain, match = dec.prefix_cache.lookup(prompt)
    assert match == 16 and len(chain) == 2
    assert pre.prefix_cache.lookup(prompt)[1] == 16
    dec.enqueue(EngineRequest(1, prompt, 8))
    dec.admit()
    assert dec.stats["cached_tokens"] == 15     # plen-1 cap: last tok redone
    dec._debug_check_refcounts()


def _one_payload(model, seed, **kw):
    src = _engine(model, **kw)
    src.enqueue(EngineRequest(seed, _prompt(9, seed), 4))
    src.admit()
    return src.export_pages(next(iter(src._live)))


def test_import_validates_layout_and_capacity(model):
    payload = _one_payload(model, 31, role="prefill")
    with pytest.raises(ValueError, match="int8"):
        _engine(model, kv_cache_dtype="int8").import_pages(payload)
    with pytest.raises(ValueError, match="pages"):
        _engine(model, max_slots=1, num_pages=1).import_pages(payload)
    dec = _engine(model, num_pages=3)
    dec.enqueue(EngineRequest(7, _prompt(9, 32), 4))
    dec.admit()                                 # 2 of 3 pages now occupied
    with pytest.raises(RuntimeError, match="insufficient free pages"):
        dec.import_pages(payload)
    ok = _engine(model)
    ok.import_pages(payload)
    assert ok.live == 1


@pytest.mark.parametrize("tamper,match", [
    (lambda pl: pl.content.update(k=pl.content["k"][:, :1]), "leaf 'k'"),
    (lambda pl: pl.content.update(v=pl.content["v"].double()), "leaf 'v'"),
    (lambda pl: pl.content.update(k=pl.content["k"][..., :8]), "leaf 'k'"),
])
def test_import_refuses_leaves_of_another_shape_or_dtype(model, tamper,
                                                         match):
    """Leaves are checked against this pool's shape and dtype before any
    page is taken; nothing is converted."""
    payload = _one_payload(model, 33)
    tamper(payload)
    dst = _engine(model)
    with pytest.raises(ValueError, match=match):
        dst.import_pages(payload)
    assert not payload.consumed and dst.live == 0
    assert dst.alloc.available() == dst.num_pages - 1


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("spec", [False, True])
def test_mid_decode_export_import_token_identity(model, kv_dtype, spec):
    kw = dict(kv_cache_dtype=kv_dtype, **(SPEC if spec else {}))
    if spec:
        prompts = [([5, 6, 7, 8] * 5)[:18], ([3, 4] * 8)[:10]]
    else:
        prompts = [_prompt(13, 40), _prompt(9, 41)]
    gold = _gold(model, prompts, 14, **kw)
    src = _engine(model, **kw)
    for i, p in enumerate(prompts):
        src.enqueue(EngineRequest(i, p, 14))
    assert src.admit() == 2
    for _ in range(20):
        src.decode_step()
        if all(0 < l.emitted < 14 for l in src._live.values()):
            break
    else:
        pytest.fail("never mid-decode on both slots")
    payloads = {src._live[s].req.rid: src.export(slot=s,
                                                 reason=ExportReason.EVACUATE)
                for s in sorted(src._live)}
    assert src.live == 0
    src._debug_check_refcounts()
    dst = _engine(model, **kw)
    for i in range(len(prompts)):
        pl = payloads[i]
        assert 0 < pl.emitted < 14 and pl.reason is ExportReason.EVACUATE
        assert pl.pos == len(prompts[i]) + pl.emitted
        if spec:
            assert pl.kslot >= 1 and pl.hist is not None
        dst.import_pages(pl)
        assert pl.consumed
    dst._debug_check_refcounts()
    done = _finish(dst)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(gold[i], np.asarray(done[i], np.int32))
    if spec:
        assert dst.stats["spec_steps"] > 0


def test_export_paused_ships_parked_request(model):
    prompt = _prompt(11, 50)
    gold = _gold(model, [prompt], 12)[0]
    src = _engine(model)
    src.enqueue(EngineRequest(7, prompt, 12))
    src.admit()
    src.decode_step()
    slot = next(iter(src._live))
    emitted = src._live[slot].emitted
    assert 0 < emitted < 12
    src.preempt(slot)
    with pytest.raises(KeyError, match="not paused"):
        src.export_paused(999)
    payload = src.export_paused(7)
    assert payload.emitted == emitted
    assert payload.reason is ExportReason.EVACUATE
    assert src.live == 0 and not src._paused
    src._debug_check_refcounts()
    dst = _engine(model)
    dst.import_pages(payload)
    np.testing.assert_array_equal(gold, np.asarray(_finish(dst)[7],
                                                   np.int32))


def test_import_rejection_paths(model):
    pl = _one_payload(model, 60)
    _engine(model).import_pages(pl)
    with pytest.raises(ValueError, match="one-shot"):
        _engine(model).import_pages(pl)
    pl = _one_payload(model, 61)
    pl.page_size = 16
    with pytest.raises(ValueError, match="page_size"):
        _engine(model).import_pages(pl)
    pl = _one_payload(model, 62)
    pl.content = {k: v for k, v in pl.content.items() if k != "v"}
    with pytest.raises(ValueError, match="leaves"):
        _engine(model).import_pages(pl)
    pl = _one_payload(model, 63)
    pl.pos += 1
    with pytest.raises(ValueError, match="inconsistent"):
        _engine(model).import_pages(pl)
    pl = _one_payload(model, 64)
    full = _engine(model)
    for i in range(SLOTS):
        full.enqueue(EngineRequest(100 + i, _prompt(9, 80 + i), 4))
    full.admit()
    with pytest.raises(RuntimeError, match="no free slot"):
        full.import_pages(pl)
    assert not pl.consumed
    ok = _engine(model)
    ok.import_pages(pl)
    assert ok.live == 1 and pl.consumed


# ---------------------------------------------------------------------------
# the tiered store (tests/test_kv_store.py)
# ---------------------------------------------------------------------------

def test_engine_satisfies_page_residency_protocol(model):
    assert isinstance(_engine(model), PageResidency)
    assert [r.value for r in ExportReason] == ["handoff", "evacuate",
                                               "demote"]


def test_export_requires_exactly_one_handle(model):
    eng = _engine(model)
    eng.enqueue(EngineRequest("a", _prompt(12), 8, namespace=NS))
    eng.admit()
    with pytest.raises(ValueError, match="exactly one"):
        eng.export()
    with pytest.raises(ValueError, match="exactly one"):
        eng.export(slot=0, rid="a")
    payload = eng.export(slot=next(iter(eng._live)),
                         reason=ExportReason.DEMOTE)
    assert payload.reason is ExportReason.DEMOTE


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_page_nbytes_is_the_sizing_truth(model, dtype):
    """``nbytes`` equals the content tensors' bytes and ``page_nbytes() *
    n_content``, scale pages included; the pool's dtype sets the size."""
    _, tcfg, _, _ = model
    eng = _engine(model, kv_cache_dtype=dtype)
    eng.enqueue(EngineRequest("a", _prompt(20), 4, namespace=NS))
    eng.admit()
    payload = eng.export(slot=next(iter(eng._live)))
    manual = sum(a.numel() * a.element_size()
                 for a in payload.content.values())
    assert payload.nbytes == manual == eng.page_nbytes() * payload.n_content
    row = tcfg.num_layers * tcfg.num_kv_heads * tcfg.page_size
    if dtype == "int8":
        assert eng.page_nbytes() == 2 * row * (tcfg.head_dim + 4)
        assert eng.page_nbytes() < _engine(model).page_nbytes()
    else:
        assert eng.page_nbytes() == 2 * row * tcfg.head_dim * 4
        bf16 = ContinuousBatchingEngine(tcfg.replace(dtype="bfloat16"),
                                        model[3], max_len=MAX_LEN,
                                        max_slots=SLOTS, device="cpu")
        assert 2 * bf16.page_nbytes() == eng.page_nbytes()


@pytest.mark.parametrize("engine_kw", [
    {}, SPEC, {"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "int8", **SPEC},
], ids=["f32", "f32-spec", "int8", "int8-spec"])
def test_demote_restore_token_identity(model, engine_kw):
    """Paused mid-decode, exported with reason DEMOTE, parked with zero HOST
    capacity (straight to OBJECT: serialized to bytes and back), restored
    and re-imported: the tokens of an undisturbed run."""
    prompt = _prompt(14, 7)
    oracle = _engine(model, **engine_kw).generate([prompt], 12).tokens[0]
    eng = _engine(model, **engine_kw)
    eng.enqueue(EngineRequest("s", prompt, 12, namespace=NS))
    eng.admit()
    eng.decode_step()
    eng.preempt(next(iter(eng._live)))
    payload = eng.export_paused("s", reason=ExportReason.DEMOTE)
    assert not eng.has_work
    store = TieredKVStore(host_capacity_bytes=0)
    assert store.demote(payload, "alice", now=0.0) is Tier.OBJECT
    stream = tuple(prompt) + tuple(payload.tokens)
    key, matched, tier = store.match(NS, stream)
    assert tier is Tier.OBJECT and matched == len(stream)
    ticket = store.request_restore(key, "s", now=1.0)
    assert ticket.ready_at > 1.0
    restored = store.complete_restore(ticket, ticket.ready_at)
    assert restored is not None and store.stats["restores_object"] == 1
    eng.import_pages(restored)
    np.testing.assert_array_equal(oracle, np.asarray(_finish(eng)["s"]))


@pytest.mark.parametrize("engine_kw", [{}, {"kv_cache_dtype": "int8",
                                            **SPEC}], ids=["f32", "int8-spec"])
def test_demote_on_retire_then_restore_pages(model, engine_kw):
    """Every finished stream is demoted at retirement; with HOST room for
    one, the other spills to OBJECT. Each is restored free-but-hittable,
    and a prompt extending the stream prefills only its suffix: the tokens
    of a fresh engine on the same prompt."""
    eng = _engine(model, **engine_kw)
    eng.demote_on_retire = True
    prompts = [_prompt(14, 70), _prompt(11, 71)]
    for i, p in enumerate(prompts):
        eng.enqueue(EngineRequest(i, p, 6, namespace=NS))
    done = _finish(eng)
    assert eng.stats["page_demotes"] == 2 and len(eng.demoted_out) == 2
    store = TieredKVStore(host_capacity_bytes=eng.demoted_out[0].nbytes)
    tiers = {}
    for t, pl in enumerate(eng.demoted_out):
        assert pl.reason is ExportReason.DEMOTE
        assert pl.emitted == 6 and pl.pos == len(pl.req.prompt) + 6
        tiers[pl.req.rid] = store.demote(pl, "alice", now=float(t))
    assert store.stats["spills"] == 1
    assert {store.tier_of(k) for k in store._entries} == {Tier.HOST,
                                                          Tier.OBJECT}
    for rid, p in enumerate(prompts):
        stream = p + done[rid]
        key, n, tier = store.match(NS, stream + [1, 2, 3])
        assert n == len(stream)
        payload = store.complete_restore(store.request_restore(key, rid,
                                                               now=5.0))
        pages = eng.restore_pages(payload)
        assert len(pages) == -(-len(stream) // 8)
        assert all(eng.alloc.refs[q] == 0 for q in pages)
        ext = stream + _prompt(3, 72 + rid)
        before = dict(eng.stats)
        eng.enqueue(EngineRequest(f"ext{rid}", ext, 5, namespace=NS))
        got = _finish(eng)[f"ext{rid}"]
        cached = eng.stats["cached_tokens"] - before["cached_tokens"]
        assert cached >= (len(stream) // 8) * 8
        assert eng.stats["prefill_tokens"] - before["prefill_tokens"] \
            == len(ext) - cached
        fresh = _engine(model, **engine_kw).generate([ext], 5).tokens[0]
        np.testing.assert_array_equal(fresh, np.asarray(got))
    assert eng.stats["page_restores"] == 2


def test_tenant_storage_budget_typed_refusal(model):
    eng = _engine(model)
    payloads = []
    for i, seed in enumerate((1, 2, 3)):
        eng.enqueue(EngineRequest(i, _prompt(16, seed), 4, namespace=NS))
        eng.admit()
        payloads.append(eng.export(slot=next(iter(eng._live)),
                                   reason=ExportReason.DEMOTE))
    budget = payloads[0].nbytes + payloads[1].nbytes
    store = TieredKVStore(host_capacity_bytes=1 << 30,
                          tenant_budget_bytes=budget)
    store.demote(payloads[0], "alice", now=0.0)
    store.demote(payloads[1], "alice", now=0.0)
    with pytest.raises(StorageBudgetExceeded) as ei:
        store.demote(payloads[2], "alice", now=0.0)
    assert ei.value.reason == "storage_budget_exceeded"
    assert store.stats["budget_refusals"] == 1
    assert store.demote(payloads[2], "bob", now=0.0) is Tier.HOST


def test_restore_racing_eviction_returns_none(model):
    eng = _engine(model)
    payloads = []
    for i, seed in enumerate((4, 5)):
        eng.enqueue(EngineRequest(i, _prompt(16, seed), 4, namespace=NS))
        eng.admit()
        payloads.append(eng.export(slot=next(iter(eng._live)),
                                   reason=ExportReason.DEMOTE))
    store = TieredKVStore(host_capacity_bytes=0,
                          object_capacity_bytes=payloads[0].nbytes)
    store.demote(payloads[0], "alice", now=0.0)
    key, _, _ = store.match(NS, tuple(payloads[0].req.prompt)
                            + tuple(payloads[0].tokens))
    ticket = store.request_restore(key, 0, now=1.0)
    store.demote(payloads[1], "alice", now=2.0)
    assert store.tier_of(key) is None
    assert store.complete_restore(ticket, ticket.ready_at) is None
    assert store.stats["restore_misses"] == 1


def test_eviction_events_cover_only_free_pages(model):
    eng = _engine(model, num_pages=12)
    events = []

    def on_evict(ev):
        for p in ev.pages:
            assert eng.alloc.refs[p] == 0
        events.append(ev)

    eng.prefix_cache.on_evict = on_evict
    for seed in range(6):
        eng.enqueue(EngineRequest(seed, _prompt(16, seed + 20), 4,
                                  namespace=NS))
        _finish(eng)
    assert events
    epochs = [e.epoch for e in events]
    assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)
    assert all(e.namespace == NS for e in events)
    assert all(0 < p < 12 for e in events for p in e.pages)


def test_gb_hours_accrue_per_tier_and_tenant(model):
    eng = _engine(model)
    eng.enqueue(EngineRequest("a", _prompt(16, 50), 4, namespace=NS))
    eng.admit()
    payload = eng.export(slot=next(iter(eng._live)),
                         reason=ExportReason.DEMOTE)
    store = TieredKVStore(host_capacity_bytes=1 << 30)
    store.demote(payload, "alice", now=0.0)
    store.accrue(now=0.0)
    usd = store.accrue(now=3600.0)
    gb = payload.nbytes / 1e9
    assert store.gb_hours[Tier.HOST] == pytest.approx(gb)
    assert usd == pytest.approx(gb * store.rate_per_gb_hour[Tier.HOST])
    assert store.cost_by_tenant["alice"] == pytest.approx(usd)
    assert store.gb_hours_by_tenant["alice"][Tier.HOST] == \
        pytest.approx(gb)


def test_object_tier_round_trip_is_bit_exact():
    """bf16 data, int8 data and f32 scales leave as bytes and come back
    with the same dtype, shape and bits (NaN and -0.0 included)."""
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(2, 4, 3, 8, 16, generator=g).bfloat16()
    bf[0, 0, 0, 0, :2] = torch.tensor([float("nan"), -0.0])
    content = {"k": bf, "v": bf.flip(-1),
               "q8": torch.randint(-128, 128, (2, 4, 3, 8, 16),
                                   dtype=torch.int8, generator=g),
               "k_scale": torch.rand(2, 4, 3, 8, generator=g)}
    back = _deserialize(_serialize(content))
    for name, t in content.items():
        assert back[name].dtype == t.dtype and back[name].shape == t.shape
        assert torch.equal(back[name].view(torch.uint8),
                           t.contiguous().view(torch.uint8))


# ---------------------------------------------------------------------------
# against the reference engine, on shared weights
# ---------------------------------------------------------------------------

def test_exports_match_the_reference_engine(model):
    """One reference engine a pool layout: the same two prompts, exported
    after the same admission and decode chunk, carry the same tokens,
    cursor, position and emitted count; f32 content within 1e-5, int8 data
    pages equal and scales within 1e-6."""
    jcfg, _, jparams, _ = model
    prompts = [_prompt(13, 90), _prompt(20, 91)]
    kw = dict(max_len=MAX_LEN, max_slots=SLOTS, prefill_chunk=8,
              decode_chunk=4)
    for kv in ("f32", "int8"):
        jeng = JaxEngine(jcfg, jparams, kv_cache_dtype=kv, **kw)
        teng = _engine(model, kv_cache_dtype=kv)
        for eng, req in ((jeng, JaxRequest), (teng, EngineRequest)):
            for i, p in enumerate(prompts):
                eng.enqueue(req(i, p, 12))
            eng.admit()
            eng.decode_step()
        for slot in sorted(teng._live):
            jp = jeng.export(slot=slot)
            tp = teng.export(slot=slot)
            for f in ("emitted", "cur", "pos"):
                assert getattr(tp, f) == getattr(jp, f), (kv, f)
            assert tp.tokens == jp.tokens and tp.req.rid == jp.req.rid
            assert set(tp.content) == set(jp.content)
            for name, want in jp.content.items():
                got = tp.content[name].numpy()
                assert got.shape == want.shape, name
                if got.dtype == np.int8:
                    np.testing.assert_array_equal(got, want, err_msg=name)
                else:
                    tol = 1e-6 if name.endswith("scale") else 1e-5
                    np.testing.assert_allclose(got, want, atol=tol,
                                               rtol=tol, err_msg=name)
