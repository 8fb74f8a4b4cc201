"""The port's copies of the control-plane modules against the reference's.

Each scenario of tests/test_telemetry.py (the registry: families, labels,
collectors, exposition, ``RegistryDict``; ``ServiceModel`` calibration),
tests/test_fleet.py (fingerprints, ``FleetRouter``, ``FingerprintTracker``)
and tests/test_gateway.py (preemption planning) runs on both packages' modules
with the same inputs: its assertions hold in each, and what it returns (the
Prometheus text, routing decisions, stats, the chosen victim) is equal,
the exposition byte for byte. ``bind_registry`` on a torch engine and on the
reference engine gives the same counter series after the same workload.
"""
import dataclasses
from collections import deque
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve.admission as j_adm  # noqa: E402
import repro.serve.paging as j_pg  # noqa: E402
import repro.serve.routing as j_rt  # noqa: E402
import repro.serve.telemetry as j_tel  # noqa: E402
import repro_torch.serve.admission as t_adm  # noqa: E402
import repro_torch.serve.paging as t_pg  # noqa: E402
import repro_torch.serve.routing as t_rt  # noqa: E402
import repro_torch.serve.telemetry as t_tel  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import EngineRequest as JaxRequest  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, EngineRequest  # noqa: E402

IMPLS = {"port": SimpleNamespace(tel=t_tel, rt=t_rt, adm=t_adm, pg=t_pg),
         "reference": SimpleNamespace(tel=j_tel, rt=j_rt, adm=j_adm,
                                      pg=j_pg)}



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are a few KB wide: one intra-op thread a test process
    runs them fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class _Clock:
    def __init__(self, t):
        self.t = t

    def now(self):
        return self.t


# ---------------------------------------------------------------------------
# telemetry (tests/test_telemetry.py)
# ---------------------------------------------------------------------------

def _basics(m):
    reg = m.tel.MetricsRegistry()
    c = reg.counter("jobs_total", "jobs", ("tenant",))
    c.inc(tenant="alice")
    c.inc(2, tenant="alice")
    c.inc(tenant="bob")
    assert reg.value("jobs_total", tenant="alice") == 3
    assert reg.value("jobs_total", tenant="nobody") == 0.0
    g = reg.gauge("depth")
    g.set(7)
    g.set(3)
    assert reg.value("depth") == 3
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = reg.snapshot()["families"]["lat_seconds"]["samples"][0]
    assert snap["buckets"] == {"0.1": 1.0, "1": 2.0, "+Inf": 3.0}
    assert snap["count"] == 3
    return reg.expose()


def _validation(m):
    reg = m.tel.MetricsRegistry()
    a = reg.counter("x_total", "x", ("t",))
    assert reg.counter("x_total", "x", ("t",)) is a
    errors = []
    for bad in (lambda: reg.gauge("x_total"),
                lambda: reg.counter("x_total", "x", ("other",)),
                lambda: reg.counter("n_total").inc(-1),
                lambda: reg.histogram("h_seconds", buckets=(1.0,)).value(),
                lambda: a.inc(region="us"),
                lambda: a.inc()):
        with pytest.raises((ValueError, TypeError)) as ei:
            bad()
        errors.append((type(ei.value).__name__, str(ei.value)))
    return errors, reg.expose()


def _collector(m):
    reg = m.tel.MetricsRegistry()
    g = reg.gauge("occ", "", ("replica",))
    live = {"r0": 0.5, "r1": 1.0}

    def collect():
        g.clear()
        for r, v in live.items():
            g.set(v, replica=r)

    reg.register_collector(collect)
    assert reg.value("occ", replica="r1") == 0
    texts = [reg.expose()]
    del live["r1"]
    snap = reg.snapshot()
    assert [s["labels"] for s in snap["families"]["occ"]["samples"]] == [
        {"replica": "r0"}]
    return texts + [reg.expose()]


def _populated(m):
    reg = m.tel.MetricsRegistry(clock=_Clock(12.5))
    c = reg.counter("kotta_requests_total", "Requests", ("tenant", "class"))
    c.inc(3, tenant="alice", **{"class": "interactive"})
    c.inc(1, tenant='quo"te\\back\nline', **{"class": "batch"})
    reg.gauge("kotta_burn", "Burn").set(1.75)
    h = reg.histogram("kotta_ttft_seconds", "TTFT", buckets=(0.5, 2.0),
                      labelnames=("tenant",))
    for v in (0.1, 1.0, 9.0):
        h.observe(v, tenant="alice")
    text = reg.expose()
    assert 'kotta_ttft_seconds_bucket{tenant="alice",le="+Inf"} 3' in text
    assert r'tenant="quo\"te\\back\nline"' in text
    assert m.tel.parse_exposition(text)["families"] == \
        reg.snapshot()["families"]
    return text, reg.snapshot()


def _awkward_floats(m):
    reg = m.tel.MetricsRegistry()
    g = reg.gauge("g", "", ("k",))
    for i, v in enumerate((0.1, 1e-12, 1e300, 123456789.000001,
                           float("inf"))):
        g.set(v, k=str(i))
    text = reg.expose()
    assert m.tel.parse_exposition(text)["families"] == \
        reg.snapshot()["families"]
    return text


def _registry_dict(m):
    reg = m.tel.MetricsRegistry()
    c = reg.counter("evt_total", "", ("engine",))
    rd = m.tel.RegistryDict()
    rd.bind("evt", c, initial=5, engine="e0")
    rd["evt"] += 3
    assert reg.value("evt_total", engine="e0") == 8
    rd["evt"] = 0                   # a stat reset: the counter keeps 8
    assert rd["evt"] == 0 and reg.value("evt_total", engine="e0") == 8
    rd["evt"] += 2
    assert reg.value("evt_total", engine="e0") == 10
    g = reg.gauge("level")
    rd.bind("level", g, initial=4)
    rd.bind("scratch", None, initial=0)
    rd["level"] = 2
    rd["scratch"] = 99
    assert dict(rd) == {"evt": 2, "level": 2, "scratch": 99} and len(rd) == 3
    return dict(rd), reg.expose()


def _service_model(m):
    svc = m.adm.ServiceModel(prefill_tok_per_s=2048.0, decode_step_s=0.05)
    assumed = svc.assumed_req_per_s(20, 8, 4)
    assert assumed == pytest.approx(4 / (20 / 2048.0 + 8 * 0.05))
    cal = svc.calibrated(assumed / 2, prompt_len=20, max_new=8, slots=4)
    assert cal.overhead == pytest.approx(2.0)
    assert cal.decode_step_s == svc.decode_step_s
    fast = svc.calibrated(assumed * 10, prompt_len=20, max_new=8, slots=4)
    assert fast.overhead == 1.0
    with pytest.raises(ValueError):
        svc.calibrated(0.0, prompt_len=20, max_new=8, slots=4)
    return (assumed, cal.overhead, cal.service_s(20, 8), svc.service_s(20, 8),
            dataclasses.astuple(cal))


# ---------------------------------------------------------------------------
# admission: preemption planning (tests/test_gateway.py)
# ---------------------------------------------------------------------------

def _plan_preemption(m):
    policy = m.adm.DeadlineCostPolicy(model=m.adm.ServiceModel(
        prefill_tok_per_s=1e9, decode_step_s=1.0))
    now = 100.0
    job = m.adm.ServeJob(rid=9, tenant="a", prompt=[1] * 4, max_new=2,
                         submitted_at=now, deadline=now + 3.0, priority=0)

    def cand(rid, deadline, remaining, priority=1):
        return m.adm.PreemptCandidate(
            m.adm.ServeJob(rid=rid, tenant="a", prompt=[1], max_new=8,
                           submitted_at=0.0, deadline=deadline,
                           priority=priority),
            remaining_tokens=remaining, replica_id=0, slot=rid)

    cands = [cand(1, now + 4.0, 5), cand(2, now + 100.0, 5),
             cand(3, now + 200.0, 5), cand(4, None, 5, priority=0)]
    hopeless = m.adm.ServeJob(rid=10, tenant="a", prompt=[1] * 4, max_new=2,
                              submitted_at=now, deadline=now + 1.0,
                              priority=0)
    off = m.adm.DeadlineCostPolicy(model=policy.model, preempt=False)
    picks = [policy.plan_preemption(job, cands, now),
             policy.plan_preemption(job, [cands[0], cands[3]], now),
             policy.plan_preemption(hopeless, [cands[2]], now),
             off.plan_preemption(job, [cands[2]], now)]
    assert picks[0] is cands[2] and picks[1:] == [None, None, None]
    return [None if p is None else p.job.rid for p in picks]


# ---------------------------------------------------------------------------
# routing (tests/test_fleet.py)
# ---------------------------------------------------------------------------

def _fingerprints(m):
    pc = m.pg.PrefixCache(4)
    prompt = list(range(10))
    pc.register(prompt, [3, 4, 5], namespace="a")
    fp = pc.fingerprint()
    hashes = m.pg.chain_hashes(prompt, 4, namespace="a")
    assert len(hashes) == 2 and set(hashes) <= fp and len(fp) == 2
    pc2 = m.pg.PrefixCache(4)
    pc2.register(list(range(8)), [3, 4], namespace="tenant-a")
    pc2.register(list(range(8)), [5, 6], namespace="tenant-b")
    before = pc2.fingerprint()
    pc2.evict(3)
    assert pc2.fingerprint(namespace="tenant-a") == frozenset()
    return fp, hashes, before, pc2.fingerprint()


def _view(m, rid, prompt, ns=None, ps=4, load=0, open_slots=2):
    fp = frozenset(m.pg.chain_hashes(prompt, ps, ns)) if prompt \
        else frozenset()
    return m.rt.ReplicaView(rid, open_slots, load, ps, fp)


def _route(router, *args):
    d = router.route(*args)
    return None if d is None else dataclasses.astuple(d)


def _router_affinity(m):
    warm = list(range(12))
    router = m.rt.FleetRouter("affinity")
    views = [_view(m, 0, None, load=0), _view(m, 1, warm, load=1)]
    out = [_route(router, warm + [99], None, views),
           _route(router, [777] * 8, None, views),
           _route(router, warm + [99], "other-tenant", views),
           _route(router, warm, None, [_view(m, 0, warm, open_slots=0)])]
    assert out[0][:1] == (1,) and out[1][0] == 0 and out[3] is None
    best = [router.best_match_tokens(warm + [5], None, views),
            router.best_match_tokens([9] * 8, None, views),
            router.best_match_tokens(warm, None, [])]
    assert best == [12, 0, 0]
    return out, best, dict(router.stats)


def _router_imbalance_cap(m):
    warm = list(range(8))
    router = m.rt.FleetRouter("affinity", imbalance_cap=2)
    out = [_route(router, warm, None, [_view(m, 0, None, load=0),
                                       _view(m, 1, warm, load=3)]),
           _route(router, warm, None, [_view(m, 0, None, load=0),
                                       _view(m, 1, warm, load=2)])]
    assert out[0][0] == 0 and out[1][0] == 1
    return out, dict(router.stats)


def _router_blind(m):
    router = m.rt.FleetRouter("blind")
    views = [_view(m, i, None) for i in range(3)]
    picks = [router.route([1, 2], None, views).replica_id for _ in range(6)]
    assert picks == [0, 1, 2, 0, 1, 2]
    with pytest.raises(ValueError, match="routing mode"):
        m.rt.FleetRouter("random")
    with pytest.raises(ValueError, match="imbalance_cap"):
        m.rt.FleetRouter("affinity", imbalance_cap=0)
    return picks, dict(router.stats)


def _delta_replay(m):
    pc = m.pg.PrefixCache(16)
    tr = m.rt.FingerprintTracker()
    seen = []

    def check():
        got = tr.refresh(0, pc)
        assert got == pc.fingerprint()
        seen.append(got)

    check()
    pc.register(list(range(12)), [1, 2, 3], namespace="a")
    check()
    pc.register(list(range(8)), [4, 5], namespace="b")
    check()
    pc.evict(1)
    check()
    assert tr.stats["snapshots"] == 1 and tr.stats["deltas"] >= 3
    assert pc.fingerprint_delta(pc.epoch + 1) is None
    pc._journal = deque(maxlen=2)
    for i in range(3):
        pc.register(list(range(100 + 20 * i, 116 + 20 * i)), [i + 6],
                    namespace="x")
    assert pc.fingerprint_delta(0) is None
    check()
    assert tr.stats["snapshots"] == 2
    return seen, dict(tr.stats)


def _delta_fed_router(m):
    caches = {0: m.pg.PrefixCache(16), 1: m.pg.PrefixCache(16)}
    tr = m.rt.FingerprintTracker()
    rt_delta, rt_snap = m.rt.FleetRouter("affinity"), \
        m.rt.FleetRouter("affinity")
    hot_a, hot_b = list(range(16)), list(range(50, 66))
    probes = [hot_a, hot_b, hot_a[:8] + [9] * 8]
    decisions = []

    def views(fp_of):
        return [m.rt.ReplicaView(replica_id=i, open_slots=2, load=0,
                                 page_size=4, fingerprint=fp_of(i))
                for i in caches]

    def same():
        for p in probes:
            d = _route(rt_delta, p, "t",
                       views(lambda i: tr.refresh(i, caches[i])))
            s = _route(rt_snap, p, "t", views(lambda i: caches[i].fingerprint()))
            assert d == s
            decisions.append(d)

    same()
    caches[0].register(hot_a, [1, 2, 3, 4], namespace="t")
    same()
    caches[1].register(hot_b, [1, 2, 3, 4], namespace="t")
    same()
    caches[0].evict(1)
    same()
    caches[1].register(hot_a, [5, 6, 7, 8], namespace="t")
    same()
    assert tr.stats["deltas"] > 0 and rt_delta.stats == rt_snap.stats
    return decisions, dict(rt_delta.stats)


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _basics, _validation, _collector, _populated, _awkward_floats,
    _registry_dict, _service_model, _plan_preemption, _fingerprints,
    _router_affinity, _router_imbalance_cap, _router_blind, _delta_replay,
    _delta_fed_router)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_reference(name):
    """The scenario's assertions hold on both packages, and what it returns
    is equal (Prometheus text byte for byte)."""
    scenario = SCENARIOS[name]
    assert scenario(IMPLS["port"]) == scenario(IMPLS["reference"])


def test_copies_import_nothing_of_the_reference():
    for mod in (t_tel, t_rt, t_adm):
        assert mod.__name__.startswith("repro_torch.")
    assert t_rt.chain_hashes is t_pg.chain_hashes
    assert t_rt.RegistryDict is t_tel.RegistryDict


# ---------------------------------------------------------------------------
# bind_registry on both engines
# ---------------------------------------------------------------------------

def _workload(eng, req_cls, prompts):
    """Admission with a shared prefix, a preempt/resume, an export and its
    import, demotion at retirement and a restore, then a ``generate``
    (which zeroes the bound mirror; the counters stay monotonic)."""
    eng.demote_on_retire = True
    for i, p in enumerate(prompts[:2]):
        eng.enqueue(req_cls(i, p, 6))
    eng.admit()
    eng.decode_step()
    slot = min(eng._live)
    eng.resume(eng.preempt(slot))
    eng.import_pages(eng.export(slot=max(eng._live)))
    while eng.has_work:
        eng.admit()
        eng.decode_step()
    eng.restore_pages(eng.demoted_out.pop())
    eng.demote_on_retire = False
    eng.generate(prompts, max_new=4)
    stats = dict(eng.stats)
    del stats["admit_seconds"]          # wall time, local-only
    return stats


def test_bind_registry_counts_as_the_reference_engine():
    jcfg = jax_reduced("yi-6b").replace(dtype="float32", page_size=8)
    tcfg = get_reduced_config("yi-6b").replace(dtype="float32", page_size=8)
    jparams = jax_init(jax_family(jcfg).layout(jcfg), jax.random.PRNGKey(0),
                       jcfg.param_dtype)
    tparams = params_from_reference(tcfg, get_family(tcfg).layout(tcfg),
                                    jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 256, size=12).tolist()
    prompts = [shared + rng.randint(0, 256, size=n).tolist()
               for n in (3, 6, 1)]
    kw = dict(max_len=48, max_slots=2, prefill_chunk=8, decode_chunk=4)
    out = {}
    for name, eng, req, tel in (
            ("port", ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                              **kw), EngineRequest, t_tel),
            ("reference", JaxEngine(jcfg, jparams, **kw), JaxRequest,
             j_tel)):
        reg = tel.MetricsRegistry()
        eng.bind_registry(reg, engine="e0")
        assert isinstance(eng.stats, tel.RegistryDict)
        out[name] = (_workload(eng, req, prompts), reg.expose())
    (stats, text), (want_stats, want_text) = out["port"], out["reference"]
    assert stats == want_stats
    assert text == want_text
    for key in ("preempted", "resumed", "page_exports", "page_imports",
                "page_demotes", "page_restores", "cached_tokens"):
        assert f'kotta_engine_{key}_total{{engine="e0"}}' in text
    assert stats["admitted"] == 3 and stats["page_demotes"] == 0
