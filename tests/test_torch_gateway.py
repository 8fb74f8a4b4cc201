"""The port's Kotta serving gateway on the CPU.

The gateway-driving scenarios of tests/test_gateway.py, test_faults.py,
test_fleet.py, test_kv_store.py and test_telemetry.py, run against the
port's gateway over torch engines on the reduced yi-6b in float32
(page_size 8, max_len 48, 2 slots, prefill_chunk 8, decode_chunk 4), each
with the reference scenario's assertions. Greedy tokens are held exactly to
an uninterrupted torch engine.

Four scenarios also run the same trace through both gateways under plain
decode (schedule parity): job states, shed reasons, completion order, the
audit log, ``metrics()`` and the Prometheus exposition are equal, byte for
byte, with replica ids restarted in both; tokens equal the reference's
wherever its teacher-forced top-1 margin exceeds 1e-4.

The port's gateway retries a destination engine only on its capacity
refusal (``CapacityError``); any other ``RuntimeError`` from
``import_pages`` / ``restore_pages`` propagates out of ``step``.
"""
import itertools
import math
from types import ModuleType

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro.core.scheduler as j_sched  # noqa: E402
import repro.core.security as j_sec  # noqa: E402
import repro.serve as j_serve  # noqa: E402
import repro.serve.gateway as j_gw  # noqa: E402
import repro.serve.loadgen as j_loadgen  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.serve as t_serve  # noqa: E402
import repro_torch.serve.gateway as t_gw  # noqa: E402
import repro_torch.serve.loadgen as t_loadgen  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import get_family, params_from_reference  # noqa: E402
from repro_torch.serve import CapacityError, ExportReason  # noqa: E402

MAX_LEN = 48
SLOTS = 2
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are a few KB wide: one intra-op thread a test process
    runs them fastest, and leaves the other workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Impl:
    """One package's gateway stack over the shared reduced model: the
    names a scenario needs, and the reference tests' helpers."""

    def __init__(self, name, cfg, params):
        self.name, self.cfg, self.params = name, cfg, params
        port = name == "port"
        for mod in ((t_core, t_serve, t_loadgen) if port
                    else (j_core, j_sched, j_sec, j_serve, j_loadgen)):
            for k, v in vars(mod).items():
                if not k.startswith("_") and not isinstance(v, ModuleType):
                    setattr(self, k, v)
        self.gw_mod = t_gw if port else j_gw
        self._gold: dict = {}

    def engine(self, **kw):
        kw.setdefault("max_len", MAX_LEN)
        kw.setdefault("max_slots", SLOTS)
        kw.setdefault("prefill_chunk", 8)
        kw.setdefault("decode_chunk", 4)
        if self.name == "port":
            kw["device"] = "cpu"
        return self.ContinuousBatchingEngine(self.cfg, self.params, **kw)

    def factory(self, **kw):
        return lambda: self.engine(**kw)

    def security(self, *tenants, zones=None):
        sec = self.PolicyEngine(clock=self.VirtualClock())
        return sec, {t: self.provision_tenant(
            sec, t, f"pw-{t}", data_zones=zones or ("public", t))
            for t in tenants}

    def gateway(self, sec, *, scaling=None, market=None, engine_kw=None,
                **kw):
        """The reference tests' gateway; replica ids restart at 0."""
        self.gw_mod._Replica._ids = itertools.count()
        kw.setdefault("provisioning",
                      self.ProvisioningModel(base_delay_s=5.0, jitter_s=0.0,
                                             volatility_prob=0.0))
        kw.setdefault("service_model", self.ServiceModel(decode_step_s=0.05))
        return self.KottaServeGateway(
            self.factory(**(engine_kw or {})), sec,
            scaling=scaling or self.ScalingPolicy.none(
                1, market="on_demand"), market=market, **kw)

    def gold(self, prompt, max_new, **kw):
        """Tokens of an uninterrupted engine run of ``prompt`` alone."""
        key = tuple(sorted(kw.items()))
        if key not in self._gold:
            self._gold[key] = self.engine(**kw)
        out = self._gold[key].generate([list(prompt)], max_new=max_new)
        return [int(t) for t in np.asarray(out.tokens)[0]]

    def prompt(self, n, seed=0):
        return np.random.RandomState(seed).randint(
            0, self.cfg.vocab_size, size=n).tolist()


@pytest.fixture(scope="module")
def impls():
    jcfg = jax_reduced("yi-6b").replace(dtype="float32", page_size=8)
    tcfg = get_reduced_config("yi-6b").replace(dtype="float32", page_size=8)
    jparams = jax_init(jax_family(jcfg).layout(jcfg), jax.random.PRNGKey(0),
                       jcfg.param_dtype)
    tparams = params_from_reference(tcfg, get_family(tcfg).layout(tcfg),
                                    jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return {"port": _Impl("port", tcfg, tparams),
            "reference": _Impl("reference", jcfg, jparams)}


@pytest.fixture(scope="module")
def port(impls):
    return impls["port"]


def _tokens(gw, rid):
    return [int(t) for t in gw.result(rid)]


def _audit(sec, action, decision=None):
    return [a for a in sec.audit.records() if a.action == action
            and (decision is None or a.decision == decision)]


def _mid_decode(gw, n_live):
    """Step until n_live requests are genuinely mid-decode on replica 0."""
    for _ in range(200):
        gw.step()
        live = gw.replicas()
        if live and live[0].engine.live == n_live and \
                all(l.emitted > 0 for l in live[0].engine._live.values()):
            return live[0].engine
    pytest.fail("never reached mid-decode state")


def _mid_decode_replica(gw, rounds=400):
    """Step until some replica has a slot genuinely mid-decode."""
    for _ in range(rounds):
        for r in gw.replicas():
            if any(0 < l.emitted < l.req.max_new
                   for l in r.engine._live.values()):
                return r
        gw.step()
    pytest.fail("never reached mid-decode state")


def _record(gw, sec):
    """What a schedule is made of, for equality across the packages."""
    gw.registry.collect()
    return {
        "jobs": [(j.rid, j.tenant, j.status.value, j.priority,
                  None if j.error is None else
                  (type(j.error).__name__, j.error.reason, str(j.error)),
                  j.submitted_at, j.dispatched_at, j.started_at,
                  j.finished_at, j.retries, j.evacuations, j.replica)
                 for j in sorted(gw.jobs.values(), key=lambda j: j.rid)],
        "order": list(gw.completed_order),
        "audit": [(a.timestamp, a.principal_id, a.role_name, a.action,
                   a.resource, a.decision, a.detail)
                  for a in sec.audit.records()],
        "metrics": gw.metrics(),
        "exposition": gw.registry.expose(),
    }


# ---------------------------------------------------------------------------
# The four schedule-parity scenarios (plain decode). Each returns
# (schedule record, {rid: (prompt, tokens)}).
# ---------------------------------------------------------------------------

def _edf_shed_preempt(h):
    """EDF across classes with a typed shed (an infeasible batch job, a
    cost-budget refusal) and a preemption whose victim resumes
    losslessly."""
    sec, tok = h.security("alice", "bob")
    gw = h.gateway(sec, engine_kw={"max_slots": 2, "decode_chunk": 2})
    rng = np.random.RandomState(50)
    bprompts = [rng.randint(0, h.cfg.vocab_size, size=6).tolist()
                for _ in range(2)]
    b_rids = [gw.submit(tok[t], p, max_new=24, deadline_s=3600.0,
                        priority=1, data_zone="public")
              for t, p in zip(("alice", "bob"), bprompts)]
    eng = _mid_decode(gw, 2)
    pf_mark = eng.stats["prefill_tokens"]
    iprompt = rng.randint(0, h.cfg.vocab_size, size=5).tolist()
    i_rid = gw.submit(tok["alice"], iprompt, max_new=4, deadline_s=0.5,
                      priority=0)
    doomed = gw.submit(tok["bob"], rng.randint(0, 256, size=6).tolist(),
                       max_new=16, deadline_s=0.3, priority=1)
    broke = gw.submit(tok["bob"], rng.randint(0, 256, size=6).tolist(),
                      max_new=8, cost_budget=1e-12)
    saw_paused = False
    for _ in range(2_000):
        if not gw.outstanding():
            break
        gw.step()
        saw_paused = saw_paused or any(j.status is h.JobState.PAUSED
                                       for j in gw.jobs.values())
    m = gw.metrics()
    assert saw_paused
    assert m["completed"] == 3 and m["shed"] == 2
    assert m["preemptions"] == 1 and m["resumes"] == 1
    assert m["preempt_wait_s"] > 0.0 and m["interactive_sla_rate"] == 1.0
    assert gw.completed_order[0] == i_rid
    with pytest.raises(h.DeadlineInfeasible):
        gw.result(doomed)
    with pytest.raises(h.CostBudgetExceeded):
        gw.result(broke)
    for rid, p in zip(b_rids, bprompts):
        assert _tokens(gw, rid) == h.gold(p, 24, decode_chunk=2)
    assert eng.stats["prefill_tokens"] - pf_mark == len(iprompt)
    assert len(_audit(sec, "serve:Preempt")) == 1
    assert len(_audit(sec, "serve:Resume")) == 1
    prompts = dict(zip(b_rids + [i_rid], bprompts + [iprompt]))
    return _record(gw, sec), {r: (p, _tokens(gw, r))
                              for r, p in prompts.items()}


def _spot_revocation_requeue(h):
    """A spot replica revoked mid-decode without notice: its requests
    requeue with backoff and finish on the replacement, token-identical."""
    sec, tok = h.security("alice")
    gw = h.gateway(
        sec, scaling=h.ScalingPolicy.limited(1, market="spot",
                                             bid_fraction=1e9),
        market=h.SpotMarket(seed=0),
        engine_kw={"max_slots": 2, "decode_chunk": 2})
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, h.cfg.vocab_size, size=n).tolist()
               for n in (6, 9)]
    rids = [gw.submit(tok["alice"], p, max_new=12) for p in prompts]
    for _ in range(200):
        gw.step()
        live = gw.replicas()
        if live and any(0 < l.emitted < l.req.max_new
                        for l in live[0].engine._live.values()):
            break
    else:
        pytest.fail("never reached mid-decode state")
    gw.revoke_replica(gw.replicas()[0].id)
    assert all(gw.jobs[r].status is h.JobState.QUEUED for r in rids
               if gw.jobs[r].tokens is None)
    gw.drain()
    for rid, p in zip(rids, prompts):
        assert _tokens(gw, rid) == h.gold(p, 12, decode_chunk=2)
    m = gw.metrics()
    assert m["revocations"] == 1 and m["requeues"] >= 1
    assert m["completed"] == 2 and m["shed"] == 0
    assert m["wasted_decode_tokens"] > 0
    return _record(gw, sec), {r: (p, _tokens(gw, r))
                              for r, p in zip(rids, prompts)}


def _notice_window_evacuation(h, kv_dtype="f32", spec=False):
    """A replica served a revocation notice mid-decode evacuates its live
    slots to the survivor: every job completes token-identically, zero
    retries, one audit record a move."""
    sec, tok = h.security("alice")
    ekw = {"kv_cache_dtype": kv_dtype, "decode_chunk": 2}
    if spec:
        ekw.update(enable_spec_decode=True, spec_tokens=4)
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   engine_kw=ekw)
    prompts = [h.prompt(6, seed=90), h.prompt(9, seed=91)]
    rids = [gw.submit(tok["alice"], p, max_new=12) for p in prompts]
    victim = _mid_decode_replica(gw)
    moved = [l.req.rid for l in victim.engine._live.values()]
    gw.revoke_replica(victim.id, notice_s=60.0)
    gw.drain()
    for r, p in zip(rids, prompts):
        assert _tokens(gw, r) == h.gold(p, 12, kv_cache_dtype=kv_dtype)
    m = gw.metrics()
    assert m["notices"] == 1 and m["revocations"] == 1
    assert m["evacuations"] == len(moved) >= 1
    assert m["evacuated_pages_bytes"] > 0
    assert m["retries"] == 0 and m["requeues"] == 0
    assert m["completed"] == 2 and m["shed"] == 0
    assert m["disturbed_jobs"] >= 1 and m["recovered_jobs"] >= 1
    for rid in moved:
        job = gw.jobs[rid]
        assert job.evacuations == 1
        assert job.recovered_at is not None
        assert job.recovered_at >= job.disturbed_at
    assert len(_audit(sec, "serve:Evacuate", "allow")) == m["evacuations"]
    assert any("notice" in a.detail
               for a in _audit(sec, "serve:Revoke", "allow"))
    return _record(gw, sec), {r: (p, _tokens(gw, r))
                              for r, p in zip(rids, prompts)}


def _disaggregated(h):
    """1 prefill + 1 decode replica: admission -> export -> ship -> import
    -> decode for every request, tokens identical to a never-shipped run,
    the shipped prefix registered in the destination's cache."""
    sec, tok = h.security("alice")
    gw = h.gateway(
        sec, routing="affinity",
        scaling=h.ScalingPolicy.none(1, market="on_demand"),
        engine_kw={"role": "decode"}, prefill_replicas=1,
        prefill_engine_factory=h.factory(role="prefill", prefill_chunk=16))
    rng = np.random.RandomState(60)
    prompts = [rng.randint(0, h.cfg.vocab_size, size=n).tolist()
               for n in (6, 13, 16, 9)]
    rids = [gw.submit(tok["alice"], p, max_new=10, data_zone="public")
            for p in prompts]
    gw.drain()
    for rid, p in zip(rids, prompts):
        assert _tokens(gw, rid) == h.gold(p, 10)
    m = gw.metrics()
    assert m["completed"] == 4 and m["shed"] == 0
    assert m["page_ships"] == 4 and m["handoffs_in_flight"] == 0
    assert m["page_ship_bytes_per_ship"] > 0
    roles = {e["replica"]: e["role"] for e in m["per_replica"]}
    assert sorted(roles.values()) == ["decode", "prefill"]
    for rid_, role in roles.items():
        eng = gw.replica_engine(rid_)
        if role == "prefill":
            assert eng.stats["prefill_tokens"] > 0
            assert eng.stats["page_exports"] == 4
        else:
            assert eng.stats["prefill_tokens"] == 0
            assert eng.stats["page_imports"] == 4
            # shipped prompts were registered here (later imports may
            # have recycled the earlier ones' pages)
            assert any(eng.prefix_cache.lookup(p, ("alice", "public"))[1]
                       >= h.cfg.page_size for p in prompts)
    return _record(gw, sec), {r: (p, _tokens(gw, r))
                              for r, p in zip(rids, prompts)}


PARITY = {f.__name__.lstrip("_"): f for f in (
    _edf_shed_preempt, _spot_revocation_requeue, _notice_window_evacuation,
    _disaggregated)}


def _teacher_forced_margins(h, prompts, tokens):
    """Top-1 minus top-2 logit of the reference model at each generated
    step, with the reference's own tokens fed back."""
    fam = jax_family(h.cfg)
    seqs = [list(p) + list(t) for p, t in zip(prompts, tokens)]
    width = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    x, pos, _ = fam._embed(h.cfg, h.params, {"tokens": jnp.asarray(toks)})
    x, _, _ = fam._stack_forward(h.cfg, h.params, x, pos, want_cache=False)
    logits = np.asarray(jax_layers.logits_fn(h.cfg, h.params, x),
                        np.float64)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    return [margin[i, len(p) - 1:len(p) - 1 + len(t)]
            for i, (p, t) in enumerate(zip(prompts, tokens))]


@pytest.mark.parametrize("name", sorted(PARITY))
def test_schedule_parity_with_reference(impls, name):
    """The same trace through both gateways: equal schedule, audit,
    metrics and exposition; tokens equal within the margin rule."""
    got, got_toks = PARITY[name](impls["port"])
    want, want_toks = PARITY[name](impls["reference"])
    for key in ("jobs", "order", "audit", "metrics"):
        assert got[key] == want[key], key
    assert got["exposition"] == want["exposition"]
    assert got_toks.keys() == want_toks.keys()
    rids = sorted(want_toks)
    margins = _teacher_forced_margins(
        impls["reference"], [want_toks[r][0] for r in rids],
        [want_toks[r][1] for r in rids])
    compared = 0
    for rid, margin in zip(rids, margins):
        prompt, want_t = want_toks[rid]
        assert got_toks[rid][0] == prompt
        for i, w in enumerate(want_t):
            if margin[i] <= MARGIN:
                break
            assert got_toks[rid][1][i] == w, (rid, i)
            compared += 1
    assert compared >= sum(len(t) for _, t in want_toks.values()) // 2


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_scenario_holds_on_port(port, name):
    PARITY[name](port)


@pytest.mark.parametrize("kv_dtype,spec", [("int8", False), ("f32", True),
                                           ("int8", True)])
def test_notice_window_evacuation_pools_and_spec(port, kv_dtype, spec):
    """Evacuation over the int8 pool and under speculative decode: the same
    assertions, tokens equal to plain decode's over the same pool."""
    _notice_window_evacuation(port, kv_dtype, spec)


# ---------------------------------------------------------------------------
# tests/test_gateway.py
# ---------------------------------------------------------------------------

def test_submit_authorizes_and_audits(port):
    h = port
    sec, tok = h.security("alice")
    mallory = h.Principal("mallory")
    sec.authenticator.register_identity(mallory, "pw-m")
    sec.register_role(h.Role("bystander"))
    sec.bind(mallory, "bystander")
    tok_m = sec.login("mallory", "pw-m")
    gw = h.gateway(sec)
    rid = gw.submit(tok["alice"], h.prompt(6), max_new=4, data_zone="public")
    with pytest.raises(h.AuthorizationError):
        gw.submit(tok_m, h.prompt(6), max_new=4)
    gw.drain()
    assert gw.result(rid)
    allows = sec.audit.records(principal_id="alice", decision="allow")
    assert any(r.action == "serve:Generate" for r in allows)
    assert any(r.action == "data:Get" for r in allows)
    denies = sec.audit.records(principal_id="mallory", decision="deny")
    assert len(denies) == 1 and denies[0].action == "serve:Generate"
    assert gw.clock is sec.clock
    t_now = gw.clock.now()
    assert t_now > 0
    gw.submit(tok["alice"], h.prompt(6), max_new=4)
    rec = sec.audit.records(principal_id="alice", decision="allow")[-1]
    assert rec.timestamp == t_now
    gw.drain()


def test_cross_tenant_prompts_share_no_pages(port):
    h = port
    sec, tok = h.security("alice", "bob")
    gw = h.gateway(sec, engine_kw={"decode_chunk": 2})
    eng = gw.replica_engine(gw.replicas()[0].id)
    prompt = h.prompt(16, seed=3)
    gw.submit(tok["alice"], prompt, max_new=8, data_zone="public")
    gw.submit(tok["bob"], prompt, max_new=8, data_zone="public")
    gw.step()
    assert eng.live == 2
    assert eng.stats["cached_tokens"] == 0
    pages = [set(l.pages) for l in eng._live.values()]
    assert not pages[0] & pages[1]
    assert all(eng.alloc.refs[p] == 1 for s in pages for p in s)
    eng._debug_check_refcounts()
    gw.drain()
    assert eng.stats["cached_tokens"] == 0
    gw.submit(tok["alice"], prompt, max_new=4, data_zone="public")
    gw.drain()
    assert eng.stats["cached_tokens"] > 0
    eng._debug_check_refcounts()


def test_same_data_zone_different_tenant_isolated(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec)
    eng = gw.replica_engine(gw.replicas()[0].id)
    prompt = h.prompt(16, seed=4)
    gw.submit(tok["alice"], prompt, max_new=4, data_zone="public")
    gw.drain()
    gw.submit(tok["alice"], prompt, max_new=4, data_zone="alice")
    gw.drain()
    assert eng.stats["cached_tokens"] == 0


def test_edf_order_across_waves(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, engine_kw={"max_slots": 1})
    t, p = tok["alice"], h.prompt(6, seed=5)
    loose = gw.submit(t, p, max_new=4, deadline_s=10_000.0)
    tight = gw.submit(t, p, max_new=4, deadline_s=1_000.0)
    mid = gw.submit(t, p, max_new=4, deadline_s=5_000.0)
    urgent = gw.submit(t, p, max_new=4, deadline_s=9_000.0, priority=0)
    gw.drain()
    assert gw.completed_order == [urgent, tight, mid, loose]
    assert gw.metrics()["deadline_hit_rate"] == 1.0


def test_infeasible_deadline_is_shed_with_typed_rejection(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, engine_kw={"max_slots": 1},
                   service_model=h.ServiceModel(decode_step_s=1.0))
    t, p = tok["alice"], h.prompt(6, seed=6)
    ok = gw.submit(t, p, max_new=8, deadline_s=10_000.0)
    doomed = gw.submit(t, p, max_new=8, deadline_s=2.0)
    gw.drain()
    assert gw.result(ok)
    assert gw.jobs[doomed].status is h.JobState.SHED
    with pytest.raises(h.DeadlineInfeasible):
        gw.result(doomed)
    m = gw.metrics()
    assert m["shed"] == 1 and m["completed"] == 1


def test_cost_budget_rejection(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec)
    rid = gw.submit(tok["alice"], h.prompt(6, seed=7), max_new=8,
                    cost_budget=1e-12)
    gw.drain()
    with pytest.raises(h.CostBudgetExceeded):
        gw.result(rid)


def test_edf_order_preserved_across_preempt_resume(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, engine_kw={"max_slots": 2, "decode_chunk": 2})
    t, p = tok["alice"], h.prompt(6, seed=51)
    early = gw.submit(t, p, max_new=20, deadline_s=500.0, priority=1)
    late = gw.submit(t, p, max_new=20, deadline_s=900.0, priority=1)
    _mid_decode(gw, 2)
    i_rid = gw.submit(t, h.prompt(5, seed=52), max_new=4, deadline_s=0.5,
                      priority=0)
    paused_rid = None
    for _ in range(2_000):
        if not gw.outstanding():
            break
        gw.step()
        for j in gw.jobs.values():
            if j.status is h.JobState.PAUSED:
                paused_rid = j.rid
    assert paused_rid == late
    assert gw.completed_order == [i_rid, early, late]
    m = gw.metrics()
    assert m["preemptions"] == 1 and m["deadline_hit_rate"] == 1.0


def test_preemption_disabled_sheds_instead(port):
    h = port
    sec, tok = h.security("alice")
    svc = h.ServiceModel(decode_step_s=0.05)
    gw = h.gateway(sec, engine_kw={"max_slots": 2, "decode_chunk": 2},
                   service_model=svc,
                   admission=h.DeadlineCostPolicy(model=svc, preempt=False))
    t, p = tok["alice"], h.prompt(6, seed=53)
    b_rids = [gw.submit(t, p, max_new=24, deadline_s=3600.0, priority=1)
              for _ in range(2)]
    _mid_decode(gw, 2)
    i_rid = gw.submit(t, h.prompt(5, seed=54), max_new=4, deadline_s=0.5,
                      priority=0)
    gw.drain()
    with pytest.raises(h.DeadlineInfeasible):
        gw.result(i_rid)
    m = gw.metrics()
    assert m["preemptions"] == 0 and m["resumes"] == 0
    assert m["completed"] == 2 and m["shed"] == 1
    assert all(gw.jobs[r].status is h.JobState.DONE for r in b_rids)


def test_queue_depth_scales_replicas_up_and_down(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(
        sec, scaling=h.ScalingPolicy.limited(3, market="spot",
                                             bid_fraction=1e9,
                                             idle_timeout_s=30.0),
        market=h.SpotMarket(seed=0), engine_kw={"max_slots": 1})
    p = h.prompt(6, seed=9)
    for _ in range(6):
        gw.submit(tok["alice"], p, max_new=4, deadline_s=100_000.0)
    gw.drain()
    m = gw.metrics()
    assert m["completed"] == 6
    assert m["peak_replicas"] > 1
    assert m["launches"] >= m["peak_replicas"]
    for _ in range(80):
        if not gw.replicas():
            break
        gw.step()
    assert not gw.replicas()
    assert m["cost_usd"] > 0.0
    # Retired engines park in the warm pool, one parameter tree for all.
    assert gw._standby
    assert all(e.params is h.params for e in gw._standby)


def test_metrics_report_per_replica_counters(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec)
    prompt = h.prompt(16, seed=11)
    gw.submit(tok["alice"], prompt, max_new=8, data_zone="public")
    gw.step()
    m = gw.metrics()
    e, = m["per_replica"]
    assert set(e) == {"replica", "role", "state", "live", "queued",
                      "open_slots", "occupancy", "prefix_hit_rate",
                      "dispatched", "health", "noticed"}
    assert e["role"] == "unified" and e["state"] == "live"
    assert e["health"] == "up" and e["noticed"] is False
    assert e["live"] == 1 and e["dispatched"] == 1
    assert e["occupancy"] == pytest.approx(0.5)
    assert e["open_slots"] == 1 and e["prefix_hit_rate"] == 0.0
    assert m["queue_depth"] == 0 and m["routing_mode"] == "affinity"
    gw.drain()
    gw.submit(tok["alice"], prompt, max_new=8, data_zone="public")
    gw.drain()
    e = gw.metrics()["per_replica"][0]
    assert e["dispatched"] == 2 and e["prefix_hit_rate"] > 0
    assert e["live"] == 0 and e["occupancy"] == 0.0
    assert gw.replica_engine(e["replica"]).prefix_hit_rate \
        == e["prefix_hit_rate"]


# ---------------------------------------------------------------------------
# tests/test_faults.py
# ---------------------------------------------------------------------------

def test_notice_too_short_falls_back_to_requeue(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   service_model=h.ServiceModel(decode_step_s=0.05,
                                                kv_ship_bytes_per_s=1.0),
                   backoff_base_s=2.0, engine_kw={"decode_chunk": 2})
    prompt = h.prompt(8, seed=95)
    rid = gw.submit(tok["alice"], prompt, max_new=12)
    victim = _mid_decode_replica(gw)
    gw.revoke_replica(victim.id, notice_s=1.0)
    gw.drain()
    assert _tokens(gw, rid) == h.gold(prompt, 12)
    m = gw.metrics()
    job = gw.jobs[rid]
    assert m["evacuations"] == 0 and m["notices"] == 1
    assert m["retries"] >= 1 and m["backoff_wait_s"] > 0
    assert job.retries == 1
    assert job.recovered_at - job.disturbed_at >= 2.0
    assert len(_audit(sec, "serve:Requeue", "allow")) >= 1


def test_notice_window_prioritizes_tightest_deadline(port):
    h = port
    sec, tok = h.security("alice")
    page_b = h.engine().page_nbytes()
    svc = h.ServiceModel(decode_step_s=0.05, kv_ship_bytes_per_s=page_b)
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   service_model=svc, backoff_base_s=1.0,
                   engine_kw={"decode_chunk": 4})
    prompt = h.prompt(16, seed=88)
    slack = gw.submit(tok["alice"], prompt, max_new=24)
    victim = _mid_decode_replica(gw)
    urgent = gw.submit(tok["alice"], prompt, max_new=24, deadline_s=120.0)
    for _ in range(400):
        live = {l.req.rid for l in victim.engine._live.values()
                if 0 < l.emitted < l.req.max_new}
        if live == {slack, urgent}:
            break
        gw.step()
    else:
        pytest.fail("jobs never decoded together on one replica")
    eng = victim.engine
    est = {eng._live[s].req.rid: math.ceil(int(eng._pos[s]) / eng.page_size)
           for s in eng._live}
    gw.revoke_replica(victim.id, notice_s=est[urgent] + 1.6)
    gw.drain()
    uj, sj = gw.jobs[urgent], gw.jobs[slack]
    assert uj.evacuations == 1 and uj.retries == 0
    assert sj.evacuations == 0 and sj.retries == 1
    m = gw.metrics()
    assert m["evacuations"] == 1 and m["requeues"] >= 1
    assert m["completed"] == 2 and m["shed"] == 0
    want = h.gold(prompt, 24)
    assert _tokens(gw, urgent) == want and _tokens(gw, slack) == want
    assert f"job {urgent}" in _audit(sec, "serve:Evacuate", "allow")[0].detail


def test_retry_budget_exhaustion_sheds_typed(port):
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, retry_budget=1, backoff_base_s=0.5)
    rid = gw.submit(tok["alice"], h.prompt(8, seed=97), max_new=24)
    for _ in range(2):
        victim = _mid_decode_replica(gw)
        gw.revoke_replica(victim.id)
    gw.drain()
    job = gw.jobs[rid]
    assert job.status is h.JobState.SHED
    assert isinstance(job.error, h.RetryBudgetExhausted)
    with pytest.raises(h.RetryBudgetExhausted, match="budget"):
        gw.result(rid)
    m = gw.metrics()
    assert m["shed"] == 1 and m["completed"] == 0
    assert m["wasted_decode_tokens"] > 0
    assert len(_audit(sec, "serve:Requeue", "deny")) == 1


def test_straggler_fault_degrades_drains_and_recovers(port):
    h = port
    sec, tok = h.security("alice")
    inj = h.FaultInjector(schedule=(
        h.FaultEvent(at_s=6.0, kind="straggler", target=0, duration_s=20.0,
                     magnitude=10.0),))
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   routing=h.FleetRouter("affinity", health_alpha=1.0),
                   fault_injector=inj)
    while not inj.fired:
        gw.step()
    gw.step()
    now = gw.clock.now()
    lame = [r for r in gw.replicas() if r.latency_mult > 1.0]
    assert len(lame) == 1
    assert gw.router.health(lame[0].id, now) == h.HEALTH_DEGRADED
    assert gw.metrics()["replica_health"].get("degraded") == 1
    rids = [gw.submit(tok["alice"], h.prompt(6, seed=98 + i), max_new=8)
            for i in range(2)]
    gw.drain()
    assert all(gw.jobs[r].status is h.JobState.DONE for r in rids)
    assert all(gw.jobs[r].replica != lame[0].id for r in rids)
    while gw.clock.now() < 30.0:
        gw.step()
    assert gw.router.health(lame[0].id, gw.clock.now()) == h.HEALTH_UP
    assert gw.metrics()["faults_injected"] == 1


def test_heartbeat_loss_quarantines_until_heartbeats_return(port):
    h = port
    sec, tok = h.security("alice")
    inj = h.FaultInjector(schedule=(
        h.FaultEvent(at_s=6.0, kind="heartbeat_loss", target=0,
                     duration_s=8.0),))
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   routing=h.FleetRouter("affinity", heartbeat_timeout_s=2.0),
                   fault_injector=inj)
    while gw.clock.now() < 9.5:
        gw.step()
    now = gw.clock.now()
    lost = [r for r in gw.replicas()
            if gw.router.health(r.id, now) == h.HEALTH_QUARANTINED]
    assert len(lost) == 1
    assert gw.metrics()["replica_health"].get("quarantined") == 1
    rid = gw.submit(tok["alice"], h.prompt(6, seed=99), max_new=8)
    gw.drain()
    assert gw.jobs[rid].replica != lost[0].id
    while gw.clock.now() < 16.0:
        gw.step()
    assert gw.router.health(lost[0].id, gw.clock.now()) == h.HEALTH_UP


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_random_faults_never_lose_or_corrupt_jobs(port, seed):
    h = port
    sec, tok = h.security("alice")
    horizon = 8.0
    inj = h.FaultInjector.random(
        seed, horizon, crash_rate_h=900.0, revoke_rate_h=1800.0,
        straggler_rate_h=1800.0, heartbeat_loss_rate_h=900.0, notice_s=0.6,
        duration_s=(0.5, 2.0), magnitude=(2.0, 6.0), max_targets=4)
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   provisioning=h.ProvisioningModel(base_delay_s=0.5,
                                                    jitter_s=0.0,
                                                    volatility_prob=0.0),
                   retry_budget=8, backoff_base_s=0.5, fault_injector=inj,
                   engine_kw={"decode_chunk": 2})
    prompts = [h.prompt(5 + (i % 5), seed=200 + i) for i in range(6)]
    rids = [gw.submit(tok["alice"], p, max_new=10) for p in prompts]
    gw.drain(max_rounds=50_000)
    while gw.clock.now() < horizon + 1.0:
        gw.step()
    assert inj.pending == 0
    for rid, p in zip(rids, prompts):
        job = gw.jobs[rid]
        assert job.status in (h.JobState.DONE, h.JobState.SHED)
        if job.status is h.JobState.DONE:
            assert [int(t) for t in job.tokens] == h.gold(p, 10)
        else:
            assert isinstance(job.error, h.RetryBudgetExhausted)
    for r in gw.replicas():
        r.engine._debug_check_refcounts()
    assert not gw._handoffs
    m = gw.metrics()
    assert m["faults_injected"] == len(inj.fired)
    assert m["completed"] + m["shed"] == len(rids)


# ---------------------------------------------------------------------------
# The capacity refusal, and nothing else, moves a payload on
# ---------------------------------------------------------------------------

def _two_replica_evacuation(h, spoil):
    """Notice-window evacuation with the survivor's ``import_pages`` (or,
    through a tiered store, ``restore_pages``) replaced by ``spoil``."""
    sec, tok = h.security("alice")
    gw = h.gateway(sec, scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   engine_kw={"decode_chunk": 2})
    prompts = [h.prompt(6, seed=90), h.prompt(9, seed=91)]
    rids = [gw.submit(tok["alice"], p, max_new=12) for p in prompts]
    victim = _mid_decode_replica(gw)
    for r in gw.replicas():
        if r is not victim:
            r.engine.import_pages = spoil
    gw.revoke_replica(victim.id, notice_s=60.0)
    return gw, rids


def test_device_failure_in_import_propagates(port):
    def fault(payload):
        raise RuntimeError("CUDA error: an illegal memory access")
    gw, _ = _two_replica_evacuation(port, fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        gw.drain()


def test_capacity_refusal_in_import_tries_the_next_round(port):
    """A full survivor refuses with ``CapacityError``: the payload stays in
    flight and is delivered later (here to the relaunched replacement),
    never an exception out of ``step``."""
    refused = []

    def full(payload):
        refused.append(payload.req.rid)
        raise CapacityError("insufficient free pages to import")
    gw, rids = _two_replica_evacuation(port, full)
    gw.drain()
    m = gw.metrics()
    assert refused and m["evacuations"] >= 1
    assert m["completed"] == 2 and m["shed"] == 0
    assert all(port.gold(p, 12) == _tokens(gw, r) for r, p in zip(
        rids, [port.prompt(6, seed=90), port.prompt(9, seed=91)]))
    assert issubclass(CapacityError, RuntimeError)


@pytest.mark.parametrize("exc,propagates", [
    (RuntimeError("CUDA error: out of memory"), True),
    (CapacityError("insufficient free pages to restore"), False)])
def test_restore_pages_catches_only_the_capacity_refusal(port, exc,
                                                         propagates):
    """A demoted stream whose device copy was churned away parks
    RESTORE_PENDING; the replica's ``restore_pages`` then fails. After a
    capacity refusal the job is served by plain re-prefill; a device fault
    propagates."""
    h = port
    sec, tok = h.security("alice")
    store = h.TieredKVStore(host_capacity_bytes=1 << 30)
    gw = h.gateway(sec, kv_store=store, engine_kw={"num_pages": 12})
    prompt = h.prompt(16, seed=30)
    r1 = gw.submit(tok["alice"], prompt, max_new=4, data_zone="public")
    gw.drain()
    for s in range(3):
        gw.submit(tok["alice"], h.prompt(16, seed=40 + s), max_new=4,
                  data_zone="public")
    gw.drain()

    calls = []

    def restore(payload):
        calls.append(payload.req.rid)
        raise exc
    gw.replicas()[0].engine.restore_pages = restore
    r2 = gw.submit(tok["alice"], prompt + _tokens(gw, r1) + h.prompt(4, 31),
                   max_new=4, data_zone="public")
    if propagates:
        with pytest.raises(RuntimeError, match="out of memory"):
            gw.drain()
    else:
        gw.drain()
        assert gw.jobs[r2].status is h.JobState.DONE
        assert gw.stats["kv_restores"] == 0
    assert calls


def test_engine_refusals_are_capacity_errors(port):
    """The engine's three want-of-room refusals raise ``CapacityError``;
    a layout mismatch stays a ``ValueError``."""
    h = port
    eng = h.engine()
    for i in range(2):
        eng.enqueue(h.EngineRequest(i, h.prompt(12, seed=i), 8))
    eng.admit()
    payload = eng.export(slot=0, reason=ExportReason.EVACUATE)
    assert payload.n_content == 2
    full = h.engine(max_slots=1)
    full.enqueue(h.EngineRequest(9, h.prompt(6, seed=9), 8))
    full.admit()
    with pytest.raises(CapacityError, match="no free slot"):
        full.import_pages(payload)
    tiny = h.engine(num_pages=3)
    tiny.enqueue(h.EngineRequest(8, h.prompt(6, seed=8), 8))
    tiny.admit()
    with pytest.raises(CapacityError, match="insufficient free pages"):
        tiny.import_pages(payload)
    with pytest.raises(CapacityError, match="insufficient free pages"):
        tiny.restore_pages(payload)
    with pytest.raises(RuntimeError) as e:
        h.engine(enable_prefix_cache=False).restore_pages(payload)
    assert not isinstance(e.value, CapacityError)


# ---------------------------------------------------------------------------
# tests/test_fleet.py
# ---------------------------------------------------------------------------

def _placement(gw, rid):
    gw.step()
    return gw.jobs[rid].replica


def test_affinity_routes_repeat_prefix_to_warm_replica(port):
    h = port
    sec, tok = h.security("a", "b")
    gw = h.gateway(sec, routing="affinity",
                   scaling=h.ScalingPolicy.none(2, market="on_demand"))
    hot = {t: h.prompt(16, seed=40 + i) for i, t in enumerate(("a", "b"))}

    def job(tenant, tail_seed):
        return gw.submit(tok[tenant], hot[tenant] + h.prompt(
            4, seed=900 + tail_seed), max_new=8, data_zone="public")

    first = {t: _placement(gw, job(t, i)) for i, t in enumerate(("a", "b"))}
    gw.drain()
    assert first["a"] != first["b"]
    for i in range(3):
        for t in ("a", "b"):
            assert _placement(gw, job(t, 10 + 2 * i + (t == "b"))) == first[t]
            gw.drain()
    m = gw.metrics()
    assert m["routing"]["affinity"] >= 6
    assert m["routing"]["matched_tokens"] >= 6 * 16
    per = {e["replica"]: e for e in m["per_replica"]}
    assert len(per) == 2
    assert all(e["prefix_hit_rate"] > 0 for e in per.values())
    assert sum(e["dispatched"] for e in per.values()) == 8
    with pytest.raises(KeyError):
        gw.replica_engine(10_000)


def test_blind_routing_ignores_affinity(port):
    h = port
    sec, tok = h.security("a")
    hot = h.prompt(16, seed=44)

    def run(mode):
        gw = h.gateway(sec, routing=mode,
                       scaling=h.ScalingPolicy.none(2, market="on_demand"))
        for i in range(6):
            gw.submit(tok["a"], hot + h.prompt(4, seed=700 + i), max_new=4,
                      data_zone="public")
            gw.drain()
        m = gw.metrics()
        return m, sum(gw.replica_engine(e["replica"]).stats["prefill_tokens"]
                      for e in m["per_replica"])

    m_blind, fresh_blind = run("blind")
    _, fresh_aff = run("affinity")
    assert m_blind["routing"]["blind"] == 6
    assert m_blind["routing"]["matched_tokens"] == 0
    assert fresh_aff < fresh_blind


def test_disaggregated_1_to_2_and_factory_validation(port):
    """1 prefill + 2 decode replicas, then the shared prefix shipped and
    kept shareable, then the gateway's refusals of wrong factories."""
    h = port
    sec, tok = h.security("alice")
    gw = h.gateway(sec, routing="affinity",
                   scaling=h.ScalingPolicy.none(2, market="on_demand"),
                   engine_kw={"role": "decode"}, prefill_replicas=1,
                   prefill_engine_factory=h.factory(role="prefill",
                                                    prefill_chunk=16))
    rng = np.random.RandomState(60)
    prompts = [rng.randint(0, h.cfg.vocab_size, size=n).tolist()
               for n in (6, 13, 16, 9)]
    rids = [gw.submit(tok["alice"], p, max_new=10, data_zone="public")
            for p in prompts]
    gw.drain()
    for rid, p in zip(rids, prompts):
        assert _tokens(gw, rid) == h.gold(p, 10)
    m = gw.metrics()
    assert m["page_ships"] == 4
    roles = {e["replica"]: e["role"] for e in m["per_replica"]}
    assert sorted(roles.values()) == ["decode", "decode", "prefill"]
    pre_id = next(r for r, ro in roles.items() if ro == "prefill")
    assert {e["replica"]: e["dispatched"]
            for e in m["per_replica"]}[pre_id] == 4

    gw = h.gateway(sec, routing="affinity",
                   engine_kw={"role": "decode"}, prefill_replicas=1,
                   prefill_engine_factory=h.factory(role="prefill"))
    hot = h.prompt(16, seed=70)
    r1 = gw.submit(tok["alice"], hot + h.prompt(3, seed=71), max_new=6,
                   data_zone="public")
    gw.drain()
    r2 = gw.submit(tok["alice"], hot + h.prompt(5, seed=72), max_new=6,
                   data_zone="public")
    gw.drain()
    assert gw.jobs[r1].status is h.JobState.DONE
    assert gw.jobs[r2].status is h.JobState.DONE
    m = gw.metrics()
    pre = next(e for e in m["per_replica"] if e["role"] == "prefill")
    dec = next(e for e in m["per_replica"] if e["role"] == "decode")
    assert pre["prefix_hit_rate"] > 0
    eng = gw.replica_engine(dec["replica"])
    assert eng.prefix_cache.lookup(hot, ("alice", "public"))[1] == 16
    with pytest.raises(ValueError, match="prefill_engine_factory"):
        h.gateway(sec, prefill_replicas=1)
    with pytest.raises(ValueError, match="role='prefill'"):
        h.gateway(sec, prefill_replicas=1, prefill_engine_factory=h.factory())
    with pytest.raises(ValueError, match="decode-capable"):
        h.gateway(sec, engine_kw={"role": "prefill"})


# ---------------------------------------------------------------------------
# tests/test_kv_store.py
# ---------------------------------------------------------------------------

def test_gateway_restore_fallback_reprefills(port):
    h = port
    prompt = h.prompt(16, seed=9)

    def run(store):
        sec, tok = h.security("alice")
        gw = h.gateway(sec, kv_store=store)
        r1 = gw.submit(tok["alice"], prompt, max_new=4, data_zone="public")
        gw.drain()
        r2 = gw.submit(tok["alice"], prompt + _tokens(gw, r1)
                       + h.prompt(4, 10), max_new=4, data_zone="public")
        if store is not None:
            gw.step()
            assert gw.jobs[r2].status is h.JobState.RESTORE_PENDING
            store._entries.clear()
        gw.drain()
        assert gw.jobs[r2].status is h.JobState.DONE
        return _tokens(gw, r2), gw

    store = h.TieredKVStore(host_capacity_bytes=1 << 30,
                            host_restore_bytes_per_s=64.0)
    got, gw = run(store)
    want, _ = run(None)
    assert got == want
    assert gw.stats["kv_restore_fallbacks"] == 1
    assert gw.stats["kv_restores"] == 0


def test_gateway_demotes_before_device_eviction(port):
    h = port
    prompt, tail = h.prompt(16, seed=30), h.prompt(4, seed=31)

    def run(store):
        sec, tok = h.security("alice")
        gw = h.gateway(sec, kv_store=store, engine_kw={"num_pages": 12})
        r1 = gw.submit(tok["alice"], prompt, max_new=4, data_zone="public")
        gw.drain()
        reply = _tokens(gw, r1)
        for s in range(3):
            gw.submit(tok["alice"], h.prompt(16, seed=40 + s), max_new=4,
                      data_zone="public")
        gw.drain()
        r2 = gw.submit(tok["alice"], prompt + reply + tail, max_new=4,
                       data_zone="public")
        gw.drain()
        return _tokens(gw, r2), gw

    store = h.TieredKVStore(host_capacity_bytes=1 << 30)
    got, gw = run(store)
    want, _ = run(None)
    assert got == want
    assert gw.stats["kv_demotions"] >= 4
    assert gw.stats["kv_restores"] == 1
    assert store.stats["eviction_events"] > 0
    assert store.stats["device_evicted_pages"] > 0


# ---------------------------------------------------------------------------
# tests/test_telemetry.py
# ---------------------------------------------------------------------------

def _telemetry_gateway(h, sec, **kw):
    svc = h.ServiceModel(decode_step_s=0.05)
    kw.setdefault("admission", h.DeadlineCostPolicy(model=svc))
    kw.setdefault("scaling", h.ScalingPolicy.none(1, market="on_demand"))
    kw.setdefault("service_model", svc)
    kw.setdefault("idle_tick_s", 0.05)
    return h.KottaServeGateway(h.factory(max_slots=4), sec, **kw)


def _small_trace(h, tenants, **kw):
    kw.setdefault("duration_s", 6.0)
    kw.setdefault("base_rate_rps", 4.0)
    return h.TrafficConfig(tenants=tenants, vocab_size=h.cfg.vocab_size,
                           prefix_tokens=16, interactive_max_new=4,
                           batch_max_new=4, seed=3, **kw)


@pytest.fixture(scope="module")
def served(port):
    """One open-loop run shared by the integration assertions below."""
    h = port
    sec, tok = h.security(*(f"tenant{i}" for i in range(3)),
                          zones=("public",))
    tokens = [tok[f"tenant{i}"] for i in range(3)]
    store = h.StateStore(clock=sec.clock, write_capacity=200.0)
    gw = _telemetry_gateway(h, sec, telemetry_store=store,
                            telemetry_flush_s=1.0)
    trace = h.generate_trace(_small_trace(h, 3))
    rounds = h.run_open_loop(gw, tokens, trace)
    gw.flush_telemetry()
    return gw, store, trace, rounds


def test_one_registry_serves_gateway_engine_and_router(served):
    gw, _, trace, rounds = served
    reg = gw.registry
    assert {"kotta_requests_total", "kotta_request_ttft_seconds",
            "kotta_engine_admitted_total", "kotta_routing_decisions_total",
            "kotta_gateway_rounds_total", "kotta_slo_burn_rate"} \
        <= set(reg.families())
    seen = {t for t in ("tenant0", "tenant1", "tenant2")
            if reg.value("kotta_requests_total", tenant=t,
                         **{"class": "interactive"})
            + reg.value("kotta_requests_total", tenant=t,
                        **{"class": "batch"}) > 0}
    assert seen == {f"tenant{a.tenant_idx}" for a in trace}
    assert reg.value("kotta_gateway_rounds_total") == gw.stats["rounds"] \
        == rounds
    assert reg.value("kotta_engine_admitted_total", engine="e0") \
        == gw.metrics()["completed"] == len(trace)


def test_gateway_exposition_round_trips(served):
    reg = served[0].registry
    assert t_serve.parse_exposition(reg.expose())["families"] == \
        reg.snapshot()["families"]


def test_latency_histograms_observe_every_completion(served):
    gw, _, trace, _ = served
    snap = gw.registry.snapshot()["families"]
    for fam in ("kotta_request_ttft_seconds", "kotta_request_tpot_seconds",
                "kotta_request_queue_wait_seconds"):
        assert sum(s["count"] for s in snap[fam]["samples"]) == len(trace)
    assert sum(s["value"] for s in
               snap["kotta_tenant_cost_usd_total"]["samples"]) > 0


def test_telemetry_stream_lands_in_statestore(served):
    gw, store, trace, _ = served
    jobs = store.scan("servejob/")
    assert len(jobs) == len(trace)
    assert all(j["status"] == "done" for j in jobs.values())
    assert len(store.scan("audit/")) == len(gw.security.audit.records())
    snaps = store.scan("metrics/")
    assert len(snaps) == gw.stats["telemetry_flushes"] + 1
    assert "kotta_gateway_rounds_total" in snaps[max(snaps)]["families"]
    assert gw.stats["telemetry_writes"] == store.write_count
    m = gw.metrics()
    assert m["completed"] + m["shed"] == len(trace)
    assert m["slo_burn_rate"] == 0.0


def test_throttled_store_counts_and_sharding_recovers(port):
    h = port

    def run(store_factory):
        sec, tok = h.security("tenant0", "tenant1", zones=("public",))
        store = store_factory(sec.clock)
        gw = _telemetry_gateway(h, sec, telemetry_store=store,
                                telemetry_flush_s=0.5)
        trace = h.generate_trace(_small_trace(h, 2, base_rate_rps=8.0))
        h.run_open_loop(gw, [tok["tenant0"], tok["tenant1"]], trace)
        gw.flush_telemetry()
        assert len(store.scan("servejob/")) == len(trace)
        return gw.stats["statestore_throttled"], store.throttled_writes

    gw_thr, st_thr = run(lambda c: h.StateStore(clock=c, write_capacity=4.0))
    assert st_thr > 0 and gw_thr == st_thr
    _, st_thr4 = run(lambda c: h.ShardedStateStore(4, clock=c,
                                                   write_capacity=4.0))
    assert st_thr4 < st_thr
