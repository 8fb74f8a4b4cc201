"""The port's copies of the gateway's pure-Python helpers, against the
reference's: ``core/clock``, ``core/security``, ``core/elastic``,
``core/market``, ``core/scheduler``'s StateStore, ``serve/faults`` and
``serve/loadgen``.

Each scenario runs on both packages, holds the reference tests'
assertions on each, and returns what it observed; the two returns must be
equal. Spot price traces, notice and revocation times, random fault
schedules and open-loop arrivals are equal exactly (both seed numpy the
same way); authorization decisions and audit records are compared by
decision, principal, role, action, resource and timestamp, never by token
strings (``secrets`` draws them afresh).
"""
import dataclasses
from types import ModuleType, SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.clock as j_clock  # noqa: E402
import repro.core.elastic as j_elastic  # noqa: E402
import repro.core.market as j_market  # noqa: E402
import repro.core.scheduler as j_sched  # noqa: E402
import repro.core.security as j_sec  # noqa: E402
import repro.serve.faults as j_faults  # noqa: E402
import repro.serve.loadgen as j_loadgen  # noqa: E402
import repro_torch.core.clock as t_clock  # noqa: E402
import repro_torch.core.elastic as t_elastic  # noqa: E402
import repro_torch.core.market as t_market  # noqa: E402
import repro_torch.core.scheduler as t_sched  # noqa: E402
import repro_torch.core.security as t_sec  # noqa: E402
import repro_torch.serve.faults as t_faults  # noqa: E402
import repro_torch.serve.loadgen as t_loadgen  # noqa: E402


def _namespace(*mods):
    ns = SimpleNamespace()
    for mod in mods:
        for k, v in vars(mod).items():
            if not k.startswith("__") and not isinstance(v, ModuleType):
                setattr(ns, k, v)
    return ns


IMPLS = {
    "port": _namespace(t_clock, t_elastic, t_market, t_sched, t_sec,
                       t_faults, t_loadgen),
    "reference": _namespace(j_clock, j_elastic, j_market, j_sched, j_sec,
                            j_faults, j_loadgen),
}


def _market(m):
    """Hourly traces, cheapest zones, and the notice firing exactly one
    window ahead of the revocation (tests/test_faults.py)."""
    mk = m.SpotMarket(seed=0)
    traces = {(z.name, it): [float(p) for p in mk.trace(z, it, 48)]
              for z in mk.zones[:4] for it in ("m4.xlarge", "c4.8xlarge")}
    cheapest = [(z.name, p) for z, p in (mk.cheapest_zone("c4.8xlarge", h)
                                         for h in range(0, 48, 5))]
    z, it = mk.zones[0], "m4.xlarge"
    trace = [mk.price(z, it, h) for h in range(12)]
    bid = (min(trace) + max(trace)) / 2.0
    ahead = mk.notice_s / 3600.0
    grid = [i * 0.01 for i in range(1200)]
    notices = [t for t in grid if mk.notice(z, it, bid, t)]
    revoked = [t for t in grid if mk.revoked(z, it, bid, t)]
    for t in grid:
        assert mk.notice(z, it, bid, t) == mk.revoked(z, it, bid, t + ahead)
    assert any(mk.notice(z, it, bid, t) and not mk.revoked(z, it, bid, t)
               for t in grid)
    other = m.SpotMarket(seed=1).trace(z, it, 48).tolist()
    assert other != traces[(z.name, it)]
    return traces, cheapest, notices, revoked, [z.name for z in mk.zones]


def _faults(m):
    """The scripted schedule pops each event once; seeded random schedules
    are deterministic and cover every kind (tests/test_faults.py)."""
    with pytest.raises(ValueError, match="fault kind"):
        m.FaultEvent(at_s=0.0, kind="meteor")
    inj = m.FaultInjector(schedule=(
        m.FaultEvent(at_s=5.0, kind="crash"),
        m.FaultEvent(at_s=1.0, kind="straggler", duration_s=3.0),))
    assert inj.pending == 2
    popped = [[e.kind for e in inj.pop_due(t)] for t in (2.0, 2.0, 10.0)]
    assert popped == [["straggler"], [], ["crash"]] and inj.pending == 0
    rates = dict(crash_rate_h=8.0, revoke_rate_h=8.0, straggler_rate_h=8.0,
                 heartbeat_loss_rate_h=8.0)
    out = {}
    for seed in (0, 1, 2, 3):
        a = m.FaultInjector.random(seed, 3600.0, notice_s=0.7, **rates)
        assert a.schedule == m.FaultInjector.random(
            seed, 3600.0, notice_s=0.7, **rates).schedule
        assert {e.kind for e in a.schedule} <= set(m.KINDS)
        out[seed] = [dataclasses.astuple(e) for e in a.schedule]
    chaos = m.FaultInjector.random(
        0, 8.0, crash_rate_h=900.0, revoke_rate_h=1800.0,
        straggler_rate_h=1800.0, heartbeat_loss_rate_h=900.0, notice_s=0.6,
        duration_s=(0.5, 2.0), magnitude=(2.0, 6.0), max_targets=4)
    out["chaos"] = [dataclasses.astuple(e) for e in chaos.schedule]
    assert out[0] != out[1]
    return out


def _traffic(m):
    """Open-loop arrivals, with diurnal modulation, Zipf users and session
    resumption (tests/test_telemetry.py)."""
    cfg = m.TrafficConfig(duration_s=20.0, base_rate_rps=10.0, tenants=3,
                          diurnal_amplitude=0.5, diurnal_period_s=20.0,
                          seed=5)
    a = m.generate_trace(cfg)
    assert a == m.generate_trace(cfg)
    assert m.generate_trace(dataclasses.replace(cfg, seed=6)) != a
    assert all(a[i].at_s <= a[i + 1].at_s for i in range(len(a) - 1))
    assert 5.0 < m.offered_load(a, cfg) < 20.0
    assert {x.priority for x in a} == {0, 1}
    resumed = m.generate_trace(dataclasses.replace(
        cfg, resume_fraction=0.3, cold_gap_mean_s=4.0))
    assert any(x.resumed for x in resumed)
    with pytest.raises(ValueError, match="amplitude"):
        m.generate_trace(m.TrafficConfig(diurnal_amplitude=1.5))
    with pytest.raises(ValueError, match="zipf"):
        m.generate_trace(m.TrafficConfig(zipf_alpha=1.0))
    return ([dataclasses.astuple(x) for x in a],
            [dataclasses.astuple(x) for x in resumed],
            m.offered_load(a, cfg))


def _policies(m):
    """One policy set: the standard roles, a private dataset, two serving
    tenants; a grid of authorization decisions, role assumption, expiry
    and signed URLs, with the audit log they leave."""
    clock = m.VirtualClock()
    eng = m.PolicyEngine(clock=clock)
    m.install_standard_roles(eng)
    m.make_dataset_role(eng, "census")
    alice = m.provision_tenant(eng, "alice", "pw-a",
                               data_zones=("public", "alice"))
    bob = m.provision_tenant(eng, "bob", "pw-b", models=("serve", "big"))
    worker = eng.service_session("task-executor")
    nobody = m.Principal("mallory")
    eng.authenticator.register_identity(nobody, "pw-m")
    with pytest.raises(m.AuthorizationError, match="least privilege"):
        eng.login("mallory", "pw-m")
    with pytest.raises(m.AuthenticationError):
        eng.login("alice", "wrong")
    decisions = []
    for tok in (alice, bob, worker):
        for action in ("serve:Generate", "data:Get", "data:Download",
                       "queue:Put", "db:Get"):
            for res in ("model/serve", "model/big", "dataset/public/x",
                        "dataset/alice/ctx", "dataset/census/x", "results/1"):
                decisions.append(eng.is_authorized(tok, action, res))
    census = eng.assume_role(worker, "kotta-read-census-private")
    decisions += [eng.is_authorized(census, "data:Get", "dataset/census/a"),
                  eng.is_authorized(census, "data:Download",
                                    "dataset/census/a")]
    with pytest.raises(m.AuthorizationError):
        eng.assume_role(alice, "kotta-read-census-private")
    m.make_dataset_role(eng, "open", downloadable=True)
    url = eng.sign_url(eng.assume_role(worker, "kotta-read-open-private"),
                       "dataset/open/x")
    url_ok = eng.verify_url(url)
    with pytest.raises(m.AuthorizationError, match="signature"):
        eng.verify_url(url[:-1] + ("0" if url[-1] != "0" else "1"))
    clock.advance(m.hours(1))
    with pytest.raises(m.TokenExpiredError):
        eng.check(alice, "serve:Generate", "model/serve")
    audit = [(r.timestamp, r.principal_id, r.role_name, r.action, r.resource,
              r.decision) for r in eng.audit.records()]
    assert len(eng.audit.records(decision="deny")) > 0
    return decisions, audit, url_ok, sorted(eng.roles_of("alice")), \
        (m.days(2), m.hours(3))


def _statestores(m):
    """Token-bucket throttling of the try_* paths on a virtual clock, and
    four shards sustaining four times the write rate."""
    clock = m.VirtualClock()
    single = m.StateStore(clock=clock, read_capacity=5.0, write_capacity=10.0)
    sharded = m.ShardedStateStore(4, clock=clock, read_capacity=5.0,
                                  write_capacity=10.0)
    log = []
    for step in range(60):
        for i in range(12):
            key = f"job/{step}/{i}"
            log.append((single.try_put_item(key, {"i": i}),
                        sharded.try_put_item(key, {"i": i})))
        log.append((single.try_get_item(f"job/{step}/0"),
                    sharded.try_get_item(f"job/{step}/0")))
        log.append((single.try_update_item(f"job/{step}/1", done=True),
                    sharded.try_update_item(f"job/{step}/1", done=True)))
        clock.advance(0.25)
    counts = [(s.write_count, s.read_count, s.throttled_writes,
               s.throttled_reads) for s in (single, sharded)]
    assert single.throttled_writes > 0
    assert sharded.write_count > 3 * single.write_count
    with pytest.raises(ValueError, match="shards"):
        m.ShardedStateStore(0)
    return log, counts, sorted(sharded.scan("job/1/")), \
        [sharded.shards.index(sharded.shard_for(f"k{i}")) for i in range(32)]


def _elastic(m):
    """Provisioner decisions and seeded provisioning delays."""
    out = []
    for policy in (m.ScalingPolicy.none(2), m.ScalingPolicy.limited(3),
                   m.ScalingPolicy.unlimited(idle_timeout_s=30.0)):
        p = m.Provisioner(policy, m.ProvisioningModel(), seed=7)
        out.append([p.launch_count(q, i, pr, t) for q in (0, 3, 9)
                    for i in (0, 1) for pr in (0, 2) for t in (0, 2, 4)])
        out.append([p.should_terminate(s, t) for s in (10.0, 700.0)
                    for t in (0, 2, 5)])
        out.append([p.provisioning_delay() for _ in range(20)])
    return out


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _market, _faults, _traffic, _policies, _statestores, _elastic)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_copy_matches_reference(name):
    scenario = SCENARIOS[name]
    assert scenario(IMPLS["port"]) == scenario(IMPLS["reference"])


def test_copies_import_nothing_of_the_reference():
    for mod in (t_clock, t_elastic, t_market, t_sched, t_sec, t_faults,
                t_loadgen):
        assert mod.__name__.startswith("repro_torch.")
    assert t_market.ComputePricing.__module__ == "repro_torch.core.cost"
    assert t_sec.Clock is t_clock.Clock and t_sched.Clock is t_clock.Clock
    assert t_sched.PolicyEngine is t_sec.PolicyEngine
    assert t_sched.KottaService.__module__ == "repro_torch.core.scheduler"
