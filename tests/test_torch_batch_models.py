"""The port's batch cost models and simulator against the reference's:
``core/cost.py``'s lifecycle and placement functions (paper Eqs 1-5, Table
III), ``core/placement.py`` and ``core/simulator.py`` (Table VII-C).

- Table III's storage column exactly, and every strategy's annual cost
  equal to the reference's over a grid of sizes, active fractions and
  recalls; Glacier's free quota; placement cost in and across regions;
- ``PlacementPolicy.place`` equal to the reference's in all three scopes
  over a grid of data regions, hours, GB and start times;
- ``run_table7c`` for seeds 7 and 3 and a revoking spot fleet (bid 0.15 of
  on-demand, seed 3) equal to the reference's field by field, timelines
  and per-job times included; the Table VII-C relations the reference's
  tests hold; determinism;
- the reference's bid-0.05 case (every hourly sweep revokes the fleet) on
  the port alone: its live-instance index and cached price trace finish it
  in seconds, where the reference takes minutes.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

import repro.core.cost as j_cost  # noqa: E402
import repro.core.elastic as j_elastic  # noqa: E402
import repro.core.market as j_market  # noqa: E402
import repro.core.placement as j_place  # noqa: E402
import repro.core.simulator as j_sim  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.cost as t_cost  # noqa: E402
import repro_torch.core.elastic as t_elastic  # noqa: E402
import repro_torch.core.market as t_market  # noqa: E402
import repro_torch.core.placement as t_place  # noqa: E402
import repro_torch.core.simulator as t_sim  # noqa: E402

TEN_TB = 10_000.0  # decimal GB, as the paper uses
POLICIES = ("STD", "IA", "GLACIER", "STD30-IA", "STD30-IA60-GLACIER",
            "STD30-IA60-GL")


@pytest.mark.parametrize("policy,active,expected", [
    ("STD", 0.0, 3546.0),
    ("IA", 0.0, 1500.0),
    ("GLACIER", 0.03, 840.0),
    ("STD30-IA", 0.0, 1670.5),
    ("STD30-IA60-GLACIER", 0.03, 880.259),
    ("STD30-IA60-GLACIER", 0.10, 974.20),
])
def test_table3_storage_column_exact(policy, active, expected):
    got = core.lifecycle_annual_cost(policy, TEN_TB, active).storage_annual
    assert got == pytest.approx(expected, abs=0.01)


@pytest.mark.parametrize("policy", POLICIES)
def test_lifecycle_cost_equals_reference(policy):
    grid = itertools.product((1.0, 500.0, 1_000.0, TEN_TB, 80_000.0),
                             (0.0, 0.001, 0.03, 0.10, 0.5),
                             (0, 1, 4))
    for gb, active, recalls in grid:
        got = t_cost.lifecycle_annual_cost(policy, gb, active, recalls)
        want = j_cost.lifecycle_annual_cost(policy, gb, active, recalls)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), \
            (policy, gb, active, recalls)
    with pytest.raises(ValueError):
        t_cost.lifecycle_annual_cost("S3-ONEZONE", TEN_TB)


def test_lifecycle_access_cost_and_glacier_quota():
    # The reference's reading: $165.0 a year for the one-day bursts at 3%,
    # within 4% of the paper's $169.73 (binary vs decimal GB).
    got = t_cost.lifecycle_annual_cost("STD30-IA60-GLACIER", TEN_TB, 0.03)
    assert got.access_annual == pytest.approx(169.73, rel=0.04)
    assert got.access_hours == 4.0
    # Under 5% a month, pro-rated daily over the 4 h window: free.
    for peak, stored in ((10.0, TEN_TB), (16.0, TEN_TB), (300.0, TEN_TB),
                         (0.0, 0.0), (5.0, 0.0)):
        fee = t_cost.glacier_retrieval_monthly(peak, stored)
        assert fee == j_cost.glacier_retrieval_monthly(peak, stored)
    assert t_cost.glacier_retrieval_monthly(10.0, TEN_TB) == 0.0
    assert t_cost.glacier_retrieval_monthly(300.0, TEN_TB) > 0.0


def test_placement_cost_in_and_across_regions():
    for args in ((1.675, 1.0, 0.0, 0.0), (1.0, 2.5, 5.0, 5.0),
                 (1.0, 1.0, 200.0, 200.0), (0.3, 10.0, 1.0, 30.0)):
        for same in (True, False):
            got = t_cost.placement_cost(*args, same_region_as_data=same)
            assert got == j_cost.placement_cost(*args,
                                                same_region_as_data=same)
    local = t_cost.placement_cost(1.675, 1.0, 0, 0, same_region_as_data=True)
    assert t_cost.placement_cost(1.675, 1.0, 50, 50, True) == local
    for gb, remote_cheaper in ((5.0, True), (200.0, False)):
        remote = t_cost.placement_cost(1.0, 1.0, gb, gb, False)
        assert remote == pytest.approx(1.0 + 2 * gb * 0.02)
        assert (remote < local) == remote_cheaper


def _decision(d):
    return (d.zone.region, d.zone.name, d.hourly_price, d.expected_total,
            d.cross_region)


@pytest.mark.parametrize("scope", ("az", "region", "global"))
def test_placement_policy_equals_reference(scope):
    port = t_place.PlacementPolicy(t_market.SpotMarket(seed=0), "c4.8xlarge",
                                   scope=scope)
    ref = j_place.PlacementPolicy(j_market.SpotMarket(seed=0), "c4.8xlarge",
                                  scope=scope)
    grid = itertools.product(("us-east-1", "us-west-2", "eu-west-1",
                              "ap-southeast-1"), (0.5, 1.0, 6.0),
                             (0.0, 5.0, 500.0), (0.0, 7.0, 100.0))
    regions = set()
    for region, hours, gb, t in grid:
        kw = dict(data_region=region, est_hours=hours, data_down_gb=gb,
                  data_up_gb=gb / 2, t_hours=t)
        got, want = port.place(**kw), ref.place(**kw)
        assert _decision(got) == _decision(want), kw
        if scope == "region":
            assert got.zone.region == region and not got.cross_region
        regions.add(got.zone.region)
    if scope == "global":
        assert len(regions) > 1          # the egress moved some decisions
    with pytest.raises(ValueError):
        t_place.PlacementPolicy(t_market.SpotMarket(), "c4.8xlarge",
                                scope="planet")


def _rows(reports):
    return [dataclasses.asdict(r) for r in reports]


@pytest.mark.parametrize("seed", (7, 3))
def test_table7c_equals_reference(seed):
    port = t_sim.run_table7c(seed)
    ref = j_sim.run_table7c(seed)
    assert _rows(port) == _rows(ref)
    assert [r.policy for r in port] == ["none", "none", "unlimited",
                                        "limited", "limited"]
    assert all(len(r.timeline) > 40 for r in port)


def test_revoking_fleet_equals_reference():
    """Bid 0.15 of on-demand at seed 3: the hourly sweeps revoke 90
    instances and resubmit their jobs; the report is the reference's."""
    reports = [sim.ElasticSimulator(
        el.ScalingPolicy.unlimited(bid_fraction=0.15),
        sim.make_paper_workload(seed=3), seed=3).run()
        for sim, el in ((t_sim, t_elastic), (j_sim, j_elastic))]
    assert _rows(reports[:1]) == _rows(reports[1:])
    assert reports[0].revocations == 90
    assert reports[0].resubmissions >= 1
    assert all(j.done_s is not None for j in reports[0].jobs)


def test_table7c_relations():
    """The reference's Table VII-C relations on the port's rows, and the
    headline: static 40 on demand over unlimited spot ($72.08 / $4.27 at
    the paper's 2016 prices, ~16.9x)."""
    rows = {r.policy + str(r.max_nodes): r for r in core.run_table7c(seed=7)}
    static, elastic = rows["none40"], rows["unlimitedNone"]
    assert static.max_wait_s == 0.0 and static.avg_wait_s == 0.0
    assert elastic.makespan_s <= static.makespan_s * 1.10
    assert 1 - elastic.on_demand_cost / static.on_demand_cost > 0.5
    assert static.on_demand_cost == pytest.approx(72.08, abs=0.01)
    assert elastic.spot_cost == pytest.approx(4.27, abs=0.01)
    assert static.on_demand_cost / elastic.spot_cost >= 16.0
    lim10, lim20 = rows["limited10"], rows["limited20"]
    assert lim10.makespan_s > lim20.makespan_s
    assert lim10.on_demand_cost < lim20.on_demand_cost
    assert lim10.peak_instances <= 10 and lim20.peak_instances <= 20
    for r in rows.values():
        assert all(j.done_s is not None for j in r.jobs)
    jobs = core.make_paper_workload(seed=7)
    assert len(jobs) == 40
    assert all(0.9 <= j.duration_s / 3600 <= 4.3 for j in jobs)
    assert {j.data_gb for j in jobs} <= {1.0, 3.0, 5.0, 7.0, 9.0}


def test_determinism():
    a, b = (core.ElasticSimulator(core.ScalingPolicy.unlimited(),
                                  core.make_paper_workload(seed=7),
                                  seed=7).run() for _ in range(2))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_cached_price_is_the_markets():
    sim = t_sim.ElasticSimulator(core.ScalingPolicy.unlimited(),
                                 core.make_paper_workload(seed=7), seed=5)
    for t in (0.0, 3599.9, 3600.0, 7.5 * 3600, 2.0, 40 * 3600.0, 1.0,
              200 * 3600 + 1.0, 3 * 3600.0):
        assert sim._price(t) == sim.market.price(sim.zone, sim.instance_type,
                                                 t / 3600.0)


def test_low_bid_revokes_every_hour_and_still_finishes():
    """The reference's bid-0.05 case (tests/test_simulator.py), on the port
    alone: every hourly sweep revokes the fleet, for over a thousand
    simulated hours."""
    rep = core.ElasticSimulator(core.ScalingPolicy.unlimited(bid_fraction=0.05),
                                core.make_paper_workload(seed=3), seed=3).run()
    assert all(j.done_s is not None for j in rep.jobs)
    assert rep.revocations > 10_000 and rep.resubmissions > 10_000
    assert rep.makespan_s > 1_000 * 3600.0
