"""Cost-aware placement policy (paper §VII-E) as a scheduler component, a
copy of the reference's ``repro/core/placement.py``.

Chooses where to provision the next instance for a job, accounting for
spot price across zones AND the egress cost of moving the job's data out of
its home region (Eqs (4)-(5)): three search scopes, one zone
(``"az"``), the data's region (``"region"``) or every zone (``"global"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .cost import StoragePricing, placement_cost
from .market import AvailabilityZone, SpotMarket


@dataclass(frozen=True)
class PlacementDecision:
    zone: AvailabilityZone
    hourly_price: float
    expected_total: float
    cross_region: bool


class PlacementPolicy:
    """scope: "az" | "region" | "global" — the paper's three search scopes."""

    def __init__(self, market: SpotMarket, instance_type: str,
                 scope: str = "global",
                 pricing: Optional[StoragePricing] = None):
        if scope not in ("az", "region", "global"):
            raise ValueError(scope)
        self.market = market
        self.instance_type = instance_type
        self.scope = scope
        self.pricing = pricing or StoragePricing()

    def candidates(self, data_region: str) -> Sequence[AvailabilityZone]:
        zones = self.market.zones
        if self.scope == "az":
            return zones[:1]
        if self.scope == "region":
            return tuple(z for z in zones if z.region == data_region)
        return zones

    def place(self, *, data_region: str, est_hours: float,
              data_down_gb: float, data_up_gb: float,
              t_hours: float = 0.0) -> PlacementDecision:
        """Pick the zone minimizing P_total = P_i·h + P_transfer (Eq 4)."""
        best: Optional[PlacementDecision] = None
        for zone in self.candidates(data_region):
            price = self.market.price(zone, self.instance_type, t_hours)
            same = zone.region == data_region
            total = placement_cost(price, est_hours, data_down_gb,
                                   data_up_gb, same, self.pricing)
            if best is None or total < best.expected_total:
                best = PlacementDecision(zone, price, total, not same)
        assert best is not None
        return best
