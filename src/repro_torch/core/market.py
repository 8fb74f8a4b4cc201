"""Spot-market model (paper §IV-C, §V-B, §VII-E).

Generates deterministic, seeded price traces per (region, AZ, instance type)
that qualitatively match 2016-era EC2 spot behaviour: prices hover at a
fraction of on-demand with mean reversion, plus occasional sharp spikes above
on-demand local to a single AZ ("spot market volatility", §VII-C). The traces
drive:

- revocation of preemptible workers (price crosses the bid),
- the Fig-7 cost-aware placement comparison across 10 AZs in 4 regions.

The adaptation note: on a TPU fleet the same object models preemptible slice
reclamation; "AZ" maps to a pod/cell and "region" to a datacenter.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field

import numpy as np

from .cost import ComputePricing


@dataclass(frozen=True)
class AvailabilityZone:
    region: str
    name: str  # e.g. "us-east-1a"


# The paper's experiment: ten AZs spread across four regions.
DEFAULT_ZONES: tuple[AvailabilityZone, ...] = (
    AvailabilityZone("us-east-1", "us-east-1a"),
    AvailabilityZone("us-east-1", "us-east-1b"),
    AvailabilityZone("us-east-1", "us-east-1d"),
    AvailabilityZone("us-west-2", "us-west-2a"),
    AvailabilityZone("us-west-2", "us-west-2b"),
    AvailabilityZone("us-west-2", "us-west-2c"),
    AvailabilityZone("eu-west-1", "eu-west-1a"),
    AvailabilityZone("eu-west-1", "eu-west-1b"),
    AvailabilityZone("ap-southeast-1", "ap-southeast-1a"),
    AvailabilityZone("ap-southeast-1", "ap-southeast-1b"),
)


def _zone_seed(seed: int, zone: AvailabilityZone, instance_type: str) -> int:
    h = hashlib.sha256(f"{seed}:{zone.region}:{zone.name}:{instance_type}".encode())
    return int.from_bytes(h.digest()[:8], "big")


@dataclass
class SpotMarket:
    """Hourly spot-price traces with mean reversion and AZ-local spikes."""

    seed: int = 0
    pricing: ComputePricing = field(default_factory=ComputePricing)
    zones: tuple[AvailabilityZone, ...] = DEFAULT_ZONES
    base_fraction: float = 0.138      # long-run spot/on-demand ratio (Table VII-C)
    volatility: float = 0.25          # per-step lognormal sigma
    reversion: float = 0.20           # pull toward base each hour
    spike_prob: float = 0.01          # per-hour probability of an AZ spike
    spike_mult: tuple[float, float] = (2.0, 12.0)  # spike height ×on-demand base frac
    spike_duration_h: tuple[int, int] = (1, 5)
    # Revocation notice window (the EC2 2-minute spot warning): a consumer
    # polling ``notice`` learns ``notice_s`` seconds ahead that the price is
    # about to cross its bid, long enough to evacuate state gracefully.
    notice_s: float = 120.0

    def on_demand_price(self, instance_type: str) -> float:
        return self.pricing.on_demand_per_hour[instance_type]

    def trace(self, zone: AvailabilityZone, instance_type: str,
              hours: int) -> np.ndarray:
        """Deterministic hourly price trace of length ``hours``."""
        rng = np.random.default_rng(_zone_seed(self.seed, zone, instance_type))
        od = self.on_demand_price(instance_type)
        base = od * self.base_fraction * float(rng.uniform(0.6, 1.6))
        log_p = math.log(base)
        prices = np.empty(hours)
        spike_left, spike_level = 0, 0.0
        for t in range(hours):
            log_p += self.reversion * (math.log(base) - log_p)
            log_p += self.volatility * float(rng.standard_normal())
            p = math.exp(log_p)
            if spike_left > 0:
                p = max(p, spike_level)
                spike_left -= 1
            elif rng.random() < self.spike_prob:
                spike_left = int(rng.integers(*self.spike_duration_h))
                spike_level = base * float(rng.uniform(*self.spike_mult))
            prices[t] = min(p, od * 10.0)  # EC2 caps bids at 10x on-demand
        return prices

    def price(self, zone: AvailabilityZone, instance_type: str, t_hours: float) -> float:
        idx = max(0, int(t_hours))
        return float(self.trace(zone, instance_type, idx + 1)[idx])

    def cheapest_zone(self, instance_type: str, t_hours: float,
                      zones: tuple[AvailabilityZone, ...] | None = None,
                      ) -> tuple[AvailabilityZone, float]:
        zs = zones or self.zones
        best = min(zs, key=lambda z: self.price(z, instance_type, t_hours))
        return best, self.price(best, instance_type, t_hours)

    def revoked(self, zone: AvailabilityZone, instance_type: str,
                bid: float, t_hours: float) -> bool:
        """True if the market price exceeds the bid at time t."""
        return self.price(zone, instance_type, t_hours) > bid

    def notice(self, zone: AvailabilityZone, instance_type: str,
               bid: float, t_hours: float) -> bool:
        """Revocation notice: the price will exceed ``bid`` ``notice_s``
        seconds from ``t_hours``. The trace is deterministic, so the notice
        is exact — a consumer that polls every round sees it fire exactly
        one window ahead of :meth:`revoked` flipping true."""
        return self.revoked(zone, instance_type, bid,
                            t_hours + self.notice_s / 3600.0)
