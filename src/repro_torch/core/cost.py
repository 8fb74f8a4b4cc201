"""Storage and instance pricing (paper §V, §VII-B, §VII-E), the part of the
reference's ``repro/core/cost.py`` the serve modules read: the tiered KV
store prices HOST and OBJECT residency from :class:`StoragePricing`, the
gateway prices replicas from :class:`ComputePricing`, and the object store
(:mod:`repro_torch.core.lifecycle`) prices its tiers with the monthly
storage functions below. The reference's lifecycle-cost and placement
functions (paper Eqs 1-5, Table III) are not copied yet.

Sizes are decimal GB, as in the paper.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class StoragePricing:
    """2016-era AWS storage prices (paper Table III / Fig 2)."""

    # S3-Standard tiered $/GB-month: first 1 TB, next 49 TB, beyond.
    s3_std_tiers: tuple[tuple[float, float], ...] = (
        (1_000.0, 0.0300),
        (49_000.0, 0.0295),
        (math.inf, 0.0290),
    )
    s3_ia_per_gb_month: float = 0.0125
    glacier_per_gb_month: float = 0.0070
    ebs_per_gb_month: float = 0.1000          # gp2, for the static-EBS strawman
    glacier_free_monthly_frac: float = 0.05   # 5% of stored data/month free
    glacier_retrieval_hours: float = 4.0      # paper: avg retrieval time
    glacier_retrieval_per_gb_hour: float = 0.011  # $ per GB/hr of peak rate
    inter_region_transfer_per_gb: float = 0.020   # paper ref [10]
    s3_request_per_10k: float = 0.004             # noted as negligible


@dataclass(frozen=True)
class ComputePricing:
    """2016-era EC2 prices for the instance types in §VII."""

    on_demand_per_hour: dict[str, float] = field(default_factory=lambda: {
        "m4.xlarge": 0.239,   # §VII-D throughput experiment
        "c4.8xlarge": 1.675,  # §VII-E cost-aware provisioning
        "r3.8xlarge": 2.660,
    })
    # Long-run average spot discount observed in the paper's Table VII-C
    # ($10.26 spot vs $74.57 on-demand for the same node-hours).
    typical_spot_fraction: float = 0.138


def s3_std_monthly(gb: float, pricing: StoragePricing | None = None) -> float:
    """Tiered S3-Standard $/month for ``gb`` stored."""
    p = pricing or StoragePricing()
    remaining, cost = gb, 0.0
    for tier_gb, rate in p.s3_std_tiers:
        take = min(remaining, tier_gb)
        cost += take * rate
        remaining -= take
        if remaining <= 0:
            break
    return cost


def s3_ia_monthly(gb: float, pricing: StoragePricing | None = None) -> float:
    p = pricing or StoragePricing()
    return gb * p.s3_ia_per_gb_month


def glacier_monthly(gb: float, pricing: StoragePricing | None = None) -> float:
    p = pricing or StoragePricing()
    return gb * p.glacier_per_gb_month
