"""Elastic provisioning policies (paper §IV-C, §V-B, §VII-C).

The three scaling strategies evaluated in Table VII-C are all instances of one
``ScalingPolicy``:

- *No scaling*:     ``ScalingPolicy(min_nodes=N, max_nodes=N)``
- *Limited*:        ``ScalingPolicy(min_nodes=0, max_nodes=M)``
- *Unlimited*:      ``ScalingPolicy(min_nodes=0, max_nodes=None)``

``Provisioner.desired_change`` implements the paper's rule: "CLOUD KOTTA
provisions additional instances when there are pending jobs in the queues",
and terminates instances that have idled past ``idle_timeout_s`` (keeping
``min_nodes`` alive; the dev pool keeps ≥1 reliable on-demand node).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ScalingPolicy:
    min_nodes: int = 0
    max_nodes: Optional[int] = None  # None = unlimited
    idle_timeout_s: float = 600.0
    # market model: "on_demand" (reliable) or "spot" (preemptible)
    market: str = "spot"
    bid_fraction: float = 1.0  # bid = fraction × on-demand price

    @classmethod
    def none(cls, nodes: int, **kw) -> "ScalingPolicy":
        return cls(min_nodes=nodes, max_nodes=nodes, **kw)

    @classmethod
    def limited(cls, max_nodes: int, **kw) -> "ScalingPolicy":
        return cls(min_nodes=0, max_nodes=max_nodes, **kw)

    @classmethod
    def unlimited(cls, **kw) -> "ScalingPolicy":
        return cls(min_nodes=0, max_nodes=None, **kw)


@dataclass(frozen=True)
class ProvisioningModel:
    """Instance acquisition latency (paper §VII-C: avg 7:39, peak 30:00)."""

    base_delay_s: float = 300.0
    jitter_s: float = 300.0            # uniform extra
    volatility_prob: float = 0.03      # spot-market stall
    volatility_delay_s: float = 1500.0

    def sample(self, rng: random.Random) -> float:
        d = self.base_delay_s + rng.uniform(0.0, self.jitter_s)
        if rng.random() < self.volatility_prob:
            d += rng.uniform(0.0, self.volatility_delay_s)
        return d


class Provisioner:
    """Pure decision logic shared by the DES and the threaded runtime."""

    def __init__(self, policy: ScalingPolicy,
                 model: ProvisioningModel | None = None,
                 seed: int = 0):
        self.policy = policy
        self.model = model or ProvisioningModel()
        self.rng = random.Random(seed)

    def launch_count(self, pending_jobs: int, idle: int, provisioning: int,
                     total: int) -> int:
        """How many new instances to request right now."""
        deficit = pending_jobs - idle - provisioning
        floor_deficit = self.policy.min_nodes - total - provisioning
        want = max(deficit, floor_deficit, 0)
        if self.policy.max_nodes is not None:
            want = min(want, self.policy.max_nodes - total - provisioning)
        return max(want, 0)

    def should_terminate(self, idle_for_s: float, total: int) -> bool:
        if total <= self.policy.min_nodes:
            return False
        return idle_for_s >= self.policy.idle_timeout_s

    def provisioning_delay(self) -> float:
        return self.model.sample(self.rng)
