"""Fault-injection harness for the serving fleet.

Cloud Kotta treats worker loss as an expected event, not an outage
(§IV-B, §V): spot nodes are revoked by the market, in-flight jobs return
to the queue, and retries are idempotent. A robustness claim like that is
only as good as the failures it was exercised against — one market trace
revokes one replica one way. :class:`FaultInjector` turns the failure
space into data: a schedule of :class:`FaultEvent`\\ s on the gateway's
:class:`~repro_torch.core.clock.VirtualClock`, either **scripted** (fixed
times/targets — the bench's reproducible fault schedule) or
**seeded-random** (:meth:`FaultInjector.random`, Poisson arrivals per
fault class — the chaos tests' coverage sweep).

Fault classes (``FaultEvent.kind``):

- ``crash`` — the replica dies NOW, no notice: the hard-loss baseline
  (requeue + backoff is the only recovery).
- ``revoke_notice`` — a revocation notice with ``duration_s`` of warning
  (default: the market's ``notice_s``), the EC2 2-minute-warning model;
  the gateway's notice-window KV evacuation
  (``engine.export(..., reason=EVACUATE)`` on the unified
  :class:`~repro_torch.serve.kv_store.PageResidency` surface) gets to race
  the deadline.
- ``straggler`` — the replica's modelled step latency is multiplied by
  ``magnitude`` for ``duration_s``; the router's leave-one-out straggler
  detection should mark it DEGRADED and drain it.
- ``heartbeat_loss`` — the replica stops heartbeating for ``duration_s``;
  the router should QUARANTINE it until the heartbeat returns.

The injector is passive: the gateway polls :meth:`pop_due` once per round
with the current virtual time and applies what fired. ``target`` indexes
the gateway's live decode-capable replicas (sorted by id, modulo count),
so schedules stay meaningful whatever the fleet size; an event with no
live target is recorded in ``skipped`` rather than silently dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KINDS = ("crash", "revoke_notice", "straggler", "heartbeat_loss")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``at_s`` is absolute virtual-clock seconds."""

    at_s: float
    kind: str
    target: int = 0             # index into live decode replicas (mod count)
    duration_s: float = 0.0     # straggler / heartbeat_loss window; for
                                # revoke_notice, the notice length (0 = the
                                # market's default)
    magnitude: float = 4.0      # straggler latency multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, "
                             f"got {self.kind!r}")


@dataclass
class FaultInjector:
    """An ordered fault schedule the gateway consumes round by round."""

    schedule: tuple[FaultEvent, ...] = ()
    fired: list[FaultEvent] = field(default_factory=list)
    skipped: list[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.schedule = tuple(sorted(self.schedule, key=lambda e: e.at_s))
        self._idx = 0

    def pop_due(self, now: float) -> list[FaultEvent]:
        """Events whose time has come; each is returned exactly once."""
        due = []
        while self._idx < len(self.schedule) \
                and self.schedule[self._idx].at_s <= now:
            due.append(self.schedule[self._idx])
            self._idx += 1
        return due

    @property
    def pending(self) -> int:
        return len(self.schedule) - self._idx

    @classmethod
    def random(cls, seed: int, horizon_s: float, *,
               crash_rate_h: float = 0.5,
               revoke_rate_h: float = 1.0,
               straggler_rate_h: float = 1.0,
               heartbeat_loss_rate_h: float = 0.5,
               notice_s: float = 0.0,
               duration_s: tuple[float, float] = (5.0, 30.0),
               magnitude: tuple[float, float] = (2.0, 8.0),
               max_targets: int = 8) -> "FaultInjector":
        """Seeded Poisson fault schedule over ``[0, horizon_s)``.

        Rates are per *hour* of virtual time, per fault class. The same
        seed always produces the same schedule (``np.random.default_rng``),
        which is what lets the chaos tests pin three seeds in CI and stay
        deterministic. ``notice_s`` = 0 defers to the market's notice
        window at fire time.
        """
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for kind, rate_h in (("crash", crash_rate_h),
                             ("revoke_notice", revoke_rate_h),
                             ("straggler", straggler_rate_h),
                             ("heartbeat_loss", heartbeat_loss_rate_h)):
            if rate_h <= 0:
                continue
            t = 0.0
            while True:
                t += float(rng.exponential(3600.0 / rate_h))
                if t >= horizon_s:
                    break
                dur = float(rng.uniform(*duration_s))
                if kind == "revoke_notice":
                    dur = notice_s
                events.append(FaultEvent(
                    at_s=t, kind=kind,
                    target=int(rng.integers(0, max_targets)),
                    duration_s=dur,
                    magnitude=float(rng.uniform(*magnitude))))
        return cls(schedule=tuple(events))
