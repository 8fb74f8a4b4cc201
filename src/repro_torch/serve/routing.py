"""Prefix-affinity fleet routing over the gateway's replica pool.

Cloud Kotta's execution model moves work to where the data already is
(PAPER.md §IV) — here the "data" is KV-cache pages. Each replica
advertises a radix fingerprint of its :class:`~repro_torch.serve.paging.PrefixCache`
(``PrefixCache.fingerprint()``, a set of namespace-salted chain hashes, one
per cached page-granular prefix) and the router scores every queued request
against every live replica: matched prefix pages × page_size is the prefill
token count the fleet would NOT have to recompute if the request lands
there. Dispatch picks the best-affinity replica, falling back to
least-loaded when nothing matches, with a **load-imbalance cap** so a hot
tenant's affinity can't starve one replica while the rest idle.

The router never sees token content — only hashes — and a hash collision
can at worst misroute a request (a perf wobble): page aliasing is decided
by the replica's own namespace-scoped radix walk at admission, never here.

The router is also the fleet's **health authority**: replicas report a
heartbeat plus their modelled per-decode-step latency every gateway round
(virtual-clock time), and :meth:`FleetRouter.health` classifies each as

- ``up`` — heartbeating, latency in line with the fleet;
- ``degraded`` — heartbeating but a straggler: its latency EMA exceeds
  ``straggler_factor`` × the median of the *other* replicas' EMAs
  (leave-one-out, so one straggler cannot drag the baseline up with it);
- ``quarantined`` — no heartbeat for ``heartbeat_timeout_s``.

The gateway stops placing new work (dispatch, handoffs, evacuations) on
anything not ``up`` and drains queued-but-unstarted work off it; states
recover on their own when heartbeats return / latency normalizes.

Fingerprints also interlock with the storage hierarchy
(:mod:`repro_torch.serve.kv_store`): a request whose prefix is already
device-resident somewhere (``best_match_tokens`` ≥ the demoted match)
skips the tiered restore entirely and routes on affinity, and a
completed restore (``engine.restore_pages``) re-registers the prefix in
the landing replica's radix cache, so the next fingerprint delta
advertises it fleet-wide.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field

from .paging import chain_hashes
from .telemetry import RegistryDict

HEALTH_UP = "up"
HEALTH_DEGRADED = "degraded"
HEALTH_QUARANTINED = "quarantined"


@dataclass
class ReplicaView:
    """Router-side snapshot of one dispatch target for a scoring round.

    ``load`` counts committed work (live + queued-this-round) and is bumped
    by the caller after each dispatch so one round's decisions see each
    other; ``fingerprint`` is immutable within a round (registration only
    happens later, at admission).
    """

    replica_id: int
    open_slots: int
    load: int
    page_size: int
    fingerprint: frozenset = field(default_factory=frozenset)


@dataclass(frozen=True)
class RouteDecision:
    replica_id: int
    matched_tokens: int
    reason: str     # "affinity" | "least_loaded" | "imbalance_cap" | "blind"


class FleetRouter:
    """Scores queued requests against replica fingerprints.

    Modes:
      - ``affinity``: best matched-prefix-token replica among those within
        ``imbalance_cap`` of the least-loaded; least-loaded when no replica
        matches any prefix page.
      - ``least_loaded``: most open slots (the pre-router gateway behavior).
      - ``blind``: round-robin, ignoring both cache state and load — the
        bench baseline for what affinity buys.

    ``window`` bounds the gateway's affinity lookahead: how many
    SLA-interchangeable jobs at the queue head it may scan for one whose
    prefix is resident on the currently-free capacity (the router itself
    is stateless per call; the gateway owns the queue scan).
    """

    MODES = ("affinity", "least_loaded", "blind")

    def __init__(self, mode: str = "affinity", imbalance_cap: int = 4,
                 window: int = 8, *, heartbeat_timeout_s: float = 10.0,
                 straggler_factor: float = 3.0, health_alpha: float = 0.5):
        if mode not in self.MODES:
            raise ValueError(f"routing mode must be one of {self.MODES}, got {mode!r}")
        if imbalance_cap < 1:
            raise ValueError(f"imbalance_cap must be >= 1, got {imbalance_cap}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if heartbeat_timeout_s <= 0:
            raise ValueError(f"heartbeat_timeout_s must be > 0, got "
                             f"{heartbeat_timeout_s}")
        if straggler_factor <= 1.0:
            raise ValueError(f"straggler_factor must be > 1, got "
                             f"{straggler_factor}")
        self.mode = mode
        self.imbalance_cap = imbalance_cap
        self.window = window
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.health_alpha = health_alpha
        self._rr = 0
        # replica_id -> [last_heartbeat_s, decode-step latency EMA | None]
        self._health: dict[int, list] = {}
        self.stats = {"affinity": 0, "least_loaded": 0, "blind": 0,
                      "imbalance_cap": 0, "matched_tokens": 0}

    def bind_registry(self, registry) -> None:
        """Swap ``stats`` for a write-through view over ``registry`` series
        (``kotta_routing_decisions_total{reason=...}`` plus matched-token
        counter). Call sites keep mutating ``stats`` as a plain dict;
        totals accumulated before binding carry into the series."""
        decisions = registry.counter(
            "kotta_routing_decisions_total",
            "Dispatch routing decisions by outcome", ("reason",))
        matched = registry.counter(
            "kotta_routing_matched_tokens_total",
            "Prefill tokens matched to resident prefix pages by routing")
        rd = RegistryDict()
        for reason in ("affinity", "least_loaded", "blind", "imbalance_cap"):
            rd.bind(reason, decisions, initial=self.stats[reason],
                    reason=reason)
        rd.bind("matched_tokens", matched,
                initial=self.stats["matched_tokens"])
        self.stats = rd

    # -- health --------------------------------------------------------------
    def heartbeat(self, replica_id: int, now: float,
                  decode_step_s: float | None = None) -> None:
        """One replica's liveness report for this round. ``decode_step_s``
        is its observed per-decode-step latency (straggler signal); EMA'd
        with ``health_alpha`` so a cleared straggler recovers within a few
        rounds instead of instantly (or never)."""
        ent = self._health.setdefault(replica_id, [now, None])
        ent[0] = now
        if decode_step_s is not None:
            a = self.health_alpha
            ent[1] = decode_step_s if ent[1] is None \
                else (1 - a) * ent[1] + a * decode_step_s

    def forget(self, replica_id: int) -> None:
        """Drop a retired replica's health record (replica ids are never
        reused, so a stale record would only leak)."""
        self._health.pop(replica_id, None)

    def health(self, replica_id: int, now: float) -> str:
        """``up`` / ``degraded`` / ``quarantined``. A replica that never
        heartbeat is ``up``: fresh launches owe nothing yet."""
        ent = self._health.get(replica_id)
        if ent is None:
            return HEALTH_UP
        if now - ent[0] > self.heartbeat_timeout_s:
            return HEALTH_QUARANTINED
        if ent[1] is not None:
            # Leave-one-out: compare against the median of the OTHER
            # replicas' latency EMAs, so a lone straggler in a two-replica
            # fleet is still 'slower than everyone else'.
            others = [e[1] for rid, e in self._health.items()
                      if rid != replica_id and e[1] is not None
                      and now - e[0] <= self.heartbeat_timeout_s]
            if others and ent[1] > self.straggler_factor \
                    * statistics.median(others):
                return HEALTH_DEGRADED
        return HEALTH_UP

    def healths(self, now: float) -> dict[int, str]:
        return {rid: self.health(rid, now) for rid in self._health}

    # -- scoring -------------------------------------------------------------
    @staticmethod
    def _match_tokens(prompt, namespace, view: ReplicaView) -> int:
        """Prefill tokens ``view``'s cache already holds for this prompt:
        consecutive chain-hash hits from the root (the fingerprint is
        prefix-closed, so the first miss ends the cached chain)."""
        hits = 0
        for h in chain_hashes(prompt, view.page_size, namespace):
            if h not in view.fingerprint:
                break
            hits += 1
        return hits * view.page_size

    def best_match_tokens(self, prompt, namespace, views) -> int:
        """Best cached-token count across the fleet (admission feasibility
        wants "what will the winner skip", not who the winner is)."""
        return max((self._match_tokens(prompt, namespace, v) for v in views),
                   default=0)

    # -- routing -------------------------------------------------------------
    def route(self, prompt, namespace, views) -> RouteDecision | None:
        """Pick a dispatch target among ``views`` (replicas with an open
        slot). Returns None when ``views`` is empty."""
        views = [v for v in views if v.open_slots > 0]
        if not views:
            return None

        if self.mode == "blind":
            v = views[self._rr % len(views)]
            self._rr += 1
            self.stats["blind"] += 1
            return RouteDecision(v.replica_id, 0, "blind")

        least = min(views, key=lambda v: (v.load, v.replica_id))
        if self.mode == "least_loaded":
            self.stats["least_loaded"] += 1
            return RouteDecision(least.replica_id, 0, "least_loaded")

        # affinity: best matched tokens, load-capped against the minimum.
        min_load = least.load
        scored = [(self._match_tokens(prompt, namespace, v), v) for v in views]
        best_tokens, best = max(scored, key=lambda t: (t[0], -t[1].load,
                                                       -t[1].replica_id))
        if best_tokens <= 0:
            self.stats["least_loaded"] += 1
            return RouteDecision(least.replica_id, 0, "least_loaded")
        if best.load - min_load > self.imbalance_cap:
            # The affinity winner is already carrying imbalance_cap more
            # work than the idlest replica: spill to the best-matching
            # replica that is still within the cap (possibly zero match).
            capped = [(t, v) for t, v in scored
                      if v.load - min_load <= self.imbalance_cap]
            cap_tokens, cap_v = max(capped, key=lambda t: (t[0], -t[1].load,
                                                           -t[1].replica_id))
            self.stats["imbalance_cap"] += 1
            self.stats["matched_tokens"] += cap_tokens
            return RouteDecision(cap_v.replica_id, cap_tokens, "imbalance_cap")
        self.stats["affinity"] += 1
        self.stats["matched_tokens"] += best_tokens
        return RouteDecision(best.replica_id, best_tokens, "affinity")


class FingerprintTracker:
    """Per-replica fingerprint mirrors fed by PrefixCache epoch deltas.

    ``PrefixCache.fingerprint()`` walks the whole radix index — fine once,
    wasteful every dispatch round when almost nothing changed. The tracker
    keeps one mirrored hash set per replica and advances it with
    :meth:`~repro_torch.serve.paging.PrefixCache.fingerprint_delta` (O(churn)
    since last round); it falls back to a full snapshot only on first
    contact or when the cache's journal has outrun the mirror. The mirror
    is exact, not approximate: delta-fed and snapshot-fed routers make
    identical decisions (tested), because replaying the journal reproduces
    the walk set-for-set.
    """

    def __init__(self):
        self._state: dict[int, tuple[int, set]] = {}   # id -> (epoch, fp)
        self.stats = {"snapshots": 0, "deltas": 0, "delta_hashes": 0}

    def refresh(self, replica_id: int, cache) -> frozenset:
        """Current fingerprint of ``cache``, advanced incrementally."""
        known = self._state.get(replica_id)
        if known is not None:
            epoch, fp = known
            delta = cache.fingerprint_delta(epoch)
            if delta is not None:
                new_epoch, added, removed = delta
                fp |= added
                fp -= removed
                self._state[replica_id] = (new_epoch, fp)
                self.stats["deltas"] += 1
                self.stats["delta_hashes"] += len(added) + len(removed)
                return frozenset(fp)
        fp = set(cache.fingerprint())
        self._state[replica_id] = (cache.epoch, fp)
        self.stats["snapshots"] += 1
        return frozenset(fp)

    def forget(self, replica_id: int) -> None:
        self._state.pop(replica_id, None)
