"""Tiered KV-cache hierarchy (device -> host -> object store).

Cloud Kotta's defining storage idea is *tiered data with an archive/restore
queue*: jobs whose inputs sit in ARCHIVE park in ``WAITING_DATA`` until an
async restore completes (PAPER.md §V-A; ``core/scheduler.py`` models this
for batch jobs), and the companion interactive-analytics paper shows that
same tiering is what makes low-latency **resumed** access affordable. This
module applies it to KV pages: a cold conversation's cache should pay
restore *bandwidth*, not re-prefill *FLOPs*.

Three tiers, one page-residency API:

=========  ====================================  =========================
Tier       Medium                                Priced as
=========  ====================================  =========================
DEVICE     the engine's paged HBM pool           (compute-instance rate)
HOST       ``ShippedKV`` CPU tensors in RAM      EBS $/GB-month / 720
OBJECT     serialized blobs (S3-model)           S3-std $/GB-month / 720
=========  ====================================  =========================

:class:`TieredKVStore` owns everything below DEVICE:

- **Demotion.** When a request finishes on an engine with
  ``demote_on_retire`` set, its content pages are exported
  (``reason=DEMOTE``) through the same :meth:`ContinuousBatchingEngine.export`
  gather that cross-replica shipping uses, and land here keyed by
  (namespace, token stream). HOST is capacity-bounded: overflow spills the
  LRU entry (by last-touch, virtual-clock time) down to OBJECT, where the
  arrays are genuinely serialized to bytes. A per-tenant storage budget is
  enforced with a typed :class:`~repro_torch.serve.admission.StorageBudgetExceeded`
  — demotion *refuses* past the budget, it never silently drops or
  over-bills. int8 scale pages ride inside the payload's structural
  ``content`` dict, so token identity survives demote/restore for f32 and
  int8 pools alike.

- **Async restore.** A radix hit on a demoted stream
  (:meth:`TieredKVStore.match`) yields a :class:`RestoreTicket` whose
  ``ready_at`` models the tier's restore latency on the gateway's
  virtual clock (bytes / tier bandwidth, plus a base fetch latency for
  OBJECT — the Glacier-style retrieval delay). The bandwidths are
  parameters of that cost model, not measurements of any device or link. The gateway parks the job
  ``RESTORE_PENDING`` — exactly mirroring the batch scheduler's
  ``WAITING_DATA`` — and on completion lands the payload back in the
  device pool via :meth:`ContinuousBatchingEngine.restore_pages` (pages
  free-but-hittable), then admits with **zero re-prefill**. An entry
  evicted while its ticket was in flight makes :meth:`complete_restore`
  return ``None``: the job falls back to plain re-prefill, no crash.

- **Accounting.** :meth:`accrue` integrates GB-hours per (tier, tenant)
  against :class:`repro_torch.core.cost.StoragePricing` rates, feeding the
  gateway's cost counters and the ``MetricsRegistry`` families bound by
  :meth:`bind_registry`.

Demoted pages stay tenant-namespaced exactly like resident ones: entries
are keyed by the prefix cache's (tenant, data-zone) namespace and
:meth:`match` never crosses it — the paper's §VI isolation carried down
one more tier.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch

from ..core.cost import StoragePricing

from .admission import StorageBudgetExceeded
from .engine import ExportReason, ShippedKV  # noqa: F401  (re-exported API)
from .paging import EvictionEvent
from .telemetry import RegistryDict

__all__ = ["Tier", "ExportReason", "PageResidency", "RestoreTicket",
           "TieredKVStore", "StorageBudgetExceeded", "EvictionEvent"]


class Tier(str, enum.Enum):
    DEVICE = "device"
    HOST = "host"
    OBJECT = "object"


@runtime_checkable
class PageResidency(Protocol):
    """The residency surface every page transport goes through.

    An engine satisfies this structurally: ``export`` gathers a request's
    content pages off the device (reason-tagged: handoff / evacuate /
    demote), ``import_pages`` revives a payload as a *live* request,
    ``restore_pages`` lands a payload as *free-but-hittable* cache pages,
    and ``page_nbytes`` is the per-page sizing truth (data + scale leaves)
    that ship budgets and tier capacities multiply. Cross-replica shipping
    and cross-tier demotion are two transports behind this one API.
    """

    def export(self, slot: int | None = None, *, rid: object = None,
               reason: ExportReason = ExportReason.HANDOFF) -> ShippedKV:
        ...

    def import_pages(self, payload: ShippedKV) -> int:
        ...

    def restore_pages(self, payload: ShippedKV) -> list:
        ...

    def page_nbytes(self) -> int:
        ...


@dataclass(frozen=True)
class RestoreTicket:
    """An in-flight async restore: redeem via ``complete_restore`` once the
    gateway clock passes ``ready_at``. ``tokens`` is the stored stream
    length the restore makes alias-able (what admission will not
    re-prefill); ``tier`` is where the bytes are coming from."""

    key: tuple
    rid: object                 # job that requested the restore
    tier: Tier
    requested_at: float
    ready_at: float
    nbytes: int
    tokens: int


@dataclass
class _Entry:
    """One demoted token stream resident in HOST or OBJECT."""

    key: tuple                  # (namespace, token-stream tuple)
    tenant: str
    namespace: object
    tier: Tier
    nbytes: int
    page_size: int
    stream_len: int
    last_touch: float
    payload: ShippedKV | None = None      # HOST: the live payload
    blobs: dict | None = None             # OBJECT: name -> (bytes, dtype, shape)


def _serialize(content: dict) -> dict:
    """OBJECT-tier representation: each CPU tensor's raw bytes plus its
    dtype's name and its shape, enough to rebuild it bit for bit (bf16
    included, which numpy cannot hold)."""
    return {name: (t.contiguous().reshape(-1).view(torch.uint8).numpy()
                   .tobytes(), str(t.dtype).removeprefix("torch."),
                   tuple(t.shape))
            for name, t in content.items()}


def _deserialize(blobs: dict) -> dict:
    return {name: torch.frombuffer(bytearray(b), dtype=torch.uint8)
            .view(getattr(torch, d)).reshape(shape)
            for name, (b, d, shape) in blobs.items()}


class TieredKVStore:
    """Demotion, async restore and GB-hour accounting below the device tier.

    ``host_capacity_bytes`` bounds the HOST tier (LRU spills to OBJECT);
    ``object_capacity_bytes`` bounds OBJECT (LRU entries are *dropped* —
    the archive is finite, and a restore racing such a drop falls back to
    re-prefill); ``tenant_budget_bytes`` caps one tenant's total demoted
    footprint across both tiers (typed refusal past it). Restore latency
    is modelled per tier: ``nbytes / *_restore_bytes_per_s`` plus
    ``object_restore_base_s`` for OBJECT fetches. The defaults (2 GB/s
    from HOST, 250 MB/s and 0.5 s from OBJECT) are the reference's
    parameters of that model; they are not measured on any device.
    """

    def __init__(self, *, host_capacity_bytes: int,
                 object_capacity_bytes: int | None = None,
                 tenant_budget_bytes: int | None = None,
                 pricing: StoragePricing | None = None,
                 host_restore_bytes_per_s: float = 2e9,
                 object_restore_bytes_per_s: float = 2.5e8,
                 object_restore_base_s: float = 0.5):
        if host_capacity_bytes < 0:
            raise ValueError(f"host_capacity_bytes must be >= 0, got "
                             f"{host_capacity_bytes}")
        if object_capacity_bytes is not None and object_capacity_bytes < 0:
            raise ValueError(f"object_capacity_bytes must be >= 0, got "
                             f"{object_capacity_bytes}")
        if host_restore_bytes_per_s <= 0 or object_restore_bytes_per_s <= 0:
            raise ValueError("restore bandwidths must be > 0")
        self.host_capacity_bytes = host_capacity_bytes
        self.object_capacity_bytes = object_capacity_bytes
        self.tenant_budget_bytes = tenant_budget_bytes
        self.pricing = pricing or StoragePricing()
        self.host_restore_bytes_per_s = host_restore_bytes_per_s
        self.object_restore_bytes_per_s = object_restore_bytes_per_s
        self.object_restore_base_s = object_restore_base_s
        # $/GB-hour per tier: monthly storage rates over 720 h/month —
        # HOST priced as EBS (RAM standing in for instance-attached
        # storage), OBJECT as the first S3-standard volume tier.
        self.rate_per_gb_hour = {
            Tier.HOST: self.pricing.ebs_per_gb_month / 720.0,
            Tier.OBJECT: self.pricing.s3_std_tiers[0][1] / 720.0,
        }
        self._entries: dict[tuple, _Entry] = {}
        self.host_bytes = 0
        self.object_bytes = 0
        self.tenant_bytes: dict[str, int] = {}
        # GB-hour + $ accrual, integrated on the virtual clock.
        self.gb_hours = {Tier.HOST: 0.0, Tier.OBJECT: 0.0}
        self.cost_by_tier = {Tier.HOST: 0.0, Tier.OBJECT: 0.0}
        self.cost_by_tenant: dict[str, float] = {}
        self.gb_hours_by_tenant: dict[str, dict] = {}
        self._last_accrue: float | None = None
        self.stats: dict = {
            "demotions_host": 0, "demotions_object": 0, "spills": 0,
            "restores_host": 0, "restores_object": 0, "restore_misses": 0,
            "budget_refusals": 0, "object_evictions": 0,
            "eviction_events": 0, "device_evicted_pages": 0,
        }
        self._registry = None

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def tier_of(self, key: tuple) -> Tier | None:
        ent = self._entries.get(key)
        return None if ent is None else ent.tier

    @property
    def usd_total(self) -> float:
        return sum(self.cost_by_tier.values())

    # -- eviction subscription ----------------------------------------------
    def on_eviction(self, event: EvictionEvent) -> None:
        """Subscriber for :attr:`PrefixCache.on_evict`: counts device-tier
        index evictions. Content safety does not depend on this callback —
        finished streams were already exported at retirement — but the
        counters make "pages left the device index" observable, and tests
        assert every evicted page was demoted or refcount-zero free."""
        self.stats["eviction_events"] += 1
        self.stats["device_evicted_pages"] += len(event.pages)

    # -- demotion ------------------------------------------------------------
    def demote(self, payload: ShippedKV, tenant: str, now: float) -> Tier:
        """Park ``payload``'s pages below the device tier; returns where.

        Lands in HOST, spilling LRU HOST entries to OBJECT while over
        ``host_capacity_bytes`` (an entry larger than the whole HOST tier
        goes straight to OBJECT). Raises
        :class:`~repro_torch.serve.admission.StorageBudgetExceeded` when the
        tenant's demoted footprint would exceed its budget — the caller
        sheds/forgoes instead of the store silently dropping pages.
        """
        req = payload.req
        stream = tuple(req.prompt) + tuple(
            payload.tokens[:payload.pos - len(req.prompt)])
        key = (req.namespace, stream)
        nbytes = payload.nbytes
        old = self._entries.pop(key, None)
        if old is not None:
            self._drop_bytes(old)
        budget = self.tenant_budget_bytes
        if budget is not None and \
                self.tenant_bytes.get(tenant, 0) + nbytes > budget:
            if old is not None:     # replacement refused: old copy is gone
                pass
            self.stats["budget_refusals"] += 1
            raise StorageBudgetExceeded(
                f"tenant {tenant!r}: demoting {nbytes}B would exceed its "
                f"{budget}B storage budget "
                f"({self.tenant_bytes.get(tenant, 0)}B already demoted)")
        ent = _Entry(key=key, tenant=tenant, namespace=req.namespace,
                     tier=Tier.HOST, nbytes=nbytes,
                     page_size=payload.page_size, stream_len=len(stream),
                     last_touch=now, payload=payload)
        if nbytes > self.host_capacity_bytes:
            self._spill_entry(ent)          # straight to OBJECT
            self._entries[key] = ent
            self.object_bytes += nbytes
            self.stats["demotions_object"] += 1
        else:
            self._entries[key] = ent
            self.host_bytes += nbytes
            self.stats["demotions_host"] += 1
            self._enforce_host_capacity()
        self.tenant_bytes[tenant] = self.tenant_bytes.get(tenant, 0) + nbytes
        self._enforce_object_capacity()
        return self._entries[key].tier if key in self._entries \
            else Tier.OBJECT

    def _lru(self, tier: Tier) -> _Entry | None:
        cands = [e for e in self._entries.values() if e.tier is tier]
        return min(cands, key=lambda e: e.last_touch) if cands else None

    def _spill_entry(self, ent: _Entry) -> None:
        """HOST -> OBJECT: genuinely serialize the arrays to bytes."""
        ent.blobs = _serialize(ent.payload.content)
        ent.payload.content = None
        ent.tier = Tier.OBJECT

    def _enforce_host_capacity(self) -> None:
        while self.host_bytes > self.host_capacity_bytes:
            victim = self._lru(Tier.HOST)
            if victim is None:
                break
            self._spill_entry(victim)
            self.host_bytes -= victim.nbytes
            self.object_bytes += victim.nbytes
            self.stats["spills"] += 1

    def _enforce_object_capacity(self) -> None:
        cap = self.object_capacity_bytes
        if cap is None:
            return
        while self.object_bytes > cap:
            victim = self._lru(Tier.OBJECT)
            if victim is None:
                break
            del self._entries[victim.key]
            self._drop_bytes(victim)
            self.stats["object_evictions"] += 1

    def _drop_bytes(self, ent: _Entry) -> None:
        if ent.tier is Tier.HOST:
            self.host_bytes -= ent.nbytes
        else:
            self.object_bytes -= ent.nbytes
        t = self.tenant_bytes.get(ent.tenant, 0) - ent.nbytes
        if t <= 0:
            self.tenant_bytes.pop(ent.tenant, None)
        else:
            self.tenant_bytes[ent.tenant] = t

    # -- lookup / restore ----------------------------------------------------
    def match(self, namespace, prompt) -> tuple[tuple, int, Tier] | None:
        """Longest demoted stream (within ``namespace``) that prefixes
        ``prompt`` with at least one full page of alias-able KV. Returns
        ``(key, stream_tokens, tier)`` or ``None``. Never crosses
        namespaces: a tenant's archived pages are as invisible to other
        tenants as its resident ones."""
        best = None
        for key, ent in self._entries.items():
            if ent.namespace != namespace:
                continue
            n = ent.stream_len
            if n > len(prompt) or n < ent.page_size:
                continue
            if tuple(prompt[:n]) != key[1]:
                continue
            if best is None or n > best[1]:
                best = (key, n, ent.tier)
        return best

    def restore_delay_s(self, key: tuple) -> float | None:
        """Modelled restore latency for ``key`` (None when absent) — what
        admission adds to the job's service estimate while it parks."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        if ent.tier is Tier.HOST:
            return ent.nbytes / self.host_restore_bytes_per_s
        return self.object_restore_base_s \
            + ent.nbytes / self.object_restore_bytes_per_s

    def request_restore(self, key: tuple, rid: object,
                        now: float) -> RestoreTicket:
        """Enqueue an async restore of ``key``; the ticket's ``ready_at``
        is ``now`` + the tier's modelled latency. The entry is touched
        (LRU-warms) but NOT pinned: capacity pressure can still evict it
        mid-flight, in which case ``complete_restore`` returns None."""
        ent = self._entries.get(key)
        if ent is None:
            raise KeyError(f"no demoted entry for key {key!r}")
        ent.last_touch = now
        delay = self.restore_delay_s(key)
        return RestoreTicket(key=key, rid=rid, tier=ent.tier,
                             requested_at=now, ready_at=now + delay,
                             nbytes=ent.nbytes, tokens=ent.stream_len)

    def complete_restore(self, ticket: RestoreTicket,
                         now: float | None = None) -> ShippedKV | None:
        """Redeem a due ticket: the entry leaves the store and its payload
        (deserialized for OBJECT) is returned for
        ``engine.restore_pages``. Returns ``None`` when the entry was
        evicted while the restore was in flight — the caller falls back to
        plain re-prefill (restore-racing-eviction is survivable, the
        stream is merely cold again)."""
        if now is not None and now < ticket.ready_at:
            raise ValueError(
                f"restore for {ticket.rid!r} not due until "
                f"t={ticket.ready_at:.3f} (now t={now:.3f})")
        ent = self._entries.pop(ticket.key, None)
        if ent is None:
            self.stats["restore_misses"] += 1
            return None
        self._drop_bytes(ent)
        if ent.tier is Tier.OBJECT:
            ent.payload.content = _deserialize(ent.blobs)
            ent.blobs = None
            self.stats["restores_object"] += 1
        else:
            self.stats["restores_host"] += 1
        return ent.payload

    # -- accounting ----------------------------------------------------------
    def accrue(self, now: float) -> float:
        """Integrate storage GB-hours (per tier, per tenant) since the last
        call at the StoragePricing rates; returns the $ accrued."""
        if self._last_accrue is None:
            self._last_accrue = now
            return 0.0
        dt_h = (now - self._last_accrue) / 3600.0
        self._last_accrue = now
        if dt_h <= 0:
            return 0.0
        total = 0.0
        for ent in self._entries.values():
            gb = ent.nbytes / 1e9
            gbh = gb * dt_h
            usd = gbh * self.rate_per_gb_hour[ent.tier]
            self.gb_hours[ent.tier] += gbh
            self.cost_by_tier[ent.tier] += usd
            self.cost_by_tenant[ent.tenant] = \
                self.cost_by_tenant.get(ent.tenant, 0.0) + usd
            per = self.gb_hours_by_tenant.setdefault(
                ent.tenant, {Tier.HOST: 0.0, Tier.OBJECT: 0.0})
            per[ent.tier] += gbh
            total += usd
        return total

    # -- metrics -------------------------------------------------------------
    def bind_registry(self, registry) -> None:
        """Bind counters for the event stats (write-through RegistryDict,
        same idiom as router/engine) and register a collector that
        refreshes per-tier byte / GB-hour / cost gauges at scrape time."""
        demotions = registry.counter(
            "kotta_kv_store_demotions_total",
            "KV page streams demoted below the device tier", ("tier",))
        restores = registry.counter(
            "kotta_kv_store_restores_total",
            "KV page streams restored toward the device tier", ("tier",))
        events = registry.counter(
            "kotta_kv_store_events_total",
            "Tier-management events by kind", ("kind",))
        rd = RegistryDict()
        rd.bind("demotions_host", demotions,
                initial=self.stats["demotions_host"], tier="host")
        rd.bind("demotions_object", demotions,
                initial=self.stats["demotions_object"], tier="object")
        rd.bind("restores_host", restores,
                initial=self.stats["restores_host"], tier="host")
        rd.bind("restores_object", restores,
                initial=self.stats["restores_object"], tier="object")
        for kind in ("restore_misses", "budget_refusals", "spills",
                     "object_evictions", "eviction_events",
                     "device_evicted_pages"):
            rd.bind(kind, events, initial=self.stats[kind], kind=kind)
        self.stats = rd
        tier_bytes = registry.gauge(
            "kotta_kv_store_bytes", "Resident demoted bytes per tier",
            ("tier",))
        gbh = registry.gauge(
            "kotta_kv_store_gb_hours",
            "Accrued storage GB-hours per tier", ("tier",))
        cost = registry.gauge(
            "kotta_kv_store_cost_usd",
            "Accrued storage cost per tier (USD)", ("tier",))
        tenant_cost = registry.gauge(
            "kotta_kv_store_tenant_cost_usd",
            "Accrued storage cost per tenant (USD)", ("tenant",))

        def collect():
            tier_bytes.set(self.host_bytes, tier="host")
            tier_bytes.set(self.object_bytes, tier="object")
            for t in (Tier.HOST, Tier.OBJECT):
                gbh.set(self.gb_hours[t], tier=t.value)
                cost.set(self.cost_by_tier[t], tier=t.value)
            for tenant, usd in self.cost_by_tenant.items():
                tenant_cost.set(usd, tenant=tenant)

        registry.register_collector(collect)
        self._registry = registry
