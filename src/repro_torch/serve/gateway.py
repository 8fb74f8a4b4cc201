"""Kotta serving gateway: every generation request is a Kotta job.

Cloud Kotta's core contribution is the control plane around the executor —
fine-grained security over shared data (§VI), queue-driven elastic
provisioning that cuts cost up to 16x (§IV-C, Table VII-C), and execution
placed where the economics say (§VII-E). :class:`KottaServeGateway` wraps
those three planes around one or more :class:`ContinuousBatchingEngine`
replicas, so serve traffic gets exactly what batch analytics got:

- **Security** (§VI): ``submit`` takes a short-term :class:`SessionToken`
  and authorizes ``serve:Generate`` on the model resource (plus ``data:Get``
  on the request's data zone) through :class:`PolicyEngine` — default-deny,
  every allow/deny appended to the immutable audit log. The engine's radix
  prefix cache is **tenant-scoped**: each request's page-granular prefix
  keys are namespaced by (tenant, data-zone), so one tenant's cached KV
  pages can never be aliased into another tenant's request, while requests
  inside a tenant still share copy-on-write.
- **Scheduling** (§IV-D): admission is a pluggable policy
  (:mod:`repro_torch.serve.admission`). The default
  :class:`~repro_torch.serve.admission.DeadlineCostPolicy` keeps the pending
  queue EDF-ordered within priority classes, sheds requests that cannot
  meet their deadline at current occupancy (typed rejection, never a
  hang), and prices requests against their cost budget with
  :mod:`repro_torch.core.cost` instance rates. The engine's ``_admit_wave``
  consumes this policy-ordered queue verbatim.
- **Decode preemption** (companion paper's interactive analytics): before
  an interactive request is shed as infeasible, the policy may nominate
  the latest-deadline running batch-class request for a lossless pause
  (:meth:`~repro_torch.serve.admission.DeadlineCostPolicy.plan_preemption`) —
  its engine slot frees immediately, its KV pages stay pinned, and it
  resumes with zero re-prefill the moment a slot opens (accepted work
  completes ahead of new admissions, Kotta's queue-watcher promise).
  Every pause/resume is a typed audit record (``serve:Preempt`` /
  ``serve:Resume``) and lands in the gateway stats (``preemptions``,
  ``resumes``, ``preempt_wait_s``).
- **Elasticity** (§IV-C): replica count follows queue depth through
  :class:`repro_torch.core.elastic.Provisioner`; spot replicas bid into
  :class:`repro_torch.core.market.SpotMarket` and can be **revoked mid-decode**
  — the gateway aborts the engine (the normal retire path: refcounts stay
  exact, cached prefixes survive), re-enqueues the live requests exempt
  from shedding, and another replica completes them. Greedy decode is
  deterministic, so a requeued request emits identical tokens. Retired
  engines park in a standby pool (a warm pool: jit caches survive
  relaunch).
- **Graceful failure** (§IV-B; worker loss is an event, not an outage):
  the market's **revocation notice** (``SpotMarket.notice_s``, the
  2-minute spot warning) arrives one window ahead of the price crossing
  the bid, and the gateway spends it **evacuating** the replica — every
  live and PAUSED request's KV pages ship out mid-decode
  (``export(reason=EVACUATE)``) and re-import on a surviving
  replica via FleetRouter placement, so recovery costs a page copy, not a
  re-prefill, and greedy tokens stay identical to an undisturbed run.
  Only when the window is too short for the payload does the job fall
  back to requeue — now with **capped exponential backoff** and a
  **retry budget** (exhaustion is a typed ``RetryBudgetExhausted`` shed,
  never a hot requeue loop). Replicas heartbeat into the router each
  round; non-UP replicas (stragglers → DEGRADED, heartbeat loss →
  QUARANTINED) take no new placements and are drained. A pluggable
  :class:`~repro_torch.serve.faults.FaultInjector` drives crash / notice /
  straggler / heartbeat-loss schedules through the same paths for the
  chaos tests and the ``fault_recovery`` bench. Every failure transition
  is audited (``serve:Revoke`` / ``serve:Evacuate`` / ``serve:Requeue``).

- **Placement** (§IV, execution near the data): dispatch goes through a
  :class:`~repro_torch.serve.routing.FleetRouter`. Each replica advertises a
  radix **fingerprint** of its prefix cache
  (:meth:`~repro_torch.serve.paging.PrefixCache.fingerprint`) and the router
  scores every queued request against every live replica — matched prefix
  pages x page_size is prefill work the fleet skips — dispatching to the
  best-affinity replica with a least-loaded fallback and a load-imbalance
  cap (``routing="affinity" | "least_loaded" | "blind"``). Affinity
  estimates also feed admission feasibility: a request that is only
  deadline-feasible on its warm replica is kept, not shed.
- **Disaggregated prefill/decode** (``prefill_replicas > 0``): dedicated
  prefill-role replicas (wide chunks, never decode) run admission prefill
  and ship each request's finished KV pages to a decode-role replica
  through the engine page-residency interface
  (:meth:`~repro_torch.serve.engine.ContinuousBatchingEngine.export` /
  ``import_pages``). Handoffs re-register the shipped prefix in the
  destination's radix cache, so it stays shareable after the hop; greedy
  tokens are identical to a never-shipped run. Ship time is billed at
  ``ServiceModel.kv_ship_bytes_per_s`` and the wire bytes land in
  ``page_ship_bytes``.
- **Tiered KV hierarchy** (``kv_store=``): with a
  :class:`~repro_torch.serve.kv_store.TieredKVStore` attached, a finished
  request's pages demote (``export(reason=DEMOTE)``) into HOST / OBJECT
  tiers instead of being destroyed, and a queued job whose prompt
  prefixes a demoted stream parks ``RESTORE_PENDING`` (the batch
  scheduler's WAITING_DATA, one layer down) while an async restore lands
  the pages back on a replica via ``restore_pages`` — resumed sessions
  pay restore bandwidth, not re-prefill FLOPs, and storage GB-hours are
  billed per (tier, tenant) through :class:`repro_torch.core.cost.StoragePricing`.

Time is a :class:`repro_torch.core.clock.VirtualClock` driven by a
:class:`~repro_torch.serve.admission.ServiceModel` — decode/prefill seconds are
modelled, so per-token and per-replica-second **cost accounting** is
deterministic and comparable across hosts, exactly like the Table VII-C
discrete-event reproduction. ``benchmarks/gateway_bench.py`` reports the
elastic-spot gateway against a static on-demand fleet, and affinity
routing against blind dispatch on a Zipf-skewed tenant trace.

The port's departures from the reference gateway: a destination engine's
``import_pages`` / ``restore_pages`` is retried on the next replica only
for :class:`~repro_torch.serve.engine.CapacityError` (no slot, not enough
pages); any other ``RuntimeError`` (a failed kernel launch, a CUDA fault)
propagates out of :meth:`KottaServeGateway.step`. And ``page_nbytes`` is
in the pool's dtype, so a bf16 pool's evacuation budget carries about
twice the reference's f32 requests through the same notice window.
"""
from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..core.clock import Clock, VirtualClock
from ..core.cost import ComputePricing
from ..core.elastic import Provisioner, ProvisioningModel, ScalingPolicy
from ..core.market import SpotMarket
from ..core.security import (AuditRecord, PolicyEngine, SessionToken)

from .admission import (AdmissionPolicy, DeadlineCostPolicy,
                        DeadlineInfeasible, JobState, PreemptCandidate,
                        RetryBudgetExhausted, ServeJob, ServiceModel,
                        StorageBudgetExceeded)
from .engine import (CapacityError, ContinuousBatchingEngine,
                     EngineRequest, ExportReason, PausedRequest, ShippedKV)
from .faults import FaultInjector
from .kv_store import TieredKVStore
from .routing import (HEALTH_UP, FingerprintTracker, FleetRouter,
                      ReplicaView)
from .telemetry import LATENCY_BUCKETS_S, MetricsRegistry, RegistryDict

# Per-token decode latency buckets (TPOT lives well under the TTFT range).
TPOT_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 1.0)


class _Replica:
    """One engine instance with a market identity and a billing meter."""

    _ids = itertools.count()

    def __init__(self, engine: ContinuousBatchingEngine, zone, market: str,
                 bid: float, ready_at: float):
        self.id = next(self._ids)
        self.engine = engine
        self.role = engine.role         # "unified" | "prefill" | "decode"
        self.zone = zone
        self.market = market            # "spot" | "on_demand"
        self.bid = bid                  # $/h; spot revokes when price > bid
        self.ready_at = ready_at
        self.state = "provisioning"     # -> "live" -> "retired"
        self.idle_since: Optional[float] = None
        self.jobs: set[int] = set()
        self.dispatched = 0             # requests routed here, lifetime
        # prefill-token watermark: stats are cumulative per engine, and
        # engines are reused across launches (warm pool).
        self.pt_mark = engine.stats["prefill_tokens"]
        # Failure plane: a pending revocation notice (absolute deadline the
        # instance disappears at) and injected-fault state.
        self.notice_deadline: Optional[float] = None
        self.latency_mult = 1.0         # straggler fault: decode slowdown
        self.straggler_until: Optional[float] = None
        self.hb_lost_until: Optional[float] = None


@dataclass
class _PausedJob:
    """A decode-preempted job parked on a replica (pages pinned there)."""

    replica: "_Replica"
    paused: PausedRequest
    job: ServeJob
    since: float                    # pause timestamp: added wait accounting


class KottaServeGateway:
    """Secure, deadline/cost-aware, elastic front for serve replicas."""

    def __init__(self, engine_factory: Callable[[], ContinuousBatchingEngine],
                 security: PolicyEngine, *,
                 model_resource: str = "model/serve",
                 admission: AdmissionPolicy | None = None,
                 scaling: ScalingPolicy | None = None,
                 market: SpotMarket | None = None,
                 provisioning: ProvisioningModel | None = None,
                 pricing: ComputePricing | None = None,
                 instance_type: str = "c4.8xlarge",
                 service_model: ServiceModel | None = None,
                 clock: Clock | None = None,
                 idle_tick_s: float = 1.0,
                 routing: str | FleetRouter = "affinity",
                 imbalance_cap: int = 4,
                 prefill_replicas: int = 0,
                 prefill_engine_factory:
                     Callable[[], ContinuousBatchingEngine] | None = None,
                 retry_budget: int = 5,
                 backoff_base_s: float = 2.0,
                 backoff_cap_s: float = 60.0,
                 evacuate_on_notice: bool = True,
                 notice_s: float | None = None,
                 fault_injector: FaultInjector | None = None,
                 kv_store: TieredKVStore | None = None,
                 registry: MetricsRegistry | None = None,
                 telemetry_store=None,
                 telemetry_flush_s: float = 5.0,
                 slo_target: float = 0.99,
                 slo_window_s: float = 300.0,
                 seed: int = 0):
        self._engine_factory = engine_factory
        self.security = security
        self.model_resource = model_resource
        self.model = service_model or ServiceModel()
        self.router = routing if isinstance(routing, FleetRouter) \
            else FleetRouter(routing, imbalance_cap=imbalance_cap)
        # The default policy estimates with the SAME service model the
        # gateway bills with — shed decisions and accounting must agree.
        self.admission = admission or DeadlineCostPolicy(model=self.model)
        self.scaling = scaling or ScalingPolicy.none(1, market="on_demand")
        self.market = market
        self.pricing = pricing or (market.pricing if market is not None
                                   else ComputePricing())
        self.instance_type = instance_type
        # One clock for both planes: scheduling time must also drive token
        # expiry and audit timestamps, or the security fabric is time-inert
        # (a 1 h session token would outlive a week-long trace). Callers
        # that pass neither clock get a shared fresh VirtualClock.
        if clock is None and isinstance(security.clock, VirtualClock):
            clock = security.clock
        self.clock = clock if clock is not None else VirtualClock()
        self.idle_tick_s = idle_tick_s
        self.provisioner = Provisioner(self.scaling, provisioning, seed=seed)
        # Failure-plane knobs: how many replica losses one job may absorb
        # before a typed shed, the capped-exponential requeue backoff, and
        # whether a revocation notice triggers KV evacuation (off = the
        # abort/requeue baseline the fault_recovery bench compares
        # against). ``notice_s`` is the window for injected/operator
        # notices; market notices use the market's own ``notice_s``.
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        self.retry_budget = retry_budget
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.evacuate_on_notice = evacuate_on_notice
        self.notice_s = notice_s if notice_s is not None else \
            (market.notice_s if market is not None else 120.0)
        self.faults = fault_injector
        self._fp_tracker = FingerprintTracker()
        # Tiered KV hierarchy (None disables demotion/restore entirely):
        # finished requests' pages demote into the store at retirement, and
        # queued jobs whose prompt prefixes a demoted stream park
        # RESTORE_PENDING while the async restore runs.
        self.kv_store = kv_store
        # rid -> [RestoreTicket, redeemed payload | None, delivery attempts]
        self._restores: dict[int, list] = {}

        self.jobs: dict[int, ServeJob] = {}
        self.completed_order: list[int] = []
        self._queue: list[ServeJob] = []
        self._rids = itertools.count()
        self._replicas: list[_Replica] = []
        self._standby: list[ContinuousBatchingEngine] = []
        self._paused: list[_PausedJob] = []
        # KV payloads in flight between replicas (prefill handoffs AND
        # evacuated requests), FIFO with a delivery-attempt counter.
        self._handoffs: list[list] = []    # [payload, job rid, attempts]

        # --- observability plane (one registry for the whole stack) --------
        # Gateway counters, every engine's stats, and the router's decision
        # counts all land in this registry; the `stats` dicts everywhere
        # stay readable/writable as plain dicts (RegistryDict views), so
        # nothing upstream of the registry changes shape.
        self.registry = registry if registry is not None \
            else MetricsRegistry(clock=self.clock)
        self.telemetry_store = telemetry_store
        self.telemetry_flush_s = telemetry_flush_s
        self.slo_target = slo_target
        self.slo_window_s = slo_window_s
        self._engine_seq = itertools.count()
        self._slo_events: deque = deque()      # (event time, deadline hit?)
        self._health_seen: dict[int, str] = {}
        self._audit_cursor = 0                 # audit records already staged
        self._write_seq = itertools.count()
        # Writes destined for the telemetry StateStore, FIFO; bounded so a
        # throttled table under sustained overload degrades to dropped
        # telemetry, never to unbounded gateway memory.
        self._pending_writes: deque = deque()
        self._last_flush = self.clock.now()
        self._build_metrics()
        self.stats = self._build_stats()
        self.router.bind_registry(self.registry)
        if self.kv_store is not None:
            self.kv_store.bind_registry(self.registry)

        # One engine up front: it validates request shapes at submit time
        # and seeds the warm pool; every autoscaled replica is
        # factory-identical (and never prefill-role — those never decode).
        self._standby.append(self._bind_engine(engine_factory()))
        if self._standby[0].role == "prefill":
            raise ValueError(
                "engine_factory must build decode-capable engines "
                "(role 'unified' or 'decode'); pass prefill-role engines "
                "through prefill_engine_factory")
        self._slots_per_replica = self._standby[0].max_slots
        # Pre-provision the floor, ready immediately — the paper's dev pool
        # always holds >= min reliable nodes (static baselines start hot).
        now = self.clock.now()
        self._start_time = now
        # Prefill-role replicas are static infrastructure: launched hot,
        # on-demand (never spot-revoked), never idle-terminated — they are
        # the fleet's admission front end, not elastic decode capacity.
        if prefill_replicas > 0 and prefill_engine_factory is None:
            raise ValueError("prefill_replicas > 0 requires a "
                             "prefill_engine_factory")
        for _ in range(prefill_replicas):
            eng = self._bind_engine(prefill_engine_factory())
            if eng.role != "prefill":
                raise ValueError("prefill_engine_factory must build "
                                 f"role='prefill' engines, got {eng.role!r}")
            r = _Replica(eng, None, "on_demand", 0.0, ready_at=now)
            r.state = "live"
            r.idle_since = now
            self._replicas.append(r)
            self.stats["launches"] += 1
        self._disaggregated = prefill_replicas > 0
        for _ in range(self.scaling.min_nodes):
            self._launch(now, ready_now=True)

    # -- observability -------------------------------------------------------
    # Gateway lifecycle counters exported as kotta_gateway_<key>_total.
    _STAT_COUNTERS = ("rounds", "launches", "terminations", "revocations",
                      "requeues", "shed", "tokens", "cost_usd",
                      "replica_seconds", "preemptions", "resumes",
                      "preempt_wait_s", "page_ships", "page_ship_bytes",
                      "notices", "evacuations", "evacuated_pages_bytes",
                      "retries", "backoff_wait_s", "wasted_decode_tokens",
                      "faults_injected", "telemetry_flushes",
                      "telemetry_writes", "telemetry_dropped",
                      "statestore_throttled", "kv_demotions",
                      "kv_demoted_bytes", "kv_restores",
                      "kv_restore_fallbacks", "kv_budget_refusals",
                      "restored_tokens", "storage_cost_usd")

    MAX_PENDING_WRITES = 10_000

    def _build_stats(self) -> RegistryDict:
        rd = RegistryDict()
        for key in self._STAT_COUNTERS:
            fam = self.registry.counter(
                f"kotta_gateway_{key}_total",
                f"Gateway {key.replace('_', ' ')} (cumulative)")
            rd.bind(key, fam, initial=0)
        rd.bind("peak_replicas",
                self.registry.gauge("kotta_gateway_peak_replicas",
                                    "High-water mark of live replicas"),
                initial=0)
        return rd

    def _build_metrics(self) -> None:
        reg = self.registry
        tc = ("tenant", "class")
        self._m_requests = reg.counter(
            "kotta_requests_total", "Requests admitted past authorization",
            tc)
        self._m_completed = reg.counter(
            "kotta_requests_completed_total", "Requests finished DONE", tc)
        self._m_shed_reason = reg.counter(
            "kotta_requests_shed_total", "Requests shed, by typed reason",
            ("tenant", "reason"))
        self._m_tenant_tokens = reg.counter(
            "kotta_tenant_tokens_total", "Decoded tokens delivered",
            ("tenant",))
        self._m_tenant_cost = reg.counter(
            "kotta_tenant_cost_usd_total",
            "Modelled serving spend attributed to the tenant (service "
            "seconds priced at the fleet's per-slot rate)", ("tenant",))
        self._m_ttft = reg.histogram(
            "kotta_request_ttft_seconds",
            "Submit to first decode-slot occupancy", LATENCY_BUCKETS_S, tc)
        self._m_tpot = reg.histogram(
            "kotta_request_tpot_seconds",
            "Decode seconds per emitted token", TPOT_BUCKETS_S, tc)
        self._m_qwait = reg.histogram(
            "kotta_request_queue_wait_seconds",
            "Submit to dispatch onto a replica", LATENCY_BUCKETS_S, tc)
        self._m_health_trans = reg.counter(
            "kotta_replica_health_transitions_total",
            "Router health-state transitions observed by the gateway",
            ("from_state", "to_state"))
        rr = ("replica", "role")
        self._g_occupancy = reg.gauge(
            "kotta_replica_occupancy", "Live decode slots / max slots", rr)
        self._g_queue_depth = reg.gauge(
            "kotta_replica_queue_depth", "Engine-queued requests", rr)
        self._g_hit_rate = reg.gauge(
            "kotta_replica_prefix_hit_rate",
            "Prompt tokens served from the prefix cache (lifetime)", rr)
        self._g_gw_queue = reg.gauge(
            "kotta_gateway_queue_depth", "Central pending-queue depth")
        self._g_live = reg.gauge(
            "kotta_gateway_live_replicas", "Replicas currently live")
        self._g_burn = reg.gauge(
            "kotta_slo_burn_rate",
            "Deadline-miss fraction over the SLO window / error budget "
            "(1.0 = burning exactly the budget)")
        self._g_slo_target = reg.gauge(
            "kotta_slo_target", "Deadline-hit SLO target")
        self._g_slo_target.set(self.slo_target)
        reg.register_collector(self._collect_gauges)

    def _bind_engine(self, eng: ContinuousBatchingEngine
                     ) -> ContinuousBatchingEngine:
        """Adopt an engine into the shared registry (idempotent: warm-pool
        engines come back already bound) and, when a tiered KV store is
        attached, into the storage hierarchy: decode-capable engines demote
        finished requests' pages instead of destroying them, and their
        prefix-cache evictions stream into the store's counters."""
        if not isinstance(eng.stats, RegistryDict):
            eng.bind_registry(self.registry, f"e{next(self._engine_seq)}")
        if self.kv_store is not None and eng.role != "prefill":
            eng.demote_on_retire = True
            if eng.prefix_cache is not None:
                eng.prefix_cache.on_evict = self.kv_store.on_eviction
        return eng

    @staticmethod
    def _job_class(job: ServeJob) -> str:
        return "interactive" if job.priority == 0 else "batch"

    def _collect_gauges(self) -> None:
        """Scrape-time refresh of gauges computed from live state (the
        Prometheus collector pattern) — retired replicas drop out of the
        exposition because the families are rebuilt from scratch."""
        now = self.clock.now()
        for fam in (self._g_occupancy, self._g_queue_depth,
                    self._g_hit_rate):
            fam.clear()
        live = 0
        for r in sorted(self._replicas, key=lambda x: x.id):
            if r.state == "retired":
                continue
            if r.state == "live":
                live += 1
            eng = r.engine
            lbl = {"replica": str(r.id), "role": r.role}
            self._g_occupancy.set(eng.live / eng.max_slots, **lbl)
            self._g_queue_depth.set(eng.queued, **lbl)
            self._g_hit_rate.set(eng.prefix_hit_rate, **lbl)
        self._g_gw_queue.set(len(self._queue))
        self._g_live.set(live)
        while self._slo_events and \
                self._slo_events[0][0] < now - self.slo_window_s:
            self._slo_events.popleft()
        if self._slo_events:
            miss = sum(1 for _, hit in self._slo_events if not hit) \
                / len(self._slo_events)
            self._g_burn.set(miss / max(1.0 - self.slo_target, 1e-9))
        else:
            self._g_burn.set(0.0)

    def _observe_completion(self, job: ServeJob) -> None:
        lbl = {"tenant": job.tenant, "class": self._job_class(job)}
        self._m_completed.inc(1, **lbl)
        ntoks = len(job.tokens or ())
        if job.started_at is not None:
            self._m_ttft.observe(job.started_at - job.submitted_at, **lbl)
            if ntoks:
                self._m_tpot.observe(
                    (job.finished_at - job.started_at) / ntoks, **lbl)
        if job.dispatched_at is not None:
            self._m_qwait.observe(job.dispatched_at - job.submitted_at,
                                  **lbl)
        self._m_tenant_tokens.inc(ntoks, tenant=job.tenant)
        # $/tenant: the job's modelled service seconds at the fleet's
        # current per-slot rate — the same arithmetic admission prices
        # budgets with, so showback and shed decisions agree.
        svc = self.model.prefill_s(len(job.prompt)) \
            + ntoks * self.model.decode_step_s
        self._m_tenant_cost.inc(
            svc / 3600.0 * self._price_per_slot_hour(job.finished_at),
            tenant=job.tenant)
        hit = job.deadline is None or job.finished_at <= job.deadline
        self._slo_events.append((job.finished_at, hit))
        self._stage_job_write(job)

    def _observe_shed(self, job: ServeJob, reason: str, now: float) -> None:
        self._m_shed_reason.inc(1, tenant=job.tenant, reason=reason)
        self._slo_events.append((now, False))
        self._stage_job_write(job)

    def _observe_health(self, now: float) -> None:
        for r in self._replicas:
            if r.state != "live" or r.role == "prefill":
                continue
            h = self.router.health(r.id, now)
            prev = self._health_seen.get(r.id)
            if prev is not None and prev != h:
                self._m_health_trans.inc(1, from_state=prev, to_state=h)
            self._health_seen[r.id] = h

    # -- telemetry -> StateStore flush ---------------------------------------
    def _stage_job_write(self, job: ServeJob) -> None:
        """Terminal job state becomes a StateStore item — the Kotta move:
        serve jobs land in the same provisioned table batch jobs use, so
        one backplane answers 'what happened to request N' for both."""
        if self.telemetry_store is None:
            return
        self._stage_write(f"servejob/{job.rid}", {
            "tenant": job.tenant, "status": job.status.value,
            "class": self._job_class(job),
            "tokens": len(job.tokens or ()),
            "submitted_at": job.submitted_at,
            "finished_at": job.finished_at,
            "retries": job.retries, "evacuations": job.evacuations,
            "error": type(job.error).__name__ if job.error else None})

    def _stage_write(self, key: str, item: dict) -> None:
        self._pending_writes.append((key, item))
        while len(self._pending_writes) > self.MAX_PENDING_WRITES:
            self._pending_writes.popleft()
            self.stats["telemetry_dropped"] += 1

    def _flush_telemetry(self, now: float) -> None:
        """Every ``telemetry_flush_s`` virtual seconds, push staged writes
        (audit records, terminal job states) plus one registry snapshot
        into the telemetry StateStore.

        Only the non-blocking ``try_put_item`` path is used: the gateway
        drives its own VirtualClock, so a blocking capacity wait here would
        deadlock the simulation — and the refusal count IS the signal
        (provisioned-throughput-exceeded) the saturation bench sweeps for.
        Throttled writes stay staged and retry next flush; a throttled
        snapshot is simply dropped (the next interval's supersedes it).
        """
        store = self.telemetry_store
        if store is None or now - self._last_flush < self.telemetry_flush_s:
            return
        self._last_flush = now
        self.stats["telemetry_flushes"] += 1
        self._stage_audit_tail()
        while self._pending_writes:
            key, item = self._pending_writes[0]
            if not store.try_put_item(key, item):
                self.stats["statestore_throttled"] += 1
                break
            self._pending_writes.popleft()
            self.stats["telemetry_writes"] += 1
        snap = self.registry.snapshot()
        if store.try_put_item(f"metrics/{next(self._write_seq):08d}", snap):
            self.stats["telemetry_writes"] += 1
        else:
            self.stats["statestore_throttled"] += 1

    def _stage_audit_tail(self) -> None:
        audit = self.security.audit
        if len(audit) > self._audit_cursor:
            for rec in audit.records()[self._audit_cursor:]:
                self._stage_write(f"audit/{next(self._write_seq):08d}", {
                    "ts": rec.timestamp, "principal": rec.principal_id,
                    "role": rec.role_name, "action": rec.action,
                    "resource": rec.resource, "decision": rec.decision,
                    "detail": rec.detail})
            self._audit_cursor = len(audit)

    def flush_telemetry(self) -> None:
        """End-of-run epilogue: drain EVERY staged telemetry write plus a
        final snapshot into the StateStore, advancing the virtual clock to
        refill write capacity when throttled (each refusal still counts —
        the wall is the wall, even during shutdown). ``step()`` never calls
        this; benches and the CLI do, so runs end with a complete table."""
        store = self.telemetry_store
        if store is None:
            return
        self._stage_audit_tail()
        while self._pending_writes:
            key, item = self._pending_writes[0]
            if store.try_put_item(key, item):
                self._pending_writes.popleft()
                self.stats["telemetry_writes"] += 1
            else:
                self.stats["statestore_throttled"] += 1
                self.clock.advance(1.0)
        key = f"metrics/{next(self._write_seq):08d}"
        snap = self.registry.snapshot()
        while not store.try_put_item(key, snap):
            self.stats["statestore_throttled"] += 1
            self.clock.advance(1.0)
        self.stats["telemetry_writes"] += 1

    # -- user API ------------------------------------------------------------
    def submit(self, token: SessionToken, prompt: list[int], *,
               max_new: int = 16, deadline_s: float | None = None,
               priority: int = 1, cost_budget: float | None = None,
               data_zone: str | None = None) -> int:
        """Authorize and enqueue one generation request; returns its job id.

        Raises :class:`repro_torch.core.security.SecurityError` on a deny — the
        deny (like every allow) is already in the audit log. ``deadline_s``
        is relative to now; ``priority`` is the class (0 = interactive).
        """
        self.security.check(token, "serve:Generate", self.model_resource)
        if data_zone is not None:
            self.security.check(token, "data:Get",
                                f"dataset/{data_zone}/serve-context")
        now = self.clock.now()
        rid = next(self._rids)
        job = ServeJob(
            rid=rid, tenant=token.principal_id, prompt=list(prompt),
            max_new=max_new, submitted_at=now,
            deadline=None if deadline_s is None else now + deadline_s,
            priority=priority, cost_budget=cost_budget,
            namespace=(token.principal_id, data_zone))
        # Fail fast on shapes that can never fit a replica's pool — checked
        # against a decode-capable engine AND, when disaggregated, a
        # prefill-role engine (both pools must hold the request).
        er = EngineRequest(rid, job.prompt, job.max_new, job.namespace)
        self._validation_engine()._validate_request(er)
        for r in self._replicas:
            if r.role == "prefill":
                r.engine._validate_request(er)
                break
        self.jobs[rid] = job
        self._queue.append(job)
        self._m_requests.inc(1, tenant=job.tenant,
                             **{"class": self._job_class(job)})
        return rid

    def result(self, rid: int) -> list[int]:
        """Completed tokens; raises the job's typed rejection if shed."""
        job = self.jobs[rid]
        if job.status is JobState.DONE:
            return job.tokens
        if job.status is JobState.SHED:
            raise job.error
        raise RuntimeError(f"job {rid} still {job.status.value}")

    def outstanding(self) -> int:
        return sum(1 for j in self.jobs.values()
                   if j.status in (JobState.QUEUED, JobState.RUNNING,
                                   JobState.PAUSED,
                                   JobState.RESTORE_PENDING))

    def drain(self, max_rounds: int = 20_000) -> None:
        """Step until every submitted job is DONE or SHED."""
        for _ in range(max_rounds):
            if not self.outstanding():
                return
            self.step()
        raise RuntimeError(f"gateway did not drain in {max_rounds} rounds "
                           f"({self.outstanding()} jobs outstanding)")

    # -- one scheduling round --------------------------------------------------
    def step(self) -> None:
        """One gateway round: activate, revoke, resume, deliver/request
        tier restores, shed/order (which may preempt), dispatch, pump,
        autoscale, bill, and advance the virtual clock.

        Resume runs BEFORE shed/dispatch: paused jobs are accepted work and
        re-take freed slots ahead of new admissions (Kotta §IV-D — accepted
        work is completed, whatever the market or the burst does). A job
        preempted in this round's shed phase therefore cannot bounce
        straight back into the slot its preemptor needs — the interactive
        request is dispatched later the same round, and the victim resumes
        no earlier than the next round's slot surplus.
        """
        now = self.clock.now()
        self.stats["rounds"] += 1
        for r in self._replicas:
            if r.state == "provisioning" and r.ready_at <= now:
                r.state = "live"
                r.idle_since = now
        self._inject_faults(now)
        self._check_revocations(now)
        evac_s = self._evacuate_noticed(now)
        self._heartbeats(now)
        self._observe_health(now)
        self._drain_unhealthy(now)
        self._resume_paused(now)
        if self.kv_store is not None:
            self._deliver_restores(now)
            self._check_restores(now)
        self._shed_and_order(now)
        self._dispatch(now)
        work_s = max(self._pump(now), evac_s)
        self._autoscale(now)
        tick = work_s if work_s > 0 else self.idle_tick_s
        self._accrue(now, tick)
        self._flush_telemetry(now)
        self.clock.advance(tick)

    # -- replica accessors ------------------------------------------------------
    def replica_engine(self, replica_id: int) -> ContinuousBatchingEngine:
        """The engine behind a specific (non-retired) replica id.

        The explicit accessor for a heterogeneous fleet — there is no
        "the" engine once replicas differ by role, so callers must say
        which one they mean. Raises ``KeyError`` for an unknown id.
        """
        for r in self._replicas:
            if r.id == replica_id:
                return r.engine
        raise KeyError(f"no replica {replica_id}")

    def _validation_engine(self) -> ContinuousBatchingEngine:
        """A decode-capable engine for submit-time shape validation (the
        warm standby when one exists — every autoscaled replica is
        factory-identical to it)."""
        if self._standby:
            return self._standby[-1]
        for r in self._replicas:
            if r.role != "prefill":
                return r.engine
        raise RuntimeError("no decode-capable engine to validate against")

    # -- security/market helpers ----------------------------------------------

    def _od_price(self) -> float:
        return self.pricing.on_demand_per_hour[self.instance_type]

    def _replica_price(self, r: _Replica, now: float) -> float:
        if r.market == "spot":
            if self.market is not None and r.zone is not None:
                return self.market.price(r.zone, self.instance_type,
                                         now / 3600.0)
            return self._od_price() * self.pricing.typical_spot_fraction
        return self._od_price()

    def _price_per_slot_hour(self, now: float) -> float:
        live = [r for r in self._replicas if r.state == "live"]
        if live:
            per_h = sum(self._replica_price(r, now) for r in live) / len(live)
        elif self.scaling.market == "spot":
            if self.market is not None:
                per_h = self.market.cheapest_zone(self.instance_type,
                                                  now / 3600.0)[1]
            else:
                per_h = self._od_price() * self.pricing.typical_spot_fraction
        else:
            per_h = self._od_price()
        return per_h / self._slots_per_replica

    # -- fault injection ---------------------------------------------------------
    def _inject_faults(self, now: float) -> None:
        """Expire transient fault windows, then apply whatever the injected
        schedule says fires this round. Targets index the live
        decode-capable fleet sorted by id (mod count), so one schedule is
        meaningful at any fleet size; events with no live target land in
        ``injector.skipped`` rather than vanishing."""
        for r in self._replicas:
            if r.straggler_until is not None and now >= r.straggler_until:
                r.latency_mult = 1.0
                r.straggler_until = None
            if r.hb_lost_until is not None and now >= r.hb_lost_until:
                r.hb_lost_until = None
        if self.faults is None:
            return
        for ev in self.faults.pop_due(now):
            targets = sorted((r for r in self._replicas
                              if r.state == "live" and r.role != "prefill"),
                             key=lambda x: x.id)
            if not targets:
                self.faults.skipped.append(ev)
                continue
            r = targets[ev.target % len(targets)]
            self.faults.fired.append(ev)
            self.stats["faults_injected"] += 1
            if ev.kind == "crash":
                self._revoke(r, now)
            elif ev.kind == "revoke_notice":
                if r.notice_deadline is None:
                    self._notice(r, now, ev.duration_s or self.notice_s)
            elif ev.kind == "straggler":
                r.latency_mult = ev.magnitude
                r.straggler_until = now + ev.duration_s
            elif ev.kind == "heartbeat_loss":
                r.hb_lost_until = now + ev.duration_s

    # -- health ------------------------------------------------------------------
    def _heartbeats(self, now: float) -> None:
        """Every live replica reports liveness + modelled decode-step
        latency to the router — unless a heartbeat_loss fault is eating its
        reports. Stragglers report their slowed latency, which is exactly
        what the router's leave-one-out detector keys on."""
        for r in self._replicas:
            if r.state != "live":
                continue
            if r.hb_lost_until is not None and now < r.hb_lost_until:
                continue
            step_s = None if r.role == "prefill" \
                else self.model.decode_step_s * r.latency_mult
            self.router.heartbeat(r.id, now, step_s)

    def _drain_unhealthy(self, now: float) -> None:
        """Non-UP replicas take no new placements (the dispatch-target and
        handoff filters) and give queued-but-unstarted work back to the
        central queue; work already in a slot rides out the episode (a
        straggler still finishes, just slowly)."""
        for r in self._replicas:
            if r.state != "live" or r.role == "prefill":
                continue
            if self.router.health(r.id, now) != HEALTH_UP and \
                    r.engine.queued:
                self._return_to_queue(r, r.engine.drop_queued(),
                                      requeued=False)

    # -- revocation -------------------------------------------------------------
    def _check_revocations(self, now: float) -> None:
        if self.market is None:
            return
        for r in list(self._replicas):
            if r.state != "live" or r.market != "spot":
                continue
            if self.market.revoked(r.zone, self.instance_type, r.bid,
                                   now / 3600.0):
                self._revoke(r, now)
            elif r.notice_deadline is None and \
                    self.market.notice(r.zone, self.instance_type, r.bid,
                                       now / 3600.0):
                self._notice(r, now, self.market.notice_s)

    def revoke_replica(self, replica_id: int,
                       notice_s: float | None = None) -> None:
        """Force-revoke a live replica (tests / operator chaos drills).

        ``notice_s=None`` is the no-warning crash; a value runs the
        graceful path — a revocation notice with that many seconds of
        evacuation window before the instance disappears.
        """
        now = self.clock.now()
        for r in self._replicas:
            if r.id == replica_id and r.state == "live":
                if notice_s is None:
                    self._revoke(r, now)
                elif r.notice_deadline is None:
                    self._notice(r, now, notice_s)
                return
        raise KeyError(f"no live replica {replica_id}")

    def _notice(self, r: _Replica, now: float, window_s: float) -> None:
        """A revocation notice landed: the instance dies at
        ``now + window_s``. The replica immediately stops taking new work
        (dispatch/handoff filters key on ``notice_deadline``); the window
        itself is spent by :meth:`_evacuate_noticed`."""
        r.notice_deadline = now + window_s
        self.stats["notices"] += 1
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=f"replica-{r.id}",
            role_name="serve-gateway", action="serve:Revoke",
            resource=self.model_resource, decision="allow",
            detail=f"replica {r.id} revocation notice: {window_s:.0f}s "
                   f"window, {r.engine.live} live / "
                   f"{len([e for e in self._paused if e.replica is r])} "
                   "paused requests to evacuate"))

    def _evacuate_noticed(self, now: float) -> float:
        """Spend pending notice windows. With ``evacuate_on_notice`` the
        replica is evacuated (KV ships out) the round the notice lands;
        without it (the requeue baseline) the replica decodes until the
        deadline, then takes the hard revoke. Returns evacuation ship
        seconds (copies run in parallel with the round's compute)."""
        evac_s = 0.0
        for r in list(self._replicas):
            if r.state != "live" or r.notice_deadline is None:
                continue
            if self.evacuate_on_notice:
                evac_s = max(evac_s, self._evacuate_replica(r, now))
            elif now >= r.notice_deadline:
                self._revoke(r, now)
        return evac_s

    def _evacuate_replica(self, r: _Replica, now: float) -> float:
        """Ship every request the notice window can carry; requeue the rest.

        Budgeting is per request against the remaining window: estimated
        ship time is ``page_nbytes() x ceil(pos/page_size)`` at the service
        model's wire rate, accumulated across requests (they share the
        instance's uplink). Export order is **tightest deadline first**
        across paused AND live requests: when the window cannot carry
        everything, the budget goes to the requests with the least slack —
        a loose-deadline request survives a requeue-with-backoff, an urgent
        one does not (deadline ties keep the old paused-then-live order).
        Whatever does not fit restarts from the queue with backoff. The
        exported payloads live in the gateway's handoff queue, NOT on the
        replica, so they survive the instance's death even if delivery
        takes a few rounds.
        """
        eng = r.engine
        budget = r.notice_deadline - now
        spent = 0.0
        page_b = eng.page_nbytes()
        ps = eng.page_size
        # (deadline, kind, handle, est ship seconds); stable sort on the
        # deadline alone preserves paused-then-live insertion order on ties.
        cands: list[tuple[float, str, int, float]] = []
        for entry in [e for e in self._paused if e.replica is r]:
            dl = self.jobs[entry.paused.req.rid].deadline
            cands.append((math.inf if dl is None else dl, "paused",
                          entry.paused.req.rid,
                          self.model.ship_s(
                              page_b * math.ceil(entry.paused.pos / ps))))
        for slot in sorted(eng._live):
            dl = self.jobs[eng._live[slot].req.rid].deadline
            cands.append((math.inf if dl is None else dl, "live", slot,
                          self.model.ship_s(
                              page_b * math.ceil(int(eng._pos[slot]) / ps))))
        cands.sort(key=lambda c: c[0])
        exports: list[ShippedKV] = []
        for _, kind, handle, est in cands:
            if spent + est > budget:
                continue
            exports.append(
                eng.export(rid=handle, reason=ExportReason.EVACUATE)
                if kind == "paused"
                else eng.export(slot=handle, reason=ExportReason.EVACUATE))
            spent += est
        for payload in exports:
            rid = payload.req.rid
            job = self.jobs[rid]
            job.status = JobState.RUNNING       # in flight to a new slot
            job.replica = None
            job.disturbed_at = now
            job.recovered_at = None
            job.evacuations += 1
            r.jobs.discard(rid)
            self._handoffs.append([payload, rid, 0])
            self.stats["evacuations"] += 1
            self.stats["evacuated_pages_bytes"] += payload.nbytes
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=job.tenant,
                role_name="serve-gateway", action="serve:Evacuate",
                resource=self.model_resource, decision="allow",
                detail=f"job {rid} evacuated off replica {r.id} mid-decode "
                       f"({payload.emitted} tokens emitted, "
                       f"{payload.nbytes} KV bytes shipped)"))
        self._paused = [e for e in self._paused if e.replica is not r]
        # Engine-queued work never started here: straight back to the
        # central queue, shed-exempt but with NO retry accounting — nothing
        # was computed, so nothing was lost. Backoff exists to stop a job
        # from hammering a failing fleet, not to punish standing in line.
        self._return_to_queue(r, eng.drop_queued(), requeued=True)
        # Whatever the window could not carry restarts from the prompt.
        for req in eng.abort():
            r.jobs.discard(req.rid)
            self._requeue_job(self.jobs[req.rid], now,
                              detail=f"notice window too short on replica "
                                     f"{r.id}")
        self.stats["revocations"] += 1
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=f"replica-{r.id}",
            role_name="serve-gateway", action="serve:Revoke",
            resource=self.model_resource, decision="allow",
            detail=f"replica {r.id} retired gracefully: {len(exports)} "
                   f"requests evacuated in {spent:.2f}s of a "
                   f"{budget:.0f}s notice window"))
        self._retire_replica(r, terminated=False)
        return spent

    def _revoke(self, r: _Replica, now: float) -> None:
        """Hard loss (spot reclaim / crash): requests restart elsewhere;
        none are lost, but every token already decoded here is wasted.

        ``abort`` also surrenders the replica's PAUSED requests (their
        pinned pages die with the instance), so their jobs re-enter the
        queue alongside the live ones — with backoff, counted against each
        job's retry budget.
        """
        eng = r.engine
        self.stats["wasted_decode_tokens"] += \
            sum(l.emitted for l in eng._live.values()) + \
            sum(p.emitted for p in eng._paused.values())
        # Queued-but-unstarted work lost nothing: shed-exempt requeue, no
        # retry/backoff accounting. Live + paused requests lost real decode
        # state and go through the budgeted backoff path.
        self._return_to_queue(r, eng.drop_queued(), requeued=True)
        dropped = eng.abort()
        self._paused = [e for e in self._paused if e.replica is not r]
        for req in dropped:
            r.jobs.discard(req.rid)
            self._requeue_job(self.jobs[req.rid], now,
                              detail=f"replica {r.id} lost without notice")
        self.stats["revocations"] += 1
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=f"replica-{r.id}",
            role_name="serve-gateway", action="serve:Revoke",
            resource=self.model_resource, decision="allow",
            detail=f"replica {r.id} revoked without notice: "
                   f"{len(dropped)} requests requeued"))
        self._retire_replica(r, terminated=False)

    def _requeue_job(self, job: ServeJob, now: float,
                     detail: str = "") -> None:
        """Return a disturbed job to the queue with capped exponential
        backoff — or shed it, typed, when its retry budget is spent."""
        job.tokens = None
        job.started_at = None       # restarts from scratch: TTFT resets
        job.dispatched_at = None
        job.replica = None
        job.disturbed_at = now
        job.recovered_at = None
        job.retries += 1
        if job.retries > self.retry_budget:
            job.status = JobState.SHED
            job.error = RetryBudgetExhausted(
                f"job {job.rid} lost its replica {job.retries} times "
                f"(budget {self.retry_budget}); shedding, not spinning")
            job.finished_at = now
            self.stats["shed"] += 1
            self._observe_shed(job, job.error.reason, now)
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=job.tenant,
                role_name="serve-gateway", action="serve:Requeue",
                resource=self.model_resource, decision="deny",
                detail=f"job {job.rid} retry budget exhausted "
                       f"({job.retries} > {self.retry_budget}): {detail}"))
            return
        backoff = min(self.backoff_cap_s,
                      self.backoff_base_s * 2 ** (job.retries - 1))
        job.status = JobState.QUEUED
        job.requeued = True
        job.not_before = now + backoff
        self._queue.append(job)
        self.stats["requeues"] += 1
        self.stats["retries"] += 1
        self.stats["backoff_wait_s"] += backoff
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=job.tenant,
            role_name="serve-gateway", action="serve:Requeue",
            resource=self.model_resource, decision="allow",
            detail=f"job {job.rid} requeued (retry {job.retries}/"
                   f"{self.retry_budget}, backoff {backoff:.1f}s): "
                   f"{detail}"))

    def _return_to_queue(self, r: _Replica, reqs: list[EngineRequest], *,
                         requeued: bool) -> None:
        """Give never-started engine-queued work back to the central queue
        (no retry accounting: nothing was lost — see :meth:`_requeue_job`
        for the disturbed-job path)."""
        for req in reqs:
            job = self.jobs[req.rid]
            job.status = JobState.QUEUED
            job.requeued = job.requeued or requeued
            job.tokens = None
            job.started_at = None       # restarts from scratch: TTFT resets
            job.dispatched_at = None
            job.replica = None
            r.jobs.discard(req.rid)
            self._queue.append(job)
            if requeued:
                self.stats["requeues"] += 1

    # -- admission ---------------------------------------------------------------
    def _slot_horizon(self, now: float) -> list[float]:
        """When does each decode slot (live or provisioning) next free?

        Prefill-role replicas contribute nothing: they hold no decode
        capacity (their slots turn over within the admission round), so
        feasibility must be argued entirely from decode-capable slots.
        """
        horizon: list[float] = []
        step_s = self.model.decode_step_s
        now = self.clock.now()
        for r in self._replicas:
            if r.role == "prefill":
                continue
            if r.state == "live" and (
                    r.notice_deadline is not None
                    or self.router.health(r.id, now) != HEALTH_UP):
                # Dying or unhealthy capacity argues nothing: feasibility
                # promised against it would be broken the moment it drains.
                continue
            if r.state == "live":
                remaining = r.engine.remaining_tokens()
                horizon.extend(now + rem * step_s for rem in remaining)
                horizon.extend([now] * max(
                    r.engine.max_slots - len(remaining)
                    - r.engine.queued, 0))
            elif r.state == "provisioning":
                horizon.extend([r.ready_at] * r.engine.max_slots)
        return horizon

    def _shed_and_order(self, now: float) -> None:
        # Routing-aware feasibility: under affinity routing, tell admission
        # how many prompt tokens the best-matching dispatch target would
        # serve from its prefix cache — those tokens bill no prefill time.
        cached: dict[int, int] | None = None
        if self.router.mode == "affinity" and self._queue:
            views = self._target_views()
            cached = {job.rid: self.router.best_match_tokens(
                          job.prompt, job.namespace, views)
                      for job in self._queue}
        # RESTORE_PENDING jobs are feasibility-checked honestly: the async
        # restore's remaining latency is pre-service delay, and the stream
        # it lands counts as cached tokens (zero re-prefill once admitted).
        kwargs: dict = {}
        if self._restores:
            kwargs["extra_delay_s"] = {
                rid: max(0.0, item[0].ready_at - now)
                for rid, item in self._restores.items()}
            cached = dict(cached or {})
            for rid, item in self._restores.items():
                cached[rid] = max(cached.get(rid, 0), item[0].tokens)
        keep, shed = self.admission.plan(
            self._queue, self._slot_horizon(now), now,
            self._price_per_slot_hour(now), cached_tokens=cached, **kwargs)
        for job, err in shed:
            # Last resort before shedding a deadline-infeasible request:
            # pause a running lower-class request (policy's choice) so the
            # urgent one starts now. Preemption frees a slot, so the job
            # goes back into the keep set and dispatches this same round.
            if isinstance(err, DeadlineInfeasible) \
                    and self._try_preempt(job, now):
                keep.append(job)
                continue
            self._restores.pop(job.rid, None)   # a shed job's ticket dies
            job.status = JobState.SHED
            job.error = err
            job.finished_at = now
            self.stats["shed"] += 1
            self._observe_shed(job, err.reason, now)
        self._queue = self.admission.order(keep, now)

    # -- decode preemption -------------------------------------------------------
    def _try_preempt(self, job: ServeJob, now: float) -> bool:
        """Pause the policy's victim so ``job`` can start now; False if the
        policy finds no victim that keeps both deadlines."""
        cands = []
        for r in self._replicas:
            if r.state != "live":
                continue
            for slot, live in r.engine._live.items():
                victim = self.jobs.get(live.req.rid)
                if victim is None:
                    continue
                cands.append(PreemptCandidate(
                    victim, live.req.max_new - live.emitted, r.id, slot))
        choice = self.admission.plan_preemption(job, cands, now)
        if choice is None:
            return False
        r = next(x for x in self._replicas if x.id == choice.replica_id)
        paused = r.engine.preempt(choice.slot)
        victim = choice.job
        victim.status = JobState.PAUSED
        self._paused.append(_PausedJob(r, paused, victim, since=now))
        self.stats["preemptions"] += 1
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=victim.tenant,
            role_name="serve-gateway", action="serve:Preempt",
            resource=self.model_resource, decision="allow",
            detail=f"job {victim.rid} paused (pages pinned, "
                   f"{choice.remaining_tokens} tokens remaining) to admit "
                   f"interactive job {job.rid}"))
        return True

    def _resume_paused(self, now: float) -> None:
        """Resume paused jobs into freed slots — ahead of new dispatches."""
        still: list[_PausedJob] = []
        for entry in self._paused:
            r = entry.replica
            if r.state != "live" or not r.engine.free_slots:
                still.append(entry)
                continue
            r.engine.resume(entry.paused)
            entry.job.status = JobState.RUNNING
            wait = now - entry.since
            self.stats["resumes"] += 1
            self.stats["preempt_wait_s"] += wait
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=entry.job.tenant,
                role_name="serve-gateway", action="serve:Resume",
                resource=self.model_resource, decision="allow",
                detail=f"job {entry.job.rid} resumed after {wait:.2f}s "
                       "paused (zero re-prefill)"))
        self._paused = still

    # -- tiered KV hierarchy (demote / restore) ---------------------------------
    def _check_restores(self, now: float) -> None:
        """Park QUEUED jobs whose prompt prefixes a demoted stream.

        The exact mirror of the batch scheduler's ARCHIVE -> WAITING_DATA
        transition: instead of re-prefilling a cold conversation, the job
        waits ``RESTORE_PENDING`` on an async tier restore whose modelled
        latency gates dispatch through the same ``not_before`` hold the
        requeue backoff uses. Jobs already as warm on the live fleet
        (affinity fingerprint match >= the stored stream) skip the restore
        — a device hit beats any lower tier.
        """
        store = self.kv_store
        views = None
        for job in self._queue:
            if (job.status is not JobState.QUEUED or job.requeued
                    or job.not_before > now
                    or job.rid in self._restores):
                continue
            hit = store.match(job.namespace, job.prompt)
            if hit is None:
                continue
            key, tokens, tier = hit
            if self.router.mode == "affinity":
                if views is None:
                    views = self._target_views()
                if self.router.best_match_tokens(
                        job.prompt, job.namespace, views) >= tokens:
                    continue
            ticket = store.request_restore(key, job.rid, now)
            self._restores[job.rid] = [ticket, None, 0]
            job.status = JobState.RESTORE_PENDING
            job.not_before = ticket.ready_at
            job.restores += 1
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=job.tenant,
                role_name="serve-gateway", action="serve:Restore",
                resource=self.model_resource, decision="allow",
                detail=f"job {job.rid} parked RESTORE_PENDING: "
                       f"{tokens}-token stream on {tier.value} tier, "
                       f"ready in {ticket.ready_at - now:.2f}s"))

    def _deliver_restores(self, now: float) -> None:
        """Land due restores on the fleet; fall back to re-prefill on loss.

        A due ticket is redeemed once (the payload survives placement
        retries); ``complete_restore`` returning None means the entry was
        evicted while the restore was in flight — the job simply rejoins
        the queue cold. Placement is least-loaded over UP decode-capable
        replicas via :meth:`ContinuousBatchingEngine.restore_pages`, which
        re-registers the stream as free-but-hittable cache pages, so the
        job's own admission aliases them with zero re-prefill.
        """
        store = self.kv_store
        for rid in list(self._restores):
            ticket, payload, attempts = self._restores[rid]
            job = self.jobs[rid]
            if job.status is not JobState.RESTORE_PENDING:
                del self._restores[rid]         # shed while parked
                continue
            if now < ticket.ready_at:
                continue
            if payload is None:
                payload = store.complete_restore(ticket, now)
                if payload is None:
                    self._restore_fallback(job, now,
                                           "entry evicted mid-restore")
                    continue
                self._restores[rid][1] = payload
            dests = sorted(
                (r for r in self._replicas
                 if r.state == "live" and r.role != "prefill"
                 and r.notice_deadline is None
                 and self.router.health(r.id, now) == HEALTH_UP),
                key=lambda x: (x.engine.live + x.engine.queued, x.id))
            landed = None
            for r in dests:
                try:
                    r.engine.restore_pages(payload)
                except CapacityError:
                    continue                    # no pages here: try the next
                landed = r
                break
            if landed is None:
                self._restores[rid][2] = attempts + 1
                if attempts + 1 >= self.MAX_DELIVERY_ATTEMPTS:
                    self._restore_fallback(
                        job, now, f"no capacity after {attempts + 1} rounds")
                continue
            del self._restores[rid]
            job.status = JobState.QUEUED
            job.not_before = 0.0
            job.restored_tokens += ticket.tokens
            self.stats["kv_restores"] += 1
            self.stats["restored_tokens"] += ticket.tokens
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=job.tenant,
                role_name="serve-gateway", action="serve:Restore",
                resource=self.model_resource, decision="allow",
                detail=f"job {rid}: {ticket.tokens}-token stream restored "
                       f"from {ticket.tier.value} onto replica {landed.id} "
                       f"({ticket.nbytes}B, zero re-prefill)"))

    def _restore_fallback(self, job: ServeJob, now: float,
                          detail: str) -> None:
        """Restore lost the race (eviction or no capacity): the job rejoins
        the queue cold and re-prefills — never a crash, never a hang."""
        del self._restores[job.rid]
        job.status = JobState.QUEUED
        job.not_before = 0.0
        self.stats["kv_restore_fallbacks"] += 1
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=job.tenant,
            role_name="serve-gateway", action="serve:Restore",
            resource=self.model_resource, decision="deny",
            detail=f"job {job.rid} falls back to re-prefill: {detail}"))

    def _demote_payload(self, payload: ShippedKV, now: float) -> None:
        """One finished request's pages into the store, budget permitting.

        A :class:`StorageBudgetExceeded` refusal is typed and audited, and
        the payload is simply forgone — the tenant's conversation restarts
        cold next time, it does not fail."""
        job = self.jobs.get(payload.req.rid)
        tenant = job.tenant if job is not None else payload.req.namespace[0]
        try:
            tier = self.kv_store.demote(payload, tenant, now)
        except StorageBudgetExceeded as err:
            self.stats["kv_budget_refusals"] += 1
            self.security.audit.append(AuditRecord(
                timestamp=now, principal_id=tenant,
                role_name="serve-gateway", action="serve:Demote",
                resource=self.model_resource, decision="deny",
                detail=str(err)))
            return
        self.stats["kv_demotions"] += 1
        self.stats["kv_demoted_bytes"] += payload.nbytes
        self.security.audit.append(AuditRecord(
            timestamp=now, principal_id=tenant,
            role_name="serve-gateway", action="serve:Demote",
            resource=self.model_resource, decision="allow",
            detail=f"job {payload.req.rid}: {payload.nbytes}B of KV pages "
                   f"demoted to {tier.value} tier at retirement"))

    def _dispatch_targets(self) -> list[_Replica]:
        """Replicas the router may place new requests on: the prefill fleet
        when disaggregated (decode replicas only take handoffs), every
        decode-capable live replica otherwise — minus anything under a
        revocation notice or not UP in the router's health view."""
        want = "prefill" if self._disaggregated else None
        now = self.clock.now()
        return [r for r in self._replicas if r.state == "live"
                and (r.role == "prefill") == (want == "prefill")
                and r.notice_deadline is None
                and self.router.health(r.id, now) == HEALTH_UP]

    def _target_views(self) -> list[ReplicaView]:
        """Router-side snapshots of the current dispatch targets.

        Fingerprints are collected only under affinity routing (the other
        modes never read them); they are stable within a round — admission,
        which registers new prefixes, runs later, in ``_pump``.
        """
        views = []
        for r in self._dispatch_targets():
            eng = r.engine
            fp = frozenset()
            if self.router.mode == "affinity" and eng.prefix_cache is not None:
                fp = self._fp_tracker.refresh(r.id, eng.prefix_cache)
            views.append(ReplicaView(
                r.id, eng.open_slots, load=eng.live + eng.queued,
                page_size=eng.page_size, fingerprint=fp))
        return views

    def _affinity_window(self) -> int:
        """Queue prefix the router may reorder within: the run of jobs
        sharing the head's (priority, deadline), capped at ``window``.

        Jobs with identical priority AND deadline are SLA-interchangeable —
        EDF ordered them by (submit, rid) only — so picking the one whose
        prefix is resident on the open capacity costs nothing in deadline
        terms. The window never crosses an EDF boundary: a tighter-deadline
        or higher-class head can NEVER be bypassed by an affinity hit
        behind it.
        """
        head = self._queue[0]
        n = 1
        for job in self._queue[1:self.router.window]:
            if (job.priority, job.deadline) != (head.priority,
                                                head.deadline):
                break
            n += 1
        return n

    def _dispatch(self, now: float) -> None:
        """Route queued jobs to replicas with open slots.

        The queue's policy order governs WHO runs first up to affinity
        lookahead: within the head's SLA-interchangeable window
        (:meth:`_affinity_window`) the router may dispatch a job whose
        prefix is resident on the free capacity ahead of a head that would
        cold-prefill there — under backlog, routing the head alone
        degenerates to blind placement, because the head rarely matches
        whichever slot happens to be free. Across EDF boundaries order is
        absolute. Each placement bumps the chosen view's load so one
        round's decisions see each other. When disaggregated, new work
        lands exclusively on prefill replicas, throttled by downstream
        decode capacity (free decode slots minus handoffs already in
        flight) so finished KV payloads can't pile up faster than decode
        replicas drain them.
        """
        # Backoff hold: requeued jobs still inside their backoff window are
        # not dispatchable this round (they keep their queue standing —
        # shed/order already saw them).
        held = [j for j in self._queue if j.not_before > now]
        if held:
            self._queue = [j for j in self._queue if j.not_before <= now]
        targets = {r.id: r for r in self._dispatch_targets()}
        views = self._target_views()
        budget = None
        if self._disaggregated:
            budget = sum(r.engine.open_slots for r in self._replicas
                         if r.state == "live" and r.role != "prefill") \
                - len(self._handoffs)
        while self._queue:
            if budget is not None and budget <= 0:
                break
            pick = 0
            if self.router.mode == "affinity" and len(self._queue) > 1:
                # Best matched tokens within the window wins; policy order
                # breaks ties, so zero-match backlogs stay exactly FIFO.
                # Score only against views with an open slot: a match on a
                # busy replica can't be dispatched to this round.
                free = [v for v in views if v.open_slots > 0]
                best = 0
                for i in range(self._affinity_window()):
                    j = self._queue[i]
                    m = self.router.best_match_tokens(j.prompt, j.namespace,
                                                      free)
                    if m > best:
                        best, pick = m, i
            job = self._queue[pick]
            decision = self.router.route(job.prompt, job.namespace, views)
            if decision is None:
                break
            self._queue.pop(pick)
            r = targets[decision.replica_id]
            r.engine.enqueue(EngineRequest(job.rid, job.prompt, job.max_new,
                                           job.namespace))
            job.status = JobState.RUNNING
            job.replica = r.id
            if job.dispatched_at is None:
                job.dispatched_at = now
            r.jobs.add(job.rid)
            r.dispatched += 1
            for v in views:
                if v.replica_id == r.id:
                    v.open_slots -= 1
                    v.load += 1
            if budget is not None:
                budget -= 1
        if held:
            self._queue = self.admission.order(self._queue + held, now)

    # -- the data plane -----------------------------------------------------------
    MAX_DELIVERY_ATTEMPTS = 50

    def _deliver_handoffs(self, now: float) -> float:
        """Import in-flight KV payloads (prefill handoffs and evacuated
        requests) into decode-capable replicas.

        FIFO over the handoff queue; destinations are live, decode-capable,
        not under a revocation notice, and UP in the router's health view.
        Placement is router-guided: under affinity routing the payload's
        prefix may already be resident somewhere (an evacuated request
        landing back on a warm replica re-imports nothing extra but keeps
        sharing), falling back to least-loaded. A payload that no replica
        can take this round (no free slot, or not enough free pages) stays
        queued and retries next round — up to ``MAX_DELIVERY_ATTEMPTS``,
        after which the copy is abandoned and the job restarts from the
        prompt via the requeue path (a payload must never strand a job
        forever). Returns the round's ship seconds (max across deliveries —
        the copies run in parallel).
        """
        if not self._handoffs:
            return 0.0
        ship_s = 0.0
        dests = [r for r in self._replicas
                 if r.state == "live" and r.role != "prefill"
                 and r.notice_deadline is None
                 and self.router.health(r.id, now) == HEALTH_UP]
        still: list[list] = []
        for item in self._handoffs:
            payload, rid, attempts = item
            job = self.jobs[rid]
            placed = False
            # Least-loaded decode replica first: handoff placement balances
            # the decode fleet the way least-loaded dispatch would.
            order = sorted(dests, key=lambda x: (x.engine.live
                                                 + x.engine.queued, x.id))
            if self.router.mode == "affinity" and len(order) > 1:
                views = [ReplicaView(
                             x.id, x.engine.open_slots,
                             load=x.engine.live + x.engine.queued,
                             page_size=x.engine.page_size,
                             fingerprint=self._fp_tracker.refresh(
                                 x.id, x.engine.prefix_cache))
                         for x in order if x.engine.open_slots > 0
                         and x.engine.prefix_cache is not None]
                decision = self.router.route(payload.req.prompt,
                                             payload.req.namespace, views)
                if decision is not None:
                    # Stable sort: the router's pick first, the rest keep
                    # least-loaded order as fallbacks.
                    order.sort(key=lambda x: x.id != decision.replica_id)
            for r in order:
                if not r.engine.free_slots:
                    continue
                try:
                    r.engine.import_pages(payload)
                except CapacityError:
                    continue            # out of pages here: try the next
                job.replica = r.id
                job.status = JobState.RUNNING
                r.jobs.add(rid)
                r.idle_since = None
                if job.started_at is None:
                    # TTFT stops at first DECODE-slot occupancy — the
                    # disaggregated analogue of the unified admit stamp.
                    job.started_at = now
                ship_s = max(ship_s, self.model.ship_s(payload.nbytes))
                placed = True
                break
            if not placed:
                item[2] = attempts + 1
                if item[2] >= self.MAX_DELIVERY_ATTEMPTS:
                    self._requeue_job(job, now,
                                      detail="KV payload undeliverable "
                                             f"after {item[2]} rounds")
                else:
                    still.append(item)
        self._handoffs = still
        return ship_s

    def _pump(self, now: float) -> float:
        """Admit + decode one chunk on every live replica; returns the
        round's simulated seconds (max across replicas — they run in
        parallel). Disaggregated fleets first deliver in-flight KV
        handoffs (so this round's decode includes them), then the prefill
        replicas admit-and-export a fresh batch for the next round."""
        round_s = self._deliver_handoffs(now)
        for r in self._replicas:
            if r.state != "live":
                continue
            eng = r.engine
            if not eng.has_work:
                if r.idle_since is None:
                    r.idle_since = now
                continue
            r.idle_since = None
            admitted = eng.admit()
            fresh = eng.stats["prefill_tokens"] - r.pt_mark
            r.pt_mark = eng.stats["prefill_tokens"]
            work = self.model.prefill_s(fresh)
            if r.role == "prefill":
                # Prefill replicas never decode: every admitted request's
                # finished pages ship out immediately, freeing the slot for
                # the next admission wave. The source's prefix cache keeps
                # the registered entries, so the NEXT request with this
                # prefix pays only its fresh suffix here.
                for slot in sorted(eng._live):
                    rid = eng._live[slot].req.rid
                    payload = eng.export(slot=slot,
                                         reason=ExportReason.HANDOFF)
                    self._handoffs.append([payload, rid, 0])
                    self.jobs[rid].replica = None     # in flight
                    r.jobs.discard(rid)
                    self.stats["page_ships"] += 1
                    self.stats["page_ship_bytes"] += payload.nbytes
                if not admitted and eng.queued:
                    self._return_to_queue(r, eng.drop_queued(),
                                          requeued=False)
            elif eng.live:
                for live in eng._live.values():
                    job = self.jobs.get(live.req.rid)
                    if job is None:
                        continue
                    if job.started_at is None:
                        # First decode-slot occupancy: the TTFT clock stops
                        # here (modelled prefill is charged identically
                        # either way).
                        job.started_at = now
                    if job.disturbed_at is not None \
                            and job.recovered_at is None:
                        # First decode occupancy AFTER a disturbance: the
                        # recovered-TTFT clock (evacuation vs requeue) stops
                        # here, whichever path brought the job back.
                        job.recovered_at = now
                finished = eng.decode_step()
                work += eng.decode_chunk * self.model.decode_step_s \
                    * r.latency_mult
                for req, toks in finished:
                    job = self.jobs[req.rid]
                    job.status = JobState.DONE
                    job.tokens = toks
                    job.finished_at = now + work
                    job.replica = None
                    r.jobs.discard(req.rid)
                    self.completed_order.append(req.rid)
                    self.stats["tokens"] += len(toks)
                    self._observe_completion(job)
                if self.kv_store is not None and eng.demoted_out:
                    # Retirement demoted these requests' pages off the
                    # device (reason=DEMOTE): park them in the tier store.
                    for payload in eng.demoted_out:
                        self._demote_payload(payload, now)
                    eng.demoted_out.clear()
            elif eng.queued:
                # Admission produced nothing (transient page pressure, e.g.
                # a paused request's pinned pages): give the QUEUED requests
                # back to the central queue so another replica — or a later
                # round here — picks them up. drop_queued, not abort: an
                # abort would also surrender the paused requests parked on
                # this replica, releasing the very pages they pin.
                self._return_to_queue(r, eng.drop_queued(), requeued=False)
            round_s = max(round_s, work)
        return round_s

    # -- elasticity ----------------------------------------------------------------
    def _autoscale(self, now: float) -> None:
        # Elasticity governs DECODE capacity only: prefill-role replicas
        # are the static admission front end — never counted, launched, or
        # idle-terminated here.
        live = [r for r in self._replicas
                if r.state == "live" and r.role != "prefill"]
        provisioning = sum(1 for r in self._replicas
                           if r.state == "provisioning")
        idle = sum(1 for r in live if not r.engine.has_work)
        n = self.provisioner.launch_count(len(self._queue), idle,
                                          provisioning, len(live))
        for _ in range(n):
            self._launch(now)
        for r in live:
            if r.engine.has_work or r.jobs or r.idle_since is None:
                continue
            total = sum(1 for x in self._replicas
                        if x.state == "live" and x.role != "prefill")
            if self.provisioner.should_terminate(now - r.idle_since, total):
                self._retire_replica(r, terminated=True)

    def _launch(self, now: float, ready_now: bool = False) -> _Replica:
        engine = self._standby.pop() if self._standby \
            else self._bind_engine(self._engine_factory())
        zone = None
        if self.market is not None:
            zone = self.market.cheapest_zone(self.instance_type,
                                             now / 3600.0)[0]
        bid = self.scaling.bid_fraction * self._od_price()
        delay = 0.0 if ready_now else self.provisioner.provisioning_delay()
        r = _Replica(engine, zone, self.scaling.market, bid,
                     ready_at=now + delay)
        if delay == 0.0:
            r.state = "live"
            r.idle_since = now
        self._replicas.append(r)
        self.stats["launches"] += 1
        return r

    def _retire_replica(self, r: _Replica, *, terminated: bool) -> None:
        r.state = "retired"
        self._replicas.remove(r)
        self._standby.append(r.engine)
        # Replica ids never recur: stale health / fingerprint mirrors for a
        # retired id would only leak (and a parked engine's cache keeps
        # mutating if relaunched, so the mirror must restart anyway).
        self.router.forget(r.id)
        self._fp_tracker.forget(r.id)
        self._health_seen.pop(r.id, None)
        if terminated:
            self.stats["terminations"] += 1

    # -- billing / reporting ----------------------------------------------------
    def _accrue(self, now: float, tick: float) -> None:
        live = [r for r in self._replicas if r.state == "live"]
        for r in live:
            self.stats["cost_usd"] += \
                self._replica_price(r, now) * tick / 3600.0
            self.stats["replica_seconds"] += tick
        self.stats["peak_replicas"] = max(self.stats["peak_replicas"],
                                          len(live))
        if self.kv_store is not None:
            # Storage GB-hours accrue on the same virtual clock but stay a
            # separate meter: compute $/token and storage $/GB-hour answer
            # different sizing questions (the bench sums them).
            self.stats["storage_cost_usd"] += self.kv_store.accrue(now)

    def replicas(self, state: str = "live") -> list[_Replica]:
        return [r for r in self._replicas if r.state == state]

    def metrics(self) -> dict:
        """Serving report: throughput, deadline SLA, spend — the serving
        analogue of the Table VII-C makespan/cost/wait rows."""
        done = [j for j in self.jobs.values() if j.status is JobState.DONE]
        lat = sorted(j.finished_at - j.submitted_at for j in done)
        hits = sum(1 for j in done
                   if j.deadline is None or j.finished_at <= j.deadline)
        sim_s = self.clock.now() - self._start_time
        # Nearest-rank percentile: ceil(q*n)-1, not int(q*n) (which would
        # report the single worst latency as p95 for any n <= 20).
        def _pct(xs):
            return (lambda q: xs[min(max(math.ceil(q * len(xs)) - 1, 0),
                                     len(xs) - 1)]) \
                if xs else (lambda q: 0.0)
        pct = _pct(lat)
        # Interactive TTFT: queue wait until the first decode-slot
        # occupancy (modelled prefill excluded — identical across modes).
        inter = [j for j in self.jobs.values() if j.priority == 0]
        ittft = _pct(sorted(j.started_at - j.submitted_at
                            for j in inter
                            if j.status is JobState.DONE
                            and j.started_at is not None))
        idone = [j for j in inter if j.status is JobState.DONE]
        ihits = sum(1 for j in idone
                    if j.deadline is None or j.finished_at <= j.deadline)
        # Per-replica observability: the routing tier's decisions must be
        # auditable from the outside — who got the work, how full each
        # replica is, and whether affinity is actually landing cache hits.
        now = self.clock.now()
        per_replica = []
        for r in sorted(self._replicas, key=lambda x: x.id):
            if r.state == "retired":
                continue
            eng = r.engine
            per_replica.append({
                "replica": r.id, "role": r.role, "state": r.state,
                "live": eng.live, "queued": eng.queued,
                "open_slots": eng.open_slots,
                "occupancy": eng.live / eng.max_slots,
                "prefix_hit_rate": eng.prefix_hit_rate,
                "dispatched": r.dispatched,
                "health": self.router.health(r.id, now),
                "noticed": r.notice_deadline is not None,
            })
        health_counts = {"up": 0, "degraded": 0, "quarantined": 0}
        for row in per_replica:
            if row["state"] == "live":
                health_counts[row["health"]] += 1
        # Recovered TTFT: disturbance (notice/crash hit the job) to the
        # first decode-slot occupancy afterwards — the figure of merit the
        # fault_recovery bench compares across evacuation and requeue.
        disturbed = [j for j in self.jobs.values()
                     if j.disturbed_at is not None]
        rec = sorted(j.recovered_at - j.disturbed_at for j in disturbed
                     if j.recovered_at is not None)
        rpct = _pct(rec)
        ships = self.stats["page_ships"]
        return {
            "jobs": len(self.jobs), "completed": len(done),
            "shed": self.stats["shed"],
            "tokens": self.stats["tokens"],
            "sim_seconds": sim_s,
            "tok_per_sim_s": self.stats["tokens"] / sim_s if sim_s else 0.0,
            "cost_usd": self.stats["cost_usd"],
            "usd_per_1k_tokens": (self.stats["cost_usd"] * 1e3
                                  / max(self.stats["tokens"], 1)),
            "replica_seconds": self.stats["replica_seconds"],
            "peak_replicas": self.stats["peak_replicas"],
            "deadline_hit_rate": hits / len(done) if done else 0.0,
            "sla_rate": hits / len(self.jobs) if self.jobs else 0.0,
            "p50_latency_s": pct(0.50), "p95_latency_s": pct(0.95),
            "interactive_jobs": len(inter),
            "interactive_completed": len(idone),
            "interactive_sla_rate": ihits / len(inter) if inter else 0.0,
            "interactive_p50_ttft_s": ittft(0.50),
            "interactive_p99_ttft_s": ittft(0.99),
            "preemptions": self.stats["preemptions"],
            "resumes": self.stats["resumes"],
            "preempt_wait_s": self.stats["preempt_wait_s"],
            "revocations": self.stats["revocations"],
            "requeues": self.stats["requeues"],
            "notices": self.stats["notices"],
            "evacuations": self.stats["evacuations"],
            "evacuated_pages_bytes": self.stats["evacuated_pages_bytes"],
            "retries": self.stats["retries"],
            "backoff_wait_s": self.stats["backoff_wait_s"],
            "wasted_decode_tokens": self.stats["wasted_decode_tokens"],
            "faults_injected": self.stats["faults_injected"],
            "disturbed_jobs": len(disturbed),
            "recovered_jobs": len(rec),
            "recovered_ttft_mean_s": (sum(rec) / len(rec)) if rec else 0.0,
            "recovered_ttft_p99_s": rpct(0.99),
            "replica_health": health_counts,
            "fingerprint_tracker": dict(self._fp_tracker.stats),
            "launches": self.stats["launches"],
            "terminations": self.stats["terminations"],
            "routing_mode": self.router.mode,
            "routing": dict(self.router.stats),
            "queue_depth": len(self._queue),
            "page_ships": ships,
            "page_ship_bytes": self.stats["page_ship_bytes"],
            "page_ship_bytes_per_ship": (self.stats["page_ship_bytes"]
                                         / ships if ships else 0.0),
            "handoffs_in_flight": len(self._handoffs),
            "kv_demotions": self.stats["kv_demotions"],
            "kv_demoted_bytes": self.stats["kv_demoted_bytes"],
            "kv_restores": self.stats["kv_restores"],
            "kv_restore_fallbacks": self.stats["kv_restore_fallbacks"],
            "kv_budget_refusals": self.stats["kv_budget_refusals"],
            "restored_tokens": self.stats["restored_tokens"],
            "storage_cost_usd": self.stats["storage_cost_usd"],
            "restore_pending": sum(
                1 for j in self.jobs.values()
                if j.status is JobState.RESTORE_PENDING),
            "kv_host_bytes": (self.kv_store.host_bytes
                              if self.kv_store is not None else 0),
            "kv_object_bytes": (self.kv_store.object_bytes
                                if self.kv_store is not None else 0),
            "kv_store": (dict(self.kv_store.stats)
                         if self.kv_store is not None else None),
            "per_replica": per_replica,
            "slo_burn_rate": self._slo_burn_rate(),
            "telemetry_flushes": self.stats["telemetry_flushes"],
            "telemetry_writes": self.stats["telemetry_writes"],
            "telemetry_dropped": self.stats["telemetry_dropped"],
            "statestore_throttled": self.stats["statestore_throttled"],
        }

    def _slo_burn_rate(self) -> float:
        self.registry.collect()
        return self.registry.value("kotta_slo_burn_rate")
