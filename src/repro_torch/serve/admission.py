"""Deadline/cost-aware admission for the Kotta serving gateway.

Cloud Kotta's control plane never runs work "because it arrived": every task
goes through a queue whose consumers are provisioned against explicit cost
and urgency signals (dev vs prod queues, §IV-D; elastic provisioning against
queue depth, §IV-C; the Table VII-C cost/makespan trade). This module is the
serving-side analogue for generation requests:

- An :class:`AdmissionPolicy` keeps the gateway's pending queue **ordered**
  — :class:`DeadlineCostPolicy` runs earliest-deadline-first *within* a
  priority class (interactive before batch, the companion paper's
  interactive-analytics requirement), FCFS breaking ties.
- The same policy **sheds** requests that cannot meet their deadline at
  current occupancy: a slot-horizon feasibility walk (who frees a decode
  slot when, with the queue ahead of you) estimates each request's finish
  time, and an infeasible request surfaces a **typed rejection**
  (:class:`DeadlineInfeasible`) instead of hanging in the queue.
- Requests carrying a ``cost_budget`` are priced with the instance rates in
  :mod:`repro_torch.core.cost` before they occupy capacity; a request whose
  estimated serving cost exceeds its budget is rejected with
  :class:`CostBudgetExceeded`.
- Before an **interactive** request is shed as infeasible, the policy may
  instead nominate a running lower-class request for **decode preemption**
  (:meth:`DeadlineCostPolicy.plan_preemption`): among the batch-class slots
  it picks the latest-deadline victim whose pause lets the interactive
  request start immediately *and* still leaves the victim able to meet its
  own deadline after a lossless resume (paused decode re-prefills nothing,
  so the resume cost is exactly its remaining decode steps). The companion
  paper's interactive-analytics requirement: scarce capacity serves the
  urgent class first, without breaking the batch class's promises.

Requests that a replica already accepted and then lost to spot revocation
are re-enqueued with ``requeued=True`` and are exempt from shedding —
Kotta's queue-watcher semantics: accepted work is completed, whatever the
market does (§IV-D resubmission).
"""
from __future__ import annotations

import enum
import heapq
import math
from dataclasses import dataclass, field, replace
from typing import Optional


class AdmissionError(Exception):
    """Typed admission rejection — shed requests fail fast, never hang."""

    reason = "rejected"


class DeadlineInfeasible(AdmissionError):
    """At current occupancy the request cannot finish by its deadline."""

    reason = "deadline_infeasible"


class CostBudgetExceeded(AdmissionError):
    """Estimated serving cost exceeds the request's cost budget."""

    reason = "cost_budget_exceeded"


class RetryBudgetExhausted(AdmissionError):
    """The job lost its replica more times than the gateway's retry budget
    allows; retrying further would let one cursed request spin forever."""

    reason = "retry_budget_exhausted"


class StorageBudgetExceeded(AdmissionError):
    """Demoting this tenant's KV pages would exceed its storage budget —
    the tiered KV store refuses the demotion with a typed error instead of
    silently dropping pages or billing past the cap."""

    reason = "storage_budget_exceeded"


class JobState(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PAUSED = "paused"        # decode-preempted; KV pages pinned on a replica
    # Waiting on an async KV restore from a lower storage tier — the
    # serving mirror of the batch scheduler's WAITING_DATA state: the job
    # holds its queue position but dispatch won't touch it until the
    # restore's modelled completion time passes.
    RESTORE_PENDING = "restore_pending"
    DONE = "done"
    SHED = "shed"


@dataclass
class ServeJob:
    """A generation request as a first-class Kotta job.

    ``deadline`` and timestamps are absolute gateway-clock seconds;
    ``priority`` is the class (lower = more urgent; 0 = interactive) and EDF
    runs *within* a class. ``namespace`` is the tenant-scoped prefix-cache
    key (tenant principal, data zone). ``requeued`` marks a job that lost
    its replica to spot revocation: it skips shed checks on readmission.

    Failure accounting: ``retries`` counts replica losses that sent the job
    back through the queue (capped by the gateway's retry budget);
    ``not_before`` is the capped-exponential-backoff gate — dispatch holds
    the job until the clock passes it. ``disturbed_at`` / ``recovered_at``
    bracket the most recent disturbance (evacuation or requeue) and its
    recovery (back in a decode slot), the pair behind the bench's
    recovered-request TTFT. ``evacuations`` counts notice-window KV
    migrations that carried the job's live state to a surviving replica.
    """

    rid: int
    tenant: str
    prompt: list[int]
    max_new: int
    submitted_at: float
    deadline: Optional[float] = None
    priority: int = 1
    cost_budget: Optional[float] = None
    namespace: object = None
    status: JobState = JobState.QUEUED
    tokens: Optional[list[int]] = None
    started_at: Optional[float] = None   # first admitted into a decode slot
    dispatched_at: Optional[float] = None   # left the central queue
                                            # (queue-wait histogram stamp)
    finished_at: Optional[float] = None
    error: Optional[AdmissionError] = None
    requeued: bool = False
    replica: Optional[int] = None
    retries: int = 0
    not_before: float = 0.0
    disturbed_at: Optional[float] = None
    recovered_at: Optional[float] = None
    evacuations: int = 0
    # Tiered-KV restore accounting: how many async tier restores this job
    # waited on (RESTORE_PENDING parks) and how many prompt tokens its
    # admission served from restored pages instead of re-prefill.
    restores: int = 0
    restored_tokens: int = 0


@dataclass(frozen=True)
class PreemptCandidate:
    """A running request the gateway could pause to admit a more urgent one.

    ``remaining_tokens`` is the victim's outstanding decode budget — after a
    lossless pause/resume (pages pinned, zero re-prefill) that is its ONLY
    remaining cost, which is what makes the feasibility arithmetic exact.
    """

    job: ServeJob
    remaining_tokens: int
    replica_id: int
    slot: int


@dataclass(frozen=True)
class ServiceModel:
    """Simulated replica service rates (virtual-clock seconds).

    The gateway runs on a virtual clock: decode
    wall time is modelled, not measured, so cost/deadline accounting is
    deterministic across hosts (the same move as the Table VII-C DES).
    Prefill is charged per *fresh* token — prompt tokens served from the
    tenant's prefix cache are free, so cache locality shows up in deadline
    headroom exactly like Kotta's data-local placement shows up in job
    turnaround.
    """

    prefill_tok_per_s: float = 4096.0
    decode_step_s: float = 0.05      # one lockstep token row across slots
    # Page-shipping bandwidth for disaggregated prefill->decode handoffs
    # (host/interconnect copy of the finished KV pages).
    kv_ship_bytes_per_s: float = 8e9
    # Calibration: measured end-to-end service time over the raw
    # prefill+decode estimate. The raw model ignores dispatch rounds,
    # chunked-prefill interleave, and queue-pump granularity, so under
    # sustained load the real per-request service time runs above it; the
    # saturation bench fits this factor from measured throughput
    # (:meth:`calibrated`) so admission's feasibility math tracks reality
    # instead of the optimistic floor. Applies to ``service_s`` only —
    # billing/shipping estimates stay raw.
    overhead: float = 1.0

    def prefill_s(self, n_tokens: int) -> float:
        return n_tokens / self.prefill_tok_per_s

    def ship_s(self, nbytes: int) -> float:
        return nbytes / self.kv_ship_bytes_per_s

    def service_s(self, prompt_len: int, max_new: int,
                  cached_tokens: int = 0) -> float:
        """End-to-end service estimate; ``cached_tokens`` is the prompt
        prefix the target replica already holds (routing-aware feasibility:
        an affinity hit shrinks the prefill bill, never below the one
        always-recomputed token)."""
        fresh = max(prompt_len - max(cached_tokens, 0), 1)
        return (self.prefill_s(fresh) + max_new * self.decode_step_s) \
            * self.overhead

    def assumed_req_per_s(self, prompt_len: int, max_new: int,
                          slots: int) -> float:
        """Throughput this model *assumes* ``slots`` decode slots deliver
        for a homogeneous workload — the number the saturation bench
        compares against measured throughput to expose model drift."""
        base = replace(self, overhead=1.0)
        return slots / base.service_s(prompt_len, max_new)

    def calibrated(self, measured_req_per_s: float, *, prompt_len: int,
                   max_new: int, slots: int) -> "ServiceModel":
        """Fit ``overhead`` so the model's implied throughput for this
        workload equals the measured one. Never calibrates below 1.0 — a
        measurement above the raw model (burst luck, cache hits) must not
        make admission *more* optimistic than physics."""
        if measured_req_per_s <= 0:
            raise ValueError(f"measured_req_per_s must be > 0, got "
                             f"{measured_req_per_s}")
        assumed = self.assumed_req_per_s(prompt_len, max_new, slots)
        return replace(self, overhead=max(1.0, assumed / measured_req_per_s))


class AdmissionPolicy:
    """FCFS baseline: submit order, no shedding (the pre-gateway engine)."""

    name = "fcfs"

    def order(self, jobs: list[ServeJob], now: float) -> list[ServeJob]:
        return sorted(jobs, key=lambda j: (j.submitted_at, j.rid))

    def plan(self, jobs: list[ServeJob], slot_free_s: list[float],
             now: float, price_per_slot_hour: float, *,
             cached_tokens: dict[int, int] | None = None,
             extra_delay_s: dict[int, float] | None = None,
             ) -> tuple[list[ServeJob], list[tuple[ServeJob,
                                                   AdmissionError]]]:
        """Return (keep_ordered, shed) — FCFS keeps everything.

        ``cached_tokens`` maps job rid -> prompt tokens the routing tier
        expects the chosen replica to serve from its prefix cache;
        ``extra_delay_s`` maps job rid -> pre-service latency the job must
        absorb before it can start (e.g. an async KV restore from a lower
        storage tier). Both are ignored by FCFS, which does no feasibility
        math.
        """
        return self.order(jobs, now), []

    def plan_preemption(self, job: ServeJob,
                        candidates: list[PreemptCandidate],
                        now: float) -> Optional[PreemptCandidate]:
        """Victim whose pause would admit ``job``; FCFS never preempts."""
        return None


FCFSPolicy = AdmissionPolicy


@dataclass
class DeadlineCostPolicy(AdmissionPolicy):
    """EDF within priority class + slot-horizon shedding + budget pricing.

    ``slot_free_s`` is the gateway's capacity horizon: one entry per decode
    slot across live and provisioning replicas, holding the absolute time
    that slot next frees (now, for an idle slot; the replica's ready time,
    for a provisioning one). The plan walks the ordered queue assigning
    each job the earliest slot — exactly the EDF feasibility test — and
    sheds jobs whose estimated finish overruns their deadline. Shedding is
    re-evaluated every round, so a job that was feasible when queued is
    still shed the moment a burst ahead of it makes the deadline hopeless
    (and capacity is spent on requests that can still win).
    """

    model: ServiceModel = field(default_factory=ServiceModel)
    # Decode preemption: pause the latest-deadline batch-class slot to admit
    # an otherwise-infeasible interactive request (both deadlines must hold).
    preempt: bool = True
    name = "edf_cost"

    def order(self, jobs: list[ServeJob], now: float) -> list[ServeJob]:
        return sorted(jobs, key=lambda j: (
            j.priority,
            j.deadline if j.deadline is not None else math.inf,
            j.submitted_at, j.rid))

    def plan(self, jobs, slot_free_s, now, price_per_slot_hour, *,
             cached_tokens=None, extra_delay_s=None):
        ordered = self.order(jobs, now)
        keep: list[ServeJob] = []
        shed: list[tuple[ServeJob, AdmissionError]] = []
        horizon = list(slot_free_s)
        heapq.heapify(horizon)
        for job in ordered:
            # Routing-aware feasibility: prompt tokens the router expects
            # the affinity target to serve from cache don't bill prefill
            # time, so a request that is only feasible ON its warm replica
            # is kept instead of shed. A pending tier restore adds its
            # modelled latency up front (restore-latency-aware deadline
            # feasibility): the job can't start until its pages are back,
            # but once they are, the restored prefix prefills for free.
            cached = 0 if cached_tokens is None \
                else cached_tokens.get(job.rid, 0)
            svc = self.model.service_s(len(job.prompt), job.max_new, cached)
            if extra_delay_s is not None:
                svc += max(0.0, extra_delay_s.get(job.rid, 0.0))
            if not job.requeued and job.cost_budget is not None:
                est_cost = svc / 3600.0 * price_per_slot_hour
                if est_cost > job.cost_budget:
                    shed.append((job, CostBudgetExceeded(
                        f"job {job.rid}: estimated ${est_cost:.4f} over "
                        f"budget ${job.cost_budget:.4f} "
                        f"({svc:.1f}s at ${price_per_slot_hour:.3f}/slot-h)"
                    )))
                    continue
            if horizon:
                slot_t = heapq.heappop(horizon)
                start = max(slot_t, now)
            else:
                # No capacity exists yet (all replicas still provisioning
                # and none announced): be optimistic — the provisioner
                # launches against queue depth — but still shed a job whose
                # deadline is hopeless even with an instant start.
                slot_t, start = None, now
            finish = start + svc
            if (not job.requeued and job.deadline is not None
                    and finish > job.deadline):
                shed.append((job, DeadlineInfeasible(
                    f"job {job.rid}: estimated finish t={finish:.1f}s "
                    f"misses deadline t={job.deadline:.1f}s at current "
                    f"occupancy")))
                if slot_t is not None:      # slot not consumed: hand it back
                    heapq.heappush(horizon, slot_t)
                continue
            keep.append(job)
            if slot_t is not None:
                heapq.heappush(horizon, finish)
        return keep, shed

    def plan_preemption(self, job, candidates, now):
        """Pick the victim whose pause admits ``job`` within BOTH deadlines.

        Eligibility: the victim must belong to a strictly lower priority
        class, ``job`` must finish by its deadline given an *instant* start
        on the freed slot, and the victim — resumed after ``job`` finishes,
        paying only its remaining decode steps (pause/resume is lossless:
        pages pinned, zero re-prefill) — must still meet its own deadline.
        Among eligible victims the LATEST-deadline one is paused: it has the
        most slack to absorb the added wait, so preemption consumes the
        cheapest SLA headroom first. Returns None (shed proceeds) when no
        victim qualifies or preemption is disabled.
        """
        if not self.preempt:
            return None
        svc = self.model.service_s(len(job.prompt), job.max_new)
        finish = now + svc
        if job.deadline is not None and finish > job.deadline:
            return None          # even an instant start cannot make it
        best, best_key = None, None
        for c in candidates:
            if c.job.priority <= job.priority:
                continue         # only a lower class may be paused
            resume_finish = finish \
                + c.remaining_tokens * self.model.decode_step_s
            if c.job.deadline is not None \
                    and resume_finish > c.job.deadline:
                continue         # pausing would break the victim's own SLA
            key = (math.inf if c.job.deadline is None else c.job.deadline,
                   c.job.submitted_at, c.job.rid)
            if best is None or key > best_key:
                best, best_key = c, key
        return best
