"""Discrete-event simulator for the elastic-scaling study (paper §VII-C), a
copy of the reference's ``repro/core/simulator.py``.

Reproduces Table VII-C and Fig 5: a 40-job workload submitted over four hours
(Poisson inter-arrivals, mean 0.1667 h), job durations {1, 3, 4} h with mix
{40%, 20%, 40%} (±5% jitter), input datasets of {1,3,5,7,9} GB staged from the
object store, executed under the *none / limited / unlimited* scaling
strategies on on-demand or spot markets. Costs are at the paper's 2016 EC2
prices; nothing here runs on a device.

The simulator shares its decision logic (``Provisioner``) and price model
(``SpotMarket``) with the live runtime. Where it departs from the
reference: beside ``_instances`` (every instance ever created, which
billing still walks) it keeps the live ones in an insertion-ordered index,
so the assignment, provisioning, idle and revocation passes and the
per-event counts walk the live fleet, not its whole history, and it
reads the spot price from one cached trace (``_price``), where
``SpotMarket.price`` draws the trace from hour 0 at every call. The
reference does both at every event and every billed hour, which makes a
run that revokes its fleet every hour quadratic in its length; the
reports are equal field by field, timelines included.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .clock import hours
from .cost import ComputePricing
from .elastic import Provisioner, ProvisioningModel, ScalingPolicy
from .market import DEFAULT_ZONES, SpotMarket


@dataclass
class SimJob:
    job_id: int
    arrival_s: float
    duration_s: float
    data_gb: float
    # filled during simulation
    stage_start_s: Optional[float] = None
    exec_start_s: Optional[float] = None
    done_s: Optional[float] = None
    attempts: int = 0

    @property
    def wait_s(self) -> float:
        return (self.stage_start_s or 0.0) - self.arrival_s


@dataclass
class SimInstance:
    inst_id: int
    market: str                     # "spot" | "on_demand"
    requested_s: float
    ready_s: Optional[float] = None
    terminated_s: Optional[float] = None
    idle_since_s: Optional[float] = None
    busy_job: Optional[int] = None
    revoked: bool = False

    def alive_hours(self) -> float:
        if self.ready_s is None or self.terminated_s is None:
            return 0.0
        return max(0.0, (self.terminated_s - self.ready_s) / 3600.0)


def make_paper_workload(seed: int = 7, n_jobs: int = 40,
                        window_h: float = 4.0) -> list[SimJob]:
    """The §VII-C synthetic workload."""
    rng = random.Random(seed)
    jobs, t = [], 0.0
    durations = [1.0, 3.0, 4.0]
    weights = [0.4, 0.2, 0.4]
    mean_interarrival_h = window_h / n_jobs  # paper: λ = 0.1667 h
    for i in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival_h)
        base_h = rng.choices(durations, weights)[0]
        dur_h = base_h * (1.0 + rng.uniform(-0.05, 0.05))
        data_gb = rng.choice([1.0, 3.0, 5.0, 7.0, 9.0])
        jobs.append(SimJob(i, hours(t), hours(dur_h), data_gb))
    return jobs


@dataclass
class SimReport:
    policy: str
    min_nodes: int
    max_nodes: Optional[int]
    makespan_s: float
    spot_cost: float
    on_demand_cost: float
    max_wait_s: float
    avg_wait_s: float
    revocations: int
    resubmissions: int
    peak_instances: int
    instance_hours: float
    jobs: list[SimJob] = field(default_factory=list)
    timeline: list[tuple[float, int, int]] = field(default_factory=list)  # (t, total, idle)


class ElasticSimulator:
    """Event-driven model of queues + provisioner + market."""

    ARRIVE, READY, STAGED, DONE, IDLE_CHECK, HOUR = range(6)

    def __init__(self, policy: ScalingPolicy,
                 workload: list[SimJob],
                 market: SpotMarket | None = None,
                 provisioning: ProvisioningModel | None = None,
                 pricing: ComputePricing | None = None,
                 instance_type: str = "m4.xlarge",
                 stage_bw_gb_s: float = 0.1,
                 stage_out_s: float = 10.0,
                 seed: int = 0):
        self.policy = policy
        self.provisioner = Provisioner(policy, provisioning, seed=seed)
        self.market = market or SpotMarket(seed=seed)
        self.pricing = pricing or ComputePricing()
        self.instance_type = instance_type
        self.zone = DEFAULT_ZONES[0]
        self.stage_bw_gb_s = stage_bw_gb_s
        self.stage_out_s = stage_out_s
        self.workload = [SimJob(j.job_id, j.arrival_s, j.duration_s, j.data_gb)
                         for j in workload]
        self._seq = itertools.count()
        self._events: list[tuple[float, int, int, tuple]] = []
        self._queue: list[int] = []
        self._instances: dict[int, SimInstance] = {}
        self._live: dict[int, SimInstance] = {}   # not terminated, in order
        self._inst_ids = itertools.count()
        self._revocations = 0
        self._resubmissions = 0
        self._timeline: list[tuple[float, int, int]] = []
        self._trace = np.empty(0)

    # -- event helpers ------------------------------------------------------
    def _push(self, t: float, kind: int, payload: tuple = ()) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _price(self, t: float) -> float:
        """``market.price`` at ``t`` seconds. That call draws the zone's trace
        from hour 0 every time; a trace's prefix does not depend on its
        length, so one trace, regrown to twice the hour asked for when it
        falls short, gives the same floats."""
        idx = max(0, int(t / 3600.0))
        if idx >= len(self._trace):
            self._trace = self.market.trace(self.zone, self.instance_type,
                                            2 * idx + 1)
        return float(self._trace[idx])

    def _od_price(self) -> float:
        return self.pricing.on_demand_per_hour[self.instance_type]

    # -- accounting -----------------------------------------------------------
    def _bill(self, inst: SimInstance) -> tuple[float, float]:
        """(spot_cost, on_demand_cost) for an instance's lifetime."""
        if inst.ready_s is None or inst.terminated_s is None:
            return 0.0, 0.0
        od, spot = self._od_price(), 0.0
        t = inst.ready_s
        while t < inst.terminated_s:
            nxt = min(inst.terminated_s, (math.floor(t / 3600.0) + 1) * 3600.0)
            frac_h = (nxt - t) / 3600.0
            spot += frac_h * (self._price(t) if inst.market == "spot" else od)
            t = nxt
        return spot, od * inst.alive_hours()

    # -- main loop ---------------------------------------------------------------
    def run(self) -> SimReport:
        for job in self.workload:
            self._push(job.arrival_s, self.ARRIVE, (job.job_id,))
        self._push(3600.0, self.HOUR)
        # Static floor (the paper's "no scaling" pool exists from t=0).
        self._control(0.0)

        done = 0
        makespan_end = 0.0
        while self._events and done < len(self.workload):
            t, _, kind, payload = heapq.heappop(self._events)
            if kind == self.ARRIVE:
                self._queue.append(payload[0])
            elif kind == self.READY:
                inst = self._instances[payload[0]]
                if not inst.revoked and inst.terminated_s is None:
                    inst.ready_s = t
                    inst.idle_since_s = t
            elif kind == self.STAGED:
                job_id, inst_id = payload
                inst = self._instances[inst_id]
                if inst.busy_job == job_id and inst.terminated_s is None:
                    job = self.workload[job_id]
                    job.exec_start_s = t
                    self._push(t + job.duration_s + self.stage_out_s,
                               self.DONE, (job_id, inst_id))
            elif kind == self.DONE:
                job_id, inst_id = payload
                inst = self._instances[inst_id]
                if inst.busy_job == job_id and inst.terminated_s is None:
                    job = self.workload[job_id]
                    job.done_s = t
                    done += 1
                    makespan_end = max(makespan_end, t)
                    inst.busy_job = None
                    inst.idle_since_s = t
                    self._push(t + self.policy.idle_timeout_s, self.IDLE_CHECK,
                               (inst_id,))
            elif kind == self.IDLE_CHECK:
                inst = self._instances[payload[0]]
                if (inst.terminated_s is None and inst.busy_job is None
                        and inst.idle_since_s is not None):
                    idle_for = t - inst.idle_since_s
                    if self.provisioner.should_terminate(idle_for,
                                                         len(self._live)):
                        self._terminate(inst, t)
            elif kind == self.HOUR:
                self._spot_sweep(t)
                if done < len(self.workload):
                    self._push(t + 3600.0, self.HOUR)
            self._control(t)
            total = sum(1 for i in self._live.values() if i.ready_s is not None)
            idle = sum(1 for i in self._live.values()
                       if i.ready_s is not None and i.busy_job is None)
            self._timeline.append((t, total, idle))

        # Tear down whatever is still alive at the end of the experiment.
        end = makespan_end
        for inst in list(self._live.values()):
            self._terminate(inst, max(end, inst.ready_s or end))

        spot_cost = od_cost = 0.0
        for inst in self._instances.values():
            s, o = self._bill(inst)
            spot_cost += s
            od_cost += o
        waits = [j.wait_s for j in self.workload]
        first = min(j.arrival_s for j in self.workload)
        return SimReport(
            policy=self._policy_name(),
            min_nodes=self.policy.min_nodes,
            max_nodes=self.policy.max_nodes,
            makespan_s=makespan_end - first,
            spot_cost=spot_cost,
            on_demand_cost=od_cost,
            max_wait_s=max(waits),
            avg_wait_s=sum(waits) / len(waits),
            revocations=self._revocations,
            resubmissions=self._resubmissions,
            peak_instances=max((n for _, n, _ in self._timeline), default=0),
            instance_hours=sum(i.alive_hours() for i in self._instances.values()),
            jobs=self.workload,
            timeline=self._timeline,
        )

    def _policy_name(self) -> str:
        if self.policy.max_nodes is None:
            return "unlimited"
        if self.policy.min_nodes == self.policy.max_nodes:
            return "none"
        return "limited"

    # -- pieces ---------------------------------------------------------------
    def _terminate(self, inst: SimInstance, t: float) -> None:
        inst.terminated_s = t
        del self._live[inst.inst_id]

    def _control(self, t: float) -> None:
        """Assign queued jobs to idle instances; provision for the deficit."""
        idle = [i for i in self._live.values()
                if i.ready_s is not None and i.busy_job is None]
        while self._queue and idle:
            job_id = self._queue.pop(0)
            inst = idle.pop(0)
            job = self.workload[job_id]
            inst.busy_job = job_id
            inst.idle_since_s = None
            job.attempts += 1
            if job.stage_start_s is None:
                job.stage_start_s = t
            self._push(t + job.data_gb / self.stage_bw_gb_s, self.STAGED,
                       (job_id, inst.inst_id))
        provisioning = sum(1 for i in self._live.values() if i.ready_s is None)
        total = len(self._live)
        n = self.provisioner.launch_count(len(self._queue), len(idle),
                                          provisioning, total)
        for _ in range(n):
            inst = SimInstance(next(self._inst_ids), self.policy.market, t)
            self._instances[inst.inst_id] = inst
            self._live[inst.inst_id] = inst
            delay = (self.provisioner.provisioning_delay()
                     if self.policy.market == "spot" or t > 0 else 0.0)
            # A static pool (no-scaling) is provisioned ahead of the workload.
            if self.policy.min_nodes == self.policy.max_nodes:
                delay = 0.0
            self._push(t + delay, self.READY, (inst.inst_id,))

    def _spot_sweep(self, t: float) -> None:
        """Hourly revocation check: market price above bid kills instances."""
        if self.policy.market != "spot":
            return
        bid = self._od_price() * self.policy.bid_fraction
        if self._price(t) <= bid:
            return
        for inst in list(self._live.values()):
            if inst.market == "spot":
                self._terminate(inst, t)
                inst.revoked = True
                self._revocations += 1
                if inst.busy_job is not None:
                    # Paper §V-B: reschedule on a fresh instance; progress lost.
                    job = self.workload[inst.busy_job]
                    job.exec_start_s = None
                    self._queue.insert(0, inst.busy_job)
                    self._resubmissions += 1
                    inst.busy_job = None


def run_table7c(seed: int = 7) -> list[SimReport]:
    """The five Table VII-C rows."""
    workload = make_paper_workload(seed=seed)
    rows = [
        ScalingPolicy.none(40),
        ScalingPolicy.none(20),
        ScalingPolicy.unlimited(),
        ScalingPolicy.limited(20),
        ScalingPolicy.limited(10),
    ]
    return [ElasticSimulator(p, workload, seed=seed).run() for p in rows]
