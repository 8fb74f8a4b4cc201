"""Reliable job management (paper §IV-D), a copy of the reference's
``repro/core/scheduler.py``. Components, mirroring the paper's
architecture figure:

- ``StateStore``   — the DynamoDB analogue: a transactional key-value store
  with **provisioned read/write capacity** (token buckets). The Fig-6
  throughput experiment saturates exactly here, like the paper's. The
  serve gateway flushes its telemetry into one through the non-blocking
  ``try_*`` variants; ``ShardedStateStore`` partitions one by key hash.
- ``JobQueue``     — the SQS analogue: leases with visibility timeouts.
- ``Worker``       — polls a queue, loads the task description from the
  StateStore, *assumes the submitting user's role* to stage inputs, reverts
  to ``task-executor`` for execution, writes status markers/heartbeats,
  stages outputs back, marks itself idle (the full §VI worker dance).
- ``QueueWatcher`` — resubmits tasks whose worker heartbeat went stale (spot
  revocation) and launches **speculative duplicates** of stragglers.
- ``KottaService`` — user-facing facade: submit/monitor jobs, with RBAC.

Jobs whose inputs are still in ``ARCHIVE`` are parked in a *restore queue*
until the object store reports availability (paper §V-A).

The runtime is pure Python and owns no device: an executable decides where
its work runs (on the card, the port's ``ElasticTrainer`` with
``device="cuda"``). Where it departs from the reference, no record,
status, note, audit entry or queue order differs:

- the threads' stop event is ``_halt``: the reference's ``_stop`` shadows
  ``threading.Thread._stop``, so its ``join`` raises on Python 3.12;
- ``KottaService.shutdown`` joins every thread it started, the watcher
  and revoked workers included;
- a cancelled or failed executable's frames are released before the job
  goes back to the queue, so its next attempt never shares the device
  with the last one's tensors.
"""
from __future__ import annotations

import enum
import itertools
import statistics
import threading
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .clock import Clock
from .lifecycle import ObjectStore, SecureStorage, Tier
from .security import AuthorizationError, PolicyEngine, SessionToken


# ---------------------------------------------------------------------------
# StateStore (DynamoDB analogue)
# ---------------------------------------------------------------------------

class _TokenBucket:
    """Provisioned-capacity limiter: ``rate`` ops/s, burst = rate."""

    def __init__(self, rate: float, clock: Clock):
        self.rate = float(rate)
        self.clock = clock
        self._tokens = float(rate)
        self._last = clock.now()
        self._lock = threading.Lock()

    def acquire(self, n: float = 1.0) -> None:
        while True:
            with self._lock:
                now = self.clock.now()
                self._tokens = min(self.rate, self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                wait = (n - self._tokens) / self.rate
            self.clock.sleep(wait)

    def try_acquire(self, n: float = 1.0) -> bool:
        """Non-blocking acquire: take ``n`` tokens if available now, else
        report a throttle. The single-threaded serve gateway advances its
        own VirtualClock, so it can never block in ``acquire`` (nothing
        else would advance the clock) — its telemetry writes use this path
        and count the refusals, which is also exactly the DynamoDB
        ProvisionedThroughputExceeded signal the Fig-6 saturation
        experiment is about."""
        with self._lock:
            now = self.clock.now()
            self._tokens = min(self.rate, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class StateStore:
    """Transactional item store with provisioned read/write capacity.

    The paper provisioned DynamoDB at 100 reads/s and 400 writes/s for the
    throughput experiment; those are the defaults here.

    Blocking ops (``put_item`` …) wait out a capacity shortfall on the
    clock — correct for worker threads while another thread advances the
    VirtualClock. The ``try_*`` variants never block: they fail fast and
    bump ``throttled_writes`` / ``throttled_reads``, for callers that
    advance the clock themselves (the serve gateway's telemetry flush).
    """

    def __init__(self, clock: Clock | None = None,
                 read_capacity: float = 100.0, write_capacity: float = 400.0):
        self.clock = clock or Clock()
        self.read_capacity = float(read_capacity)
        self.write_capacity = float(write_capacity)
        self._items: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._reads = _TokenBucket(read_capacity, self.clock)
        self._writes = _TokenBucket(write_capacity, self.clock)
        self.read_count = 0
        self.write_count = 0
        self.throttled_reads = 0
        self.throttled_writes = 0

    def put_item(self, key: str, item: dict[str, Any]) -> None:
        self._writes.acquire()
        with self._lock:
            self._items[key] = dict(item)
            self.write_count += 1

    def update_item(self, key: str, **updates: Any) -> None:
        self._writes.acquire()
        with self._lock:
            self._items.setdefault(key, {}).update(updates)
            self.write_count += 1

    def get_item(self, key: str) -> Optional[dict[str, Any]]:
        self._reads.acquire()
        with self._lock:
            self.read_count += 1
            item = self._items.get(key)
            return dict(item) if item is not None else None

    def scan(self, prefix: str = "") -> dict[str, dict[str, Any]]:
        self._reads.acquire()
        with self._lock:
            self.read_count += 1
            return {k: dict(v) for k, v in self._items.items() if k.startswith(prefix)}

    # -- non-blocking (throttle-counting) variants ---------------------------
    def try_put_item(self, key: str, item: dict[str, Any]) -> bool:
        if not self._writes.try_acquire():
            with self._lock:
                self.throttled_writes += 1
            return False
        with self._lock:
            self._items[key] = dict(item)
            self.write_count += 1
        return True

    def try_update_item(self, key: str, **updates: Any) -> bool:
        if not self._writes.try_acquire():
            with self._lock:
                self.throttled_writes += 1
            return False
        with self._lock:
            self._items.setdefault(key, {}).update(updates)
            self.write_count += 1
        return True

    def try_get_item(self, key: str) -> tuple[bool, Optional[dict[str, Any]]]:
        """(served, item) — ``(False, None)`` means throttled, not absent."""
        if not self._reads.try_acquire():
            with self._lock:
                self.throttled_reads += 1
            return False, None
        with self._lock:
            self.read_count += 1
            item = self._items.get(key)
            return True, (dict(item) if item is not None else None)


class ShardedStateStore:
    """Hash-by-key sharding over N :class:`StateStore` partitions.

    The Kotta scaling move for the telemetry table: when one table's
    provisioned write capacity becomes the wall (Fig-6's ~1800 job/s knee),
    you shard the key space so each partition brings its own token bucket.
    Keys route by ``crc32(key) % shards`` — stable across processes and
    hash-seed randomization (the same choice as the serve stack's page
    hashing), so an item always lands on the shard that holds it.

    Aggregate ``write_count`` / ``throttled_writes`` / … sum over shards;
    ``scan`` merges every shard's view. With N shards of the same per-shard
    capacity the sustained write rate is N× a single store — asserted by
    the tier-1 overload tests.
    """

    def __init__(self, shards: int = 4, clock: Clock | None = None,
                 read_capacity: float = 100.0, write_capacity: float = 400.0):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.clock = clock or Clock()
        self.shards = [StateStore(self.clock, read_capacity, write_capacity)
                       for _ in range(shards)]

    def shard_for(self, key: str) -> StateStore:
        return self.shards[zlib.crc32(key.encode()) % len(self.shards)]

    def put_item(self, key: str, item: dict[str, Any]) -> None:
        self.shard_for(key).put_item(key, item)

    def update_item(self, key: str, **updates: Any) -> None:
        self.shard_for(key).update_item(key, **updates)

    def get_item(self, key: str) -> Optional[dict[str, Any]]:
        return self.shard_for(key).get_item(key)

    def try_put_item(self, key: str, item: dict[str, Any]) -> bool:
        return self.shard_for(key).try_put_item(key, item)

    def try_update_item(self, key: str, **updates: Any) -> bool:
        return self.shard_for(key).try_update_item(key, **updates)

    def try_get_item(self, key: str) -> tuple[bool, Optional[dict[str, Any]]]:
        return self.shard_for(key).try_get_item(key)

    def scan(self, prefix: str = "") -> dict[str, dict[str, Any]]:
        merged: dict[str, dict[str, Any]] = {}
        for shard in self.shards:
            merged.update(shard.scan(prefix))
        return merged

    @property
    def read_count(self) -> int:
        return sum(s.read_count for s in self.shards)

    @property
    def write_count(self) -> int:
        return sum(s.write_count for s in self.shards)

    @property
    def throttled_reads(self) -> int:
        return sum(s.throttled_reads for s in self.shards)

    @property
    def throttled_writes(self) -> int:
        return sum(s.throttled_writes for s in self.shards)


# ---------------------------------------------------------------------------
# JobQueue (SQS analogue)
# ---------------------------------------------------------------------------

class JobQueue:
    """FIFO queue with leases: unacked messages reappear after the
    visibility timeout — the substrate the queue-watcher relies on."""

    def __init__(self, name: str, clock: Clock | None = None,
                 visibility_timeout_s: float = 3600.0):
        self.name = name
        self.clock = clock or Clock()
        self.visibility_timeout_s = visibility_timeout_s
        self._ready: list[str] = []
        self._leased: dict[str, float] = {}  # msg -> lease expiry
        self._lock = threading.Lock()

    def put(self, msg: str) -> None:
        with self._lock:
            self._ready.append(msg)

    def get(self) -> Optional[str]:
        with self._lock:
            now = self.clock.now()
            expired = [m for m, t in self._leased.items() if t <= now]
            for m in expired:
                del self._leased[m]
                self._ready.append(m)
            if not self._ready:
                return None
            msg = self._ready.pop(0)
            self._leased[msg] = now + self.visibility_timeout_s
            return msg

    def ack(self, msg: str) -> None:
        with self._lock:
            self._leased.pop(msg, None)

    def nack(self, msg: str) -> None:
        with self._lock:
            if msg in self._leased:
                del self._leased[msg]
                self._ready.insert(0, msg)

    def depth(self) -> int:
        with self._lock:
            return len(self._ready)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

class JobStatus(str, enum.Enum):
    PENDING = "pending"
    WAITING_DATA = "waiting_data"   # parked until archive restore completes
    STAGING = "staging"
    RUNNING = "running"
    STAGING_OUT = "staging_out"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class JobSpec:
    """Complete description of an analysis task (paper §IV-A)."""

    executable: str                      # name in the ExecutableRegistry
    args: dict[str, Any] = field(default_factory=dict)
    inputs: tuple[str, ...] = ()         # object-store keys to stage in
    outputs: tuple[str, ...] = ()        # keys to stage out (under results/)
    max_walltime_s: float = 3600.0
    queue: str = "prod"                  # "dev" | "prod"


class JobCancelled(Exception):
    pass


@dataclass
class JobContext:
    """Handed to executables: staged inputs + cancellation + heartbeat."""

    job_id: str
    staged_inputs: dict[str, bytes]
    outputs: dict[str, bytes] = field(default_factory=dict)
    _cancel: threading.Event = field(default_factory=threading.Event)
    _heartbeat: Optional[Callable[[dict], None]] = None
    clock: Clock = field(default_factory=Clock)

    def should_stop(self) -> bool:
        return self._cancel.is_set()

    def checkpoint(self) -> None:
        """Cooperative cancellation point; call between work slices."""
        if self._cancel.is_set():
            raise JobCancelled(self.job_id)

    def report(self, **markers: Any) -> None:
        if self._heartbeat:
            self._heartbeat(markers)


ExecutableFn = Callable[[JobContext], Any]


class ExecutableRegistry:
    def __init__(self):
        self._fns: dict[str, ExecutableFn] = {}

    def register(self, name: str, fn: ExecutableFn | None = None):
        if fn is None:  # decorator form
            def deco(f):
                self._fns[name] = f
                return f
            return deco
        self._fns[name] = fn
        return fn

    def resolve(self, name: str) -> ExecutableFn:
        if name not in self._fns:
            raise KeyError(f"unknown executable {name!r}")
        return self._fns[name]


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

class Worker(threading.Thread):
    """One compute instance. ``preemptible`` workers can be revoked."""

    _ids = itertools.count()

    def __init__(self, service: "KottaService", queue_name: str,
                 preemptible: bool = True, poll_interval_s: float = 0.02):
        super().__init__(daemon=True, name=f"worker-{next(self._ids)}")
        self.service = service
        self.queue_name = queue_name
        self.preemptible = preemptible
        self.poll_interval_s = poll_interval_s
        self.idle = threading.Event()
        self.idle.set()
        self._halt = threading.Event()
        self._revoked = threading.Event()
        self._current_ctx: Optional[JobContext] = None
        self.jobs_done = 0

    # -- control -------------------------------------------------------------
    def shutdown(self) -> None:
        self._halt.set()

    def revoke(self) -> None:
        """Spot revocation: kill the instance; current job dies mid-flight."""
        self._revoked.set()
        self._halt.set()
        ctx = self._current_ctx
        if ctx is not None:
            ctx._cancel.set()

    # -- main loop -------------------------------------------------------------
    def run(self) -> None:
        svc = self.service
        token = svc.engine.service_session("task-executor")
        queue = svc.queues[self.queue_name]
        while not self._halt.is_set():
            job_id = queue.get()
            if job_id is None:
                svc.clock.sleep(self.poll_interval_s)
                continue
            self.idle.clear()
            try:
                self._execute(token, queue, job_id)
            finally:
                self.idle.set()
        svc._worker_exited(self)

    def _execute(self, token: SessionToken, queue: JobQueue, job_id: str) -> None:
        svc = self.service
        rec = svc.db.get_item(f"job/{job_id}")
        if rec is None or rec["status"] in (JobStatus.COMPLETED, JobStatus.CANCELLED):
            queue.ack(job_id)
            return

        spec: JobSpec = svc._specs[job_id]
        now = svc.clock.now()
        svc.db.update_item(f"job/{job_id}", status=JobStatus.STAGING,
                           worker=self.name, heartbeat=now,
                           started_at=rec.get("started_at") or now)

        # Park the job if any input is still archived (§V-A restore queue).
        archived = [k for k in spec.inputs if not svc.store.is_available(k)]
        if archived:
            for k in archived:
                svc.store.restore(k)
            svc.db.update_item(f"job/{job_id}", status=JobStatus.WAITING_DATA,
                               waiting_on=list(archived), worker=None)
            queue.ack(job_id)
            svc._parked[job_id] = tuple(archived)
            return

        # Stage inputs under the *user's* role (assume-role dance, §VI).
        # No inputs -> nothing to stage -> no role switch needed.
        try:
            staged = {}
            if spec.inputs:
                user_token = svc.engine.assume_role(token, rec["role"])
                staged = {k: svc.storage.get(user_token, k)
                          for k in spec.inputs}
                svc.engine.revoke(user_token)
        except AuthorizationError as e:
            svc.db.update_item(f"job/{job_id}", status=JobStatus.FAILED,
                               error=f"staging denied: {e}", completed_at=svc.clock.now())
            queue.ack(job_id)
            return

        ctx = JobContext(job_id=job_id, staged_inputs=staged, clock=svc.clock,
                         _heartbeat=lambda m: svc.db.update_item(
                             f"job/{job_id}", heartbeat=svc.clock.now(), **m))
        if self._revoked.is_set():
            ctx._cancel.set()
        self._current_ctx = ctx
        svc.db.update_item(f"job/{job_id}", status=JobStatus.RUNNING,
                           heartbeat=svc.clock.now())
        # The handlers keep only what they record, so the executable's frames
        # (and whatever device memory they hold) are gone before the job is
        # handed back to the queue.
        cancelled, error = False, None
        try:
            result = svc.registry.resolve(spec.executable)(ctx)
        except JobCancelled:
            cancelled = True
        except Exception as e:  # noqa: BLE001 - job code is arbitrary
            error = repr(e)
        if cancelled:
            # Revocation mid-run: leave the job leased; the queue-watcher (or
            # the visibility timeout) resubmits it.
            svc.db.update_item(f"job/{job_id}", status=JobStatus.PENDING,
                               worker=None, note="revoked mid-run")
            queue.nack(job_id)
            self._current_ctx = None
            return
        if error is not None:
            svc.db.update_item(f"job/{job_id}", status=JobStatus.FAILED,
                               error=error, completed_at=svc.clock.now())
            queue.ack(job_id)
            self._current_ctx = None
            return

        # Stage outputs back as private objects of the submitting user (§VI).
        svc.db.update_item(f"job/{job_id}", status=JobStatus.STAGING_OUT)
        for key, data in ctx.outputs.items():
            svc.store.put(key, data, owner=rec["user"], tier=Tier.STD)

        # First-completion-wins for speculative duplicates.
        final = svc.db.get_item(f"job/{job_id}")
        if final and final["status"] != JobStatus.COMPLETED:
            svc.db.update_item(f"job/{job_id}", status=JobStatus.COMPLETED,
                               exit_code=0, result=repr(result),
                               completed_at=svc.clock.now(), worker=self.name)
        queue.ack(job_id)
        self.jobs_done += 1
        self._current_ctx = None


# ---------------------------------------------------------------------------
# QueueWatcher
# ---------------------------------------------------------------------------

class QueueWatcher(threading.Thread):
    """Monitors heartbeats; resubmits orphaned jobs; unparks restored jobs;
    launches speculative duplicates of stragglers."""

    def __init__(self, service: "KottaService", heartbeat_timeout_s: float = 5.0,
                 straggler_factor: float = 3.0, interval_s: float = 0.05,
                 speculation: bool = True):
        super().__init__(daemon=True, name="queue-watcher")
        self.service = service
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.interval_s = interval_s
        self.speculation = speculation
        self._halt = threading.Event()
        self.resubmissions = 0
        self.speculations = 0

    def shutdown(self) -> None:
        self._halt.set()

    def run(self) -> None:
        svc = self.service
        while not self._halt.is_set():
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 - watcher must survive anything
                pass
            svc.clock.sleep(self.interval_s)

    def sweep(self) -> None:
        svc = self.service
        now = svc.clock.now()
        jobs = svc.db.scan("job/")

        # 1. unpark jobs whose archived inputs became available
        for job_id, keys in list(svc._parked.items()):
            if all(svc.store.is_available(k) for k in keys):
                del svc._parked[job_id]
                svc.db.update_item(f"job/{job_id}", status=JobStatus.PENDING,
                                   waiting_on=[])
                svc.queues[svc._specs[job_id].queue].put(job_id)

        durations = [r["completed_at"] - r["started_at"]
                     for r in jobs.values()
                     if r.get("status") == JobStatus.COMPLETED
                     and r.get("completed_at") and r.get("started_at")]
        median = statistics.median(durations) if durations else None

        for key, rec in jobs.items():
            job_id = key.split("/", 1)[1]
            status = rec.get("status")
            if status == JobStatus.RUNNING:
                hb = rec.get("heartbeat", 0.0)
                if now - hb > self.heartbeat_timeout_s:
                    # Worker died (revocation): resubmit.
                    svc.db.update_item(key, status=JobStatus.PENDING, worker=None,
                                       note="resubmitted by queue-watcher",
                                       attempt=rec.get("attempt", 0) + 1)
                    svc.queues[svc._specs[job_id].queue].put(job_id)
                    self.resubmissions += 1
                elif (self.speculation and median is not None
                      and not rec.get("speculated")
                      and now - rec.get("started_at", now) > self.straggler_factor * median):
                    # Straggler: speculative duplicate (first completion wins).
                    svc.db.update_item(key, speculated=True)
                    svc.queues[svc._specs[job_id].queue].put(job_id)
                    self.speculations += 1


# ---------------------------------------------------------------------------
# Service facade
# ---------------------------------------------------------------------------

class KottaService:
    """End-to-end service: security + storage + queues + workers + watcher."""

    def __init__(self, engine: PolicyEngine, store: ObjectStore,
                 registry: ExecutableRegistry | None = None,
                 clock: Clock | None = None,
                 db: StateStore | None = None,
                 watcher_kwargs: dict | None = None):
        self.engine = engine
        self.store = store
        self.storage = SecureStorage(store, engine)
        self.registry = registry or ExecutableRegistry()
        self.clock = clock or Clock()
        self.db = db or StateStore(self.clock)
        self.queues: dict[str, JobQueue] = {
            "dev": JobQueue("dev", self.clock),
            "prod": JobQueue("prod", self.clock),
        }
        self._specs: dict[str, JobSpec] = {}
        self._parked: dict[str, tuple[str, ...]] = {}
        self._workers: list[Worker] = []
        self._threads: list[threading.Thread] = []   # every one started
        self._lock = threading.Lock()
        self.watcher = QueueWatcher(self, **(watcher_kwargs or {}))
        self._watcher_started = False

    # -- lifecycle -------------------------------------------------------------
    def start(self, dev_workers: int = 1, prod_workers: int = 0) -> None:
        # Paper: the development pool always holds ≥1 reliable on-demand node.
        for _ in range(max(1, dev_workers)):
            self.add_worker("dev", preemptible=False)
        for _ in range(prod_workers):
            self.add_worker("prod", preemptible=True)
        if not self._watcher_started:
            with self._lock:
                self._threads.append(self.watcher)
            self.watcher.start()
            self._watcher_started = True

    def add_worker(self, queue_name: str, preemptible: bool = True) -> Worker:
        w = Worker(self, queue_name, preemptible=preemptible)
        with self._lock:
            self._workers.append(w)
            self._threads.append(w)
        w.start()
        return w

    def _worker_exited(self, worker: Worker) -> None:
        with self._lock:
            if worker in self._workers:
                self._workers.remove(worker)

    def workers(self, queue_name: str | None = None) -> list[Worker]:
        with self._lock:
            return [w for w in self._workers
                    if queue_name is None or w.queue_name == queue_name]

    def shutdown(self) -> None:
        """Stop the watcher and every worker, then join every thread this
        service started (revoked workers included), 5 s each at most: a
        worker still inside an executable finishes it first."""
        self.watcher.shutdown()
        for w in self.workers():
            w.shutdown()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5.0)

    # -- user API ----------------------------------------------------------------
    def submit(self, token: SessionToken, spec: JobSpec) -> str:
        """Authorize, persist the full task description, enqueue (§IV-D)."""
        self.engine.check(token, "jobs:Submit", f"queue/{spec.queue}")
        for key in spec.inputs:
            # Submission-time authorization of data access under the user role.
            self.engine.check(token, "data:Get", key)
        job_id = uuid.uuid4().hex[:12]
        self._specs[job_id] = spec
        self.db.put_item(f"job/{job_id}", {
            "status": JobStatus.PENDING, "user": token.principal_id,
            "role": token.role_name, "queue": spec.queue,
            "executable": spec.executable,
            "submitted_at": self.clock.now(), "attempt": 0,
        })
        self.queues[spec.queue].put(job_id)
        return job_id

    def status(self, job_id: str) -> dict[str, Any]:
        rec = self.db.get_item(f"job/{job_id}")
        if rec is None:
            raise KeyError(job_id)
        return rec

    def wait(self, job_id: str, timeout_s: float = 30.0,
             poll_s: float = 0.02) -> dict[str, Any]:
        deadline = self.clock.now() + timeout_s
        while self.clock.now() < deadline:
            rec = self.status(job_id)
            if rec["status"] in (JobStatus.COMPLETED, JobStatus.FAILED,
                                 JobStatus.CANCELLED):
                return rec
            self.clock.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still {self.status(job_id)['status']}")
