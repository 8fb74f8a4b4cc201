"""Reliable job management (paper §IV-D): the part of the reference's
``repro/core/scheduler.py`` that the serve gateway needs.

- ``StateStore``   — the DynamoDB analogue: a transactional key-value store
  with **provisioned read/write capacity** (token buckets). The Fig-6
  throughput experiment saturates exactly here, like the paper's. The
  serve gateway flushes its telemetry into one through the non-blocking
  ``try_*`` variants.
- ``ShardedStateStore`` — hash-by-key partitions of ``StateStore``.

The threaded batch runtime of the same reference module (``JobQueue``,
``Worker``, ``QueueWatcher``, ``KottaService``) waits for a later slice of
the port.
"""
from __future__ import annotations

import threading
import zlib
from typing import Any, Optional

from .clock import Clock


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

