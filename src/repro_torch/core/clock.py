"""Clock abstraction.

Every time-dependent component in Kotta (token expiry, lifecycle staleness,
queue wait accounting, the discrete-event simulator) takes a ``Clock`` so that
production code uses wall time while tests and the Table VII-C reproduction use
a deterministic virtual clock.
"""
from __future__ import annotations

import heapq
import threading
import time as _time


class Clock:
    """Wall-clock seconds since epoch."""

    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic manually-advanced clock.

    ``sleep`` registers a wakeup and blocks until another thread advances
    the clock past it (single-threaded DES uses ``advance`` directly and never
    blocks).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self._wakeups: list[tuple[float, int, threading.Event]] = []
        self._counter = 0

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> None:
        self.advance_to(self.now() + seconds)

    def advance_to(self, t: float) -> None:
        with self._lock:
            self._now = max(self._now, float(t))
            due = [w for w in self._wakeups if w[0] <= self._now]
            self._wakeups = [w for w in self._wakeups if w[0] > self._now]
        for _, _, ev in due:
            ev.set()

    def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        ev = threading.Event()
        with self._lock:
            self._counter += 1
            self._wakeups.append((self._now + seconds, self._counter, ev))
        ev.wait()

    def pending_wakeups(self) -> int:
        with self._lock:
            return len(self._wakeups)


SECONDS_PER_DAY = 86_400.0
SECONDS_PER_HOUR = 3_600.0


def days(n: float) -> float:
    return n * SECONDS_PER_DAY


def hours(n: float) -> float:
    return n * SECONDS_PER_HOUR
