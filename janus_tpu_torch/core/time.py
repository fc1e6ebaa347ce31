"""Clock abstraction and time math.

reference: core/src/time.rs:11 (Clock trait), :42 (MockClock), extension math
for Time/Duration/Interval (:89-270).  The mock clock makes every time-driven
code path deterministic in tests, mirroring the reference's test strategy
(SURVEY.md §4).
"""

from __future__ import annotations

import threading
import time as _time

from ..messages import Duration, Interval, Time


class Clock:
    def now(self) -> Time:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> Time:
        return Time(int(_time.time()))


class MockClock(Clock):
    """Settable, advanceable clock (reference: core/src/time.rs:42)."""

    def __init__(self, start: Time = Time(1_600_000_000)):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> Time:
        with self._lock:
            return self._now

    def advance(self, duration: Duration) -> None:
        with self._lock:
            self._now = Time(self._now.seconds + duration.seconds)

    def set(self, t: Time) -> None:
        with self._lock:
            self._now = t


# --- Time/Interval extension math (reference: core/src/time.rs:89-270) -----


def time_add(t: Time, d: Duration) -> Time:
    return Time(t.seconds + d.seconds)


def time_sub(t: Time, d: Duration) -> Time:
    if t.seconds < d.seconds:
        raise ValueError("time subtraction underflow")
    return Time(t.seconds - d.seconds)


def time_difference(a: Time, b: Time) -> Duration:
    if a.seconds < b.seconds:
        raise ValueError("time difference underflow")
    return Duration(a.seconds - b.seconds)


def time_to_batch_interval_start(t: Time, time_precision: Duration) -> Time:
    """Round down to the nearest multiple of the time precision."""
    if time_precision.seconds == 0:
        raise ValueError("zero time precision")
    return Time(t.seconds - t.seconds % time_precision.seconds)


def time_to_batch_interval(t: Time, time_precision: Duration) -> Interval:
    return Interval(time_to_batch_interval_start(t, time_precision), time_precision)


def time_is_after(t: Time, other: Time) -> bool:
    return t.seconds > other.seconds


def interval_merge(a: Interval, b: Interval) -> Interval:
    """Smallest interval covering both (used for collection intervals)."""
    if a == Interval.EMPTY:
        return b
    if b == Interval.EMPTY:
        return a
    start = min(a.start.seconds, b.start.seconds)
    end = max(a.end().seconds, b.end().seconds)
    return Interval(Time(start), Duration(end - start))


def intervals_overlap(a: Interval, b: Interval) -> bool:
    if a.duration.seconds == 0 or b.duration.seconds == 0:
        return False
    return a.start.seconds < b.end().seconds and b.start.seconds < a.end().seconds


def interval_contains_interval(outer: Interval, inner: Interval) -> bool:
    return (
        outer.start.seconds <= inner.start.seconds
        and inner.end().seconds <= outer.end().seconds
    )
