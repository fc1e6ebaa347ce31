"""Process-wide datastore health: brownout detection for the database.

Janus is database-centric — every component coordinates implicitly
through the datastore, and the fleet plane made it the fleet's membership and
routing substrate too.  That makes a datastore *brownout* (slow disk,
sqlite writer contention, Postgres failover) a correlated failure: every
replica's heartbeat goes stale simultaneously, which without a local
verdict is indistinguishable from "everyone died" and triggers a
fleet-wide migration storm at the worst possible moment.

This module is ``core/peer_health.py``'s state machine pointed at the
one datastore instead of N peers: a single process-wide
healthy→suspect→probing tracker fed from the ``run_tx`` retry loop.
Only TRANSIENT failures count (SQLITE_BUSY / "database is locked",
psycopg OperationalError / serialization failures, injected tx faults):
schema and integrity errors are bugs, stay loud, and never mark the
datastore unhealthy.

States (exported as the ``janus_datastore_health{state}`` state-set
gauge and the /statusz "datastore" section):

    healthy  transactions are committing; everything flows
    suspect  >= ``failure_threshold`` consecutive transient tx failures;
             consumers degrade — the fleet router freezes its ownership
             view, the upload front door sheds with 503 before burning
             HPKE work, the janitors skip their sweeps
    probing  suspect past its dwell: traffic probes the datastore again;
             the first commit restores healthy, the first transient
             failure re-suspects (and restarts the dwell)

Consumers gate on two predicates with different strictness:
``is_suspect()`` (state != healthy — used where acting on a possibly
stale view is dangerous, e.g. fleet takeovers) and ``state() ==
DB_SUSPECT`` (strict — used by the upload shed, because probing traffic
IS the probe that heals the tracker).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

DB_HEALTHY, DB_SUSPECT, DB_PROBING = "healthy", "suspect", "probing"
_STATES = (DB_HEALTHY, DB_SUSPECT, DB_PROBING)

logger = logging.getLogger("janus_tpu.db_health")


def backoff_s(
    attempt: int,
    *,
    initial: float = 0.025,
    cap: float = 0.5,
    rng: Optional[random.Random] = None,
) -> float:
    """Full-jitter exponential backoff for the ``run_tx`` retry loop:
    ``min(cap, initial * 2**attempt)`` scaled by a uniform [0.5, 1.0)
    factor, so N replicas retrying the same contended writer spread out
    instead of stampeding in lockstep.  ``rng`` is the determinism hook
    (tests seed it); None uses the module-level PRNG."""
    base = min(cap, initial * (2.0 ** max(0, attempt)))
    r = rng if rng is not None else random
    return base * (0.5 + 0.5 * r.random())


class DbHealthTracker:
    """The datastore's transport-health state machine; one per process
    (module singleton below), thread-safe — ``run_tx`` records from any
    thread, /statusz reads from the health server."""

    def __init__(self, failure_threshold: int = 3, suspect_dwell_s: float = 5.0):
        self.failure_threshold = failure_threshold
        self.suspect_dwell_s = suspect_dwell_s
        self.consecutive_failures = 0
        self.tx_failures_total = 0
        self.suspected = False
        self.suspected_at = 0.0
        #: suspect transitions (a flapping disk shows up as a high count)
        self.suspect_transitions = 0
        #: when the tracker last transitioned non-healthy -> healthy (0 =
        #: never suspected): the job drivers' heal-grace signal — a lease
        #: whose attempt count was inflated by the brownout gets its
        #: post-heal attempt instead of an entry abandonment
        self.healed_at = 0.0
        self._lock = threading.Lock()

    def configure(
        self,
        failure_threshold: Optional[int] = None,
        suspect_dwell_s: Optional[float] = None,
    ) -> None:
        with self._lock:
            if failure_threshold is not None:
                self.failure_threshold = failure_threshold
            if suspect_dwell_s is not None:
                self.suspect_dwell_s = suspect_dwell_s

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if not self.suspected:
            return DB_HEALTHY
        if time.monotonic() - self.suspected_at >= self.suspect_dwell_s:
            return DB_PROBING
        return DB_SUSPECT

    def is_suspect(self) -> bool:
        """True while suspect OR probing — the tracker currently believes
        the datastore is (or may still be) browning out.  The fleet
        router and janitors gate on this; the upload shed uses the
        strict ``state() == DB_SUSPECT`` instead (probing uploads are
        the probe)."""
        return self.state() != DB_HEALTHY

    def record_tx_success(self) -> None:
        was = False
        with self._lock:
            self.consecutive_failures = 0
            was = self.suspected
            self.suspected = False
            if was:
                self.healed_at = time.monotonic()
        if was:
            self._publish()
            logger.info("datastore HEALTHY again (transaction committed)")

    def record_tx_failure(self) -> None:
        """One TRANSIENT (retryable) transaction failure.  Permanent
        errors — schema, integrity, bugs — must NOT be fed here: they
        stay loud and say nothing about datastore availability."""
        transitioned = False
        with self._lock:
            self.consecutive_failures += 1
            self.tx_failures_total += 1
            if self.failure_threshold > 0 and (
                self.consecutive_failures >= self.failure_threshold
            ):
                if not self.suspected:
                    self.suspect_transitions += 1
                    transitioned = True
                # a failing probe (or further failures while suspect)
                # restarts the dwell: the datastore earns its way back
                # only with a real commit
                self.suspected = True
                self.suspected_at = time.monotonic()
        self._publish(count_failure=True)
        if transitioned:
            logger.warning(
                "datastore SUSPECT after %d consecutive transient tx "
                "failure(s); degrading for %.1fs before probing",
                self.consecutive_failures,
                self.suspect_dwell_s,
            )

    def recently_healed(self, window_s: float) -> bool:
        with self._lock:
            return (
                self.healed_at > 0
                and time.monotonic() - self.healed_at < window_s
            )

    def brownout_signal(self, window_s: float) -> bool:
        """Is the datastore non-healthy now, or healed within
        ``window_s``?  The job drivers' ceiling guards use this to
        excuse attempt counts inflated by a brownout."""
        return self.is_suspect() or self.recently_healed(window_s)

    def _publish(self, count_failure: bool = False) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None:
            return
        if count_failure:
            GLOBAL_METRICS.datastore_tx_retries.inc()
        current = self.state()
        for state in _STATES:
            GLOBAL_METRICS.datastore_health.labels(state=state).set(
                1.0 if state == current else 0.0
            )

    def republish_metrics(self) -> None:
        """Refresh the state-set gauge: the suspect -> probing transition
        happens purely by time passing, so with no transactions flowing
        the gauge would report suspect=1 forever — the status sampler
        calls this each tick so alerts match live state."""
        self._publish()

    def stats(self) -> dict:
        with self._lock:
            state = self._state_locked()
            out = {
                "state": state,
                "consecutive_failures": self.consecutive_failures,
                "tx_failures_total": self.tx_failures_total,
                "suspect_transitions": self.suspect_transitions,
                "failure_threshold": self.failure_threshold,
                "suspect_dwell_s": self.suspect_dwell_s,
            }
            if self.suspected:
                out["suspected_age_s"] = round(
                    time.monotonic() - self.suspected_at, 3
                )
        return out

    def reset(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self.tx_failures_total = 0
            self.suspected = False
            self.suspected_at = 0.0
            self.suspect_transitions = 0
            self.healed_at = 0.0


# -- process-wide instance ---------------------------------------------------

_TRACKER = DbHealthTracker()


def tracker() -> DbHealthTracker:
    return _TRACKER


def reset_db_health() -> None:
    """Test hook: drop all state (thresholds keep their last configured
    values — reconfigure explicitly if a test needs defaults)."""
    _TRACKER.reset()


def janitor_skip(component: str) -> bool:
    """Shared janitor gate: True when background sweeps (GC, key
    rotation) should no-op because the tracker is non-healthy.  Deletes
    and key-state flips are the worst traffic to aim at a browning-out
    datastore — they contend with the latency-sensitive upload/step
    writes and none of them are urgent.  Counted per component in
    ``janus_janitor_skips_total`` so a stuck-suspect tracker shows up as
    a climbing skip count, not silently stalled maintenance."""
    if not _TRACKER.is_suspect():
        return False
    from .metrics import GLOBAL_METRICS

    if GLOBAL_METRICS.registry is not None:
        GLOBAL_METRICS.janitor_skips.labels(component=component).inc()
    logger.warning(
        "%s sweep skipped: datastore is %s (no-op until it heals)",
        component,
        _TRACKER.state(),
    )
    return True
