"""Per-peer transport health: suspect gating for partitioned peers.

Janus's two aggregators coordinate only through their datastores and DAP
HTTPS calls to the peer, so the failure that matters at fleet scale is a
peer that is *unreachable* — partitioned, blackholed, flapping — while
everything local stays healthy.  Without gating, every job driver burns
a lease (and a slice of its ``max_step_attempts`` budget) per delivery
discovering the same dead link, and a long partition abandons jobs that
would have finished fine after the heal.

This module is the executor circuit breaker's pattern applied to the
HTTP path, with one deliberate difference: past the suspect dwell the
gate goes half-open for ALL comers rather than a single probe slot — a
healed fleet-wide partition should heal fleet-wide, and concurrent
probes against a still-dead peer just re-suspect it (the lease-backoff
jitter in ``job_driver.step_retry_delay`` keeps the probe wave spread).

States (exported as the ``janus_peer_health{peer,state}`` state-set
gauge and the /statusz "peers" section):

    healthy  transport is fine; every request flows
    suspect  >= ``failure_threshold`` consecutive transport failures;
             requests are refused (``allow()`` is False) until the
             dwell elapses — job drivers release their leases with
             retryable backoff instead of attempting the peer
    probing  suspect past its dwell: requests flow again; the first
             success restores healthy, the first transport failure
             re-suspects (and restarts the dwell)

Only TRANSPORT failures count (connect refused/reset, timeouts,
injected transport faults): an HTTP response of any status — 503
backpressure included — proves the peer reachable and resets the
counter.  Fed by ``retry_http_request`` (core/retries.py) per attempt;
consulted by both job drivers before lease work is burned.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional
from urllib.parse import urlsplit

PEER_HEALTHY, PEER_SUSPECT, PEER_PROBING = "healthy", "suspect", "probing"
_STATES = (PEER_HEALTHY, PEER_SUSPECT, PEER_PROBING)


def origin_of(url: str) -> str:
    """Peer identity for tracking/metrics: the URL's host:port authority.
    Falls back to the raw string for non-URL targets (tests)."""
    try:
        netloc = urlsplit(url).netloc
    except ValueError:
        return url
    return netloc or url


class PeerHealth:
    """One peer's transport state machine; thread-safe (the retry loop
    records from event loops, /statusz reads from the health server)."""

    def __init__(self, peer: str, failure_threshold: int, suspect_dwell_s: float):
        self.peer = peer
        self.failure_threshold = failure_threshold
        self.suspect_dwell_s = suspect_dwell_s
        self.consecutive_failures = 0
        self.transport_failures_total = 0
        self.suspected = False
        self.suspected_at = 0.0
        #: suspect transitions (a flapping link shows up as a high count)
        self.suspect_transitions = 0
        #: when the peer last transitioned non-healthy -> healthy (0 =
        #: never suspected): the ceiling guards' heal-grace signal — a
        #: job whose delivery count was inflated by the partition gets
        #: its post-heal attempt instead of an entry abandonment
        self.healed_at = 0.0
        self._lock = threading.Lock()

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if not self.suspected:
            return PEER_HEALTHY
        if time.monotonic() - self.suspected_at >= self.suspect_dwell_s:
            return PEER_PROBING
        return PEER_SUSPECT

    def allow(self) -> bool:
        """May a request to this peer be attempted right now?  True for
        healthy and probing (dwell elapsed), False inside the dwell."""
        return self.state() != PEER_SUSPECT

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            was = self.suspected
            self.suspected = False
            if was:
                self.healed_at = time.monotonic()
        if was:
            self._publish()

    def recently_healed(self, window_s: float) -> bool:
        with self._lock:
            return (
                self.healed_at > 0
                and time.monotonic() - self.healed_at < window_s
            )

    def record_transport_failure(self) -> None:
        transitioned = False
        with self._lock:
            self.consecutive_failures += 1
            self.transport_failures_total += 1
            if self.failure_threshold > 0 and (
                self.consecutive_failures >= self.failure_threshold
            ):
                if not self.suspected:
                    self.suspect_transitions += 1
                    transitioned = True
                # a failing probe (or further failures while suspect)
                # restarts the dwell: the peer earns its way back only
                # with a real success
                self.suspected = True
                self.suspected_at = time.monotonic()
        self._publish(count_failure=True)
        if transitioned:
            import logging

            logging.getLogger("janus_tpu.peer_health").warning(
                "peer %s SUSPECT after %d consecutive transport failure(s); "
                "gating requests for %.1fs before probing",
                self.peer,
                self.consecutive_failures,
                self.suspect_dwell_s,
            )

    def _publish(self, count_failure: bool = False) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None:
            return
        if count_failure:
            GLOBAL_METRICS.peer_transport_failures.labels(peer=self.peer).inc()
        current = self.state()
        for state in _STATES:
            GLOBAL_METRICS.peer_health.labels(peer=self.peer, state=state).set(
                1.0 if state == current else 0.0
            )

    def stats(self) -> dict:
        with self._lock:
            state = self._state_locked()
            out = {
                "state": state,
                "consecutive_failures": self.consecutive_failures,
                "transport_failures_total": self.transport_failures_total,
                "suspect_transitions": self.suspect_transitions,
            }
            if self.suspected:
                out["suspected_age_s"] = round(
                    time.monotonic() - self.suspected_at, 3
                )
        return out


class PeerHealthTracker:
    """Process-wide peer registry (one per process, like the executor):
    every driver in the process shares each peer's verdict, so replica A
    discovering a partition spares replica B the probe."""

    def __init__(self, failure_threshold: int = 3, suspect_dwell_s: float = 10.0):
        self.failure_threshold = failure_threshold
        self.suspect_dwell_s = suspect_dwell_s
        self._peers: Dict[str, PeerHealth] = {}
        self._lock = threading.Lock()

    def configure(
        self,
        failure_threshold: Optional[int] = None,
        suspect_dwell_s: Optional[float] = None,
    ) -> None:
        """Adjust thresholds (driver construction); existing peers adopt
        them — the tracker is process-wide, so the last configured driver
        wins, which is fine because every driver in one binary shares one
        config."""
        with self._lock:
            if failure_threshold is not None:
                self.failure_threshold = failure_threshold
            if suspect_dwell_s is not None:
                self.suspect_dwell_s = suspect_dwell_s
            for p in self._peers.values():
                p.failure_threshold = self.failure_threshold
                p.suspect_dwell_s = self.suspect_dwell_s

    def _peer(self, url: str) -> PeerHealth:
        key = origin_of(url)
        with self._lock:
            p = self._peers.get(key)
            if p is None:
                p = PeerHealth(key, self.failure_threshold, self.suspect_dwell_s)
                self._peers[key] = p
            return p

    def allow(self, url: str) -> bool:
        return self._peer(url).allow()

    def state(self, url: str) -> str:
        return self._peer(url).state()

    def is_suspect(self, url: str) -> bool:
        """True while the peer is suspect OR probing — i.e. the tracker
        currently believes the link is (or may still be) partitioned.
        Job drivers use this to classify a failed exchange as partition
        pressure (release without consuming the attempt budget)."""
        return self._peer(url).state() != PEER_HEALTHY

    def record_success(self, url: str) -> None:
        self._peer(url).record_success()

    def recently_healed(self, url: str, window_s: float) -> bool:
        """Did this peer transition back to healthy within ``window_s``?
        False for a peer that was never suspect — the ceiling guards use
        this to tell partition debris from a genuinely sick job."""
        return self._peer(url).recently_healed(window_s)

    def record_transport_failure(self, url: str) -> None:
        self._peer(url).record_transport_failure()

    def republish_metrics(self) -> None:
        """Refresh every peer's state-set gauge.  The suspect -> probing
        transition happens purely by time passing, so with no traffic
        flowing (a quiesced partition) the gauge would otherwise report
        suspect=1 forever while the tracker is actually probing — the
        status sampler calls this each tick so alerts match live state."""
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            p._publish()

    def partition_signal(self, window_s: float) -> bool:
        """Cheap in-memory pre-check for the ceiling guards: is ANY peer
        currently non-healthy, or healed within ``window_s``?  False in
        the overwhelmingly common no-partition case, letting callers
        skip a datastore lookup."""
        with self._lock:
            peers = list(self._peers.values())
        return any(
            p.state() != PEER_HEALTHY or p.recently_healed(window_s)
            for p in peers
        )

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            peers = list(self._peers.items())
        return {key: p.stats() for key, p in sorted(peers)}

    def reset(self) -> None:
        with self._lock:
            self._peers = {}


# -- process-wide instance ---------------------------------------------------

_TRACKER = PeerHealthTracker()


def tracker() -> PeerHealthTracker:
    return _TRACKER


def reset_peer_health() -> None:
    """Test hook: drop every peer's state (thresholds keep their last
    configured values — reconfigure explicitly if a test needs defaults)."""
    _TRACKER.reset()
