"""Executor flight recorder: a black box for the device plane.

A bounded in-memory ring of per-flush records — bucket, rows vs padded
rows, participating tasks, queue delay, stage/launch wall time, outcome,
breaker state, whether an injected fault fired — kept cheap enough to run
always-on.  Three read paths:

* the ``flights`` section of ``/statusz`` (the last N records, newest
  first) — what an operator curls when a soak wedges;
* a **breaker-trip dump**: the moment a circuit opens, the whole ring is
  emitted as ONE structured log event, so every chaos failure ships with
  the flushes that led up to it (the post-hoc question "what were the
  last launches doing" has an answer even after the process is gone);
* a **slow-flush anomaly dump**: a flush whose launch exceeds
  ``slow_flush_p95_factor`` × the bucket's rolling p95 dumps the ring
  too (rate-limited — an overloaded chip must not turn the log into a
  dump firehose).

The ring is O(size) bounded, process-local, and deliberately NOT
persisted: a fresh binary starts an empty ring (SIGKILL semantics —
asserted by ``./ci.sh chaos crash``), because the flight recorder answers
"what was THIS incarnation doing", and the durable story (journal,
leases, traces) already survives elsewhere.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("janus_tpu_torch.executor.flights")

#: grep-stable marker for the one-line structured dump event (chaos
#: asserts exactly-once on it; keep it unique in the codebase)
DUMP_MARKER = "EXECUTOR-FLIGHT-RECORDER-DUMP"


class FlightRecorder:
    """Bounded ring of per-flush records + anomaly-triggered dumps."""

    #: launch-duration window per bucket feeding the rolling p95
    P95_WINDOW = 64
    #: anomaly detection needs this many samples before it trusts the p95
    MIN_P95_SAMPLES = 16
    #: floor between two slow-flush dumps (breaker trips are never limited)
    SLOW_DUMP_MIN_INTERVAL_S = 30.0

    def __init__(self, size: int = 256, slow_flush_p95_factor: float = 4.0):
        self.size = max(1, size)
        #: k in "launch > k × rolling p95 -> dump"; <= 0 disables the
        #: anomaly detector (the ring and breaker dumps stay on)
        self.slow_flush_p95_factor = slow_flush_p95_factor
        self._ring: deque = deque(maxlen=self.size)
        self._launch_window: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded_total = 0
        self.dumps: Dict[str, int] = {}
        self._last_slow_dump = 0.0

    # -- recording -------------------------------------------------------
    def record(
        self,
        *,
        bucket: str,
        trigger: str,
        rows: int,
        padded_rows: int,
        tasks: List[str],
        queue_delay_max_s: float,
        stage_s: float,
        launch_s: float,
        outcome: str,
        breaker_state: Optional[str],
        fault: bool,
        error: Optional[str] = None,
    ) -> Optional[dict]:
        """Append one flush record; returns the record.  Runs the
        slow-flush detector against the bucket's rolling p95 BEFORE this
        flush's own sample joins the window (a single huge flush must not
        raise the bar it is judged by)."""
        with self._lock:
            self._seq += 1
            rec = {
                "seq": self._seq,
                "t": round(time.time(), 3),
                "bucket": bucket,
                "trigger": trigger,
                "rows": rows,
                "padded_rows": padded_rows,
                "tasks": sorted(set(tasks)),
                "queue_delay_max_ms": round(queue_delay_max_s * 1000.0, 3),
                "stage_ms": round(stage_s * 1000.0, 3),
                "launch_ms": round(launch_s * 1000.0, 3),
                "outcome": outcome,
                "breaker": breaker_state,
                "fault": fault,
            }
            if error:
                rec["error"] = str(error)[:200]
            self._ring.append(rec)
            self.recorded_total += 1
            window = self._launch_window.get(bucket)
            if window is None:
                window = self._launch_window[bucket] = deque(
                    maxlen=self.P95_WINDOW
                )
            p95 = self._p95_locked(window)
            slow = (
                outcome == "ok"
                and self.slow_flush_p95_factor > 0
                and p95 is not None
                and launch_s > self.slow_flush_p95_factor * p95
            )
            if outcome == "ok":
                window.append(launch_s)
        if slow:
            self.dump(
                "slow_flush",
                detail={
                    "bucket": bucket,
                    "launch_ms": rec["launch_ms"],
                    "rolling_p95_ms": round(p95 * 1000.0, 3),
                    "factor": self.slow_flush_p95_factor,
                },
                rate_limited=True,
            )
        return rec

    def _p95_locked(self, window: deque) -> Optional[float]:
        if len(window) < self.MIN_P95_SAMPLES:
            return None
        ordered = sorted(window)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    # -- dumps -----------------------------------------------------------
    def dump(
        self, reason: str, detail: Optional[dict] = None, rate_limited: bool = False
    ) -> bool:
        """Emit the whole ring as ONE structured log event.  Breaker trips
        always dump; slow-flush anomalies respect the rate floor so chip
        overload cannot flood the log.  Returns whether a dump fired."""
        now = time.monotonic()
        with self._lock:
            if rate_limited and now - self._last_slow_dump < self.SLOW_DUMP_MIN_INTERVAL_S:
                return False
            if rate_limited:
                self._last_slow_dump = now
            self.dumps[reason] = self.dumps.get(reason, 0) + 1
            payload = {
                "reason": reason,
                "detail": detail or {},
                "flights": list(self._ring),
            }
        logger.warning("%s %s", DUMP_MARKER, json.dumps(payload, sort_keys=True))
        return True

    # -- introspection ---------------------------------------------------
    def snapshot(self, n: int = 32) -> List[dict]:
        """The newest ``n`` records, newest first (statusz "flights")."""
        with self._lock:
            recs = list(self._ring)
        return list(reversed(recs))[: max(0, n)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "ring_size": self.size,
                "recorded": self.recorded_total,
                "dumps": dict(self.dumps),
            }
