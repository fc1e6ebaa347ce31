"""Blast-radius isolation for vectorized passes and durable journal rows.

Vectorized planes (batched HPKE open, executor mega-batch prep_init/combine,
the journal materializer fold) fail at *cohort* granularity: one poison row
fails the whole batch, the batch re-enters the retry path, and the pipeline
wedges (or the breaker trips globally) forever.  This module restores the
per-report failure semantics of the reference system on top of those
vectorized planes:

- ``bisect_batch`` retries a failed cohort in halves to isolate the poison
  row(s) within a per-report retry budget — O(log B) extra passes per poison
  row, and the healthy remainder proceeds.
- ``QuarantineRecorder`` records offenders (report id, task, stage, error
  class, payload digest) in memory for /statusz and — when a datastore sink is
  configured — durably in the ``quarantined_reports`` table via a
  failure-tolerant background writer.
- ``crc32c`` / ``chain_crc`` provide the Castagnoli checksum used to detect
  torn/bit-flipped ``report_journal`` and ``accumulator_journal`` rows.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli).  zlib.crc32 implements the plain CRC32 (0xEDB88320)
# polynomial; durable-storage checksums conventionally use Castagnoli
# (0x82F63B78, reflected), so we carry a small table-driven implementation.
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _build_crc32c_table() -> Tuple[int, ...]:
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _build_crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """Castagnoli CRC32 of ``data``, optionally chained from ``crc``."""
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def chain_crc(*parts: Optional[bytes]) -> int:
    """CRC32C over a length-prefixed concatenation of ``parts``.

    Length-prefixing (and an explicit marker for NULL columns) makes the
    checksum sensitive to column boundaries: ``(b"ab", b"c")`` and
    ``(b"a", b"bc")`` hash differently, as do ``(None,)`` and ``(b"",)``.
    """
    crc = 0
    for part in parts:
        if part is None:
            crc = crc32c(b"\xff\xff\xff\xff\xff", crc)
            continue
        crc = crc32c(len(part).to_bytes(4, "big"), crc)
        crc = crc32c(part, crc)
    return crc


def payload_digest(payload: object) -> str:
    """Short stable digest of an offending payload for the quarantine record."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        raw = bytes(payload)
    else:
        raw = repr(payload).encode("utf-8", "replace")
    return hashlib.sha256(raw).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Batch bisection.
# ---------------------------------------------------------------------------


@dataclass
class BisectionOutcome:
    """Result of ``bisect_batch`` over a cohort of ``total`` items."""

    total: int
    results: Dict[int, object] = field(default_factory=dict)
    offenders: List[Tuple[int, Exception]] = field(default_factory=list)
    attempts: int = 0
    exhausted: bool = False

    @property
    def attributable(self) -> bool:
        """True when failure was isolated to a strict subset of the cohort.

        An all-offenders outcome means every singleton failed — that is not a
        poison row, it is the pass itself failing (device lost, bad build) and
        must take the legacy breaker path instead of quarantining the cohort.
        """
        return 0 < len(self.offenders) < self.total

    @property
    def offender_indices(self) -> List[int]:
        return [i for i, _ in self.offenders]


def bisect_batch(
    items: Sequence[object],
    attempt: Callable[[Sequence[object]], Sequence[object]],
    per_item_budget: int = 16,
) -> BisectionOutcome:
    """Isolate poison rows in ``items`` by retrying failing halves.

    ``attempt(subset)`` must either return one result per subset element (in
    order) or raise; it must never partially succeed.  The full cohort is
    retried once first so a transient batch-level failure costs a single extra
    pass and quarantines nothing.  Each item is charged one attempt per pass
    it participates in; when an item's charge reaches ``per_item_budget`` its
    remaining range is marked offender wholesale (``exhausted=True``) rather
    than retried forever.
    """
    outcome = BisectionOutcome(total=len(items))
    if not items:
        return outcome
    charges = [0] * len(items)

    def run(lo: int, hi: int) -> None:
        # Budget fence: the most-charged item in the range pays for each pass.
        if max(charges[lo:hi]) >= per_item_budget:
            outcome.exhausted = True
            for i in range(lo, hi):
                outcome.offenders.append(
                    (i, BudgetExhausted(f"retry budget exhausted at index {i}"))
                )
            return
        outcome.attempts += 1
        for i in range(lo, hi):
            charges[i] += 1
        try:
            sub = attempt(items[lo:hi])
        except Exception as exc:  # noqa: BLE001 - bisection is an error sieve
            if hi - lo == 1:
                outcome.offenders.append((lo, exc))
                return
            mid = (lo + hi) // 2
            run(lo, mid)
            run(mid, hi)
            return
        for i, result in zip(range(lo, hi), sub):
            outcome.results[i] = result

    run(0, len(items))
    return outcome


class BudgetExhausted(Exception):
    """Raised (as an offender error) when bisection hits its retry budget."""


# ---------------------------------------------------------------------------
# Quarantine recorder: in-memory stats for /statusz plus an optional durable
# sink into the quarantined_reports table.  Recording must never take down a
# serving path, so the durable write happens on a background thread and all
# failures are logged-and-counted instead of raised.
# ---------------------------------------------------------------------------

_RECENT_LIMIT = 64


class QuarantineRecorder:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stage_counts: Dict[str, int] = {}
        self._bisections = 0
        self._corrupt_rows = 0
        self._recent: List[Dict[str, object]] = []
        self._sink = None
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._sink_errors = 0

    # -- configuration ----------------------------------------------------

    def configure_sink(self, datastore) -> None:
        """Point durable quarantine writes at ``datastore`` (last call wins)."""
        with self._lock:
            self._sink = datastore

    def reset(self) -> None:
        self.drain(timeout=1.0)
        with self._lock:
            self._stage_counts.clear()
            self._recent.clear()
            self._bisections = 0
            self._corrupt_rows = 0
            self._sink = None
            self._sink_errors = 0

    # -- recording --------------------------------------------------------

    def record(
        self,
        stage: str,
        task: Optional[str] = None,
        report_id: Optional[bytes] = None,
        error: Optional[BaseException] = None,
        payload: object = None,
        durable: bool = True,
    ) -> None:
        error_class = type(error).__name__ if error is not None else "unknown"
        digest = payload_digest(payload) if payload is not None else None
        entry = {
            "stage": stage,
            "task": task,
            "report_id": report_id.hex() if report_id else None,
            "error_class": error_class,
            "payload_digest": digest,
        }
        with self._lock:
            self._stage_counts[stage] = self._stage_counts.get(stage, 0) + 1
            self._recent.append(entry)
            del self._recent[:-_RECENT_LIMIT]
            sink = self._sink
        self._bump_metric(stage)
        logger.warning(
            "quarantined report stage=%s task=%s report_id=%s error=%s",
            stage,
            task,
            entry["report_id"],
            error_class,
        )
        if durable and sink is not None:
            self._queue.put(
                {
                    "task": task,
                    "report_id": bytes(report_id) if report_id else None,
                    "stage": stage,
                    "error_class": error_class,
                    "payload_digest": digest,
                }
            )
            self._ensure_worker()

    def note_bisection(self) -> None:
        with self._lock:
            self._bisections += 1
        try:
            from .metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.batch_bisections.inc()
        except Exception:  # pragma: no cover - metrics must never break serving
            logger.exception("failed to record bisection metric")

    def note_corrupt_row(self, stage: str = "journal") -> None:
        """Count a checksum-failed durable row (already quarantined in-tx)."""
        with self._lock:
            self._corrupt_rows += 1
            self._stage_counts[stage] = self._stage_counts.get(stage, 0) + 1
        self._bump_metric(stage)
        try:
            from .metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.journal_corrupt_rows.inc()
        except Exception:  # pragma: no cover
            logger.exception("failed to record corrupt-row metric")

    def _bump_metric(self, stage: str) -> None:
        try:
            from .metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.quarantined_reports.labels(stage=stage).inc()
        except Exception:  # pragma: no cover
            logger.exception("failed to record quarantine metric")

    # -- background sink writer ------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._drain_loop, name="quarantine-writer", daemon=True
            )
            self._worker.start()

    def _drain_loop(self) -> None:
        while True:
            try:
                row = self._queue.get(timeout=5.0)
            except queue.Empty:
                return
            if row is None:
                self._queue.task_done()
                return
            try:
                with self._lock:
                    sink = self._sink
                if sink is not None:
                    sink.run_tx(
                        "put_quarantined_report",
                        lambda tx: tx.put_quarantined_report(
                            task=row["task"],
                            report_id=row["report_id"],
                            stage=row["stage"],
                            error_class=row["error_class"],
                            payload_digest=row["payload_digest"],
                        ),
                    )
            except Exception:  # noqa: BLE001 - the sink must never crash us
                with self._lock:
                    self._sink_errors += 1
                logger.exception("failed to persist quarantined report")
            finally:
                self._queue.task_done()

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until all queued durable writes have been attempted.

        Test/shutdown helper; returns False on timeout.
        """
        deadline = threading.Event()
        done = threading.Event()

        def waiter() -> None:
            self._queue.join()
            done.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        ok = done.wait(timeout)
        deadline.set()
        return ok

    # -- introspection ----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "stages": dict(sorted(self._stage_counts.items())),
                "total": sum(self._stage_counts.values()),
                "bisections": self._bisections,
                "corrupt_rows": self._corrupt_rows,
                "pending_writes": self._queue.qsize(),
                "sink_errors": self._sink_errors,
                "sink_configured": self._sink is not None,
                "recent": list(self._recent[-8:]),
            }


_RECORDER = QuarantineRecorder()


def recorder() -> QuarantineRecorder:
    return _RECORDER


def configure_sink(datastore) -> None:
    _RECORDER.configure_sink(datastore)


def record(stage: str, **kwargs) -> None:
    _RECORDER.record(stage, **kwargs)


def note_bisection() -> None:
    _RECORDER.note_bisection()


def note_corrupt_row(stage: str = "journal") -> None:
    _RECORDER.note_corrupt_row(stage)


def quarantine_stats() -> Dict[str, object]:
    return _RECORDER.stats()


def reset() -> None:
    _RECORDER.reset()
