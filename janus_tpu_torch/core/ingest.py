"""The zero-copy ingest plane: upload -> staging handoff with a
write-behind report journal.

The synchronous pipeline re-materializes every report at each hop:
batched HPKE open -> ``put_client_report`` commit -> creator
claim/read-back -> driver -> executor.  This module collapses the middle:
the upload front door hands freshly opened, validated shares DIRECTLY to
the aggregation pipeline's staging side — pre-bucketed by (task, vdaf
shape) the way the executor's stage/launch split buckets device work —
while the authoritative client_reports write becomes a WRITE-BEHIND
journal flushed by a bounded background writer.

Durability contract (the non-negotiable half): a report is ACKed to its
client only after its journal row is durable.  The journal-flush
transaction is the durability ACK *and* the only place report_success is
counted; everything downstream — materialization into client_reports,
direct staged-cohort packing, crash replay — consumes the row without
touching counters.  Write-behind applies to the *aggregation visibility*
path only, never to the ACK.

Exactly-once across the reordering hangs on one linearization point, the
same one the accumulator journal uses (executor/accumulator.py):
``delete_report_journal_row`` returns whether THIS transaction consumed
the row, and the loser of a consume race MUST NOT write anything for the
report.  Every consumer follows it:

- the background materializer moves rows into client_reports (a pure
  ciphertext column copy — the share is encrypted under the
  client_reports AAD precisely so this hop never decrypts);
- the staged-cohort consumer (aggregation_job_creator.run_staged_once)
  deletes the row and inserts a born-scrubbed client_reports tombstone in
  the same transaction that packs the report into a job;
- crash replay (a restarted replica, or any creator's pre-pass over rows
  older than a grace) is just the materializer under another scheduler —
  which is also the migration handoff: a cohort staged on replica A is
  collectable after A dies because its journal rows are global state.

Backpressure composes with the upload admission control: the journal
writer's queue is bounded, and :meth:`IngestPlane.admit` sheds 503 +
Retry-After (reason="journal") past the bound — a wedged journal writer
degrades to counted sheds, never unbounded memory.  The staging buffer is
bounded separately and OVERFLOWS TO THE JOURNAL, not to the client:
reports that do not fit simply reach aggregation through the
materializer's read-back path (counted path="readback").
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import time
import zlib
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("janus_tpu.ingest")

#: The process's ingest plane, registered at construction so /statusz can
#: render journal depth / staged occupancy without holding the Aggregator
#: (the UploadOpenBatcher._FRONTDOOR pattern; one serving plane per
#: process, tests that build several see the most recent).
_INGEST: Optional["IngestPlane"] = None


def ingest_stats() -> Optional[dict]:
    """The /statusz "ingest" section (None when no plane exists —
    synchronous mode, or binaries that serve no uploads)."""
    return _INGEST.stats() if _INGEST is not None else None


def _shape_digest(shape_key) -> str:
    """Stable 6-hex digest of a vdaf shape key — the executor's bucket
    labeling scheme (executor/service.py _shape_digest), imported when the
    executor is present so the two label spaces cannot drift, recomputed
    identically when it is not (control-plane binaries never pay the
    executor import)."""
    try:
        from ..executor.service import _shape_digest as ex_digest

        return ex_digest(shape_key)
    except Exception:
        return "%06x" % (zlib.crc32(repr(shape_key).encode()) & 0xFFFFFF)


class IngestPlane:
    """The journaled ingest mode's moving parts: the bounded write-behind
    journal writer (the ReportWriteBatcher size/delay shape, flush-
    generation guard included), the bounded in-memory staging buffer, and
    the background materializer.

    ``submit()`` is the upload handler's write seam: it resolves when the
    report's journal row is DURABLE (the ACK point).  On each committed
    flush the fresh reports are handed to the staging buffer, bucketed by
    (task, vdaf shape); ``take_staged()`` is the in-process job creator's
    consumption point.  ``materialize_once()`` drains journal rows into
    client_reports for everything that did not go direct."""

    def __init__(
        self,
        datastore,
        max_batch_size: int = 100,
        max_write_delay: float = 0.05,
        queue_max: int = 2048,
        counter_shard_count: int = 8,
        stage_direct: bool = True,
        stage_max_reports: int = 4096,
    ):
        self.datastore = datastore
        self.max_batch_size = max_batch_size
        self.max_write_delay = max_write_delay
        self.queue_max = queue_max
        self.counter_shard_count = counter_shard_count
        self.stage_direct = stage_direct
        self.stage_max_reports = stage_max_reports
        #: (report, shape_key, waiter, enqueue-monotonic)
        self._queue: List[Tuple[object, object, asyncio.Future, float]] = []
        #: detached-but-uncommitted flushes: seq -> row count.  The
        #: admission bound must count these (the front door's lesson: the
        #: staging queue drains into flight at batch granularity, so on
        #: its own it never reaches a real bound while a slow writer
        #: piles work up).
        self._inflight: Dict[int, int] = {}
        self._flush_seq = 0
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        #: flush generation (the ReportWriteBatcher stale-timer guard): an
        #: armed timer carries the generation it was armed for, and a
        #: fired flush whose generation has moved on is a no-op.
        self._flush_gen = 0
        self._lock = asyncio.Lock()
        #: (task_id.data, shape digest) -> staged reports awaiting direct
        #: consumption.  Bounded by stage_max_reports; overflow reports
        #: are simply not staged (their journal rows reach aggregation
        #: through the materializer's read-back path).
        self._staged: Dict[Tuple[bytes, str], List[object]] = {}
        self._staged_count = 0
        self._sheds = 0
        self._flushes = 0
        self._journaled = 0
        self._staged_total = 0
        self._overflow_total = 0
        self._materialized_total = 0
        global _INGEST
        _INGEST = self

    # -- admission control ------------------------------------------------
    def queue_depth(self) -> int:
        """Reports pending anywhere before durability: staged for flush +
        detached into an in-flight flush transaction."""
        return len(self._queue) + sum(self._inflight.values())

    def admit(self) -> None:
        """Raise :class:`UploadShed` when the journal writer is past its
        depth budget — counted as reason="journal" in
        janus_upload_shed_total.  Composes with (runs after) the front
        door's open-queue admission gate."""
        if self.queue_max <= 0 or self.queue_depth() < self.queue_max:
            return
        from ..aggregator.error import UploadShed
        from .metrics import GLOBAL_METRICS

        self._sheds += 1
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.upload_sheds.labels(reason="journal").inc()
        raise UploadShed("report-journal writer over depth budget; retry")

    # -- the write-behind ACK path ---------------------------------------
    async def submit(self, report, shape_key=None) -> None:
        """Enqueue a validated report; resolves when its journal row is
        durable — the client's ACK point.  Mirrors
        ReportWriteBatcher.write_report's trace adoption so every
        journaled report carries a 32-hex upload trace.

        ``shape_key`` is the staging bucket identity (the task's vdaf
        shape); None marks the report journal-only — it is never staged
        and reaches aggregation through the materializer (agg-param and
        FixedSize tasks, whose jobs the direct path cannot create)."""
        if report.trace_id is None:
            from .trace import current_trace, new_trace_id

            report = dataclasses.replace(
                report,
                trace_id=current_trace().get("trace_id") or new_trace_id(),
            )
        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            self._queue.append((report, shape_key, fut, time.monotonic()))
            self._publish_depth()
            if len(self._queue) >= self.max_batch_size:
                await self._flush_locked()
            elif self._flush_handle is None:
                loop = asyncio.get_running_loop()
                gen = self._flush_gen
                self._flush_handle = loop.call_later(
                    self.max_write_delay,
                    lambda: asyncio.ensure_future(self._flush(gen)),
                )
        await fut

    async def _flush(self, gen: Optional[int] = None) -> None:
        async with self._lock:
            if gen is not None and gen != self._flush_gen:
                return  # stale timer (see ReportWriteBatcher._flush)
            await self._flush_locked()

    async def _flush_locked(self) -> None:
        """Detach the pending cohort and run its journal transaction
        off-lock, so flushes overlap the way open batches do."""
        self._flush_gen += 1
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        batch, self._queue = self._queue, []
        if not batch:
            self._publish_depth()
            return
        seq = self._flush_seq
        self._flush_seq += 1
        self._inflight[seq] = len(batch)
        self._publish_depth()
        asyncio.ensure_future(self._run_flush(batch, seq))

    async def _run_flush(self, batch, seq: int) -> None:
        from ..datastore import TaskUploadCounter, TxConflict
        from . import faults
        from .metrics import GLOBAL_METRICS

        # In-batch dedup by (task, report id): first wins, dups succeed as
        # idempotent uploads (the ReportWriteBatcher contract).
        seen: Dict[bytes, int] = {}
        unique: List[Tuple[object, object, List[asyncio.Future], float]] = []
        for report, shape_key, fut, enqueued in batch:
            key = report.task_id.data + report.report_id.data
            if key in seen:
                unique[seen[key]][2].append(fut)
            else:
                seen[key] = len(unique)
                unique.append((report, shape_key, [fut], enqueued))

        def tx_fn(tx):
            fresh = []
            shard = random.randrange(self.counter_shard_count)
            for report, _shape, _futs, _enq in unique:
                # A report already materialized in client_reports is a
                # cross-path duplicate (synchronous-mode replica, retried
                # upload after its row was consumed): idempotent success,
                # and CRITICALLY no counter — report_success was settled
                # when it was first journaled/committed.
                if tx.check_client_report_exists(report.task_id, report.report_id):
                    fresh.append(False)
                    continue
                try:
                    tx.put_report_journal_row(report)
                    tx.increment_task_upload_counter(
                        report.task_id,
                        shard,
                        TaskUploadCounter(report.task_id, report_success=1),
                    )
                    fresh.append(True)
                except TxConflict:
                    # journal-row duplicate: idempotent success
                    fresh.append(False)
            return fresh

        t0 = time.monotonic()
        try:
            # Failure-domain boundary: an injected ingest.journal fault
            # impersonates a journal-commit failure — fanned to every
            # waiting ACK exactly like a real one (clients retry).
            await faults.fire_async("ingest.journal")
            fresh = await self.datastore.run_tx_async("ingest_journal", tx_fn)
        except BaseException as e:
            # Belt and suspenders (the _run_batch contract): a
            # stranded upload handler is the one unacceptable outcome, so
            # even a non-Exception escape fans to every waiter first.
            for _report, _shape, futs, _enq in unique:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(
                            e if isinstance(e, Exception) else RuntimeError(str(e))
                        )
            if not isinstance(e, Exception):
                raise
            return
        finally:
            self._inflight.pop(seq, None)
            self._publish_depth()

        from .trace import emit_span

        committed = time.monotonic()
        have_metrics = GLOBAL_METRICS.registry is not None
        now_s = self.datastore.now().seconds if have_metrics else 0
        if have_metrics:
            GLOBAL_METRICS.ingest_journal_flush_seconds.observe(committed - t0)
        self._flushes += 1
        accepted = 0
        for (report, shape_key, futs, enqueued), is_fresh in zip(unique, fresh):
            if have_metrics:
                accepted += 1
                # The same SLO inputs the synchronous writer feeds — in
                # journaled mode "commit" means the durability ACK, which
                # is exactly what the client experiences.
                GLOBAL_METRICS.report_commit_age.observe(
                    max(0.0, float(now_s - report.time.seconds))
                )
                GLOBAL_METRICS.upload_to_commit.observe(
                    max(0.0, committed - enqueued)
                )
            emit_span(
                "upload_commit",
                "upload",
                enqueued,
                committed - enqueued,
                trace_id=report.trace_id,
                task_id=str(report.task_id),
            )
            if is_fresh:
                self._journaled += 1
                self._stage(report, shape_key)
            for fut in futs:
                if not fut.done():
                    fut.set_result(None)
        if have_metrics:
            GLOBAL_METRICS.upload_outcomes.labels(decision="accepted").inc(accepted)

    def _publish_depth(self) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.ingest_journal_depth.set(self.queue_depth())

    # -- the staging side -------------------------------------------------
    def _stage(self, report, shape_key) -> None:
        """Hand one durably journaled report to the staging buffer.  Over
        the bound (or with direct staging off, or shape_key None) the
        report is simply not staged: its journal row reaches aggregation
        through the materializer — overflow degrades to read-back, never
        to memory."""
        if (
            shape_key is None
            or not self.stage_direct
            or self._staged_count >= self.stage_max_reports
        ):
            self._overflow_total += 1
            return
        bucket = (report.task_id.data, _shape_digest(shape_key))
        self._staged.setdefault(bucket, []).append(report)
        self._staged_count += 1
        self._staged_total += 1

    def take_staged(self):
        """Detach every staged cohort: [(task_id, shape_digest, reports)].
        The caller (the in-process creator's staged pass) owns consumption
        from here; reports it cannot consume simply stay journaled and
        fall to the materializer."""
        cohorts = []
        staged, self._staged = self._staged, {}
        self._staged_count = 0
        for (task_data, shape), reports in staged.items():
            from ..messages import TaskId

            cohorts.append((TaskId(task_data), shape, reports))
        return cohorts

    # -- the background materializer --------------------------------------
    async def materialize_once(self, limit: int = 256) -> Tuple[int, int]:
        """One bounded write-behind pass: move up to ``limit`` journal
        rows into client_reports (ciphertext column copies, no decrypt)
        and consume them.  Returns (consumed, materialized); materialized
        rows are counted path="readback" — they will reach aggregation
        through the classic creator claim."""
        from .metrics import GLOBAL_METRICS

        consumed, materialized = await self.datastore.run_tx_async(
            "ingest_materialize",
            lambda tx: tx.materialize_report_journal_rows(limit),
        )
        self._materialized_total += materialized
        if materialized and GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.ingest_staged_total.labels(path="readback").inc(
                materialized
            )
        return consumed, materialized

    async def drain(self) -> None:
        """Graceful-shutdown drain: flush whatever is queued, then
        materialize the journal backlog (bounded loop).  Rows that remain
        (e.g. the datastore died too) are exactly what crash replay
        exists for."""
        try:
            await self._flush()
            for _ in range(64):
                consumed, _materialized = await self.materialize_once()
                if consumed == 0:
                    break
        except Exception:
            logger.exception("ingest drain left journal rows for replay")

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "mode": "journaled",
            "queue_depth": self.queue_depth(),
            "staged_flush": len(self._queue),
            "inflight_flush": sum(self._inflight.values()),
            "queue_max": self.queue_max,
            "sheds": self._sheds,
            "flushes": self._flushes,
            "journaled": self._journaled,
            "stage_direct": self.stage_direct,
            "staged_reports": self._staged_count,
            "staged_buckets": len(self._staged),
            "staged_total": self._staged_total,
            "stage_overflow_total": self._overflow_total,
            "materialized_total": self._materialized_total,
        }


async def replay_report_journal(datastore, batch_size: int = 256) -> int:
    """Startup/crash replay: materialize EVERY outstanding journal row
    into client_reports (bounded batches so one huge backlog cannot hold
    a transaction open forever).  Returns rows materialized.  Safe to run
    concurrently with live consumers on any replica — the per-row delete
    is the linearization point, so a row consumed elsewhere mid-replay is
    simply skipped."""
    from .metrics import GLOBAL_METRICS

    total = 0
    while True:
        consumed, materialized = await datastore.run_tx_async(
            "report_journal_replay",
            lambda tx: tx.materialize_report_journal_rows(batch_size),
        )
        total += materialized
        if materialized and GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.ingest_journal_replayed.inc(materialized)
        if consumed < batch_size:
            return total
