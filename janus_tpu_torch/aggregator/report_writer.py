"""Batched upload writer + the batched HPKE-open stage.

The analog of ``ReportWriteBatcher`` (reference:
aggregator/src/aggregator/report_writer.rs:39-246): uploaded reports from all
tasks are funneled into one background batcher that commits up to
``max_batch_size`` of them in a single datastore transaction (or after
``max_batch_write_delay`` elapses), fanning per-report results back to the
waiting upload handlers.  In-batch duplicates by (task, report id) are
resolved to a single write.  Rejected uploads increment the task's sharded
upload counters (reference: report_writer.rs:324 TaskUploadCounters).

This module also holds the front door's OTHER batcher: :class:`UploadOpenBatcher`
applies the same size/delay pattern to the expensive half of upload
validation — the HPKE open.  Concurrent uploads' opens queue here, flush
as ONE ``core/hpke_batch.open_batch`` call on a worker thread (per-report
KEM off the event loop, all AES-GCM bodies as one vectorized pass), and
its bounded queue is the admission-control point: past the depth or
delay budget, :meth:`UploadOpenBatcher.admit` sheds with the
DAP-retryable 503 + Retry-After instead of letting the event loop
drown (counted in ``janus_upload_shed_total``, visible in /statusz).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from ..core.hpke_batch import VectorPassError, route_rows
from ..datastore import Datastore, LeaderStoredReport, TaskUploadCounter, TxConflict
from ..messages import TaskId
from .error import ReportRejection, UploadShed

logger = logging.getLogger(__name__)


class ReportWriteBatcher:
    def __init__(
        self,
        datastore: Datastore,
        max_batch_size: int = 100,
        max_batch_write_delay: float = 0.25,
        counter_shard_count: int = 8,
    ):
        self.datastore = datastore
        self.max_batch_size = max_batch_size
        self.max_batch_write_delay = max_batch_write_delay
        self.counter_shard_count = counter_shard_count
        #: (report, waiter, enqueue-monotonic) — the timestamp feeds
        #: janus_report_upload_to_commit_seconds and the upload_commit span
        self._queue: List[Tuple[object, asyncio.Future, float]] = []
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        #: flush generation: a call_later-scheduled
        #: _flush can interleave with a size-triggered _flush_locked — by
        #: the time the timer task wins the lock, its cohort was already
        #: flushed and a NEW cohort's timer may be armed.  The stale task
        #: must neither cancel that live timer nor flush the new cohort
        #: early, so each armed timer carries the generation it was armed
        #: for and a fired flush whose generation has moved on is a no-op.
        self._flush_gen = 0
        self._lock = asyncio.Lock()

    # ------------------------------------------------------------------
    async def write_report(self, report: LeaderStoredReport) -> None:
        """Enqueue a validated report; resolves when its batch commits.
        Raises ReportRejection if the store rejected it.

        Upload trace: a report arriving without a trace id
        adopts the caller's bound trace context or mints a fresh one, so
        EVERY persisted report carries a 32-hex upload trace — including
        writes from paths that bypass handle_upload (load generators,
        soaks seeding through the real writer)."""
        if report.trace_id is None:
            from ..core.trace import current_trace, new_trace_id

            report = dataclasses.replace(
                report,
                trace_id=current_trace().get("trace_id") or new_trace_id(),
            )
        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            self._queue.append((report, fut, time.monotonic()))
            if len(self._queue) >= self.max_batch_size:
                await self._flush_locked()
            elif self._flush_handle is None:
                loop = asyncio.get_running_loop()
                gen = self._flush_gen
                self._flush_handle = loop.call_later(
                    self.max_batch_write_delay,
                    lambda: asyncio.ensure_future(self._flush(gen)),
                )
        await fut

    async def write_rejection(self, task_id: TaskId, rejection: ReportRejection) -> None:
        """Record a rejected upload in the task's sharded counters."""
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.upload_outcomes.labels(decision=rejection.category).inc()
        shard = random.randrange(self.counter_shard_count)
        counter = TaskUploadCounter(task_id, **{rejection.category: 1})

        def tx_fn(tx):
            tx.increment_task_upload_counter(task_id, shard, counter)

        await self.datastore.run_tx_async("upload_rejection", tx_fn)

    async def _flush(self, gen: Optional[int] = None) -> None:
        async with self._lock:
            if gen is not None and gen != self._flush_gen:
                # stale timer: its cohort was already size-flushed while
                # this task waited on the lock.  Returning (instead of
                # flushing) keeps it from cancelling the NEW cohort's
                # timer and draining that cohort before its delay.
                return
            await self._flush_locked()

    async def _flush_locked(self) -> None:
        self._flush_gen += 1
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        batch, self._queue = self._queue, []
        if not batch:
            return
        # In-batch dedup by (task, report id): first wins, dups succeed as
        # idempotent uploads (reference: report_writer.rs:159-237).
        seen: Dict[bytes, int] = {}
        unique: List[Tuple[object, List[asyncio.Future], float]] = []
        for report, fut, enqueued in batch:
            key = report.task_id.data + report.report_id.data
            if key in seen:
                unique[seen[key]][1].append(fut)
            else:
                seen[key] = len(unique)
                unique.append((report, [fut], enqueued))

        def tx_fn(tx):
            outcomes = []
            shard = random.randrange(self.counter_shard_count)
            for report, _futs, _enq in unique:
                try:
                    tx.put_client_report(report)
                    tx.increment_task_upload_counter(
                        report.task_id,
                        shard,
                        TaskUploadCounter(report.task_id, report_success=1),
                    )
                    outcomes.append(None)
                except TxConflict:
                    # duplicate upload: idempotent success
                    outcomes.append(None)
            return outcomes

        from ..core import faults
        from ..core.metrics import GLOBAL_METRICS

        try:
            # Failure-domain boundary: an injected flush fault impersonates
            # a batch-commit failure — fanned to every waiting upload
            # handler exactly like a real one (clients retry the upload).
            await faults.fire_async("report_writer.flush")
            outcomes = await self.datastore.run_tx_async("upload_batch", tx_fn)
        except Exception as e:  # commit failed: fan the error to every waiter
            for _report, futs, _enq in unique:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
            return
        from ..core.trace import emit_span

        have_metrics = GLOBAL_METRICS.registry is not None
        now_s = self.datastore.now().seconds if have_metrics else 0
        committed = time.monotonic()
        accepted = 0
        for (report, futs, enqueued), outcome in zip(unique, outcomes):
            if outcome is None:
                if have_metrics:
                    accepted += 1
                    # Freshness SLO input: report age at commit (client
                    # timestamp -> writer commit) per accepted report.
                    GLOBAL_METRICS.report_commit_age.observe(
                        max(0.0, float(now_s - report.time.seconds))
                    )
                    # Front-door SLO input: how long the batcher
                    # held the report before it was durable.
                    GLOBAL_METRICS.upload_to_commit.observe(
                        max(0.0, committed - enqueued)
                    )
                # Per-report CHILD span stamped with the UPLOAD's trace id
                # (the flush_share pattern): the client-ingress hop of the
                # merged timeline, enqueue -> batch commit.
                emit_span(
                    "upload_commit",
                    "upload",
                    enqueued,
                    committed - enqueued,
                    trace_id=report.trace_id,
                    task_id=str(report.task_id),
                )
            for fut in futs:
                if fut.done():
                    continue
                if outcome is None:
                    fut.set_result(None)
                else:
                    fut.set_exception(outcome)
        if have_metrics:
            GLOBAL_METRICS.upload_outcomes.labels(decision="accepted").inc(accepted)


# ---------------------------------------------------------------------------
# the batched HPKE-open stage


#: The process's front-door open batcher, registered at construction so
#: /statusz can render queue depth / shed counts without holding the
#: Aggregator (one aggregator binary per process; tests that build
#: several see the most recent, which is the serving one).
_FRONTDOOR: Optional["UploadOpenBatcher"] = None


def frontdoor_stats() -> Optional[dict]:
    """The /statusz "upload" section (None when no opener exists —
    driver/creator binaries)."""
    return _FRONTDOOR.stats() if _FRONTDOOR is not None else None


class UploadOpenBatcher:
    """Size/delay batcher for upload HPKE opens + the front door's
    admission-control point.

    ``open()`` enqueues one report's open; a batch flushes when
    ``max_batch_size`` opens are pending or ``max_batch_delay`` elapses,
    as ONE ``hpke_batch.open_batch`` call on a worker thread — the KEM
    leaves the event loop, the AES-GCM bodies fuse into one vectorized
    pass, and per-report error slots keep one malformed ciphertext from
    touching its batchmates.  Multiple flushes may be in flight at once
    (the lock covers only queue surgery, never crypto).

    ``admit()`` is the load-shedding gate: callers invoke it BEFORE any
    per-upload work; past ``max_queue`` pending opens, or once the oldest
    pending open has waited ``shed_delay_s``, it raises
    :class:`UploadShed` (503 + Retry-After).  Both signals mean the open
    stage is not keeping up — refusing new work with a retryable error is
    strictly cheaper than queueing it to time out."""

    def __init__(
        self,
        max_batch_size: int = 64,
        max_batch_delay: float = 0.005,
        max_queue: int = 1024,
        shed_delay_s: float = 2.0,
        device=None,
    ):
        self.max_batch_size = max_batch_size
        #: the vector pass's device (None: the process's configured one)
        self.device = device
        self.max_batch_delay = max_batch_delay
        self.max_queue = max_queue
        self.shed_delay_s = shed_delay_s
        #: (request 4-tuple, waiter, enqueue-monotonic, report ident)
        self._queue: List[Tuple[tuple, asyncio.Future, float, Optional[tuple]]] = []
        #: detached-but-unresolved batches: seq -> (rows, oldest enqueue).
        #: Admission control MUST count these — the staging queue drains
        #: into flight at max_batch_size/max_batch_delay granularity, so
        #: on its own it can never reach a real queue bound while a slow
        #: open stage piles work up on the thread pool.
        self._inflight: Dict[int, Tuple[int, float]] = {}
        self._batch_seq = 0
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._flush_gen = 0
        self._lock = asyncio.Lock()
        self._sheds = {"queue_full": 0, "queue_delay": 0}
        self._batches = 0
        self._opened = 0
        self._bisections = 0
        self._quarantined = 0
        self._vector_pass_failures = 0
        global _FRONTDOOR
        _FRONTDOOR = self

    # -- admission control ----------------------------------------------
    def queue_depth(self) -> int:
        """Opens pending anywhere in the front door: staged + in flight.
        The DEPTH bound must count detached-but-unresolved batches — the
        staging queue drains into flight at batch-size granularity, so
        on its own it could never reach a real bound while a slow open
        stage piles work up on the thread pool."""
        return len(self._queue) + sum(n for n, _enq in self._inflight.values())

    def oldest_wait_s(self) -> float:
        """Age of the oldest STAGED open.  Deliberately excludes
        in-flight batches: their age spikes transiently on one-off costs
        (a cold kernel build or first launch at a new pow2 shape) that the depth
        bound already covers — a staged entry aging past budget, by
        contrast, means flushes have stopped being picked up at all
        (event-loop or timer starvation), which is exactly the collapse
        the delay shed exists to catch."""
        return time.monotonic() - self._queue[0][2] if self._queue else 0.0

    def admit(self) -> None:
        """Raise :class:`UploadShed` when the front door is past budget;
        counted per reason in janus_upload_shed_total."""
        reason = None
        if self.max_queue > 0 and self.queue_depth() >= self.max_queue:
            reason = "queue_full"
        elif self.shed_delay_s > 0 and self.oldest_wait_s() > self.shed_delay_s:
            reason = "queue_delay"
        if reason is None:
            return
        from ..core.metrics import GLOBAL_METRICS

        self._sheds[reason] += 1
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.upload_sheds.labels(reason=reason).inc()
        raise UploadShed(f"upload front door over {reason} budget; retry")

    # -- the open stage --------------------------------------------------
    async def open(self, keypair, info, ciphertext, aad, ident=None) -> bytes:
        """Resolve to the plaintext when this report's batch opens;
        raises HpkeError on a per-report decrypt failure.  ``ident`` is an
        optional (task_hex, report_id_bytes) pair carried alongside the
        request so a poison row isolated by bisection can be recorded in
        the quarantine ledger under its report identity."""
        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            self._queue.append(
                ((keypair, info, ciphertext, aad), fut, time.monotonic(), ident)
            )
            self._publish_depth()
            if len(self._queue) >= self.max_batch_size:
                await self._flush_locked()
            elif self._flush_handle is None:
                loop = asyncio.get_running_loop()
                gen = self._flush_gen
                self._flush_handle = loop.call_later(
                    self.max_batch_delay,
                    lambda: asyncio.ensure_future(self._flush(gen)),
                )
        return await fut

    async def _flush(self, gen: Optional[int] = None) -> None:
        async with self._lock:
            if gen is not None and gen != self._flush_gen:
                return  # stale timer (see ReportWriteBatcher._flush)
            await self._flush_locked()

    async def _flush_locked(self) -> None:
        """Detach the pending cohort and launch its open off-lock: the
        lock guards queue surgery only, so several batches can be in
        flight on the thread pool at once."""
        self._flush_gen += 1
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        batch, self._queue = self._queue, []
        if not batch:
            self._publish_depth()
            return
        seq = self._batch_seq
        self._batch_seq += 1
        self._inflight[seq] = (len(batch), batch[0][2])
        self._publish_depth()
        asyncio.ensure_future(self._run_batch(batch, seq))

    async def _run_batch(self, batch, seq: int) -> None:
        from ..core.metrics import GLOBAL_METRICS

        requests = [item for item, _fut, _enq, _ident in batch]
        t0 = time.monotonic()
        try:
            loop = asyncio.get_running_loop()
            try:
                results = await loop.run_in_executor(
                    None, _open_batch_worker, requests, self.device
                )
            except VectorPassError as e:
                # the vector pass failed as a whole: no report was judged,
                # so none is bisected or opened another way
                results = self._vector_pass_failed(batch, e)
            except Exception:
                # batch-LEVEL failure: bisect the cohort on the thread
                # pool to isolate the poison row(s) — O(log B) extra
                # passes, not B serial opens — while rejecting nothing
                # the inline path would accept (a failing singleton
                # falls through to the inline open, errors as values)
                try:
                    results, offenders = await loop.run_in_executor(
                        None, _open_bisect_worker, requests, self.device
                    )
                    self._note_offenders(batch, offenders)
                except VectorPassError as e:
                    results = self._vector_pass_failed(batch, e)
            took = time.monotonic() - t0
            self._batches += 1
            self._opened += len(batch)
            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.upload_open_batch_rows.observe(len(batch))
                GLOBAL_METRICS.upload_open_seconds.labels(backend="batched").observe(took)
        except BaseException as e:
            # nothing above should throw, but a stranded upload handler
            # (future never resolved) is the one unacceptable outcome
            for _item, fut, _enq, _ident in batch:
                if not fut.done():
                    fut.set_exception(
                        e if isinstance(e, Exception) else RuntimeError(str(e))
                    )
            raise
        finally:
            self._inflight.pop(seq, None)
            self._publish_depth()
        for (_item, fut, _enq, _ident), result in zip(batch, results):
            if fut.done():
                continue
            if isinstance(result, Exception):
                fut.set_exception(result)
            else:
                fut.set_result(result)

    def _vector_pass_failed(self, batch, error) -> list:
        """Count a failed vector pass and answer each of its uploads with
        a retryable ServiceUnavailable (503 + Retry-After)."""
        from ..core.metrics import GLOBAL_METRICS
        from .error import ServiceUnavailable

        logger.error("upload vector pass failed for %d upload(s): %s", len(batch), error)
        self._vector_pass_failures += 1
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.hpke_vector_pass_failures.labels(stage="upload").inc()
        return [ServiceUnavailable(f"upload open failed on the device; retry: {error}") for _ in batch]

    def _note_offenders(self, batch, offenders) -> None:
        """Record bisection-isolated poison rows in the quarantine ledger
        under their report identity (when the caller supplied one)."""
        from ..core import quarantine

        quarantine.note_bisection()
        self._bisections += 1
        for idx, err in offenders:
            item, _fut, _enq, ident = batch[idx]
            task_hex, report_id = ident if ident is not None else (None, None)
            quarantine.record(
                "upload_open",
                task=task_hex,
                report_id=report_id,
                error=err,
                payload=item[2],  # the ciphertext
            )
            self._quarantined += 1

    def _publish_depth(self) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.upload_queue_depth.set(self.queue_depth())

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth(),
            "staged": len(self._queue),
            "inflight": sum(n for n, _enq in self._inflight.values()),
            "oldest_wait_s": round(self.oldest_wait_s(), 4),
            "max_queue": self.max_queue,
            "shed_delay_s": self.shed_delay_s,
            "sheds": dict(self._sheds),
            "batches": self._batches,
            "opened": self._opened,
            "bisections": self._bisections,
            "quarantined": self._quarantined,
            "vector_pass_failures": self._vector_pass_failures,
            "routes": route_rows("upload"),
        }


def _open_batch_worker(requests, device=None):
    """Thread-pool body of one open batch; the ``upload.open`` fault
    point lets chaos wedge the open stage (delay mode backs the queue up
    into sheds; error mode exercises the per-report fallback)."""
    from ..core import faults
    from ..core.hpke_batch import open_batch

    faults.fire("upload.open")
    return open_batch(requests, device)


def _open_bisect_worker(requests, device=None):
    """Batch-level failure fallback: bisect the cohort to isolate the
    poison row(s) instead of re-running the FULL batch inline serially (a
    healthy 499-report cohort must not pay 499 serial opens for one
    poison row).  The bisection attempt is ``open_batch`` WITHOUT the
    ``upload.open`` fault hook — an injected transient must heal on the
    full-cohort retry, not quarantine healthy reports.  A singleton that
    still fails the batch path gets the per-report inline open (errors as
    values), so nothing the inline path would accept is ever rejected.
    A vector pass that fails as a whole is no poison row: it stops the
    bisection and is raised, so that no report is opened another way.
    Returns (results, offenders) where offenders is [(index, error)]."""
    from ..core.hpke_batch import _open_one, open_batch
    from ..core.quarantine import bisect_batch

    vector_fault: List[VectorPassError] = []

    def attempt(subset):
        if vector_fault:
            raise vector_fault[0]
        try:
            return open_batch(subset, device)
        except VectorPassError as e:
            vector_fault.append(e)
            raise

    outcome = bisect_batch(requests, attempt)
    if vector_fault:
        raise vector_fault[0]
    results = [None] * len(requests)
    for i, r in outcome.results.items():
        results[i] = r
    offenders = []
    for i, err in outcome.offenders:
        one = _open_one(*requests[i])
        results[i] = one
        if isinstance(one, Exception):
            offenders.append((i, err))
    return results, offenders
