"""Transactional write-combiner for aggregation jobs.

The analog of ``AggregationJobWriter`` (reference:
aggregator/src/aggregator/aggregation_job_writer.rs:35-861): writes an
aggregation job plus its report aggregations in one transaction, accumulating
every Finished report's output share into a randomly-chosen shard of the
batch's ``batch_aggregations`` accumulator — the write-contention sharding the
device path later merges on the card (SURVEY.md §2.3 P4).  Reports whose
batch has already been collected are failed with BatchCollected.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.report_id import checksum_combined, checksum_updated_with
from ..core.time import interval_merge, time_to_batch_interval
from ..datastore import (
    AggregationJob,
    AggregationJobState,
    BatchAggregation,
    BatchAggregationState,
    ReportAggregation,
    ReportAggregationState,
    Transaction,
    TxConflict,
)
from ..datastore.query_type import strategy_for
from ..datastore.task import AggregatorTask
from ..messages import Interval, PrepareError, ReportIdChecksum


class AggregationJobWriter:
    """Collects job + report-aggregation writes, then commits them with
    batch-aggregation accumulation inside the caller's transaction.

    ``initial_write=True`` is the creation path (jobs counted into
    aggregation_jobs_created); False is the update path (terminal jobs
    counted into aggregation_jobs_terminated), mirroring the reference's
    InitialWrite/UpdateWrite strategies.

    ``out_shares`` maps a finished report's id bytes to its VDAF output-share
    vector; shares are accumulated here and never persisted per report
    (the reference does the same: out shares exist only inside this write).
    """

    def __init__(
        self,
        task: AggregatorTask,
        vdaf,
        batch_aggregation_shard_count: int = 8,
        initial_write: bool = True,
        backend=None,
        accumulator_deltas: Optional[
            Dict[bytes, Tuple[Sequence[int], frozenset]]
        ] = None,
        journal_entries: Optional[Dict[bytes, frozenset]] = None,
        journal_drain_interval_s: Optional[float] = None,
    ):
        self.task = task
        self.vdaf = vdaf
        self.shard_count = batch_aggregation_shard_count
        self.initial_write = initial_write
        #: Device backend (CudaBackend) for on-device out-share
        #: accumulation; None falls back to host field adds.
        self.backend = backend
        #: Pre-drained device-resident deltas (executor/accumulator.py):
        #: batch identifier -> (field vector, report ids it covers).  Rows
        #: whose out_share is a ResidentRef are summed by these instead of
        #: host vectors; the rid set is checked against the reports that
        #: survive the in-tx BatchCollected gate (mismatch raises
        #: StaleAccumulatorDelta — the delta must never merge a report the
        #: tx is failing).
        self.accumulator_deltas = accumulator_deltas or {}
        #: Deferred drains (accumulator.drain_interval_s > 0): batch
        #: identifier -> report ids whose out shares STAY resident on
        #: device past this tx.  The writer persists one accumulator-
        #: journal row per (job, identifier) in the same transaction and
        #: merges NO share for those rows now — the cadence drain (or a
        #: crash-recovery replay) merges them later against the row.
        self.journal_entries = journal_entries or {}
        #: the owning accumulator's drain interval, stored on each journal
        #: row so that a collection step knows how long to leave the row
        #: to its owner's drain
        self.journal_drain_interval_s = journal_drain_interval_s
        self._jobs: List[
            Tuple[AggregationJob, List[ReportAggregation], Dict[bytes, Sequence[int]]]
        ] = []

    def put(
        self,
        job: AggregationJob,
        report_aggregations: List[ReportAggregation],
        out_shares: Optional[Dict[bytes, Sequence[int]]] = None,
    ):
        self._jobs.append((job, report_aggregations, out_shares or {}))

    # ------------------------------------------------------------------
    def write(self, tx: Transaction) -> Dict[bytes, PrepareError]:
        """Write everything; returns {report_id.data: error} for reports that
        were failed during the write (batch already collected)."""
        strategy = strategy_for(self.task)
        failures: Dict[bytes, PrepareError] = {}
        collected: Dict[bytes, bool] = {}

        def ident_for(job: AggregationJob, ra: ReportAggregation) -> bytes:
            if job.partial_batch_identifier is not None:
                return job.partial_batch_identifier.get_encoded()
            return strategy.to_batch_identifier(self.task, ra.time)

        def is_collected(ident: bytes, param: bytes) -> bool:
            if ident not in collected:
                bas = tx.get_batch_aggregations_for_batch(
                    self.task.task_id, ident, param
                )
                collected[ident] = any(
                    ba.state != BatchAggregationState.AGGREGATING for ba in bas
                )
            return collected[ident]

        for job, ras, out_shares in self._jobs:
            # Fail reports aimed at collected batches
            # (reference: aggregation_job_writer.rs:591-698).
            checked: List[ReportAggregation] = []
            for ra in ras:
                if ra.state != ReportAggregationState.FAILED and is_collected(
                    ident_for(job, ra), job.aggregation_parameter
                ):
                    ra = ra.failed(PrepareError.BATCH_COLLECTED)
                    failures[ra.report_id.data] = PrepareError.BATCH_COLLECTED
                    out_shares.pop(ra.report_id.data, None)
                checked.append(ra)
            ras = checked

            if self.initial_write:
                tx.put_aggregation_job(job)
                for ra in ras:
                    tx.put_report_aggregation(ra)
            else:
                tx.update_aggregation_job(job)
                for ra in ras:
                    tx.update_report_aggregation(ra)

            if self.journal_entries:
                self._write_journal(tx, job, failures)
            self._accumulate(tx, job, ras, out_shares, ident_for)
        return failures

    def _write_journal(self, tx, job, failures) -> None:
        """Persist the deferred-drain journal rows IN this transaction.
        A journaled report that was failed by the in-tx collected check
        would leave the resident delta counting a report the tx rejects —
        abort via StaleAccumulatorDelta (the caller discards the bucket
        and the step redelivers, exactly like the drained-delta race)."""
        from ..executor.accumulator import StaleAccumulatorDelta

        for ident, rids in self.journal_entries.items():
            dropped = [r for r in rids if r in failures]
            if dropped:
                raise StaleAccumulatorDelta(
                    f"batch {ident!r}: {len(dropped)} journaled report(s) "
                    "failed in-tx (batch collected)"
                )
            tx.put_accumulator_journal_entry(
                self.task.task_id,
                ident,
                job.aggregation_parameter,
                job.aggregation_job_id,
                sorted(rids),
                self.journal_drain_interval_s,
            )

    # ------------------------------------------------------------------
    def _sum_shares(self, field, shares: List[Sequence[int]]) -> List[int]:
        """Sum out-share vectors: on the card (the sum replacing the
        reference's DB shard merge) when a device backend is attached and
        the batch is worth a launch; host field adds otherwise."""
        backend = self.backend
        if backend is not None and hasattr(backend, "aggregate_batch") and len(shares) > 1:
            import numpy as np

            tf = backend.bp.f  # the prepare's TField: host ints <-> u32 limbs
            limbs = tf.to_limbs([x for sh in shares for x in sh]).reshape(
                len(shares), -1, tf.n
            )
            return backend.aggregate_batch(limbs, np.ones(len(shares), dtype=bool))
        acc: Optional[List[int]] = None
        for sh in shares:
            acc = list(sh) if acc is None else field.vec_add(acc, sh)
        return acc

    # ------------------------------------------------------------------
    def _resolve_shares(self, field, ident, shares, rids) -> Optional[List[int]]:
        """Sum one batch's finished shares, mixing host vectors with a
        pre-drained device-resident delta (ResidentRef rows).  Rows named
        by a deferred-drain journal entry contribute NOTHING here (their
        delta stays on device; the journal row written in this tx is what
        guarantees it is merged later).  Returns None when every share is
        deferred — the batch row carries count/checksum only for now."""
        from ..executor.accumulator import ResidentRef, StaleAccumulatorDelta

        host_rows = [s for s in shares if not isinstance(s, ResidentRef)]
        ref_rids = {
            rid for rid, s in zip(rids, shares) if isinstance(s, ResidentRef)
        }
        journaled = ref_rids & set(self.journal_entries.get(ident, frozenset()))
        need_drained = ref_rids - journaled
        if not need_drained:
            return self._sum_shares(field, host_rows) if host_rows else None
        delta, covered = self.accumulator_deltas.get(ident, (None, frozenset()))
        if delta is None or set(covered) != need_drained:
            raise StaleAccumulatorDelta(
                f"batch {ident!r}: drained delta covers {len(covered)} "
                f"report(s), tx needs exactly {len(need_drained)}"
            )
        if not host_rows:
            return list(delta)
        return field.vec_add(list(delta), self._sum_shares(field, host_rows))

    # ------------------------------------------------------------------
    def _accumulate(self, tx, job, ras, out_shares, ident_for) -> None:
        """Merge finished out-shares into per-batch shard accumulators and
        update the created/terminated job counters the collection readiness
        gate relies on (reference: collection_job_driver.rs:124-262)."""
        by_batch: Dict[bytes, List[ReportAggregation]] = {}
        for ra in ras:
            if (
                ra.state == ReportAggregationState.FINISHED
                and ra.report_id.data in out_shares
            ):
                by_batch.setdefault(ident_for(job, ra), []).append(ra)

        # Job-level counters land on every batch the job touched; for a job
        # with no finished reports, on the batch of its interval start.
        job_batches = set(by_batch)
        if job.partial_batch_identifier is not None:
            job_batches.add(job.partial_batch_identifier.get_encoded())
        elif not job_batches:
            job_batches.add(
                time_to_batch_interval(
                    job.client_timestamp_interval.start, self.task.time_precision
                ).get_encoded()
            )

        field = self.vdaf.field_for_agg_param(
            self.vdaf.decode_agg_param(job.aggregation_parameter)
        )
        terminal = job.state in (
            AggregationJobState.FINISHED,
            AggregationJobState.ABANDONED,
        )
        for ident in job_batches:
            finished = by_batch.get(ident, [])
            shard = random.randrange(self.shard_count)
            agg_share: Optional[List[int]] = None
            count = 0
            checksum = ReportIdChecksum.zero()
            interval = Interval.EMPTY
            for ra in finished:
                count += 1
                checksum = checksum_updated_with(checksum, ra.report_id)
                interval = interval_merge(
                    interval,
                    time_to_batch_interval(ra.time, self.task.time_precision),
                )
            if finished:
                agg_share = self._resolve_shares(
                    field, ident, [out_shares[ra.report_id.data] for ra in finished],
                    [ra.report_id.data for ra in finished],
                )
            delta = BatchAggregation(
                task_id=self.task.task_id,
                batch_identifier=ident,
                aggregation_parameter=job.aggregation_parameter,
                ord=shard,
                state=BatchAggregationState.AGGREGATING,
                aggregate_share=field.encode_vec(agg_share)
                if agg_share is not None
                else None,
                report_count=count,
                checksum=checksum,
                client_timestamp_interval=interval,
                aggregation_jobs_created=1 if self.initial_write else 0,
                aggregation_jobs_terminated=1
                if (not self.initial_write and terminal)
                else 0,
            )
            upsert_batch_aggregation(tx, field, delta)


def upsert_batch_aggregation(tx: Transaction, field, delta: BatchAggregation) -> None:
    """Merge ``delta`` into its shard row, creating it if absent (the one
    upsert shared by the writer's accumulate path and the deferred-drain /
    journal-replay share merges — they must never diverge)."""
    existing = tx.get_batch_aggregation(
        delta.task_id, delta.batch_identifier, delta.aggregation_parameter, delta.ord
    )
    if existing is not None:
        tx.update_batch_aggregation(merge_batch_aggregations(field, existing, delta))
        return
    try:
        tx.put_batch_aggregation(delta)
    except TxConflict:
        fresh = tx.get_batch_aggregation(
            delta.task_id, delta.batch_identifier, delta.aggregation_parameter, delta.ord
        )
        tx.update_batch_aggregation(merge_batch_aggregations(field, fresh, delta))


def merge_share_delta(
    tx: Transaction,
    task: AggregatorTask,
    field,
    batch_identifier: bytes,
    aggregation_parameter: bytes,
    vector: Sequence[int],
    shard_count: int = 8,
) -> None:
    """Merge a share-ONLY delta into one random shard of a batch's
    accumulator — the deferred-drain / journal-replay write: the covered
    reports' count, checksum and interval were already committed by their
    jobs' writer transactions; only the aggregate share was left resident
    on device."""
    delta = BatchAggregation(
        task_id=task.task_id,
        batch_identifier=batch_identifier,
        aggregation_parameter=aggregation_parameter,
        ord=random.randrange(shard_count),
        state=BatchAggregationState.AGGREGATING,
        aggregate_share=field.encode_vec(list(vector)),
        report_count=0,
        checksum=ReportIdChecksum.zero(),
        client_timestamp_interval=Interval.EMPTY,
        aggregation_jobs_created=0,
        aggregation_jobs_terminated=0,
    )
    upsert_batch_aggregation(tx, field, delta)


def merge_batch_aggregations(
    field, base: BatchAggregation, add: BatchAggregation
) -> BatchAggregation:
    """Pointwise merge of two shard accumulators (same batch/param/ord)."""
    share_a = field.decode_vec(base.aggregate_share) if base.aggregate_share else None
    share_b = field.decode_vec(add.aggregate_share) if add.aggregate_share else None
    if share_a is None:
        merged = share_b
    elif share_b is None:
        merged = share_a
    else:
        merged = field.vec_add(share_a, share_b)
    return BatchAggregation(
        task_id=base.task_id,
        batch_identifier=base.batch_identifier,
        aggregation_parameter=base.aggregation_parameter,
        ord=base.ord,
        state=base.state,
        aggregate_share=field.encode_vec(merged) if merged is not None else None,
        report_count=base.report_count + add.report_count,
        checksum=checksum_combined(base.checksum, add.checksum),
        client_timestamp_interval=interval_merge(
            base.client_timestamp_interval, add.client_timestamp_interval
        ),
        aggregation_jobs_created=base.aggregation_jobs_created
        + add.aggregation_jobs_created,
        aggregation_jobs_terminated=base.aggregation_jobs_terminated
        + add.aggregation_jobs_terminated,
    )
