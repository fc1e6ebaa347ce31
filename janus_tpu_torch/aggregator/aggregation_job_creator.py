"""Aggregation job creation (leader).

The analog of ``AggregationJobCreator`` + ``BatchCreator`` (reference:
aggregator/src/aggregator/aggregation_job_creator.rs:67-981,
batch_creator.rs:32-517): periodically claims unaggregated reports, groups
them into aggregation jobs of [min, max] size — per batch interval for
TimeInterval tasks, via outstanding-batch filling for FixedSize tasks —
moves each report's payload into its StartLeader report aggregation, and
scrubs the client report.  Metadata-only: no VDAF compute happens here.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.time import time_to_batch_interval_start
from ..core.trace import emit_span, new_trace_id
from ..datastore import (
    AggregationJob,
    AggregationJobState,
    Datastore,
    ReportAggregation,
    ReportAggregationState,
    Transaction,
)
from ..datastore.task import AggregatorTask
from ..messages import (
    AggregationJobId,
    AggregationJobStep,
    BatchId,
    Duration,
    Interval,
    ReportMetadata,
    Role,
    Time,
)
from .aggregation_job_writer import AggregationJobWriter

logger = logging.getLogger("janus_tpu_torch.aggregation_job_creator")


@dataclass
class CreatorConfig:
    """reference: aggregation_job_creator.rs config fields"""

    min_aggregation_job_size: int = 10
    max_aggregation_job_size: int = 256
    reports_per_round: int = 5000
    batch_aggregation_shard_count: int = 8
    #: Write-behind ingest: every run_once pre-pass
    #: materializes report-journal rows at least this old into
    #: client_reports before claiming — the crash-replay + migration
    #: handoff for journaled replicas (a cohort staged on a dead replica
    #: becomes ordinary claimable reports here).  The grace keeps the
    #: creator from stealing seconds-old rows the upload replica's own
    #: staged consumer is about to pack zero-copy; stealing is safe
    #: (the row delete linearizes it), just wasteful.
    journal_replay_min_age_s: float = 5.0


class AggregationJobCreator:
    def __init__(self, datastore: Datastore, config: Optional[CreatorConfig] = None):
        self.datastore = datastore
        self.config = config or CreatorConfig()

    async def run_once(self) -> int:
        """One creation pass over every leader task; returns jobs created."""
        # Report-journal replay pre-pass: ACKed-but-
        # unmaterialized reports from journaled-ingest replicas become
        # claimable client_reports rows.  One indexed probe when the
        # journal is empty; failure-tolerant — a wedged replay must not
        # stop classic creation.
        try:
            _consumed, materialized = await self.datastore.run_tx_async(
                "report_journal_replay",
                lambda tx: tx.materialize_report_journal_rows(
                    self.config.reports_per_round,
                    min_age_s=self.config.journal_replay_min_age_s,
                ),
            )
            if materialized:
                from ..core.metrics import GLOBAL_METRICS

                if GLOBAL_METRICS.registry is not None:
                    GLOBAL_METRICS.ingest_journal_replayed.inc(materialized)
                logger.info("replayed %d report-journal rows", materialized)
        except Exception:
            logger.exception("report-journal replay pre-pass failed")
        tasks = await self.datastore.run_tx_async(
            "creator_tasks", lambda tx: tx.get_aggregator_tasks()
        )
        created = 0
        for task in tasks:
            if task.role != Role.LEADER:
                continue
            try:
                count, job_spans = await self.datastore.run_tx_async(
                    "create_aggregation_jobs",
                    lambda tx, task=task: self.create_jobs_for_task(tx, task),
                )
                created += count
                # Trace LINK point, emitted only AFTER the
                # transaction commits: the tx function re-runs on retryable
                # conflicts, and a span written mid-attempt would link
                # upload traces to phantom jobs that never committed.
                for span in job_spans:
                    emit_span("job_create", "job", **span)
            except Exception:
                logger.exception("job creation failed for task %s", task.task_id)
        return created

    # -- per-task creation (one transaction) ----------------------------
    def create_jobs_for_task(
        self, tx: Transaction, task: AggregatorTask
    ) -> Tuple[int, List[dict]]:
        vdaf = task.vdaf_instance()
        if getattr(vdaf, "REQUIRES_AGG_PARAM", False):
            # VDAFs with a real aggregation parameter (Poplar1) get their
            # jobs from collection requests, not from this periodic creator
            # (the reference gates this path behind test-util:
            # aggregation_job_creator.rs:741).
            logger.debug("skipping agg-param task %s", task.task_id)
            return 0, []
        metas = tx.get_unaggregated_client_reports_for_task(
            task.task_id, self.config.reports_per_round
        )
        if not metas:
            return 0, []
        if task.query_type.kind == "TimeInterval":
            jobs, leftover = self._group_time_interval(task, metas)
        else:
            jobs, leftover = self._group_fixed_size(tx, task, metas)

        # leftover reports go back to the unaggregated pool
        # (reference: aggregation_job_creator.rs:607-717)
        if leftover:
            tx.mark_reports_unaggregated(task.task_id, [m.report_id for m in leftover])

        writer = AggregationJobWriter(
            task,
            vdaf,
            batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
            initial_write=True,
        )
        count = 0
        job_spans: List[dict] = []
        for batch_id, group in jobs:
            t_job = time.monotonic()
            job_id = AggregationJobId.random()
            start = min(m.time.seconds for m in group)
            end = max(m.time.seconds for m in group) + 1
            job = AggregationJob(
                task_id=task.task_id,
                aggregation_job_id=job_id,
                aggregation_parameter=b"",
                partial_batch_identifier=batch_id,
                client_timestamp_interval=Interval(Time(start), Duration(end - start)),
                state=AggregationJobState.IN_PROGRESS,
                step=AggregationJobStep(0),
                # Trace mint point: the job's whole cross-process
                # pipeline — every driver step on any replica, the helper's
                # handling, log lines and chrome-trace spans — joins on
                # this persisted id.
                trace_id=new_trace_id(),
            )
            ras = []
            upload_traces = set()
            for ord_, meta in enumerate(group):
                # move payload from client_reports into the StartLeader row,
                # then scrub (reference: :718-731)
                report = tx.get_client_report(task.task_id, meta.report_id)
                if report is None:
                    continue
                if report.trace_id:
                    upload_traces.add(report.trace_id)
                ras.append(
                    ReportAggregation(
                        task_id=task.task_id,
                        aggregation_job_id=job_id,
                        report_id=meta.report_id,
                        time=meta.time,
                        ord=ord_,
                        state=ReportAggregationState.START_LEADER,
                        public_share=report.public_share,
                        leader_extensions=report.leader_extensions,
                        leader_input_share=report.leader_input_share,
                        helper_encrypted_input_share=report.helper_encrypted_input_share,
                    )
                )
                tx.scrub_client_report(task.task_id, meta.report_id)
            if not ras:
                continue
            writer.put(job, ras)
            # The job's creation span carries the upload trace ids of the
            # reports it packs, stitching client ingress (upload-minted
            # traces) onto the job's cross-process timeline — one view
            # from upload through prepare to collection.  Collected here,
            # EMITTED by run_once after the transaction commits: spans are
            # not transactional, so a mid-attempt emit would survive a
            # retried/rolled-back attempt as a phantom job.
            job_spans.append(
                dict(
                    start_s=t_job,
                    dur_s=time.monotonic() - t_job,
                    trace_id=job.trace_id,
                    task_id=str(task.task_id),
                    job_id=str(job_id),
                    reports=len(ras),
                    links=sorted(upload_traces),
                )
            )
            count += 1
        writer.write(tx)
        return count, job_spans

    def _group_time_interval(
        self, task: AggregatorTask, metas: List[ReportMetadata]
    ) -> Tuple[List[Tuple[Optional[BatchId], List[ReportMetadata]]], List[ReportMetadata]]:
        """Group by batch interval, then chunk into [min, max]-sized jobs
        (reference: aggregation_job_creator.rs:563-741)."""
        by_interval: Dict[int, List[ReportMetadata]] = {}
        for m in metas:
            start = time_to_batch_interval_start(m.time, task.time_precision).seconds
            by_interval.setdefault(start, []).append(m)
        jobs: List[Tuple[Optional[BatchId], List[ReportMetadata]]] = []
        leftover: List[ReportMetadata] = []
        for group in by_interval.values():
            for i in range(0, len(group), self.config.max_aggregation_job_size):
                chunk = group[i : i + self.config.max_aggregation_job_size]
                if len(chunk) >= self.config.min_aggregation_job_size:
                    jobs.append((None, chunk))
                else:
                    leftover.extend(chunk)
        return jobs, leftover

    # -- staged-cohort consumption (the zero-copy path) --------
    async def run_staged_once(self, plane) -> int:
        """One consumption pass over the ingest plane's staged cohorts
        (core/ingest.py IngestPlane.take_staged): pack journaled reports
        into aggregation jobs from their IN-MEMORY payloads — no
        client_reports read-back.  Returns jobs created.  Reports the
        pass cannot consume (race lost, cohort below min size) simply
        stay journaled and fall to the materializer."""
        created = 0
        for task_id, _shape, reports in plane.take_staged():
            try:
                count, packed, job_spans = await self.datastore.run_tx_async(
                    "staged_aggregation_jobs",
                    lambda tx, task_id=task_id, reports=reports: (
                        self._staged_jobs_tx(tx, task_id, reports)
                    ),
                )
                created += count
                from ..core.metrics import GLOBAL_METRICS

                if packed and GLOBAL_METRICS.registry is not None:
                    GLOBAL_METRICS.ingest_staged_total.labels(path="direct").inc(
                        packed
                    )
                # emitted only AFTER the commit, exactly like run_once
                for span in job_spans:
                    emit_span("job_create", "job", **span)
            except Exception:
                logger.exception("staged job creation failed for task %s", task_id)
        return created

    def _staged_jobs_tx(self, tx: Transaction, task_id, reports):
        task = tx.get_aggregator_task(task_id)
        if task is None:
            return 0, 0, []
        return self.create_jobs_from_staged(tx, task, reports)

    def create_jobs_from_staged(
        self, tx: Transaction, task: AggregatorTask, reports
    ) -> Tuple[int, int, List[dict]]:
        """Pack a staged cohort (LeaderStoredReports with live payloads)
        into aggregation jobs inside ``tx``; returns (jobs, reports
        packed, job spans).  TimeInterval tasks only — the ingest plane
        stages nothing else.

        Exactly-once per report is two writes in THIS transaction, in
        order: consume the journal row (``delete_report_journal_row`` —
        losing the delete means the materializer or a replaying replica
        owns the report, so we must write NOTHING for it), then insert
        the born-scrubbed client_reports tombstone
        (``put_scrubbed_client_report`` — losing that insert means a
        synchronous-path duplicate already materialized a row whose
        owner will pack it).  Only a report that wins both is packed."""
        vdaf = task.vdaf_instance()
        by_report = {r.report_id.data: r for r in reports}
        metas = [ReportMetadata(r.report_id, r.time) for r in reports]
        # leftovers (below min job size) are NOT consumed: their journal
        # rows are still outstanding, so the materializer/replay routes
        # them through the classic path instead of stranding them
        jobs, _leftover = self._group_time_interval(task, metas)
        writer = AggregationJobWriter(
            task,
            vdaf,
            batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
            initial_write=True,
        )
        count = 0
        packed = 0
        job_spans: List[dict] = []
        for batch_id, group in jobs:
            t_job = time.monotonic()
            job_id = AggregationJobId.random()
            ras = []
            upload_traces = set()
            for meta in group:
                report = by_report[meta.report_id.data]
                if not tx.delete_report_journal_row(task.task_id, meta.report_id):
                    continue  # consumed elsewhere: not ours to pack
                if not tx.put_scrubbed_client_report(
                    task.task_id, meta.report_id, meta.time, report.trace_id
                ):
                    continue  # duplicate already materialized: its owner packs it
                if report.trace_id:
                    upload_traces.add(report.trace_id)
                ras.append(
                    ReportAggregation(
                        task_id=task.task_id,
                        aggregation_job_id=job_id,
                        report_id=meta.report_id,
                        time=meta.time,
                        ord=len(ras),
                        state=ReportAggregationState.START_LEADER,
                        public_share=report.public_share,
                        leader_extensions=report.leader_extensions,
                        leader_input_share=report.leader_input_share,
                        helper_encrypted_input_share=report.helper_encrypted_input_share,
                    )
                )
            if not ras:
                continue
            start = min(ra.time.seconds for ra in ras)
            end = max(ra.time.seconds for ra in ras) + 1
            job = AggregationJob(
                task_id=task.task_id,
                aggregation_job_id=job_id,
                aggregation_parameter=b"",
                partial_batch_identifier=batch_id,
                client_timestamp_interval=Interval(Time(start), Duration(end - start)),
                state=AggregationJobState.IN_PROGRESS,
                step=AggregationJobStep(0),
                trace_id=new_trace_id(),
            )
            writer.put(job, ras)
            job_spans.append(
                dict(
                    start_s=t_job,
                    dur_s=time.monotonic() - t_job,
                    trace_id=job.trace_id,
                    task_id=str(task.task_id),
                    job_id=str(job_id),
                    reports=len(ras),
                    links=sorted(upload_traces),
                )
            )
            count += 1
            packed += len(ras)
        if count:
            writer.write(tx)
        return count, packed, job_spans

    def _group_fixed_size(
        self, tx: Transaction, task: AggregatorTask, metas: List[ReportMetadata]
    ) -> Tuple[List[Tuple[Optional[BatchId], List[ReportMetadata]]], List[ReportMetadata]]:
        """Incremental batch filling via the headroom-priority BatchCreator
        (reference: batch_creator.rs:32-517 — see batch_creator.py)."""
        from .batch_creator import BatchCreator

        creator = BatchCreator(
            tx,
            task,
            self.config.min_aggregation_job_size,
            self.config.max_aggregation_job_size,
        )
        for m in metas:
            creator.add_report(m)
        return creator.finish()
