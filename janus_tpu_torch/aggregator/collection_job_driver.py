"""Collection job stepping (leader).

The analog of ``CollectionJobDriver`` (reference:
aggregator/src/aggregator/collection_job_driver.rs:43-650): a leased
collection job steps through a readiness gate (no unaggregated reports in
scope AND every started aggregation job terminated), marks the batch
Collected (writing empty fence shards so concurrent aggregation writers
fail fast), computes the leader share from the shard accumulators, applies
the differential-privacy hook, requests the helper's encrypted aggregate
share, and stores the Finished job.  Not-ready jobs are released with a
stepped retry delay (reference RetryStrategy :723-792).
"""

from __future__ import annotations

import asyncio
import logging
import math
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.report_id import checksum_combined
from ..core.retries import HttpRetryPolicy, retry_http_request
from ..datastore import (
    BatchAggregation,
    BatchAggregationState,
    CollectionJobState,
    Datastore,
    Lease,
)
from ..datastore.datastore import DatastoreError, DatastoreUnavailable
from ..datastore.query_type import strategy_for
from ..datastore.task import AggregatorTask
from ..messages import (
    AggregateShare,
    AggregateShareReq,
    BatchId,
    BatchSelector,
    Duration,
    Interval,
    ReportIdChecksum,
)
from .aggregate_share import compute_aggregate_share
from .aggregation_job_writer import merge_batch_aggregations
from .error import InvalidBatchSize

logger = logging.getLogger("janus_tpu_torch.collection_job_driver")

#: The replay bound, in the owner's drain intervals: an accumulator-journal
#: row younger than this many of its owner's drain intervals
#: (``drain_interval_s`` on the row) is left to the owner's cadence drain,
#: and the collection job asks again, as for any batch not yet ready.  An
#: older row's owner is presumed dead (a live owner drains a row within
#: about one interval and its maintenance cadence), and the row is
#: replayed on the CPU oracle.
JOURNAL_REPLAY_AFTER_INTERVALS = 4


# Strategy types live in core.dp (ZCdpDiscreteGaussian discrete-Gaussian
# noise + the no-op); re-exported here for compatibility with earlier API.
from ..core.dp import NoDifferentialPrivacy, dp_strategy_from_dict  # noqa: E402


@dataclass
class CollectionDriverConfig:
    maximum_attempts_before_failure: int = 10
    #: Uniform retryable-failure budget (mirrors DriverConfig
    #: .max_step_attempts): a failed helper exchange releases the lease
    #: with exponential backoff and abandons once lease_attempts reaches
    #: this, instead of redelivering forever.
    max_step_attempts: int = 10
    #: Readiness-poll backoff: a NOT-READY job (reports still
    #: aggregating) re-polls on this curve (reference RetryStrategy
    #: :723-792).  Distinct from the failure backoff below — polling an
    #: unready batch is normal operation, not a failure.
    retry_initial_delay: Duration = Duration(5)
    retry_max_delay: Duration = Duration(300)
    #: Retryable-FAILURE backoff (helper exchange failed): the
    #: aggregation driver's curve, shared via step_retry_delay.
    step_retry_initial_delay: Duration = Duration(1)
    step_retry_max_delay: Duration = Duration(300)
    http_retry: HttpRetryPolicy = field(default_factory=HttpRetryPolicy)
    #: shard layout for journal-replay share merges — must match the
    #: writers' batch_aggregation_shard_count
    batch_aggregation_shard_count: int = 8
    #: (Peer-health gating thresholds live on the PROCESS-WIDE tracker —
    #: see DriverConfig's note; binaries apply them once at startup.)


class CollectionJobDriver:
    def __init__(
        self,
        datastore: Datastore,
        session_factory,
        config: Optional[CollectionDriverConfig] = None,
        dp_strategy=None,
    ):
        self.datastore = datastore
        self._session_factory = session_factory
        self._session = None
        self.config = config or CollectionDriverConfig()
        # None => per-task dispatch from the VDAF instance's dp_strategy.
        self._dp_override = dp_strategy

    def _get_session(self):
        if self._session is None or self._session.closed:
            self._session = self._session_factory()
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # ------------------------------------------------------------------
    async def step_collection_job(self, lease: Lease) -> None:
        """Stepper entry: runs the step, classifying a mid-step
        ``DatastoreUnavailable`` as brownout pressure — release with
        jittered backoff WITHOUT consuming the attempt budget, exactly
        the peer_unhealthy treatment."""
        try:
            await self._step_collection_job(lease)
        except DatastoreUnavailable as e:
            acq = lease.leased
            logger.warning(
                "datastore unavailable mid-step for collection job %s — "
                "releasing without consuming the attempt budget: %s",
                acq.collection_job_id,
                e,
            )
            try:
                await self._release_retryable(lease, peer_unhealthy=True)
            except DatastoreError:
                logger.warning(
                    "release of collection job %s failed too (datastore "
                    "still browned out); lease expiry redelivers it",
                    acq.collection_job_id,
                )

    async def _step_collection_job(self, lease: Lease) -> None:
        import time as _time

        t_step = _time.monotonic()
        acq = lease.leased
        if lease.lease_attempts > self.config.maximum_attempts_before_failure:
            # Entry-ceiling partition guard (shared classification with
            # the aggregation driver): a delivery count inflated by
            # clean peer-unhealthy releases must not abandon the job
            # while the peer is still unreachable — and within the heal
            # grace the job gets its post-heal delivery instead of an
            # entry abandonment.  Brownout excuse first (in-memory): a
            # datastore brownout inflates the count the same way.
            from ..core.db_health import tracker as db_tracker
            from .job_driver import heal_grace_s, peer_partition_state

            if db_tracker().brownout_signal(
                heal_grace_s(self.config.step_retry_max_delay.seconds)
            ):
                await self._release_retryable(lease, peer_unhealthy=True)
                return
            verdict = await peer_partition_state(
                self.datastore,
                acq.task_id,
                heal_grace_s(self.config.step_retry_max_delay.seconds),
            )
            if verdict == "suspect":
                await self._release_retryable(lease, peer_unhealthy=True)
                return
            if verdict != "healed":
                await self.abandon_collection_job(lease)
                return
            # healed: fall through — this delivery is the job's chance
        else:
            # Early peer gate (mirrors the aggregation driver's
            # _gate_peer): the helper exchange sits at the END of this
            # step, after the journal replay and the aggregate-share
            # recomputation — a suspect peer inside its dwell would
            # waste all of that per delivery.  Cheap: the in-memory
            # partition_signal short-circuits the task lookup in the
            # common no-partition case.
            from .job_driver import peer_partition_state as _pps

            if await _pps(self.datastore, acq.task_id, 0.0) == "suspect":
                await self._release_retryable(lease, peer_unhealthy=True)
                return

        # Guaranteed drain-before-collection: outstanding accumulator-
        # journal rows name FINISHED reports whose out shares are still
        # resident in some replica's device accumulator.  Rows past the
        # replay bound (their owner is presumed dead) are re-derived on the
        # bit-exact CPU oracle from the retained report_aggregations
        # payloads and merged now; younger rows are left to their owner's
        # drain.  The readiness gate below refuses to collect while any
        # row is outstanding, so an aggregate can never be computed
        # without these shares.
        try:
            owner_wait_s = await self._replay_outstanding_journal(acq)
        except DatastoreUnavailable:
            # brownout, not a replay problem: classify at the wrapper
            # (release without consuming the budget)
            raise
        except Exception as e:
            logger.warning("accumulator journal replay failed: %s", e)
            await self._release_retryable(lease)
            return

        def tx1(tx):
            task = tx.get_aggregator_task(acq.task_id)
            job = tx.get_collection_job(
                acq.task_id, acq.collection_job_id, acq.query_type
            )
            if task is None or job is None:
                return None
            if job.state != CollectionJobState.START:
                tx.release_collection_job(lease)
                return None
            vdaf = task.vdaf_instance()
            if not self._ready(tx, task, job):
                # stepped retry delay (reference: :255-262, :723-792)
                attempts = tx.increment_collection_job_step_attempts(
                    acq.task_id, acq.collection_job_id
                )
                delay = min(
                    self.config.retry_initial_delay.seconds * (2 ** (attempts - 1)),
                    self.config.retry_max_delay.seconds,
                )
                if owner_wait_s is not None:
                    # journal rows wait for a live owner's drain: ask
                    # again after one of its drain intervals
                    delay = min(delay, max(1, math.ceil(owner_wait_s)))
                tx.release_collection_job(lease, Duration(delay))
                return None
            # mark batch aggregations Collected + fence (reference: :283-316)
            strategy = strategy_for(task)
            for ident in strategy.batch_identifiers_for_collection_identifier(
                task, job.batch_identifier
            ):
                for ba in tx.get_batch_aggregations_for_batch(
                    acq.task_id, ident, job.aggregation_parameter
                ):
                    if ba.state == BatchAggregationState.AGGREGATING:
                        tx.update_batch_aggregation(
                            BatchAggregation(
                                task_id=ba.task_id,
                                batch_identifier=ba.batch_identifier,
                                aggregation_parameter=ba.aggregation_parameter,
                                ord=ba.ord,
                                state=BatchAggregationState.COLLECTED,
                                aggregate_share=ba.aggregate_share,
                                report_count=ba.report_count,
                                checksum=ba.checksum,
                                client_timestamp_interval=ba.client_timestamp_interval,
                                aggregation_jobs_created=ba.aggregation_jobs_created,
                                aggregation_jobs_terminated=ba.aggregation_jobs_terminated,
                            )
                        )
            share, count, checksum, interval = compute_aggregate_share(
                task, vdaf, tx, job.batch_identifier, job.aggregation_parameter
            )
            return task, job, vdaf, share, count, checksum, interval

        loaded = await self.datastore.run_tx_async("step_collection_job_1", tx1)
        if loaded is None:
            return
        task, job, vdaf, share, count, checksum, interval = loaded

        if share is None or count < task.min_batch_size:
            logger.warning(
                "collection job %s batch too small (%d < %d); abandoning",
                acq.collection_job_id,
                count,
                task.min_batch_size,
            )
            await self.abandon_collection_job(lease)
            return

        # DP noise (reference: :338-344 add_noise_to_agg_share): the
        # strategy comes from the task's VDAF instance description unless
        # the driver was constructed with an explicit override.
        strategy = self._dp_override or dp_strategy_from_dict(
            task.vdaf.get("dp_strategy")
        )
        share = strategy.add_noise_to_agg_share(vdaf, share, count)

        # request the helper's encrypted aggregate share (reference: :347-377)
        if task.query_type.kind == "TimeInterval":
            batch_selector = BatchSelector.new_time_interval(
                Interval.get_decoded(job.batch_identifier)
            )
        else:
            batch_selector = BatchSelector.new_fixed_size(
                BatchId.get_decoded(job.batch_identifier)
            )
        req = AggregateShareReq(
            batch_selector=batch_selector,
            aggregation_parameter=job.aggregation_parameter,
            report_count=count,
            checksum=checksum,
        )
        url = (
            task.peer_aggregator_endpoint.rstrip("/")
            + f"/tasks/{task.task_id}/aggregate_shares"
        )
        # Peer-health gate: a suspect helper inside its dwell
        # means this exchange is doomed — release with backoff without
        # burning the attempt (and without consuming the failure budget).
        from ..core import peer_health
        from ..core.retries import is_transport_error

        tracker = peer_health.tracker()
        if not tracker.allow(url):
            logger.warning(
                "peer %s is suspect; releasing collection job without an "
                "attempt",
                peer_health.origin_of(url),
            )
            await self._release_retryable(lease, peer_unhealthy=True)
            return
        headers = {"Content-Type": AggregateShareReq.MEDIA_TYPE}
        if task.aggregator_auth_token is not None:
            name, value = task.aggregator_auth_token.request_authentication()
            headers[name] = value
        from ..core.trace import inject_traceparent

        inject_traceparent(headers)
        # lease-derived deadline: a blackholed helper must hand the step
        # back in time to RELEASE the lease, never leave it to the reaper
        from .job_driver import helper_request_deadline

        deadline = helper_request_deadline(lease, self.datastore)
        try:
            status, body, _ = await retry_http_request(
                self._get_session(),
                "POST",
                url,
                data=req.get_encoded(),
                headers=headers,
                policy=self.config.http_retry,
                deadline=deadline,
            )
        except Exception as e:
            logger.warning("helper aggregate-share request failed: %s", e)
            await self._release_retryable(
                lease,
                peer_unhealthy=is_transport_error(e) and tracker.is_suspect(url),
            )
            return
        if status >= 400:
            logger.warning("helper aggregate-share returned %d", status)
            await self._release_retryable(lease)
            return
        helper_share = AggregateShare.get_decoded(body)

        # Chaos seam: the canary's wrong-answer fence.  A
        # corrupt-mode spec on this point mangles the encoded leader
        # aggregate share right before it is sealed into the finished
        # job — a fault no transport/lease/health signal can see; only a
        # known-plaintext probe verifying the collected sum catches it.
        from ..core import faults

        leader_share_bytes = faults.corrupt_bytes(
            "collection.aggregate_share",
            vdaf.field_for_agg_param(
                vdaf.decode_agg_param(job.aggregation_parameter)
            ).encode_vec(share),
            target=str(task.task_id),
        )
        finished = job.finished(
            report_count=count,
            client_timestamp_interval=interval,
            leader_aggregate_share=leader_share_bytes,
            helper_aggregate_share=helper_share.encrypted_aggregate_share,
        )

        def tx2(tx):
            tx.update_collection_job(finished)
            # scrub batch aggregations (reference: :380-463)
            strategy = strategy_for(task)
            for ident in strategy.batch_identifiers_for_collection_identifier(
                task, job.batch_identifier
            ):
                for ba in tx.get_batch_aggregations_for_batch(
                    task.task_id, ident, job.aggregation_parameter
                ):
                    if ba.state == BatchAggregationState.COLLECTED:
                        tx.update_batch_aggregation(ba.scrubbed())
            tx.release_collection_job(lease)

        await self.datastore.run_tx_async("step_collection_job_2", tx2)

        # Pipeline-freshness SLO: end-to-end age of the collected batch —
        # collection finish minus its earliest client timestamp, the "how
        # old is a report by the time it lands in an aggregate" histogram.
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None and interval is not None:
            GLOBAL_METRICS.collection_e2e.observe(
                max(0.0, float(self.datastore.now().seconds - interval.start.seconds))
            )

        # Trace LINK point: close the merged timeline's far end.
        # The collection-finish span links the collected reports' upload
        # trace ids (persisted on client_reports; they survive scrubbing),
        # so trace_merge stitches client ingress -> prepare -> collection
        # into ONE critical path even though the collection job's own
        # trace id was minted independently of any upload's.
        collected_batch_id = (
            BatchId.get_decoded(job.batch_identifier)
            if task.query_type.kind != "TimeInterval"
            else None
        )
        await self._emit_collection_finish_span(
            task, interval, collected_batch_id, count, t_step
        )

    # ------------------------------------------------------------------
    async def _emit_collection_finish_span(
        self, task, interval, batch_id, report_count, t_step
    ) -> None:
        """Emit the collection-finish span with upload-trace links;
        failure-tolerant and bounded (at most 512 linked ids) — tracing
        must never fail a finished collection, and with no span consumer
        active (no chrome tracer, no OTLP sink) the link query is skipped
        entirely: the collection hot path pays nothing for tracing that
        is off.  Linked ids come from the reports AGGREGATED into this
        batch (``batch_id`` scopes fixed-size tasks), so overlapping
        collections never chain-merge each other's traces."""
        import time as _time

        from ..core.trace import emit_span, tracing_active

        if (interval is None and batch_id is None) or not tracing_active():
            return
        try:
            trace_ids = await self.datastore.run_tx_async(
                "collect_trace_links",
                lambda tx: tx.get_aggregated_report_trace_ids(
                    task.task_id,
                    interval=interval if batch_id is None else None,
                    batch_id=batch_id,
                    limit=512,
                ),
            )
        except Exception:
            logger.exception("collection trace-link lookup failed")
            trace_ids = []
        emit_span(
            "collection_finish",
            "collection",
            t_step,
            _time.monotonic() - t_step,
            task_id=str(task.task_id),
            reports=report_count,
            links=trace_ids,
        )

    # ------------------------------------------------------------------
    async def _replay_outstanding_journal(self, acq) -> Optional[float]:
        """Consume every accumulator-journal row covering this collection's
        batches that is past the replay bound: oracle-recompute the named
        reports' out shares from their retained report_aggregations
        payloads and merge ONE vector per row into the batch's shard
        accumulators.  A row younger than the bound belongs to its live
        owner's cadence drain and is left alone; returns the shortest drain
        interval of such rows (None when none was left).  Row deletion and
        the merge share a transaction, so a row is merged exactly once even
        when the owning replica's drain races this replay (the loser of
        the DELETE drops its vector)."""
        # cheap pre-check first: in the common (non-deferred) deployment
        # the journal is always empty, and this one indexed COUNT is all
        # the hot path pays — the task/job reload below runs only when
        # there is actually something to replay
        if not await self.datastore.run_tx_async(
            "collect_journal_probe",
            lambda tx: tx.count_accumulator_journal_entries(acq.task_id),
        ):
            return None

        def load(tx):
            task = tx.get_aggregator_task(acq.task_id)
            job = tx.get_collection_job(
                acq.task_id, acq.collection_job_id, acq.query_type
            )
            if task is None or job is None:
                return None
            strategy = strategy_for(task)
            entries = []
            for ident in strategy.batch_identifiers_for_collection_identifier(
                task, job.batch_identifier
            ):
                entries.extend(
                    e
                    for e in tx.get_accumulator_journal_entries(acq.task_id, ident)
                    if e.aggregation_parameter == job.aggregation_parameter
                )
            return task, entries

        loaded = await self.datastore.run_tx_async("collect_journal_scan", load)
        if loaded is None or not loaded[1]:
            return None
        task, entries = loaded
        vdaf = task.vdaf_instance()
        now_s = self.datastore.now().seconds
        owner_wait_s = None
        for entry in entries:
            if now_s - entry.created_at.seconds < self._replay_bound_s(entry):
                # the live owner's drain merges it
                owner_wait_s = min(owner_wait_s or entry.drain_interval_s, entry.drain_interval_s)
                continue
            await self._replay_journal_entry(task, vdaf, entry)
        return owner_wait_s

    def _replay_bound_s(self, entry) -> float:
        """Age past which ``entry``'s owner is presumed dead: the owner's
        drain interval times JOURNAL_REPLAY_AFTER_INTERVALS (0 for a row
        that names no interval)."""
        return (entry.drain_interval_s or 0.0) * JOURNAL_REPLAY_AFTER_INTERVALS

    async def _replay_journal_entry(self, task, vdaf, entry) -> None:
        from ..core import faults
        from ..vdaf.backend import OracleBackend
        from .aggregation_job_writer import merge_share_delta

        await faults.fire_async("accumulator.replay")
        ras = await self.datastore.run_tx_async(
            "replay_load_ras",
            lambda tx: tx.get_report_aggregations_for_aggregation_job(
                task.task_id, entry.aggregation_job_id
            ),
        )
        by_rid = {ra.report_id.data: ra for ra in ras}
        rows = []
        for rid in entry.report_ids:
            ra = by_rid.get(rid)
            if ra is None or ra.leader_input_share is None:
                # the replay window was violated (payload scrubbed or row
                # GC'd under an outstanding journal entry) — shares are
                # unrecoverable; fail LOUDLY, never silently drop
                raise RuntimeError(
                    f"journal entry for job {entry.aggregation_job_id} names "
                    f"report {rid.hex()} without a replayable payload"
                )
            rows.append(ra)
        agg_param = vdaf.decode_agg_param(entry.aggregation_parameter)
        field = vdaf.field_for_agg_param(agg_param)

        def recompute():
            prep_in = [
                (
                    ra.report_id.data,
                    vdaf.decode_public_share(ra.public_share or b""),
                    vdaf.decode_input_share(0, ra.leader_input_share),
                )
                for ra in rows
            ]
            if getattr(vdaf, "REQUIRES_AGG_PARAM", False):
                # Agg-param VDAFs (Poplar1): replay at the journal row's
                # OWN parameter — the row carries it precisely so two tree
                # levels can never cross — re-walking each report's IDPF
                # share and summing the prefix-value vectors the FINISHED
                # verdict already vouched for (the sketch verified before
                # the row was journaled).
                total = None
                for nonce, public, share in prep_in:
                    state, _sh = vdaf.prep_init(task.vdaf_verify_key, 0, agg_param, nonce, public, share)
                    out = list(state.y_flat)
                    total = out if total is None else field.vec_add(total, out)
                return total
            oracle = OracleBackend(vdaf)
            total = None
            for outcome in oracle.prep_init_batch(
                task.vdaf_verify_key, 0, prep_in
            ):
                if not isinstance(outcome, tuple):
                    # a report that already prepared successfully cannot
                    # re-reject on the bit-exact oracle; treat as data loss
                    raise RuntimeError(f"oracle replay rejected a report: {outcome}")
                state, _share = outcome
                total = (
                    list(state.out_share)
                    if total is None
                    else field.vec_add(total, state.out_share)
                )
            return total

        # task cost scope (core/costs.py): the crash-recovery replay's CPU
        # time attributes to the task with path="oracle" via the oracle's
        # _observe_prepare hook
        from ..core import costs

        total = await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: costs.run_in_task_scope(task.task_id.data, recompute),
        )

        def tx_fn(tx):
            # exactly-once hinges on the DELETE: whoever consumes the row
            # merges the shares, in the same transaction
            if not tx.delete_accumulator_journal_entry(
                task.task_id,
                entry.batch_identifier,
                entry.aggregation_parameter,
                entry.aggregation_job_id,
            ):
                return False
            if total is not None:
                merge_share_delta(
                    tx,
                    task,
                    field,
                    entry.batch_identifier,
                    entry.aggregation_parameter,
                    total,
                    shard_count=self.config.batch_aggregation_shard_count,
                )
            return True

        merged = await self.datastore.run_tx_async("journal_replay", tx_fn)
        if merged:
            logger.warning(
                "oracle-replayed %d report(s) of job %s from the datastore "
                "journal (owner never drained — crashed or raced)",
                len(entry.report_ids),
                entry.aggregation_job_id,
            )
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.accumulator_journal_consumed.labels(
                    path="replay"
                ).inc()

    # ------------------------------------------------------------------
    async def _release_retryable(
        self, lease: Lease, peer_unhealthy: bool = False
    ) -> None:
        """Retryable-failure budget + exponential lease-backoff (the
        aggregation driver's curve, shared via step_retry_delay): release
        for redelivery, or abandon once the budget is spent.  Partition
        pressure (``peer_unhealthy`` — the peer-health tracker has the
        helper suspect) never consumes the budget: the job releases with
        jittered backoff for as long as the partition lasts."""
        from ..core.db_health import tracker as db_tracker
        from .job_driver import (
            heal_grace_s,
            partition_excused,
            step_retry_delay,
        )

        if (
            lease.lease_attempts >= self.config.max_step_attempts
            and not peer_unhealthy
            # attempts inflated by a datastore brownout are the
            # database's doing (in-memory check, evaluated first)
            and not db_tracker().brownout_signal(
                heal_grace_s(self.config.step_retry_max_delay.seconds)
            )
            # attempts inflated by a partition must not abandon the
            # post-heal delivery on its first ordinary hiccup
            and not await partition_excused(
                self.datastore,
                lease.leased.task_id,
                self.config.step_retry_max_delay.seconds,
            )
        ):
            logger.error(
                "collection step failure exhausted its %d-attempt budget; "
                "abandoning",
                self.config.max_step_attempts,
            )
            await self.abandon_collection_job(lease)
            return
        delay = step_retry_delay(
            lease.lease_attempts,
            self.config.step_retry_initial_delay.seconds,
            self.config.step_retry_max_delay.seconds,
            # per-job jitter: heal-time reacquisitions spread out instead
            # of thundering-herding the freshly recovered helper
            jitter_key=lease.leased.collection_job_id.data,
        )
        await self.datastore.run_tx_async(
            "release_coll_job", lambda tx: tx.release_collection_job(lease, delay)
        )

    def _ready(self, tx, task: AggregatorTask, job) -> bool:
        """Readiness gate (reference: :124-262): no unaggregated reports in
        scope and all created aggregation jobs terminated."""
        vdaf = task.vdaf_instance()
        if task.query_type.kind == "TimeInterval" and not getattr(vdaf, "REQUIRES_AGG_PARAM", False):
            # agg-param VDAFs never mark reports aggregated (they are reused
            # across levels); their jobs are all created with the collection
            # request, so created==terminated alone gates readiness
            interval = Interval.get_decoded(job.batch_identifier)
            if tx.count_unaggregated_client_reports_for_interval(
                task.task_id, interval
            ):
                return False
        strategy = strategy_for(task)
        for ident in strategy.batch_identifiers_for_collection_identifier(
            task, job.batch_identifier
        ):
            # Deferred-drain fence: an outstanding accumulator-journal row
            # means counted reports whose shares are not yet merged —
            # collecting now would compute a wrong aggregate.  The
            # pre-step replay consumes these; re-checking INSIDE the
            # readiness transaction closes the race with a job committing
            # a new row between the replay and this step.
            if tx.count_accumulator_journal_entries_for_batch(
                task.task_id, ident, job.aggregation_parameter
            ):
                return False
            # counters are sharded: a job's created/terminated increments may
            # land on different shards, so compare per-batch sums
            # (reference: models.rs:1421 counters summed over shards)
            created = terminated = 0
            for ba in tx.get_batch_aggregations_for_batch(
                task.task_id, ident, job.aggregation_parameter
            ):
                created += ba.aggregation_jobs_created
                terminated += ba.aggregation_jobs_terminated
            if created != terminated:
                return False
        return True

    async def abandon_collection_job(self, lease: Lease) -> None:
        """reference: :568-629"""
        acq = lease.leased

        def tx_fn(tx):
            job = tx.get_collection_job(
                acq.task_id, acq.collection_job_id, acq.query_type
            )
            if job is not None and job.state == CollectionJobState.START:
                tx.update_collection_job(job.with_state(CollectionJobState.ABANDONED))
            tx.release_collection_job(lease)

        await self.datastore.run_tx_async("abandon_collection_job", tx_fn)
