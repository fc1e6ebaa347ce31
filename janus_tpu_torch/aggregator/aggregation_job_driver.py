"""Aggregation job stepping (leader) — the north-star hot path.

The analog of ``AggregationJobDriver`` (reference:
aggregator/src/aggregator/aggregation_job_driver.rs:59-1046): steps leased
aggregation jobs through init (leader prepare → PUT init request to helper)
and continue (evaluate stored ping-pong transitions → POST continue
request), merges the helper's responses, and commits everything through the
AggregationJobWriter.  The per-report leader prepare loop the reference
ships to rayon (:449) is ONE batched device launch via the backend seam.

Abandonment: after ``maximum_attempts_before_failure`` lease attempts the
job is abandoned with a best-effort DELETE to the helper (reference
:977-1026); errors are classified retryable vs fatal (:1030-1045).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.retries import HttpRetryPolicy, retry_http_request
from ..datastore import (
    AggregationJob,
    AggregationJobState,
    Datastore,
    Lease,
    ReportAggregation,
    ReportAggregationState,
)
from ..datastore.datastore import DatastoreError, DatastoreUnavailable
from ..datastore.task import AggregatorTask
from ..messages import (
    AggregationJobContinueReq,
    AggregationJobInitializeReq,
    AggregationJobResp,
    AggregationJobStep,
    Duration,
    PartialBatchSelector,
    PrepareContinue,
    PrepareError,
    PrepareInit,
    PrepareResp,
    PrepareStepResult,
    ReportShare,
    ReportMetadata,
)
from ..vdaf import pingpong as pp
from ..vdaf.prio3 import Prio3, VdafError
from .aggregation_job_writer import AggregationJobWriter
from .job_driver import helper_request_deadline

logger = logging.getLogger("janus_tpu_torch.aggregation_job_driver")


class JobStepError(Exception):
    def __init__(self, detail: str, retryable: bool, peer_unhealthy: bool = False):
        super().__init__(detail)
        self.retryable = retryable
        #: the failure is PARTITION PRESSURE (the peer-health tracker has
        #: the peer suspect, or the gate refused the attempt outright):
        #: the job releases with retryable backoff WITHOUT consuming the
        #: max_step_attempts budget — a long partition must never abandon
        #: work that will finish fine after the heal.
        self.peer_unhealthy = peer_unhealthy


class _JournalRowMissing(Exception):
    """A deferred drain lost the race with a crash-recovery replay for one
    of its journal rows; the drained vector must not merge (non-retryable
    by construction: run_tx propagates it out of the drain tx)."""


@dataclass
class DriverConfig:
    batch_aggregation_shard_count: int = 8
    #: Delivery-count ceiling, checked at step ENTRY: bounds redeliveries
    #: that never report back (crashed/timed-out holders whose lease
    #: simply expired).  Reported retryable failures are bounded by
    #: max_step_attempts below; both count lease_attempts, so the
    #: effective bound is whichever fires first.
    maximum_attempts_before_failure: int = 10
    #: Retryable-failure budget, checked when a step REPORTS
    #: JobStepError(retryable=True): the lease is released with
    #: exponential backoff until lease_attempts reaches this, then the
    #: job is abandoned — it must not ping-pong forever.
    max_step_attempts: int = 10
    #: Lease-backoff curve for retryable failures (doubling per attempt).
    retry_initial_delay_s: float = 1.0
    retry_max_delay_s: float = 300.0
    #: (Peer-health gating thresholds live on the PROCESS-WIDE tracker,
    #: not here: binaries apply JobDriverConfig.peer_failure_threshold /
    #: peer_suspect_dwell_s once at startup, and test harnesses call
    #: peer_health.tracker().configure() explicitly — a per-driver copy
    #: would either be dead or clobber tuned values.)
    #: VDAF execution backend: "cuda" (the card, the default), "mesh"
    #: (every card of the process) or "oracle" (only when named); see
    #: aggregator.Config.vdaf_backend.
    vdaf_backend: str = "cuda"
    #: torch device of the "cuda" backend; None = "cuda" (tests name "cpu")
    vdaf_device: Optional[str] = None
    #: Field layout of the card backends ("vpu" | "mxu", None = the process
    #: default); see aggregator.Config.field_backend.
    field_backend: Optional[str] = None
    http_retry: HttpRetryPolicy = field(default_factory=HttpRetryPolicy)
    #: Gather window for coalescing same-shape jobs from DIFFERENT tasks
    #: into one device launch (BASELINE configs[4]); 0 disables.  Only
    #: meaningful for device backends — the oracle ignores it.
    multi_task_launch_window_s: float = 0.005
    #: When set, prepare launches route through this device executor
    #: (executor/service.py; one a process, shared by ALL its drivers):
    #: continuous cross-job batching instead of this driver's private
    #: gather window above.  None = the gather window.
    device_executor: Optional[object] = None  # executor.DeviceExecutor


class AggregationJobDriver:
    def __init__(
        self,
        datastore: Datastore,
        session_factory,
        config: Optional[DriverConfig] = None,
    ):
        self.datastore = datastore
        self._session_factory = session_factory
        self._session = None
        self.config = config or DriverConfig()
        self._backends: Dict[tuple, object] = {}
        # key -> [(verify_key, prep_rows, future)] awaiting a coalesced launch
        self._pending_prep: Dict[int, list] = {}
        # Quarantine ledger sink: bisection offenders found
        # while this driver's flushes sieve persist durably (last
        # configured datastore wins — one per process in production).
        if self.datastore is not None:
            from ..core import quarantine

            quarantine.configure_sink(self.datastore)
        # Process-wide continuous batcher: every driver in the process
        # feeds ONE executor so concurrent tasks form one saturated
        # pipeline rather than N contending ones.
        self._executor = self.config.device_executor
        if self._executor is not None:
            if (
                self._executor.accumulator is not None
                and self.datastore is not None
            ):
                # Durable spill target for graceful shutdown: committed-
                # but-unspilled deferred deltas drain through the journal
                # transaction instead of being discarded.
                self._executor.set_spill_sink(self._spill_sink)

    def _get_session(self):
        """One shared connection-pooled session per driver (the analog of the
        reference's shared reqwest client)."""
        if self._session is None or self._session.closed:
            self._session = self._session_factory()
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # ------------------------------------------------------------------
    async def step_aggregation_job(self, lease: Lease) -> None:
        """Stepper callback for the JobDriver
        (reference: aggregation_job_driver.rs:126 step_aggregation_job)."""
        from ..core.metrics import GLOBAL_METRICS, Timer

        if lease.lease_attempts > self.config.maximum_attempts_before_failure:
            # Entry-ceiling partition guard: clean peer-unhealthy
            # releases still increment lease_attempts (acquisition
            # counts deliveries), so a long partition inflates the count
            # past the ceiling.  While the peer is STILL unhealthy the
            # job releases; within the heal grace it gets its POST-HEAL
            # delivery (abandoning then would destroy exactly the work
            # the partition tolerance exists to preserve); only a peer
            # that has been healthy past the grace gets the ceiling's
            # normal abandon verdict.  (Stopping the inflation at its
            # source — peer-aware acquisition filtering — is the ROADMAP
            # follow-on.)
            from ..core.db_health import tracker as db_tracker
            from .job_driver import heal_grace_s, peer_partition_state

            # Brownout excuse first (in-memory, no datastore lookup): a
            # datastore brownout inflates lease_attempts exactly like a
            # peer partition does — releases without consumed budget —
            # so the ceiling's abandon verdict must wait out the heal
            # grace here too.
            if db_tracker().brownout_signal(
                heal_grace_s(self.config.retry_max_delay_s)
            ):
                await self._release_ceiling_partition(lease)
                return
            verdict = await peer_partition_state(
                self.datastore,
                lease.leased.task_id,
                heal_grace_s(self.config.retry_max_delay_s),
            )
            if verdict == "suspect":
                await self._release_ceiling_partition(lease)
                return
            if verdict != "healed":
                await self.abandon_aggregation_job(lease)
                return
            # healed: fall through — this delivery is the job's chance
        outcome = "success"
        with Timer() as timer:
            try:
                await self._step(lease)
            except JobStepError as e:
                # Partition pressure (peer suspect) releases WITHOUT
                # consuming the retryable budget: the failure is the
                # network's, not the job's, and a long partition must
                # not march every in-flight job to abandonment.  The
                # delivery ceiling (maximum_attempts_before_failure,
                # checked at entry) still bounds holders that never
                # report back.
                from ..core.db_health import tracker as db_tracker
                from .job_driver import heal_grace_s, partition_excused

                if e.retryable and (
                    lease.lease_attempts < self.config.max_step_attempts
                    or e.peer_unhealthy
                    # attempts inflated by a datastore brownout (still
                    # suspect, or healed within the grace) are the
                    # database's doing — in-memory check, evaluated
                    # before the datastore-lookup excuse below
                    or db_tracker().brownout_signal(
                        heal_grace_s(self.config.retry_max_delay_s)
                    )
                    # attempts inflated by a partition (peer still
                    # unhealthy, or healed within the grace) must not
                    # abandon the post-heal delivery on its first
                    # ordinary hiccup — evaluated lazily, only when the
                    # budget comparison would otherwise abandon
                    or await partition_excused(
                        self.datastore,
                        lease.leased.task_id,
                        self.config.retry_max_delay_s,
                    )
                ):
                    from .job_driver import step_retry_delay

                    outcome = "retried"
                    delay = step_retry_delay(
                        lease.lease_attempts,
                        self.config.retry_initial_delay_s,
                        self.config.retry_max_delay_s,
                        # seeded per-job jitter: jobs released during a
                        # partition re-acquire SPREAD OUT after the heal
                        # instead of thundering-herding the helper
                        jitter_key=lease.leased.aggregation_job_id.data,
                    )
                    logger.warning(
                        "retryable step failure (attempt %d/%d, redeliver in %ds): %s",
                        lease.lease_attempts,
                        self.config.max_step_attempts,
                        delay.seconds,
                        e,
                    )
                    await self.datastore.run_tx_async(
                        "release_agg_job",
                        lambda tx: tx.release_aggregation_job(lease, delay),
                    )
                else:
                    outcome = "abandoned"
                    if e.retryable:
                        logger.error(
                            "retryable step failure exhausted its %d-attempt "
                            "budget; abandoning: %s",
                            self.config.max_step_attempts,
                            e,
                        )
                    else:
                        logger.error("fatal step failure: %s", e)
                    await self.abandon_aggregation_job(lease)
            except DatastoreUnavailable as e:
                # Datastore brownout mid-step: treated exactly like
                # peer_unhealthy — release with jittered backoff, budget
                # untouched.
                outcome = "retried"
                await self._release_datastore_brownout(lease, e)
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.job_steps.labels(
                job_type="aggregation", outcome=outcome
            ).observe(timer.seconds)
            if outcome != "success":
                GLOBAL_METRICS.step_failures.labels(type=outcome).inc()

    async def _step(self, lease: Lease) -> None:
        acq = lease.leased
        # tx1: load task, job, report aggregations (reference :169-220)
        def load(tx):
            task = tx.get_aggregator_task(acq.task_id)
            job = tx.get_aggregation_job(acq.task_id, acq.aggregation_job_id)
            ras = tx.get_report_aggregations_for_aggregation_job(
                acq.task_id, acq.aggregation_job_id
            )
            return task, job, ras

        task, job, ras = await self.datastore.run_tx_async("step_agg_job_1", load)
        if task is None or job is None:
            raise JobStepError("job or task vanished", retryable=False)
        if job.state != AggregationJobState.IN_PROGRESS:
            await self.datastore.run_tx_async(
                "release_done", lambda tx: tx.release_aggregation_job(lease)
            )
            return
        # Peer-health gate: a suspect helper inside its dwell
        # means this step WILL end at a dead socket — release now, before
        # any prepare work (device launch, decode) is burned on it.  Past
        # the dwell the gate opens (half-open) and this step is the probe.
        self._gate_peer(task)
        vdaf = task.vdaf_instance()

        start_ras = [ra for ra in ras if ra.state == ReportAggregationState.START_LEADER]
        waiting_ras = [
            ra for ra in ras if ra.state == ReportAggregationState.WAITING_LEADER
        ]
        if start_ras:
            await self._step_init(lease, task, vdaf, job, ras, start_ras)
        elif waiting_ras:
            await self._step_continue(lease, task, vdaf, job, ras, waiting_ras)
        else:
            # nothing to do; close the job out
            job = job.with_state(AggregationJobState.FINISHED)
            writer = AggregationJobWriter(
                task,
                vdaf,
                batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
                initial_write=False,
            )
            writer.put(job, [], {})

            def tx_fn(tx):
                writer.write(tx)
                tx.release_aggregation_job(lease)

            await self.datastore.run_tx_async("step_agg_job_2", tx_fn)

    # ------------------------------------------------------------------
    async def _release_ceiling_partition(self, lease) -> None:
        """Release a past-ceiling lease with jittered backoff: the
        inflated delivery count is partition/brownout pressure, not a
        sick job."""
        from .job_driver import step_retry_delay

        acq = lease.leased
        delay = step_retry_delay(
            lease.lease_attempts,
            self.config.retry_initial_delay_s,
            self.config.retry_max_delay_s,
            jitter_key=acq.aggregation_job_id.data,
        )
        logger.warning(
            "job %s is past its delivery ceiling (%d attempts) but the "
            "peer or datastore is suspect — releasing for %ds instead of "
            "abandoning pressured work",
            acq.aggregation_job_id,
            lease.lease_attempts,
            delay.seconds,
        )
        await self.datastore.run_tx_async(
            "release_agg_job",
            lambda tx: tx.release_aggregation_job(lease, delay),
        )

    async def _release_datastore_brownout(self, lease, err) -> None:
        """A step that died on ``DatastoreUnavailable`` releases WITHOUT
        consuming the retryable budget — the failure is the database's,
        not the job's (the exact peer_unhealthy treatment).
        The release transaction itself runs under a short deadline and
        tolerates failure: mid-brownout it may not commit either, and
        lease expiry + the reaper redeliver the job regardless."""
        from .job_driver import step_retry_delay

        acq = lease.leased
        delay = step_retry_delay(
            lease.lease_attempts,
            self.config.retry_initial_delay_s,
            self.config.retry_max_delay_s,
            jitter_key=acq.aggregation_job_id.data,
        )
        logger.warning(
            "datastore unavailable mid-step for job %s — releasing for "
            "%ds without consuming the attempt budget: %s",
            acq.aggregation_job_id,
            delay.seconds,
            err,
        )
        try:
            await self.datastore.run_tx_async(
                "release_agg_job",
                lambda tx: tx.release_aggregation_job(lease, delay),
                deadline_s=5.0,
            )
        except DatastoreError:
            logger.warning(
                "release of job %s failed too (datastore still browned "
                "out); lease expiry redelivers it",
                acq.aggregation_job_id,
            )

    def _gate_peer(self, task: AggregatorTask) -> None:
        """Refuse to burn lease work on a suspect peer (raises a
        peer-unhealthy retryable JobStepError); no-op while healthy or
        once the suspect dwell has elapsed (the half-open probe)."""
        from ..core import peer_health

        url = task.peer_aggregator_endpoint
        if not peer_health.tracker().allow(url):
            raise JobStepError(
                f"peer {peer_health.origin_of(url)} is suspect (consecutive "
                "transport failures); releasing without an attempt",
                retryable=True,
                peer_unhealthy=True,
            )

    # ------------------------------------------------------------------
    @staticmethod
    def _vdaf_shape_key(vdaf) -> tuple:
        """Backend/bucket key (vdaf_shape_key in vdaf/backend.py — shared
        with the helper aggregator so both protocol sides land in the same
        executor buckets and breaker domains)."""
        from ..vdaf.backend import vdaf_shape_key

        return vdaf_shape_key(vdaf)

    def _backend_for(self, task: AggregatorTask, vdaf):
        """The task's backend, one per VDAF shape (in the process-wide
        executor's cache when there is one: a canonicalizable task gets its
        bucket's twin there, ``DeviceExecutor.prep_backend_for``).  A VDAF
        the card does not serve takes the CPU oracle, logged and counted
        (aggregator.resolve_backend); for a served circuit a failure to
        build the card's backend propagates.  A Poplar1 gets its
        ``Poplar1Backend`` (None when the oracle is configured: it then
        steps per report); other non-Prio3 VDAFs step per report (None)."""
        poplar = type(vdaf).__name__ == "Poplar1" and self.config.vdaf_backend != "oracle"
        if not isinstance(vdaf, Prio3) and not poplar:
            return None
        memo = self._vdaf_shape_key(vdaf)
        b = self._backends.get(memo)
        if b is None:
            from .aggregator import resolve_backend

            def factory():
                return resolve_backend(
                    vdaf, self.config.vdaf_backend, self.config.vdaf_device, task.task_id,
                    self.config.field_backend,
                )

            if self._executor is not None:
                # Shape-keyed cache lives in the process-wide executor:
                # every driver (and its warmup) shares one backend per
                # VDAF shape or canonical bucket.
                _key, b = self._executor.prep_backend_for(
                    vdaf, self.config.vdaf_backend, self.config.vdaf_device, factory,
                    field_backend=self.config.field_backend,
                )
            else:
                b = factory()
            self._backends[memo] = b
        return b

    async def _coalesced_prep_init(
        self, backend, verify_key: bytes, prep_in, task_ident=None, vdaf=None
    ):
        """Join concurrent same-shape jobs (across tasks) into ONE launch.

        With a device executor, submission routes through the
        PROCESS-WIDE continuous batcher instead: all drivers' same-shape
        jobs coalesce into pow2-padded mega-batches with size/deadline
        flushing, and backpressure rejections surface as retryable
        JobStepErrors (the lease machinery redelivers the job).

        Otherwise the first arrival opens a short gather window; jobs
        landing inside it ride the same ``prep_init_multi`` launch with
        per-row verify keys (BASELINE configs[4]'s 16-task shape).  Window
        0 or a backend without prep_init_multi degrades to a per-job
        launch.

        ``vdaf`` is the task's own VDAF: a canonical backend's request
        carries it as its third element.
        """
        loop = asyncio.get_running_loop()
        if self._executor is not None and hasattr(backend, "stage_prep_init_multi"):
            from ..executor import CircuitOpenError, ExecutorOverloadedError
            from ..vdaf.backend import prep_request
            from ..vdaf.canonical import backend_shape_key

            # the executor cache / warmup-ledger / breaker key, derived
            # from the RESOLVED backend so key and backend never diverge —
            # after a failed twin build the cached backend is exact-shape
            # and must keep submitting under the exact key
            shape_key = backend_shape_key(backend)
            # A served circuit never lands on the CPU oracle: an open
            # circuit (known BEFORE submitting, from the breaker peek)
            # refuses the job as retryable, and the lease machinery
            # redelivers it until the half-open probe closes the circuit.
            if self._executor.circuit_open(shape_key):
                raise JobStepError(
                    f"circuit for shape {shape_key[0]}/{shape_key[1]} is open",
                    retryable=True,
                )
            if self._executor.warming(shape_key):
                # The kernels are still building on the warmup thread:
                # wait on the compile future, off the event loop.  The
                # breaker never counts the compile-wait as a launch
                # failure and no flush deadline can trip on it.
                await loop.run_in_executor(
                    None, lambda: self._executor.wait_warm(shape_key)
                )
            try:
                return await self._executor.submit(
                    shape_key,
                    "prep_init",
                    prep_request(backend, verify_key, prep_in, vdaf),
                    backend=backend,
                    agg_id=0,
                    retain_out_shares=self._executor.accumulator is not None,
                    task_ident=task_ident,
                )
            except CircuitOpenError as e:
                raise JobStepError(f"device circuit open: {e}", retryable=True)
            except ExecutorOverloadedError as e:
                raise JobStepError(
                    f"device executor overloaded: {e}", retryable=True
                )
            except JobStepError:
                raise
            except Exception as e:
                # Launch failure: the breaker counted it; the lease
                # machinery redelivers (with backoff), and an open circuit
                # keeps refusing the shape above until it closes.
                raise JobStepError(f"device launch failed: {e}", retryable=True)
        window = self.config.multi_task_launch_window_s
        try:
            if window <= 0 or not hasattr(backend, "prep_init_multi"):
                return await loop.run_in_executor(
                    None, lambda: backend.prep_init_batch(verify_key, 0, prep_in)
                )
            key = id(backend)
            fut = loop.create_future()
            bucket = self._pending_prep.setdefault(key, [])
            bucket.append((verify_key, prep_in, fut))
            if len(bucket) == 1:
                loop.call_later(
                    window,
                    lambda: asyncio.ensure_future(self._flush_prep(backend, key)),
                )
            return await fut
        except Exception as e:
            # Per-row VDAF rejections come back as in-band PrepOutcomes; an
            # exception here is infrastructure (device launch, thread pool)
            # and the lease machinery owns the retry.
            raise JobStepError(f"prepare launch failed: {e}", retryable=True)

    async def _coalesced_poplar_init(self, backend, verify_key: bytes, agg_param, prep_in, task_ident=None):
        """Poplar1 round-0 prepare, through the process-wide executor when
        there is one: the submission lands in the agg-param-keyed
        ``poplar_init`` bucket for this shape at ``agg_param.level``, so
        concurrent jobs at one tree level coalesce into ONE walk and sketch
        pass.  As for Prio3, an open circuit (peeked before submitting, or
        raised by the flush), a launch failure and backpressure all refuse
        the job as a retryable JobStepError; no served row lands on the
        oracle."""
        loop = asyncio.get_running_loop()
        if self._executor is not None:
            from ..executor import KIND_POPLAR_INIT, CircuitOpenError, ExecutorOverloadedError

            shape_key = self._vdaf_shape_key(backend.vdaf)
            if self._executor.circuit_open(shape_key):
                raise JobStepError(f"circuit for shape {shape_key[0]} is open", retryable=True)
            # Sketch vectors kept on the card: only with DEFERRED drains —
            # the refs cross the WAITING_LEADER persistence hop, and only
            # deferred mode keeps the StartLeader payloads that make a dead
            # ref (restart, eviction past recall) recoverable through the
            # per-report oracle replay.
            store = self._executor.accumulator
            retain_sketch = store is not None and getattr(store.config, "deferred", False)
            try:
                return await self._executor.submit(
                    shape_key,
                    KIND_POPLAR_INIT,
                    (verify_key, agg_param, prep_in),
                    backend=backend,
                    agg_id=0,
                    retain_out_shares=retain_sketch,
                    task_ident=task_ident,
                    agg_param_key=getattr(agg_param, "level", None),
                )
            except CircuitOpenError as e:
                raise JobStepError(f"device circuit open: {e}", retryable=True)
            except ExecutorOverloadedError as e:
                raise JobStepError(f"device executor overloaded: {e}", retryable=True)
            except JobStepError:
                raise
            except Exception as e:
                raise JobStepError(f"device launch failed: {e}", retryable=True)
        try:
            return await loop.run_in_executor(
                None, lambda: backend.prep_init_batch_poplar(verify_key, 0, agg_param, prep_in)
            )
        except Exception as e:
            raise JobStepError(f"prepare launch failed: {e}", retryable=True)

    async def _flush_prep(self, backend, key: int) -> None:
        bucket = self._pending_prep.pop(key, [])
        if not bucket:
            return
        reqs = [(vk, rows) for vk, rows, _ in bucket]
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(
                None, lambda: backend.prep_init_multi(0, reqs)
            )
            if len(results) != len(bucket):
                raise RuntimeError(
                    f"prep_init_multi returned {len(results)} results for "
                    f"{len(bucket)} requests"
                )
            for (_, _, fut), res in zip(bucket, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # surface the launch failure to every job
            for _, _, fut in bucket:
                if not fut.done():
                    fut.set_exception(e)

    async def _leader_prep_init(self, task, vdaf, job, start_ras):
        """Batched leader prepare (device launch for Prio3;
        reference mirror: aggregation_job_driver.rs:397-428 on rayon)."""
        try:
            agg_param = vdaf.decode_agg_param(job.aggregation_parameter)
        except VdafError:
            return {
                ra.report_id.data: PrepareError.INVALID_MESSAGE for ra in start_ras
            }
        outcomes: Dict[bytes, object] = {}  # report_id -> (state, msg) | PrepareError
        loop = asyncio.get_running_loop()

        def decode_rows():
            """Per-report wire decoding is pure-Python field parsing —
            thousands of elements per report — so it stays off the event
            loop (the loop must keep serving lease heartbeats and the
            coalescing gather timers)."""
            good, bad = [], []
            for ra in start_ras:
                try:
                    public_parts = vdaf.decode_public_share(ra.public_share or b"")
                    input_share = vdaf.decode_input_share(0, ra.leader_input_share)
                except (VdafError, Exception):
                    bad.append(ra.report_id.data)
                    continue
                good.append((ra, public_parts, input_share))
            return good, bad

        rows, bad_ids = await loop.run_in_executor(None, decode_rows)
        for rid in bad_ids:
            outcomes[rid] = PrepareError.INVALID_MESSAGE

        backend = self._backend_for(task, vdaf)
        if backend is not None:
            prep_in = [
                (ra.report_id.data, public, share) for ra, public, share in rows
            ]
            if hasattr(backend, "prep_init_batch_poplar"):
                # Heavy hitters: round-0 prep through the executor's
                # agg-param-keyed poplar_init plane (or the direct batched
                # walk when no executor is configured).
                prep_out = await self._coalesced_poplar_init(
                    backend, task.vdaf_verify_key, agg_param, prep_in, task_ident=task.task_id.data
                )
            else:
                prep_out = await self._coalesced_prep_init(
                    backend,
                    task.vdaf_verify_key,
                    prep_in,
                    # per-task fairness quota: the DRR accounting domain
                    # WITHIN the shared shape bucket
                    # (executor._pick_entry_locked)
                    task_ident=task.task_id.data,
                    vdaf=vdaf,
                )

            def wrap_outcomes():
                out = {}
                for (ra, _pub, _sh), outcome in zip(rows, prep_out):
                    if isinstance(outcome, VdafError):
                        out[ra.report_id.data] = PrepareError.VDAF_PREP_ERROR
                        continue
                    state, share = outcome
                    msg = pp.PingPongMessage(
                        pp.PingPongMessage.INITIALIZE,
                        prep_share=vdaf.ping_pong_encode_prep_share(share),
                    )
                    out[ra.report_id.data] = (pp.PingPongContinued(state, 0), msg)
                return out

            outcomes.update(await loop.run_in_executor(None, wrap_outcomes))
        else:

            def oracle_prep():
                out = {}
                for ra, public, share in rows:
                    try:
                        state, msg = pp.leader_initialized(
                            vdaf,
                            task.vdaf_verify_key,
                            agg_param,
                            ra.report_id.data,
                            public,
                            share,
                        )
                        out[ra.report_id.data] = (state, msg)
                    except (VdafError, pp.PingPongError):
                        out[ra.report_id.data] = PrepareError.VDAF_PREP_ERROR
                return out

            outcomes.update(
                await asyncio.get_running_loop().run_in_executor(None, oracle_prep)
            )
        return outcomes

    async def _step_init(self, lease, task, vdaf, job, all_ras, start_ras):
        outcomes = await self._leader_prep_init(task, vdaf, job, start_ras)
        try:
            await self._step_init_with_outcomes(
                lease, task, vdaf, job, all_ras, start_ras, outcomes
            )
        except BaseException:
            # A failure between prep and commit (helper HTTP, tx, anything)
            # must not pin the flush matrices the step's ResidentRefs hold:
            # redelivery will mint fresh refs.  Release is idempotent, so
            # refs already consumed by a partial commit are unaffected.
            self._release_resident_outcomes(outcomes)
            raise

    def _release_finished_refs(self, finished_now) -> None:
        """Release device-resident out shares held by finished-at-evaluate
        rows (Poplar1 continue steps) after a step failure or a helper
        rejection dropped them short of the commit."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None or not finished_now:
            return
        from ..executor.accumulator import ResidentRef

        refs = [v for v in finished_now.values() if isinstance(v, ResidentRef)]
        if refs:
            store.release_refs(refs)

    def _release_resident_outcomes(self, outcomes) -> None:
        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return
        from ..executor.accumulator import ResidentRef

        refs = []
        for outcome in outcomes.values():
            if isinstance(outcome, PrepareError):
                continue
            state, _msg = outcome
            ref = getattr(getattr(state, "prep_state", None), "out_share", None)
            if not isinstance(ref, ResidentRef):  # Poplar1 carries y_flat
                ref = getattr(getattr(state, "prep_state", None), "y_flat", None)
            if isinstance(ref, ResidentRef):
                refs.append(ref)
        if refs:
            store.release_refs(refs)

    async def _step_init_with_outcomes(
        self, lease, task, vdaf, job, all_ras, start_ras, outcomes
    ):
        prepare_inits = []
        states: Dict[bytes, pp.PingPongContinued] = {}
        failed: Dict[bytes, PrepareError] = {}
        for ra in start_ras:
            outcome = outcomes[ra.report_id.data]
            if isinstance(outcome, PrepareError):
                failed[ra.report_id.data] = outcome
                continue
            state, msg = outcome
            states[ra.report_id.data] = state
            prepare_inits.append(
                PrepareInit(
                    ReportShare(
                        ReportMetadata(ra.report_id, ra.time),
                        ra.public_share or b"",
                        ra.helper_encrypted_input_share,
                    ),
                    msg,
                )
            )

        if task.query_type.kind == "FixedSize":
            pbs = PartialBatchSelector.new_fixed_size(job.partial_batch_identifier)
        else:
            pbs = PartialBatchSelector.new_time_interval()
        req = AggregationJobInitializeReq(
            aggregation_parameter=job.aggregation_parameter,
            partial_batch_selector=pbs,
            prepare_inits=prepare_inits,
        )
        resp = await self._send_to_helper(
            task,
            "PUT",
            f"aggregation_jobs/{job.aggregation_job_id}",
            req.get_encoded(),
            AggregationJobInitializeReq.MEDIA_TYPE,
            lease=lease,
        )
        await self._process_helper_resp(
            lease, task, vdaf, job, all_ras, states, failed, resp
        )

    async def _step_continue(self, lease, task, vdaf, job, all_ras, waiting_ras):
        """Evaluate stored transitions, send continue, process responses
        (reference: :527-626)."""
        states: Dict[bytes, pp.PingPongContinued] = {}
        failed: Dict[bytes, PrepareError] = {}
        finished_now: Dict[bytes, Sequence[int]] = {}
        conts = []
        for ra in waiting_ras:
            try:
                trans = pp.PingPongTransition.decode(vdaf, ra.leader_prep_transition)
                state, msg = trans.evaluate(vdaf)
            except (VdafError, pp.PingPongError):
                failed[ra.report_id.data] = PrepareError.VDAF_PREP_ERROR
                continue
            conts.append(PrepareContinue(ra.report_id, msg))
            if isinstance(state, pp.PingPongFinished):
                finished_now[ra.report_id.data] = state.out_share
            else:
                states[ra.report_id.data] = state

        # The wire step is the leader's CURRENT step: after init the leader
        # job is at step 1 while the helper is at 0, and the helper requires
        # req.step == helper_step + 1 — i.e. exactly the leader's step.
        wire_step = AggregationJobStep(int(job.step))
        req = AggregationJobContinueReq(wire_step, conts)
        try:
            resp = await self._send_to_helper(
                task,
                "POST",
                f"aggregation_jobs/{job.aggregation_job_id}",
                req.get_encoded(),
                AggregationJobContinueReq.MEDIA_TYPE,
                lease=lease,
            )
            await self._process_helper_resp(
                lease,
                task,
                vdaf,
                job,
                all_ras,
                states,
                failed,
                resp,
                finished_now=finished_now,
                next_step=AggregationJobStep(int(wire_step) + 1),
            )
        except BaseException:
            # A failure between evaluate and commit must not pin the flush
            # matrices this step's device-resident rows (Poplar1 y refs
            # riding in finished_now) reference: redelivery re-evaluates
            # the persisted transition, and a then-dead ref fails closed
            # into the per-report oracle replay.  Release is idempotent —
            # rows a partial commit already consumed are unaffected.
            self._release_finished_refs(finished_now)
            raise

    # ------------------------------------------------------------------
    async def _process_helper_resp(
        self,
        lease,
        task,
        vdaf,
        job,
        all_ras,
        states: Dict[bytes, pp.PingPongContinued],
        failed: Dict[bytes, PrepareError],
        resp: AggregationJobResp,
        *,
        finished_now: Optional[Dict[bytes, Sequence[int]]] = None,
        next_step: Optional[AggregationJobStep] = None,
    ) -> None:
        """Merge helper PrepareResps into report aggregations
        (reference: :629-793 process_response_from_helper)."""
        finished_now = finished_now or {}
        by_id = {pr.report_id.data: pr for pr in resp.prepare_resps}
        new_ras: List[ReportAggregation] = []
        out_shares: Dict[bytes, Sequence[int]] = {}
        # Multi-round deferred journaling (Poplar1): a report that will only
        # FINISH at a later round must carry its StartLeader payload through
        # every WAITING round — the payload is the journal's oracle-replay
        # window, and with_state() clears it by default.  Costs storage only
        # while the journal machinery is armed for this VDAF.
        store_cfg = getattr(
            self._executor.accumulator if self._executor is not None else None,
            "config",
            None,
        )
        retain_waiting_payload = (
            store_cfg is not None
            and getattr(store_cfg, "deferred", False)
            and getattr(vdaf, "REQUIRES_AGG_PARAM", False)
        )
        for ra in all_ras:
            rid = ra.report_id.data
            if ra.state in (
                ReportAggregationState.FINISHED,
                ReportAggregationState.FAILED,
            ):
                continue  # already terminal; no update needed
            if rid in failed:
                new_ras.append(ra.failed(failed[rid]))
                continue
            pr = by_id.get(rid)
            if pr is None:
                new_ras.append(ra.failed(PrepareError.REPORT_DROPPED))
                continue
            if pr.result.variant == PrepareStepResult.REJECT:
                new_ras.append(ra.failed(pr.result.error))
                continue
            if rid in finished_now:
                if pr.result.variant != PrepareStepResult.FINISHED:
                    new_ras.append(ra.failed(PrepareError.VDAF_PREP_ERROR))
                    continue
                new_ras.append(ra.with_state(ReportAggregationState.FINISHED))
                out_shares[rid] = finished_now[rid]
                continue
            if pr.result.variant != PrepareStepResult.CONTINUE:
                new_ras.append(ra.failed(PrepareError.VDAF_PREP_ERROR))
                continue
            state = states.get(rid)
            if state is None:
                new_ras.append(ra.failed(PrepareError.VDAF_PREP_ERROR))
                continue
            try:
                value = pp.continued(
                    vdaf, True, state, pr.result.message,
                    vdaf.decode_agg_param(job.aggregation_parameter),
                )
            except (VdafError, pp.PingPongError):
                new_ras.append(ra.failed(PrepareError.VDAF_PREP_ERROR))
                continue
            if value.out_share is not None:
                new_ras.append(ra.with_state(ReportAggregationState.FINISHED))
                out_shares[rid] = value.out_share
            else:
                keep = (
                    dict(public_share=ra.public_share, leader_input_share=ra.leader_input_share)
                    if retain_waiting_payload
                    else {}
                )
                new_ras.append(
                    ra.with_state(
                        ReportAggregationState.WAITING_LEADER,
                        leader_prep_transition=value.transition.encode(vdaf),
                        **keep,
                    )
                )

        any_waiting = any(
            ra.state == ReportAggregationState.WAITING_LEADER for ra in new_ras
        )
        job = job.with_step(
            next_step if next_step is not None else AggregationJobStep(int(job.step) + 1)
        )
        job = job.with_state(
            AggregationJobState.IN_PROGRESS
            if any_waiting
            else AggregationJobState.FINISHED
        )

        # Device-resident out shares: drain-at-commit mode psums the
        # finished rows' ResidentRefs and spills the delta BEFORE the
        # transaction (a tx retry must never replay a device psum; one
        # O(OUT) readback per batch bucket); deferred mode persists a
        # journal row in the tx and psums after it commits, outside any
        # tx retry (crash recovery replays from the datastore).
        # finished-at-evaluate rows the helper rejected never reached
        # out_shares: their device-resident refs (Poplar1) must release or
        # the retained sketch matrix never frees
        self._release_finished_refs(
            {
                rid: v
                for rid, v in finished_now.items()
                if rid not in out_shares
            }
        )
        (
            accumulator_deltas,
            journal_entries,
            pending,
        ) = await self._commit_resident_shares(
            task, vdaf, job, all_ras, states, out_shares,
            # WAITING rows (multi-round VDAFs) keep their refs alive: the
            # next step's transition evaluation finishes them
            waiting_rids={
                ra.report_id.data
                for ra in new_ras
                if ra.state == ReportAggregationState.WAITING_LEADER
            },
        )

        if journal_entries:
            # Deferred drains retain the StartLeader payloads on the
            # FINISHED rows: they are the journal's oracle-replay window —
            # a survivor re-derives the out shares from these columns
            # after this process dies with the delta still on device.
            ra_by_rid = {ra.report_id.data: ra for ra in all_ras}
            journaled_rids = set().union(*journal_entries.values())
            new_ras = [
                self._finished_with_payload(ra_by_rid[ra.report_id.data], ra)
                if ra.report_id.data in journaled_rids
                and ra.state == ReportAggregationState.FINISHED
                else ra
                for ra in new_ras
            ]

        writer = AggregationJobWriter(
            task,
            vdaf,
            batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
            initial_write=False,
            backend=self._backend_for(task, vdaf),
            accumulator_deltas=accumulator_deltas,
            journal_entries=journal_entries,
            journal_drain_interval_s=self._executor.accumulator.config.drain_interval_s
            if journal_entries
            else None,
        )
        writer.put(job, new_ras, out_shares)

        def tx_fn(tx):
            writer.write(tx)
            tx.release_aggregation_job(lease)

        from ..executor.accumulator import StaleAccumulatorDelta

        try:
            await self.datastore.run_tx_async("step_agg_job_2", tx_fn)
        except StaleAccumulatorDelta as e:
            # A report was failed in-tx (batch collected under our feet)
            # AFTER its row was drained/journaled.  The tx aborted with
            # nothing merged; redelivery re-prepares the job and the in-tx
            # check fails the report properly — exactly-once either way.
            self._release_pending(pending)
            raise JobStepError(
                f"resident delta invalidated in-tx: {e}", retryable=True
            )
        except BaseException:
            # Deferred mode: this job's journal rows never committed, so
            # its rows must not reach a bucket (redelivery re-prepares them)
            self._release_pending(pending)
            raise
        if pending:
            await self._commit_journaled(task, vdaf, job, pending)
        if journal_entries:
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.accumulator_journal_entries.inc(len(journal_entries))
            await self._maybe_drain_due()

    @staticmethod
    def _finished_with_payload(orig, finished_ra):
        """FINISHED, but keeping exactly the columns the oracle replay
        reads (public share + leader input share — the deferred journal's
        replay window); the helper's ciphertext has no replay reader and
        is dropped like any other FINISHED row's.  GC reclaims the rest
        with the job, once its journal row is consumed."""
        return orig.with_state(
            ReportAggregationState.FINISHED,
            public_share=orig.public_share,
            leader_input_share=orig.leader_input_share,
        ).with_last_prep_resp(finished_ra.last_prep_resp)

    @staticmethod
    def _batch_ident_for(task, job):
        """ra -> batch identifier, shared by the device- and host-vector
        accumulator commit paths (they must bucket identically)."""
        from ..datastore.query_type import strategy_for

        strategy = strategy_for(task)

        def ident_for(ra):
            if job.partial_batch_identifier is not None:
                return job.partial_batch_identifier.get_encoded()
            return strategy.to_batch_identifier(task, ra.time)

        return ident_for

    async def _collected_idents(self, task, job, idents) -> set:
        """Pre-tx collected check shared by both accumulator commit paths:
        batches already past AGGREGATING must not be accumulated/journaled
        now — the writer tx would fail their reports and every redelivery
        would re-trip the StaleAccumulatorDelta fence."""
        if self.datastore is None or not idents:
            return set()
        from ..datastore import BatchAggregationState

        def check(tx):
            out = set()
            for ident in idents:
                bas = tx.get_batch_aggregations_for_batch(
                    task.task_id, ident, job.aggregation_parameter
                )
                if any(
                    ba.state != BatchAggregationState.AGGREGATING for ba in bas
                ):
                    out.add(ident)
            return out

        return await self.datastore.run_tx_async("accum_collected_check", check)

    async def _commit_resident_shares(
        self, task, vdaf, job, all_ras, states, out_shares, waiting_rids=frozenset()
    ) -> Tuple[
        Optional[Dict[bytes, Tuple[Sequence[int], frozenset]]],
        Optional[Dict[bytes, frozenset]],
        List[tuple],
    ]:
        """Accumulator-store commit path (no-op when the store is off or no
        finished report carries a ResidentRef).

        Drain-at-commit mode (default): per batch bucket, psum the
        finished rows into the resident accumulator (one device launch, no
        readback) and drain it to ONE host field vector for the writer's
        sharded merge.  Deferred mode (drain_interval_s > 0): nothing is
        summed yet; the step hands back journal entries the writer
        persists in its tx and the pending commits that
        :meth:`_commit_journaled` sums into the buckets once that tx has
        committed — so a bucket only ever holds rows whose journal rows
        are written, and the cadence drain (or, after a crash, the
        collection-time oracle replay) consumes each row exactly once.
        On AccumulatorUnavailable (launch failure / poisoned bucket /
        injected spill fault) the journaled reports are replayed through
        the bit-exact CPU oracle — host vectors replace the dead refs in
        ``out_shares`` and the poisoned device delta is discarded, so
        accumulation never double-counts or drops.  Leftover refs (reports
        the helper failed) are released so their flush matrices free.

        Returns ``(accumulator_deltas, journal_entries, pending)`` —
        ``pending`` lists the deferred ``(bucket_key, refs, report_ids)``
        commits, made after the tx commits or released if it fails."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return None, None, []
        from ..executor.accumulator import AccumulatorUnavailable, ResidentRef

        resident = {
            rid: v for rid, v in out_shares.items() if isinstance(v, ResidentRef)
        }
        # release the never-finished rows' refs regardless of outcome below
        # — but NOT the WAITING rows': a multi-round VDAF's pending rows
        # carry their refs through the persisted transition into the next
        # step (releasing them here would strand every Poplar1 row on the
        # dead-ref oracle path at round 1)
        leftover = []
        for rid, st in states.items():
            if rid in out_shares or rid in waiting_rids:
                continue
            ref = getattr(getattr(st, "prep_state", None), "out_share", None)
            if not isinstance(ref, ResidentRef):  # Poplar1 carries y_flat
                ref = getattr(getattr(st, "prep_state", None), "y_flat", None)
            if isinstance(ref, ResidentRef):
                leftover.append(ref)
        if leftover:
            store.release_refs(leftover)
        if not resident:
            return None, None, []

        ra_by_rid = {ra.report_id.data: ra for ra in all_ras}
        ident_for = self._batch_ident_for(task, job)
        by_ident: Dict[bytes, List[bytes]] = {}
        for rid in resident:
            by_ident.setdefault(ident_for(ra_by_rid[rid]), []).append(rid)

        backend = self._backend_for(task, vdaf)
        shape_key = self._vdaf_shape_key(vdaf)
        agg_param = (
            vdaf.decode_agg_param(job.aggregation_parameter) if getattr(vdaf, "REQUIRES_AGG_PARAM", False) else None
        )
        field = vdaf.field_for_agg_param(agg_param)
        loop = asyncio.get_running_loop()

        # Pre-tx collected check: reports aimed at an already-collected
        # batch will be FAILED inside the writer tx, so accumulating them
        # now would guarantee a delta/tx mismatch on every redelivery.
        # Route those batches through host vectors instead (the writer
        # pops them harmlessly).  The residual race (collection commits
        # between this check and our tx) still aborts cleanly via
        # StaleAccumulatorDelta -> retryable redelivery.
        collected = await self._collected_idents(task, job, by_ident)

        deferred = getattr(store.config, "deferred", False)
        deltas: Dict[bytes, Tuple[Sequence[int], frozenset]] = {}
        journal_entries: Dict[bytes, frozenset] = {}
        pending: List[tuple] = []
        # Drain-at-commit scopes buckets per STEP ATTEMPT (job id + a
        # fresh nonce): two driver replicas sharing one process (and one
        # store) can deliver the same job concurrently after a lease
        # expiry, and a shared bucket would let both commits land before
        # either drain — a doubled vector whose rid set still matches, so
        # StaleAccumulatorDelta cannot catch it and the surviving lease
        # holder would merge it.  The bucket lives only within this step,
        # so per-attempt uniqueness costs nothing.  Deferred drains
        # accumulate ACROSS jobs by design — there the persisted journal
        # row is the fence (the drain tx only merges if it consumes every
        # contributing row exactly once).
        import secrets as _secrets

        step_nonce = _secrets.token_bytes(8)
        for ident, rids in by_ident.items():
            if deferred:
                bucket_key = (
                    "leader",
                    task.task_id.data,
                    shape_key,
                    ident,
                    job.aggregation_parameter,
                )
            else:
                bucket_key = (
                    "leader",
                    task.task_id.data,
                    shape_key,
                    ident,
                    job.aggregation_parameter,
                    job.aggregation_job_id.data,
                    step_nonce,
                )
            refs = [resident[rid] for rid in rids]

            async def replay(rids, refs, cause, bucket_key=bucket_key):
                """Exactly-once recovery: the device delta (whole or
                partial) is discarded FIRST, then the journaled reports are
                recomputed on the bit-exact CPU oracle.  Deferred entries
                from OTHER jobs have committed journal rows — they are NOT
                replayed here (the datastore replay path owns them)."""
                journal = store.discard(bucket_key)
                store.release_refs(refs)
                replay_rids = set(rids)
                other_jobs = 0
                for job_token, ids in journal:
                    if job_token == job.aggregation_job_id.data:
                        replay_rids |= set(ids)
                    else:
                        other_jobs += 1
                if other_jobs:
                    logger.warning(
                        "discarded bucket %r still journaled %d other "
                        "job(s); their persisted journal rows will be "
                        "oracle-replayed from the datastore",
                        bucket_key,
                        other_jobs,
                    )
                unknown = replay_rids - set(ra_by_rid)
                if unknown:
                    # this job's rows must always be recomputable from the
                    # step's loaded report aggregations; fail loudly and
                    # retryably rather than silently dropping shares
                    raise JobStepError(
                        f"accumulator journal names {len(unknown)} report(s) "
                        f"outside this job; cannot replay: {cause}",
                        retryable=True,
                    )
                if cause is not None:
                    logger.warning(
                        "resident accumulator unavailable for %d report(s); "
                        "replaying through the CPU oracle: %s",
                        len(replay_rids),
                        cause,
                    )
                replayed = await loop.run_in_executor(
                    None,
                    lambda rids=sorted(replay_rids): self._oracle_out_shares(
                        task, vdaf, backend, [ra_by_rid[r] for r in rids], agg_param=agg_param
                    ),
                )
                out_shares.update(replayed)

            if ident in collected:
                await replay(rids, refs, None)
                continue
            if deferred:
                # summed only once the tx has written the journal row
                journal_entries[ident] = frozenset(rids)
                pending.append((bucket_key, refs, rids))
                continue

            def commit_and_drain(bucket_key=bucket_key, refs=refs, rids=rids):
                store.commit_rows(
                    bucket_key,
                    backend,
                    refs,
                    job_token=job.aggregation_job_id.data,
                    report_ids=rids,
                )
                return store.drain(bucket_key, field)

            try:
                drained = await loop.run_in_executor(None, commit_and_drain)
            except JobStepError:
                raise
            except Exception as e:
                # AccumulatorUnavailable, an injected fault, or anything
                # else device-shaped: the same discard-then-replay recovery
                # (a partial commit must never survive to double-count)
                if not isinstance(e, AccumulatorUnavailable):
                    logger.exception("accumulator commit/drain failed")
                await replay(rids, refs, e)
                continue
            if drained is None:
                continue
            vector, drained_rids = drained
            deltas[ident] = (vector, frozenset(drained_rids))
        return deltas or None, journal_entries or None, pending

    async def _commit_journaled(self, task, vdaf, job, pending) -> None:
        """Deferred mode, after the step's tx has written its journal rows:
        sum each bucket's pending rows into the resident accumulator (no
        readback).  A drain that ran before this point could not take
        them.  Where the commit fails (a poisoned bucket, a lost flush),
        the rows are released: their journal rows stay in the datastore
        for the collection step's replay once they pass its bound, and the
        cadence drain discards a poisoned bucket."""
        from ..executor.accumulator import AccumulatorUnavailable

        store = self._executor.accumulator
        backend = self._backend_for(task, vdaf)
        loop = asyncio.get_running_loop()
        for bucket_key, refs, rids in pending:

            def commit(bucket_key=bucket_key, refs=refs, rids=rids):
                store.commit_rows(
                    bucket_key,
                    backend,
                    refs,
                    job_token=job.aggregation_job_id.data,
                    report_ids=rids,
                )

            try:
                try:
                    await loop.run_in_executor(None, commit)
                except AccumulatorUnavailable:
                    # a drain may have detached the bucket between the
                    # commit's lookup and its sum: the retry opens a fresh
                    # one (a poisoned bucket refuses again)
                    await loop.run_in_executor(None, commit)
            except Exception:
                logger.exception(
                    "deferred accumulator commit failed for bucket %r; its "
                    "journal rows stay persisted for the collection replay",
                    bucket_key,
                )
                store.release_refs(refs)

    def _release_pending(self, pending) -> None:
        """The step's tx failed: its journal rows never committed, so its
        pending rows must never reach a bucket (redelivery re-prepares
        them).  The buckets and the other jobs' rows in them stay."""
        if pending:
            self._executor.accumulator.release_refs(
                [ref for _key, refs, _rids in pending for ref in refs]
            )

    def _oracle_out_shares(self, task, vdaf, backend, ras, agg_param=None):
        """Bit-exact CPU replay of finished reports' out shares (backend
        contract: oracle == device, tests/test_torch_backend.py).
        Agg-param VDAFs (Poplar1) replay per report at the job's OWN
        parameter — ``prep_init(...).y_flat`` is the value vector the
        FINISHED verdict already vouched for (the sketch verified before
        the ref was minted).  The replay runs inside the task's cost
        scope, so crash-recovery CPU time shows on the task's
        ``path="oracle"`` series like any other oracle work."""
        from ..core import costs
        from ..vdaf.backend import OracleBackend, oracle_backend_for

        rows = []
        for ra in ras:
            rows.append(
                (
                    ra.report_id.data,
                    vdaf.decode_public_share(ra.public_share or b""),
                    vdaf.decode_input_share(0, ra.leader_input_share),
                )
            )
        out = {}
        if getattr(vdaf, "REQUIRES_AGG_PARAM", False):

            def poplar_replay():
                res = {}
                for rid, public, share in rows:  # the report id IS the nonce
                    state, _sh = vdaf.prep_init(task.vdaf_verify_key, 0, agg_param, rid, public, share)
                    res[rid] = list(state.y_flat)
                return res

            return costs.run_in_task_scope(task.task_id.data, poplar_replay)
        oracle = oracle_backend_for(backend, vdaf) or OracleBackend(vdaf)
        replayed = costs.run_in_task_scope(
            task.task_id.data,
            lambda: oracle.prep_init_batch(task.vdaf_verify_key, 0, rows),
        )
        for ra, outcome in zip(ras, replayed):
            if isinstance(outcome, VdafError):  # cannot happen for a report
                raise JobStepError(  # that already prepared successfully
                    f"oracle replay rejected report {ra.report_id}: {outcome}",
                    retryable=True,
                )
            state, _share = outcome
            out[ra.report_id.data] = state.out_share
        return out

    # ------------------------------------------------------------------
    # deferred-drain plumbing (accumulator.drain_interval_s > 0)

    async def run_accumulator_maintenance(self) -> int:
        """The dedicated maintenance pass (binaries background loop,
        ``accumulator.maintenance_interval_s``): drain deferred buckets
        that came due while no driver commit was around to drain them —
        an idle task's resident delta no longer waits for UNRELATED
        traffic to commit — then rebalance resident occupancy (the LRU
        eviction pass, off the hot path).  Returns the number of due
        buckets drained (attempted)."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return 0
        drained = await self._maybe_drain_due()
        occupancy = store.rebalance()
        if drained:
            logger.info(
                "accumulator maintenance drained %d due bucket(s); "
                "occupancy: %d bucket(s), %d resident byte(s)",
                drained,
                occupancy.get("buckets", 0),
                occupancy.get("resident_bytes", 0),
            )
        return drained

    async def _maybe_drain_due(self) -> int:
        """Cadence scan: drain every deferred bucket whose oldest delta is
        older than drain_interval_s, merging ONE share-only vector per
        bucket into batch_aggregations and consuming its journal rows.
        Returns the number of due buckets scanned."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None or not getattr(store.config, "deferred", False):
            return 0
        # the shared store may also hold 7-tuple drain-at-commit keys
        # (helper requests in the same process) and the HELPER's 5-tuple
        # deferred CONTINUE buckets (aggregator.py owns those — it merges
        # into the helper datastore); only this driver's LEADER-role
        # 5-tuple deferred keys are cadence-drainable here
        keys = [
            k
            for k in store.due_buckets(store.config.drain_interval_s)
            if len(k) == 5 and k[0] == "leader"
        ]
        if not keys:
            return 0
        loop = asyncio.get_running_loop()
        for key in keys:
            try:
                await loop.run_in_executor(None, self._drain_due_bucket, key)
            except Exception:
                # the step's own tx already committed — a drain failure
                # (e.g. the drain tx exhausting retries under contention)
                # must not fail the step or strand its lease; whatever was
                # not merged stays journaled for the datastore replay
                logger.exception("deferred cadence drain failed for %r", key)
        return len(keys)

    def _drain_due_bucket(self, key: tuple) -> None:
        store = self._executor.accumulator
        from ..executor.accumulator import AccumulatorError

        task, vdaf, field = self._task_field_for_bucket(key)
        if task is None:
            return
        try:
            out = store.drain_with_journal(key, field)
        except AccumulatorError as e:
            journal = store.discard(key)
            logger.warning(
                "deferred drain failed for bucket %r; %d journal row(s) "
                "stay persisted for the datastore oracle replay: %s",
                key,
                len(journal),
                e,
            )
            return
        if out is not None:
            self._merge_drained(task, field, key, out[0], out[1])

    def _task_field_for_bucket(self, key: tuple):
        """(task, vdaf, field) for a deferred bucket key
        ``(role, task_id, shape_key, batch_identifier, agg_param)``."""
        from ..messages import TaskId

        _role, task_id_b, _shape, _ident, param = key
        task = self.datastore.run_tx(
            "accum_drain_task",
            lambda tx: tx.get_aggregator_task(TaskId(task_id_b)),
        )
        if task is None:
            logger.warning("bucket %r names an unknown task; dropping", key)
            return None, None, None
        vdaf = task.vdaf_instance()
        return task, vdaf, vdaf.field_for_agg_param(vdaf.decode_agg_param(param))

    def _merge_drained(self, task, field, key: tuple, vector, journal) -> None:
        """The deferred-drain transaction: consume every contributing
        job's journal row, then merge the drained vector as a share-only
        batch-aggregation delta.  A missing row means a crash-recovery
        replay already merged that job's shares from the datastore — the
        vector can no longer be applied (it cannot be split per job), so
        the whole drain aborts and the SURVIVING rows stay journaled for
        the same replay path.  Either path merges each row exactly once."""
        from ..messages import AggregationJobId
        from .aggregation_job_writer import merge_share_delta

        _role, _task_id_b, _shape, ident, param = key

        def tx_fn(tx):
            for job_token, _rids in journal:
                if not tx.delete_accumulator_journal_entry(
                    task.task_id, ident, param, AggregationJobId(job_token)
                ):
                    raise _JournalRowMissing(job_token)
            merge_share_delta(
                tx,
                task,
                field,
                ident,
                param,
                vector,
                shard_count=self.config.batch_aggregation_shard_count,
            )

        try:
            self.datastore.run_tx("accumulator_drain", tx_fn)
        except _JournalRowMissing as e:
            logger.warning(
                "bucket %r journal row %s already consumed (replayed by a "
                "survivor); dropping the drained vector — remaining rows "
                "stay journaled for the datastore replay",
                key,
                e,
            )
            return
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.accumulator_journal_consumed.labels(path="drain").inc(
                len(journal)
            )

    def _spill_sink(self, key: tuple, vector, journal) -> None:
        """shutdown(drain=True) target: spill one committed-but-unspilled
        bucket durably.  Only LEADER deferred buckets (5-tuple keys) with
        persisted journal rows are mergeable here; job-scoped
        drain-at-commit buckets still resident at shutdown belong to
        transactions that never committed — merging them would
        double-count after the lease redelivers — and a co-resident
        HELPER's deferred buckets belong to the helper datastore (its
        journal replay at aggregate-share time re-derives them), so both
        are dropped loudly instead."""
        if len(key) != 5 or key[0] != "leader" or not journal:
            logger.warning(
                "dropping un-journaled resident delta for bucket %r "
                "(%d job(s)); lease redelivery re-derives it",
                key,
                len(journal),
            )
            return
        task, _vdaf, field = self._task_field_for_bucket(key)
        if task is None:
            return
        self._merge_drained(task, field, key, vector, journal)

    async def shutdown(self) -> None:
        """Graceful teardown (SIGTERM path): flush the executor's pending
        mega-batches, spill committed-but-unspilled deferred deltas to the
        datastore through the journal transaction, then stop intake.  The
        crash path is ``executor.shutdown(drain=False)`` — everything it
        drops is re-derived by lease redelivery or the journal replay."""
        if self._executor is not None:
            try:
                await self._executor.drain()
            except Exception:
                logger.exception("executor drain failed during shutdown")
            ex = self._executor
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: ex.shutdown(drain=True)
            )
        await self.close()

    # ------------------------------------------------------------------
    async def abandon_aggregation_job(self, lease: Lease) -> None:
        """reference: :977-1026 (abandon + best-effort helper DELETE)"""
        acq = lease.leased

        def tx_fn(tx):
            task = tx.get_aggregator_task(acq.task_id)
            job = tx.get_aggregation_job(acq.task_id, acq.aggregation_job_id)
            if job is not None and job.state == AggregationJobState.IN_PROGRESS:
                tx.update_aggregation_job(job.with_state(AggregationJobState.ABANDONED))
            tx.release_aggregation_job(lease)
            return task

        task = await self.datastore.run_tx_async("abandon_agg_job", tx_fn)
        if task is not None:
            try:
                await self._send_to_helper(
                    task,
                    "DELETE",
                    f"aggregation_jobs/{acq.aggregation_job_id}",
                    None,
                    None,
                    expect_body=False,
                )
            except Exception:
                logger.warning("best-effort helper DELETE failed", exc_info=True)

    # ------------------------------------------------------------------
    async def _send_to_helper(
        self,
        task: AggregatorTask,
        method: str,
        resource: str,
        body: Optional[bytes],
        media_type: Optional[str],
        expect_body: bool = True,
        lease=None,
    ) -> Optional[AggregationJobResp]:
        """HTTPS to the peer aggregator with retry/backoff
        (reference: aggregator.rs:3200 send_request_to_helper).  The
        exchange runs under a lease-derived deadline (a blackholed peer
        must release the lease, never pin it past reap) and behind the
        peer-health gate; a transport-level failure against a suspect
        peer surfaces as partition pressure (peer_unhealthy), which
        releases without consuming the attempt budget."""
        from ..core import peer_health
        from ..core.retries import is_transport_error

        url = (
            task.peer_aggregator_endpoint.rstrip("/")
            + f"/tasks/{task.task_id}/{resource}"
        )
        tracker = peer_health.tracker()
        # re-gate: a partition detected MID-step (between prepare and
        # send) must not burn the attempt either
        self._gate_peer(task)
        headers = {}
        if media_type:
            headers["Content-Type"] = media_type
        if task.aggregator_auth_token is not None:
            name, value = task.aggregator_auth_token.request_authentication()
            headers[name] = value
        # Cross-process trace propagation: the helper binds this request's
        # trace id so both aggregators' spans/logs join one timeline.
        from ..core.trace import inject_traceparent

        inject_traceparent(headers)
        try:
            status, resp_body, _ = await retry_http_request(
                self._get_session(),
                method,
                url,
                data=body,
                headers=headers,
                policy=self.config.http_retry,
                deadline=helper_request_deadline(lease, self.datastore),
            )
        except Exception as e:
            raise JobStepError(
                f"helper request failed: {e}",
                retryable=True,
                # only a transport failure against a peer the tracker has
                # ALREADY suspected is partition pressure — a one-off
                # blip still consumes budget (a broken-but-reachable path
                # must not ping-pong forever)
                peer_unhealthy=is_transport_error(e)
                and tracker.is_suspect(url),
            )
        if status >= 400:
            # 4xx = fatal (bad request will not heal); 5xx = retryable
            # (reference: aggregation_job_driver.rs:1030 error classification)
            raise JobStepError(
                f"helper returned {status}: {resp_body[:200]!r}",
                retryable=status >= 500,
            )
        if not expect_body:
            return None
        return AggregationJobResp.get_decoded(resp_body)
