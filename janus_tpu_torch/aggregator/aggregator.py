"""Per-process aggregator façade and role logic.

The analog of ``Aggregator<C>`` / ``TaskAggregator`` / ``VdafOps``
(reference: aggregator/src/aggregator.rs:133,868,1168): a task cache resolves
each task's VDAF instance and execution backend once; handlers implement the
DAP endpoints.  The helper's aggregate-init pipeline replaces the reference's
per-report rayon loop (aggregator.rs:2101) with ONE batched device launch via
the backend seam (vdaf/backend.py: the card's ``CudaBackend``) — the
north-star hot path.

Handlers are async: datastore transactions run on a worker thread
(run_tx_async) and the batched VDAF launch runs in an executor, so the event
loop is never blocked (the analog of L0's tokio/rayon split, SURVEY.md §1).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.auth_tokens import AuthenticationToken
from ..core.dp import dp_strategy_from_dict
from ..core.hpke import HpkeApplicationInfo, HpkeError, HpkeKeypair, Label, open_, seal
from ..core.time import Clock, interval_merge, time_add, time_to_batch_interval
from ..datastore import (
    AggregateShareJob,
    AggregationJob,
    AggregationJobState,
    AggregatorTask,
    BatchAggregationState,
    CollectionJob,
    CollectionJobState,
    Datastore,
    LeaderStoredReport,
    ReportAggregation,
    ReportAggregationState,
    TaskNotFound,
    TxConflict,
)
from ..datastore.datastore import QUERY_TYPES
from ..datastore.query_type import strategy_for
from ..messages import (
    AggregateShare,
    AggregateShareAad,
    AggregateShareReq,
    AggregationJobContinueReq,
    AggregationJobId,
    AggregationJobInitializeReq,
    AggregationJobResp,
    AggregationJobStep,
    BatchId,
    BatchSelector,
    Collection,
    CollectionJobId,
    CollectionReq,
    Duration,
    FixedSizeQuery,
    HpkeConfigList,
    InputShareAad,
    Interval,
    PartialBatchSelector,
    PlaintextInputShare,
    PrepareError,
    PrepareResp,
    PrepareStepResult,
    Query,
    Report,
    ReportId,
    Role,
    TaskId,
    Time,
)
from ..vdaf import pingpong as pp
from ..vdaf.backend import BACKENDS, device_supported, make_backend, prep_request
from ..vdaf.prio3 import Prio3, VdafError
from .aggregation_job_writer import AggregationJobWriter
from .aggregate_share import compute_aggregate_share
from .error import (
    AggregatorError,
    BatchInvalid,
    BatchMismatch,
    BatchOverlap,
    BatchQueriedTooManyTimes,
    DeletedCollectionJob,
    ForbiddenMutation,
    InvalidBatchSize,
    InvalidMessage,
    ReportRejection,
    StepMismatch,
    UnauthorizedRequest,
    UnrecognizedAggregationJob,
    UnrecognizedCollectionJob,
    UnrecognizedTask,
    UploadShed,
)
from .report_writer import ReportWriteBatcher

logger = logging.getLogger("janus_tpu_torch.aggregator")


@dataclass
class Config:
    """reference: aggregator/src/aggregator.rs:180 Config"""

    max_upload_batch_size: int = 100
    max_upload_batch_write_delay: float = 0.25
    #: Upload HPKE-open backend: "batched" groups concurrent
    #: uploads' opens into one vectorized pass on a worker thread
    #: (core/hpke_batch.py — bit-exact vs inline, per-report fallback on
    #: any batch-level error); "inline" is the legacy per-report open on
    #: the handler's event loop.
    upload_open_backend: str = "batched"
    #: open-batch size/delay (the ReportWriteBatcher pattern)
    upload_open_batch_size: int = 64
    upload_open_batch_delay: float = 0.005
    #: Admission control: shed uploads (503 + Retry-After) once this many
    #: opens are pending (staged + in flight), or once the oldest STAGED
    #: open has waited upload_shed_delay_s.  <= 0 disables either signal.
    upload_queue_max: int = 1024
    upload_shed_delay_s: float = 2.0
    #: Ingest mode: "synchronous" commits every report through
    #: the legacy ReportWriteBatcher put_client_report path (the
    #: bit-for-bit default); "journaled" ACKs uploads on the write-behind
    #: report journal and hands opened shares directly to the aggregation
    #: pipeline's staging side (core/ingest.py IngestPlane).
    ingest_mode: str = "synchronous"
    #: journal-writer size/delay/bound (the ReportWriteBatcher pattern;
    #: queue_max is the reason="journal" admission bound)
    ingest_journal_batch_size: int = 100
    ingest_journal_write_delay: float = 0.05
    ingest_journal_queue_max: int = 2048
    #: direct staging: hand journaled cohorts to the in-process creator
    #: (False = journal-only write-behind; everything reaches aggregation
    #: through the materializer's read-back path)
    ingest_stage_direct: bool = True
    ingest_stage_max_reports: int = 4096
    batch_aggregation_shard_count: int = 8
    task_counter_shard_count: int = 8
    task_cache_ttl: float = 30.0
    #: Refresh cadence for the global-HPKE / taskprov-peer config caches
    #: (reference: cache.rs refresh tasks).
    global_hpke_cache_refresh_interval: float = 60.0
    peer_aggregator_cache_refresh_interval: float = 60.0
    #: VDAF execution backend: "cuda" (the batched prepare on the card,
    #: vdaf/backend.py CudaBackend), "mesh" (the same prepare sharded over
    #: every card of the process, MeshBackend) or "oracle" (the CPU
    #: oracle, only when named).  A VDAF the card does not serve (device_supported False:
    #: FixedPointBoundedL2VecSum, the Fake* test VDAFs) takes the oracle,
    #: logged and counted; for a served circuit a backend that fails to
    #: build raises.
    vdaf_backend: str = "cuda"
    #: torch device of the "cuda" backend; None = "cuda" (tests name "cpu")
    vdaf_device: Optional[str] = None
    #: Field layout of the card backends: "vpu" (limb core) or "mxu" (the
    #: limb-digit matmul layout, vdaf/backend.py FIELD_BACKENDS); None =
    #: JANUS_TPU_TORCH_FIELD_BACKEND or "vpu".  Bit-exact either way.
    field_backend: Optional[str] = None
    collection_job_retry_after: int = 10
    #: Aggregation-job size for agg-param VDAFs (Poplar1), whose jobs are
    #: created by the collection request (_create_agg_param_jobs) rather
    #: than the periodic creator: one collection's reports split into
    #: ceil(N/this) jobs per level.  With the device executor the split
    #: costs nothing at prepare time — the jobs' rows re-coalesce in the
    #: level-keyed poplar_init bucket.
    max_agg_param_job_size: int = 256
    #: The process's device executor (executor.DeviceExecutor): when set,
    #: the HELPER's Prio3 prep_init/combine launches submit through the
    #: same continuous batcher the drivers feed, so the circuit breaker
    #: guards the helper path too.  None = per-request launches.
    device_executor: Optional[object] = None


def resolve_backend(vdaf, backend_name: str, device, task_id=None, field_backend: Optional[str] = None):
    """The backend that serves ``vdaf``: ``make_backend(vdaf, backend_name,
    device=, field_backend=)``, except that a VDAF the card does not serve
    (``device_supported`` False) takes the CPU oracle — logged, and counted
    in ``janus_vdaf_backend_fallbacks_total``.  For a served circuit an
    error from building the backend propagates: no oracle hides the card."""
    if backend_name not in BACKENDS:
        raise VdafError(f"unknown backend {backend_name!r} (cuda|mesh|oracle)")
    if backend_name != "oracle":
        ok, reason = device_supported(vdaf)
        if not ok:
            vdaf_type = (getattr(vdaf, "instance", None) or {}).get(
                "type", type(vdaf).__name__
            )
            logger.warning(
                "task %s VDAF %s falls back to the CPU oracle "
                "(configured backend %r): %s",
                task_id,
                vdaf_type,
                backend_name,
                reason,
            )
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.vdaf_backend_fallbacks.labels(
                    vdaf_type=vdaf_type, reason=reason[:80]
                ).inc()
            backend_name = "oracle"
    return make_backend(vdaf, backend_name, device=device, field_backend=field_backend)


class TaskAggregator:
    """A task with its VDAF instance + backend resolved once
    (reference: aggregator.rs:868-1137)."""

    def __init__(
        self,
        task: AggregatorTask,
        backend_name: str,
        device: Optional[str] = None,
        field_backend: Optional[str] = None,
    ):
        self.task = task
        self.vdaf = task.vdaf_instance()
        self.backend_name = backend_name
        self.device = device
        self.field_backend = field_backend
        self._backend = None

    @property
    def backend(self):
        if self._backend is None:
            self._backend = resolve_backend(
                self.vdaf, self.backend_name, self.device, self.task.task_id, self.field_backend
            )
        return self._backend

    @property
    def query_class(self):
        return QUERY_TYPES[self.task.query_type.kind]

    def check_aggregator_auth(self, token: Optional[AuthenticationToken]) -> None:
        h = self.task.aggregator_auth_token_hash
        if h is None or token is None or not h.validate(token):
            raise UnauthorizedRequest("invalid aggregator auth token")

    def check_collector_auth(self, token: Optional[AuthenticationToken]) -> None:
        h = self.task.collector_auth_token_hash
        if h is None or token is None or not h.validate(token):
            raise UnauthorizedRequest("invalid collector auth token")

    def hpke_config_list(self) -> HpkeConfigList:
        return HpkeConfigList([self.task.current_hpke_keypair().config])


class Aggregator:
    """reference: aggregator/src/aggregator.rs:133"""

    def __init__(self, datastore: Datastore, clock: Clock, config: Config = None):
        self.datastore = datastore
        self.clock = clock
        self.config = config or Config()
        self._task_cache: Dict[bytes, Tuple[float, TaskAggregator]] = {}
        from .cache import GlobalHpkeKeypairCache, PeerAggregatorCache

        self.global_hpke_cache = GlobalHpkeKeypairCache(
            datastore, self.config.global_hpke_cache_refresh_interval
        )
        self.peer_aggregator_cache = PeerAggregatorCache(
            datastore, self.config.peer_aggregator_cache_refresh_interval
        )
        self.report_writer = ReportWriteBatcher(
            datastore,
            max_batch_size=self.config.max_upload_batch_size,
            max_batch_write_delay=self.config.max_upload_batch_write_delay,
            counter_shard_count=self.config.task_counter_shard_count,
        )
        # Front-door open stage: the batched-HPKE pipeline +
        # admission control.  Constructed unconditionally so /statusz and
        # the shed gate exist even under upload_open_backend: inline.
        if self.config.upload_open_backend not in ("batched", "inline"):
            # a typo'd backend must fail construction loudly, not silently
            # serve the legacy path
            raise ValueError(
                f"unknown upload_open_backend "
                f"{self.config.upload_open_backend!r} (batched|inline)"
            )
        from .report_writer import UploadOpenBatcher

        self.upload_opener = UploadOpenBatcher(
            max_batch_size=self.config.upload_open_batch_size,
            max_batch_delay=self.config.upload_open_batch_delay,
            max_queue=self.config.upload_queue_max,
            shed_delay_s=self.config.upload_shed_delay_s,
            device=self.config.vdaf_device,
        )
        # Zero-copy ingest plane: in journaled mode the upload
        # write seam becomes the write-behind report journal + direct
        # staging handoff; synchronous keeps the legacy writer bit-for-bit.
        if self.config.ingest_mode not in ("synchronous", "journaled"):
            raise ValueError(
                f"unknown ingest_mode {self.config.ingest_mode!r} "
                f"(synchronous|journaled)"
            )
        self.ingest = None
        if self.config.ingest_mode == "journaled":
            from ..core.ingest import IngestPlane

            self.ingest = IngestPlane(
                datastore,
                max_batch_size=self.config.ingest_journal_batch_size,
                max_write_delay=self.config.ingest_journal_write_delay,
                queue_max=self.config.ingest_journal_queue_max,
                counter_shard_count=self.config.task_counter_shard_count,
                stage_direct=self.config.ingest_stage_direct,
                stage_max_reports=self.config.ingest_stage_max_reports,
            )
        # Quarantine ledger sink: poison offenders found by the
        # batched-open / executor bisection sieves persist into this
        # datastore's quarantined_reports table (failure-tolerant,
        # background thread — see core/quarantine.py).
        if datastore is not None:
            from ..core import quarantine

            quarantine.configure_sink(datastore)
        # Helper-side executor routing: share the process's continuous
        # batcher (and its per-shape circuit breakers) with the drivers.
        self._executor = self.config.device_executor

    async def shutdown(self) -> None:
        """Cancel the config-cache refresh loops (call on service teardown)."""
        await self.global_hpke_cache.stop()
        await self.peer_aggregator_cache.stop()

    # ------------------------------------------------------------------
    # task cache (reference: aggregator.rs:675 task_aggregator_for)

    async def task_aggregator_for(self, task_id: TaskId) -> TaskAggregator:
        import time as _t

        key = task_id.data
        hit = self._task_cache.get(key)
        if hit is not None and hit[0] > _t.monotonic():
            return hit[1]
        task = await self.datastore.run_tx_async(
            "get_task", lambda tx: tx.get_aggregator_task(task_id)
        )
        if task is None:
            raise UnrecognizedTask(str(task_id))
        ta = TaskAggregator(task, self.config.vdaf_backend, self.config.vdaf_device, self.config.field_backend)
        self._task_cache[key] = (_t.monotonic() + self.config.task_cache_ttl, ta)
        return ta

    # ------------------------------------------------------------------
    # taskprov opt-in (reference: aggregator.rs:722)

    async def ensure_taskprov_task(
        self,
        task_id: TaskId,
        encoded_task_config: Optional[bytes],
        auth_token: Optional[AuthenticationToken],
        require_peer_auth: bool = True,
    ) -> None:
        """Provision a task advertised in-band, if the advertising peer is
        configured, AUTHENTICATED, and the id matches SHA-256 of the config
        (reference: aggregator.rs:722 opt-in + :813 taskprov request
        authorization — the peer must present its pre-shared token before
        anything is written)."""
        if encoded_task_config is None:
            return
        if task_id.data in self._task_cache or await self.datastore.run_tx_async(
            "taskprov_exists",
            lambda tx: tx.get_aggregator_task(task_id) is not None,
        ):
            return
        from .taskprov import taskprov_task, taskprov_task_id

        if taskprov_task_id(encoded_task_config) != task_id:
            raise InvalidMessage("taskprov task id mismatch")
        from ..messages.taskprov import TaskConfig

        config = TaskConfig.get_decoded(encoded_task_config)
        if config.task_expiration.seconds <= self.clock.now().seconds:
            raise InvalidMessage("taskprov advertisement already expired")

        # Peer + global-key lookups come from the refreshed caches; only the
        # task write needs a transaction (reference: cache.rs consumers).
        peers = await self.peer_aggregator_cache.peers()
        own_role = peer = None
        for p in peers:
            if (
                p.role == Role.LEADER
                and p.endpoint == str(config.leader_aggregator_endpoint)
            ):
                own_role, peer = Role.HELPER, p
                break
            if (
                p.role == Role.HELPER
                and p.endpoint == str(config.helper_aggregator_endpoint)
            ):
                own_role, peer = Role.LEADER, p
                break
        if peer is None:
            raise UnrecognizedTask("no taskprov peer for advertised task")
        # authenticate the advertising peer before any write; the upload
        # route is exempt (clients cannot hold the peer token — the
        # reference separates upload opt-in from peer request auth)
        if require_peer_auth:
            h = peer.aggregator_auth_token_hash
            if h is None and peer.aggregator_auth_token is not None:
                h = peer.aggregator_auth_token.hash()
            if h is None or auth_token is None or not h.validate(auth_token):
                raise UnauthorizedRequest("taskprov advertisement not authenticated")
        keys = [
            HpkeKeypair(kp.config, kp.private_key)
            for kp in await self.global_hpke_cache.active_keypairs()
        ]
        if not keys:
            raise UnrecognizedTask("no active global HPKE key for taskprov")

        def tx_fn(tx):
            task = taskprov_task(
                encoded_task_config, peer, own_role, keys, config=config
            )
            try:
                tx.put_aggregator_task(task)
            except TxConflict:
                pass  # concurrent provisioning of the same advertisement

        await self.datastore.run_tx_async("taskprov_opt_in", tx_fn)

    # ------------------------------------------------------------------
    # GET hpke_config (reference: http_handlers.rs "hpke_config" route)

    async def handle_hpke_config(self, task_id: Optional[TaskId]) -> HpkeConfigList:
        if task_id is not None:
            ta = await self.task_aggregator_for(task_id)
            return ta.hpke_config_list()
        # global keys, served from the refreshed cache (no DB hit in the
        # steady state — reference: cache.rs GlobalHpkeKeypairCache)
        active = await self.global_hpke_cache.active_configs()
        if not active:
            raise UnrecognizedTask("no HPKE configuration available")
        return HpkeConfigList(active)

    # ------------------------------------------------------------------
    # upload (reference: aggregator.rs:1522 handle_upload_generic)

    @staticmethod
    def _shed_if_datastore_suspect() -> None:
        """Brownout shed: while the datastore tracker is
        SUSPECT every upload would burn HPKE work only to fail at the
        write, so refuse with the retryable 503 up front.  PROBING
        uploads are deliberately admitted — the write attempt IS the
        probe that heals the tracker."""
        from ..core.db_health import DB_SUSPECT, tracker as db_tracker

        if db_tracker().state() != DB_SUSPECT:
            return
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.upload_sheds.labels(reason="datastore").inc()
        raise UploadShed("datastore suspect (brownout); retry shortly")

    async def handle_upload(self, task_id: TaskId, report: Report) -> None:
        from ..core.trace import current_trace, new_trace_id, trace_scope, trace_span

        # Upload trace mint point: adopt the client's strict-hex
        # traceparent (bound by http_handlers._route when valid) or mint a
        # fresh 32-hex id.  A malformed header therefore costs the client
        # nothing — parse_traceparent returned None, we mint, the upload
        # proceeds.  The id is bound for the whole handler (validation
        # logs, the upload span) and rides the stored report so job
        # creation can link prepare back to client ingress.
        trace_id = current_trace().get("trace_id") or new_trace_id()
        with trace_scope(trace_id=trace_id), trace_span("upload", cat="upload"):
            # Admission control: shed BEFORE any per-upload
            # crypto or datastore work — past the front-door budget the
            # cheapest correct answer is the retryable 503.
            self._shed_if_datastore_suspect()
            self.upload_opener.admit()
            # Journaled-mode backpressure composes here: a
            # slow journal writer surfaces as reason="journal" sheds at
            # the same pre-crypto gate, never as unbounded memory.
            if self.ingest is not None:
                self.ingest.admit()
            ta = await self.task_aggregator_for(task_id)
            task = ta.task
            if task.role != Role.LEADER:
                raise UnrecognizedTask("upload to non-leader")
            try:
                keypair, info, aad = self._validate_report_pre_open(ta, report)
            except ReportRejection as rej:
                await self.report_writer.write_rejection(task_id, rej)
                raise rej.to_error()
            # The expensive open: batched (grouped with concurrent
            # uploads, KEM on a worker thread, one vectorized AES-GCM
            # pass) or the legacy inline call.  Either way the SAME
            # plaintext comes back — bit-exactness is the seam contract.
            try:
                if self.config.upload_open_backend == "batched":
                    plaintext = await self.upload_opener.open(
                        keypair,
                        info,
                        report.leader_encrypted_input_share,
                        aad,
                        # report identity for the quarantine ledger, should
                        # bisection isolate this row as poison
                        ident=(
                            task_id.data.hex(),
                            report.metadata.report_id.data,
                        ),
                    )
                else:
                    import time as _time

                    from ..core.metrics import GLOBAL_METRICS

                    t0 = _time.monotonic()
                    if GLOBAL_METRICS.registry is not None:
                        GLOBAL_METRICS.hpke_open_rows.labels(stage="upload", route="inline").inc()
                    plaintext = open_(
                        keypair, info, report.leader_encrypted_input_share, aad
                    )
                    if GLOBAL_METRICS.registry is not None:
                        GLOBAL_METRICS.upload_open_seconds.labels(
                            backend="inline"
                        ).observe(_time.monotonic() - t0)
            except HpkeError:
                rej = ReportRejection(ReportRejection.DECRYPT_FAILURE, "decrypt failed")
                await self.report_writer.write_rejection(task_id, rej)
                raise rej.to_error()
            try:
                stored = self._decode_opened_report(ta, report, plaintext)
            except ReportRejection as rej:
                await self.report_writer.write_rejection(task_id, rej)
                raise rej.to_error()
            if self.ingest is not None:
                # journaled: the ACK resolves when the journal row is
                # durable; the opened share rides to the staging side
                # without a put_client_report round-trip
                await self.ingest.submit(
                    stored, shape_key=self._ingest_shape_key(ta)
                )
            else:
                await self.report_writer.write_report(stored)

    @staticmethod
    def _ingest_shape_key(ta: TaskAggregator):
        """Staging bucket identity for the ingest plane: the task's vdaf
        shape (the executor's bucketing axis), or None for cohorts the
        direct path cannot consume — FixedSize tasks (jobs come from
        outstanding-batch filling) journal and reach aggregation through
        the materializer instead."""
        if ta.task.query_type.kind != "TimeInterval":
            return None
        return (
            type(ta.vdaf).__name__,
            tuple(sorted((k, repr(v)) for k, v in ta.task.vdaf.items())),
        )

    def _validate_report_pre_open(self, ta: TaskAggregator, report: Report):
        """The CHEAP upload checks, run inline before the open is queued:
        clock skew / expiry / public-share decode / key lookup.  Returns
        (keypair, application info, aad) for the open stage."""
        task = ta.task
        now = self.clock.now()
        t = report.metadata.time
        # clock skew / expiry / GC eligibility (reference: aggregator.rs:1552-1581)
        if t.seconds > time_add(now, task.tolerable_clock_skew).seconds:
            raise ReportRejection(ReportRejection.TOO_EARLY, "report too far in future")
        if task.task_expiration is not None and t.seconds > task.task_expiration.seconds:
            raise ReportRejection(ReportRejection.TASK_EXPIRED, "task expired")
        if (
            task.report_expiry_age is not None
            and t.seconds < now.seconds - task.report_expiry_age.seconds
        ):
            raise ReportRejection(ReportRejection.EXPIRED, "report expired")

        # decode public share (reference: aggregator.rs:1587)
        try:
            ta.vdaf.decode_public_share(report.public_share)
        except Exception:
            raise ReportRejection(ReportRejection.DECODE_FAILURE, "bad public share")

        keypair = task.hpke_keypair_for(report.leader_encrypted_input_share.config_id)
        if keypair is None:
            raise ReportRejection(
                ReportRejection.OUTDATED_KEY,
                f"unknown HPKE config id {report.leader_encrypted_input_share.config_id}",
            )
        aad = InputShareAad(
            task.task_id, report.metadata, report.public_share
        ).get_encoded()
        info = HpkeApplicationInfo.new(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
        return keypair, info, aad

    def _decode_opened_report(
        self, ta: TaskAggregator, report: Report, plaintext: bytes
    ) -> LeaderStoredReport:
        """Post-open decode (cheap, inline): plaintext share -> stored row."""
        task = ta.task
        try:
            plain = PlaintextInputShare.get_decoded(plaintext)
            _check_extensions(plain.extensions)
            ta.vdaf.decode_input_share(0, plain.payload)
        except Exception as e:
            raise ReportRejection(ReportRejection.DECODE_FAILURE, f"bad input share: {e}")

        return LeaderStoredReport(
            task_id=task.task_id,
            metadata=report.metadata,
            public_share=report.public_share,
            leader_extensions=list(plain.extensions),
            leader_input_share=plain.payload,
            helper_encrypted_input_share=report.helper_encrypted_input_share,
        )

    def _validate_and_open_report(self, ta: TaskAggregator, report: Report) -> LeaderStoredReport:
        """The legacy single-call inline path (pre-open checks + open +
        decode in one synchronous pass) — kept as the reference the
        batched pipeline is parity-tested against."""
        keypair, info, aad = self._validate_report_pre_open(ta, report)
        try:
            plaintext = open_(keypair, info, report.leader_encrypted_input_share, aad)
        except HpkeError:
            raise ReportRejection(ReportRejection.DECRYPT_FAILURE, "decrypt failed")
        return self._decode_opened_report(ta, report, plaintext)

    # ------------------------------------------------------------------
    # helper aggregate init (reference: aggregator.rs:1720 handle_aggregate_init_generic)

    async def handle_aggregate_init(
        self,
        task_id: TaskId,
        aggregation_job_id: AggregationJobId,
        body: bytes,
        auth_token: Optional[AuthenticationToken],
    ) -> AggregationJobResp:
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        if task.role != Role.HELPER:
            raise UnrecognizedTask("aggregate-init on non-helper")
        ta.check_aggregator_auth(auth_token)
        req = AggregationJobInitializeReq.get_decoded(body, ta.query_class)
        request_hash = hashlib.sha256(body).digest()

        # replay/idempotency check (reference: aggregator.rs:1748,2173-2209)
        existing = await self.datastore.run_tx_async(
            "agg_init_replay",
            lambda tx: tx.get_aggregation_job(task_id, aggregation_job_id),
        )
        if existing is not None:
            if existing.last_request_hash == request_hash:
                return await self._stored_job_resp(task_id, aggregation_job_id)
            raise ForbiddenMutation("aggregation job replayed with different request")

        # duplicate report IDs in one request are rejected outright
        # (reference: aggregator.rs:1765)
        seen = set()
        for pi in req.prepare_inits:
            rid = pi.report_share.metadata.report_id.data
            if rid in seen:
                raise InvalidMessage("duplicate report id in request")
            seen.add(rid)

        # Per-report validation + HPKE open (host side, async-friendly).
        failed: Dict[int, PrepareError] = {}
        conflict_key = ta.vdaf.agg_param_conflict_key(req.aggregation_parameter)

        def find_replays(tx):
            out = []
            for pi in req.prepare_inits:
                rid = pi.report_share.metadata.report_id
                for param in tx.get_aggregation_params_for_report(
                    task_id, rid, exclude_aggregation_job_id=aggregation_job_id
                ):
                    if ta.vdaf.agg_param_conflict_key(param) == conflict_key:
                        out.append(rid.data)
                        break
            return out

        replay_ids = await self.datastore.run_tx_async(
            "agg_init_conflicts", find_replays
        )
        replay_set = set(replay_ids)
        now = self.clock.now()
        # Batched HPKE open (ROADMAP front-door follow-on): the helper's
        # aggregate-init report-share opens are the same embarrassingly-
        # batchable shape as upload — cheap per-report validation inline,
        # then ONE core/hpke_batch.open_batch call on a worker thread
        # (per-report KEM decap + one vectorized AES-128-GCM pass), with
        # per-report inline fallback on any other batch-LEVEL error.  A
        # vector pass that fails as a whole answers 503 (the leader
        # retries) and opens nothing another way.
        decoded: List[Tuple[int, tuple]] = []  # (idx, (nonce, public, share, msg))
        to_open: List[Tuple[int, object]] = []  # (idx, OpenRequest)
        for idx, pi in enumerate(req.prepare_inits):
            err = self._helper_validate_report_share(ta, pi, replay_set, now)
            if err is not None:
                failed[idx] = err
                continue
            prepared = self._helper_open_request(ta, pi)
            if isinstance(prepared, PrepareError):
                failed[idx] = prepared
            else:
                to_open.append((idx, prepared))
        if to_open:
            loop = asyncio.get_running_loop()
            from ..core.hpke_batch import VectorPassError, _open_one, open_batch

            stage = "aggregate_init"
            if self.config.upload_open_backend == "batched":

                def run_opens():
                    try:
                        return open_batch([r for _i, r in to_open], self.config.vdaf_device, stage)
                    except VectorPassError:
                        raise
                    except Exception:
                        # batch-LEVEL failure: per-report inline opens —
                        # the batched path must never reject a report the
                        # inline path would accept
                        logger.exception(
                            "batched aggregate-init open failed; falling "
                            "back to per-report opens"
                        )
                        return [_open_one(*r, stage=stage) for _i, r in to_open]

                try:
                    opened = await loop.run_in_executor(None, run_opens)
                except VectorPassError as e:
                    from ..core.metrics import GLOBAL_METRICS
                    from .error import ServiceUnavailable

                    logger.error("aggregate-init vector pass failed: %s", e)
                    if GLOBAL_METRICS.registry is not None:
                        GLOBAL_METRICS.hpke_vector_pass_failures.labels(stage=stage).inc()
                    raise ServiceUnavailable(f"report share open failed on the device; retry: {e}")
            else:
                opened = await loop.run_in_executor(
                    None, lambda: [_open_one(*r, stage=stage) for _i, r in to_open]
                )
            for (idx, _req), plaintext in zip(to_open, opened):
                if isinstance(plaintext, Exception) or plaintext is None:
                    failed[idx] = PrepareError.HPKE_DECRYPT_ERROR
                    continue
                item = self._helper_decode_opened_share(
                    ta, req.prepare_inits[idx], plaintext
                )
                if isinstance(item, PrepareError):
                    failed[idx] = item
                else:
                    decoded.append((idx, item))

        # Batched prepare: ONE device launch for the whole job (north star).
        try:
            agg_param = ta.vdaf.decode_agg_param(req.aggregation_parameter)
        except VdafError:
            raise InvalidMessage("bad aggregation parameter")
        loop = asyncio.get_running_loop()
        if (
            self._executor is not None
            and isinstance(ta.vdaf, Prio3)
            and hasattr(ta.backend, "stage_prep_init_multi")
        ):
            # Helper-side executor routing (ROADMAP item): prep_init and
            # combine submit through the process-wide continuous batcher,
            # so helper requests coalesce with driver traffic and the
            # circuit breaker guards this path too.
            results = await self._helper_prepare_batch_prio3_executor(ta, decoded)
        elif self._executor is not None and hasattr(ta.backend, "prep_init_batch_poplar"):
            # Heavy hitters through the same dispatch plane: the request's
            # rows coalesce in the agg-param(level)-keyed poplar_init
            # bucket, under the same breaker.
            results = await self._helper_prepare_batch_poplar1_executor(ta, decoded, agg_param)
        else:
            # direct (non-executor) path: bind the task cost scope on the
            # worker thread so the backend's measured prepare seconds
            # attribute to this task (core/costs.py — path derives from
            # the backend: cuda -> device, oracle -> oracle)
            from ..core import costs

            _ident = getattr(getattr(ta.task, "task_id", None), "data", None)
            results = await loop.run_in_executor(
                None,
                lambda: costs.run_in_task_scope(
                    _ident,
                    lambda: self._helper_prepare_batch(ta, decoded, agg_param),
                ),
            )

        # Assemble responses + report aggregations in request order.
        ras: List[ReportAggregation] = []
        out_shares: Dict[bytes, Sequence[int]] = {}
        resps: List[PrepareResp] = []
        interval = Interval.EMPTY
        for idx, pi in enumerate(req.prepare_inits):
            rid = pi.report_share.metadata.report_id
            t = pi.report_share.metadata.time
            interval = interval_merge(
                interval, time_to_batch_interval(t, task.time_precision)
            )
            base = dict(
                task_id=task_id,
                aggregation_job_id=aggregation_job_id,
                report_id=rid,
                time=t,
                ord=idx,
            )
            if idx in failed:
                err = failed[idx]
                resp = PrepareResp(rid, PrepareStepResult.reject(err))
                ras.append(
                    ReportAggregation(
                        state=ReportAggregationState.FAILED, error=err,
                        last_prep_resp=resp, **base
                    )
                )
                resps.append(resp)
                continue
            outcome = results[idx]
            if isinstance(outcome, PrepareError):
                resp = PrepareResp(rid, PrepareStepResult.reject(outcome))
                ras.append(
                    ReportAggregation(
                        state=ReportAggregationState.FAILED, error=outcome,
                        last_prep_resp=resp, **base
                    )
                )
                resps.append(resp)
                continue
            kind, payload, outbound = outcome
            resp = PrepareResp(rid, PrepareStepResult.new_continue(outbound))
            if kind == "finished":
                out_shares[rid.data] = payload
                ras.append(
                    ReportAggregation(
                        state=ReportAggregationState.FINISHED,
                        last_prep_resp=resp, **base
                    )
                )
            else:  # continued (multi-round VDAF)
                ras.append(
                    ReportAggregation(
                        state=ReportAggregationState.WAITING_HELPER,
                        helper_prep_state=payload,
                        last_prep_resp=resp, **base
                    )
                )
            resps.append(resp)

        from ..core.trace import current_trace

        job = AggregationJob(
            task_id=task_id,
            aggregation_job_id=aggregation_job_id,
            aggregation_parameter=req.aggregation_parameter,
            partial_batch_identifier=req.partial_batch_selector.batch_identifier
            if task.query_type.kind == "FixedSize"
            else None,
            client_timestamp_interval=interval,
            state=AggregationJobState.FINISHED
            if all(
                ra.state
                in (ReportAggregationState.FINISHED, ReportAggregationState.FAILED)
                for ra in ras
            )
            else AggregationJobState.IN_PROGRESS,
            step=AggregationJobStep(0),
            last_request_hash=request_hash,
            # cross-process correlation: the leader driver's traceparent
            # (bound by the HTTP layer) persists on the helper's job row
            trace_id=current_trace().get("trace_id"),
        )

        # Helper-side retention: finished rows carrying
        # ResidentRefs psum into per-batch device accumulators and drain to
        # ONE vector per batch here, BEFORE the tx — closing the gap
        # where the helper read its out shares back per flush.
        decoded_by_rid = {item[0]: item for _idx, item in decoded}
        accumulator_deltas = await self._commit_helper_resident_shares(
            ta, job, ras, out_shares, decoded_by_rid
        )

        from ..executor.accumulator import ResidentRef, StaleAccumulatorDelta

        writer = AggregationJobWriter(
            task,
            ta.vdaf,
            batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
            initial_write=True,
            backend=ta.backend,
            accumulator_deltas=accumulator_deltas,
        )
        writer.put(job, ras, out_shares)

        def tx_fn(tx):
            return writer.write(tx)

        try:
            failures = await self.datastore.run_tx_async("agg_init_write", tx_fn)
        except TxConflict:
            # racing identical request: return the stored response
            return await self._stored_job_resp(task_id, aggregation_job_id)
        except StaleAccumulatorDelta:
            # A batch was collected between the drain and the tx: the
            # drained delta no longer matches the rows surviving the in-tx
            # check.  The tx aborted with nothing merged; retry ONCE with
            # oracle host vectors — the writer then fails the collected
            # rows properly (BatchCollected) and merges only survivors.
            loop = asyncio.get_running_loop()
            stale = sorted(
                rid for rid, v in out_shares.items() if isinstance(v, ResidentRef)
            )
            replayed = await loop.run_in_executor(
                None,
                lambda: self._helper_oracle_out_shares(ta, stale, decoded_by_rid),
            )
            out_shares.update(replayed)
            writer = AggregationJobWriter(
                task,
                ta.vdaf,
                batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
                initial_write=True,
                backend=ta.backend,
            )
            writer.put(job, ras, out_shares)
            try:
                failures = await self.datastore.run_tx_async(
                    "agg_init_write", lambda tx: writer.write(tx)
                )
            except TxConflict:
                return await self._stored_job_resp(task_id, aggregation_job_id)
        if failures:
            resps = [
                PrepareResp(r.report_id, PrepareStepResult.reject(failures[r.report_id.data]))
                if r.report_id.data in failures
                else r
                for r in resps
            ]
        return AggregationJobResp(resps)

    def _helper_validate_report_share(
        self, ta: TaskAggregator, pi, replay_set, now
    ) -> Optional[PrepareError]:
        task = ta.task
        meta = pi.report_share.metadata
        if meta.report_id.data in replay_set:
            return PrepareError.REPORT_REPLAYED
        if (
            task.task_expiration is not None
            and meta.time.seconds > task.task_expiration.seconds
        ):
            return PrepareError.TASK_EXPIRED
        if (
            task.report_expiry_age is not None
            and meta.time.seconds < now.seconds - task.report_expiry_age.seconds
        ):
            return PrepareError.REPORT_DROPPED
        if meta.time.seconds > time_add(now, task.tolerable_clock_skew).seconds:
            return PrepareError.REPORT_TOO_EARLY
        return None

    def _helper_open_request(self, ta: TaskAggregator, pi):
        """The pre-open half of a report-share decode: key lookup + AAD
        assembly.  Returns a core/hpke_batch OpenRequest tuple, or the
        PrepareError that rejects the share before any crypto is paid."""
        task = ta.task
        meta = pi.report_share.metadata
        keypair = task.hpke_keypair_for(pi.report_share.encrypted_input_share.config_id)
        if keypair is None:
            return PrepareError.HPKE_UNKNOWN_CONFIG_ID
        aad = InputShareAad(
            task.task_id, meta, pi.report_share.public_share
        ).get_encoded()
        info = HpkeApplicationInfo.new(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
        return (keypair, info, pi.report_share.encrypted_input_share, aad)

    def _helper_decode_opened_share(self, ta: TaskAggregator, pi, plaintext):
        """The post-open half: plaintext + wire decode and ping-pong
        variant checks."""
        meta = pi.report_share.metadata
        try:
            plain = PlaintextInputShare.get_decoded(plaintext)
            _check_extensions(plain.extensions)
        except Exception:
            return PrepareError.INVALID_MESSAGE
        try:
            input_share = ta.vdaf.decode_input_share(1, plain.payload)
            public_parts = ta.vdaf.decode_public_share(pi.report_share.public_share)
        except (VdafError, Exception):
            return PrepareError.INVALID_MESSAGE
        if pi.message.variant != pp.PingPongMessage.INITIALIZE:
            return PrepareError.INVALID_MESSAGE
        return (meta.report_id.data, public_parts, input_share, pi.message)

    def _helper_prepare_batch(self, ta: TaskAggregator, decoded, agg_param):
        """Batched helper_initialized over the surviving reports.

        Prio3 rides the backend seam (ONE batched device launch), and so
        does Poplar1 (one walk and one sketch pass); other VDAFs (the
        multi-round test doubles) step per report through the generic
        ping-pong topology (reference mirror: aggregator.rs:2022-2040
        helper_initialized on rayon)."""
        vdaf = ta.vdaf
        if isinstance(vdaf, Prio3):
            return self._helper_prepare_batch_prio3(ta, decoded)
        if hasattr(ta.backend, "prep_init_batch_poplar"):
            return self._helper_prepare_batch_poplar1(ta, decoded, agg_param)
        results: Dict[int, object] = {}
        vk = ta.task.vdaf_verify_key
        for idx, (nonce, public_parts, input_share, leader_msg) in decoded:
            try:
                trans = pp.helper_initialized(
                    vdaf, vk, agg_param, nonce, public_parts, input_share, leader_msg
                )
                state, outbound = trans.evaluate(vdaf)
            except (VdafError, pp.PingPongError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            if isinstance(state, pp.PingPongFinished):
                results[idx] = ("finished", state.out_share, outbound)
            else:
                results[idx] = (
                    "continued",
                    vdaf.ping_pong_encode_state(state.prep_state),
                    outbound,
                )
        return results

    def _helper_prepare_batch_poplar1(self, ta: TaskAggregator, decoded, agg_param):
        """Heavy hitters through the batched backend: the round-0 IDPF tree
        walk and sketch run once for the whole job (ops/poplar1_batch.py);
        the per-report remainder is the combine and transition
        helper_initialized performs."""
        vdaf = ta.vdaf
        results, rows = self._helper_decode_poplar_rows(vdaf, decoded)
        if not rows:
            return results
        prep_out = ta.backend.prep_init_batch_poplar(
            ta.task.vdaf_verify_key, 1, agg_param, [(n, p, s) for (_, n, p, s, _) in rows]
        )
        return self._helper_finish_poplar1(vdaf, agg_param, results, rows, prep_out)

    @staticmethod
    def _helper_decode_poplar_rows(vdaf, decoded):
        """Decode the leader's round-0 sketch shares; (errors, rows)."""
        results: Dict[int, object] = {}
        rows = []
        for idx, (nonce, public_parts, input_share, leader_msg) in decoded:
            try:
                if leader_msg.variant != pp.PingPongMessage.INITIALIZE:
                    raise pp.PingPongError("expected initialize message")
                leader_share = vdaf.ping_pong_decode_prep_share(leader_msg.prep_share, round=0)
            except (VdafError, pp.PingPongError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            rows.append((idx, nonce, public_parts, input_share, leader_share))
        return results, rows

    @staticmethod
    def _helper_finish_poplar1(vdaf, agg_param, results, rows, prep_out):
        """Combine the sketch shares and evaluate the transition a report
        (the cheap sigma math after the batched walk and sketch)."""
        for (idx, _n, _p, _s, leader_share), outcome in zip(rows, prep_out):
            if isinstance(outcome, VdafError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            prep_state, helper_share = outcome
            try:
                prep_msg = vdaf.ping_pong_prep_shares_to_prep(agg_param, [leader_share, helper_share], round=0)
                trans = pp.PingPongTransition(prep_state, prep_msg, 0)
                state, outbound = trans.evaluate(vdaf)
            except (VdafError, pp.PingPongError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            if isinstance(state, pp.PingPongFinished):
                results[idx] = ("finished", state.out_share, outbound)
            else:
                results[idx] = ("continued", vdaf.ping_pong_encode_state(state.prep_state), outbound)
        return results

    async def _helper_prepare_batch_poplar1_executor(self, ta: TaskAggregator, decoded, agg_param):
        """Helper Poplar1 prep through the process-wide device executor: the
        request's rows submit into the agg-param-keyed ``poplar_init``
        bucket (agg_id=1, the level as discriminant), coalescing with every
        other helper request at the same tree level.  As on the Prio3
        helper path, an open circuit and executor backpressure both answer
        a retryable 503 to the leader; no served row lands on the oracle."""
        from ..executor import KIND_POPLAR_INIT
        from ..executor.service import CircuitOpenError, ExecutorOverloadedError
        from .error import ServiceUnavailable

        vdaf = ta.vdaf
        shape_key, backend = self._executor_backend_for(ta)
        task_ident = getattr(getattr(ta.task, "task_id", None), "data", None)
        loop = asyncio.get_running_loop()
        if self._executor.circuit_open(shape_key):
            raise ServiceUnavailable(f"circuit for shape {shape_key[0]} is open")
        if self._executor.warming(shape_key):
            await loop.run_in_executor(None, lambda: self._executor.wait_warm(shape_key))
        results, rows = await loop.run_in_executor(None, lambda: self._helper_decode_poplar_rows(vdaf, decoded))
        if not rows:
            return results
        prep_in = [(nonce, public, share) for (_, nonce, public, share, _) in rows]
        try:
            prep_out = await self._executor.submit(
                shape_key,
                KIND_POPLAR_INIT,
                (ta.task.vdaf_verify_key, agg_param, prep_in),
                backend=backend,
                agg_id=1,
                task_ident=task_ident,
                agg_param_key=getattr(agg_param, "level", None),
            )
        except CircuitOpenError as e:
            raise ServiceUnavailable(f"device circuit open: {e}")
        except ExecutorOverloadedError as e:
            raise ServiceUnavailable(f"device executor overloaded: {e}")
        return await loop.run_in_executor(
            None, lambda: self._helper_finish_poplar1(vdaf, agg_param, results, rows, prep_out)
        )

    @staticmethod
    def _helper_decode_leader_shares(vdaf, decoded):
        """Decode the leader's round-0 prepare shares; returns
        (per-index errors so far, surviving rows)."""
        results: Dict[int, object] = {}
        rows = []
        for idx, (nonce, public_parts, input_share, leader_msg) in decoded:
            try:
                leader_share = vdaf.ping_pong_decode_prep_share(
                    leader_msg.prep_share, round=0
                )
            except VdafError:
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            rows.append((idx, nonce, public_parts, input_share, leader_share))
        return results, rows

    @staticmethod
    def _helper_finish_prio3(vdaf, results, combine_rows, combined):
        """Evaluate the combined prepare messages into finished outcomes."""
        for (idx, state, _ls, hs), prep_msg in zip(combine_rows, combined):
            if isinstance(prep_msg, VdafError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            try:
                out_share = vdaf.prep_next(state, prep_msg)
            except VdafError:
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            outbound = pp.PingPongMessage(
                pp.PingPongMessage.FINISH, prep_msg=prep_msg or b""
            )
            results[idx] = ("finished", out_share, outbound)
        return results

    def _helper_prepare_batch_prio3(self, ta: TaskAggregator, decoded):
        """The north-star path: one batched launch for prep + combine."""
        backend = ta.backend
        vdaf = ta.vdaf
        results, rows = self._helper_decode_leader_shares(vdaf, decoded)
        if not rows:
            return results
        prep_in = [(nonce, public, share) for (_, nonce, public, share, _) in rows]
        prep_out = backend.prep_init_batch(ta.task.vdaf_verify_key, 1, prep_in)
        combine_rows = []
        for (idx, _n, _p, _s, leader_share), outcome in zip(rows, prep_out):
            if isinstance(outcome, VdafError):
                results[idx] = PrepareError.VDAF_PREP_ERROR
                continue
            state, helper_share = outcome
            combine_rows.append((idx, state, leader_share, helper_share))
        combined = backend.prep_shares_to_prep_batch(
            [[ls, hs] for (_, _, ls, hs) in combine_rows]
        )
        return self._helper_finish_prio3(vdaf, results, combine_rows, combined)

    def _executor_backend_for(self, ta: TaskAggregator):
        """(shape key, backend) through the executor's shape-keyed cache:
        tasks sharing one VDAF shape, or one canonical bucket, share one
        backend (and the drivers' backend, in the same process)."""
        return self._executor.prep_backend_for(
            ta.vdaf, ta.backend_name, ta.device, lambda: ta.backend, field_backend=ta.field_backend
        )

    async def _helper_prepare_batch_prio3_executor(self, ta: TaskAggregator, decoded):
        """Helper prep through the process-wide device executor: prep_init
        (agg_id=1 buckets) and combine submissions coalesce with every
        other producer's, and the per-shape circuit breaker guards this
        path — an open circuit (CircuitOpenError, or a breaker-peek hit
        before submitting) and executor backpressure both surface as a
        retryable 503 to the leader; no served circuit lands on the
        oracle."""
        from ..executor import (
            KIND_COMBINE,
            KIND_PREP_INIT,
        )
        from ..executor.service import CircuitOpenError, ExecutorOverloadedError
        from .error import ServiceUnavailable

        vdaf = ta.vdaf
        shape_key, backend = self._executor_backend_for(ta)
        # task identity for the per-task fairness quota within the bucket
        task_ident = getattr(getattr(ta.task, "task_id", None), "data", None)
        loop = asyncio.get_running_loop()
        # A served circuit never lands on the CPU oracle: an open circuit
        # answers 503, and the leader's lease machinery redelivers.
        if self._executor.circuit_open(shape_key):
            raise ServiceUnavailable(
                f"circuit for shape {shape_key[0]}/{shape_key[1]} is open"
            )
        if self._executor.warming(shape_key):
            # kernels still building on the warmup thread: wait on the
            # compile future off the event loop (the breaker never sees
            # compile-wait)
            await loop.run_in_executor(None, lambda: self._executor.wait_warm(shape_key))

        results, rows = await loop.run_in_executor(
            None, lambda: self._helper_decode_leader_shares(vdaf, decoded)
        )
        if not rows:
            return results
        prep_in = [(nonce, public, share) for (_, nonce, public, share, _) in rows]
        prep_out = None
        try:
            prep_out = await self._executor.submit(
                shape_key,
                KIND_PREP_INIT,
                prep_request(backend, ta.task.vdaf_verify_key, prep_in, vdaf),
                backend=backend,
                agg_id=1,
                # Helper-side retention: with the
                # accumulator store attached, the helper's out shares stay
                # ON DEVICE and the writer consumes a drained delta
                # instead of reading every row back.
                retain_out_shares=self._executor.accumulator is not None,
                task_ident=task_ident,
            )
            combine_rows = []
            for (idx, _n, _p, _s, leader_share), outcome in zip(rows, prep_out):
                if isinstance(outcome, VdafError):
                    results[idx] = PrepareError.VDAF_PREP_ERROR
                    continue
                state, helper_share = outcome
                combine_rows.append((idx, state, leader_share, helper_share))
            combined = await self._executor.submit(
                shape_key,
                KIND_COMBINE,
                [[ls, hs] for (_, _, ls, hs) in combine_rows],
                backend=backend,
                agg_id=1,
                task_ident=task_ident,
            )
            results = await loop.run_in_executor(
                None,
                lambda: self._helper_finish_prio3(vdaf, results, combine_rows, combined),
            )
        except CircuitOpenError as e:
            self._release_helper_refs(prep_out)
            raise ServiceUnavailable(f"device circuit open: {e}")
        except ExecutorOverloadedError as e:
            self._release_helper_refs(prep_out)
            raise ServiceUnavailable(f"device executor overloaded: {e}")
        except BaseException:
            # anything else — a cancelled request mid-combine, an
            # unclassified executor failure — must not strand the minted
            # refs, or the retained flush matrix never frees (release is
            # idempotent, so rows a flush already released are unaffected)
            self._release_helper_refs(prep_out)
            raise
        # rows whose combine/finish failed keep no out share: release their
        # refs so the retained flush matrix can free
        self._release_unfinished_helper_refs(results, combine_rows)
        return results

    def _release_helper_refs(self, prep_out) -> None:
        from ..executor.accumulator import ResidentRef

        store = self._executor.accumulator if self._executor is not None else None
        if store is None or not prep_out:
            return
        refs = [
            o[0].out_share
            for o in prep_out
            if isinstance(o, tuple) and isinstance(o[0].out_share, ResidentRef)
        ]
        if refs:
            store.release_refs(refs)

    def _release_unfinished_helper_refs(self, results, combine_rows) -> None:
        from ..executor.accumulator import ResidentRef

        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return
        refs = []
        for idx, state, _ls, _hs in combine_rows:
            out = results.get(idx)
            if isinstance(out, tuple) and out[0] == "finished":
                continue  # its ref lives on in out_shares; committed later
            ref = getattr(state, "out_share", None)
            if isinstance(ref, ResidentRef):
                refs.append(ref)
        if refs:
            store.release_refs(refs)

    async def _commit_helper_resident_shares(
        self, ta: TaskAggregator, job, ras, out_shares, decoded_by_rid
    ):
        """Helper mirror of the driver's accumulator commit (drain-at-
        commit only: the helper's writer runs in this request, so there is
        no cross-job residency to defer).  On any store/device failure the
        journaled reports are recomputed on the bit-exact CPU oracle from
        the request's decoded shares — host vectors replace the dead refs
        and the poisoned delta is discarded, exactly-once either way."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return None
        from ..datastore.query_type import strategy_for
        from ..executor.accumulator import AccumulatorUnavailable, ResidentRef
        from ..vdaf.backend import vdaf_shape_key

        resident = {
            rid: v for rid, v in out_shares.items() if isinstance(v, ResidentRef)
        }
        if not resident:
            return None
        task = ta.task
        vdaf = ta.vdaf
        shape_key = vdaf_shape_key(vdaf)
        # commit_rows sums each ref on the backend that minted its flush
        # (the executor's cached one; a canonical bucket's twin), whose
        # buffers match the retained matrices; ta.backend is only the last
        # resort for a flush without one.
        commit_backend = ta.backend
        strategy = strategy_for(task)
        ra_by_rid = {ra.report_id.data: ra for ra in ras}
        field = vdaf.field_for_agg_param(
            vdaf.decode_agg_param(job.aggregation_parameter)
        )

        def ident_for(ra):
            if job.partial_batch_identifier is not None:
                return job.partial_batch_identifier.get_encoded()
            return strategy.to_batch_identifier(task, ra.time)

        by_ident: Dict[bytes, List[bytes]] = {}
        for rid in resident:
            by_ident.setdefault(ident_for(ra_by_rid[rid]), []).append(rid)

        loop = asyncio.get_running_loop()
        deltas: Dict[bytes, tuple] = {}
        # Per-REQUEST nonce in the key, not just the job id: two identical
        # init requests for one job can be in flight concurrently (a
        # leader replica redelivers while the first delivery's request is
        # still being served).  Sharing a bucket would let both commits
        # land before either drain — a doubled vector whose report-id set
        # still matches, which the StaleAccumulatorDelta check cannot
        # catch and (unlike the leader) no lease-token fence aborts.  The
        # bucket lives only within this request, so uniqueness costs
        # nothing.
        import secrets as _secrets

        request_nonce = _secrets.token_bytes(8)
        for ident, rids in by_ident.items():
            bucket_key = (
                "helper",
                task.task_id.data,
                shape_key,
                ident,
                job.aggregation_parameter,
                job.aggregation_job_id.data,
                request_nonce,
            )
            refs = [resident[rid] for rid in rids]

            def commit_and_drain(bucket_key=bucket_key, refs=refs, rids=rids):
                store.commit_rows(
                    bucket_key,
                    commit_backend,
                    refs,
                    job_token=job.aggregation_job_id.data,
                    report_ids=rids,
                )
                return store.drain(bucket_key, field)

            try:
                drained = await loop.run_in_executor(None, commit_and_drain)
            except Exception as e:
                if not isinstance(e, AccumulatorUnavailable):
                    logger.exception("helper accumulator commit/drain failed")
                journal = store.discard(bucket_key)
                store.release_refs(refs)
                replay_rids = set(rids)
                for _job_token, ids in journal:
                    replay_rids |= set(ids)
                logger.warning(
                    "helper resident accumulator unavailable for %d "
                    "report(s); replaying through the CPU oracle: %s",
                    len(replay_rids),
                    e,
                )
                replayed = await loop.run_in_executor(
                    None,
                    lambda rids=sorted(replay_rids): self._helper_oracle_out_shares(
                        ta, rids, decoded_by_rid
                    ),
                )
                out_shares.update(replayed)
                continue
            if drained is None:
                continue
            vector, drained_rids = drained
            deltas[ident] = (vector, frozenset(drained_rids))
        return deltas or None

    def _helper_oracle_out_shares(self, ta: TaskAggregator, rids, decoded_by_rid):
        """Bit-exact CPU recompute of the helper's out shares from the
        request's already-decoded input shares (backend contract: oracle
        == device, tests/test_backend.py)."""
        from ..vdaf.backend import OracleBackend

        oracle = getattr(ta.backend, "oracle", None) or OracleBackend(ta.vdaf)
        rows = []
        for rid in rids:
            _rid, public_parts, input_share, _msg = decoded_by_rid[rid]
            rows.append((rid, public_parts, input_share))
        out = {}
        for rid, outcome in zip(
            rids, oracle.prep_init_batch(ta.task.vdaf_verify_key, 1, rows)
        ):
            if isinstance(outcome, VdafError):  # cannot happen for a report
                raise AggregatorError(  # that already prepared successfully
                    f"oracle replay rejected report {rid.hex()}"
                )
            state, _share = outcome
            out[rid] = state.out_share
        return out

    async def _stored_job_resp(
        self, task_id: TaskId, aggregation_job_id: AggregationJobId
    ) -> AggregationJobResp:
        """Reconstruct the last response from stored report aggregations."""
        ras = await self.datastore.run_tx_async(
            "stored_resp",
            lambda tx: tx.get_report_aggregations_for_aggregation_job(
                task_id, aggregation_job_id
            ),
        )
        resps = [ra.last_prep_resp for ra in ras if ra.last_prep_resp is not None]
        return AggregationJobResp(resps)

    # ------------------------------------------------------------------
    # helper aggregate continue (reference: aggregation_job_continue.rs:38)

    async def handle_aggregate_continue(
        self,
        task_id: TaskId,
        aggregation_job_id: AggregationJobId,
        body: bytes,
        auth_token: Optional[AuthenticationToken],
    ) -> AggregationJobResp:
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        if task.role != Role.HELPER:
            raise UnrecognizedTask("aggregate-continue on non-helper")
        ta.check_aggregator_auth(auth_token)
        req = AggregationJobContinueReq.get_decoded(body)
        if int(req.step) == 0:
            raise InvalidMessage("continue cannot request step 0")

        job = await self.datastore.run_tx_async(
            "agg_cont_load",
            lambda tx: tx.get_aggregation_job(task_id, aggregation_job_id),
        )
        if job is None:
            raise UnrecognizedAggregationJob(str(aggregation_job_id))
        # step skew (reference: aggregation_job_continue.rs:38-286)
        if int(req.step) == int(job.step):
            # replay of the previous request: only an identical body may be
            # answered from cache; a mutated request is a conflict
            if job.last_request_hash == hashlib.sha256(body).digest():
                return await self._stored_job_resp(task_id, aggregation_job_id)
            raise ForbiddenMutation("continue replayed with different request")
        if int(req.step) != int(job.step) + 1:
            raise StepMismatch(
                f"request step {int(req.step)} vs job step {int(job.step)}"
            )

        ras = await self.datastore.run_tx_async(
            "agg_cont_ras",
            lambda tx: tx.get_report_aggregations_for_aggregation_job(
                task_id, aggregation_job_id
            ),
        )
        by_id = {ra.report_id.data: ra for ra in ras}

        loop = asyncio.get_running_loop()
        stepped = await loop.run_in_executor(
            None, lambda: self._helper_continue_batch(ta, job, req, by_id)
        )
        new_ras, out_shares, resps = stepped

        job = job.with_step(AggregationJobStep(int(req.step))).with_last_request_hash(
            hashlib.sha256(body).digest()
        )
        if all(
            ra.state
            in (ReportAggregationState.FINISHED, ReportAggregationState.FAILED)
            for ra in new_ras
        ):
            job = job.with_state(AggregationJobState.FINISHED)

        # Helper-side deferred accumulation: CONTINUE rounds of agg-param
        # VDAFs (Poplar1's round-1 finishers) route their host vectors
        # through the store's deferred buckets — N continue requests at one
        # tree level merge as ONE datastore vector write, drained on the
        # request cadence or at the aggregate-share barrier.  The journal
        # row written in this tx is the exactly-once fence (replayable at
        # aggregate-share time from the retained helper_prep_state), and
        # the vectors enter their bucket only once it has committed.
        journal_entries = None
        pending: List[tuple] = []
        direct_shares = out_shares
        store = self._executor.accumulator if self._executor is not None else None
        if (
            store is not None
            and store.config.deferred
            and getattr(ta.vdaf, "REQUIRES_AGG_PARAM", False)
            and out_shares
        ):
            out_shares = dict(out_shares)
            (
                journal_entries,
                pending,
                new_ras,
            ) = await self._commit_helper_deferred_host_shares(
                ta, job, by_id, new_ras, out_shares
            )

        from ..executor.accumulator import StaleAccumulatorDelta

        def write_tx(journal_entries, out_shares):
            writer = AggregationJobWriter(
                task,
                ta.vdaf,
                batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
                initial_write=False,
                backend=ta.backend,
                journal_entries=journal_entries,
                journal_drain_interval_s=store.config.drain_interval_s if journal_entries else None,
            )
            writer.put(job, new_ras, out_shares)
            return self.datastore.run_tx_async("agg_cont_write", lambda tx: writer.write(tx))

        try:
            failures = await write_tx(journal_entries, out_shares)
        except StaleAccumulatorDelta:
            # a journaled report failed in-tx (its batch was collected
            # under our feet): the journal rows never committed and no
            # vector entered a bucket; retry once merging this request's
            # vectors directly (no deferral; still exactly-once)
            journal_entries, pending = None, []
            failures = await write_tx(None, direct_shares)
        if pending:
            await self._commit_helper_journaled(ta, job, pending)
        if journal_entries:
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.accumulator_journal_entries.inc(len(journal_entries))
            await self._maybe_drain_helper_due(ta)
        if failures:
            resps = [
                PrepareResp(r.report_id, PrepareStepResult.reject(failures[r.report_id.data]))
                if r.report_id.data in failures
                else r
                for r in resps
            ]
        return AggregationJobResp(resps)

    async def _commit_helper_deferred_host_shares(
        self, ta: TaskAggregator, job, by_id, new_ras, out_shares
    ):
        """The helper twin of the driver's deferred journaling: per batch
        bucket, hand the writer a journal entry instead of this request's
        finished vectors, whose out_shares become sentinel refs so that
        the writer defers them.  Their FINISHED report aggregations RETAIN
        ``helper_prep_state`` (the round-1 prepare state whose ``y_flat``
        IS the vector): the replay window after the bucket is lost.
        Batches already collected are left to the writer, which fails
        their reports in-tx.  Returns (journal_entries, pending, new_ras):
        ``pending`` lists the ``(bucket_key, field, vectors, report_ids)``
        that :meth:`_commit_helper_journaled` sums into the buckets once
        the write tx has committed."""
        import dataclasses

        from ..datastore import BatchAggregationState
        from ..executor.accumulator import ResidentRef
        from ..vdaf.backend import vdaf_shape_key

        task = ta.task
        vdaf = ta.vdaf
        strategy = strategy_for(task)
        shape_key = vdaf_shape_key(vdaf)
        field = vdaf.field_for_agg_param(vdaf.decode_agg_param(job.aggregation_parameter))
        ra_by_rid = {ra.report_id.data: ra for ra in new_ras}

        def ident_for(ra):
            if job.partial_batch_identifier is not None:
                return job.partial_batch_identifier.get_encoded()
            return strategy.to_batch_identifier(task, ra.time)

        by_ident: Dict[bytes, List[bytes]] = {}
        for rid in out_shares:
            by_ident.setdefault(ident_for(ra_by_rid[rid]), []).append(rid)

        # Pre-tx collected check (as the driver's): journaling a report the
        # writer tx will fail guarantees a StaleAccumulatorDelta abort.
        def check(tx):
            out = set()
            for ident in by_ident:
                bas = tx.get_batch_aggregations_for_batch(task.task_id, ident, job.aggregation_parameter)
                if any(ba.state != BatchAggregationState.AGGREGATING for ba in bas):
                    out.add(ident)
            return out

        collected = await self.datastore.run_tx_async("helper_accum_collected_check", check)
        journal_entries: Dict[bytes, frozenset] = {}
        pending: List[tuple] = []
        for ident, rids in by_ident.items():
            if ident in collected:
                continue  # the writer fails these in-tx; vectors merge nowhere
            bucket_key = ("helper", task.task_id.data, shape_key, ident, job.aggregation_parameter)
            pending.append((bucket_key, field, [out_shares[rid] for rid in rids], rids))
            journal_entries[ident] = frozenset(rids)
            for i, rid in enumerate(rids):
                out_shares[rid] = ResidentRef(-1, i)
        if not journal_entries:
            return None, [], new_ras
        journaled = set().union(*journal_entries.values())
        new_ras = [
            dataclasses.replace(ra, helper_prep_state=by_id[ra.report_id.data].helper_prep_state)
            if ra.report_id.data in journaled and ra.state == ReportAggregationState.FINISHED
            else ra
            for ra in new_ras
        ]
        return journal_entries, pending, new_ras

    async def _commit_helper_journaled(self, ta: TaskAggregator, job, pending) -> None:
        """After the continue tx has written its journal rows: sum each
        bucket's vectors into the store's host mirror.  A drain that
        detached the bucket meanwhile makes the commit open a fresh one;
        where the commit still fails, the bucket is discarded and its
        rows, all journaled, replay at the aggregate-share barrier."""
        from ..executor.accumulator import AccumulatorUnavailable

        store = self._executor.accumulator
        loop = asyncio.get_running_loop()
        for bucket_key, field, vectors, rids in pending:

            def commit(bucket_key=bucket_key, field=field, vectors=vectors, rids=rids):
                store.commit_host_rows(
                    bucket_key, field, vectors, job_token=job.aggregation_job_id.data, report_ids=rids
                )

            try:
                try:
                    await loop.run_in_executor(None, commit)
                except AccumulatorUnavailable:
                    await loop.run_in_executor(None, commit)
            except Exception:
                logger.exception(
                    "helper deferred commit failed for bucket %r; its journal rows replay at aggregate-share time",
                    bucket_key,
                )
                self._discard_helper_deferred([bucket_key])

    def _discard_helper_deferred(self, keys) -> None:
        """Drop helper deferred buckets that failed: every row they held
        has a committed journal row, which the aggregate-share barrier
        replays from the retained states."""
        store = self._executor.accumulator if self._executor is not None else None
        if store is None:
            return
        for key in keys:
            journal = store.discard(key)
            if journal:
                logger.warning(
                    "discarded helper bucket %r with %d journaled request(s); their journal rows "
                    "replay at aggregate-share time",
                    key,
                    len(journal),
                )

    def _helper_bucket_keys(self, ta: TaskAggregator, keys) -> List[tuple]:
        """The helper's deferred (5-element) bucket keys of this task."""
        task_id = ta.task.task_id.data
        return [k for k in keys if len(k) == 5 and k[0] == "helper" and k[1] == task_id]

    async def _maybe_drain_helper_due(self, ta: TaskAggregator) -> int:
        """Cadence scan for the HELPER's deferred buckets (the helper has
        no driver loop: drains ride request completions and the
        aggregate-share barrier): merge every due bucket's vector into
        batch_aggregations, consuming its journal rows exactly once."""
        store = self._executor.accumulator
        keys = self._helper_bucket_keys(ta, store.due_buckets(store.config.drain_interval_s))
        for key in keys:
            try:
                await asyncio.get_running_loop().run_in_executor(None, self._drain_helper_bucket, ta, key)
            except Exception:
                logger.exception("helper deferred drain failed for %r", key)
        return len(keys)

    def _drain_helper_bucket(self, ta: TaskAggregator, key: tuple) -> None:
        from ..executor.accumulator import AccumulatorError

        vdaf = ta.vdaf
        _role, _task_id, _shape, ident, param = key
        field = vdaf.field_for_agg_param(vdaf.decode_agg_param(param))
        try:
            out = self._executor.accumulator.drain_with_journal(key, field)
        except AccumulatorError as e:
            journal = self._executor.accumulator.discard(key)
            logger.warning(
                "helper deferred drain failed for bucket %r; %d journal row(s) stay persisted for the "
                "aggregate-share replay: %s",
                key,
                len(journal),
                e,
            )
            return
        if out is not None:
            vector, journal = out
            self._merge_helper_drained(ta, field, ident, param, vector, journal)

    def _merge_helper_drained(self, ta: TaskAggregator, field, ident, param, vector, journal) -> None:
        """Merge one drained helper vector, consuming its journal rows in
        the same tx (exactly-once: the DELETE decides the winner against
        a concurrent aggregate-share replay)."""
        from .aggregation_job_writer import merge_share_delta

        class _RowMissing(Exception):
            pass

        task = ta.task

        def tx_fn(tx):
            for job_token, _rids in journal:
                if not tx.delete_accumulator_journal_entry(task.task_id, ident, param, AggregationJobId(job_token)):
                    raise _RowMissing(job_token)
            merge_share_delta(
                tx, task, field, ident, param, vector, shard_count=self.config.batch_aggregation_shard_count
            )

        try:
            self.datastore.run_tx("helper_accumulator_drain", tx_fn)
        except _RowMissing as e:
            logger.warning(
                "helper bucket (%r, %r) journal row %s already consumed (replayed); dropping the drained vector",
                ident,
                param,
                e,
            )
            return
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.accumulator_journal_consumed.labels(path="drain").inc(len(journal))

    async def _flush_helper_deferred(self, ta: TaskAggregator, ident: bytes, param: bytes) -> None:
        """The aggregate-share barrier: before the helper computes a
        batch's share, (1) drain every resident deferred bucket of this
        task, whatever its age (collection is the deadline), then (2)
        replay the journal rows still outstanding for the collection's
        batches (a lost store's buckets died with it; the rows name
        FINISHED reports whose retained ``helper_prep_state`` carries the
        vector)."""
        store = self._executor.accumulator if self._executor is not None else None
        task = ta.task
        if store is not None:
            for key in self._helper_bucket_keys(ta, store.bucket_keys()):
                try:
                    await asyncio.get_running_loop().run_in_executor(None, self._drain_helper_bucket, ta, key)
                except Exception:
                    # the rows it held stay journaled: the replay below
                    # takes them
                    logger.exception("helper pre-share drain failed for %r", key)
        if not await self.datastore.run_tx_async(
            "helper_journal_probe", lambda tx: tx.count_accumulator_journal_entries(task.task_id)
        ):
            return
        strategy = strategy_for(task)

        def load(tx):
            entries = []
            for bident in strategy.batch_identifiers_for_collection_identifier(task, ident):
                entries.extend(
                    e for e in tx.get_accumulator_journal_entries(task.task_id, bident)
                    if e.aggregation_parameter == param
                )
            return entries

        for entry in await self.datastore.run_tx_async("helper_journal_scan", load):
            await self._replay_helper_journal_entry(ta, entry)

    async def _replay_helper_journal_entry(self, ta: TaskAggregator, entry) -> None:
        """Re-derive one outstanding helper journal row's vector from the
        retained round-1 prepare states and merge it, deleting the row in
        the same tx (exactly-once against any concurrent drain).  A state
        that does not carry its vector on the host (a device-resident ref
        whose flush is gone) fails the replay: the share must not be
        computed without it."""
        from ..core import costs

        vdaf = ta.vdaf
        ras = await self.datastore.run_tx_async(
            "helper_replay_load_ras",
            lambda tx: tx.get_report_aggregations_for_aggregation_job(ta.task.task_id, entry.aggregation_job_id),
        )
        by_rid = {ra.report_id.data: ra for ra in ras}
        field = vdaf.field_for_agg_param(vdaf.decode_agg_param(entry.aggregation_parameter))

        def recompute():
            total = None
            for rid in entry.report_ids:
                ra = by_rid.get(rid)
                if ra is None or ra.helper_prep_state is None:
                    raise AggregatorError(
                        f"helper journal entry for job {entry.aggregation_job_id} names report {rid.hex()} "
                        "without a retained state"
                    )
                y = vdaf.ping_pong_decode_state(ra.helper_prep_state).y_flat
                if not isinstance(y, list):
                    raise AggregatorError(
                        f"helper journal entry for job {entry.aggregation_job_id}: report {rid.hex()}'s retained "
                        f"state holds {type(y).__name__}, not its vector"
                    )
                total = list(y) if total is None else field.vec_add(total, y)
            return total

        total = await asyncio.get_running_loop().run_in_executor(
            None, lambda: costs.run_in_task_scope(ta.task.task_id.data, recompute)
        )
        self._merge_replayed_helper_entry(ta, field, entry, total)

    def _merge_replayed_helper_entry(self, ta: TaskAggregator, field, entry, total) -> None:
        from .aggregation_job_writer import merge_share_delta

        task = ta.task

        def tx_fn(tx):
            if not tx.delete_accumulator_journal_entry(
                task.task_id, entry.batch_identifier, entry.aggregation_parameter, entry.aggregation_job_id
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

        if self.datastore.run_tx("helper_journal_replay", tx_fn):
            logger.warning(
                "helper replayed %d report(s) of job %s from the datastore journal (its bucket was lost)",
                len(entry.report_ids),
                entry.aggregation_job_id,
            )
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.accumulator_journal_consumed.labels(path="replay").inc()

    def _helper_continue_batch(self, ta: TaskAggregator, job, req, by_id):
        """Step WaitingHelper reports with the leader's continue messages."""
        vdaf = ta.vdaf
        new_ras: List[ReportAggregation] = []
        out_shares: Dict[bytes, Sequence[int]] = {}
        resps: List[PrepareResp] = []
        for pc in req.prepare_continues:
            ra = by_id.get(pc.report_id.data)
            if ra is None or ra.state != ReportAggregationState.WAITING_HELPER:
                raise InvalidMessage(
                    f"report {pc.report_id} not in WaitingHelper state"
                )
            try:
                agg_param = vdaf.decode_agg_param(job.aggregation_parameter)
                state = vdaf.ping_pong_decode_state(ra.helper_prep_state)
                # the helper's stored state after evaluating round k's
                # transition is at round k; step k+1's continue finds it at
                # round == req.step
                value = pp.continued(
                    vdaf,
                    False,
                    pp.PingPongContinued(state, int(req.step)),
                    pc.message,
                    agg_param,
                )
            except (VdafError, pp.PingPongError):
                resp = PrepareResp(
                    pc.report_id, PrepareStepResult.reject(PrepareError.VDAF_PREP_ERROR)
                )
                new_ras.append(
                    ra.failed(PrepareError.VDAF_PREP_ERROR).with_last_prep_resp(resp)
                )
                resps.append(resp)
                continue
            if value.out_share is not None:
                resp = PrepareResp(pc.report_id, PrepareStepResult.finished())
                new_ras.append(
                    ra.with_state(ReportAggregationState.FINISHED).with_last_prep_resp(resp)
                )
                out_shares[pc.report_id.data] = value.out_share
            else:
                next_state, outbound = value.transition.evaluate(vdaf)
                resp = PrepareResp(
                    pc.report_id, PrepareStepResult.new_continue(outbound)
                )
                if isinstance(next_state, pp.PingPongFinished):
                    new_ras.append(
                        ra.with_state(ReportAggregationState.FINISHED).with_last_prep_resp(resp)
                    )
                    out_shares[pc.report_id.data] = next_state.out_share
                else:
                    new_ras.append(
                        ra.with_state(
                            ReportAggregationState.WAITING_HELPER,
                            helper_prep_state=vdaf.ping_pong_encode_state(
                                next_state.prep_state
                            ),
                        ).with_last_prep_resp(resp)
                    )
            resps.append(resp)
        # reports absent from the request keep their state
        present = {pc.report_id.data for pc in req.prepare_continues}
        for rid, ra in by_id.items():
            if rid not in present and ra.state == ReportAggregationState.WAITING_HELPER:
                new_ras.append(ra.failed(PrepareError.REPORT_DROPPED))
        return new_ras, out_shares, resps

    # ------------------------------------------------------------------
    # helper aggregation job delete

    async def handle_aggregate_delete(
        self,
        task_id: TaskId,
        aggregation_job_id: AggregationJobId,
        auth_token: Optional[AuthenticationToken],
    ) -> None:
        ta = await self.task_aggregator_for(task_id)
        ta.check_aggregator_auth(auth_token)

        def tx_fn(tx):
            job = tx.get_aggregation_job(task_id, aggregation_job_id)
            if job is None:
                raise UnrecognizedAggregationJob(str(aggregation_job_id))
            tx.update_aggregation_job(job.with_state(AggregationJobState.DELETED))

        await self.datastore.run_tx_async("agg_delete", tx_fn)

    # ------------------------------------------------------------------
    # collection jobs (leader; reference: aggregator.rs:2461-2757)

    async def handle_create_collection_job(
        self,
        task_id: TaskId,
        collection_job_id: CollectionJobId,
        body: bytes,
        auth_token: Optional[AuthenticationToken],
    ) -> None:
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        if task.role != Role.LEADER:
            raise UnrecognizedTask("collection on non-leader")
        ta.check_collector_auth(auth_token)
        req = CollectionReq.get_decoded(body, ta.query_class)
        strategy = strategy_for(task)
        err = strategy.validate_query(task, req.query)
        if err is not None:
            raise BatchInvalid(err)

        # Trace mint point: the collection pipeline (readiness polls,
        # journal replays, helper share exchange) joins on this id.
        # Resolved OUTSIDE the tx closure — contextvars do not cross the
        # datastore's executor thread.
        from ..core.trace import current_trace, new_trace_id

        trace_id = current_trace().get("trace_id") or new_trace_id()

        def tx_fn(tx):
            existing = tx.get_collection_job(
                task_id, collection_job_id, task.query_type.kind
            )
            if existing is not None:
                if (
                    existing.query == req.query
                    and existing.aggregation_parameter == req.aggregation_parameter
                ):
                    return  # idempotent re-PUT
                raise ForbiddenMutation("collection job mutated")

            if task.query_type.kind == "TimeInterval":
                ident = req.query.query_body.get_encoded()
                # batch overlap check (reference: batch queried at most once)
                for other in tx.get_collection_jobs_by_batch_identifier(
                    task_id, ident, task.query_type.kind
                ):
                    if other.aggregation_parameter == req.aggregation_parameter:
                        raise BatchQueriedTooManyTimes("batch already queried")
            else:
                fsq: FixedSizeQuery = req.query.query_body
                if fsq.variant == FixedSizeQuery.BY_BATCH_ID:
                    batch_id = fsq.batch_id
                    for other in tx.get_collection_jobs_by_batch_identifier(
                        task_id, batch_id.get_encoded(), task.query_type.kind
                    ):
                        if other.aggregation_parameter == req.aggregation_parameter:
                            raise BatchQueriedTooManyTimes("batch already queried")
                else:  # current batch
                    batch_id = tx.acquire_filled_outstanding_batch(
                        task_id, task.min_batch_size
                    )
                    if batch_id is None:
                        raise InvalidBatchSize("no batch ready for collection")
                ident = batch_id.get_encoded()

            tx.put_collection_job(
                CollectionJob(
                    task_id=task_id,
                    collection_job_id=collection_job_id,
                    query=req.query,
                    aggregation_parameter=req.aggregation_parameter,
                    batch_identifier=ident,
                    state=CollectionJobState.START,
                    trace_id=trace_id,
                )
            )
            if getattr(ta.vdaf, "REQUIRES_AGG_PARAM", False):
                # Aggregation-parameter VDAFs (Poplar1): the collection
                # request IS what names the parameter, so aggregation jobs
                # are created here, re-reading the (never scrubbed) client
                # reports for each level (the reference gates the analogous
                # path behind test-util, aggregation_job_creator.rs:741).
                self._create_agg_param_jobs(tx, ta, ident, req.aggregation_parameter, trace_id=trace_id)

        await self.datastore.run_tx_async("create_collection_job", tx_fn)

    def _create_agg_param_jobs(
        self,
        tx,
        ta: TaskAggregator,
        collection_identifier: bytes,
        agg_param: bytes,
        trace_id: Optional[str] = None,
    ) -> None:
        """Create aggregation jobs for one (batch, aggregation parameter):
        the interval's reports not yet aggregated at this level, in jobs
        of ``max_agg_param_job_size``."""
        task = ta.task
        if task.query_type.kind != "TimeInterval":
            raise BatchInvalid("aggregation-parameter VDAFs support TimeInterval tasks")
        interval = Interval.get_decoded(collection_identifier)
        reports = tx.get_client_reports_for_interval(task.task_id, interval, 50000)
        if not reports:
            return
        conflict_key = ta.vdaf.agg_param_conflict_key(agg_param)
        writer = AggregationJobWriter(
            task,
            ta.vdaf,
            batch_aggregation_shard_count=self.config.batch_aggregation_shard_count,
            initial_write=True,
            backend=ta.backend,
        )
        params_by_report = tx.get_aggregation_params_by_report_for_interval(task.task_id, interval)
        fresh = []
        for report in reports:
            params = params_by_report.get(report.report_id.data, [])
            if any(ta.vdaf.agg_param_conflict_key(p) == conflict_key for p in params):
                continue  # already aggregated at this level
            fresh.append(report)
        job_size = max(1, self.config.max_agg_param_job_size)
        for i in range(0, len(fresh), job_size):
            chunk = fresh[i : i + job_size]
            job_id = AggregationJobId.random()
            start = min(r.time.seconds for r in chunk)
            end = max(r.time.seconds for r in chunk) + 1
            job = AggregationJob(
                task_id=task.task_id,
                aggregation_job_id=job_id,
                aggregation_parameter=agg_param,
                partial_batch_identifier=None,
                client_timestamp_interval=Interval(Time(start), Duration(end - start)),
                state=AggregationJobState.IN_PROGRESS,
                step=AggregationJobStep(0),
                # collection-driven jobs inherit the collection's trace id
                trace_id=trace_id,
            )
            ras = [
                ReportAggregation(
                    task_id=task.task_id,
                    aggregation_job_id=job_id,
                    report_id=r.report_id,
                    time=r.time,
                    ord=ord_,
                    state=ReportAggregationState.START_LEADER,
                    public_share=r.public_share,
                    leader_extensions=r.leader_extensions,
                    leader_input_share=r.leader_input_share,
                    helper_encrypted_input_share=r.helper_encrypted_input_share,
                )
                for ord_, r in enumerate(chunk)
            ]
            writer.put(job, ras)
        writer.write(tx)

    async def handle_get_collection_job(
        self,
        task_id: TaskId,
        collection_job_id: CollectionJobId,
        auth_token: Optional[AuthenticationToken],
    ) -> Optional[Collection]:
        """Returns the Collection when finished, None when still running
        (HTTP layer turns None into 202 + Retry-After)."""
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        ta.check_collector_auth(auth_token)
        job = await self.datastore.run_tx_async(
            "get_collection_job",
            lambda tx: tx.get_collection_job(
                task_id, collection_job_id, task.query_type.kind
            ),
        )
        if job is None:
            raise UnrecognizedCollectionJob(str(collection_job_id))
        if job.state == CollectionJobState.START:
            return None
        if job.state == CollectionJobState.DELETED:
            raise DeletedCollectionJob("collection job deleted")
        if job.state == CollectionJobState.ABANDONED:
            raise AggregatorError("collection job abandoned")

        # Finished: seal the leader share to the collector
        # (reference: aggregator.rs:2648-2757).
        if task.query_type.kind == "TimeInterval":
            batch_selector = BatchSelector.new_time_interval(
                Interval.get_decoded(job.batch_identifier)
            )
            pbs = PartialBatchSelector.new_time_interval()
        else:
            batch_selector = BatchSelector.new_fixed_size(
                BatchId.get_decoded(job.batch_identifier)
            )
            pbs = PartialBatchSelector.new_fixed_size(
                BatchId.get_decoded(job.batch_identifier)
            )
        aad = AggregateShareAad(
            task_id, job.aggregation_parameter, batch_selector
        ).get_encoded()
        leader_encrypted = seal(
            task.collector_hpke_config,
            HpkeApplicationInfo.new(Label.AGGREGATE_SHARE, Role.LEADER, Role.COLLECTOR),
            job.leader_aggregate_share,
            aad,
        )
        return Collection(
            partial_batch_selector=pbs,
            report_count=job.report_count,
            interval=job.client_timestamp_interval,
            leader_encrypted_agg_share=leader_encrypted,
            helper_encrypted_agg_share=job.helper_aggregate_share,
        )

    async def handle_delete_collection_job(
        self,
        task_id: TaskId,
        collection_job_id: CollectionJobId,
        auth_token: Optional[AuthenticationToken],
    ) -> None:
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        ta.check_collector_auth(auth_token)

        def tx_fn(tx):
            job = tx.get_collection_job(task_id, collection_job_id, task.query_type.kind)
            if job is None:
                raise UnrecognizedCollectionJob(str(collection_job_id))
            if job.state != CollectionJobState.DELETED:
                tx.update_collection_job(job.with_state(CollectionJobState.DELETED))

        await self.datastore.run_tx_async("delete_collection_job", tx_fn)

    # ------------------------------------------------------------------
    # helper aggregate share (reference: aggregator.rs:2878 handle_aggregate_share_generic)

    async def handle_aggregate_share(
        self,
        task_id: TaskId,
        body: bytes,
        auth_token: Optional[AuthenticationToken],
    ) -> AggregateShare:
        ta = await self.task_aggregator_for(task_id)
        task = ta.task
        if task.role != Role.HELPER:
            raise UnrecognizedTask("aggregate-share on non-helper")
        ta.check_aggregator_auth(auth_token)
        req = AggregateShareReq.get_decoded(body, ta.query_class)
        strategy = strategy_for(task)
        ident = req.batch_selector.batch_identifier.get_encoded()

        # Deferred-drain barrier: resident helper buckets drain and
        # outstanding journal rows replay BEFORE the share is computed.
        if getattr(ta.vdaf, "REQUIRES_AGG_PARAM", False):
            try:
                await self._flush_helper_deferred(ta, ident, req.aggregation_parameter)
            except Exception:
                # a failed drain leaves rows journaled: the share below
                # would under-count, so the request fails and the leader
                # retries
                logger.exception("helper deferred flush failed")
                raise AggregatorError("deferred share flush failed")

        def tx_fn(tx):
            cached = tx.get_aggregate_share_job(
                task_id, ident, req.aggregation_parameter
            )
            if cached is not None:
                if (
                    cached.report_count != req.report_count
                    or cached.checksum.data != req.checksum.data
                ):
                    raise BatchMismatch("cached aggregate share mismatch")
                return cached.helper_aggregate_share, None

            share, count, checksum, _interval = compute_aggregate_share(
                task, ta.vdaf, tx, ident, req.aggregation_parameter
            )
            # cross-aggregator consistency checks (reference: aggregate_share.rs:21-118)
            if count != req.report_count or checksum.data != req.checksum.data:
                raise BatchMismatch(
                    f"count/checksum mismatch: {count} vs {req.report_count}"
                )
            if count < task.min_batch_size:
                raise InvalidBatchSize(f"batch too small: {count}")
            if share is None:
                raise InvalidBatchSize("empty batch")
            return None, (share, count, checksum)

        encoded_share, computed = await self.datastore.run_tx_async(
            "aggregate_share", tx_fn
        )
        if computed is not None:
            share, count, checksum = computed
            # Helper-side DP noise (reference: aggregator.rs:3005
            # add_noise_to_agg_share): the helper noises its share
            # independently of the leader so the zCDP guarantee holds
            # against a collector colluding with either aggregator.  The
            # exact-rational sampler runs OUTSIDE any transaction (it can
            # take seconds on wide shares) and off the event loop.
            field = ta.vdaf.field_for_agg_param(
                ta.vdaf.decode_agg_param(req.aggregation_parameter)
            )
            strategy_dp = dp_strategy_from_dict(task.vdaf.get("dp_strategy"))
            encoded_share = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: field.encode_vec(
                    strategy_dp.add_noise_to_agg_share(ta.vdaf, share, count)
                ),
            )

            def tx_store(tx):
                # Re-check the cache: a concurrent request may have stored
                # its (differently-noised) job first — serve THAT share so
                # repeated requests stay byte-identical.
                cached = tx.get_aggregate_share_job(
                    task_id, ident, req.aggregation_parameter
                )
                if cached is not None:
                    if (
                        cached.report_count != req.report_count
                        or cached.checksum.data != req.checksum.data
                    ):
                        raise BatchMismatch("cached aggregate share mismatch")
                    return cached.helper_aggregate_share
                tx.put_aggregate_share_job(
                    AggregateShareJob(
                        task_id=task_id,
                        batch_identifier=ident,
                        aggregation_parameter=req.aggregation_parameter,
                        helper_aggregate_share=encoded_share,
                        report_count=count,
                        checksum=checksum,
                    )
                )
                # Scrub contributing batch aggregations ATOMICALLY with the
                # job insert (reference: :2878-3123): if this transaction
                # fails, the un-scrubbed aggregations still support a clean
                # retry; once it commits, every later request is served
                # from the cache and never recomputes over scrubbed rows.
                for bident in strategy.batch_identifiers_for_collection_identifier(
                    task, ident
                ):
                    for ba in tx.get_batch_aggregations_for_batch(
                        task_id, bident, req.aggregation_parameter
                    ):
                        if ba.state == BatchAggregationState.AGGREGATING:
                            tx.update_batch_aggregation(ba.scrubbed())
                return encoded_share

            encoded_share = await self.datastore.run_tx_async(
                "aggregate_share_store", tx_store
            )
        aad = AggregateShareAad(
            task_id, req.aggregation_parameter, req.batch_selector
        ).get_encoded()
        encrypted = seal(
            task.collector_hpke_config,
            HpkeApplicationInfo.new(Label.AGGREGATE_SHARE, Role.HELPER, Role.COLLECTOR),
            encoded_share,
            aad,
        )
        return AggregateShare(encrypted)


def _check_extensions(extensions) -> None:
    """Duplicate extension types are rejected (reference: aggregator.rs upload
    and init validation)."""
    seen = set()
    for ext in extensions:
        if ext.extension_type in seen:
            raise InvalidMessage("duplicate extension")
        seen.add(ext.extension_type)
