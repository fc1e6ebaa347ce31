"""Datastore models and state machines.

The analog of the reference's ``aggregator_core/src/datastore/models.rs``:
every protocol step persists one of these state machines, which is what makes
the database the checkpoint — any process can die at any point and another
resumes from the stored state (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import enum
import secrets
from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Tuple

from ..messages import (
    AggregationJobId,
    AggregationJobStep,
    BatchId,
    CollectionJobId,
    Duration,
    Extension,
    HpkeCiphertext,
    HpkeConfig,
    Interval,
    PrepareError,
    PrepareResp,
    Query,
    ReportId,
    ReportIdChecksum,
    ReportMetadata,
    TaskId,
    Time,
)


# --------------------------------------------------------------------------
# Client reports


@dataclass(frozen=True)
class LeaderStoredReport:
    """A decrypted, validated report stored by the leader
    (reference: models.rs:103)."""

    task_id: TaskId
    metadata: ReportMetadata
    public_share: bytes  # encoded VDAF public share
    leader_extensions: List[Extension]
    leader_input_share: bytes  # encoded plaintext leader input share
    helper_encrypted_input_share: HpkeCiphertext
    #: 32-hex upload trace id (core/trace.py): adopted from the
    #: client's strict-hex ``traceparent`` or minted at upload; persisted
    #: so aggregation-job creation can link jobs back to client ingress.
    trace_id: Optional[str] = None

    @property
    def report_id(self) -> ReportId:
        return self.metadata.report_id

    @property
    def time(self) -> Time:
        return self.metadata.time


# --------------------------------------------------------------------------
# Aggregation jobs


class AggregationJobState(str, enum.Enum):
    """reference: models.rs:513"""

    IN_PROGRESS = "InProgress"
    FINISHED = "Finished"
    ABANDONED = "Abandoned"
    DELETED = "Deleted"


@dataclass(frozen=True)
class AggregationJob:
    """reference: models.rs:359"""

    task_id: TaskId
    aggregation_job_id: AggregationJobId
    aggregation_parameter: bytes
    # Fixed-size tasks: the batch this job contributes to; TimeInterval: None
    # (the partial batch identifier is ()).
    partial_batch_identifier: Optional[BatchId]
    client_timestamp_interval: Interval
    state: AggregationJobState
    step: AggregationJobStep
    last_request_hash: Optional[bytes] = None
    #: 32-hex cross-process trace id (core/trace.py): minted at creation on
    #: the leader, inherited from the peer's traceparent on the helper.
    trace_id: Optional[str] = None

    def with_state(self, state: AggregationJobState) -> "AggregationJob":
        return replace(self, state=state)

    def with_step(self, step: AggregationJobStep) -> "AggregationJob":
        return replace(self, step=step)

    def with_last_request_hash(self, h: bytes) -> "AggregationJob":
        return replace(self, last_request_hash=h)


# --------------------------------------------------------------------------
# Leases


@dataclass(frozen=True)
class LeaseToken:
    """Random token fencing lease ownership (reference: models.rs:526)."""

    data: bytes

    @classmethod
    def random(cls) -> "LeaseToken":
        return cls(secrets.token_bytes(16))


@dataclass(frozen=True)
class Lease:
    """An acquired lease on a job (reference: models.rs:~600)."""

    leased: Any  # AcquiredAggregationJob | AcquiredCollectionJob
    lease_expiry: Time
    lease_token: LeaseToken
    lease_attempts: int


@dataclass(frozen=True)
class AcquiredAggregationJob:
    """reference: models.rs:635"""

    task_id: TaskId
    aggregation_job_id: AggregationJobId
    query_type: str
    vdaf: dict
    #: persisted trace id, bound by the stepping driver (core/trace.py)
    trace_id: Optional[str] = None
    #: created_at -> acquire, for janus_job_age_at_acquire_seconds
    age_seconds: float = 0.0


@dataclass(frozen=True)
class AcquiredCollectionJob:
    """reference: models.rs:681"""

    task_id: TaskId
    collection_job_id: CollectionJobId
    query_type: str
    vdaf: dict
    step_attempts: int
    trace_id: Optional[str] = None
    age_seconds: float = 0.0


# --------------------------------------------------------------------------
# Report aggregations


class ReportAggregationState(str, enum.Enum):
    """reference: models.rs:898"""

    START_LEADER = "StartLeader"
    WAITING_LEADER = "WaitingLeader"
    WAITING_HELPER = "WaitingHelper"
    FINISHED = "Finished"
    FAILED = "Failed"


@dataclass(frozen=True)
class ReportAggregation:
    """Per-report progress through one aggregation job
    (reference: models.rs:769).  State-specific payloads:

    - StartLeader: the full unaggregated report data (public share,
      extensions, leader input share, helper encrypted share).
    - WaitingLeader: the serialized ping-pong transition to evaluate when the
      helper's response arrives.
    - WaitingHelper: the helper's serialized prepare state.
    - Failed: the PrepareError.
    """

    task_id: TaskId
    aggregation_job_id: AggregationJobId
    report_id: ReportId
    time: Time
    ord: int
    state: ReportAggregationState
    last_prep_resp: Optional[PrepareResp] = None
    # StartLeader payload:
    public_share: Optional[bytes] = None
    leader_extensions: List[Extension] = field(default_factory=list)
    leader_input_share: Optional[bytes] = None
    helper_encrypted_input_share: Optional[HpkeCiphertext] = None
    # WaitingLeader payload:
    leader_prep_transition: Optional[bytes] = None
    # WaitingHelper payload:
    helper_prep_state: Optional[bytes] = None
    # Failed payload:
    error: Optional[PrepareError] = None

    def with_state(self, state: ReportAggregationState, **payload) -> "ReportAggregation":
        cleared = dict(
            public_share=None,
            leader_extensions=[],
            leader_input_share=None,
            helper_encrypted_input_share=None,
            leader_prep_transition=None,
            helper_prep_state=None,
            error=None,
        )
        cleared.update(payload)
        return replace(self, state=state, **cleared)

    def failed(self, error: PrepareError) -> "ReportAggregation":
        return self.with_state(ReportAggregationState.FAILED, error=error)

    def with_last_prep_resp(self, resp: Optional[PrepareResp]) -> "ReportAggregation":
        return replace(self, last_prep_resp=resp)


@dataclass(frozen=True)
class ReportAggregationMetadata:
    """Creation-time view without VDAF payloads (reference: models.rs:1116) —
    used by the aggregation job creator, which never touches share data."""

    task_id: TaskId
    aggregation_job_id: AggregationJobId
    report_id: ReportId
    time: Time
    ord: int


# --------------------------------------------------------------------------
# Batch aggregations (sharded accumulators)


class BatchAggregationState(str, enum.Enum):
    """reference: models.rs:1421"""

    AGGREGATING = "Aggregating"
    COLLECTED = "Collected"
    SCRUBBED = "Scrubbed"


@dataclass(frozen=True)
class BatchAggregation:
    """One shard of a batch's accumulated aggregate share
    (reference: models.rs:1195).  ``batch_identifier`` is the encoded
    Interval (TimeInterval) or BatchId (FixedSize)."""

    task_id: TaskId
    batch_identifier: bytes
    aggregation_parameter: bytes
    ord: int
    state: BatchAggregationState
    aggregate_share: Optional[bytes]  # encoded field vector, None if empty
    report_count: int
    checksum: ReportIdChecksum
    client_timestamp_interval: Interval
    aggregation_jobs_created: int
    aggregation_jobs_terminated: int

    def scrubbed(self) -> "BatchAggregation":
        return replace(
            self,
            state=BatchAggregationState.SCRUBBED,
            aggregate_share=None,
            report_count=0,
            checksum=ReportIdChecksum.zero(),
        )


# --------------------------------------------------------------------------
# Collection jobs


class CollectionJobState(str, enum.Enum):
    """reference: models.rs:1778"""

    START = "Start"
    FINISHED = "Finished"
    ABANDONED = "Abandoned"
    DELETED = "Deleted"


@dataclass(frozen=True)
class CollectionJob:
    """reference: models.rs:1651"""

    task_id: TaskId
    collection_job_id: CollectionJobId
    query: Query
    aggregation_parameter: bytes
    batch_identifier: bytes  # encoded Interval or BatchId
    state: CollectionJobState
    report_count: Optional[int] = None
    client_timestamp_interval: Optional[Interval] = None
    leader_aggregate_share: Optional[bytes] = None  # encoded field vector
    helper_aggregate_share: Optional[HpkeCiphertext] = None
    #: 32-hex cross-process trace id minted at collection-job creation
    trace_id: Optional[str] = None

    def finished(
        self,
        report_count: int,
        client_timestamp_interval: Interval,
        leader_aggregate_share: bytes,
        helper_aggregate_share: HpkeCiphertext,
    ) -> "CollectionJob":
        return replace(
            self,
            state=CollectionJobState.FINISHED,
            report_count=report_count,
            client_timestamp_interval=client_timestamp_interval,
            leader_aggregate_share=leader_aggregate_share,
            helper_aggregate_share=helper_aggregate_share,
        )

    def with_state(self, state: CollectionJobState) -> "CollectionJob":
        return replace(self, state=state)


# --------------------------------------------------------------------------
# Aggregate share jobs (helper-side collection cache)


@dataclass(frozen=True)
class AggregateShareJob:
    """reference: models.rs:1883"""

    task_id: TaskId
    batch_identifier: bytes
    aggregation_parameter: bytes
    helper_aggregate_share: bytes  # encoded field vector (plaintext)
    report_count: int
    checksum: ReportIdChecksum


# --------------------------------------------------------------------------
# Outstanding batches (fixed-size filling)


@dataclass(frozen=True)
class OutstandingBatch:
    """reference: models.rs:2008"""

    task_id: TaskId
    batch_id: BatchId
    time_bucket_start: Optional[Time]
    # inclusive range of possible report counts given current aggregations
    size_min: int = 0
    size_max: int = 0


# --------------------------------------------------------------------------
# Global HPKE keys


class HpkeKeyState(str, enum.Enum):
    """reference: models.rs:2186"""

    PENDING = "Pending"
    ACTIVE = "Active"
    EXPIRED = "Expired"


@dataclass(frozen=True)
class GlobalHpkeKeypair:
    config: HpkeConfig
    private_key: bytes
    state: HpkeKeyState
    updated_at: Time


# --------------------------------------------------------------------------
# Upload counters


@dataclass(frozen=True)
class TaskUploadCounter:
    """Sharded per-task upload outcome counters (reference: models.rs:2234)."""

    task_id: TaskId
    interval_collected: int = 0
    report_decode_failure: int = 0
    report_decrypt_failure: int = 0
    report_expired: int = 0
    report_outdated_key: int = 0
    report_success: int = 0
    report_too_early: int = 0
    task_expired: int = 0

    COLUMNS = (
        "interval_collected",
        "report_decode_failure",
        "report_decrypt_failure",
        "report_expired",
        "report_outdated_key",
        "report_success",
        "report_too_early",
        "task_expired",
    )


# --------------------------------------------------------------------------
# Accumulator journal (deferred device-resident drains)


@dataclass(frozen=True)
class AccumulatorJournalEntry:
    """One aggregation job's contribution to a device-resident accumulator
    bucket that has not been drained into ``batch_aggregations`` yet.

    Persisted in the same transaction that records the reports Finished
    (aggregation_job_writer.py), so after a process death the surviving
    replicas can enumerate exactly which counted reports still lack their
    share merge and re-derive them on the bit-exact CPU oracle from the
    retained ``report_aggregations`` payloads (collection_job_driver.py
    replay path)."""

    task_id: TaskId
    batch_identifier: bytes
    aggregation_parameter: bytes
    aggregation_job_id: AggregationJobId
    report_ids: Tuple[bytes, ...]
    created_at: Time
    #: the owning accumulator's drain cadence (None: a pre-migration row)
    drain_interval_s: Optional[float] = None


# --------------------------------------------------------------------------
# Fleet control plane membership (core/fleet.py)


@dataclass(frozen=True)
class FleetMember:
    """One registered driver replica's membership row (fleet_members).

    A member is *live* iff ``now - heartbeat <= heartbeat_ttl``; the live
    set of a role is the rendezvous-hash domain routing task_id -> replica
    for that job type.  ``suspect_peers`` is the fleet-shared suspect set:
    the peer origins this replica's in-memory health tracker currently
    holds SUSPECT, JSON-encoded, refreshed (or emptied on heal) with every
    heartbeat; ``suspect_updated_at`` bounds how stale a consumer will
    honor that advertisement."""

    replica_id: str
    role: str
    heartbeat: Time
    started_at: Time
    suspect_peers: Tuple[str, ...] = ()
    suspect_updated_at: Optional[Time] = None

    def heartbeat_age(self, now: Time) -> int:
        return max(0, now.seconds - self.heartbeat.seconds)
