"""Taskprov: in-band task provisioning.

The analog of the reference's taskprov support (reference:
aggregator_core/src/taskprov.rs:17,97; aggregator.rs:722 opt-in): a client
or peer advertises an encoded ``TaskConfig`` (dap-taskprov header); the
aggregator derives the task id as SHA-256 of the encoded config, checks the
advertising peer is a configured ``PeerAggregator``, derives the VDAF verify
key from the peer's ``verify_key_init``, and provisions the task on the fly.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.auth_tokens import AuthenticationToken, AuthenticationTokenHash
from ..core.hpke import HpkeKeypair
from ..datastore.task import AggregatorTask, TaskQueryType, vdaf_verify_key_length
from ..messages import Duration, HpkeConfig, Role, TaskId, Time
from ..messages.taskprov import TaskConfig, TaskprovQuery
from ..xof import XofTurboShake128


@dataclass(frozen=True)
class PeerAggregator:
    """Pre-shared configuration for a taskprov peer
    (reference: aggregator_core/src/taskprov.rs:97)."""

    endpoint: str
    role: Role  # the PEER's role
    # Secret hygiene: VerifyKeyInit seeds every task's verify key — never in
    # logs (reference: aggregator_core/src/taskprov.rs:17 wraps it in a
    # Debug-redacting newtype).
    verify_key_init: bytes = field(repr=False)  # 32 bytes
    collector_hpke_config: HpkeConfig
    report_expiry_age: Optional[Duration] = None
    tolerable_clock_skew: Duration = Duration(60)
    aggregator_auth_token: Optional[AuthenticationToken] = None
    aggregator_auth_token_hash: Optional[AuthenticationTokenHash] = None
    collector_auth_token_hash: Optional[AuthenticationTokenHash] = None


def taskprov_task_id(encoded_task_config: bytes) -> TaskId:
    """task_id = SHA-256(TaskConfig) (draft-wang-ppm-dap-taskprov)."""
    return TaskId(hashlib.sha256(encoded_task_config).digest())


def derive_vdaf_verify_key(
    verify_key_init: bytes, task_id: TaskId, length: int
) -> bytes:
    """Per-task verify key from the peer's VerifyKeyInit
    (reference: aggregator_core/src/taskprov.rs:17 VerifyKeyInit).

    All 32 bytes of the init feed the derivation (as the binder, with a
    fixed all-zero XOF seed), so the full keyspace is preserved.
    """
    if len(verify_key_init) != 32:
        raise ValueError("verify_key_init must be 32 bytes")
    return XofTurboShake128(
        b"\x00" * 16, b"dap-taskprov verify key", verify_key_init + task_id.data
    ).next(length)


def taskprov_task(
    encoded_task_config: bytes,
    peer: PeerAggregator,
    own_role: Role,
    hpke_keys: List[HpkeKeypair],
    config: Optional[TaskConfig] = None,
) -> AggregatorTask:
    """Build the AggregatorTask a taskprov advertisement describes."""
    if config is None:
        config = TaskConfig.get_decoded(encoded_task_config)
    task_id = taskprov_task_id(encoded_task_config)
    q = config.query_config
    if q.query.variant == TaskprovQuery.TIME_INTERVAL:
        query_type = TaskQueryType.time_interval()
    elif q.query.variant == TaskprovQuery.FIXED_SIZE:
        query_type = TaskQueryType.fixed_size(max_batch_size=q.query.max_batch_size)
    else:
        raise ValueError("reserved taskprov query type")
    vdaf = config.vdaf_config.vdaf_type.to_instance()
    return AggregatorTask(
        task_id=task_id,
        peer_aggregator_endpoint=peer.endpoint,
        query_type=query_type,
        vdaf=vdaf,
        role=own_role,
        vdaf_verify_key=derive_vdaf_verify_key(
            peer.verify_key_init, task_id, vdaf_verify_key_length(vdaf)
        ),
        min_batch_size=q.min_batch_size,
        time_precision=q.time_precision,
        task_expiration=config.task_expiration,
        report_expiry_age=peer.report_expiry_age,
        tolerable_clock_skew=peer.tolerable_clock_skew,
        aggregator_auth_token=peer.aggregator_auth_token,
        aggregator_auth_token_hash=peer.aggregator_auth_token_hash,
        collector_auth_token_hash=peer.collector_auth_token_hash,
        collector_hpke_config=peer.collector_hpke_config,
        hpke_keys=hpke_keys,
    )
