"""Aggregator task model.

The analog of the reference's ``AggregatorTask`` + ``AggregatorTaskParameters``
(reference: aggregator_core/src/task.rs:211,520) and the task-level query-type
config (task.rs:36).  A task is the unit of configuration shared (out of band)
between the two aggregators: VDAF instance, verify key, HPKE keys, auth
tokens, batch/time parameters.
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

from ..core.auth_tokens import AuthenticationToken, AuthenticationTokenHash
from ..core.hpke import HpkeKeypair
from ..messages import Duration, HpkeConfig, Role, TaskId, Time
from ..vdaf.instances import vdaf_from_instance


@dataclass(frozen=True)
class TaskQueryType:
    """Task-level query type (reference: aggregator_core/src/task.rs:36).

    ``kind`` is "TimeInterval" or "FixedSize"; FixedSize carries an optional
    ``max_batch_size`` and optional ``batch_time_window_size`` (seconds).
    """

    kind: str
    max_batch_size: Optional[int] = None
    batch_time_window_size: Optional[Duration] = None

    def __post_init__(self):
        if self.kind not in ("TimeInterval", "FixedSize"):
            raise ValueError(f"unknown query type {self.kind!r}")
        if self.kind == "TimeInterval" and self.max_batch_size is not None:
            raise ValueError("TimeInterval takes no max_batch_size")

    def to_json(self) -> str:
        d: Dict[str, Any] = {"kind": self.kind}
        if self.max_batch_size is not None:
            d["max_batch_size"] = self.max_batch_size
        if self.batch_time_window_size is not None:
            d["batch_time_window_size"] = self.batch_time_window_size.seconds
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TaskQueryType":
        d = json.loads(s)
        btws = d.get("batch_time_window_size")
        return cls(
            kind=d["kind"],
            max_batch_size=d.get("max_batch_size"),
            batch_time_window_size=Duration(btws) if btws is not None else None,
        )

    @classmethod
    def time_interval(cls) -> "TaskQueryType":
        return cls("TimeInterval")

    @classmethod
    def fixed_size(
        cls,
        max_batch_size: Optional[int] = None,
        batch_time_window_size: Optional[Duration] = None,
    ) -> "TaskQueryType":
        return cls("FixedSize", max_batch_size, batch_time_window_size)


@dataclass(frozen=True)
class AggregatorTask:
    """One aggregator's view of a DAP task
    (reference: aggregator_core/src/task.rs:211).
    """

    task_id: TaskId
    peer_aggregator_endpoint: str
    query_type: TaskQueryType
    vdaf: Dict[str, Any]  # serialized VdafInstance description
    role: Role
    # Secret hygiene: never in logs (reference: aggregator_core/src/lib.rs:28).
    vdaf_verify_key: bytes = field(repr=False)
    min_batch_size: int
    time_precision: Duration
    task_expiration: Optional[Time] = None
    report_expiry_age: Optional[Duration] = None
    tolerable_clock_skew: Duration = Duration(60)
    # Leader: token used to authenticate to the helper.  Helper: hash used to
    # check the leader's token (reference task.rs:520 role-specific params).
    aggregator_auth_token: Optional[AuthenticationToken] = None
    aggregator_auth_token_hash: Optional[AuthenticationTokenHash] = None
    # Leader only: hash of the collector's token.
    collector_auth_token_hash: Optional[AuthenticationTokenHash] = None
    collector_hpke_config: Optional[HpkeConfig] = None
    hpke_keys: List[HpkeKeypair] = field(default_factory=list)

    def __post_init__(self):
        if not self.role.is_aggregator():
            raise ValueError("task role must be Leader or Helper")
        if self.min_batch_size < 1:
            raise ValueError("min_batch_size must be positive")
        if self.time_precision.seconds <= 0:
            raise ValueError("time_precision must be positive")
        expected = vdaf_verify_key_length(self.vdaf)
        if len(self.vdaf_verify_key) != expected:
            raise ValueError(
                f"verify key must be {expected} bytes for {self.vdaf.get('type')}"
            )

    # -- VDAF -----------------------------------------------------------
    def vdaf_instance(self):
        return vdaf_from_instance(self.vdaf)

    # -- HPKE -----------------------------------------------------------
    def hpke_keypair_for(self, config_id: int) -> Optional[HpkeKeypair]:
        for kp in self.hpke_keys:
            if kp.config.id == config_id:
                return kp
        return None

    def current_hpke_keypair(self) -> HpkeKeypair:
        if not self.hpke_keys:
            raise ValueError("task has no HPKE keys")
        return max(self.hpke_keys, key=lambda kp: kp.config.id)

    def with_hpke_keys(self, keys: List[HpkeKeypair]) -> "AggregatorTask":
        return replace(self, hpke_keys=list(keys))


def vdaf_verify_key_length(vdaf: Dict[str, Any]) -> int:
    """Verify-key size for a serialized VDAF instance
    (reference: core/src/vdaf.rs:16,24 via task.rs VerifyKey<SEED_SIZE>)."""
    if vdaf.get("type") == "Prio3SumVecField64MultiproofHmacSha256Aes128":
        return 32
    return 16


def generate_vdaf_verify_key(vdaf: Dict[str, Any]) -> bytes:
    return secrets.token_bytes(vdaf_verify_key_length(vdaf))


def validate_vdaf_instance(vdaf: Dict[str, Any]) -> None:
    """Raise ValueError if the instance description is unknown/invalid."""
    vdaf_from_instance(vdaf)
