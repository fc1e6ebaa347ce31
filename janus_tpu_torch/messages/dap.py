"""DAP wire messages (draft-ietf-ppm-dap-09), byte-compatible with the
reference's ``janus_messages`` crate (reference: messages/src/lib.rs).

Every type carries its reference location in the docstring so parity can be
checked; encodings are anchored to the reference's own test hex in
tests/test_messages.py.  Fixed-size IDs are raw bytes; varying payloads are
u16/u32 length-prefixed per TLS syntax.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import IntEnum
from typing import ClassVar, List, Optional, Type, Union

from ..vdaf.pingpong import PingPongMessage
from .codec import CodecError, Decoder, Encoder, Message


def _b64url(data: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    import base64

    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


class _FixedId(Message):
    """Fixed-length opaque identifier (TaskId, ReportId, BatchId, ...)."""

    LEN: ClassVar[int]

    def __init__(self, data: bytes):
        if len(data) != self.LEN:
            raise ValueError(f"{type(self).__name__} must be {self.LEN} bytes")
        self._data = bytes(data)

    @classmethod
    def random(cls):
        return cls(os.urandom(cls.LEN))

    @property
    def data(self) -> bytes:
        return self._data

    def encode(self, w: Encoder) -> None:
        w.fixed(self._data, self.LEN)

    @classmethod
    def _decode(cls, r: Decoder):
        return cls(r.read(cls.LEN))

    @classmethod
    def from_str(cls, s: str):
        return cls(_unb64url(s))

    def __str__(self) -> str:
        return _b64url(self._data)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._data == other._data

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._data))

    def __lt__(self, other) -> bool:
        return self._data < other._data


class TaskId(_FixedId):
    """reference: messages/src/lib.rs:640"""

    LEN = 32


class BatchId(_FixedId):
    """reference: messages/src/lib.rs:286"""

    LEN = 32


class ReportId(_FixedId):
    """reference: messages/src/lib.rs:366"""

    LEN = 16


class ReportIdChecksum(_FixedId):
    """XOR-of-SHA256 checksum; reference: messages/src/lib.rs:446"""

    LEN = 32

    @classmethod
    def zero(cls) -> "ReportIdChecksum":
        return cls(bytes(cls.LEN))


class AggregationJobId(_FixedId):
    """reference: messages/src/lib.rs:2266"""

    LEN = 16


class CollectionJobId(_FixedId):
    """reference: messages/src/lib.rs:1674"""

    LEN = 16


class Duration(Message):
    """Seconds; u64 BE. reference: messages/src/lib.rs:132"""

    def __init__(self, seconds: int):
        self.seconds = int(seconds)

    ZERO: ClassVar["Duration"]

    @classmethod
    def from_seconds(cls, s: int) -> "Duration":
        return cls(s)

    def encode(self, w: Encoder) -> None:
        w.u64(self.seconds)

    @classmethod
    def _decode(cls, r: Decoder) -> "Duration":
        return cls(r.u64())

    def __eq__(self, o) -> bool:
        return isinstance(o, Duration) and self.seconds == o.seconds

    def __hash__(self):
        return hash(("Duration", self.seconds))

    def __repr__(self):
        return f"Duration({self.seconds})"


Duration.ZERO = Duration(0)


class Time(Message):
    """Seconds since epoch; u64 BE. reference: messages/src/lib.rs:172"""

    def __init__(self, seconds: int):
        self.seconds = int(seconds)

    def encode(self, w: Encoder) -> None:
        w.u64(self.seconds)

    @classmethod
    def _decode(cls, r: Decoder) -> "Time":
        return cls(r.u64())

    def __eq__(self, o) -> bool:
        return isinstance(o, Time) and self.seconds == o.seconds

    def __lt__(self, o) -> bool:
        return self.seconds < o.seconds

    def __le__(self, o) -> bool:
        return self.seconds <= o.seconds

    def __hash__(self):
        return hash(("Time", self.seconds))

    def __repr__(self):
        return f"Time({self.seconds})"


@dataclass(frozen=True)
class Interval(Message):
    """Half-open [start, start+duration). reference: messages/src/lib.rs:223"""

    start: Time
    duration: Duration

    def __post_init__(self):
        if self.start.seconds + self.duration.seconds >= 1 << 64:
            raise ValueError("interval end overflows Time")

    EMPTY: ClassVar["Interval"]

    def end(self) -> Time:
        return Time(self.start.seconds + self.duration.seconds)

    def contains(self, t: Time) -> bool:
        return self.start.seconds <= t.seconds < self.end().seconds

    def encode(self, w: Encoder) -> None:
        self.start.encode(w)
        self.duration.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "Interval":
        return cls(Time._decode(r), Duration._decode(r))


Interval.EMPTY = Interval(Time(0), Duration.ZERO)


class Url(Message):
    """u16-length-prefixed ASCII URL. reference: messages/src/lib.rs:56"""

    MAX_LEN = 2**16 - 1

    def __init__(self, url: Union[str, bytes]):
        raw = url.encode("ascii") if isinstance(url, str) else bytes(url)
        if not raw or len(raw) > self.MAX_LEN:
            raise ValueError("bad URL length")
        raw.decode("ascii")  # must be ASCII
        self.raw = raw

    def __str__(self) -> str:
        return self.raw.decode("ascii")

    def encode(self, w: Encoder) -> None:
        w.opaque_u16(self.raw)

    @classmethod
    def _decode(cls, r: Decoder) -> "Url":
        try:
            return cls(r.opaque_u16())
        except (ValueError, UnicodeDecodeError) as e:
            raise CodecError(f"bad URL: {e}")

    def __eq__(self, o):
        return isinstance(o, Url) and self.raw == o.raw

    def __hash__(self):
        return hash(("Url", self.raw))

    def __repr__(self):
        return f"Url({self})"


class Role(IntEnum):
    """reference: messages/src/lib.rs:516"""

    COLLECTOR = 0
    CLIENT = 1
    LEADER = 2
    HELPER = 3

    def is_aggregator(self) -> bool:
        return self in (Role.LEADER, Role.HELPER)

    def index(self) -> Optional[int]:
        return {Role.LEADER: 0, Role.HELPER: 1}.get(self)

    def encode(self, w: Encoder) -> None:
        w.u8(self.value)

    @classmethod
    def _decode(cls, r: Decoder) -> "Role":
        try:
            return cls(r.u8())
        except ValueError as e:
            raise CodecError(str(e))


# HPKE config ids are plain u8 ints on the wire (reference newtype:
# messages/src/lib.rs:596); the alias keeps the reference name importable.
HpkeConfigId = int


class HpkeKemId(IntEnum):
    """RFC 9180 KEM ids; reference: messages/src/lib.rs:770"""

    RESERVED = 0x0000
    P256_HKDF_SHA256 = 0x0010
    P384_HKDF_SHA384 = 0x0011
    P521_HKDF_SHA512 = 0x0012
    X25519_HKDF_SHA256 = 0x0020

    def encode(self, w: Encoder) -> None:
        w.u16(self.value)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeKemId":
        val = r.u16()
        try:
            return cls(val)
        except ValueError:
            raise CodecError(f"unknown HPKE KEM id {val:#06x}")


class HpkeKdfId(IntEnum):
    """reference: messages/src/lib.rs:809"""

    RESERVED = 0x0000
    HKDF_SHA256 = 0x0001
    HKDF_SHA384 = 0x0002
    HKDF_SHA512 = 0x0003

    def encode(self, w: Encoder) -> None:
        w.u16(self.value)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeKdfId":
        val = r.u16()
        try:
            return cls(val)
        except ValueError:
            raise CodecError(f"unknown HPKE KDF id {val:#06x}")


class HpkeAeadId(IntEnum):
    """reference: messages/src/lib.rs:844"""

    RESERVED = 0x0000
    AES_128_GCM = 0x0001
    AES_256_GCM = 0x0002
    CHACHA20_POLY1305 = 0x0003

    def encode(self, w: Encoder) -> None:
        w.u16(self.value)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeAeadId":
        val = r.u16()
        try:
            return cls(val)
        except ValueError:
            raise CodecError(f"unknown HPKE AEAD id {val:#06x}")


class ExtensionType(IntEnum):
    """reference: messages/src/lib.rs:928"""

    TBD = 0
    TASKPROV = 0xFF00


@dataclass(frozen=True)
class Extension(Message):
    """reference: messages/src/lib.rs:875"""

    extension_type: ExtensionType
    extension_data: bytes = b""

    def encode(self, w: Encoder) -> None:
        w.u16(self.extension_type.value)
        w.opaque_u16(self.extension_data)

    @classmethod
    def _decode(cls, r: Decoder) -> "Extension":
        try:
            ext_type = ExtensionType(r.u16())
        except ValueError as e:
            raise CodecError(str(e))
        return cls(ext_type, r.opaque_u16())


@dataclass(frozen=True)
class HpkeCiphertext(Message):
    """reference: messages/src/lib.rs:955"""

    config_id: int
    encapsulated_key: bytes
    payload: bytes

    def encode(self, w: Encoder) -> None:
        w.u8(self.config_id)
        w.opaque_u16(self.encapsulated_key)
        w.opaque_u32(self.payload)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeCiphertext":
        return cls(r.u8(), r.opaque_u16(), r.opaque_u32())


@dataclass(frozen=True)
class HpkePublicKey(Message):
    """reference: messages/src/lib.rs:1031"""

    raw: bytes

    def encode(self, w: Encoder) -> None:
        w.opaque_u16(self.raw)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkePublicKey":
        return cls(r.opaque_u16())


@dataclass(frozen=True)
class HpkeConfig(Message):
    """reference: messages/src/lib.rs:1127"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-hpke-config"

    id: int
    kem_id: HpkeKemId
    kdf_id: HpkeKdfId
    aead_id: HpkeAeadId
    public_key: HpkePublicKey

    def encode(self, w: Encoder) -> None:
        w.u8(self.id)
        self.kem_id.encode(w)
        self.kdf_id.encode(w)
        self.aead_id.encode(w)
        self.public_key.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeConfig":
        return cls(
            r.u8(),
            HpkeKemId._decode(r),
            HpkeKdfId._decode(r),
            HpkeAeadId._decode(r),
            HpkePublicKey._decode(r),
        )


@dataclass(frozen=True)
class HpkeConfigList(Message):
    """reference: messages/src/lib.rs:1219"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-hpke-config-list"

    hpke_configs: tuple

    def __init__(self, hpke_configs):
        object.__setattr__(self, "hpke_configs", tuple(hpke_configs))

    def encode(self, w: Encoder) -> None:
        w.items_u16(self.hpke_configs, lambda ww, c: c.encode(ww))

    @classmethod
    def _decode(cls, r: Decoder) -> "HpkeConfigList":
        return cls(r.items_u16(HpkeConfig._decode))


@dataclass(frozen=True)
class ReportMetadata(Message):
    """reference: messages/src/lib.rs:1257"""

    report_id: ReportId
    time: Time

    def encode(self, w: Encoder) -> None:
        self.report_id.encode(w)
        self.time.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "ReportMetadata":
        return cls(ReportId._decode(r), Time._decode(r))


@dataclass(frozen=True)
class PlaintextInputShare(Message):
    """reference: messages/src/lib.rs:1301"""

    extensions: tuple
    payload: bytes

    def __init__(self, extensions, payload: bytes):
        object.__setattr__(self, "extensions", tuple(extensions))
        object.__setattr__(self, "payload", bytes(payload))

    def encode(self, w: Encoder) -> None:
        w.items_u16(self.extensions, lambda ww, e: e.encode(ww))
        w.opaque_u32(self.payload)

    @classmethod
    def _decode(cls, r: Decoder) -> "PlaintextInputShare":
        return cls(r.items_u16(Extension._decode), r.opaque_u32())


@dataclass(frozen=True)
class Report(Message):
    """reference: messages/src/lib.rs:1357"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-report"

    metadata: ReportMetadata
    public_share: bytes
    leader_encrypted_input_share: HpkeCiphertext
    helper_encrypted_input_share: HpkeCiphertext

    def encode(self, w: Encoder) -> None:
        self.metadata.encode(w)
        w.opaque_u32(self.public_share)
        self.leader_encrypted_input_share.encode(w)
        self.helper_encrypted_input_share.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "Report":
        return cls(
            ReportMetadata._decode(r),
            r.opaque_u32(),
            HpkeCiphertext._decode(r),
            HpkeCiphertext._decode(r),
        )


@dataclass(frozen=True)
class InputShareAad(Message):
    """AAD for input-share encryption; reference: messages/src/lib.rs:1825"""

    task_id: TaskId
    metadata: ReportMetadata
    public_share: bytes

    def encode(self, w: Encoder) -> None:
        self.task_id.encode(w)
        self.metadata.encode(w)
        w.opaque_u32(self.public_share)

    @classmethod
    def _decode(cls, r: Decoder) -> "InputShareAad":
        return cls(TaskId._decode(r), ReportMetadata._decode(r), r.opaque_u32())


# ---------------------------------------------------------------------------
# Query types (reference: messages/src/query_type.rs)
# ---------------------------------------------------------------------------


class QueryCode(IntEnum):
    """reference: messages/src/query_type.rs:110"""

    RESERVED = 0
    TIME_INTERVAL = 1
    FIXED_SIZE = 2


class TimeInterval:
    """reference: messages/src/query_type.rs:66"""

    CODE = QueryCode.TIME_INTERVAL
    NAME = "TimeInterval"

    # BatchIdentifier = Interval; PartialBatchIdentifier = (); QueryBody = Interval
    @staticmethod
    def encode_batch_identifier(w: Encoder, ident: Interval) -> None:
        ident.encode(w)

    @staticmethod
    def decode_batch_identifier(r: Decoder) -> Interval:
        return Interval._decode(r)

    @staticmethod
    def encode_partial_batch_identifier(w: Encoder, ident) -> None:
        if ident is not None:
            raise CodecError("time-interval partial batch identifier is empty")

    @staticmethod
    def decode_partial_batch_identifier(r: Decoder):
        return None

    @staticmethod
    def encode_query_body(w: Encoder, body: Interval) -> None:
        body.encode(w)

    @staticmethod
    def decode_query_body(r: Decoder) -> Interval:
        return Interval._decode(r)

    @staticmethod
    def partial_batch_identifier(batch_identifier):
        return None


@dataclass(frozen=True)
class FixedSizeQuery(Message):
    """reference: messages/src/lib.rs:1440"""

    BY_BATCH_ID: ClassVar[int] = 0
    CURRENT_BATCH: ClassVar[int] = 1

    variant: int
    batch_id: Optional[BatchId] = None

    @classmethod
    def by_batch_id(cls, batch_id: BatchId) -> "FixedSizeQuery":
        return cls(cls.BY_BATCH_ID, batch_id)

    @classmethod
    def current_batch(cls) -> "FixedSizeQuery":
        return cls(cls.CURRENT_BATCH)

    def encode(self, w: Encoder) -> None:
        w.u8(self.variant)
        if self.variant == self.BY_BATCH_ID:
            self.batch_id.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "FixedSizeQuery":
        variant = r.u8()
        if variant == cls.BY_BATCH_ID:
            return cls(variant, BatchId._decode(r))
        if variant == cls.CURRENT_BATCH:
            return cls(variant)
        raise CodecError(f"unexpected FixedSizeQueryType value {variant}")


class FixedSize:
    """reference: messages/src/query_type.rs:89"""

    CODE = QueryCode.FIXED_SIZE
    NAME = "FixedSize"

    @staticmethod
    def encode_batch_identifier(w: Encoder, ident: BatchId) -> None:
        ident.encode(w)

    @staticmethod
    def decode_batch_identifier(r: Decoder) -> BatchId:
        return BatchId._decode(r)

    @staticmethod
    def encode_partial_batch_identifier(w: Encoder, ident: BatchId) -> None:
        ident.encode(w)

    @staticmethod
    def decode_partial_batch_identifier(r: Decoder) -> BatchId:
        return BatchId._decode(r)

    @staticmethod
    def encode_query_body(w: Encoder, body: FixedSizeQuery) -> None:
        body.encode(w)

    @staticmethod
    def decode_query_body(r: Decoder) -> FixedSizeQuery:
        return FixedSizeQuery._decode(r)

    @staticmethod
    def partial_batch_identifier(batch_identifier: BatchId) -> BatchId:
        return batch_identifier


QUERY_TYPES = {TimeInterval.CODE: TimeInterval, FixedSize.CODE: FixedSize}


def _expect_code(r: Decoder, query_type) -> None:
    code = r.u8()
    if code != query_type.CODE.value:
        raise CodecError(f"unexpected query type code {code}")


@dataclass(frozen=True)
class Query(Message):
    """reference: messages/src/lib.rs:1483"""

    query_type: type
    query_body: object

    @classmethod
    def new_time_interval(cls, batch_interval: Interval) -> "Query":
        return cls(TimeInterval, batch_interval)

    @classmethod
    def new_fixed_size(cls, fixed_size_query: FixedSizeQuery) -> "Query":
        return cls(FixedSize, fixed_size_query)

    def encode(self, w: Encoder) -> None:
        w.u8(self.query_type.CODE.value)
        self.query_type.encode_query_body(w, self.query_body)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "Query":
        _expect_code(r, query_type)
        return cls(query_type, query_type.decode_query_body(r))


@dataclass(frozen=True)
class PartialBatchSelector(Message):
    """reference: messages/src/lib.rs:1610"""

    query_type: type
    batch_identifier: object = None

    @classmethod
    def new_time_interval(cls) -> "PartialBatchSelector":
        return cls(TimeInterval, None)

    @classmethod
    def new_fixed_size(cls, batch_id: BatchId) -> "PartialBatchSelector":
        return cls(FixedSize, batch_id)

    def encode(self, w: Encoder) -> None:
        w.u8(self.query_type.CODE.value)
        self.query_type.encode_partial_batch_identifier(w, self.batch_identifier)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "PartialBatchSelector":
        _expect_code(r, query_type)
        return cls(query_type, query_type.decode_partial_batch_identifier(r))


@dataclass(frozen=True)
class BatchSelector(Message):
    """reference: messages/src/lib.rs:2558"""

    query_type: type
    batch_identifier: object

    @classmethod
    def new_time_interval(cls, batch_interval: Interval) -> "BatchSelector":
        return cls(TimeInterval, batch_interval)

    @classmethod
    def new_fixed_size(cls, batch_id: BatchId) -> "BatchSelector":
        return cls(FixedSize, batch_id)

    def encode(self, w: Encoder) -> None:
        w.u8(self.query_type.CODE.value)
        self.query_type.encode_batch_identifier(w, self.batch_identifier)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "BatchSelector":
        _expect_code(r, query_type)
        return cls(query_type, query_type.decode_batch_identifier(r))


# ---------------------------------------------------------------------------
# Collection flow
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectionReq(Message):
    """reference: messages/src/lib.rs:1555"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-collect-req"

    query: Query
    aggregation_parameter: bytes = b""

    def encode(self, w: Encoder) -> None:
        self.query.encode(w)
        w.opaque_u32(self.aggregation_parameter)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "CollectionReq":
        return cls(Query._decode(r, query_type), r.opaque_u32())


@dataclass(frozen=True)
class Collection(Message):
    """reference: messages/src/lib.rs:1730"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-collection"

    partial_batch_selector: PartialBatchSelector
    report_count: int
    interval: Interval
    leader_encrypted_agg_share: HpkeCiphertext
    helper_encrypted_agg_share: HpkeCiphertext

    def encode(self, w: Encoder) -> None:
        self.partial_batch_selector.encode(w)
        w.u64(self.report_count)
        self.interval.encode(w)
        self.leader_encrypted_agg_share.encode(w)
        self.helper_encrypted_agg_share.encode(w)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "Collection":
        return cls(
            PartialBatchSelector._decode(r, query_type),
            r.u64(),
            Interval._decode(r),
            HpkeCiphertext._decode(r),
            HpkeCiphertext._decode(r),
        )


@dataclass(frozen=True)
class AggregateShareAad(Message):
    """reference: messages/src/lib.rs:1891"""

    task_id: TaskId
    aggregation_parameter: bytes
    batch_selector: BatchSelector

    def encode(self, w: Encoder) -> None:
        self.task_id.encode(w)
        w.opaque_u32(self.aggregation_parameter)
        self.batch_selector.encode(w)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "AggregateShareAad":
        return cls(
            TaskId._decode(r), r.opaque_u32(), BatchSelector._decode(r, query_type)
        )


# ---------------------------------------------------------------------------
# Aggregation flow
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReportShare(Message):
    """reference: messages/src/lib.rs:1961"""

    metadata: ReportMetadata
    public_share: bytes
    encrypted_input_share: HpkeCiphertext

    def encode(self, w: Encoder) -> None:
        self.metadata.encode(w)
        w.opaque_u32(self.public_share)
        self.encrypted_input_share.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "ReportShare":
        return cls(ReportMetadata._decode(r), r.opaque_u32(), HpkeCiphertext._decode(r))


@dataclass(frozen=True)
class PrepareInit(Message):
    """reference: messages/src/lib.rs:2032"""

    report_share: ReportShare
    message: PingPongMessage

    def encode(self, w: Encoder) -> None:
        self.report_share.encode(w)
        w.opaque_u32(self.message.encode())

    @classmethod
    def _decode(cls, r: Decoder) -> "PrepareInit":
        report_share = ReportShare._decode(r)
        return cls(report_share, PingPongMessage.decode(r.opaque_u32()))


class PrepareError(IntEnum):
    """reference: messages/src/lib.rs:2185"""

    BATCH_COLLECTED = 0
    REPORT_REPLAYED = 1
    REPORT_DROPPED = 2
    HPKE_UNKNOWN_CONFIG_ID = 3
    HPKE_DECRYPT_ERROR = 4
    VDAF_PREP_ERROR = 5
    BATCH_SATURATED = 6
    TASK_EXPIRED = 7
    INVALID_MESSAGE = 8
    REPORT_TOO_EARLY = 9


@dataclass(frozen=True)
class PrepareStepResult(Message):
    """Tagged union Continue{message} | Finished | Reject(error).
    reference: messages/src/lib.rs:2130"""

    CONTINUE: ClassVar[int] = 0
    FINISHED: ClassVar[int] = 1
    REJECT: ClassVar[int] = 2

    variant: int
    message: Optional[PingPongMessage] = None
    error: Optional[PrepareError] = None

    @classmethod
    def new_continue(cls, message: PingPongMessage) -> "PrepareStepResult":
        return cls(cls.CONTINUE, message=message)

    @classmethod
    def finished(cls) -> "PrepareStepResult":
        return cls(cls.FINISHED)

    @classmethod
    def reject(cls, error: PrepareError) -> "PrepareStepResult":
        return cls(cls.REJECT, error=error)

    def encode(self, w: Encoder) -> None:
        w.u8(self.variant)
        if self.variant == self.CONTINUE:
            w.opaque_u32(self.message.encode())
        elif self.variant == self.REJECT:
            w.u8(self.error.value)

    @classmethod
    def _decode(cls, r: Decoder) -> "PrepareStepResult":
        variant = r.u8()
        if variant == cls.CONTINUE:
            return cls(variant, message=PingPongMessage.decode(r.opaque_u32()))
        if variant == cls.FINISHED:
            return cls(variant)
        if variant == cls.REJECT:
            try:
                return cls(variant, error=PrepareError(r.u8()))
            except ValueError as e:
                raise CodecError(str(e))
        raise CodecError(f"unexpected PrepareStepResult value {variant}")


@dataclass(frozen=True)
class PrepareResp(Message):
    """reference: messages/src/lib.rs:2084"""

    report_id: ReportId
    result: PrepareStepResult

    def encode(self, w: Encoder) -> None:
        self.report_id.encode(w)
        self.result.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "PrepareResp":
        return cls(ReportId._decode(r), PrepareStepResult._decode(r))


@dataclass(frozen=True)
class PrepareContinue(Message):
    """reference: messages/src/lib.rs:2220"""

    report_id: ReportId
    message: PingPongMessage

    def encode(self, w: Encoder) -> None:
        self.report_id.encode(w)
        w.opaque_u32(self.message.encode())

    @classmethod
    def _decode(cls, r: Decoder) -> "PrepareContinue":
        return cls(ReportId._decode(r), PingPongMessage.decode(r.opaque_u32()))


@dataclass(frozen=True)
class AggregationJobInitializeReq(Message):
    """reference: messages/src/lib.rs:2329"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-aggregation-job-init-req"

    aggregation_parameter: bytes
    partial_batch_selector: PartialBatchSelector
    prepare_inits: tuple

    def __init__(self, aggregation_parameter, partial_batch_selector, prepare_inits):
        object.__setattr__(self, "aggregation_parameter", bytes(aggregation_parameter))
        object.__setattr__(self, "partial_batch_selector", partial_batch_selector)
        object.__setattr__(self, "prepare_inits", tuple(prepare_inits))

    def encode(self, w: Encoder) -> None:
        w.opaque_u32(self.aggregation_parameter)
        self.partial_batch_selector.encode(w)
        w.items_u32(self.prepare_inits, lambda ww, p: p.encode(ww))

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "AggregationJobInitializeReq":
        return cls(
            r.opaque_u32(),
            PartialBatchSelector._decode(r, query_type),
            r.items_u32(PrepareInit._decode),
        )


class AggregationJobStep(int):
    """u16 step counter; reference: messages/src/lib.rs:2404"""

    def increment(self) -> "AggregationJobStep":
        return AggregationJobStep(self + 1)

    def encode(self, w: Encoder) -> None:
        w.u16(int(self))

    @classmethod
    def _decode(cls, r: Decoder) -> "AggregationJobStep":
        return cls(r.u16())


@dataclass(frozen=True)
class AggregationJobContinueReq(Message):
    """reference: messages/src/lib.rs:2461"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-aggregation-job-continue-req"

    step: AggregationJobStep
    prepare_continues: tuple

    def __init__(self, step, prepare_continues):
        object.__setattr__(self, "step", AggregationJobStep(step))
        object.__setattr__(self, "prepare_continues", tuple(prepare_continues))

    def encode(self, w: Encoder) -> None:
        self.step.encode(w)
        w.items_u32(self.prepare_continues, lambda ww, p: p.encode(ww))

    @classmethod
    def _decode(cls, r: Decoder) -> "AggregationJobContinueReq":
        return cls(AggregationJobStep._decode(r), r.items_u32(PrepareContinue._decode))


@dataclass(frozen=True)
class AggregationJobResp(Message):
    """reference: messages/src/lib.rs:2516"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-aggregation-job-resp"

    prepare_resps: tuple

    def __init__(self, prepare_resps):
        object.__setattr__(self, "prepare_resps", tuple(prepare_resps))

    def encode(self, w: Encoder) -> None:
        w.items_u32(self.prepare_resps, lambda ww, p: p.encode(ww))

    @classmethod
    def _decode(cls, r: Decoder) -> "AggregationJobResp":
        return cls(r.items_u32(PrepareResp._decode))


@dataclass(frozen=True)
class AggregateShareReq(Message):
    """reference: messages/src/lib.rs:2630"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-aggregate-share-req"

    batch_selector: BatchSelector
    aggregation_parameter: bytes
    report_count: int
    checksum: ReportIdChecksum

    def encode(self, w: Encoder) -> None:
        self.batch_selector.encode(w)
        w.opaque_u32(self.aggregation_parameter)
        w.u64(self.report_count)
        self.checksum.encode(w)

    @classmethod
    def _decode(cls, r: Decoder, query_type=TimeInterval) -> "AggregateShareReq":
        return cls(
            BatchSelector._decode(r, query_type),
            r.opaque_u32(),
            r.u64(),
            ReportIdChecksum._decode(r),
        )


@dataclass(frozen=True)
class AggregateShare(Message):
    """reference: messages/src/lib.rs:2716"""

    MEDIA_TYPE: ClassVar[str] = "application/dap-aggregate-share"

    encrypted_aggregate_share: HpkeCiphertext

    def encode(self, w: Encoder) -> None:
        self.encrypted_aggregate_share.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "AggregateShare":
        return cls(HpkeCiphertext._decode(r))
