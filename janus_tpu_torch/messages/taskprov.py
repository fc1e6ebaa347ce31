"""Taskprov extension messages (draft-wang-ppm-dap-taskprov), byte-compatible
with the reference (reference: messages/src/taskprov.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional

from .codec import CodecError, Decoder, Encoder, Message
from .dap import Duration, Time, Url


@dataclass(frozen=True)
class DpMechanism(Message):
    """reference: messages/src/taskprov.rs:514"""

    RESERVED: ClassVar[int] = 0
    NONE: ClassVar[int] = 1

    codepoint: int
    payload: bytes = b""

    @classmethod
    def none(cls) -> "DpMechanism":
        return cls(cls.NONE)

    def encode(self, w: Encoder) -> None:
        w.u8(self.codepoint)
        w.write(self.payload)

    @classmethod
    def _decode(cls, r: Decoder) -> "DpMechanism":
        codepoint = r.u8()
        if codepoint in (cls.RESERVED, cls.NONE):
            return cls(codepoint)
        # Unrecognized mechanisms swallow the remaining payload.
        return cls(codepoint, r.read(r.remaining()))


@dataclass(frozen=True)
class DpConfig(Message):
    """reference: messages/src/taskprov.rs:479"""

    dp_mechanism: DpMechanism

    def encode(self, w: Encoder) -> None:
        self.dp_mechanism.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "DpConfig":
        return cls(DpMechanism._decode(r))


@dataclass(frozen=True)
class VdafType(Message):
    """Tagged VDAF descriptor; codes match the reference and the VDAF spec
    (reference: messages/src/taskprov.rs:321-433)."""

    PRIO3COUNT: ClassVar[int] = 0x00000000
    PRIO3SUM: ClassVar[int] = 0x00000001
    PRIO3SUMVEC: ClassVar[int] = 0x00000002
    PRIO3HISTOGRAM: ClassVar[int] = 0x00000003
    PRIO3SUMVECFIELD64MULTIPROOFHMACSHA256AES128: ClassVar[int] = 0xFFFF1003
    POPLAR1: ClassVar[int] = 0x00001000

    code: int
    bits: Optional[int] = None
    length: Optional[int] = None
    chunk_length: Optional[int] = None
    proofs: Optional[int] = None

    def encode(self, w: Encoder) -> None:
        w.u32(self.code)
        if self.code == self.PRIO3COUNT:
            pass
        elif self.code == self.PRIO3SUM:
            w.u8(self.bits)
        elif self.code == self.PRIO3SUMVEC:
            w.u32(self.length)
            w.u8(self.bits)
            w.u32(self.chunk_length)
        elif self.code == self.PRIO3SUMVECFIELD64MULTIPROOFHMACSHA256AES128:
            w.u32(self.length)
            w.u8(self.bits)
            w.u32(self.chunk_length)
            w.u8(self.proofs)
        elif self.code == self.PRIO3HISTOGRAM:
            w.u32(self.length)
            w.u32(self.chunk_length)
        elif self.code == self.POPLAR1:
            w.u16(self.bits)
        else:
            raise CodecError(f"unknown VdafType code {self.code:#x}")

    @classmethod
    def _decode(cls, r: Decoder) -> "VdafType":
        code = r.u32()
        if code == cls.PRIO3COUNT:
            return cls(code)
        if code == cls.PRIO3SUM:
            return cls(code, bits=r.u8())
        if code == cls.PRIO3SUMVEC:
            return cls(code, length=r.u32(), bits=r.u8(), chunk_length=r.u32())
        if code == cls.PRIO3SUMVECFIELD64MULTIPROOFHMACSHA256AES128:
            return cls(
                code, length=r.u32(), bits=r.u8(), chunk_length=r.u32(), proofs=r.u8()
            )
        if code == cls.PRIO3HISTOGRAM:
            return cls(code, length=r.u32(), chunk_length=r.u32())
        if code == cls.POPLAR1:
            return cls(code, bits=r.u16())
        raise CodecError(f"unknown VdafType code {code:#x}")

    def to_instance(self) -> dict:
        """Serialized VdafInstance description (janus_tpu_torch.vdaf.instances)."""
        if self.code == self.PRIO3COUNT:
            return {"type": "Prio3Count"}
        if self.code == self.PRIO3SUM:
            return {"type": "Prio3Sum", "bits": self.bits}
        if self.code == self.PRIO3SUMVEC:
            return {
                "type": "Prio3SumVec",
                "length": self.length,
                "bits": self.bits,
                "chunk_length": self.chunk_length,
            }
        if self.code == self.PRIO3SUMVECFIELD64MULTIPROOFHMACSHA256AES128:
            return {
                "type": "Prio3SumVecField64MultiproofHmacSha256Aes128",
                "length": self.length,
                "bits": self.bits,
                "chunk_length": self.chunk_length,
                "proofs": self.proofs,
            }
        if self.code == self.PRIO3HISTOGRAM:
            return {
                "type": "Prio3Histogram",
                "length": self.length,
                "chunk_length": self.chunk_length,
            }
        if self.code == self.POPLAR1:
            return {"type": "Poplar1", "bits": self.bits}
        raise CodecError(f"unknown VdafType code {self.code:#x}")


@dataclass(frozen=True)
class VdafConfig(Message):
    """reference: messages/src/taskprov.rs:272"""

    dp_config: DpConfig
    vdaf_type: VdafType

    def encode(self, w: Encoder) -> None:
        w.opaque_u16(self.dp_config.get_encoded())
        self.vdaf_type.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "VdafConfig":
        dp_config = DpConfig.get_decoded(r.opaque_u16())
        return cls(dp_config, VdafType._decode(r))


@dataclass(frozen=True)
class TaskprovQuery(Message):
    """reference: messages/src/taskprov.rs:219"""

    RESERVED: ClassVar[int] = 0
    TIME_INTERVAL: ClassVar[int] = 1
    FIXED_SIZE: ClassVar[int] = 2

    variant: int
    max_batch_size: Optional[int] = None

    @classmethod
    def time_interval(cls) -> "TaskprovQuery":
        return cls(cls.TIME_INTERVAL)

    @classmethod
    def fixed_size(cls, max_batch_size: int) -> "TaskprovQuery":
        return cls(cls.FIXED_SIZE, max_batch_size)

    def encode(self, w: Encoder) -> None:
        w.u8(self.variant)
        if self.variant == self.FIXED_SIZE:
            w.u32(self.max_batch_size)

    @classmethod
    def _decode(cls, r: Decoder) -> "TaskprovQuery":
        variant = r.u8()
        if variant == cls.FIXED_SIZE:
            return cls(variant, r.u32())
        if variant in (cls.RESERVED, cls.TIME_INTERVAL):
            return cls(variant)
        raise CodecError(f"unexpected taskprov query type {variant}")


@dataclass(frozen=True)
class QueryConfig(Message):
    """reference: messages/src/taskprov.rs:133"""

    time_precision: Duration
    max_batch_query_count: int
    min_batch_size: int
    query: TaskprovQuery

    def encode(self, w: Encoder) -> None:
        self.time_precision.encode(w)
        w.u16(self.max_batch_query_count)
        w.u32(self.min_batch_size)
        self.query.encode(w)

    @classmethod
    def _decode(cls, r: Decoder) -> "QueryConfig":
        return cls(Duration._decode(r), r.u16(), r.u32(), TaskprovQuery._decode(r))


@dataclass(frozen=True)
class TaskConfig(Message):
    """reference: messages/src/taskprov.rs:17"""

    task_info: bytes
    leader_aggregator_endpoint: Url
    helper_aggregator_endpoint: Url
    query_config: QueryConfig
    task_expiration: Time
    vdaf_config: VdafConfig

    def encode(self, w: Encoder) -> None:
        w.u8(len(self.task_info))
        w.write(self.task_info)
        self.leader_aggregator_endpoint.encode(w)
        self.helper_aggregator_endpoint.encode(w)
        w.opaque_u16(self.query_config.get_encoded())
        self.task_expiration.encode(w)
        w.opaque_u16(self.vdaf_config.get_encoded())

    @classmethod
    def _decode(cls, r: Decoder) -> "TaskConfig":
        task_info = r.read(r.u8())
        leader = Url._decode(r)
        helper = Url._decode(r)
        query_config = QueryConfig.get_decoded(r.opaque_u16())
        task_expiration = Time._decode(r)
        vdaf_config = VdafConfig.get_decoded(r.opaque_u16())
        return cls(task_info, leader, helper, query_config, task_expiration, vdaf_config)
