"""Dummy VDAFs for protocol-layer tests — no real crypto, configurable round
count, and fault-injection variants.

The analog of ``prio::vdaf::dummy`` consumed by the reference's
``VdafInstance::Fake{rounds}/FakeFailsPrepInit/FakeFailsPrepStep``
(reference: core/src/vdaf.rs:96-108); lets job-driver and handler tests
exercise multi-round ping-pong and failure paths without FLP work
(SURVEY.md §4 item 5).

Measurement: one small integer.  Every party's output share is the
measurement (shares are not actually secret — this is a test double); the
aggregate is the sum over reports, "unshard" halves the doubled sum so
transcripts stay shaped like a two-party VDAF.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .prio3 import VdafError


@dataclass
class DummyInputShare:
    measurement: int

    def encode(self, vdaf) -> bytes:
        return struct.pack(">I", self.measurement)

    @staticmethod
    def decode(vdaf, agg_id: int, data: bytes) -> "DummyInputShare":
        if len(data) != 4:
            raise VdafError("bad dummy input share")
        return DummyInputShare(struct.unpack(">I", data)[0])


@dataclass
class DummyPrepState:
    measurement: int
    round: int


class DummyField:
    """Minimal field surface for out-share accumulation (u64 counters)."""

    ENCODED_SIZE = 8
    MODULUS = 1 << 64

    @classmethod
    def vec_add(cls, a, b):
        return [(x + y) % cls.MODULUS for x, y in zip(a, b)]

    @classmethod
    def encode_vec(cls, vec) -> bytes:
        return b"".join(int(x).to_bytes(8, "little") for x in vec)

    @classmethod
    def decode_vec(cls, data: bytes):
        if len(data) % 8:
            raise VdafError("bad dummy vector length")
        return [int.from_bytes(data[i : i + 8], "little") for i in range(0, len(data), 8)]


class DummyVdaf:
    """Test VDAF with ``rounds`` ping-pong prepare rounds (>= 1)."""

    NONCE_SIZE = 16
    VERIFY_KEY_SIZE = 0
    RAND_SIZE = 0
    ROUNDS: int
    REQUIRES_AGG_PARAM = False
    field = DummyField

    def __init__(self, rounds: int = 1):
        if rounds < 1:
            raise ValueError("rounds must be >= 1")
        self.ROUNDS = rounds

    # -- sharding / aggregation ----------------------------------------
    def shard(self, measurement: int, nonce: bytes, rand: bytes):
        share = DummyInputShare(int(measurement))
        return None, [share, share]

    def aggregate(self, out_shares) -> List[int]:
        return [sum(s[0] for s in out_shares)]

    def unshard(self, agg_shares, num_measurements: int) -> int:
        return sum(s[0] for s in agg_shares) // 2

    def encode_public_share(self, public_share) -> bytes:
        return b""

    def decode_public_share(self, data: bytes):
        if data:
            raise VdafError("unexpected public share")
        return None

    # Uniform VDAF surface consumed by role logic.
    def field_for_agg_param(self, agg_param):
        return self.field

    def unshard_with_param(self, agg_param, agg_shares, num_measurements: int):
        return self.unshard(agg_shares, num_measurements)

    def decode_input_share(self, agg_id: int, data: bytes) -> DummyInputShare:
        return DummyInputShare.decode(self, agg_id, data)

    def encode_agg_param(self, agg_param) -> bytes:
        return b"" if agg_param is None else struct.pack(">I", int(agg_param))

    def decode_agg_param(self, data: bytes):
        if not data:
            return None
        if len(data) != 4:
            raise VdafError("bad dummy aggregation parameter")
        return struct.unpack(">I", data)[0]

    def agg_param_conflict_key(self, data: bytes) -> bytes:
        return data

    # -- ping-pong adapter surface --------------------------------------
    def ping_pong_prep_init(self, verify_key, agg_id, agg_param, nonce, public_share, input_share):
        state = DummyPrepState(input_share.measurement, 0)
        share = struct.pack(">IB", input_share.measurement, 0)
        return state, share

    def ping_pong_prep_shares_to_prep(self, agg_param, prep_shares, round=0) -> bytes:
        vals = set()
        for s in prep_shares:
            try:
                m, r = struct.unpack(">IB", s)
            except struct.error:
                raise VdafError("bad dummy prepare share")
            if r != round:
                raise VdafError("prepare share round mismatch")
            vals.add(m)
        if len(vals) != 1:
            raise VdafError("dummy prepare disagreement")
        return struct.pack(">IB", vals.pop(), round)

    def ping_pong_prep_next(self, prep_state: DummyPrepState, prep_msg: bytes, round=0):
        try:
            m, r = struct.unpack(">IB", prep_msg)
        except struct.error:
            raise VdafError("bad dummy prepare message")
        if m != prep_state.measurement or r != prep_state.round:
            raise VdafError("dummy prepare message mismatch")
        if prep_state.round + 1 >= self.ROUNDS:
            return ("finish", [prep_state.measurement])
        next_state = DummyPrepState(prep_state.measurement, prep_state.round + 1)
        next_share = struct.pack(">IB", prep_state.measurement, next_state.round)
        return ("continue", next_state, next_share)

    def ping_pong_encode_prep_share(self, share: bytes) -> bytes:
        return share

    def ping_pong_decode_prep_share(self, data: bytes, round=0) -> bytes:
        if len(data) != 5:
            raise VdafError("bad dummy prepare share")
        return data

    def ping_pong_encode_state(self, state: DummyPrepState) -> bytes:
        return struct.pack(">IB", state.measurement, state.round)

    def ping_pong_decode_state(self, data: bytes) -> DummyPrepState:
        try:
            m, r = struct.unpack(">IB", data)
        except struct.error:
            raise VdafError("bad dummy prepare state")
        return DummyPrepState(m, r)


class FakeFailsPrepInit(DummyVdaf):
    """Every prep_init errors (reference: core/src/vdaf.rs:101)."""

    def ping_pong_prep_init(self, *args, **kwargs):
        raise VdafError("FakeFailsPrepInit")


class FakeFailsPrepStep(DummyVdaf):
    """prep_init succeeds; every prepare step errors
    (reference: core/src/vdaf.rs:105)."""

    def ping_pong_prep_shares_to_prep(self, agg_param, prep_shares, round=0):
        raise VdafError("FakeFailsPrepStep")

    def ping_pong_prep_next(self, prep_state, prep_msg, round=0):
        raise VdafError("FakeFailsPrepStep")
