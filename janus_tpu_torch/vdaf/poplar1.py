"""Poplar1: heavy-hitters VDAF over the IDPF.

The analog of the reference's ``Poplar1{bits}`` instance (reference:
core/src/vdaf.rs:96, served by the prio crate; draft-irtf-cfrg-vdaf-08 §9):
clients shard a ``bits``-bit string through an IDPF; aggregators, given an
aggregation parameter (level, prefixes), evaluate their IDPF shares at each
prefix and run a two-round sketch to verify the client's contribution is a
one-hot unit vector before accumulating prefix counts.

Sketch (Boneh et al. secure-sketching as used by Poplar): with verifier
randomness r_i per prefix and client-supplied correlated randomness
(A, B, C=A²) additively shared — helper's shares derived from a seed, the
leader's carried explicitly so the relation C = A² holds — the aggregators
broadcast

    z_b  = Σ r_i·y_b(i) + a_b,      z*_b = Σ r_i²·y_b(i) + b_b,

then verify  σ = (z−A)² − (z*−B) = (Σ r_i y_i)² − Σ r_i² y_i = 0,  which
holds exactly when y is one-hot with value 1 (up to the r-randomized check).

Multi-round state flows through the stored-transition ping-pong model
(janus_tpu_torch.vdaf.pingpong), so the driver layer persists Poplar1 exactly as
the reference persists prio's PingPongTransition (models.rs:898).

Copy of ``janus_tpu/vdaf/poplar1.py`` for the port, with the resident state
variant (a ``ResidentRef`` from ``executor/accumulator.py`` in place of the
sketch vector).  tests/test_torch_poplar1.py holds its shards, prepare
states and shares byte for byte against the JAX package's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..fields import Field64, Field255
from ..xof import XofTurboShake128
from .idpf import IdpfPoplar
from .prio3 import VdafError

USAGE_SHARD_RANDOMNESS = 1
USAGE_CORR_INNER = 2
USAGE_CORR_LEAF = 3
USAGE_VERIFY_RANDOMNESS = 4

ALG_POPLAR1 = 0x00000006

_FIELD_TAGS = {0: Field64, 1: Field255}


def _field_tag(field: type) -> int:
    return 1 if field is Field255 else 0


@dataclass(frozen=True)
class Poplar1AggregationParam:
    """(level, sorted distinct prefixes) — reference analog:
    prio's Poplar1AggregationParam."""

    level: int
    prefixes: Tuple[int, ...]

    def __post_init__(self):
        if list(self.prefixes) != sorted(set(self.prefixes)):
            raise VdafError("prefixes must be sorted and distinct")

    def encode(self, bits: int) -> bytes:
        if not 0 <= self.level < bits:
            raise VdafError("level out of range")
        prefix_bytes = (self.level + 1 + 7) // 8
        out = struct.pack(">HI", self.level, len(self.prefixes))
        for p in self.prefixes:
            if p >> (self.level + 1):
                raise VdafError("prefix out of range")
            out += int(p).to_bytes(prefix_bytes, "big")
        return out

    @classmethod
    def decode(cls, bits: int, data: bytes) -> "Poplar1AggregationParam":
        if len(data) < 6:
            raise VdafError("truncated aggregation parameter")
        level, count = struct.unpack(">HI", data[:6])
        if level >= bits:
            raise VdafError("level out of range")
        prefix_bytes = (level + 1 + 7) // 8
        if len(data) != 6 + count * prefix_bytes:
            raise VdafError("bad aggregation parameter length")
        prefixes = tuple(
            int.from_bytes(data[6 + i * prefix_bytes : 6 + (i + 1) * prefix_bytes], "big")
            for i in range(count)
        )
        for p in prefixes:
            if p >> (level + 1):
                raise VdafError("prefix out of range for level")
        return cls(level, prefixes)


@dataclass
class Poplar1InputShare:
    idpf_key: bytes
    #: helper: 16-byte seed the corr randomness expands from; leader: None
    corr_seed: Optional[bytes]
    #: leader: explicit (a, b, c) triples per level; helper: None
    corr_inner: Optional[List[Tuple[int, int, int]]] = None
    corr_leaf: Optional[Tuple[int, int, int]] = None

    def encode(self, vdaf: "Poplar1") -> bytes:
        if self.corr_seed is not None:
            return b"\x01" + self.idpf_key + self.corr_seed
        out = bytearray(b"\x00" + self.idpf_key)
        for triple in self.corr_inner:
            out += Field64.encode_vec(list(triple))
        out += Field255.encode_vec(list(self.corr_leaf))
        return bytes(out)

    @staticmethod
    def decode(vdaf: "Poplar1", agg_id: int, data: bytes) -> "Poplar1InputShare":
        if not data:
            raise VdafError("empty input share")
        kind, rest = data[0], data[1:]
        if kind == 1:
            if agg_id == 0:
                raise VdafError("leader share must carry explicit correlation")
            if len(rest) != 32:
                raise VdafError("bad helper input share length")
            return Poplar1InputShare(rest[:16], rest[16:])
        if kind != 0 or agg_id != 0:
            raise VdafError("bad input share")
        key, rest = rest[:16], rest[16:]
        inner_len = 3 * Field64.ENCODED_SIZE * (vdaf.bits - 1)
        leaf_len = 3 * Field255.ENCODED_SIZE
        if len(rest) != inner_len + leaf_len:
            raise VdafError("bad leader input share length")
        inner_vals = Field64.decode_vec(rest[:inner_len])
        leaf_vals = Field255.decode_vec(rest[inner_len:])
        corr_inner = [
            (inner_vals[3 * i], inner_vals[3 * i + 1], inner_vals[3 * i + 2])
            for i in range(vdaf.bits - 1)
        ]
        return Poplar1InputShare(
            key, None, corr_inner, (leaf_vals[0], leaf_vals[1], leaf_vals[2])
        )


@dataclass
class Poplar1PrepareShare:
    """Round 0: values = [z, zs]; round 1: values = [sigma].  Field-tagged
    so wire decoding needs no agg-param context."""

    field_tag: int
    values: List[int]

    def encode(self) -> bytes:
        return bytes([self.field_tag]) + _FIELD_TAGS[self.field_tag].encode_vec(
            self.values
        )

    @staticmethod
    def decode(data: bytes) -> "Poplar1PrepareShare":
        if not data or data[0] not in _FIELD_TAGS:
            raise VdafError("bad prepare share")
        vals = _FIELD_TAGS[data[0]].decode_vec(data[1:])
        if len(vals) not in (1, 2):
            raise VdafError("bad prepare share length")
        return Poplar1PrepareShare(data[0], vals)


@dataclass
class Poplar1PrepareState:
    agg_id: int
    level: int
    round: int  # 0 = sketch broadcast pending, 1 = decision pending
    #: this party's prefix value shares — a List[int], or (device-resident
    #: IDPF) an executor.accumulator.ResidentRef naming the row of a
    #: retained (B, P, n) sketch matrix; the ping-pong layer passes it
    #: through untouched, exactly like Prio3's resident out shares
    y_flat: object
    a: int
    b: int
    c: int
    zs_share: int


class Poplar1:
    """Two-party Poplar1 with ``bits``-bit inputs; 2 prepare rounds."""

    NONCE_SIZE = 16
    VERIFY_KEY_SIZE = 16
    ROUNDS = 2
    REQUIRES_AGG_PARAM = True
    num_shares = 2

    def __init__(self, bits: int):
        self.bits = bits
        self.idpf = IdpfPoplar(bits, value_len=1)
        # idpf keys + helper corr seed + joint (a, b) seed
        self.RAND_SIZE = self.idpf.RAND_SIZE + 16 + 16

    # -- uniform VDAF surface -------------------------------------------
    @property
    def field(self) -> type:
        return Field255  # leaf field; level-dependent via field_for_agg_param

    def field_for_agg_param(self, agg_param) -> type:
        if agg_param is None:
            raise VdafError("Poplar1 requires an aggregation parameter")
        return self.idpf.field_at(agg_param.level)

    def encode_agg_param(self, agg_param: Poplar1AggregationParam) -> bytes:
        return agg_param.encode(self.bits)

    def decode_agg_param(self, data: bytes) -> Poplar1AggregationParam:
        return Poplar1AggregationParam.decode(self.bits, data)

    def decode_input_share(self, agg_id: int, data: bytes) -> Poplar1InputShare:
        return Poplar1InputShare.decode(self, agg_id, data)

    def agg_param_conflict_key(self, data: bytes) -> bytes:
        """A report may be aggregated at most ONCE PER LEVEL: the sketch's
        correlated randomness is keyed by (nonce, level), so two different
        prefix sets at one level would reuse one-time randomness and leak
        relations among the helper's shares."""
        return data[:2]  # the big-endian level prefix of the encoded param

    def encode_public_share(self, public_share) -> bytes:
        return self.idpf.encode_public_share(public_share)

    def decode_public_share(self, data: bytes):
        return self.idpf.decode_public_share(data)

    # -- correlated randomness ------------------------------------------
    def _dst(self, usage: int) -> bytes:
        return struct.pack(">BIBH", 8, ALG_POPLAR1, 0, usage)

    def _corr_triples(self, seed: bytes, nonce: bytes, who: int):
        """Expand (a, b, c)-shares per level from a seed (helper side)."""
        binder = bytes([who]) + nonce
        inner_vals = XofTurboShake128(
            seed, self._dst(USAGE_CORR_INNER), binder
        ).next_vec(Field64, 3 * (self.bits - 1)) if self.bits > 1 else []
        leaf_vals = XofTurboShake128(
            seed, self._dst(USAGE_CORR_LEAF), binder
        ).next_vec(Field255, 3)
        inner = [
            (inner_vals[3 * i], inner_vals[3 * i + 1], inner_vals[3 * i + 2])
            for i in range(self.bits - 1)
        ]
        return inner, (leaf_vals[0], leaf_vals[1], leaf_vals[2])

    # -- shard -----------------------------------------------------------
    def shard(self, measurement: int, nonce: bytes, rand: bytes):
        """Returns (public_share, [leader_share, helper_share])."""
        if len(rand) != self.RAND_SIZE:
            raise VdafError("bad rand size")
        if measurement >> self.bits:
            raise VdafError("measurement out of range")
        idpf_rand = rand[: self.idpf.RAND_SIZE]
        helper_corr_seed = rand[self.idpf.RAND_SIZE : self.idpf.RAND_SIZE + 16]
        joint_seed = rand[self.idpf.RAND_SIZE + 16 :]

        beta_inner = [[1] for _ in range(self.bits - 1)]
        public_share, keys = self.idpf.gen(
            measurement, beta_inner, [1], nonce, idpf_rand
        )

        # helper (a1,b1,c1) from its seed; joint (A,B) from the joint seed;
        # leader gets a0 = A-a1, b0 = B-b1, c0 = A²-c1 so C = A² holds.
        h_inner, h_leaf = self._corr_triples(helper_corr_seed, nonce, 1)
        j_inner, j_leaf = self._corr_triples(joint_seed, nonce, 2)
        corr_inner = []
        for lvl in range(self.bits - 1):
            A, B, _ = j_inner[lvl]
            a1, b1, c1 = h_inner[lvl]
            corr_inner.append(
                (
                    Field64.sub(A, a1),
                    Field64.sub(B, b1),
                    Field64.sub(Field64.mul(A, A), c1),
                )
            )
        A, B, _ = j_leaf
        a1, b1, c1 = h_leaf
        corr_leaf = (
            Field255.sub(A, a1),
            Field255.sub(B, b1),
            Field255.sub(Field255.mul(A, A), c1),
        )
        leader = Poplar1InputShare(keys[0], None, corr_inner, corr_leaf)
        helper = Poplar1InputShare(keys[1], helper_corr_seed)
        return public_share, [leader, helper]

    # -- prepare ---------------------------------------------------------
    def _verify_rands(
        self, verify_key: bytes, nonce: bytes, agg_param: Poplar1AggregationParam
    ) -> List[int]:
        field = self.field_for_agg_param(agg_param)
        binder = nonce + struct.pack(">H", agg_param.level)
        return XofTurboShake128(
            verify_key, self._dst(USAGE_VERIFY_RANDOMNESS), binder
        ).next_vec(field, len(agg_param.prefixes))

    def prep_init(
        self,
        verify_key: bytes,
        agg_id: int,
        agg_param: Poplar1AggregationParam,
        nonce: bytes,
        public_share,
        input_share: Poplar1InputShare,
    ):
        field = self.field_for_agg_param(agg_param)
        level = agg_param.level
        y = self.idpf.eval(
            agg_id, public_share, input_share.idpf_key, level, agg_param.prefixes, nonce
        )
        y_flat = [row[0] for row in y]
        if input_share.corr_seed is not None:
            inner, leaf = self._corr_triples(input_share.corr_seed, nonce, 1)
        else:
            inner, leaf = input_share.corr_inner, input_share.corr_leaf
        a, b, c = leaf if level == self.bits - 1 else inner[level]
        r = self._verify_rands(verify_key, nonce, agg_param)
        z = a
        zs = b
        for r_i, y_i in zip(r, y_flat):
            z = field.add(z, field.mul(r_i, y_i))
            zs = field.add(zs, field.mul(field.mul(r_i, r_i), y_i))
        state = Poplar1PrepareState(
            agg_id=agg_id, level=level, round=0, y_flat=y_flat,
            a=a, b=b, c=c, zs_share=zs,
        )
        return state, Poplar1PrepareShare(_field_tag(field), [z, zs])

    def sketch_combine(self, agg_param, shares: Sequence[Tuple[int, int]]):
        """Round-0 combine: broadcast (z, z*)."""
        field = self.field_for_agg_param(agg_param)
        z = zs = 0
        for z_b, zs_b in shares:
            z = field.add(z, z_b)
            zs = field.add(zs, zs_b)
        return z, zs

    def sketch_decide_share(self, state: Poplar1PrepareState, z: int, zs: int) -> int:
        """Round-1 share:  σ_b = [z²]_{b=0} − 2z·a_b + c_b + b_b − z*_b."""
        field = self.idpf.field_at(state.level)
        sigma = field.sub(
            field.add(field.add(state.c, state.b), 0 if state.agg_id else field.mul(z, z)),
            field.add(field.mul(field.add(z, z), state.a), state.zs_share),
        )
        return sigma

    def decide(self, agg_param, sigma_shares: Sequence[int]) -> None:
        field = self.field_for_agg_param(agg_param)
        total = 0
        for s in sigma_shares:
            total = field.add(total, s)
        if total != 0:
            raise VdafError("sketch verification failed")

    # -- aggregation -----------------------------------------------------
    def aggregate(self, agg_param, out_shares: Sequence[Sequence[int]]) -> List[int]:
        field = self.field_for_agg_param(agg_param)
        agg = [0] * len(agg_param.prefixes)
        for s in out_shares:
            agg = field.vec_add(agg, s)
        return agg

    def unshard_with_param(
        self, agg_param, agg_shares: Sequence[Sequence[int]], num_measurements: int
    ) -> List[int]:
        field = self.field_for_agg_param(agg_param)
        agg = [0] * len(agg_param.prefixes)
        for s in agg_shares:
            agg = field.vec_add(agg, s)
        return agg

    # -- ping-pong adapter surface --------------------------------------
    # Encodings are field-tagged so they decode without agg-param context.

    def ping_pong_prep_init(
        self, verify_key, agg_id, agg_param, nonce, public_share, input_share
    ):
        return self.prep_init(
            verify_key, agg_id, agg_param, nonce, public_share, input_share
        )

    def ping_pong_prep_shares_to_prep(self, agg_param, prep_shares, round=0) -> bytes:
        field = self.field_for_agg_param(agg_param)
        tag = _field_tag(field)
        for sh in prep_shares:
            if sh.field_tag != tag:
                raise VdafError("prepare share field mismatch")
        if round == 0:
            z, zs = self.sketch_combine(
                agg_param, [(sh.values[0], sh.values[1]) for sh in prep_shares]
            )
            return bytes([tag]) + field.encode_vec([z, zs])
        self.decide(agg_param, [sh.values[0] for sh in prep_shares])
        return b""

    def ping_pong_prep_next(self, prep_state: Poplar1PrepareState, prep_msg: bytes, round=0):
        field = self.idpf.field_at(prep_state.level)
        if prep_state.round == 0:
            if not prep_msg or prep_msg[0] != _field_tag(field):
                raise VdafError("bad sketch message")
            vals = field.decode_vec(prep_msg[1:])
            if len(vals) != 2:
                raise VdafError("bad sketch message length")
            sigma = self.sketch_decide_share(prep_state, vals[0], vals[1])
            next_state = Poplar1PrepareState(
                agg_id=prep_state.agg_id, level=prep_state.level, round=1,
                y_flat=prep_state.y_flat, a=0, b=0, c=0, zs_share=0,
            )
            share = Poplar1PrepareShare(_field_tag(field), [sigma])
            return ("continue", next_state, share.encode())
        if prep_msg:
            raise VdafError("unexpected decision payload")
        if isinstance(prep_state.y_flat, list):
            return ("finish", list(prep_state.y_flat))
        # device-resident sketch: the ref travels out verbatim; only the
        # accumulator store can resolve it (commit psums the row in place)
        return ("finish", prep_state.y_flat)

    def ping_pong_encode_prep_share(self, share: Poplar1PrepareShare) -> bytes:
        return share.encode()

    def ping_pong_decode_prep_share(self, data: bytes, round=0) -> Poplar1PrepareShare:
        share = Poplar1PrepareShare.decode(data)
        expected = 2 if round == 0 else 1
        if len(share.values) != expected:
            raise VdafError("bad prepare share length for round")
        return share

    #: y-count sentinel marking a persisted state whose sketch vector is a
    #: device-resident ref (flush id + row) instead of inline field
    #: elements.  The value is unreachable for real prefix counts (the
    #: encoded agg param caps count at u32, and a 2^32-prefix frontier
    #: cannot exist), so legacy states decode unchanged.
    _RESIDENT_Y = 0xFFFFFFFF

    def ping_pong_encode_state(self, state: Poplar1PrepareState) -> bytes:
        field = self.idpf.field_at(state.level)
        if not isinstance(state.y_flat, list):
            # device-resident sketch: persist the ref, not the vector —
            # the WAITING_LEADER -> FINISHED hop never round-trips the
            # y values through host memory.  A ref that outlives its
            # process decodes fine and fails closed at commit time
            # (AccumulatorUnavailable -> per-report oracle replay from the
            # retained report payloads).
            ref = state.y_flat
            head = struct.pack(
                ">BHBI", state.agg_id, state.level, state.round, self._RESIDENT_Y
            )
            return (
                head
                + struct.pack(">qI", int(ref.flush_id), int(ref.row))
                + field.encode_vec(
                    [state.a, state.b, state.c, state.zs_share]
                )
            )
        head = struct.pack(
            ">BHBI", state.agg_id, state.level, state.round, len(state.y_flat)
        )
        return head + field.encode_vec(
            state.y_flat + [state.a, state.b, state.c, state.zs_share]
        )

    def ping_pong_decode_state(self, data: bytes) -> Poplar1PrepareState:
        if len(data) < 8:
            raise VdafError("truncated prepare state")
        agg_id, level, round_, n = struct.unpack(">BHBI", data[:8])
        field = self.idpf.field_at(level)
        if n == self._RESIDENT_Y:
            from ..executor.accumulator import ResidentRef

            if len(data) < 20:
                raise VdafError("truncated resident prepare state")
            flush_id, row = struct.unpack(">qI", data[8:20])
            vals = field.decode_vec(data[20:])
            if len(vals) != 4:
                raise VdafError("bad resident prepare state length")
            return Poplar1PrepareState(
                agg_id=agg_id, level=level, round=round_,
                y_flat=ResidentRef(flush_id, row),
                a=vals[0], b=vals[1], c=vals[2], zs_share=vals[3],
            )
        vals = field.decode_vec(data[8:])
        if len(vals) != n + 4:
            raise VdafError("bad prepare state length")
        return Poplar1PrepareState(
            agg_id=agg_id, level=level, round=round_, y_flat=vals[:n],
            a=vals[n], b=vals[n + 1], c=vals[n + 2], zs_share=vals[n + 3],
        )
