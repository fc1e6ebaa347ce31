"""Prio3 VDAF composition — draft-irtf-cfrg-vdaf-08 §7.2, CPU oracle.

Implements shard / prepare (init, shares-to-prep, next) / aggregate / unshard
generically over an FLP and an XOF, including the joint-randomness derivation
and the multi-proof generalization used by libprio-rs for the custom
``Prio3SumVecField64MultiproofHmacSha256Aes128`` VDAF the reference registers
(reference: core/src/vdaf.rs:178-195; algorithm id 0xFFFF1003).

This is the protocol oracle the CUDA batched path (janus_tpu_torch.ops.prepare) must
match byte-for-byte; the reference runs the equivalent per-report loop on a
rayon pool (reference: aggregator/src/aggregator/aggregation_job_driver.rs:449,
aggregator/src/aggregator.rs:2101).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..flp.generic import FlpGeneric
from ..xof import XofTurboShake128

# Domain-separation usage constants (§7.2).
USAGE_MEAS_SHARE = 1
USAGE_PROOF_SHARE = 2
USAGE_JOINT_RANDOMNESS = 3
USAGE_PROVE_RANDOMNESS = 4
USAGE_QUERY_RANDOMNESS = 5
USAGE_JOINT_RAND_SEED = 6
USAGE_JOINT_RAND_PART = 7

VDAF_VERSION = 8  # draft-irtf-cfrg-vdaf-08

# Algorithm identifiers (§10; reference custom id at core/src/vdaf.rs:178-195).
ALG_PRIO3_COUNT = 0x00000000
ALG_PRIO3_SUM = 0x00000001
ALG_PRIO3_SUMVEC = 0x00000002
ALG_PRIO3_HISTOGRAM = 0x00000003
ALG_PRIO3_SUMVEC_FIELD64_MULTIPROOF_HMACSHA256_AES128 = 0xFFFF1003
# libprio's private codepoint for the fpvec_bounded_l2 family.
ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM = 0xFFFF1002


class VdafError(Exception):
    pass


class ReadOnlyVector(list):
    """A list that refuses change in place: the vectors of a decoded leader
    share, which must stay equal to the bytes they were decoded from.
    Equal to a plain list of the same elements."""

    def _refuse(self, *args, **kwargs):
        raise TypeError("a decoded input share's vectors are read-only: build a new share instead")

    __setitem__ = __delitem__ = __iadd__ = __imul__ = _refuse
    append = extend = insert = pop = remove = clear = sort = reverse = _refuse

    def __reduce__(self):
        return (type(self), (list(self),))


@dataclass
class Prio3InputShare:
    """Leader share carries explicit vectors; helpers carry seeds."""

    meas_share: Optional[List[int]] = None  # leader only
    proofs_share: Optional[List[int]] = None  # leader only (all proofs, concatenated)
    share_seed: Optional[bytes] = None  # helpers only
    joint_rand_blind: Optional[bytes] = None  # present iff circuit uses joint rand
    #: leader only, set by ``decode``: the measurement and proof vectors as
    #: they arrived, ENCODED_SIZE little-endian bytes an element, which are
    #: the element's u32 limbs; the device backend marshals a flush from
    #: them.  Not part of the share's value: equality and ``encode`` ignore
    #: it.  It cannot go stale: ``decode`` makes the vectors read-only,
    #: assigning either vector drops it, and ``dataclasses.replace`` does
    #: not carry it over (it is no constructor argument).
    encoded_vectors: Optional[bytes] = field(default=None, init=False, compare=False, repr=False)

    def __setattr__(self, name, value):
        if name in ("meas_share", "proofs_share"):
            object.__setattr__(self, "encoded_vectors", None)
        object.__setattr__(self, name, value)

    def encode(self, prio3: "Prio3") -> bytes:
        f = prio3.flp.field
        if self.share_seed is None:
            out = f.encode_vec(self.meas_share) + f.encode_vec(self.proofs_share)
        else:
            out = self.share_seed
        if self.joint_rand_blind is not None:
            out += self.joint_rand_blind
        return out

    @staticmethod
    def decode(prio3: "Prio3", agg_id: int, data: bytes) -> "Prio3InputShare":
        f = prio3.flp.field
        blind = None
        if prio3.flp.JOINT_RAND_LEN > 0:
            if len(data) < prio3.xof.SEED_SIZE:
                raise VdafError("input share too short")
            blind = data[len(data) - prio3.xof.SEED_SIZE :]
            data = data[: len(data) - prio3.xof.SEED_SIZE]
        if agg_id == 0:
            meas_len = prio3.flp.MEAS_LEN * f.ENCODED_SIZE
            proofs_len = prio3.flp.PROOF_LEN * prio3.num_proofs * f.ENCODED_SIZE
            if len(data) != meas_len + proofs_len:
                raise VdafError("bad leader input share length")
            share = Prio3InputShare(
                meas_share=ReadOnlyVector(f.decode_vec(data[:meas_len])),
                proofs_share=ReadOnlyVector(f.decode_vec(data[meas_len:])),
                joint_rand_blind=blind,
            )
            share.encoded_vectors = bytes(data)
            return share
        if len(data) != prio3.xof.SEED_SIZE:
            raise VdafError("bad helper input share length")
        return Prio3InputShare(share_seed=data, joint_rand_blind=blind)


@dataclass
class Prio3PrepareState:
    out_share: List[int]
    corrected_joint_rand_seed: Optional[bytes]


@dataclass
class Prio3PrepareShare:
    verifiers_share: List[int]  # VERIFIER_LEN * num_proofs elements
    joint_rand_part: Optional[bytes]

    def encode(self, prio3: "Prio3") -> bytes:
        out = prio3.flp.field.encode_vec(self.verifiers_share)
        if self.joint_rand_part is not None:
            out += self.joint_rand_part
        return out

    @staticmethod
    def decode(prio3: "Prio3", data: bytes) -> "Prio3PrepareShare":
        f = prio3.flp.field
        n = prio3.flp.VERIFIER_LEN * prio3.num_proofs * f.ENCODED_SIZE
        part = None
        if prio3.flp.JOINT_RAND_LEN > 0:
            if len(data) != n + prio3.xof.SEED_SIZE:
                raise VdafError("bad prepare share length")
            part = data[n:]
        elif len(data) != n:
            raise VdafError("bad prepare share length")
        return Prio3PrepareShare(f.decode_vec(data[:n]), part)


class Prio3:
    """A Prio3 instance: FLP + XOF + share/proof counts + algorithm id."""

    ROUNDS = 1
    NONCE_SIZE = 16
    REQUIRES_AGG_PARAM = False

    def __init__(
        self,
        flp: FlpGeneric,
        algorithm_id: int,
        num_shares: int = 2,
        num_proofs: int = 1,
        xof: type = XofTurboShake128,
    ):
        if not 2 <= num_shares < 256:
            raise ValueError("num_shares out of range")
        if num_proofs < 1:
            raise ValueError("need at least one proof")
        self.flp = flp
        self.algorithm_id = algorithm_id
        self.num_shares = num_shares
        self.num_proofs = num_proofs
        self.xof = xof
        self.VERIFY_KEY_SIZE = xof.SEED_SIZE
        if flp.JOINT_RAND_LEN > 0:
            self.RAND_SIZE = (2 * (num_shares - 1) + 2) * xof.SEED_SIZE
        else:
            self.RAND_SIZE = num_shares * xof.SEED_SIZE

    # ------------------------------------------------------------------
    def _dst(self, usage: int) -> bytes:
        return (
            VDAF_VERSION.to_bytes(1, "big")
            + b"\x00"  # algorithm class: VDAF
            + self.algorithm_id.to_bytes(4, "big")
            + usage.to_bytes(2, "big")
        )

    def _helper_meas_share(self, agg_id: int, seed: bytes) -> List[int]:
        return self.xof.expand_into_vec(
            self.flp.field, seed, self._dst(USAGE_MEAS_SHARE), bytes([agg_id]), self.flp.MEAS_LEN
        )

    def _helper_proofs_share(self, agg_id: int, seed: bytes) -> List[int]:
        return self.xof.expand_into_vec(
            self.flp.field,
            seed,
            self._dst(USAGE_PROOF_SHARE),
            bytes([agg_id]),
            self.flp.PROOF_LEN * self.num_proofs,
        )

    def _joint_rand_part(self, agg_id: int, blind: bytes, meas_share: Sequence[int], nonce: bytes) -> bytes:
        x = self.xof(
            blind,
            self._dst(USAGE_JOINT_RAND_PART),
            bytes([agg_id]) + nonce + self.flp.field.encode_vec(meas_share),
        )
        return x.next(self.xof.SEED_SIZE)

    def _joint_rand_seed(self, parts: Sequence[bytes]) -> bytes:
        x = self.xof(b"\x00" * self.xof.SEED_SIZE, self._dst(USAGE_JOINT_RAND_SEED), b"".join(parts))
        return x.next(self.xof.SEED_SIZE)

    def _joint_rands(self, seed: bytes) -> List[int]:
        return self.xof.expand_into_vec(
            self.flp.field,
            seed,
            self._dst(USAGE_JOINT_RANDOMNESS),
            b"",
            self.flp.JOINT_RAND_LEN * self.num_proofs,
        )

    def _prove_rands(self, seed: bytes) -> List[int]:
        return self.xof.expand_into_vec(
            self.flp.field,
            seed,
            self._dst(USAGE_PROVE_RANDOMNESS),
            b"",
            self.flp.PROVE_RAND_LEN * self.num_proofs,
        )

    def _query_rands(self, verify_key: bytes, nonce: bytes) -> List[int]:
        return self.xof.expand_into_vec(
            self.flp.field,
            verify_key,
            self._dst(USAGE_QUERY_RANDOMNESS),
            nonce,
            self.flp.QUERY_RAND_LEN * self.num_proofs,
        )

    # ------------------------------------------------------------------
    def shard(
        self, measurement, nonce: bytes, rand: bytes
    ) -> Tuple[Optional[List[bytes]], List[Prio3InputShare]]:
        """Returns (public_share = joint rand parts or None, input shares)."""
        if len(nonce) != self.NONCE_SIZE:
            raise VdafError("bad nonce size")
        if len(rand) != self.RAND_SIZE:
            raise VdafError("bad rand size")
        l = self.xof.SEED_SIZE
        seeds = [rand[i : i + l] for i in range(0, len(rand), l)]
        meas = self.flp.encode(measurement)
        if self.flp.JOINT_RAND_LEN > 0:
            return self._shard_with_joint_rand(meas, nonce, seeds)
        return self._shard_without_joint_rand(meas, seeds)

    def _shard_without_joint_rand(self, meas, seeds):
        f = self.flp.field
        helper_seeds, (prove_seed,) = seeds[: self.num_shares - 1], seeds[self.num_shares - 1 :]
        leader_meas_share = list(meas)
        for j in range(self.num_shares - 1):
            leader_meas_share = f.vec_sub(leader_meas_share, self._helper_meas_share(j + 1, helper_seeds[j]))
        prove_rands = self._prove_rands(prove_seed)
        proofs: List[int] = []
        for i in range(self.num_proofs):
            pr = prove_rands[i * self.flp.PROVE_RAND_LEN : (i + 1) * self.flp.PROVE_RAND_LEN]
            proofs += self.flp.prove(meas, pr, [])
        leader_proofs_share = list(proofs)
        for j in range(self.num_shares - 1):
            leader_proofs_share = f.vec_sub(leader_proofs_share, self._helper_proofs_share(j + 1, helper_seeds[j]))
        shares = [Prio3InputShare(meas_share=leader_meas_share, proofs_share=leader_proofs_share)]
        shares += [Prio3InputShare(share_seed=s) for s in helper_seeds]
        return None, shares

    def _shard_with_joint_rand(self, meas, nonce, seeds):
        f = self.flp.field
        k_helper_seeds = seeds[: 2 * (self.num_shares - 1)]
        k_helper_meas_shares = k_helper_seeds[0::2]
        k_helper_blinds = k_helper_seeds[1::2]
        k_leader_blind = seeds[2 * (self.num_shares - 1)]
        k_prove = seeds[2 * (self.num_shares - 1) + 1]

        leader_meas_share = list(meas)
        joint_rand_parts: List[bytes] = []
        for j in range(self.num_shares - 1):
            helper_share = self._helper_meas_share(j + 1, k_helper_meas_shares[j])
            leader_meas_share = f.vec_sub(leader_meas_share, helper_share)
            joint_rand_parts.append(self._joint_rand_part(j + 1, k_helper_blinds[j], helper_share, nonce))
        leader_part = self._joint_rand_part(0, k_leader_blind, leader_meas_share, nonce)
        joint_rand_parts.insert(0, leader_part)
        joint_rand_seed = self._joint_rand_seed(joint_rand_parts)
        joint_rands = self._joint_rands(joint_rand_seed)
        prove_rands = self._prove_rands(k_prove)
        proofs: List[int] = []
        for i in range(self.num_proofs):
            pr = prove_rands[i * self.flp.PROVE_RAND_LEN : (i + 1) * self.flp.PROVE_RAND_LEN]
            jr = joint_rands[i * self.flp.JOINT_RAND_LEN : (i + 1) * self.flp.JOINT_RAND_LEN]
            proofs += self.flp.prove(meas, pr, jr)
        leader_proofs_share = list(proofs)
        for j in range(self.num_shares - 1):
            leader_proofs_share = f.vec_sub(
                leader_proofs_share, self._helper_proofs_share(j + 1, k_helper_meas_shares[j])
            )
        shares = [
            Prio3InputShare(
                meas_share=leader_meas_share,
                proofs_share=leader_proofs_share,
                joint_rand_blind=k_leader_blind,
            )
        ]
        for j in range(self.num_shares - 1):
            shares.append(
                Prio3InputShare(share_seed=k_helper_meas_shares[j], joint_rand_blind=k_helper_blinds[j])
            )
        return joint_rand_parts, shares

    # ------------------------------------------------------------------
    def prep_init(
        self,
        verify_key: bytes,
        agg_id: int,
        nonce: bytes,
        public_share: Optional[List[bytes]],
        input_share: Prio3InputShare,
    ) -> Tuple[Prio3PrepareState, Prio3PrepareShare]:
        flp = self.flp
        if agg_id == 0:
            meas_share = input_share.meas_share
            proofs_share = input_share.proofs_share
        else:
            meas_share = self._helper_meas_share(agg_id, input_share.share_seed)
            proofs_share = self._helper_proofs_share(agg_id, input_share.share_seed)

        query_rands = self._query_rands(verify_key, nonce)
        joint_rands: List[int] = []
        joint_rand_part = None
        corrected_seed = None
        if flp.JOINT_RAND_LEN > 0:
            joint_rand_part = self._joint_rand_part(agg_id, input_share.joint_rand_blind, meas_share, nonce)
            parts = list(public_share)
            parts[agg_id] = joint_rand_part
            corrected_seed = self._joint_rand_seed(parts)
            joint_rands = self._joint_rands(corrected_seed)

        verifiers: List[int] = []
        for i in range(self.num_proofs):
            qr = query_rands[i * flp.QUERY_RAND_LEN : (i + 1) * flp.QUERY_RAND_LEN]
            jr = joint_rands[i * flp.JOINT_RAND_LEN : (i + 1) * flp.JOINT_RAND_LEN]
            ps = proofs_share[i * flp.PROOF_LEN : (i + 1) * flp.PROOF_LEN]
            verifiers += flp.query(meas_share, ps, qr, jr, self.num_shares)

        out_share = flp.truncate(meas_share)
        return (
            Prio3PrepareState(out_share=out_share, corrected_joint_rand_seed=corrected_seed),
            Prio3PrepareShare(verifiers_share=verifiers, joint_rand_part=joint_rand_part),
        )

    def prep_shares_to_prep(self, prep_shares: Sequence[Prio3PrepareShare]) -> Optional[bytes]:
        """Combine prepare shares; verify every proof; return the joint-rand
        seed confirmation message (or None when the circuit has no joint rand)."""
        if len(prep_shares) != self.num_shares:
            raise VdafError("wrong number of prepare shares")
        f = self.flp.field
        verifiers = [0] * (self.flp.VERIFIER_LEN * self.num_proofs)
        parts: List[bytes] = []
        for ps in prep_shares:
            verifiers = f.vec_add(verifiers, ps.verifiers_share)
            if self.flp.JOINT_RAND_LEN > 0:
                parts.append(ps.joint_rand_part)
        for i in range(self.num_proofs):
            v = verifiers[i * self.flp.VERIFIER_LEN : (i + 1) * self.flp.VERIFIER_LEN]
            if not self.flp.decide(v):
                raise VdafError("proof verification failed")
        if self.flp.JOINT_RAND_LEN > 0:
            return self._joint_rand_seed(parts)
        return None

    def prep_next(self, prep_state: Prio3PrepareState, prep_msg: Optional[bytes]) -> List[int]:
        if self.flp.JOINT_RAND_LEN > 0:
            if prep_msg != prep_state.corrected_joint_rand_seed:
                raise VdafError("joint randomness check failed")
        return prep_state.out_share

    # ------------------------------------------------------------------
    def aggregate(self, out_shares: Sequence[Sequence[int]]) -> List[int]:
        f = self.flp.field
        agg = [0] * self.flp.OUTPUT_LEN
        for s in out_shares:
            agg = f.vec_add(agg, s)
        return agg

    def unshard(self, agg_shares: Sequence[Sequence[int]], num_measurements: int):
        f = self.flp.field
        agg = [0] * self.flp.OUTPUT_LEN
        for s in agg_shares:
            agg = f.vec_add(agg, s)
        return self.flp.decode(agg, num_measurements)

    # ------------------------------------------------------------------
    def encode_public_share(self, public_share: Optional[List[bytes]]) -> bytes:
        if public_share is None:
            return b""
        return b"".join(public_share)

    def decode_public_share(self, data: bytes) -> Optional[List[bytes]]:
        if self.flp.JOINT_RAND_LEN == 0:
            if data:
                raise VdafError("unexpected public share")
            return None
        l = self.xof.SEED_SIZE
        if len(data) != self.num_shares * l:
            raise VdafError("bad public share length")
        return [data[i : i + l] for i in range(0, len(data), l)]

    # Uniform VDAF surface consumed by role logic (the analog of the
    # prio::vdaf::Aggregator assoc-type codecs, SURVEY.md §2.2).
    @property
    def field(self):
        return self.flp.field

    def field_for_agg_param(self, agg_param):
        return self.flp.field

    def unshard_with_param(self, agg_param, agg_shares, num_measurements: int):
        return self.unshard(agg_shares, num_measurements)

    def decode_input_share(self, agg_id: int, data: bytes) -> Prio3InputShare:
        return Prio3InputShare.decode(self, agg_id, data)

    def encode_agg_param(self, agg_param) -> bytes:
        if agg_param is not None:
            raise VdafError("Prio3 takes no aggregation parameter")
        return b""

    def decode_agg_param(self, data: bytes):
        if data:
            raise VdafError("Prio3 takes no aggregation parameter")
        return None

    def agg_param_conflict_key(self, data: bytes) -> bytes:
        """Reports may be aggregated once, period (no aggregation parameter)."""
        return b""
