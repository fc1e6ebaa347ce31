"""Ping-pong topology for two-aggregator VDAF preparation.

draft-irtf-cfrg-vdaf-08 §5.8, generalized to multi-round VDAFs with the
stored-transition model the reference persists between driver steps
(reference consumes ``prio::topology::ping_pong``:
``PingPongTopology::{leader_initialized, helper_initialized, leader_continued}``,
``PingPongState::{Continued, Finished}``, ``PingPongTransition::evaluate``;
driver storage of serialized transitions at
aggregator_core/src/datastore/models.rs:898-1105 ``WaitingLeader``).

A ``PingPongTransition`` is the deferred tail of one protocol step: the
party's *pre-message* prepare state plus the combined prepare message.  It is
serializable, so a driver can persist it in the datastore and evaluate it in
a later process — "the DB is the checkpoint" (SURVEY.md §5).

VDAFs plug in via the small ``ping_pong_*`` adapter surface implemented by
``Prio3`` (1 round) and the dummy test VDAFs (any rounds; vdaf/dummy.py).

Message wire format (tagged union with u32-length-prefixed opaques) matches
the DAP embedding used inside PrepareResp/PrepareContinue — anchored to the
reference's own hex in tests/test_messages.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

from .prio3 import Prio3, Prio3InputShare, Prio3PrepareShare, Prio3PrepareState, VdafError


class PingPongError(VdafError):
    pass


@dataclass
class PingPongMessage:
    """Tagged union: 0 = initialize, 1 = continue, 2 = finish."""

    INITIALIZE = 0
    CONTINUE = 1
    FINISH = 2

    variant: int
    prep_share: Optional[bytes] = None  # initialize / continue
    prep_msg: Optional[bytes] = None  # continue / finish

    def encode(self) -> bytes:
        out = bytes([self.variant])
        if self.variant == self.INITIALIZE:
            out += struct.pack(">I", len(self.prep_share)) + self.prep_share
        elif self.variant == self.CONTINUE:
            out += struct.pack(">I", len(self.prep_msg)) + self.prep_msg
            out += struct.pack(">I", len(self.prep_share)) + self.prep_share
        elif self.variant == self.FINISH:
            out += struct.pack(">I", len(self.prep_msg)) + self.prep_msg
        else:
            raise VdafError("bad ping-pong variant")
        return out

    @staticmethod
    def decode(data: bytes) -> "PingPongMessage":
        if not data:
            raise VdafError("empty ping-pong message")
        variant = data[0]
        rest = data[1:]

        def take(buf: bytes) -> Tuple[bytes, bytes]:
            if len(buf) < 4:
                raise VdafError("truncated ping-pong message")
            (n,) = struct.unpack(">I", buf[:4])
            if len(buf) < 4 + n:
                raise VdafError("truncated ping-pong message")
            return buf[4 : 4 + n], buf[4 + n :]

        if variant == PingPongMessage.INITIALIZE:
            share, rest = take(rest)
            if rest:
                raise VdafError("trailing bytes")
            return PingPongMessage(variant, prep_share=share)
        if variant == PingPongMessage.CONTINUE:
            msg, rest = take(rest)
            share, rest = take(rest)
            if rest:
                raise VdafError("trailing bytes")
            return PingPongMessage(variant, prep_share=share, prep_msg=msg)
        if variant == PingPongMessage.FINISH:
            msg, rest = take(rest)
            if rest:
                raise VdafError("trailing bytes")
            return PingPongMessage(variant, prep_msg=msg)
        raise VdafError("bad ping-pong variant")


@dataclass
class PingPongContinued:
    """Waiting for the peer; holds our prepare state (+ current round)."""

    prep_state: Any
    round: int = 0


@dataclass
class PingPongFinished:
    out_share: Any


PingPongState = Union[PingPongContinued, PingPongFinished]


@dataclass
class PingPongTransition:
    """Deferred evaluation of one prepare step: (pre-message state, combined
    prepare message).  Mirrors ``prio::topology::ping_pong::PingPongTransition``;
    serialized into driver state between steps (reference:
    aggregator_core/src/datastore/models.rs:898)."""

    previous_prepare_state: Any
    current_prepare_message: bytes  # encoded prep message
    round: int  # round of previous_prepare_state

    def evaluate(self, vdaf) -> Tuple[PingPongState, PingPongMessage]:
        kind, *rest = vdaf.ping_pong_prep_next(
            self.previous_prepare_state, self.current_prepare_message, self.round
        )
        if kind == "finish":
            (out_share,) = rest
            return (
                PingPongFinished(out_share),
                PingPongMessage(PingPongMessage.FINISH, prep_msg=self.current_prepare_message),
            )
        next_state, next_share = rest
        return (
            PingPongContinued(next_state, self.round + 1),
            PingPongMessage(
                PingPongMessage.CONTINUE,
                prep_msg=self.current_prepare_message,
                prep_share=next_share,
            ),
        )

    # -- persistence ----------------------------------------------------
    def encode(self, vdaf) -> bytes:
        state = vdaf.ping_pong_encode_state(self.previous_prepare_state)
        return (
            struct.pack(">H", self.round)
            + struct.pack(">I", len(self.current_prepare_message))
            + self.current_prepare_message
            + state
        )

    @classmethod
    def decode(cls, vdaf, data: bytes) -> "PingPongTransition":
        if len(data) < 6:
            raise PingPongError("truncated transition")
        (rnd,) = struct.unpack(">H", data[:2])
        (n,) = struct.unpack(">I", data[2:6])
        if len(data) < 6 + n:
            raise PingPongError("truncated transition")
        msg = data[6 : 6 + n]
        state = vdaf.ping_pong_decode_state(data[6 + n :])
        return cls(state, msg, rnd)


def leader_initialized(
    vdaf,
    verify_key: bytes,
    agg_param,
    nonce: bytes,
    public_share,
    input_share,
) -> Tuple[PingPongContinued, PingPongMessage]:
    """Leader's first move: prep_init, send Initialize{prep_share}."""
    prep_state, prep_share = vdaf.ping_pong_prep_init(
        verify_key, 0, agg_param, nonce, public_share, input_share
    )
    msg = PingPongMessage(
        PingPongMessage.INITIALIZE, prep_share=vdaf.ping_pong_encode_prep_share(prep_share)
    )
    return PingPongContinued(prep_state, 0), msg


def helper_initialized(
    vdaf,
    verify_key: bytes,
    agg_param,
    nonce: bytes,
    public_share,
    input_share,
    inbound: PingPongMessage,
) -> PingPongTransition:
    """Helper's first move: prep_init, combine with the leader's share, and
    return the (storable) transition whose evaluation yields the reply."""
    if inbound.variant != PingPongMessage.INITIALIZE:
        raise PingPongError("expected initialize message")
    leader_share = vdaf.ping_pong_decode_prep_share(inbound.prep_share, round=0)
    prep_state, helper_share = vdaf.ping_pong_prep_init(
        verify_key, 1, agg_param, nonce, public_share, input_share
    )
    prep_msg = vdaf.ping_pong_prep_shares_to_prep(
        agg_param, [leader_share, helper_share], round=0
    )
    return PingPongTransition(prep_state, prep_msg, 0)


@dataclass
class PingPongContinuedValue:
    """Either a new transition (reply pending) or a message-less finish."""

    transition: Optional[PingPongTransition] = None
    out_share: Optional[Any] = None


def continued(
    vdaf,
    is_leader: bool,
    state: PingPongContinued,
    inbound: PingPongMessage,
    agg_param=None,
) -> PingPongContinuedValue:
    """Apply the peer's message to our continued state.

    Mirrors prio's ``leader_continued``/``helper_continued``: evaluate our
    deferred prep_next with the inbound prepare message; on Continue, combine
    the new prepare shares into the next transition; on Finish, we are done.
    """
    if inbound.variant == PingPongMessage.INITIALIZE:
        raise PingPongError("unexpected initialize message")
    kind, *rest = vdaf.ping_pong_prep_next(state.prep_state, inbound.prep_msg, state.round)
    if kind == "finish":
        if inbound.variant != PingPongMessage.FINISH:
            raise PingPongError("round mismatch: we finished, peer continued")
        (out_share,) = rest
        return PingPongContinuedValue(out_share=out_share)
    if inbound.variant != PingPongMessage.CONTINUE:
        raise PingPongError("round mismatch: we continued, peer finished")
    next_state, our_share_enc = rest
    next_round = state.round + 1
    our_share = vdaf.ping_pong_decode_prep_share(our_share_enc, round=next_round)
    peer_share = vdaf.ping_pong_decode_prep_share(inbound.prep_share, round=next_round)
    shares = [our_share, peer_share] if is_leader else [peer_share, our_share]
    prep_msg = vdaf.ping_pong_prep_shares_to_prep(agg_param, shares, round=next_round)
    return PingPongContinuedValue(
        transition=PingPongTransition(next_state, prep_msg, next_round)
    )


def leader_continued(vdaf, state: PingPongContinued, inbound: PingPongMessage):
    """One-round convenience (Prio3): the FINISH reply completes the leader.

    Multi-round flows should use ``continued`` and transition evaluation.
    """
    value = continued(vdaf, True, state, inbound)
    if value.out_share is None:
        raise PingPongError("expected finish message")
    return PingPongFinished(value.out_share)


# ---------------------------------------------------------------------------
# Prio3 adapter surface (1-round).  The encoded prepare message for Prio3 is
# the joint-rand seed confirmation (or empty when the circuit has none).
# ---------------------------------------------------------------------------


def _prio3_prep_init(self, verify_key, agg_id, agg_param, nonce, public_share, input_share):
    if agg_param is not None:
        raise VdafError("Prio3 takes no aggregation parameter")
    return self.prep_init(verify_key, agg_id, nonce, public_share, input_share)


def _prio3_prep_shares_to_prep(self, agg_param, prep_shares, round=0):
    msg = self.prep_shares_to_prep(prep_shares)
    return msg if msg is not None else b""


def _prio3_prep_next(self, prep_state, prep_msg: bytes, round=0):
    if self.flp.JOINT_RAND_LEN > 0:
        out = self.prep_next(prep_state, prep_msg)
    else:
        if prep_msg:
            raise VdafError("unexpected prepare message payload")
        out = self.prep_next(prep_state, None)
    return ("finish", out)


def _prio3_encode_prep_share(self, share: Prio3PrepareShare) -> bytes:
    return share.encode(self)


def _prio3_decode_prep_share(self, data: bytes, round=0) -> Prio3PrepareShare:
    return Prio3PrepareShare.decode(self, data)


def _prio3_encode_state(self, state: Prio3PrepareState) -> bytes:
    f = self.flp.field
    out = f.encode_vec(state.out_share)
    if state.corrected_joint_rand_seed is not None:
        out += state.corrected_joint_rand_seed
    return out


def _prio3_decode_state(self, data: bytes) -> Prio3PrepareState:
    f = self.flp.field
    seed = None
    if self.flp.JOINT_RAND_LEN > 0:
        if len(data) < self.xof.SEED_SIZE:
            raise VdafError("truncated prepare state")
        seed = data[len(data) - self.xof.SEED_SIZE :]
        data = data[: len(data) - self.xof.SEED_SIZE]
    out_share = f.decode_vec(data)
    if len(out_share) != self.flp.OUTPUT_LEN:
        raise VdafError("bad prepare state length")
    return Prio3PrepareState(out_share=out_share, corrected_joint_rand_seed=seed)


Prio3.ping_pong_prep_init = _prio3_prep_init
Prio3.ping_pong_prep_shares_to_prep = _prio3_prep_shares_to_prep
Prio3.ping_pong_prep_next = _prio3_prep_next
Prio3.ping_pong_encode_prep_share = _prio3_encode_prep_share
Prio3.ping_pong_decode_prep_share = _prio3_decode_prep_share
Prio3.ping_pong_encode_state = _prio3_encode_state
Prio3.ping_pong_decode_state = _prio3_decode_state
