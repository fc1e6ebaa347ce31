"""VDAF instance registry — the analog of the reference's ``VdafInstance`` enum
and ``vdaf_dispatch!`` gate (reference: core/src/vdaf.rs:65-108, 516-532).

Each constructor returns a configured ``Prio3`` over the port's own FLP and
XOF copies, or a ``Poplar1``.  The registry maps the serialized instance
description (as stored in the task model / DB ``tasks.vdaf`` column) to a
constructor; the execution backend (the card's ``CudaBackend``,
``HybridXofBackend`` or ``Poplar1Backend``, or the CPU oracle) is chosen
for the result by ``aggregator.resolve_backend``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..fields import Field64, Field128
from ..flp import Count, FixedPointBoundedL2VecSum, FlpGeneric, Histogram, Sum, SumVec
from ..xof import XofHmacSha256Aes128
from .prio3 import (
    ALG_PRIO3_COUNT,
    ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM,
    ALG_PRIO3_HISTOGRAM,
    ALG_PRIO3_SUM,
    ALG_PRIO3_SUMVEC,
    ALG_PRIO3_SUMVEC_FIELD64_MULTIPROOF_HMACSHA256_AES128,
    Prio3,
)

# Verify-key sizes, as in the reference (core/src/vdaf.rs:16,24).
VERIFY_KEY_LENGTH = 16
VERIFY_KEY_LENGTH_HMACSHA256_AES128 = 32


def prio3_count(num_shares: int = 2) -> Prio3:
    return Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, num_shares=num_shares)


def prio3_sum(bits: int, num_shares: int = 2) -> Prio3:
    return Prio3(FlpGeneric(Sum(bits)), ALG_PRIO3_SUM, num_shares=num_shares)


def prio3_sum_vec(length: int, bits: int, chunk_length: int, num_shares: int = 2) -> Prio3:
    return Prio3(
        FlpGeneric(SumVec(length=length, bits=bits, chunk_length=chunk_length, field=Field128)),
        ALG_PRIO3_SUMVEC,
        num_shares=num_shares,
    )


def prio3_histogram(length: int, chunk_length: int, num_shares: int = 2) -> Prio3:
    return Prio3(
        FlpGeneric(Histogram(length=length, chunk_length=chunk_length)),
        ALG_PRIO3_HISTOGRAM,
        num_shares=num_shares,
    )


def prio3_sum_vec_field64_multiproof_hmacsha256_aes128(
    proofs: int, length: int, bits: int, chunk_length: int, num_shares: int = 2
) -> Prio3:
    """The custom Daphne-interop VDAF (reference: core/src/vdaf.rs:178-195)."""
    if proofs < 2:
        raise ValueError("multiproof variant requires at least 2 proofs")
    return Prio3(
        FlpGeneric(SumVec(length=length, bits=bits, chunk_length=chunk_length, field=Field64)),
        ALG_PRIO3_SUMVEC_FIELD64_MULTIPROOF_HMACSHA256_AES128,
        num_shares=num_shares,
        num_proofs=proofs,
        xof=XofHmacSha256Aes128,
    )


def prio3_fixedpoint_bounded_l2_vec_sum(
    bitsize, length: int, num_shares: int = 2, chunk_length: int = None
) -> Prio3:
    """Fixed-point bounded-L2 vector sum (reference: core/src/vdaf.rs:88-91).

    ``bitsize``: 16 | 32 | "BitSize16" | "BitSize32" (the reference's enum).
    A ``dp_strategy`` key in the instance description is handled by the DP
    layer (core/dp.py), not the circuit — vdaf_from_instance strips it
    before construction.
    """
    bits = {16: 16, 32: 32, "BitSize16": 16, "BitSize32": 32}.get(bitsize)
    if bits is None:
        raise ValueError(f"unsupported bitsize {bitsize!r}")
    return Prio3(
        FlpGeneric(
            FixedPointBoundedL2VecSum(
                bits_per_entry=bits, entries=length, chunk_length=chunk_length
            )
        ),
        ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM,
        num_shares=num_shares,
    )


def _poplar1(bits: int):
    from .poplar1 import Poplar1

    return Poplar1(bits)


def _fake(rounds: int = 1):
    from .dummy import DummyVdaf

    return DummyVdaf(rounds)


def _fake_fails_prep_init(rounds: int = 1):
    from .dummy import FakeFailsPrepInit

    return FakeFailsPrepInit(rounds)


def _fake_fails_prep_step(rounds: int = 1):
    from .dummy import FakeFailsPrepStep

    return FakeFailsPrepStep(rounds)


# Serializable registry keyed the way the reference names instances
# (core/src/vdaf.rs:65-108).  Values: constructor taking the instance's
# params.  The Fake* test VDAFs mirror the reference's test-util instances
# (core/src/vdaf.rs:96-108): no real crypto, configurable round count,
# fault injection.
VDAF_INSTANCES: Dict[str, Callable[..., Prio3]] = {
    "Prio3Count": prio3_count,
    "Prio3Sum": prio3_sum,
    "Prio3SumVec": prio3_sum_vec,
    "Prio3Histogram": prio3_histogram,
    "Prio3SumVecField64MultiproofHmacSha256Aes128": prio3_sum_vec_field64_multiproof_hmacsha256_aes128,
    "Prio3FixedPointBoundedL2VecSum": prio3_fixedpoint_bounded_l2_vec_sum,
    "Poplar1": _poplar1,
    "Fake": _fake,
    "FakeFailsPrepInit": _fake_fails_prep_init,
    "FakeFailsPrepStep": _fake_fails_prep_step,
}


def vdaf_from_instance(instance: Dict[str, Any]) -> Prio3:
    """Instantiate from a serialized description, e.g.
    ``{"type": "Prio3Histogram", "length": 1024, "chunk_length": 316}``.
    Backends are built from the result by ``aggregator.resolve_backend``.
    """
    kind = instance["type"]
    if kind not in VDAF_INSTANCES:
        raise ValueError(f"unknown VDAF instance: {kind}")
    # dp_strategy rides inside the instance description (the reference keeps
    # it in the VdafInstance variants, collection_job_driver.rs:98); it is
    # not a circuit parameter.
    params = {k: v for k, v in instance.items() if k not in ("type", "dp_strategy")}
    vdaf = VDAF_INSTANCES[kind](**params)
    vdaf.instance = dict(instance)
    return vdaf
