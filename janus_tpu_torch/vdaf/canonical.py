"""Pow2 shape canonicalization: tasks of one circuit family share a backend.

Counterpart of ``janus_tpu/vdaf/canonical.py``, with the same plans, keys
and fallback reasons.  Every distinct circuit parameterization —
Histogram(length=1000) vs (length=1024), Sum(bits=17) vs (bits=20) — is
otherwise its own executor bucket, so tasks of one family never share a
flush: under taskprov, many DAP tasks of one family with different lengths
are the normal case.  This module maps a task's VDAF to a CANONICAL twin
whose parameter axes are rounded up to a small bucket set, so that every
task in a bucket shares ONE backend instance and ONE executor bucket: two
half-empty flushes become one.

The contract is strict bit-exactness: the twin's masked row-path prepare
(``ops/prepare.py``), given a task's reports plus a per-row ``meas_len``
input, produces byte-identical prepare outputs to the task's own
(unpadded) oracle — for ARBITRARY (adversarial) report content, not just
honest reports.  That works because:

* Wire polynomials in the FLP are interpolated over the P = 2^k roots of
  unity with ZERO values at unused gadget calls, so padding the call axis
  within one P class and zero-masking the padded calls' barycentric
  coefficients reproduces the exact polynomial.
* The gadget polynomial's length (``glen = DEGREE*(P-1)+1``) and the
  verifier layout (``VERIFIER_LEN = 2 + ARITY``) depend only on (P,
  chunk), not on the measurement length — the wire formats of proofs and
  prepare shares are IDENTICAL across a bucket.
* XOF expansions are prefix-stable: expanding MORE elements from a
  TurboSHAKE stream yields the same leading elements (rejection sampling
  only widens the ``ok=False`` oracle-recompute window, which is exact by
  construction).
* The one length-dependent XOF *message* (the joint-randomness part,
  whose binder embeds ``enc(meas)``) is absorbed with a per-row
  length-selected sponge (``ops/keccak.turboshake128_batch_select`` and
  its K2 select kernel) that is byte-identical to absorbing the row's true
  message.

The bucket set per (circuit, chunk) class is {2^k} ∪ {2^k - 1} gadget
calls: ``calls`` rounds up to ``min(next_pow2(calls), P-1)``, which is
the largest padding that provably preserves P (P = next_pow2(1+calls)
must not change — the roots of unity ARE the circuit).  Shapes where any
parity precondition cannot be verified — multiproof instances (their
joint/query-rand streams interleave per proof, breaking prefix
stability), non-TurboSHAKE XOFs, circuits without a padded twin — keep
their exact shape: ``canonical_vdaf_for`` returns None and the executor
keys the backend by the exact ``vdaf_shape_key``.
"""

from __future__ import annotations

from typing import Tuple

from ..fields import next_power_of_2
from ..xof import XofTurboShake128

__all__ = [
    "backend_shape_key",
    "canonical_vdaf_for",
    "canonicalization_reason",
    "clip_agg_vector",
    "clip_to_width",
    "executor_shape",
    "plan_stats",
]


def _canonical_calls(calls: int) -> int:
    """Round a gadget-call count up within its P class.

    P = next_pow2(1 + calls) is load-bearing (the wire polynomials live
    on the P-th roots of unity), so the bucket ceiling is P - 1; below
    it, calls round to the next power of two.  Bucket set per class:
    {2^k, 2^k - 1} — O(log N) buckets over N lengths."""
    P = next_power_of_2(1 + calls)
    return min(next_power_of_2(calls), P - 1)


def _build_canonical(vdaf):
    """The padded circuit twin, or None when no padding applies."""
    from ..flp import (
        FixedPointBoundedL2VecSum,
        FlpGeneric,
        Histogram,
        Sum,
        SumVec,
    )
    from .prio3 import Prio3

    valid = vdaf.flp.valid
    calls = valid.GADGET_CALLS[0]
    c_calls = _canonical_calls(calls)
    if isinstance(valid, FixedPointBoundedL2VecSum):
        # TWO gadgets chunk over different axes: bit checks over MEAS_LEN
        # = entries*n + (2n-2), entry squares over entries.  Pad ENTRIES
        # to the largest count that keeps BOTH gadgets' call counts within
        # their P classes (the per-gadget rounding of _canonical_calls);
        # _parity_preconditions then re-verifies every P from the built
        # twin — the bucket set stays O(log N) over N entry counts.
        chunk = valid.chunk_length
        nb = valid.bits_per_entry
        c_sq = _canonical_calls(valid.GADGET_CALLS[1])
        by_bits = (c_calls * chunk - valid.bits_for_norm) // nb
        by_sq = c_sq * chunk
        entries = min(by_bits, by_sq)
        if entries <= valid.entries:
            return None
        twin = FixedPointBoundedL2VecSum(
            bits_per_entry=nb,
            entries=entries,
            chunk_length=chunk,
            field=valid.field,
        )
    elif isinstance(valid, Histogram):
        length = c_calls * valid.chunk_length
        if length == valid.length:
            return None  # already canonical: keep the exact backend
        twin = Histogram(length, valid.chunk_length, field=valid.field)
    elif isinstance(valid, SumVec):
        # MEAS_LEN = length*bits must stay a multiple of bits, so the
        # padded length is the largest one whose call count fits the
        # bucket; the validator below re-derives P and rejects any edge
        # case where flooring dropped out of the class.
        length = (c_calls * valid.chunk_length) // valid.bits
        if length == valid.length:
            return None
        twin = SumVec(length, valid.bits, valid.chunk_length, field=valid.field)
    elif isinstance(valid, Sum):
        if c_calls == valid.bits:
            return None
        twin = Sum(c_calls)
    else:
        return None  # Count has no parameter axis; others have no twin
    return Prio3(
        FlpGeneric(twin),
        vdaf.algorithm_id,
        num_shares=vdaf.num_shares,
        num_proofs=vdaf.num_proofs,
        xof=vdaf.xof,
    )


def _parity_preconditions(vdaf, canon) -> Tuple[bool, str]:
    """Verify — never assume — that the canonical prepare can be bit-exact
    for this task.  Every check here guards a concrete mechanism the
    masked prepare relies on; any failure keeps the exact shape."""
    a, c = vdaf.flp, canon.flp
    av, cv = a.valid, c.valid
    if len(av.GADGET_CALLS) != len(cv.GADGET_CALLS):
        return False, "gadget count differs across the bucket"
    for ac, cc in zip(av.GADGET_CALLS, cv.GADGET_CALLS):
        if next_power_of_2(1 + ac) != next_power_of_2(1 + cc):
            return False, "padding changed P (the interpolation roots)"
    if a.PROOF_LEN != c.PROOF_LEN or a.VERIFIER_LEN != c.VERIFIER_LEN:
        return False, "proof/verifier wire width differs across the bucket"
    if a.QUERY_RAND_LEN != c.QUERY_RAND_LEN:
        return False, "query-rand stream width differs across the bucket"
    if getattr(av, "chunk_length", None) != getattr(cv, "chunk_length", None):
        return False, "chunk_length differs (gadget arity is the wire format)"
    if getattr(av, "bits_per_entry", None) != getattr(cv, "bits_per_entry", None):
        return False, "bits_per_entry differs (the entry layout is the wire format)"
    if a.MEAS_LEN > c.MEAS_LEN or a.OUTPUT_LEN > c.OUTPUT_LEN:
        return False, "canonical shape smaller than actual"
    if a.JOINT_RAND_LEN > c.JOINT_RAND_LEN:
        return False, "joint-rand stream would truncate"
    if av.field is not cv.field:
        return False, "field differs"
    return True, ""


#: shape_key -> (canonical twin | None, reason).  The plan is a pure
#: function of the shape, and drain consumers ask per merge — memoizing
#: makes the steady-state cost a dict hit (twin instances are stateless
#: parameter records, safe to share).
_PLAN_CACHE: dict = {}


def _plan(vdaf):
    """(canonical twin or None, exact-shape reason) — memoized by shape."""
    from .backend import vdaf_shape_key
    from .prio3 import Prio3

    if not isinstance(vdaf, Prio3):
        return None, f"{type(vdaf).__name__} is not Prio3"
    key = vdaf_shape_key(vdaf)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    if vdaf.xof is not XofTurboShake128:
        plan = (None, "length-selected absorb requires the TurboSHAKE XOF")
    elif vdaf.num_proofs != 1:
        plan = (None, "multiproof rand streams are not prefix-stable")
    else:
        try:
            canon = _build_canonical(vdaf)
        except Exception as e:  # e.g. Sum(bits) ceiling past the field width
            canon, reason = None, f"no canonical twin: {e}"
        else:
            if canon is None:
                reason = "shape is its own bucket ceiling"
            else:
                ok, reason = _parity_preconditions(vdaf, canon)
                if not ok:
                    canon = None
        plan = (canon, "" if canon is not None else reason)
    _PLAN_CACHE[key] = plan
    return plan


def canonicalization_reason(vdaf) -> str:
    """Why this VDAF keeps its exact shape ("" when it canonicalizes)."""
    return _plan(vdaf)[1]


def plan_stats() -> dict:
    """Counted plan outcomes across every shape this process has resolved
    (the memoized _PLAN_CACHE): how many canonicalized, and the per-reason
    counts of shapes that kept their exact shape.  /statusz shows it under
    ``canonicalization``, so an operator can see why a fleet's bucket count
    does not collapse."""
    reasons: dict = {}
    canonicalized = 0
    for canon, reason in list(_PLAN_CACHE.values()):
        if canon is not None:
            canonicalized += 1
        else:
            reasons[reason] = reasons.get(reason, 0) + 1
    return {
        "planned": len(_PLAN_CACHE),
        "canonicalized": canonicalized,
        "exact_reasons": reasons,
    }


def canonical_vdaf_for(vdaf):
    """The canonical Prio3 twin this task's prepare runs as, or None when
    the task must keep an exact-shape backend (including when the task
    already sits on its bucket ceiling — a ceiling shape keeps its
    maskless exact prepare, and with it the planar kernels (K3, K5) that
    the masked row path forgoes)."""
    return _plan(vdaf)[0]


def executor_shape(vdaf, enabled: bool = True):
    """(backend cache key, canonical vdaf or None) for the device
    executor.  Tasks mapping to one canonical twin share the key — one
    backend instance, one executor bucket.  Shared by the job drivers and
    the helper aggregator so both protocol sides keep landing in the same
    buckets and breaker domains.

    Canonical keys carry a distinguishing tag: a bucket-CEILING task
    (its own twin — e.g. Histogram(6,2) in the {5,6} bucket) keeps the
    EXACT key and an exact maskless backend, and that key must never
    collide with the bucket's canonical entry — whichever task resolved
    first would otherwise decide the backend mode for every bucket
    member (a maskless exact backend served to a shorter member computes
    the wrong circuit)."""
    from .backend import vdaf_shape_key

    canon = canonical_vdaf_for(vdaf) if enabled else None
    if canon is None:
        return vdaf_shape_key(vdaf), None
    return ("canon",) + vdaf_shape_key(canon), canon


def backend_shape_key(backend):
    """The executor cache/bucket key a RESOLVED backend serves under —
    derived from the backend ITSELF, so the submit key can never diverge
    from the cache entry.  This matters on the fallback path: when a
    canonical twin build fails, the driver caches an exact-shape backend
    under the exact key, and re-deriving the key from the task's vdaf
    would aim submissions at the (empty) canonical bucket — binding a
    wrong-shaped backend to it for every later bucket member."""
    from .backend import vdaf_shape_key

    key = vdaf_shape_key(backend.vdaf)
    if getattr(backend, "canonical", False):
        return ("canon",) + key
    return key


def clip_agg_vector(vdaf, vector):
    """Clip a drained accumulator vector from canonical OUTPUT_LEN back to
    the task's (:func:`clip_to_width` at ``vdaf``'s OUTPUT_LEN)."""
    return clip_to_width(vector, vdaf.flp.OUTPUT_LEN)


def clip_to_width(vector, width):
    """A bucket-width vector clipped to its task's ``width``.  The
    canonical pad tail is provably zero (padded measurement columns are
    zero-masked through truncate), so clipping is exact — and a nonzero
    tail means the parity contract broke, which must fail LOUDLY, never
    aggregate.  The accumulator store clips every readback of a canonical
    bucket here."""
    if vector is None or width is None or len(vector) <= width:
        return vector
    if any(vector[width:]):
        from .prio3 import VdafError

        raise VdafError(
            "canonical accumulator pad tail is nonzero "
            f"({len(vector)} drained, {width} expected)"
        )
    return list(vector[:width])
