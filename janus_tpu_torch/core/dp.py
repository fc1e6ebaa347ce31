"""Differential privacy: exact discrete-Gaussian noise for aggregate shares.

The analog of the reference's DP layer (reference: core/src/dp.rs — strategy
types dispatched per VDAF instance; the noise hook is
aggregator/src/aggregator/collection_job_driver.rs:338-344
``add_noise_to_agg_share``, with the distributions provided by the prio
crate's ``ZCdpDiscreteGaussian``).

The sampler is the Canonne–Kamath–Steinke exact discrete Gaussian
(arXiv:2004.00010, Algorithms 1-3), implemented from the paper's
description: all arithmetic is exact rational/integer, randomness comes
from ``secrets``-grade entropy, and there is no floating point anywhere on
the sampling path — so the output distribution is exactly
N_Z(0, sigma^2) with no floating-point privacy leaks.

Budget semantics match prio's ``ZCdpDiscreteGaussian``: a budget epsilon
applied to a query with L2 sensitivity Delta adds noise with
sigma = Delta / epsilon per coordinate, which yields (epsilon^2)/2-zCDP.
Sensitivity bounds per VDAF are the replacement-adjacency L2 bounds of the
truncated measurement vectors.
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Dict, List, Optional


class DpError(Exception):
    pass


# -- exact sampling primitives (CKS arXiv:2004.00010) -----------------------

def _randbelow(n: int) -> int:
    return secrets.randbelow(n)


def _bernoulli(p: Fraction) -> bool:
    """Exact Bernoulli(p) for rational p in [0, 1]."""
    return _randbelow(p.denominator) < p.numerator


def _bernoulli_exp1(gamma: Fraction) -> bool:
    """Bernoulli(exp(-gamma)) for 0 <= gamma <= 1 (CKS Algorithm 1)."""
    k = 1
    while _bernoulli(gamma / k):
        k += 1
    return k % 2 == 1


def _bernoulli_exp(gamma: Fraction) -> bool:
    """Bernoulli(exp(-gamma)) for gamma >= 0."""
    while gamma > 1:
        if not _bernoulli_exp1(Fraction(1)):
            return False
        gamma -= 1
    return _bernoulli_exp1(gamma)


def _geometric_exp_slow(gamma: Fraction) -> int:
    """Geometric: P[K = k] = (1 - e^-gamma) e^(-gamma k)."""
    k = 0
    while _bernoulli_exp(gamma):
        k += 1
    return k


def _geometric_exp_fast(gamma: Fraction) -> int:
    """Same distribution, O(1 + gamma) expected Bernoulli-exp trials."""
    if gamma == 0:
        return 0
    s, t = gamma.numerator, gamma.denominator
    while True:
        u = _randbelow(t)
        if _bernoulli_exp(Fraction(u, t)):
            break
    v = _geometric_exp_slow(Fraction(1))
    return (v * t + u) // s


def sample_discrete_laplace(scale: Fraction) -> int:
    """Exact discrete Laplace: P[X = x] proportional to exp(-|x|/scale)."""
    if scale <= 0:
        raise DpError("discrete Laplace scale must be positive")
    while True:
        negative = _bernoulli(Fraction(1, 2))
        magnitude = _geometric_exp_fast(1 / scale)
        if negative and magnitude == 0:
            continue
        return -magnitude if negative else magnitude


def sample_discrete_gaussian(sigma: Fraction) -> int:
    """Exact discrete Gaussian N_Z(0, sigma^2) (CKS Algorithm 3)."""
    if sigma <= 0:
        raise DpError("discrete Gaussian sigma must be positive")
    t = math.floor(sigma) + 1
    sigma2 = sigma * sigma
    while True:
        candidate = sample_discrete_laplace(Fraction(t))
        bias = (Fraction(abs(candidate)) - sigma2 / t) ** 2 / (2 * sigma2)
        if _bernoulli_exp(bias):
            return candidate


# -- strategies -------------------------------------------------------------

class NoDifferentialPrivacy:
    """No-op strategy (reference: core/src/dp.rs:38)."""

    def add_noise_to_agg_share(self, vdaf, agg_share: List[int], report_count: int):
        return agg_share

    def to_dict(self) -> Dict[str, Any]:
        return {"dp_mechanism": "NoDifferentialPrivacy"}


def _sqrt_frac_upper(x: Fraction, precision: int = 10**12) -> Fraction:
    """Rational upper bound on sqrt(x): ceil(sqrt(x * p^2)) / p."""
    num = x.numerator * precision * precision
    r = math.isqrt(num // x.denominator) + 1
    return Fraction(r, precision)


def l2_sensitivity(vdaf_instance: Dict[str, Any]) -> Fraction:
    """Replacement-adjacency L2 sensitivity of one report's aggregate
    contribution, as a rational UPPER bound (rounding up never weakens the
    privacy guarantee)."""
    kind = vdaf_instance.get("type")
    if kind == "Prio3Count":
        return Fraction(1)
    if kind == "Prio3Sum":
        return Fraction((1 << vdaf_instance["bits"]) - 1)
    if kind == "Prio3Histogram":
        # one-hot contribution: replacing a report moves two buckets by 1.
        return _sqrt_frac_upper(Fraction(2))
    if kind in ("Prio3SumVec", "Prio3SumVecField64MultiproofHmacSha256Aes128"):
        per_elem = (1 << vdaf_instance["bits"]) - 1
        return per_elem * _sqrt_frac_upper(Fraction(vdaf_instance["length"]))
    if kind == "Prio3FixedPointBoundedL2VecSum":
        # The circuit enforces ||x||_2 <= 1.0 in fixed point with 2^(b-1)
        # integer scale, so replacement moves the aggregate by <= 2 * 2^(b-1)
        # in field units (reference: core/src/vdaf.rs:88-91; the fpvec DP
        # support is the one place the reference wires real noise).
        bits = {16: 16, 32: 32, "BitSize16": 16, "BitSize32": 32}[
            vdaf_instance["bitsize"]
        ]
        return Fraction(1 << bits)
    raise DpError(f"no L2 sensitivity bound for VDAF type {kind!r}")


@dataclass
class ZCdpDiscreteGaussian:
    """Discrete-Gaussian strategy under a zCDP budget.

    sigma = sensitivity / epsilon per coordinate => (epsilon^2)/2-zCDP
    (prio's ZCdpDiscreteGaussian semantics).
    """

    epsilon: Fraction

    def __post_init__(self):
        if self.epsilon <= 0:
            raise DpError("epsilon must be positive")

    def sigma_for(self, vdaf) -> Fraction:
        return l2_sensitivity(getattr(vdaf, "instance", None) or vdaf) / self.epsilon

    def add_noise_to_agg_share(self, vdaf, agg_share: List[int], report_count: int):
        """agg_share: canonical field-element ints; noise is added mod p.

        Matches the reference hook's signature/semantics
        (collection_job_driver.rs:338-344): one independent discrete
        Gaussian per coordinate of the aggregate share.
        """
        p = vdaf.flp.field.MODULUS
        sigma = self.sigma_for(vdaf)
        return [(x + sample_discrete_gaussian(sigma)) % p for x in agg_share]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "dp_mechanism": "ZCdpDiscreteGaussian",
            "epsilon": [self.epsilon.numerator, self.epsilon.denominator],
        }


def dp_strategy_from_dict(d: Optional[Dict[str, Any]]):
    """Parse a task's serialized DP strategy (stored inside the VDAF
    instance JSON, mirroring the reference's per-VdafInstance dp_strategy
    dispatch, aggregator/src/aggregator/collection_job_driver.rs:98)."""
    if isinstance(d, str):  # legacy string tag form
        if d == "NoDifferentialPrivacy":
            return NoDifferentialPrivacy()
        raise DpError(f"unknown dp_strategy tag {d!r}")
    if not d or d.get("dp_mechanism") in (None, "NoDifferentialPrivacy"):
        return NoDifferentialPrivacy()
    if d["dp_mechanism"] == "ZCdpDiscreteGaussian":
        num, den = d["epsilon"]
        return ZCdpDiscreteGaussian(Fraction(num, den))
    raise DpError(f"unknown dp_mechanism {d['dp_mechanism']!r}")
