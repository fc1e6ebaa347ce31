"""Batched Prio3 prepare on the card: Count, Sum, SumVec, Histogram and
FixedPointBoundedL2VecSum.

Counterpart of ``janus_tpu/ops/prepare.py``.  Two prepares, each
byte-identical to the oracle ``janus_tpu_torch.vdaf.prio3``:

- ``prep_init_planar`` (Histogram, SumVec with bits == 1): per-report tensors
  keep the report axis last; share streams are word-major planes (W, B)
  straight out of the Keccak kernels and field tensors are (elems, n, B),
  the same memory as a stream of those elements.  The wire kernels (K3
  histogram, K5 SumVec) and the planar combine (K4) carry the heavy work.
- ``prep_init`` (every circuit; the one path for Count, Sum, SumVec with
  bits > 1, FixedPointBoundedL2VecSum, any circuit with more than one
  proof, Histogram with MEAS_LEN > 65535 and any batch past 65535):
  row-major (B, elems, n) tensors with the limb axis last, every gadget of
  the circuit and every proof in turn.  The JAX
  package's limb-planar Count/Sum path exists for the TPU's lane layout;
  on the card the row path is the faster of the two (PERF.md), so the port
  has no such path.

Every path expands shares and randomness through the K1 squeeze and absorbs
multi-block joint-rand messages through the K2 absorb; the small
coefficient work around the kernels is plain PyTorch on the same device.

Canonical shape padding (``vdaf/canonical.py``): ``prep_init`` of a bucket's
padded twin takes each row's true measurement length (``meas_len``).
Measurement columns at or past it are zeroed, the joint-rand part is
absorbed at the row's own message length by the K2 select kernel, and
per-gadget ``calls_live`` masks zero the padded calls' gadget outputs and
barycentric coefficients, so every output equals the row's own task's
oracle.  The planar path takes no masks: a masked batch runs row-major.

Montgomery convention as in the JAX package: bulk tensors (shares, wires,
verifiers, out shares) stay canonical; the per-report scalars that multiply
them (joint rand r, query point t, Lagrange coefficients, constants) are in
Montgomery form, so ``mont_mul(canonical, montgomery)`` lands canonical.

Served: every Prio3 circuit with any number of proofs.  The XOF runs on the
card only for TurboSHAKE128; for another XOF (the HMAC multiproof SumVec)
``BatchedPrio3(require_device_xof=False)`` serves the XOF-free
``query_batch``/``decide_batch`` to ``vdaf.backend.HybridXofBackend``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fields import next_power_of_2
from ..flp.circuits import Count, FixedPointBoundedL2VecSum, Histogram, Sum, SumVec
from ..vdaf.prio3 import (
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RAND_SEED,
    USAGE_JOINT_RANDOMNESS,
    USAGE_MEAS_SHARE,
    USAGE_PROOF_SHARE,
    USAGE_QUERY_RANDOMNESS,
    Prio3,
)
from ..state import consts_from_numpy
from ..xof import XofTurboShake128
from .field import M16, M32, TField, field_words, limb_list, limb_stack, storage, words
from .flp_kernels import combine_decide, sumvec_wires, wire_evals
from .keccak import RATE, RATE_WORDS, bytes_to_words, words_to_bytes
from .keccak_kernels import absorb_planes, absorb_select, const_word_planes, rows_to_planes, xof_planes, xof_words
from .xof import xof_next_vec_batch

#: The planar lazy sums (meas_sum, aggregate) add u16 halves in int64 like
#: the JAX u32 sums they mirror, which are exact only up to this many terms.
LAZY_SUM_MAX = 65535
#: Gadget outputs on the row path and the SumVec planar path take an NTT
#: over the P-th roots from this P up, and a Horner scan below it, as the
#: JAX package does.
NTT_MIN_P = 64
#: The row path's field layouts (``BatchedPrio3(field_backend=)``).
FIELD_BACKENDS = ("vpu", "mxu")


def _ones(f: TField, B: int, device) -> List[torch.Tensor]:
    """Montgomery one as a limb list of (B,) planes."""
    return [torch.full((B,), int(v), dtype=torch.int64, device=device) for v in f.mont_one_np]


def _pow_range_planes(f: TField, x: List, count: int) -> torch.Tensor:
    """x^1..x^count (Montgomery), x limb lists (B,) -> (count, n, B)."""
    out = f.pow_range_limbs(x, count)  # n tensors (B, count)
    return torch.stack(out, dim=0).permute(2, 0, 1)


def _sum_limbs(f: TField, x: List) -> List:
    """Modular sum over the leading axis of limb lists (K, B) -> (B,), by
    u16 halves and one fold (exact for K <= LAZY_SUM_MAX)."""
    slo = [torch.sum(t & M16, dim=0) for t in x]
    shi = [torch.sum(t >> 16, dim=0) for t in x]
    return f.lazy_fold_limbs(slo, shi)


class _GadgetPlan:
    """Static shape of one gadget: calls, wire arity/degree, interpolation
    modulus P = next_pow2(1 + calls) and gadget-polynomial length."""

    __slots__ = ("calls", "arity", "degree", "P", "glen")

    def __init__(self, calls: int, arity: int, degree: int):
        self.calls = calls
        self.arity = arity
        self.degree = degree
        self.P = next_power_of_2(1 + calls)
        self.glen = degree * (self.P - 1) + 1


class _DeviceCircuit:
    """Device twin of one FLP validity circuit, with one plan per gadget.

    Subclasses give ``inputs``, ``v``, ``truncate`` and
    ``gadget_eval_scaled`` on row-major tensors (B, ..., n): meas, gk and
    wires canonical, jr_m Montgomery (None without joint randomness).  The
    single-gadget circuits keep gadget 0's plan under ``calls``, ``arity``,
    ``P`` and ``glen``, which the planar path reads; a circuit with more
    gadgets (FixedPointBoundedL2VecSum) overrides the per-gadget hooks
    ``wire_evals_g`` and ``v_multi``.

    ``mxu`` takes the contractions over calls and bits (the wire
    evaluations' Lagrange folds, the weighted truncates and bit
    recompositions, the joint-rand fold of Sum) through the limb-digit
    matmul (``TField.mat_mul_mont``/``dot_mont``) in place of mont_mul/sum
    trees: the same canonical limbs, computed as matmuls."""

    def __init__(self, valid, mxu: bool = False):
        self.valid = valid
        self.mxu = mxu
        self.plans = [
            _GadgetPlan(calls, g.ARITY, g.DEGREE)
            for g, calls in zip(valid.new_gadgets(), valid.GADGET_CALLS)
        ]
        p0 = self.plans[0]
        self.calls, self.arity, self.degree = p0.calls, p0.arity, p0.degree
        self.P, self.glen = p0.P, p0.glen

    def calls_live_list(self, ml: torch.Tensor) -> List[torch.Tensor]:
        """Per-gadget live-call counts (B,) of rows whose true measurement
        length is ``ml`` (B,): the mask boundary of the barycentric
        coefficients and of the gadget-output fold under canonical padding.
        One gadget over ``chunk`` measurement columns a call (1 for Sum):
        ceil(ml / chunk)."""
        chunk = getattr(self.valid, "chunk_length", 1)
        return [(ml + chunk - 1) // chunk]

    def wire_evals_g(self, gi: int, f: TField, meas, jr_m, lag, seeds, consts, ml=None) -> torch.Tensor:
        """Wire evaluations of gadget ``gi`` (only 0 here); ``ml`` (B,) is
        the rows' true measurement length under canonical padding, read
        only by length-dependent gadget inputs (FixedPointBoundedL2VecSum's
        entries)."""
        return self.wire_evals(f, meas, jr_m, lag, seeds, consts)

    def v_multi(self, f: TField, gks: List[torch.Tensor], meas, jr_m, consts, ml=None) -> torch.Tensor:
        """Circuit output from one (B, calls_g, n) gadget-output tensor per
        gadget."""
        return self.v(f, gks[0], meas, jr_m, consts)

    def wire_evals(self, f: TField, meas, jr_m, lag, seeds, consts) -> torch.Tensor:
        """Wire-polynomial evaluations at t, (B, arity, n) canonical, from
        the gadget-input tensor.  lag (B, K, n) Montgomery barycentric
        coefficients, seeds (B, arity, n) canonical."""
        inp = self.inputs(f, meas, jr_m, consts)  # (B, calls, arity, n)
        wires = torch.cat([seeds[:, None], inp], dim=1)  # (B, K, arity, n)
        if self.mxu:
            return f.dot_mont(wires, lag)
        return f.sum(f.mont_mul(wires, lag[:, :, None, :]), axis=1)


class _DCount(_DeviceCircuit):
    """Count: one Mul call on [m0, m0]; Field64, no joint randomness."""

    def inputs(self, f, meas, jr_m, consts):
        m0 = meas[:, 0:1]  # (B, 1, n)
        return torch.stack([m0, m0], dim=2)  # (B, 1, 2, n)

    def v(self, f, gk, meas, jr_m, consts):
        return f.sub(gk[:, 0], meas[:, 0])

    def truncate(self, f, meas, consts, ml=None):
        return meas

    def gadget_eval_scaled(self, f, x):
        """Mul on canonical wires (B, 2, n), scaled by R^-1."""
        return f.mont_mul(x[:, 0], x[:, 1])


class _DSum(_DeviceCircuit):
    """Sum: one Range2 call a bit, weighted by r^(k+1) into v."""

    def inputs(self, f, meas, jr_m, consts):
        return meas[:, :, None, :]  # (B, bits, 1, n)

    def v(self, f, gk, meas, jr_m, consts):
        r = jr_m[:, 0]  # (B, n) Montgomery
        r_pows = f.cumprod_mont(r[:, None, :].expand(gk.shape), axis=1)  # r^(k+1) at call k
        if self.mxu:
            return f.dot_mont(gk[:, :, None, :], r_pows).squeeze(1)
        return f.sum(f.mont_mul(r_pows, gk), axis=1)

    def truncate(self, f, meas, consts, ml=None):
        if self.mxu:
            # the bit weights are one constant vector shared by every row
            return f.dot_mont(meas[:, :, None, :], consts["pow2_m"])
        return f.sum(f.mont_mul(meas, consts["pow2_m"][None]), axis=1)[:, None, :]

    def gadget_eval_scaled(self, f, x):
        """(x^2 - x) R^-1 from canonical x: x*x*R^-1 - x*1*R^-1."""
        x0 = x[:, 0]
        return f.sub(f.mont_mul(x0, x0), f.from_mont(x0))


class _DChunked(_DeviceCircuit):
    """Shared machinery for the ParallelSum(Mul, chunk) circuits."""

    def __init__(self, valid, mxu: bool = False):
        super().__init__(valid, mxu)
        self.chunk = valid.chunk_length
        #: the circuit's zero padding of the last call (positions
        #: MEAS_LEN..calls*chunk-1, applied inside the wire kernels)
        self.pad_len = self.calls * self.chunk - valid.MEAS_LEN

    def _blocks(self, f, meas):
        """(B, MEAS_LEN, n) -> zero-padded (B, calls, chunk, n)."""
        B = meas.shape[0]
        if self.pad_len:
            zeros = torch.zeros((B, self.pad_len, f.n), dtype=meas.dtype, device=meas.device)
            meas = torch.cat([meas, zeros], dim=1)
        return meas.reshape(B, self.calls, self.chunk, f.n)

    def _lag_fold(self, f, m, lagk):
        """sum_k m[k, u] lag_{k+1}: m (B, calls, chunk, n) canonical, lagk
        (B, calls, n) Montgomery -> (B, chunk, n) canonical."""
        if self.mxu:
            return f.dot_mont(m, lagk)
        return f.sum(f.mont_mul(m, lagk[:, :, None, :]), axis=1)

    def _zip_wires(self, f, evens, s2, lag0, ccorr, seeds):
        """The row wires [seed_i lag_0 + (evens|odds)[u]] from the even
        evaluations and s2 = ``_lag_fold`` of m, with odds[u] = s2[u] -
        ccorr, where ccorr = (1/shares) sum_k lag_{k+1} canonical (B, n)
        (mont_mul distributes over mod-p addition)."""
        B = evens.shape[0]
        odds = f.sub(s2, ccorr[:, None, :])
        pair = torch.stack([evens, odds], dim=2).reshape(B, 2 * self.chunk, f.n)
        return f.add(f.mont_mul(seeds, lag0[:, None, :]), pair)

    def gadget_eval_scaled(self, f: TField, x: torch.Tensor) -> torch.Tensor:
        """ParallelSum(Mul) on canonical wires (B, arity, n), scaled by R^-1."""
        B, arity, n = x.shape
        pairs = x.reshape(B, arity // 2, 2, n)
        return f.sum(f.mont_mul(pairs[:, :, 0], pairs[:, :, 1]), axis=1)

    def truncate(self, f, meas, consts, ml=None):
        """The out share of a histogram or of a one-bit SumVec is the
        measurement share itself (the weighted bit sum over one bit is the
        identity), so no MEAS_LEN-wide multiply runs."""
        return meas


class _DHistogram(_DChunked):
    def wire_evals(self, f, meas, jr_m, lag, seeds, consts):
        """The K3 formula on rows, with the coefficients of
        ``planar_coeffs`` (the same code that feeds the kernel, so the two
        paths cannot drift):
        evens[u] = (sum_k m[k,u] kl[k]) r_ch[u], odds[u] = sum_k m[k,u]
        lag_{k+1} - ccorr."""
        m = self._blocks(f, meas)
        rch, kl, lagk, lag0, ccorr = self.planar_coeffs(f, jr_m.permute(1, 2, 0), lag.permute(1, 2, 0), consts)
        rch, kl, lagk = (x.permute(2, 0, 1) for x in (rch, kl, lagk))
        if self.mxu:
            # both folds read m: the kl and lagk columns stack into one
            # right operand (B, calls, 2, n), one contraction
            s12 = f.mat_mul_mont(m, torch.stack([kl, lagk], dim=2))
            s1, s2 = s12[:, :, 0], s12[:, :, 1]
        else:
            s1 = f.sum(f.mont_mul(m, kl[:, :, None, :]), axis=1)  # (B, chunk, n)
            s2 = self._lag_fold(f, m, lagk)
        return self._zip_wires(f, f.mont_mul(s1, rch), s2, lag0.T, ccorr.T, seeds)

    def v(self, f, gk, meas, jr_m, consts):
        meas_sum = f.sum(meas, axis=1)  # (B, n)
        v = self.v_from_meas_sum(f, limb_list(gk.permute(1, 2, 0)), limb_list(meas_sum.T), jr_m.permute(1, 2, 0), consts)
        return limb_stack(v).T

    def v_from_meas_sum(self, f: TField, gk: List, meas_sum: List, jr_m: torch.Tensor, consts) -> List:
        """Circuit output v (limb lists over the report axis).

        gk: limb lists of (calls, B) canonical gadget outputs; meas_sum:
        limb lists (B,) canonical; jr_m: (2, n, B) Montgomery planes [r, r1]."""
        range_check = _sum_limbs(f, gk)
        c = consts["shares_inv_c"]
        sum_check = f.sub_limbs(meas_sum, [c[l] for l in range(f.n)])
        jr1 = limb_list(jr_m[1])
        return f.add_limbs(
            f.mont_mul_limbs(jr1, range_check),
            f.mont_mul_limbs(f.mont_mul_limbs(jr1, jr1), sum_check),
        )

    def planar_coeffs(self, f: TField, jr_m: torch.Tensor, lag: torch.Tensor, consts):
        """Coefficient planes of the wire kernel from jr_m (2, n, B) and lag
        (K, n, B): (rch (chunk, n, B), kl (calls, n, B), lagk (calls, n, B),
        lag0 (n, B), ccorr (n, B)).  r^(k*chunk + u + 1) = r^(k*chunk) *
        r^(u+1) splits the global joint-rand power into the per-call kl and
        the per-column r_ch."""
        B = lag.shape[-1]
        r = limb_list(jr_m[0])
        rch = _pow_range_planes(f, r, self.chunk)
        rc = limb_list(rch[self.chunk - 1])  # r^chunk
        r_call = [_ones(f, B, lag.device)]
        for _ in range(self.calls - 1):
            r_call.append(f.mont_mul_limbs(r_call[-1], rc))
        r_call_t = torch.stack([limb_stack(x) for x in r_call], dim=0)  # (calls, n, B)
        lagk = lag[1 : 1 + self.calls]
        kl = limb_stack(f.mont_mul_limbs(limb_list(r_call_t), limb_list(lagk)))
        c = consts["shares_inv_c"]
        ccorr = limb_stack(f.mont_mul_limbs([c[l].expand(B) for l in range(f.n)], _sum_limbs(f, limb_list(lagk))))
        return rch, kl, lagk, lag[0], ccorr


class _DSumVec(_DChunked):
    """SumVec: per-call joint rand, power resetting each call."""

    def wire_evals(self, f, meas, jr_m, lag, seeds, consts):
        """evens[u] = sum_k m[k,u] jr_k^(u+1) lag_{k+1}: lag folds into the
        per-(k, u) power table, so no (B, calls, arity, n) tensor is made."""
        m = self._blocks(f, meas)
        lag0, lagk = lag[:, 0], lag[:, 1:]
        r_pows = f.cumprod_mont(jr_m[:, :, None, :].expand(m.shape), axis=2)
        rl = f.mont_mul(r_pows, lagk[:, :, None, :])
        # the evens' coefficient varies over both axes, so it is no matmul
        evens = f.sum(f.mont_mul(m, rl), axis=1)  # (B, chunk, n)
        ccorr = f.mont_mul(consts["shares_inv_c"], f.sum(lagk, axis=1))  # (B, n) canonical
        return self._zip_wires(f, evens, self._lag_fold(f, m, lagk), lag0, ccorr, seeds)

    def v(self, f, gk, meas, jr_m, consts):
        """Circuit output: the sum of the gadget outputs (B, calls, n) -> (B, n)."""
        return f.sum(gk, axis=1)

    def truncate(self, f, meas, consts, ml=None):
        if self.valid.bits == 1:
            return meas
        B = meas.shape[0]
        m = meas.reshape(B, self.valid.length, self.valid.bits, f.n)
        if self.mxu:
            return f.dot_mont(m.transpose(1, 2), consts["pow2_m"])  # (B, length, n)
        return f.sum(f.mont_mul(m, consts["pow2_m"][None, None]), axis=2)


class _DFixedPointL2(_DSumVec):
    """FixedPointBoundedL2VecSum: two gadgets.  Gadget 0 is the bit check
    over every MEAS_LEN position on the SumVec pattern (a joint-rand weight
    a call); gadget 1 is ParallelSum(Mul) over the entry pairs (X_i, X_i),
    the entries recomposed from their bits on the card.  Both gadgets are
    ParallelSum(Mul) over ``chunk``, so one ``gadget_eval_scaled`` decides
    both.  The norm identity and the Schwartz-Zippel fold of the two checks
    are in ``v_multi``."""

    def __init__(self, valid, mxu: bool = False):
        super().__init__(valid, mxu)  # chunk and gadget 0's padding of MEAS_LEN
        self.nbits = valid.bits_per_entry
        self.entries = valid.entries
        self.norm_bits = valid.bits_for_norm
        #: gadget 1's zero padding of the entries in its last call
        self.pad_len1 = self.plans[1].calls * self.chunk - valid.entries

    # Under canonical padding every length-dependent site is per row: the
    # entry count d comes from the row's measurement length, the columns
    # past a row's entries hold its norm bits (live data) and are masked
    # out of the entries, the claimed norm's bits are gathered at the row's
    # own offset d * nbits, and the Schwartz-Zippel weight r_n is the joint
    # rand at the row's own bit-call count.
    def entries_from_meas_len(self, ml: torch.Tensor) -> torch.Tensor:
        return (ml - self.norm_bits) // self.nbits

    def calls_live_list(self, ml: torch.Tensor) -> List[torch.Tensor]:
        chunk = self.chunk
        return [(ml + chunk - 1) // chunk, (self.entries_from_meas_len(ml) + chunk - 1) // chunk]

    def _entries(self, f, meas, consts, entries_live=None):
        """X_i = sum_b 2^b meas[i * nbits + b] -> (B, entries, n) canonical;
        ``entries_live`` (B,) zeroes the entries at and past a row's own
        count."""
        B = meas.shape[0]
        m = meas[:, : self.entries * self.nbits].reshape(B, self.entries, self.nbits, f.n)
        if self.mxu:
            x = f.dot_mont(m.transpose(1, 2), consts["pow2_m"])
        else:
            x = f.sum(f.mont_mul(m, consts["pow2_m"][None, None]), axis=2)
        if entries_live is not None:
            e = torch.arange(self.entries, device=x.device)[None, :]
            x = torch.where((e < entries_live[:, None])[:, :, None], x, torch.zeros_like(x))
        return x

    def _entries_ml(self, f, meas, consts, ml):
        return self._entries(f, meas, consts, None if ml is None else self.entries_from_meas_len(ml))

    def wire_evals_g(self, gi, f, meas, jr_m, lag, seeds, consts, ml=None):
        if gi == 0:
            return self.wire_evals(f, meas, jr_m[:, : self.calls], lag, seeds, consts)
        # Both wires of pair u evaluate to seed * lag_0 + sum_k X[k, u]
        # lag_{k+1}: one contraction fills the even and the odd slot.
        B = meas.shape[0]
        x = self._entries_ml(f, meas, consts, ml)
        if self.pad_len1:
            x = torch.cat([x, torch.zeros((B, self.pad_len1, f.n), dtype=x.dtype, device=x.device)], dim=1)
        xm = x.reshape(B, self.plans[1].calls, self.chunk, f.n)
        s = self._lag_fold(f, xm, lag[:, 1:])  # (B, chunk, n)
        pair = torch.stack([s, s], dim=2).reshape(B, 2 * self.chunk, f.n)
        return f.add(f.mont_mul(seeds, lag[:, 0, None, :]), pair)

    def v_multi(self, f, gks, meas, jr_m, consts, ml=None):
        """rn * bit_check + rn^2 * norm_check, rn = jr[bit calls], where
        norm_check = sum X_i^2 - 2^n sum X_i + d 2^(2n-2) / shares minus the
        claimed norm's (2n-2)-bit decomposition."""
        gk_bits, gk_sq = gks
        B = meas.shape[0]
        bit_check = f.sum(gk_bits, axis=1)  # (B, n)
        sumsq = f.sum(gk_sq, axis=1)
        sum_x = f.sum(self._entries_ml(f, meas, consts, ml), axis=1)
        if ml is None:
            norm_bits = meas[:, self.entries * self.nbits :]
            offset = consts["offset_sq_c"]
            rn = jr_m[:, self.calls]
        else:
            el = self.entries_from_meas_len(ml)
            cols = (el * self.nbits)[:, None] + torch.arange(self.norm_bits, device=meas.device)[None, :]
            norm_bits = torch.gather(meas, 1, cols[:, :, None].expand(-1, -1, f.n))
            d = torch.zeros((B, f.n), dtype=torch.int64, device=meas.device)
            d[:, 0] = el
            offset = f.mont_mul(d, consts["offsq_m"])  # d * 2^(2n-2) / shares
            cl0 = (ml + self.chunk - 1) // self.chunk
            rn = torch.gather(jr_m, 1, cl0[:, None, None].expand(-1, 1, f.n))[:, 0]
        if self.mxu:
            claimed = f.dot_mont(norm_bits[:, :, None, :], consts["pow2_norm_m"]).squeeze(1)
        else:
            claimed = f.sum(f.mont_mul(norm_bits, consts["pow2_norm_m"][None]), axis=1)
        computed = f.add(f.sub(sumsq, f.mont_mul(sum_x, consts["pow2n_m"])), offset)
        norm_check = f.sub(computed, claimed)
        return f.add(f.mont_mul(bit_check, rn), f.mont_mul(f.mont_mul(norm_check, rn), rn))

    def truncate(self, f, meas, consts, ml=None):
        return self._entries_ml(f, meas, consts, ml)


def _device_circuit(valid, mxu: bool = False) -> _DeviceCircuit:
    if isinstance(valid, FixedPointBoundedL2VecSum):
        return _DFixedPointL2(valid, mxu)
    if isinstance(valid, Count):
        return _DCount(valid, mxu)
    if isinstance(valid, Sum):
        return _DSum(valid, mxu)
    if isinstance(valid, SumVec):
        return _DSumVec(valid, mxu)
    if isinstance(valid, Histogram):
        return _DHistogram(valid, mxu)
    raise NotImplementedError(
        f"the CUDA prepare path serves Count, Sum, SumVec, Histogram and FixedPointBoundedL2VecSum, "
        f"not {type(valid).__name__}"
    )


class BatchedPrio3:
    """Device-batched prepare for one Prio3 instance: Count, Sum, SumVec,
    Histogram or FixedPointBoundedL2VecSum, with any number of proofs.

    All entry points take and return tensors on ``device`` (default the
    card); the tests pass ``device="cpu"``, where every kernel wrapper takes
    its plain PyTorch version.  With ``require_device_xof=False`` an XOF
    other than TurboSHAKE128 is accepted, for the XOF-free
    ``query_batch``/``decide_batch`` only.

    ``field_backend`` is the field layout of the row path: "vpu" (the
    default), mont_mul/sum trees on limbs; "mxu", the JAX package's
    limb-digit matmul layout, where the contractions over calls and bits,
    the gadget outputs (one matmul against the w^(kj) table) and gpoly(t)
    run through ``TField.mat_mul_mont``.  The outputs are the same bytes;
    under "mxu" every flush takes the row path."""

    def __init__(self, prio3: Prio3, device="cuda", require_device_xof: bool = True, field_backend: str = "vpu"):
        if require_device_xof and prio3.xof is not XofTurboShake128:
            raise NotImplementedError("the CUDA prepare path requires XofTurboShake128")
        if field_backend not in FIELD_BACKENDS:
            raise ValueError(f"unknown field_backend {field_backend!r}")
        self.field_backend = field_backend
        self.device = torch.device(device)
        self.prio3 = prio3
        self.flp = prio3.flp
        self.f = TField(self.flp.field)
        self.circ = _device_circuit(self.flp.valid, mxu=field_backend == "mxu")
        self.consts_np = compute_consts(prio3, self.f, self.circ)
        self.consts = consts_from_numpy(self.consts_np, self.device)
        #: per gadget: its constants (alpha_pows_m, bary_c_m, roots_m,
        #: roots_all_m) on the device, log2 P and its NTT tables (bit
        #: reversal (P,), per-stage twiddles) or None below NTT_MIN_P (under
        #: "mxu" none: the gadget outputs are one matmul against
        #: ``alpha_mat_t``, the (glen, calls, n) w^(kj) table).  Gadget 0's
        #: constants are ``consts`` itself, where the planar path reads them.
        self.gadgets = []
        for gi, plan in enumerate(self.circ.plans):
            consts_np = self.consts_np if gi == 0 else gadget_consts(self.f, plan)
            consts = self.consts if gi == 0 else consts_from_numpy(consts_np, self.device)
            g = {"consts": consts, "log2_P": plan.P.bit_length() - 1, "ntt": None}
            if field_backend == "mxu":
                amat = alpha_mat(plan, consts_np["roots_all_m"]).transpose(1, 0, 2)
                g["alpha_mat_t"] = torch.from_numpy(amat.astype(np.int64)).to(self.device)
            elif plan.P >= NTT_MIN_P:
                bitrev, stages = compute_ntt(self.f, plan.P)
                tw = consts_from_numpy(dict(enumerate(stages)), self.device)
                g["ntt"] = (torch.from_numpy(bitrev).to(self.device), list(tw.values()))
            self.gadgets.append(g)

    # -- XOF helpers ----------------------------------------------------
    def _dst(self, usage: int) -> bytes:
        return self.prio3._dst(usage)

    def _expand_vec(self, seed, dst, binder, length) -> Tuple[torch.Tensor, torch.Tensor]:
        """XOF -> (canonical limbs (length, n, B) int64, ok (B,))."""
        return xof_next_vec_batch(self.f, seed, dst, binder, length)

    def _xof_seed(self, seed, dst, binder) -> torch.Tensor:
        """XOF -> one seed-sized output (B, SEED) uint8."""
        w = xof_words(seed, dst, binder, self.prio3.xof.SEED_SIZE // 4)
        return words_to_bytes(words(w).transpose(0, 1))

    def _joint_rand(self, agg_id, part, public_parts_u8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The corrected joint-rand seed over the public parts with our
        ``part`` (B, SEED) substituted, and the joint-rand vector from it
        -> (corrected (B, SEED) uint8, jr (JOINT_RAND_LEN, n, B), ok (B,))."""
        prio3 = self.prio3
        B, dev = part.shape[0], part.device
        pieces = []
        if agg_id > 0:
            pieces.append(public_parts_u8[:, :agg_id].reshape(B, -1))
        pieces.append(part)
        if agg_id < prio3.num_shares - 1:
            pieces.append(public_parts_u8[:, agg_id + 1 :].reshape(B, -1))
        zero_seed = torch.zeros((B, prio3.xof.SEED_SIZE), dtype=torch.uint8, device=dev)
        corrected = self._xof_seed(zero_seed, self._dst(USAGE_JOINT_RAND_SEED), torch.cat(pieces, dim=-1))
        empty = torch.zeros((B, 0), dtype=torch.uint8, device=dev)
        jr_len = self.flp.JOINT_RAND_LEN * prio3.num_proofs
        jr, ok = self._expand_vec(corrected, self._dst(USAGE_JOINT_RANDOMNESS), empty, jr_len)
        return corrected, jr, ok

    def _query_rand(self, verify_key, nonces_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """Query randomness from the verify key (bytes or (B, 16) uint8) and
        the nonces -> (qr (num_proofs * QUERY_RAND_LEN, n, B), ok (B,))."""
        B, dev = nonces_u8.shape[0], nonces_u8.device
        if isinstance(verify_key, (bytes, bytearray)):
            verify_key = torch.from_numpy(np.frombuffer(bytes(verify_key), dtype=np.uint8).copy()).to(dev)
        vk = verify_key.expand(B, verify_key.shape[-1]).contiguous()
        qr_len = self.flp.QUERY_RAND_LEN * self.prio3.num_proofs
        return self._expand_vec(vk, self._dst(USAGE_QUERY_RANDOMNESS), nonces_u8, qr_len)

    def planar_eligible(self, agg_id: int, batch: int) -> bool:
        """True when the planar path serves this prep: the JAX package's
        rules for the chunked circuits, without its B % 1024 tile rule (the
        port's kernels take any batch).  Count and Sum, which the JAX
        package serves on a limb-planar path for the TPU's lanes, take the
        row path here, and so does every circuit under "mxu", whose
        contractions live on the row path."""
        if self.field_backend == "mxu":
            return False
        if isinstance(self.circ, _DHistogram):
            # the lazy u16-half meas_sum is exact only up to 65535 terms
            circuit_ok = self.flp.MEAS_LEN <= LAZY_SUM_MAX
        else:
            # bits > 1 would need a planar truncate (out_share != meas);
            # FixedPointBoundedL2VecSum's second gadget takes the row path
            circuit_ok = type(self.circ) is _DSumVec and self.flp.valid.bits == 1
        return circuit_ok and self.prio3.num_proofs == 1 and batch <= LAZY_SUM_MAX

    def prep_route(self, agg_id: int, batch: int, masked: bool = False) -> str:
        """The name of the prepare that serves a flush of ``batch`` (padded)
        rows; a ``masked`` flush (canonical padding, per-row measurement
        lengths) runs row-major, as the planar kernels take no masks."""
        if not masked and self.planar_eligible(agg_id, batch):
            return "prep_init_planar"
        return "prep_init"

    def _planar_ok(self, stream: torch.Tensor, num_elems: int) -> torch.Tensor:
        """Canonicality of every element of a (W, B) stream -> ok (B,)."""
        el = field_words(words(stream), num_elems, self.f.n)
        return torch.all(self.f.is_canonical_limbs(limb_list(el)), dim=0)

    # -- coefficient planes (plain PyTorch, small) ------------------------
    def _const_limbs(self, name: str, idx=None) -> List[torch.Tensor]:
        c = self.consts[name] if idx is None else self.consts[name][idx]
        return [c[..., l] for l in range(self.f.n)]

    def _gpoly_at_planes(self, gp: torch.Tensor, t: List) -> List:
        """gpoly(t) by baby-step/giant-step: gp (glen, n, B) canonical
        coefficients, t Montgomery limb lists (B,) -> canonical (B,)."""
        f = self.f
        glen, _, B = gp.shape
        bs = max(1, math.isqrt(glen))
        gs = -(-glen // bs)
        one = _ones(f, B, gp.device)
        baby = [one]
        for _ in range(bs - 1):
            baby.append(f.mont_mul_limbs(baby[-1], t))
        tbs = f.mont_mul_limbs(baby[-1], t)
        giant = [one]
        for _ in range(gs - 1):
            giant.append(f.mont_mul_limbs(giant[-1], tbs))
        gpt = None
        for g in range(gs):
            inner = None
            for j in range(bs):
                idx = g * bs + j
                if idx >= glen:
                    break
                term = f.mont_mul_limbs(limb_list(gp[idx]), baby[j])
                inner = term if inner is None else f.add_limbs(inner, term)
            outer = f.mont_mul_limbs(inner, giant[g])
            gpt = outer if gpt is None else f.add_limbs(gpt, outer)
        return gpt

    def _lagrange_planes(self, t: List) -> Tuple[torch.Tensor, torch.Tensor]:
        """Barycentric Lagrange coefficients at t (inversion-free form
        z/(t - w^k) = prod_{j != k} (t - w^j)) -> (lag (K, n, B) Montgomery,
        t_ok (B,)).  t_ok is False where t is a P-th root of unity."""
        f, circ = self.f, self.circ
        one = _ones(f, t[0].shape[0], t[0].device)
        tp = t
        for _ in range(self.gadgets[0]["log2_P"]):
            tp = f.mont_mul_limbs(tp, tp)
        z = f.sub_limbs(tp, one)
        nz = z[0]
        for l in range(1, f.n):
            nz = nz | z[l]
        t_ok = nz != 0
        denom = [f.sub_limbs(t, self._const_limbs("roots_all_m", k)) for k in range(circ.P)]
        prefix = [one]
        for k in range(1, circ.P):
            prefix.append(f.mont_mul_limbs(prefix[-1], denom[k - 1]))
        suffix = [one] * circ.P
        for k in range(circ.P - 2, -1, -1):
            suffix[k] = f.mont_mul_limbs(suffix[k + 1], denom[k + 1])
        cols = []
        for k in range(circ.calls + 1):
            others = f.mont_mul_limbs(prefix[k], suffix[k])
            cols.append(limb_stack(f.mont_mul_limbs(others, self._const_limbs("bary_c_m", k))))
        return torch.stack(cols, dim=0), t_ok

    def _gadget_planes(self, gp: torch.Tensor, t: List) -> Tuple[List, List]:
        """gk[k] = gpoly(alpha^k) as the direct sum over coefficients times
        the constant w^{kj} table, and gpoly(t).  gp (glen, n, B) canonical
        -> (gk limb lists (calls, B), gpt limb lists (B,)), canonical."""
        f, circ = self.f, self.circ
        amat = self.consts["alpha_mat_m"]  # (calls, glen, n)
        gp_l = limb_list(gp)  # n tensors (glen, B)
        cols = []
        for k in range(circ.calls):
            terms = f.mont_mul_limbs(gp_l, [amat[k, :, l][:, None] for l in range(f.n)])
            acc = [x[0] for x in terms]
            for j in range(1, gp.shape[0]):
                acc = f.add_limbs(acc, [x[j] for x in terms])
            cols.append(acc)
        gk = [torch.stack([c[l] for c in cols], dim=0) for l in range(f.n)]
        return gk, self._gpoly_at_planes(gp, t)

    # -- row-major FLP helpers (limb axis last, (B, K, n)) ----------------
    def _lagrange_coeffs(self, t_m: torch.Tensor, gi: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Barycentric Lagrange coefficients at t over gadget ``gi``'s P-th
        roots: z/(t - w^k) = prod_{j != k} (t - w^j), the exclusive mutual
        products.  t_m (B, n) Montgomery -> (lag (B, calls+1, n) Montgomery,
        t_ok (B,)); t_ok is False where t is a P-th root of unity."""
        f, g = self.f, self.gadgets[gi]
        t_pow = t_m
        for _ in range(g["log2_P"]):
            t_pow = f.mont_mul(t_pow, t_pow)
        t_ok = ~f.is_zero(f.sub(t_pow, f.mont_one(t_m.device)))
        denom = f.sub(t_m[:, None, :], g["consts"]["roots_all_m"][None])  # (B, P, n)
        others = f.mutual_products_mont(denom, axis=1)
        lag = f.mont_mul(others[:, : self.circ.plans[gi].calls + 1], g["consts"]["bary_c_m"][None])
        return lag, t_ok

    def _gpoly_at(self, gpoly: torch.Tensor, t_m: torch.Tensor) -> torch.Tensor:
        """Gadget polynomial at t: gpoly (B, glen, n) canonical, t_m (B, n)
        Montgomery -> (B, n) canonical.  Baby-step/giant-step for glen >= 64,
        Horner below it; under "mxu" baby-step/giant-step with both folds
        as matmuls."""
        if self.field_backend == "mxu":
            return self.f.poly_eval_dot(gpoly, t_m)
        if gpoly.shape[1] >= 64:
            return self.f.poly_eval_mont(gpoly, t_m)
        return self.f.horner_mont(gpoly, t_m)

    def _gadget_outputs(self, gpoly: torch.Tensor, gi: int = 0) -> torch.Tensor:
        """gk (B, calls, n): gadget ``gi``'s polynomial at alpha^1..alpha^calls.
        An NTT over all P roots after folding the glen coefficients mod
        x^P - 1, or a Horner scan of every call at once below NTT_MIN_P;
        under "mxu" gk[b, k] = sum_j gpoly[b, j] w^(kj), one matmul against
        the constant table shared by every row."""
        f, plan, g = self.f, self.circ.plans[gi], self.gadgets[gi]
        if self.field_backend == "mxu":
            return f.mat_mul_mont(gpoly[:, :, None, :], g["alpha_mat_t"]).squeeze(1)
        if g["ntt"] is not None:
            P = plan.P
            hi = gpoly[:, P:]
            pad = torch.zeros((hi.shape[0], P - hi.shape[1], f.n), dtype=hi.dtype, device=hi.device)
            folded = f.add(gpoly[:, :P], torch.cat([hi, pad], dim=1))
            return f.ntt_eval_mont(folded, *g["ntt"])[:, 1 : plan.calls + 1]
        alpha = g["consts"]["alpha_pows_m"][None]  # (1, calls, n)
        acc = torch.zeros((gpoly.shape[0], plan.calls, f.n), dtype=torch.int64, device=gpoly.device)
        for j in range(gpoly.shape[1] - 1, -1, -1):
            acc = f.add(f.mont_mul(acc, alpha), gpoly[:, j : j + 1])
        return acc

    # -- planar wire evaluations (K3, K5) -----------------------------------
    def _histogram_parts(self, meas_st, proofs_st, jr_m, t_m):
        """Histogram wires (K3), circuit output v and gpoly(t) ->
        (ev, od (chunk, n, B) int32, v (B, n), gpt (B, n), t_ok (B,))."""
        f, flp, circ, n = self.f, self.flp, self.circ, self.f.n
        lag, t_ok = self._lagrange_planes(t_m)
        rch, kl, lagk, lag0, ccorr = circ.planar_coeffs(f, jr_m, lag, self.consts)
        ev, od = wire_evals(
            f, flp.MEAS_LEN, circ.chunk, meas_st, proofs_st,
            storage(rch).contiguous(), storage(kl).contiguous(), storage(lagk).contiguous(),
            storage(lag0).contiguous(), storage(ccorr).contiguous(),
        )
        proof_el = field_words(words(proofs_st), flp.PROOF_LEN, n)
        gk, gpt = self._gadget_planes(proof_el[circ.arity : circ.arity + circ.glen], t_m)
        # v from the lazily summed measurement (u16 halves, one fold).
        meas_sum = _sum_limbs(f, limb_list(field_words(words(meas_st), flp.MEAS_LEN, n)))
        v = circ.v_from_meas_sum(f, gk, meas_sum, jr_m, self.consts)
        return ev, od, limb_stack(v).transpose(0, 1), limb_stack(gpt).transpose(0, 1), t_ok

    def _sumvec_parts(self, meas_st, proofs_st, jr_m, t_m):
        """SumVec wires (K5), circuit output v and gpoly(t), as
        ``_histogram_parts``.  The wire coefficients are per call (jr_k,
        lag_{k+1}); the kernel makes jr_k^(u+1) in registers, so no
        (calls, chunk) coefficient tensor is ever written."""
        f, flp, circ, n = self.f, self.flp, self.circ, self.f.n
        t_row = limb_stack(t_m).transpose(0, 1)  # (B, n)
        lag, t_ok = self._lagrange_coeffs(t_row)  # (B, K, n)
        ccorr = f.mont_mul(self.consts["shares_inv_c"], f.sum(lag[:, 1:], axis=1))  # (B, n)
        lag_pl = lag.permute(1, 2, 0)  # (K, n, B)
        ev, od = sumvec_wires(
            f, flp.MEAS_LEN, circ.chunk, meas_st, proofs_st, storage(jr_m).contiguous(),
            storage(lag_pl[1:]).contiguous(), storage(lag_pl[0]).contiguous(),
            storage(ccorr.transpose(0, 1)).contiguous(),
        )
        proof_el = field_words(words(proofs_st), flp.PROOF_LEN, n)
        gpoly = proof_el[circ.arity : circ.arity + circ.glen].permute(2, 0, 1)  # (B, glen, n)
        v = circ.v(f, self._gadget_outputs(gpoly), None, None, self.consts)
        return ev, od, v, self._gpoly_at(gpoly, t_row), t_ok

    def _jr_part_planes(self, agg_id, blinds_u8, nonces_u8, meas_stream, meas_len=None) -> torch.Tensor:
        """Joint-rand-part XOF: the K2 absorb of ``_jr_part_message``, or
        with ``meas_len`` (B,) its select variant at each row's own message
        length -> (B, SEED) uint8."""
        msg = self._jr_part_message(agg_id, blinds_u8, nonces_u8, meas_stream, meas_len)
        out_words = self.prio3.xof.SEED_SIZE // 4
        if meas_len is None:
            part = absorb_planes(msg, out_words)
        else:
            last = (self._jr_part_head_len(blinds_u8, nonces_u8) + 4 * self.f.n * meas_len) // RATE
            part = absorb_select(msg, last.to(torch.int32).contiguous(), out_words)
        return words_to_bytes(words(part).transpose(0, 1))

    def _jr_part_head_len(self, blinds_u8, nonces_u8) -> int:
        """Bytes of the joint-rand-part message before the measurement."""
        dst = self._dst(USAGE_JOINT_RAND_PART)
        return 1 + len(dst) + blinds_u8.shape[-1] + 1 + nonces_u8.shape[-1]

    def _jr_part_message(self, agg_id, blinds_u8, nonces_u8, meas_stream, meas_len=None) -> torch.Tensor:
        """The padded joint-rand-part message, built in-plane.

        The message is len(dst) || dst || blind || agg_id || nonce ||
        meas_bytes || padding; the measurement bytes are the squeeze (or the
        leader's) stream planes, funnel-shifted by the head's byte remainder
        into message words -> (nblocks*42, B) int32.  With ``meas_len`` (B,)
        each row's measurement ends at its own length: the stream words
        past it are zeroed and the row is padded there (the domain byte at
        its length, 0x80 at the end of its final block), over as many
        blocks as the longest row needs."""
        B = nonces_u8.shape[0]
        dev = nonces_u8.device
        dst = self._dst(USAGE_JOINT_RAND_PART)
        W_m = meas_stream.shape[0]
        hb_len = self._jr_part_head_len(blinds_u8, nonces_u8)
        q, rm = divmod(hb_len, 4)
        msg_len = hb_len + 4 * W_m
        nblocks = msg_len // RATE + 1
        msg_words = nblocks * RATE_WORDS

        prefix = torch.from_numpy(np.frombuffer(bytes([len(dst)]) + dst, dtype=np.uint8).copy())
        head_parts = [
            prefix.to(dev).expand(B, -1),
            blinds_u8,
            torch.full((B, 1), agg_id, dtype=torch.uint8, device=dev),
            nonces_u8,
        ]
        head_pad = (-hb_len) % 4
        if head_pad:
            head_parts.append(torch.zeros((B, head_pad), dtype=torch.uint8, device=dev))
        head = bytes_to_words(torch.cat(head_parts, dim=-1)).transpose(0, 1)  # (nh, B)

        pad_len = nblocks * RATE - msg_len
        pad_words_needed = (rm + pad_len) // 4
        pad = np.zeros(pad_words_needed * 4, dtype=np.uint8)
        meas_w = words(meas_stream)
        if meas_len is None:
            pad[0] = 0x01
            pad[pad_len - 1] ^= 0x80
        else:
            row_words = meas_len.to(torch.int64) * self.f.n
            live = torch.arange(W_m, device=dev)[:, None] < row_words[None, :]
            meas_w = torch.where(live, meas_w, torch.zeros_like(meas_w))
        ext = torch.cat([meas_w, const_word_planes(pad.tobytes(), B, dev)], dim=0)
        if rm == 0:
            msg = torch.cat([head[:q], ext[: msg_words - q]], dim=0)
        else:
            sh = 8 * rm
            boundary = head[q] | ((ext[0] << sh) & M32)
            nbody = msg_words - q - 1
            body = (ext[:nbody] >> (32 - sh)) | ((ext[1 : nbody + 1] << sh) & M32)
            msg = torch.cat([head[:q], boundary[None], body], dim=0)
        if meas_len is not None:
            # each row's pad: the domain byte lands on a zero byte, and 0x80
            # xors into the last byte of the row's final block (the two
            # coincide when the true pad is one byte)
            L = hb_len + 4 * row_words  # (B,) message bytes
            at = (L // 4)[None]
            one = torch.ones_like(L)
            msg = msg.scatter(0, at, msg.gather(0, at) | (one << (8 * (L % 4)))[None])
            end = ((L // RATE + 1) * RATE_WORDS - 1)[None]
            msg = msg.scatter(0, end, msg.gather(0, end) ^ (0x80 << 24))
        return storage(msg).contiguous()

    # -- prepare ------------------------------------------------------------
    def prep_init_planar(
        self,
        agg_id: int,
        verify_key,
        nonces_u8: torch.Tensor,
        *,
        share_seeds_u8: Optional[torch.Tensor] = None,
        meas_limbs: Optional[torch.Tensor] = None,
        proofs_limbs: Optional[torch.Tensor] = None,
        blinds_u8: Optional[torch.Tensor] = None,
        public_parts_u8: Optional[torch.Tensor] = None,
        keep_planar: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Prepare-init of a Histogram or one-bit SumVec batch, either side.

        Helpers (agg_id > 0) pass ``share_seeds_u8`` (B, 16) and the share
        streams come from the K1 squeeze; the leader passes its explicit
        ``meas_limbs``/``proofs_limbs`` (B, L, n) int32, transposed into the
        same stream planes.  ``verify_key`` is bytes or a (B, 16) uint8
        tensor.  Returns ``verifiers`` (B, VERIFIER_LEN, n) int64 canonical,
        ``out_share`` (B, OUTPUT_LEN, n) int32, ``joint_rand_part`` and
        ``corrected_seed`` (B, 16) uint8, and ``ok`` (B,): False marks rows
        whose XOF streams held a rejected candidate or whose query point hit
        a root of unity, which the caller recomputes with the oracle.

        With ``keep_planar`` the verifier is not assembled: ``wire_ev_pl``
        and ``wire_od_pl`` (chunk, n, B) int32 and ``v_row``/``gpt_row``
        (B, n) take its place, for ``prep_shares_to_prep_planar``.
        """
        flp, f, circ = self.flp, self.f, self.circ
        B = nonces_u8.shape[0]
        if not self.planar_eligible(agg_id, B):
            raise NotImplementedError(
                f"prep_init_planar does not serve {type(self.circ.valid).__name__} at a batch of {B}"
            )
        n, dev = f.n, nonces_u8.device
        if agg_id == 0:
            meas_st = rows_to_planes(meas_limbs.reshape(B, flp.MEAS_LEN * n))
            proofs_st = rows_to_planes(proofs_limbs.reshape(B, flp.PROOF_LEN * n))
            ok = torch.ones((B,), dtype=torch.bool, device=dev)
        else:
            binder = torch.full((B, 1), agg_id, dtype=torch.uint8, device=dev)
            meas_st = xof_planes(share_seeds_u8, self._dst(USAGE_MEAS_SHARE), binder, flp.MEAS_LEN * n)
            proofs_st = xof_planes(share_seeds_u8, self._dst(USAGE_PROOF_SHARE), binder, flp.PROOF_LEN * n)
            ok = self._planar_ok(meas_st, flp.MEAS_LEN) & self._planar_ok(proofs_st, flp.PROOF_LEN)

        # Joint randomness: the part from the in-plane absorb, then the
        # corrected seed and the joint-rand vector from one-block XOFs.
        part = self._jr_part_planes(agg_id, blinds_u8, nonces_u8, meas_st)
        corrected, jr, ok_j = self._joint_rand(agg_id, part, public_parts_u8)
        qr, ok_q = self._query_rand(verify_key, nonces_u8)
        ok = ok & ok_j & ok_q

        r2 = self._const_limbs("r2")
        jr_m = limb_stack(f.mont_mul_limbs(limb_list(jr), r2))  # (JOINT_RAND_LEN, n, B)
        t_m = f.mont_mul_limbs(limb_list(qr[0]), r2)  # one gadget, one proof

        parts = self._histogram_parts if isinstance(circ, _DHistogram) else self._sumvec_parts
        ev, od, v, gpt, t_ok = parts(meas_st, proofs_st, jr_m, t_m)
        out = {
            # the planar circuits' out share is the measurement share itself
            "out_share": self.planar_out_share_to_rows(field_words(meas_st, flp.MEAS_LEN, f.n)),
            "ok": ok & t_ok,
            "joint_rand_part": part,
            "corrected_seed": corrected,
        }
        if keep_planar:
            # Our wires stay in plane layout for prep_shares_to_prep_planar;
            # only the small v and gpoly(t) rows leave it.
            out.update(wire_ev_pl=ev, wire_od_pl=od, v_row=v, gpt_row=gpt)
        else:
            out["verifiers"] = torch.cat([v[:, None], self._zip_planes_to_rows(ev, od), gpt[:, None]], dim=1)
        return out

    def helper_shares(self, agg_id: int, share_seeds_u8: torch.Tensor):
        """A helper's (meas (B, MEAS_LEN, n), proofs (B, num_proofs *
        PROOF_LEN, n)) int64 canonical shares from its seed (K1), and ok (B,)."""
        B = share_seeds_u8.shape[0]
        binder = torch.full((B, 1), agg_id, dtype=torch.uint8, device=share_seeds_u8.device)
        proofs_len = self.flp.PROOF_LEN * self.prio3.num_proofs
        meas, ok1 = self._expand_vec(share_seeds_u8, self._dst(USAGE_MEAS_SHARE), binder, self.flp.MEAS_LEN)
        proofs, ok2 = self._expand_vec(share_seeds_u8, self._dst(USAGE_PROOF_SHARE), binder, proofs_len)
        return meas.permute(2, 0, 1), proofs.permute(2, 0, 1), ok1 & ok2

    def _query_one(self, meas, proof, jr_m, t_m, calls_live=None, ml=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Row-major FLP query of one proof over every gadget: meas (B,
        MEAS_LEN, n) and proof (B, PROOF_LEN, n) canonical, jr_m (B,
        JOINT_RAND_LEN, n) Montgomery or None, t_m (B, QUERY_RAND_LEN, n)
        Montgomery, gadget g's query point at t_m[:, g] -> (verifier (B,
        VERIFIER_LEN, n) canonical, t_ok (B,)).  The oracle's
        FlpGeneric.query layouts: the proof is per gadget [wire seeds, gadget
        polynomial], the verifier [v] and per gadget [wire evaluations,
        gpoly(t)].

        ``calls_live`` (canonical padding) is one (B,) live-call count per
        gadget: the rows of a shorter task zero their padded calls out of
        the gadget-output fold (an adversarial gadget polynomial is not
        zero at unused evaluation points) and out of the barycentric
        coefficients (the task's wire polynomials are zero there by
        definition, and every wire evaluation reads lag after this mask).
        ``ml`` (B,) is the rows' true measurement length."""
        f, circ = self.f, self.circ
        B, dev = meas.shape[0], meas.device
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        gks, segs = [], []
        idx = 0
        for gi, plan in enumerate(circ.plans):
            seeds = proof[:, idx : idx + plan.arity]
            gpoly = proof[:, idx + plan.arity : idx + plan.arity + plan.glen]
            idx += plan.arity + plan.glen
            gk = self._gadget_outputs(gpoly, gi)
            lag, t_ok = self._lagrange_coeffs(t_m[:, gi], gi)
            if calls_live is not None:
                cl = calls_live[gi][:, None]
                k = torch.arange(plan.calls + 1, device=dev)[None, :]
                gk = torch.where((k[:, 1:] <= cl)[:, :, None], gk, torch.zeros_like(gk))
                lag = torch.where((k <= cl)[:, :, None], lag, torch.zeros_like(lag))
            gks.append(gk)
            ok = ok & t_ok
            wires = circ.wire_evals_g(gi, f, meas, jr_m, lag, seeds, self.consts, ml=ml)
            segs += [wires, self._gpoly_at(gpoly, t_m[:, gi])[:, None]]
        v = circ.v_multi(f, gks, meas, jr_m, self.consts, ml=ml)
        return torch.cat([v[:, None]] + segs, dim=1), ok

    def prep_init(
        self,
        agg_id: int,
        verify_key,
        nonces_u8: torch.Tensor,
        *,
        share_seeds_u8: Optional[torch.Tensor] = None,
        meas_limbs: Optional[torch.Tensor] = None,
        proofs_limbs: Optional[torch.Tensor] = None,
        blinds_u8: Optional[torch.Tensor] = None,
        public_parts_u8: Optional[torch.Tensor] = None,
        meas_len: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Row-major prepare-init of any served circuit at any batch, either
        side: the path for what the planar path cannot take.  Takes and
        returns what ``prep_init_planar`` does (without ``keep_planar``);
        Count has no joint randomness, so its result has no
        ``joint_rand_part`` or ``corrected_seed``.

        ``meas_len`` (B,) int32 engages canonical padding
        (``vdaf/canonical.py``): this instance is a bucket's padded twin and
        each row carries its task's true MEAS_LEN.  Measurement columns at
        or past it are zeroed (the helper's stream is expanded at the
        bucket's width: prefix-stable, but its tail is live data that must
        not reach the wires), the joint-rand part absorbs the row's true
        ``enc(meas)`` through the K2 select kernel, and the gadget-call
        masks go into ``_query_one``.  The outputs equal the row's own
        task's oracle byte for byte; out shares keep the twin's width with
        a zero tail."""
        flp = self.flp
        B, dev = nonces_u8.shape[0], nonces_u8.device
        if agg_id == 0:
            meas, proofs = words(meas_limbs), words(proofs_limbs)
            ok = torch.ones((B,), dtype=torch.bool, device=dev)
        else:
            meas, proofs, ok = self.helper_shares(agg_id, share_seeds_u8)
        ml = calls_live = None
        if meas_len is not None:
            ml = meas_len.to(torch.int64)
            calls_live = self.circ.calls_live_list(ml)
            col = torch.arange(flp.MEAS_LEN, device=dev)[None, :]
            meas = torch.where((col < ml[:, None])[:, :, None], meas, torch.zeros_like(meas))

        out: Dict[str, torch.Tensor] = {}
        jr = None
        if flp.JOINT_RAND_LEN > 0:
            # joint_rand_part = XOF(blind, dst, agg_id || nonce || enc(meas))
            if ml is None:
                agg_b = torch.full((B, 1), agg_id, dtype=torch.uint8, device=dev)
                binder = torch.cat([agg_b, nonces_u8, words_to_bytes(meas.reshape(B, -1))], dim=-1)
                part = self._xof_seed(blinds_u8, self._dst(USAGE_JOINT_RAND_PART), binder)
            else:
                # the binder's true byte length is per row: the in-plane
                # message padded at each row's length, absorbed by K2's
                # select variant
                meas_st = rows_to_planes(storage(meas.reshape(B, -1)))
                part = self._jr_part_planes(agg_id, blinds_u8, nonces_u8, meas_st, ml)
            corrected, jr, ok_j = self._joint_rand(agg_id, part, public_parts_u8)
            ok = ok & ok_j
            out.update(joint_rand_part=part, corrected_seed=corrected)
            jr = jr.permute(2, 0, 1)
        qr, ok_q = self._query_rand(verify_key, nonces_u8)
        res = self.query_batch(meas, proofs, jr, qr.permute(2, 0, 1), calls_live=calls_live, ml=ml)
        out.update(res, ok=ok & ok_q & res["ok"])
        return out

    def query_batch(self, meas, proofs, jr, qr, calls_live=None, ml=None) -> Dict[str, torch.Tensor]:
        """The FLP query of every proof with every XOF output given: meas
        (B, MEAS_LEN, n), proofs (B, num_proofs * PROOF_LEN, n), jr (B,
        num_proofs * JOINT_RAND_LEN, n) or None and qr (B, num_proofs *
        QUERY_RAND_LEN, n), all canonical int64; proof i takes the i-th
        slice of each.  Returns ``verifiers`` (B, num_proofs * VERIFIER_LEN,
        n) int64, ``out_share`` (B, OUTPUT_LEN, n) int32 and ``ok`` (rows
        where a query point hit a root of unity are False).  ``calls_live``
        and ``ml``: the canonical masks of ``prep_init``."""
        f, flp = self.f, self.flp
        jr_m = None if jr is None else f.to_mont(jr)
        ok = torch.ones((meas.shape[0],), dtype=torch.bool, device=meas.device)
        verifiers = []
        for i in range(self.prio3.num_proofs):
            proof = proofs[:, i * flp.PROOF_LEN : (i + 1) * flp.PROOF_LEN]
            t_m = f.to_mont(qr[:, i * flp.QUERY_RAND_LEN : (i + 1) * flp.QUERY_RAND_LEN])
            ji = None if jr_m is None else jr_m[:, i * flp.JOINT_RAND_LEN : (i + 1) * flp.JOINT_RAND_LEN]
            ver, t_ok = self._query_one(meas, proof, ji, t_m, calls_live=calls_live, ml=ml)
            verifiers.append(ver)
            ok = ok & t_ok
        out_share = storage(self.circ.truncate(f, meas, self.consts, ml=ml)).contiguous()
        return {"verifiers": torch.cat(verifiers, dim=1), "out_share": out_share, "ok": ok}

    def decide_batch(self, combined: torch.Tensor) -> torch.Tensor:
        """Decide from the combined (summed) verifiers (B, num_proofs *
        VERIFIER_LEN, n): for every proof, v == 0 and each gadget on its
        combined wires equals its gpoly(t)."""
        f, flp, circ = self.f, self.flp, self.circ
        decide = torch.ones((combined.shape[0],), dtype=torch.bool, device=combined.device)
        for i in range(self.prio3.num_proofs):
            ver = combined[:, i * flp.VERIFIER_LEN : (i + 1) * flp.VERIFIER_LEN]
            decide = decide & f.is_zero(ver[:, 0])
            idx = 1
            for gi, plan in enumerate(circ.plans):
                x = ver[:, idx : idx + plan.arity]
                # g*R^-1 == y*R^-1 is the predicate g == y (R is invertible).
                y_scaled = f.from_mont(ver[:, idx + plan.arity])
                decide = decide & f.eq(circ.gadget_eval_scaled(f, x), y_scaled)
                idx += plan.arity + 1
        return decide

    @staticmethod
    def _zip_planes_to_rows(ev: torch.Tensor, od: torch.Tensor) -> torch.Tensor:
        """Interleave even/odd wire planes (chunk, n, B) -> rows (B, 2*chunk, n) int64."""
        chunk, n, B = ev.shape
        zipped = torch.stack([words(ev), words(od)], dim=1)  # (chunk, 2, n, B)
        return zipped.permute(3, 0, 1, 2).reshape(B, 2 * chunk, n)

    @staticmethod
    def planar_out_share_to_rows(osp: torch.Tensor) -> torch.Tensor:
        """(L, n, B) planar out shares -> row-major (B, L, n)."""
        return osp.permute(2, 0, 1).contiguous()

    # -- prep shares -> prep message ------------------------------------
    def prep_shares_to_prep(
        self,
        verifier_shares: List[torch.Tensor],
        joint_rand_parts_u8: Optional[List[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Combine verifier shares (each (B, VERIFIER_LEN, n) int64
        canonical) and decide; derive the joint-rand seed from the parts."""
        combined = verifier_shares[0]
        for vs in verifier_shares[1:]:
            combined = self.f.add(combined, vs)
        return self._prep_msg(self.decide_batch(combined), joint_rand_parts_u8)

    def prep_shares_to_prep_planar(
        self,
        own: Dict[str, torch.Tensor],
        peer_verifiers: torch.Tensor,
        joint_rand_parts_u8: Optional[List[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Combine and decide with our verifier still in plane layout.

        ``own`` is a ``prep_init_planar(keep_planar=True)`` result;
        ``peer_verifiers`` is the other aggregator's share, (B, VERIFIER_LEN,
        n) int64 canonical as it arrives, contiguous.  The K4 kernel reads
        the peer's wires from those rows in place and sums the gadget over
        the combined wires; only v, gpoly(t) and the folded sum touch rows.
        ``decide`` and ``prep_msg_seed`` equal ``prep_shares_to_prep``'s."""
        f, circ = self.f, self.circ
        g = words(combine_decide(f, circ.chunk, own["wire_ev_pl"], own["wire_od_pl"], peer_verifiers)).transpose(0, 1)
        v = f.add(own["v_row"], peer_verifiers[:, 0])
        y = f.add(own["gpt_row"], peer_verifiers[:, 1 + circ.arity])
        # g is (a*b)*R^-1-scaled; against y*R^-1 the predicate is g == y.
        return self._prep_msg(f.is_zero(v) & f.eq(g, f.from_mont(y)), joint_rand_parts_u8)

    def _prep_msg(self, decide: torch.Tensor, joint_rand_parts_u8) -> Dict[str, torch.Tensor]:
        """The decision and, with joint randomness, the prep-message seed
        derived from every aggregator's part."""
        out: Dict[str, torch.Tensor] = {"decide": decide}
        if self.flp.JOINT_RAND_LEN > 0:
            binder = torch.cat(list(joint_rand_parts_u8), dim=-1)
            zero_seed = torch.zeros((decide.shape[0], self.prio3.xof.SEED_SIZE), dtype=torch.uint8, device=binder.device)
            out["prep_msg_seed"] = self._xof_seed(zero_seed, self._dst(USAGE_JOINT_RAND_SEED), binder)
        return out

    # -- aggregation -----------------------------------------------------
    def aggregate(self, out_shares: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked modular sum over the batch: out_shares (B, OUT, n)
        canonical words (int32 storage or int64), mask (B,) bool -> (OUT, n)."""
        x = words(out_shares) if out_shares.dtype == torch.int32 else out_shares
        masked = torch.where(mask[:, None, None], x, torch.zeros_like(x))
        return self.f.sum(masked, axis=0)


def gadget_consts(f: TField, plan: _GadgetPlan) -> Dict[str, np.ndarray]:
    """One gadget's host constants over its own P-th roots w, as uint32 limb
    arrays: alpha^k (k = 1..calls), the barycentric weights w^k / P and the
    roots w^k (k = 0..calls), and every P-th root (the JAX package's
    per-gadget constants, under the same names)."""
    p = f.p
    w = f.oracle.root(plan.P)
    p_inv = pow(plan.P, p - 2, p)

    def mont_np(x: int) -> np.ndarray:
        return f._int_to_limbs_np(f.mont_int(x))

    return {
        "alpha_pows_m": np.stack([mont_np(pow(w, k, p)) for k in range(1, plan.calls + 1)]),
        "bary_c_m": np.stack([mont_np(pow(w, k, p) * p_inv % p) for k in range(plan.calls + 1)]),
        "roots_m": np.stack([mont_np(pow(w, k, p)) for k in range(plan.calls + 1)]),
        "roots_all_m": np.stack([mont_np(pow(w, k, p)) for k in range(plan.P)]),
    }


def compute_consts(prio3: Prio3, f: TField, circ: _DeviceCircuit) -> Dict[str, np.ndarray]:
    """The instance's host constants as uint32 limb arrays, gadget 0's among
    them (``BatchedPrio3`` of the JAX package holds the same values under the
    same names)."""
    p = f.p
    plan = circ.plans[0]

    def mont_np(x: int) -> np.ndarray:
        return f._int_to_limbs_np(f.mont_int(x))

    consts = {
        "shares_inv_c": f._int_to_limbs_np(pow(prio3.num_shares, p - 2, p)),
        **gadget_consts(f, plan),
        "r2": f.r2_np.copy(),
    }
    if isinstance(circ, _DHistogram):
        # the w^{kj} table of the histogram's direct gadget evaluation
        # (calls * glen entries: 4 * 15 for Histogram(1024, 316), but
        # 317 * 1023 for SumVec(100000, 1, 316), whose NTT needs none)
        consts["alpha_mat_m"] = alpha_mat(plan, consts["roots_all_m"])
    valid = circ.valid
    if isinstance(circ, _DFixedPointL2):
        nb = valid.bits_per_entry
        shares_inv = pow(prio3.num_shares, p - 2, p)
        # the entry recomposition weights 2^b (b < bits_per_entry), the
        # claimed norm's 2^b (b < 2n - 2), the cross term's 2^n and the
        # offset d 2^(2n-2) / shares of the norm identity (canonical)
        consts["pow2_m"] = np.stack([mont_np(1 << b) for b in range(nb)])
        consts["pow2_norm_m"] = np.stack([mont_np(1 << b) for b in range(valid.bits_for_norm)])
        consts["pow2n_m"] = mont_np(1 << nb)
        # shares_inv * 2^(2n-2), multiplied by a row's own entry count d
        # under canonical padding
        consts["offsq_m"] = mont_np(shares_inv * (1 << (2 * nb - 2)) % p)
        consts["offset_sq_c"] = f._int_to_limbs_np(shares_inv * (valid.entries % p) * (1 << (2 * nb - 2)) % p)
        return consts
    bits = getattr(valid, "bits", 1)
    if isinstance(circ, _DSum) or bits > 1:
        # the bit weights 2^b (b < bits) of the weighted truncate
        consts["pow2_m"] = np.stack([mont_np(1 << b) for b in range(bits)])
    return consts


def alpha_mat(plan: _GadgetPlan, roots_all_m: np.ndarray) -> np.ndarray:
    """The (calls, glen, n) table w^(kj), k = 1..calls, j < glen, in
    Montgomery form, from the P-th roots w^i (i < P) of ``gadget_consts``:
    w^(kj) = w^(kj mod P)."""
    k = np.arange(1, plan.calls + 1)[:, None]
    j = np.arange(plan.glen)[None, :]
    return roots_all_m[(k * j) % plan.P]


def compute_ntt(f: TField, P: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The NTT's bit-reversal permutation (P,) int64 and per-stage twiddles
    w_m^j (m/2, n) uint32 in Montgomery form, for m = 2, 4, ..., P (the JAX
    package's ``BatchedPrio3._ntt``)."""
    p = f.p
    w = f.oracle.root(P)
    logp = P.bit_length() - 1
    bitrev = np.array([int(format(i, f"0{logp}b")[::-1], 2) for i in range(P)], dtype=np.int64)
    stages = []
    m = 2
    while m <= P:
        w_m = pow(w, P // m, p)
        stages.append(np.stack([f._int_to_limbs_np(f.mont_int(pow(w_m, j, p))) for j in range(m // 2)]))
        m *= 2
    return bitrev, stages
