"""Batched prime-field arithmetic on u32 limbs held in int64 tensors.

The plain PyTorch counterpart of ``janus_tpu/ops/field_jax.py``'s ``JField``.
A field element is a little-endian vector of n u32 limbs (n = 2 for Field64,
4 for Field128).  PyTorch on the CPU has no uint32 add, shift or compare, so
every limb is carried as an int64 holding a value in [0, 2^32) and masked
after each operation.  A 32x32-bit product in int64 may wrap past 2^63, but
its bit pattern is the exact unsigned product, so the low and high words come
out right through ``& M32`` and ``(x >> 32) & M32``.

Montgomery form uses R = 2^(32 n) exactly as ``JField`` does, so the CUDA
field core (``csrc/field.cuh``, 64-bit limbs, the same R) and these limbs are
byte-equal.  All operations are exact integer arithmetic mod p.

Kernel I/O uses int32 tensors that hold the u32 bit patterns (half the bytes
of int64); ``words``/``storage`` convert between the two.

The limb-digit matmul layer (``mat_mul_mont``, ``dot_mont``,
``poly_eval_dot``; ``JField``'s "mxu" layout) splits each element into 4n
base-2^8 digits and contracts the digit planes as one float64 matmul: every
partial sum is an integer below K * 255^2 <= 2^32 < 2^53, so it is exact in
any order of addition, on the CPU and in cuBLAS alike.  One pass an output
element then folds the digit-pair sums into canonical limbs
(``_lazy_reduce_digits``, on the card ``ops/field_kernels.py``'s kernel).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF
M8 = 0xFF

#: Longest contraction of one ``mat_mul_mont`` digit pass: a digit-pair
#: partial sum is at most K * 255^2 and must stay below 2^32, so K <=
#: 66051; 65536 is the JAX package's ``DOT_MAX_K``.  Longer contractions add
#: their chunks mod p.
DOT_MAX_K = 65536
#: Bytes of float64 digit operands and partial sums one digit pass may hold
#: (8 bytes a digit, 8x the limbs): a larger batch is split into slices.
DIGIT_BYTE_BUDGET = 1 << 30


def words(x: torch.Tensor) -> torch.Tensor:
    """int32 u32-bit-pattern storage -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def storage(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 storage of the same bits."""
    return x.to(torch.int32)


def u32_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32 array -> int32 storage tensor on ``device``."""
    a = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def tensor_to_u32(x: torch.Tensor) -> np.ndarray:
    """int32 storage (or int64 words) tensor -> host uint32 array."""
    if x.dtype == torch.int64:
        x = storage(x)
    return x.cpu().numpy().view(np.uint32)


def _adc(a, b, carry_in):
    """a + b + carry_in -> (sum mod 2^32, carry_out in {0, 1})."""
    s = a + b + carry_in
    return s & M32, s >> 32


def _sbb(a, b, borrow_in):
    """a - b - borrow_in -> (diff mod 2^32, borrow_out in {0, 1})."""
    bb = b + borrow_in
    return (a - bb) & M32, (a < bb).to(torch.int64)


def _mac(a, b, acc, carry):
    """a*b + acc + carry -> (hi, lo).  The true value is < 2^64; int64 wraps
    to the same bit pattern."""
    x = a * b + acc + carry
    return (x >> 32) & M32, x & M32


class TField:
    """Batched ops for one of the oracle fields (``janus_tpu_torch.fields``).

    Tensor forms take the limb axis last, (..., n), as ``JField`` does; the
    ``*_limbs`` forms take lists of n same-shaped tensors, which the planar
    prepare code uses with the report axis last.
    """

    def __init__(self, oracle_field: type):
        self.oracle = oracle_field
        p = oracle_field.MODULUS
        self.p = p
        self.n = oracle_field.ENCODED_SIZE // 4
        r = (1 << (32 * self.n)) % p
        self.p_np = self._int_to_limbs_np(p)
        self.r2_np = self._int_to_limbs_np(r * r % p)
        self.one_np = self._int_to_limbs_np(1)
        self.mont_one_np = self._int_to_limbs_np(r)
        self.p_limbs = [int(x) for x in self.p_np]
        self.n_prime = (-pow(p, -1, 1 << 32)) % (1 << 32)
        #: the bits of p - 2, most significant first (Fermat inversion)
        self.inv_exp_bits = [int(b) for b in bin(p - 2)[2:]]

    # --- host-side conversions ----------------------------------------
    def _int_to_limbs_np(self, x: int) -> np.ndarray:
        return np.array([(x >> (32 * i)) & M32 for i in range(self.n)], dtype=np.uint32)

    def to_limbs(self, values: Sequence[int]) -> np.ndarray:
        """Host: python ints in [0, 2^(32n)) -> (len, n) uint32 limbs."""
        if self.n == 2:
            # a Field64 element is one u64: numpy converts the list at once
            return np.array(values, dtype="<u8").view("<u4").astype(np.uint32).reshape(-1, 2)
        size = 4 * self.n
        data = b"".join(int(v).to_bytes(size, "little") for v in values)
        return np.frombuffer(data, dtype="<u4").astype(np.uint32).reshape(-1, self.n)

    def from_limbs(self, limbs: np.ndarray) -> List[int]:
        """Host: (..., n) uint32 limbs -> python ints (flattened)."""
        if self.n == 2:
            return np.ascontiguousarray(limbs, dtype="<u4").view("<u8").ravel().tolist()
        size = 4 * self.n
        data = np.ascontiguousarray(limbs, dtype="<u4").tobytes()
        return [int.from_bytes(data[i : i + size], "little") for i in range(0, len(data), size)]

    def mont_int(self, value: int) -> int:
        return (value % self.p) * (1 << (32 * self.n)) % self.p

    def mont_one(self, device="cpu") -> torch.Tensor:
        return torch.from_numpy(self.mont_one_np.astype(np.int64)).to(device)

    # --- limb-list core --------------------------------------------------
    def _split(self, a: torch.Tensor) -> List[torch.Tensor]:
        return [a[..., i] for i in range(self.n)]

    def _join(self, limbs: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(limbs, dim=-1)

    def _cond_sub_p(self, limbs, extra_bit):
        """limbs + extra_bit * 2^(32n); subtract p once if that is >= p."""
        d = []
        borrow = torch.zeros_like(limbs[0])
        for i in range(self.n):
            di, borrow = _sbb(limbs[i], self.p_limbs[i], borrow)
            d.append(di)
        take = (extra_bit | (1 - borrow)) != 0
        return [torch.where(take, d[i], limbs[i]) for i in range(self.n)]

    def add_limbs(self, aa: List, bb: List) -> List:
        s = []
        carry = torch.zeros_like(aa[0])
        for i in range(self.n):
            si, carry = _adc(aa[i], bb[i], carry)
            s.append(si)
        return self._cond_sub_p(s, carry)

    def sub_limbs(self, aa: List, bb: List) -> List:
        d = []
        borrow = torch.zeros_like(aa[0])
        for i in range(self.n):
            di, borrow = _sbb(aa[i], bb[i], borrow)
            d.append(di)
        s = []
        carry = torch.zeros_like(d[0])
        for i in range(self.n):
            si, carry = _adc(d[i], self.p_limbs[i], carry)
            s.append(si)
        use_add = borrow != 0
        return [torch.where(use_add, s[i], d[i]) for i in range(self.n)]

    def mont_mul_limbs(self, aa: List, bb: List) -> List:
        """CIOS Montgomery product a*b*R^-1 mod p on limb lists."""
        n = self.n
        zero = torch.zeros_like(aa[0] + bb[0])
        t = [zero] * (n + 2)
        for i in range(n):
            carry = zero
            for j in range(n):
                carry, t[j] = _mac(aa[i], bb[j], t[j], carry)
            s = t[n] + carry
            t[n] = s & M32
            t[n + 1] = t[n + 1] + (s >> 32)
            m = (t[0] * self.n_prime) & M32
            carry, _lo = _mac(m, self.p_limbs[0], t[0], zero)
            for j in range(1, n):
                carry, t[j - 1] = _mac(m, self.p_limbs[j], t[j], carry)
            s = t[n] + carry
            t[n - 1] = s & M32
            t[n] = t[n + 1] + (s >> 32)
            t[n + 1] = zero
        return self._cond_sub_p(t[:n], t[n])

    # --- tensor forms (limb axis last) ----------------------------------
    def add(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._join(self.add_limbs(self._split(a), self._split(b)))

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._join(self.sub_limbs(self._split(a), self._split(b)))

    def mont_mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._join(self.mont_mul_limbs(self._split(a), self._split(b)))

    def to_mont(self, a):
        r2 = torch.from_numpy(self.r2_np.astype(np.int64)).to(a.device)
        return self.mont_mul(a, r2)

    def from_mont(self, a):
        one = torch.from_numpy(self.one_np.astype(np.int64)).to(a.device)
        return self.mont_mul(a, one)

    def eq(self, a, b):
        return torch.all(a == b, dim=-1)

    def is_zero(self, a):
        return torch.all(a == 0, dim=-1)

    def sum(self, a, axis: int):
        """Exact modular sum along an element axis (never the limb axis).

        16..65535 terms take the lazy u16-half sum (one mod-p fold at the
        end); shorter axes take the pairwise add tree, as ``JField.sum``."""
        axis = axis % (a.dim() - 1)
        length = a.shape[axis]
        if 16 <= length <= 65535:
            slo = torch.sum(a & M16, dim=axis)
            shi = torch.sum(a >> 16, dim=axis)
            return self.lazy_fold(slo, shi)
        while length > 1:
            half = length // 2
            lo = a.narrow(axis, 0, half)
            hi = a.narrow(axis, half, half)
            rest = a.narrow(axis, 2 * half, length - 2 * half)
            a = torch.cat([self.add(lo, hi), rest], dim=axis)
            length = half + (length - 2 * half)
        return a.squeeze(axis)

    def lazy_fold_limbs(self, slo: List, shi: List) -> List:
        """u16-half column sums (limb lists, each < 2^32) -> canonical limbs.

        The base-2^16 digit stream is carry-normalised; the overflow beyond
        2^(32n) folds back through one mont_mul with R^2."""
        n = self.n
        carry = torch.zeros_like(slo[0])
        digits = []
        for i in range(n):
            t = slo[i] + carry
            digits.append(t & M16)
            carry = t >> 16
            t = shi[i] + carry
            digits.append(t & M16)
            carry = t >> 16
        limbs = [digits[2 * j] | (digits[2 * j + 1] << 16) for j in range(n)]
        zero = torch.zeros_like(carry)
        r2 = [zero + int(x) for x in self.r2_np]
        corr = self.mont_mul_limbs([carry] + [zero] * (n - 1), r2)
        limbs = self.add_limbs(limbs, [zero] * n)
        return self.add_limbs(limbs, corr)

    def lazy_fold(self, slo, shi):
        return self._join(self.lazy_fold_limbs(self._split(slo), self._split(shi)))

    def cumprod_mont(self, a, axis: int):
        """Inclusive cumulative Montgomery product along an element axis.

        Log-depth like ``lax.associative_scan``: pass d multiplies each
        position by the one 2^d before it, so L positions take ceil(log2 L)
        full-width products instead of L - 1 sequential ones."""
        axis = axis % (a.dim() - 1)
        length = a.shape[axis]
        d = 1
        while d < length:
            tail = self.mont_mul(a.narrow(axis, 0, length - d), a.narrow(axis, d, length - d))
            a = torch.cat([a.narrow(axis, 0, d), tail], dim=axis)
            d *= 2
        return a

    def mutual_products_mont(self, a, axis: int):
        """For each k along the axis: prod_{j != k} a_j (Montgomery), as the
        exclusive prefix times the exclusive suffix product."""
        axis = axis % (a.dim() - 1)
        length = a.shape[axis]
        one = self.mont_one(a.device).expand_as(a.narrow(axis, 0, 1))
        prefix = self.cumprod_mont(a, axis)
        suffix = self.cumprod_mont(a.flip(axis), axis).flip(axis)
        prefix_excl = torch.cat([one, prefix.narrow(axis, 0, length - 1)], dim=axis)
        suffix_excl = torch.cat([suffix.narrow(axis, 1, length - 1), one], dim=axis)
        return self.mont_mul(prefix_excl, suffix_excl)

    def _powers_from_one(self, x, count: int):
        """x^0..x^(count-1) (Montgomery): x (..., n) -> (..., count, n)."""
        one = self.mont_one(x.device).expand_as(x).unsqueeze(-2)
        if count == 1:
            return one
        pw = self.cumprod_mont(x.unsqueeze(-2).expand(x.shape[:-1] + (count - 1, self.n)), axis=-1)
        return torch.cat([one, pw], dim=-2)

    def poly_eval_mont(self, coeffs, x):
        """Polynomial at x by baby-step/giant-step: coeffs (..., C, n)
        canonical, low order first; x (..., n) Montgomery -> (..., n)
        canonical.  The baby and giant powers come from log-depth scans."""
        C = coeffs.shape[-2]
        bs = max(1, math.isqrt(C))
        gs = -(-C // bs)
        if bs * gs > C:
            pad = torch.zeros(coeffs.shape[:-2] + (bs * gs - C, self.n), dtype=coeffs.dtype, device=coeffs.device)
            coeffs = torch.cat([coeffs, pad], dim=-2)
        baby = self._powers_from_one(x, bs + 1)  # x^0..x^bs
        giant = self._powers_from_one(baby[..., bs, :], gs)  # x^(bs*g)
        cg = coeffs.reshape(coeffs.shape[:-2] + (gs, bs, self.n))
        inner = self.sum(self.mont_mul(cg, baby[..., None, :bs, :]), axis=-1)  # (..., gs, n)
        return self.sum(self.mont_mul(inner, giant), axis=-1)

    def horner_mont(self, coeffs, x):
        """Polynomial at x by Horner's rule: coeffs (..., C, n) canonical,
        low order first; x (..., n) Montgomery -> (..., n) canonical."""
        acc = torch.zeros_like(coeffs[..., 0, :])
        for j in range(coeffs.shape[-2] - 1, -1, -1):
            acc = self.add(self.mont_mul(acc, x), coeffs[..., j, :])
        return acc

    def ntt_eval_mont(self, coeffs, bitrev_idx: torch.Tensor, tw_stages: List[torch.Tensor]):
        """A polynomial at every P-th root of unity (Cooley-Tukey DIT):
        coeffs (..., P, n) canonical -> (..., P, n) canonical, value j at
        w^j.  ``bitrev_idx`` (P,) is the bit-reversal permutation and
        ``tw_stages`` the per-stage twiddles (m/2, n) in Montgomery form."""
        P = coeffs.shape[-2]
        x = coeffs.index_select(coeffs.dim() - 2, bitrev_idx)
        m = 2
        for tw in tw_stages:
            xr = x.reshape(x.shape[:-2] + (P // m, m, self.n))
            even, odd = xr[..., : m // 2, :], xr[..., m // 2 :, :]
            t = self.mont_mul(odd, tw)
            x = torch.cat([self.add(even, t), self.sub(even, t)], dim=-2).reshape(x.shape)
            m *= 2
        return x

    def pow_range_limbs(self, x: List, count: int) -> List:
        """x^1..x^count (Montgomery) by baby-step/giant-step on limb lists:
        each x (...) -> (..., count)."""
        bs = max(1, math.isqrt(count))
        gs = -(-count // bs)
        baby = [x]
        for _ in range(bs - 1):
            baby.append(self.mont_mul_limbs(baby[-1], x))
        one = [torch.zeros_like(x[0]) + int(v) for v in self.mont_one_np]
        giant = [one]
        for _ in range(gs - 1):
            giant.append(self.mont_mul_limbs(giant[-1], baby[-1]))
        baby_t = [torch.stack([b[l] for b in baby], dim=-1) for l in range(self.n)]
        giant_t = [torch.stack([g[l] for g in giant], dim=-1) for l in range(self.n)]
        outer = self.mont_mul_limbs(
            [g.unsqueeze(-1) for g in giant_t], [b.unsqueeze(-2) for b in baby_t]
        )
        return [o.reshape(o.shape[:-2] + (gs * bs,))[..., :count] for o in outer]

    def pow_range_mont(self, x, count: int):
        """x (..., n) Montgomery -> (..., count, n): x^1..x^count."""
        return self._join(self.pow_range_limbs(self._split(x), count))

    def is_canonical_limbs(self, limbs: List) -> torch.Tensor:
        """True where the limb value is < p (the rejection-sampling test)."""
        borrow = torch.zeros_like(limbs[0])
        for i in range(self.n):
            _, borrow = _sbb(limbs[i], self.p_limbs[i], borrow)
        return borrow == 1

    # --- inversion (Montgomery domain) -------------------------------------
    def _fermat_inv_mont(self, a):
        """a^(p-2) by square-and-multiply over the bits of p - 2: the
        Montgomery form of the inverse of a's value; inv(0) = 0."""
        acc = self.mont_one(a.device).expand_as(a)
        for bit in self.inv_exp_bits:
            acc = self.mont_mul(acc, acc)
            if bit:
                acc = self.mont_mul(acc, a)
        return acc

    def inv_mont(self, a):
        """Inverse in the Montgomery domain, inv(0) = 0.  One element takes
        the Fermat chain; more take Montgomery's batch trick, one chain over
        the product of all fanned back out by the mutual products, with
        each zero replaced by one before the product and zeroed after.  An
        inverse and its canonical limbs are unique, so both give the same
        limbs."""
        if a[..., 0].numel() <= 1:
            return self._fermat_inv_mont(a)
        flat = a.reshape(-1, self.n)
        zero = self.is_zero(flat)[:, None]
        safe = torch.where(zero, self.mont_one(a.device).expand_as(flat), flat)
        inv = self._batch_inv_nonzero(safe, 0)
        return torch.where(zero, torch.zeros_like(inv), inv).reshape(a.shape)

    def _batch_inv_nonzero(self, a, axis: int):
        """inv(a_k) = inv(prod_j a_j) * prod_{j != k} a_j along an element
        axis whose entries are all nonzero."""
        length = a.shape[axis]
        total = self.cumprod_mont(a, axis).narrow(axis, length - 1, 1)
        return self.mont_mul(self.mutual_products_mont(a, axis), self._fermat_inv_mont(total).expand_as(a))

    def batch_inv_mont(self, a, axis: int):
        """Montgomery's batch inversion along an element axis (all nonzero)."""
        return self._batch_inv_nonzero(a, axis % (a.dim() - 1))

    # --- the limb-digit matmul layer ---------------------------------------
    def _digits8(self, x):
        """(..., n) limbs -> (..., 4n) base-2^8 digits, little-endian: digit
        d has weight 2^(8d)."""
        parts = torch.stack([(x >> (8 * i)) & M8 for i in range(4)], dim=-1)
        return parts.reshape(x.shape[:-1] + (4 * self.n,))

    def mat_mul_mont(self, a, b):
        """Modular matmul with one Montgomery reduction an output element:
        a (*B, K, M, n) x b (*B, K, N, n) -> (*B, M, N, n) canonical, with
        out[m, v] = sum_k a[k, m] b[k, v] R^-1 mod p, which is sum_k
        mont_mul(a_k, b_k): a canonical operand times a Montgomery one lands
        canonical, as a mont_mul/sum chain does.  ``b`` may omit the batch
        dimensions ((K, N, n)): a constant matrix shared by every batch
        element.  A contraction longer than DOT_MAX_K adds its chunks mod p."""
        K = a.shape[-3]
        out = None
        for s in range(0, K, DOT_MAX_K):
            part = self._mat_mul_dot(a[..., s : s + DOT_MAX_K, :, :], b[..., s : s + DOT_MAX_K, :, :])
            out = part if out is None else self.add(out, part)
        return out

    def _mat_mul_dot(self, a, b):
        """One digit pass of ``mat_mul_mont`` (K <= DOT_MAX_K): the (M*D, K)
        x (K, N*D) digit product (D = 4n) as one float64 matmul, then
        ``field_kernels.lazy_reduce_digits``.  The batch is taken in slices
        whose digit operands and partial sums stay under DIGIT_BYTE_BUDGET."""
        from .field_kernels import lazy_reduce_digits

        n, D = self.n, 4 * self.n
        K, M, N = a.shape[-3], a.shape[-2], b.shape[-2]
        batch = a.shape[:-3]
        shared = b.dim() == 3
        if not shared and b.shape[:-3] != batch:
            raise ValueError(f"mat_mul_mont: batch dimensions {tuple(b.shape[:-3])} and {tuple(batch)} differ")
        a = a.reshape((-1, K, M, n))
        if not shared:
            b = b.reshape((-1, K, N, n))
        per_row = 8 * (M * D * K + M * D * N * D + (0 if shared else K * N * D))
        step = max(1, DIGIT_BYTE_BUDGET // per_row)
        outs = []
        for s in range(0, a.shape[0], step):
            lhs, rhs = self.digit_operands(a[s : s + step], b if shared else b[s : s + step])
            P = torch.matmul(lhs, rhs).reshape(-1, M, D, N, D)
            outs.append(words(lazy_reduce_digits(self, P)))
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out.reshape(batch + (M, N, n))

    def digit_operands(self, a, b):
        """The float64 digit operands of one digit pass: a (R, K, M, n) ->
        (R, M*D, K) and b (K, N, n) -> (K, N*D) or (R, K, N, n) -> (R, K,
        N*D), so that their matmul, read as (R, M, D, N, D), is the
        digit-pair partial sums."""
        R, K, M, _ = a.shape
        D = 4 * self.n
        lhs = self._digits8(a).to(torch.float64).permute(0, 2, 3, 1).reshape(R, M * D, K)
        return lhs, self._digits8(b).to(torch.float64).reshape(b.shape[:-2] + (b.shape[-2] * D,))

    def _lazy_reduce_digits(self, P):
        """(..., M, D, N, D) digit-pair partial sums (integers below 2^32,
        float64 or int64) -> canonical (..., M, N, n) int64 limbs.

        Each sum splits into u16 halves; half lo[d, e] lands on digit column
        d + e and hi[d, e] on d + e + 2, so a column holds at most 2D terms
        below 2^16.  The columns carry into the 2n + 1 limbs of the integer
        U = U0 + R U1 + R^2 U2 (R = 2^(32n)), and U R^-1 mod p =
        from_mont(U0) + U1 + mont_mul(U2, R^2), each term canonical."""
        n, D = self.n, 4 * self.n
        P = P.to(torch.int64)
        L = 2 * n + 1
        cols = torch.zeros(P.shape[:-4] + (P.shape[-4], P.shape[-2], 4 * L), dtype=torch.int64, device=P.device)
        for d in range(D):
            cols[..., d : d + D] += P[..., d, :, :] & M16
            cols[..., d + 2 : d + 2 + D] += P[..., d, :, :] >> 16
        limbs = []
        carry = torch.zeros_like(cols[..., 0])
        for j in range(L):
            c = cols[..., 4 * j : 4 * j + 4]
            t = c[..., 0] + (c[..., 1] << 8) + (c[..., 2] << 16) + (c[..., 3] << 24) + carry
            limbs.append(t & M32)
            carry = t >> 32
        zero = torch.zeros_like(carry)
        u0 = self._join(limbs[:n])
        u1 = self._join(limbs[n : 2 * n])
        u2 = self._join([limbs[2 * n]] + [zero] * (n - 1))
        r2 = torch.from_numpy(self.r2_np.astype(np.int64)).to(P.device)
        res = self.add(self.from_mont(u0), self.add(u1, torch.zeros_like(u1)))
        return self.add(res, self.mont_mul(u2, r2))

    def dot_mont(self, a, b):
        """sum_k mont_mul(a_k, b_k): a (*B, K, M, n) x b (*B, K, n) ->
        (*B, M, n), one ``mat_mul_mont``."""
        return self.mat_mul_mont(a, b.unsqueeze(-2)).squeeze(-2)

    def poly_eval_dot(self, coeffs, x):
        """``poly_eval_mont`` with both baby-step/giant-step contractions
        (the coefficient fold a giant step and the giant fold) as
        ``dot_mont``: coeffs (..., C, n) canonical, low order first; x
        (..., n) Montgomery -> (..., n) canonical."""
        C = coeffs.shape[-2]
        bs = max(1, math.isqrt(C))
        gs = -(-C // bs)
        if bs * gs > C:
            pad = torch.zeros(coeffs.shape[:-2] + (bs * gs - C, self.n), dtype=coeffs.dtype, device=coeffs.device)
            coeffs = torch.cat([coeffs, pad], dim=-2)
        baby = self._powers_from_one(x, bs + 1)  # x^0..x^bs
        giant = self._powers_from_one(baby[..., bs, :], gs)  # x^(bs*g)
        cg = coeffs.reshape(coeffs.shape[:-2] + (gs, bs, self.n))
        inner = self.dot_mont(cg.transpose(-3, -2), baby[..., :bs, :])  # (..., gs, n)
        return self.dot_mont(inner.unsqueeze(-2), giant).squeeze(-2)


def field_words(words_: torch.Tensor, num_elems: int, n: int) -> torch.Tensor:
    """(W, B) stream words -> (num_elems, n, B): element e, limb l is word
    e*n + l, as the XOF squeeze emits them."""
    return words_[: num_elems * n].reshape(num_elems, n, words_.shape[-1])


def limb_list(planes: torch.Tensor) -> List[torch.Tensor]:
    """(..., n, B) planes -> list of n (..., B) tensors."""
    return list(planes.unbind(dim=-2))


def limb_stack(limbs: List[torch.Tensor]) -> torch.Tensor:
    """List of n (..., B) tensors -> (..., n, B) planes."""
    return torch.stack(limbs, dim=-2)

