"""Finite fields used by Prio3, bit-exact CPU oracle.

Mirrors the field parameters of the ``prio`` crate (libprio-rs v0.16.2) consumed
by the reference (reference: core/src/vdaf.rs:65-108 names the VDAFs; the fields
themselves are defined by draft-irtf-cfrg-vdaf-08 §6.1):

* ``Field64``  — p = 2^32 * 4294967295 + 1 = 2^64 - 2^32 + 1   ("Goldilocks")
* ``Field128`` — p = 2^66 * 4611686018427387897 + 1

Elements are represented as plain Python ints in ``[0, p)``; vectors as lists of
ints.  This module is the correctness oracle for the CUDA kernels in
``janus_tpu_torch.ops`` — every device kernel must agree with it bit-for-bit.

Wire encoding is little-endian fixed-width per element (draft-irtf-cfrg-vdaf-08
§6.1: Field.encode_vec / decode_vec), matching the TLS-syntax opaque encoding the
DAP messages embed (reference: messages/src/lib.rs:11-17 uses prio::codec).
"""

from __future__ import annotations

from typing import List, Sequence


def next_power_of_2(n: int) -> int:
    if n <= 0:
        raise ValueError("n must be positive")
    return 1 << (n - 1).bit_length()


class Field:
    """A prime field with high 2-adicity. Subclasses set the parameters."""

    MODULUS: int
    ENCODED_SIZE: int  # bytes per element, little-endian
    NUM_ROOTS: int  # 2-adicity: 2^NUM_ROOTS divides p-1
    GEN_BASE: int = 7  # multiplicative generator base (as in the VDAF spec tables)

    # --- scalar ops -------------------------------------------------------
    @classmethod
    def add(cls, a: int, b: int) -> int:
        return (a + b) % cls.MODULUS

    @classmethod
    def sub(cls, a: int, b: int) -> int:
        return (a - b) % cls.MODULUS

    @classmethod
    def mul(cls, a: int, b: int) -> int:
        return (a * b) % cls.MODULUS

    @classmethod
    def neg(cls, a: int) -> int:
        return (-a) % cls.MODULUS

    @classmethod
    def inv(cls, a: int) -> int:
        if a % cls.MODULUS == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, cls.MODULUS - 2, cls.MODULUS)

    # --- vector ops -------------------------------------------------------
    @classmethod
    def vec_add(cls, a: Sequence[int], b: Sequence[int]) -> List[int]:
        if len(a) != len(b):
            raise ValueError("vector length mismatch")
        p = cls.MODULUS
        return [(x + y) % p for x, y in zip(a, b)]

    @classmethod
    def vec_sub(cls, a: Sequence[int], b: Sequence[int]) -> List[int]:
        if len(a) != len(b):
            raise ValueError("vector length mismatch")
        p = cls.MODULUS
        return [(x - y) % p for x, y in zip(a, b)]

    # --- roots of unity ---------------------------------------------------
    @classmethod
    def gen(cls) -> int:
        """Generator of the subgroup of order 2^NUM_ROOTS (= GEN_ORDER)."""
        return cls._GEN

    @classmethod
    def gen_order(cls) -> int:
        return 1 << cls.NUM_ROOTS

    @classmethod
    def root(cls, order: int) -> int:
        """Principal root of unity of the given power-of-two order."""
        if order & (order - 1):
            raise ValueError("order must be a power of two")
        if order > cls.gen_order():
            raise ValueError("order exceeds field 2-adicity")
        return pow(cls._GEN, cls.gen_order() // order, cls.MODULUS)

    # --- codec ------------------------------------------------------------
    @classmethod
    def encode_elem(cls, x: int) -> bytes:
        return int(x).to_bytes(cls.ENCODED_SIZE, "little")

    @classmethod
    def decode_elem(cls, data: bytes) -> int:
        if len(data) != cls.ENCODED_SIZE:
            raise ValueError("wrong length for field element")
        x = int.from_bytes(data, "little")
        if x >= cls.MODULUS:
            raise ValueError("field element out of range")
        return x

    @classmethod
    def encode_vec(cls, vec: Sequence[int]) -> bytes:
        # encode_elem inlined: a leader share's marshal encodes every element
        n = cls.ENCODED_SIZE
        return b"".join([int(x).to_bytes(n, "little") for x in vec])

    @classmethod
    def decode_vec(cls, data: bytes) -> List[int]:
        n = cls.ENCODED_SIZE
        if len(data) % n:
            raise ValueError("encoded vector length not a multiple of element size")
        out = []
        for i in range(0, len(data), n):
            out.append(cls.decode_elem(data[i : i + n]))
        return out


class Field64(Field):
    MODULUS = 2**32 * 4294967295 + 1  # = 2^64 - 2^32 + 1
    ENCODED_SIZE = 8
    NUM_ROOTS = 32


class Field128(Field):
    MODULUS = 2**66 * 4611686018427387897 + 1  # = 2^128 - 7*2^66 + 1
    ENCODED_SIZE = 16
    NUM_ROOTS = 66


class Field255(Field):
    """GF(2^255 - 19): the Poplar1 leaf field (VDAF spec field table).

    No NTT support (NUM_ROOTS unset): Poplar1 does no polynomial work, only
    additive sharing and sketch algebra.
    """

    MODULUS = 2**255 - 19
    ENCODED_SIZE = 32


def _init_field(cls: type) -> None:
    p = cls.MODULUS
    # explicit raises: these import-time invariants must hold even under -O
    if (p - 1) % (1 << cls.NUM_ROOTS) != 0:
        raise AssertionError(f"{cls.__name__}: 2-adicity does not divide p-1")
    g = pow(cls.GEN_BASE, (p - 1) >> cls.NUM_ROOTS, p)
    # g must have order exactly 2^NUM_ROOTS.
    if pow(g, 1 << cls.NUM_ROOTS, p) != 1 or pow(g, 1 << (cls.NUM_ROOTS - 1), p) == 1:
        raise AssertionError(f"{cls.__name__}: generator order check failed")
    cls._GEN = g


_init_field(Field64)
_init_field(Field128)


# ---------------------------------------------------------------------------
# Polynomial helpers over a field (coefficient vectors, low-order first).
# Used by the FLP proof system (janus_tpu_torch.flp.generic).
# ---------------------------------------------------------------------------

def poly_eval(field: type, coeffs: Sequence[int], x: int) -> int:
    """Horner evaluation of the polynomial at x."""
    p = field.MODULUS
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


#: From this many coefficients in each operand up, ``poly_mul`` multiplies
#: through the NTT: the wide circuits' gadget polynomials (SumVec(100000)
#: multiplies 316 wire pairs of 512 coefficients a proof) take a fraction of
#: the naive convolution's time, with the same coefficients mod p.
POLY_MUL_NTT_MIN = 64


def poly_mul(field: type, a: Sequence[int], b: Sequence[int]) -> List[int]:
    """The product polynomial: the naive convolution, or for long operands
    the inverse NTT of the pointwise product of the operands' NTTs."""
    p = field.MODULUS
    if not a or not b:
        return []
    if min(len(a), len(b)) >= POLY_MUL_NTT_MIN:
        n_out = len(a) + len(b) - 1
        n = next_power_of_2(n_out)
        fa = ntt(field, list(a) + [0] * (n - len(a)))
        fb = ntt(field, list(b) + [0] * (n - len(b)))
        return ntt(field, [x * y % p for x, y in zip(fa, fb)], inverse=True)[:n_out]
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == 0:
            continue
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def poly_add(field: type, a: Sequence[int], b: Sequence[int]) -> List[int]:
    p = field.MODULUS
    n = max(len(a), len(b))
    out = [0] * n
    for i, x in enumerate(a):
        out[i] = x
    for i, y in enumerate(b):
        out[i] = (out[i] + y) % p
    return out


def ntt(field: type, values: Sequence[int], inverse: bool = False) -> List[int]:
    """Radix-2 NTT of power-of-two size n over the field.

    Forward maps coefficients c to evaluations at w^k (w = principal n-th root,
    k in NTT order 0..n-1); inverse maps evaluations back to coefficients.
    """
    n = len(values)
    if n & (n - 1):
        raise ValueError("NTT size must be a power of two")
    p = field.MODULUS
    a = list(values)
    if n == 1:
        return a
    w = field.root(n)
    if inverse:
        w = pow(w, p - 2, p)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wl = pow(w, n // length, p)
        half = length // 2
        for start in range(0, n, length):
            wn = 1
            for k in range(start, start + half):
                u = a[k]
                v = a[k + half] * wn % p
                a[k] = (u + v) % p
                a[k + half] = (u - v) % p
                wn = wn * wl % p
        length <<= 1
    if inverse:
        n_inv = pow(n, p - 2, p)
        a = [x * n_inv % p for x in a]
    return a


def poly_interp(field: type, values: Sequence[int]) -> List[int]:
    """Interpolate the polynomial with value values[k] at w^k (w of order n).

    n = len(values) must be a power of two.  Returns n coefficients.
    """
    return ntt(field, values, inverse=True)
