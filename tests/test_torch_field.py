"""The port's field ops (janus_tpu_torch.ops.field) against JField.

Same numpy-seeded limbs through both; outputs must be byte-equal."""

import numpy as np
import pytest
import torch

from janus_tpu.fields import Field64, Field128
from janus_tpu.ops.field_jax import JField
from janus_tpu_torch.ops.field import TField, _sbb, storage, tensor_to_u32, u32_to_tensor, words

FIELDS = [Field64, Field128]


def _values(field, rng, count):
    p = field.MODULUS
    edge = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    rand = [int.from_bytes(rng.bytes(field.ENCODED_SIZE), "little") % p for _ in range(count)]
    return edge + rand


def _pair(field, seed, count=26):
    rng = np.random.default_rng(seed)
    jf = JField(field)
    a = jf.to_limbs(_values(field, rng, count))
    b = jf.to_limbs(_values(field, rng, count)[::-1])
    return jf, TField(field), a, b


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))


def _np(x):
    return tensor_to_u32(x)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_host_limb_conversions_match(field):
    rng = np.random.default_rng(1)
    jf, tf = JField(field), TField(field)
    vals = _values(field, rng, 40)
    np.testing.assert_array_equal(tf.to_limbs(vals), jf.to_limbs(vals))
    assert tf.from_limbs(jf.to_limbs(vals)) == jf.from_limbs(jf.to_limbs(vals)) == vals
    for x in (0, 1, field.MODULUS - 1):
        np.testing.assert_array_equal(tf._int_to_limbs_np(x), jf._int_to_limbs_np(x))
    np.testing.assert_array_equal(tf.r2_np, jf.r2_np)
    assert tf.n_prime == int(jf.n_prime)
    np.testing.assert_array_equal(tensor_to_u32(tf.mont_one()), np.asarray(jf.mont_one()))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_jfield(field, op):
    jf, tf, a, b = _pair(field, 2)
    want = np.asarray(getattr(jf, op)(a, b))
    got = _np(getattr(tf, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_mont_conversions_and_predicates_match_jfield(field):
    jf, tf, a, b = _pair(field, 3)
    m = tf.to_mont(_t(a))
    np.testing.assert_array_equal(_np(m), np.asarray(jf.to_mont(a)))
    np.testing.assert_array_equal(_np(tf.from_mont(m)), a)
    np.testing.assert_array_equal(tf.is_zero(_t(a)).numpy(), np.asarray(jf.is_zero(a)))
    np.testing.assert_array_equal(tf.eq(_t(a), _t(a[::-1])).numpy(), np.asarray(jf.eq(a, a[::-1])))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("length", [5, 20])  # add tree, lazy u16-half sum
def test_sum_matches_jfield(field, length):
    jf, tf, a, _ = _pair(field, 4, count=3 * length - 6)
    x = a.reshape(3, length, jf.n)
    np.testing.assert_array_equal(_np(tf.sum(_t(x), axis=1)), np.asarray(jf.sum(x, 1)))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_lazy_fold_matches_jfield(field):
    rng = np.random.default_rng(5)
    jf, tf = JField(field), TField(field)
    slo = rng.integers(0, 2**32, size=(6, jf.n), dtype=np.uint64).astype(np.uint32)
    shi = rng.integers(0, 2**32, size=(6, jf.n), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jf.lazy_fold(slo, shi))
    np.testing.assert_array_equal(_np(tf.lazy_fold(_t(slo), _t(shi))), want)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_cumprod_and_pow_range_match_oracle(field):
    """Held against the oracle's integers: JField's Field128 scan graphs
    take minutes to compile on XLA:CPU."""
    rng = np.random.default_rng(6)
    tf = TField(field)
    p = field.MODULUS
    vals = _values(field, rng, 4)
    mont = [tf.mont_int(v) for v in vals]
    x = _t(tf.to_limbs(mont)).reshape(2, 5, tf.n)
    got = tf.from_limbs(_np(tf.cumprod_mont(x, axis=1)))
    want = []
    for row in (vals[:5], vals[5:]):
        acc = 1
        for v in row:
            acc = acc * v % p
            want.append(tf.mont_int(acc))
    assert got == want
    got = tf.from_limbs(_np(tf.pow_range_mont(x[:, 0], 11)))
    want = [tf.mont_int(pow(v, k, p)) for v in (vals[0], vals[5]) for k in range(1, 12)]
    assert got == want


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_mutual_products_poly_eval_and_ntt_match_oracle(field):
    """mutual_products_mont, poly_eval_mont (baby-step/giant-step),
    horner_mont and ntt_eval_mont against the oracle's integers."""
    rng = np.random.default_rng(7)
    tf = TField(field)
    p = field.MODULUS
    vals = _values(field, rng, 18)[:20]  # two rows of ten
    x = _t(tf.to_limbs([tf.mont_int(v) for v in vals])).reshape(2, 10, tf.n)
    got = tf.from_limbs(_np(tf.mutual_products_mont(x, axis=1)))
    want = []
    for row in (vals[:10], vals[10:]):
        for k in range(10):
            acc = 1
            for j, v in enumerate(row):
                acc = acc * v % p if j != k else acc
            want.append(tf.mont_int(acc))
    assert got == want

    coeffs = _t(tf.to_limbs(vals)).reshape(2, 10, tf.n)  # canonical, low order first
    pts = _values(field, rng, 2)[-2:]
    pt_m = _t(tf.to_limbs([tf.mont_int(v) for v in pts]))
    want = [sum(c * pow(pt, j, p) for j, c in enumerate(row)) % p for row, pt in ((vals[:10], pts[0]), (vals[10:], pts[1]))]
    assert tf.from_limbs(_np(tf.poly_eval_mont(coeffs, pt_m))) == want
    assert tf.from_limbs(_np(tf.horner_mont(coeffs, pt_m))) == want

    P = 8
    w = field.root(P)
    bitrev = torch.tensor([int(format(i, "03b")[::-1], 2) for i in range(P)])
    stages = []
    m = 2
    while m <= P:
        stages.append(_t(tf.to_limbs([tf.mont_int(pow(w, (P // m) * j, p)) for j in range(m // 2)])))
        m *= 2
    got = tf.from_limbs(_np(tf.ntt_eval_mont(coeffs[:, :P], bitrev, stages)))
    assert got == [sum(c * pow(w, k * j, p) for j, c in enumerate(row[:P])) % p for row in (vals[:10], vals[10:]) for k in range(P)]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
def test_canonicality_check_matches_sbb_chain(field):
    """The rejection test: limbs >= p are flagged, exactly at the boundary."""
    tf = TField(field)
    p = field.MODULUS
    vals = [0, p - 1, p, p + 1, (1 << (32 * tf.n)) - 1]
    limbs = torch.from_numpy(tf.to_limbs(vals).astype(np.int64))
    got = tf.is_canonical_limbs(tf._split(limbs)).tolist()
    assert got == [True, True, False, False, False]


def test_sbb_and_storage_round_trip():
    a = torch.tensor([0, 5, 0xFFFFFFFF], dtype=torch.int64)
    b = torch.tensor([1, 5, 0], dtype=torch.int64)
    d, borrow = _sbb(a, b, torch.tensor([0, 1, 1]))
    assert d.tolist() == [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFE]
    assert borrow.tolist() == [1, 1, 0]
    host = np.array([0, 1, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = u32_to_tensor(host, "cpu")
    assert t.dtype == torch.int32
    assert words(t).tolist() == host.astype(np.int64).tolist()
    np.testing.assert_array_equal(tensor_to_u32(storage(words(t))), host)


# The CUDA field core (csrc/field.cuh) works on two 64-bit words with the same
# R = 2^128.  These mirror its functions line by line on Python ints, so the
# word-size change is held against the u32-limb version here on the CPU.
_M64 = (1 << 64) - 1
_P_LO, _P_HI = 1, 0xFFFFFFFFFFFFFFE4


def _cond_sub64(lo, hi, extra):
    dlo, b0 = (lo - _P_LO) & _M64, int(lo < _P_LO)
    dhi = (hi - _P_HI - b0) & _M64
    borrow = hi < _P_HI or (hi == _P_HI and b0)
    return (dlo, dhi) if (extra or not borrow) else (lo, hi)


def _add64(a, b):
    s0 = a[0] + b[0]
    s1 = a[1] + b[1] + (s0 >> 64)
    return _cond_sub64(s0 & _M64, s1 & _M64, s1 >> 64)


def _sub64(a, b):
    dlo, b0 = (a[0] - b[0]) & _M64, int(a[0] < b[0])
    dhi = (a[1] - b[1] - b0) & _M64
    if not (a[1] < b[1] or (a[1] == b[1] and b0)):
        return dlo, dhi
    slo = (dlo + _P_LO) & _M64
    return slo, (dhi + _P_HI + int(slo < dlo)) & _M64


def _mont_mul64(a, b):
    t0 = t1 = t2 = 0
    for ai in a:
        x = ai * b[0] + t0
        t0, c = x & _M64, x >> 64
        x = ai * b[1] + t1 + c
        t1, c = x & _M64, x >> 64
        x = t2 + c
        t2, t3 = x & _M64, x >> 64
        m = (t0 * _M64) & _M64
        c = (m * _P_LO + t0) >> 64
        x = m * _P_HI + t1 + c
        t0, c = x & _M64, x >> 64
        x = t2 + c
        t1, t2 = x & _M64, (t3 + (x >> 64)) & _M64
    return _cond_sub64(t0, t1, t2)


@pytest.mark.parametrize("op,fn", [("add", _add64), ("sub", _sub64), ("mont_mul", _mont_mul64)])
def test_word64_field_core_matches_u32_limbs(op, fn):
    """Same limbs from the 64-bit-word core as from TField's u32 CIOS; the
    Montgomery product also on non-canonical inputs below 2^128."""
    rng = np.random.default_rng(8)
    tf = TField(Field128)
    a = _values(Field128, rng, 60)
    b = _values(Field128, rng, 60)[::-1]
    if op == "mont_mul":
        top = [(1 << 128) - 1, (1 << 128) - 2, Field128.MODULUS, Field128.MODULUS + 5]
        a, b = a + top + top[::-1], b + top[::-1] + top
    want = tf.from_limbs(_np(getattr(tf, op)(_t(tf.to_limbs(a)), _t(tf.to_limbs(b)))))
    got = []
    for x, y in zip(a, b):
        lo, hi = fn((x & _M64, x >> 64), (y & _M64, y >> 64))
        got.append(lo | (hi << 64))
    assert got == want


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("lengths", [(64, 64), (64, 200), (129, 300), (63, 500)], ids=lambda n: "x".join(map(str, n)))
def test_oracle_poly_mul_matches_the_jax_oracle(field, lengths):
    """The port's oracle ``poly_mul`` (through the NTT from
    ``POLY_MUL_NTT_MIN`` coefficients up, the convolution below) against
    the JAX package's convolution, edge values included."""
    from janus_tpu.fields import poly_mul as jax_poly_mul
    from janus_tpu_torch import fields as port_fields

    port_field = getattr(port_fields, field.__name__)
    rng = np.random.default_rng(sum(lengths))
    a, b = (_values(field, rng, n)[:n] for n in lengths)
    assert port_fields.poly_mul(port_field, a, b) == jax_poly_mul(field, a, b)
