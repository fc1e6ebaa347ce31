"""The port's K5 SumVec wire evaluations against flp_pallas.sumvec_partial_planar
(interpret mode) and against the field formula on the oracle's integers."""

import numpy as np
import pytest
import torch

from janus_tpu.fields import Field128
from janus_tpu.ops.field_jax import JField
from janus_tpu.ops.flp_pallas import pad_chunk, sumvec_partial_planar
from janus_tpu_torch import _build, state
from janus_tpu_torch.ops import flp_kernels
from janus_tpu_torch.ops.field import TField

P = Field128.MODULUS
R_INV = pow(1 << 128, -1, P)
N = 4


def _ints(rng, count):
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]


def _plane(f, vals, L, B):
    """L*B ints, element-major -> (L, n, B) int32 planes."""
    limbs = f.to_limbs(vals).reshape(L, B, N).transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32))


def _mont_pow(x, e):
    """x^e in Montgomery form from x in Montgomery form."""
    return pow(x, e, P) * pow(R_INV, e - 1, P) % P


def _wires_from_ints(m, pr, jr, lagk, lag0, cc, meas_len, chunk, calls, B):
    """The SumVec wire formula on integers: element-major lists, b fastest."""
    at = lambda vals, e, b: vals[e * B + b]  # noqa: E731
    ev, od = {}, {}
    for b in range(B):
        for u in range(chunk):
            ks = [k for k in range(calls) if k * chunk + u < meas_len]
            s1 = sum(at(m, k * chunk + u, b) * _mont_pow(at(jr, k, b), u + 1) * R_INV * at(lagk, k, b) * R_INV for k in ks)
            s2 = sum(at(m, k * chunk + u, b) * at(lagk, k, b) * R_INV for k in ks)
            ev[b, u] = (at(pr, 2 * u, b) * at(lag0, 0, b) * R_INV + s1) % P
            od[b, u] = (at(pr, 2 * u + 1, b) * at(lag0, 0, b) * R_INV + s2 - at(cc, 0, b)) % P
    return ev, od


def test_sumvec_plain_matches_pallas_interpret():
    """Two calls of chunk 4 (KC = 2, one slab) at R = 1, the last call
    zero-padded past meas_len 7.  The Pallas kernel takes klu from the
    oracle's integers; its partial sums finish into wires on integers."""
    rng = np.random.default_rng(11)
    f = TField(Field128)
    meas_len, chunk, calls, B = 7, 4, 2, 128
    cp = pad_chunk(chunk)
    m, pr = _ints(rng, meas_len * B), _ints(rng, 2 * chunk * B)
    jr, lagk, lag0, cc = _ints(rng, calls * B), _ints(rng, calls * B), _ints(rng, B), _ints(rng, B)

    m_pad = np.zeros((calls * chunk, N, B), np.uint32)
    m_pad[:meas_len] = f.to_limbs(m).reshape(meas_len, B, N).transpose(0, 2, 1)
    klu = np.zeros((calls, cp, N, B), np.uint32)
    for k in range(calls):
        for u in range(chunk):
            vals = [_mont_pow(jr[k * B + b], u + 1) * lagk[k * B + b] * R_INV % P for b in range(B)]
            klu[k, u] = f.to_limbs(vals).T
    m_slab = np.zeros((calls, cp, N, B), np.uint32)
    m_slab[:, :chunk] = m_pad.reshape(calls, chunk, N, B)

    def to_jax(x):  # (calls, cp, n, B) -> (R, n, calls, cp, 128)
        return np.ascontiguousarray(x.reshape(calls, cp, N, 1, 128).transpose(3, 2, 0, 1, 4))

    lagk_np = f.to_limbs(lagk).reshape(calls, B, N).transpose(0, 2, 1)
    lagk_slab = np.ascontiguousarray(lagk_np.reshape(calls, N, 1, 128).transpose(2, 1, 0, 3))
    jev, jod = sumvec_partial_planar(JField(Field128), to_jax(m_slab), to_jax(klu), lagk_slab, interpret=True)
    ev_part = f.from_limbs(state.from_jax_planar(np.asarray(jev))[:chunk].transpose(0, 2, 1))
    od_part = f.from_limbs(state.from_jax_planar(np.asarray(jod))[:chunk].transpose(0, 2, 1))

    ev, od = flp_kernels.sumvec_wires(
        f, meas_len, chunk, _plane(f, m, meas_len, B).reshape(-1, B), _plane(f, pr, 2 * chunk, B).reshape(-1, B),
        _plane(f, jr, calls, B), _plane(f, lagk, calls, B), _plane(f, lag0, 1, B)[0], _plane(f, cc, 1, B)[0],
    )
    got_ev = f.from_limbs(ev.numpy().view(np.uint32).transpose(0, 2, 1))
    got_od = f.from_limbs(od.numpy().view(np.uint32).transpose(0, 2, 1))
    for u in range(chunk):
        for b in range(B):
            i = u * B + b
            want_ev = (pr[2 * u * B + b] * lag0[b] * R_INV + ev_part[i]) % P
            want_od = (pr[(2 * u + 1) * B + b] * lag0[b] * R_INV + od_part[i] - cc[b]) % P
            assert (got_ev[i], got_od[i]) == (want_ev, want_od), (u, b)


@pytest.mark.parametrize("meas_len,chunk", [(40, 4), (10, 3), (7, 7)])
def test_sumvec_plain_matches_field_formula(meas_len, chunk):
    """Every column and call at B = 4, including the last call's padding."""
    rng = np.random.default_rng(meas_len * 10 + chunk)
    f = TField(Field128)
    B = 4
    calls = -(-meas_len // chunk)
    m, pr = _ints(rng, meas_len * B), _ints(rng, 2 * chunk * B)
    jr, lagk, lag0, cc = _ints(rng, calls * B), _ints(rng, calls * B), _ints(rng, B), _ints(rng, B)
    ev, od = flp_kernels.sumvec_wires(
        f, meas_len, chunk, _plane(f, m, meas_len, B).reshape(-1, B), _plane(f, pr, 2 * chunk, B).reshape(-1, B),
        _plane(f, jr, calls, B), _plane(f, lagk, calls, B), _plane(f, lag0, 1, B)[0], _plane(f, cc, 1, B)[0],
    )
    want_ev, want_od = _wires_from_ints(m, pr, jr, lagk, lag0, cc, meas_len, chunk, calls, B)
    for b in range(B):
        for u in range(chunk):
            got = (f.from_limbs(ev[u, :, b].numpy().view(np.uint32))[0], f.from_limbs(od[u, :, b].numpy().view(np.uint32))[0])
            assert got == (want_ev[b, u], want_od[b, u]), (b, u)


def _zeros(meas_len, chunk, calls, B, device="cpu"):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    return (z(meas_len * N, B), z(2 * chunk * N, B), z(calls, N, B), z(calls, N, B), z(N, B), z(N, B))


def test_sumvec_wrapper_rejects_bad_inputs():
    f = TField(Field128)
    good = _zeros(10, 3, 4, 5)
    flp_kernels.sumvec_wires(f, 10, 3, *good)
    with pytest.raises(ValueError):  # int64 storage
        flp_kernels.sumvec_wires(f, 10, 3, *((good[0].long(),) + good[1:]))
    with pytest.raises(ValueError):  # stream shorter than the circuit
        flp_kernels.sumvec_wires(f, 11, 3, *good)
    with pytest.raises(ValueError):  # too few calls for meas_len
        flp_kernels.sumvec_wires(f, 10, 3, *(good[:2] + _zeros(10, 3, 3, 5)[2:4] + good[4:]))
    with pytest.raises(ValueError):  # lag0 with the wrong limb count
        flp_kernels.sumvec_wires(f, 10, 3, *(good[:4] + (torch.zeros((3, 5), dtype=torch.int32),) + good[5:]))


def test_sumvec_wrapper_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: with
    the library failing to load, the plain version is never taken."""
    def no_library(name):
        raise _build.BuildError(f"no library for {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(flp_kernels, "sumvec_wires_plain", no_plain)
    before = flp_kernels.sumvec_wires.launches
    with pytest.raises(_build.BuildError):
        flp_kernels.sumvec_wires(TField(Field128), 10, 3, *_zeros(10, 3, 4, 5, device="meta"))
    assert flp_kernels.sumvec_wires.launches == before
