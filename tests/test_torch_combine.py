"""The port's K4 planar combine-decide against flp_pallas.combine_decide_planar
(interpret mode) and the field formula, and the planar combine of
BatchedPrio3 against its row-major combine and the oracle."""

import numpy as np
import pytest
import torch

from janus_tpu.fields import Field128
from janus_tpu.ops.field_jax import JField
from janus_tpu.ops.flp_pallas import _grid_chunk, combine_decide_planar
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu_torch import _build, state
from janus_tpu_torch.ops import flp_kernels
from janus_tpu_torch.ops.field import TField
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import instances
from test_torch_prepare import _inputs

P = Field128.MODULUS
R_INV = pow(1 << 128, -1, P)
N = 4


def _planes(rng, L, B):
    """Random canonical Field128 limbs (top bit clear) as uint32 (L, n, B)."""
    x = rng.integers(0, 2**32, size=(L, N, B), dtype=np.uint64).astype(np.uint32)
    x[:, N - 1] >>= 1
    return x


def _rows(rng, B, L):
    """A peer verifier as it arrives: canonical limbs as int64 rows (B, L, n)."""
    return torch.from_numpy(_planes(rng, L, B).transpose(2, 0, 1).astype(np.int64)).contiguous()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("chunk", [1, 3, 17])
def test_combine_plain_matches_pallas_interpret(chunk):
    rng = np.random.default_rng(5 + chunk)
    f = TField(Field128)
    B = 128  # one lane tile, as the Pallas kernel needs
    cp = int(np.prod(_grid_chunk(chunk)))
    he, ho, pv = _planes(rng, chunk, B), _planes(rng, chunk, B), _rows(rng, B, 2 * chunk + 2)
    jhe, jho = (state.to_jax_planar(np.concatenate([x, np.zeros((cp - chunk, N, B), np.uint32)])) for x in (he, ho))
    # Only the JAX side puts the peer's rows in planes.
    jpv = state.to_jax_planar(np.ascontiguousarray(pv.numpy().astype(np.uint32).transpose(1, 2, 0)))
    parts = combine_decide_planar(JField(Field128), chunk, jhe, jho, jpv, interpret=True)
    # Fold the (R, n, 8*NJ, 128) sublane partials into one sum per report.
    want = np.asarray(JField(Field128).sum(np.asarray(parts).transpose(0, 3, 2, 1).reshape(B, -1, N), axis=1))
    g = flp_kernels.combine_decide(f, chunk, _t(he), _t(ho), pv)
    assert g.shape == (N, B)
    np.testing.assert_array_equal(g.numpy().view(np.uint32).T, want)


@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("chunk", [1, 5, 20])
def test_combine_plain_matches_field_formula(chunk, B):
    rng = np.random.default_rng([chunk, B])
    f = TField(Field128)
    he, ho, pv = _planes(rng, chunk, B), _planes(rng, chunk, B), _rows(rng, B, 2 * chunk + 2)
    g = flp_kernels.combine_decide(f, chunk, _t(he), _t(ho), pv)
    ints = lambda x: np.array(f.from_limbs(x.transpose(0, 2, 1)), dtype=object).reshape(x.shape[0], B)  # noqa: E731
    he_i, ho_i = ints(he), ints(ho)
    pv_i = ints(pv.numpy().astype(np.uint32).transpose(1, 2, 0))
    for b in range(B):
        want = sum((he_i[u, b] + pv_i[1 + 2 * u, b]) * (ho_i[u, b] + pv_i[2 + 2 * u, b]) for u in range(chunk)) * R_INV % P
        assert f.from_limbs(g[:, b].numpy().view(np.uint32))[0] == want, b


def test_combine_wrapper_rejects_bad_inputs_and_never_falls_back(monkeypatch):
    f = TField(Field128)
    z = lambda *s, device="cpu": torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    rows = lambda *s, device="cpu": torch.zeros(s, dtype=torch.int64, device=device)  # noqa: E731
    flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(5, 8, N))
    with pytest.raises(ValueError):  # ho of the wrong width
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(4, N, 5), rows(5, 8, N))
    with pytest.raises(ValueError):  # int64 storage of our wires
        flp_kernels.combine_decide(f, 3, z(3, N, 5).long(), z(3, N, 5), rows(5, 8, N))
    with pytest.raises(ValueError):  # peer verifier too short for chunk 3
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(5, 6, N))
    with pytest.raises(ValueError):  # peer verifier longer than chunk 3's
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(5, 9, N))
    with pytest.raises(ValueError):  # peer verifier narrowed to int32 words
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), z(5, 8, N))
    with pytest.raises(ValueError):  # peer verifier in planes, not rows
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(8, N, 5))
    with pytest.raises(ValueError):  # peer verifier rows that are not contiguous
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(8, 5, N).transpose(0, 1))
    with pytest.raises(ValueError):  # peer rows for another batch
        flp_kernels.combine_decide(f, 3, z(3, N, 5), z(3, N, 5), rows(6, 8, N))

    def no_library(name):
        raise _build.BuildError(f"no library for {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(flp_kernels, "combine_decide_plain", no_plain)
    with pytest.raises(ValueError):  # our wires and the peer's rows on different devices
        flp_kernels.combine_decide(f, 3, z(3, N, 5, device="meta"), z(3, N, 5, device="meta"), rows(5, 8, N))
    with pytest.raises(_build.BuildError):
        flp_kernels.combine_decide(
            f, 3, z(3, N, 5, device="meta"), z(3, N, 5, device="meta"), rows(5, 8, N, device="meta")
        )


def _sharded(jvdaf, count, seed, vector):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        length = jvdaf.flp.valid.OUTPUT_LEN
        m = [int(x) for x in rng.integers(0, 2, length)] if vector else int(rng.integers(0, length))
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(m, nonce, rng.bytes(jvdaf.RAND_SIZE))
        out.append((m, nonce, public, list(shares)))
    # Tamper the leader's share of report 1: its proof no longer verifies.
    lead = out[1][3][0]
    bad = list(lead.meas_share)
    bad[0] = (bad[0] + 1) % P
    out[1][3][0] = type(lead)(bad, lead.proofs_share, None, lead.joint_rand_blind)
    return out


@pytest.mark.parametrize(
    "name,jctor,ctor,vector",
    [
        ("histogram", lambda: jax_instances.prio3_histogram(10, 3), lambda: instances.prio3_histogram(10, 3), False),
        ("sumvec", lambda: jax_instances.prio3_sum_vec(10, 1, 3), lambda: instances.prio3_sum_vec(10, 1, 3), True),
    ],
)
def test_planar_combine_matches_row_combine(name, jctor, ctor, vector):
    """keep_planar + prep_shares_to_prep_planar decide and seed equal the
    row-major prep_shares_to_prep and the oracle, for each aggregator's
    view, with a tampered report rejected."""
    jvdaf, bp = jctor(), BatchedPrio3(ctor(), device="cpu")
    reports = _sharded(jvdaf, 4, seed=3, vector=vector)
    vk = bytes(range(32, 48))
    rows = [bp.prep_init_planar(a, vk, **_inputs(bp, reports, a)) for a in (0, 1)]
    planar = [bp.prep_init_planar(a, vk, keep_planar=True, **_inputs(bp, reports, a)) for a in (0, 1)]
    assert "verifiers" not in planar[0] and planar[0]["wire_ev_pl"].shape == (3, N, 4)
    parts = [r["joint_rand_part"] for r in rows]
    want = bp.prep_shares_to_prep([r["verifiers"] for r in rows], parts)
    for a in (0, 1):
        got = bp.prep_shares_to_prep_planar(planar[a], rows[1 - a]["verifiers"], parts)
        assert torch.equal(got["decide"], want["decide"])
        assert torch.equal(got["prep_msg_seed"], want["prep_msg_seed"])
    assert want["decide"].tolist() == [True, False, True, True]
    for b in (0, 2, 3):
        _, nonce, public, shares = reports[b]
        pss = [jvdaf.prep_init(vk, a, nonce, public, shares[a])[1] for a in (0, 1)]
        assert want["prep_msg_seed"][b].numpy().tobytes() == jvdaf.prep_shares_to_prep(pss)
