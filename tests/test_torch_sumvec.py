"""The port's Prio3SumVec prepare (janus_tpu_torch.ops.prepare) on the CPU,
against the JAX package's oracle and constants."""

import numpy as np
import pytest

from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu_torch.ops.field import u32_to_tensor, words
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import instances
from test_torch_prepare import _inputs
from test_torch_small import served_pair_matches_jax_oracle

VK = bytes(range(64, 80))


def _shard(jvdaf, count, seed, tamper=()):
    """Reports of random bit vectors, sharded by the JAX package's oracle;
    rows in ``tamper`` get a perturbed leader measurement share."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        m = [int(x) for x in rng.integers(0, 2, jvdaf.flp.valid.length)]
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(m, nonce, rng.bytes(jvdaf.RAND_SIZE))
        shares = list(shares)
        if i in tamper:
            lead = shares[0]
            bad = list(lead.meas_share)
            bad[0] = (bad[0] + 1) % jvdaf.flp.field.MODULUS
            shares[0] = type(lead)(bad, lead.proofs_share, None, lead.joint_rand_blind)
        out.append((m, nonce, public, shares))
    return out


@pytest.mark.parametrize(
    "length,chunk,ntt",
    [(40, 4, False), (10, 3, False), (200, 4, True)],
    ids=["40x4-horner", "10x3-horner", "200x4-ntt"],
)
@pytest.mark.parametrize("agg_id", [0, 1])
def test_prep_init_planar_matches_jax_oracle(length, chunk, ntt, agg_id):
    """(200, 4) has 50 calls, so P = 64 and the gadget outputs take the NTT."""
    jvdaf = jax_instances.prio3_sum_vec(length, 1, chunk)
    bp = BatchedPrio3(instances.prio3_sum_vec(length, 1, chunk), device="cpu")
    assert (bp.gadgets[0]["ntt"] is not None) == ntt
    reports = _shard(jvdaf, 4, seed=length + agg_id)
    out = bp.prep_init_planar(agg_id, VK, **_inputs(bp, reports, agg_id))
    assert bool(out["ok"].all())
    f = bp.f
    for b, (_, nonce, public, shares) in enumerate(reports):
        st, ps = jvdaf.prep_init(VK, agg_id, nonce, public, shares[agg_id])
        assert f.from_limbs(out["verifiers"][b].numpy().astype(np.uint32)) == ps.verifiers_share
        assert f.from_limbs(out["out_share"][b].numpy().view(np.uint32)) == st.out_share
        assert out["joint_rand_part"][b].numpy().tobytes() == ps.joint_rand_part
        assert out["corrected_seed"][b].numpy().tobytes() == st.corrected_joint_rand_seed


def test_tampered_row_fails_prep_shares_to_prep():
    jvdaf = jax_instances.prio3_sum_vec(10, 1, 3)
    bp = BatchedPrio3(instances.prio3_sum_vec(10, 1, 3), device="cpu")
    reports = _shard(jvdaf, 3, seed=9, tamper={2})
    outs = [bp.prep_init_planar(a, VK, **_inputs(bp, reports, a)) for a in (0, 1)]
    res = bp.prep_shares_to_prep([o["verifiers"] for o in outs], [o["joint_rand_part"] for o in outs])
    assert res["decide"].tolist() == [True, True, False]
    for b in (0, 1):
        _, nonce, public, shares = reports[b]
        pss = [jvdaf.prep_init(VK, a, nonce, public, shares[a])[1] for a in (0, 1)]
        assert res["prep_msg_seed"][b].numpy().tobytes() == jvdaf.prep_shares_to_prep(pss)


def test_constants_equal_jax():
    """The NTT tables and the circuit shape, against the JAX package's BatchedPrio3."""
    jbp = JaxBatchedPrio3(jax_instances.prio3_sum_vec(200, 1, 4))
    bp = BatchedPrio3(instances.prio3_sum_vec(200, 1, 4), device="cpu")
    bitrev, stages = jbp._ntt
    np.testing.assert_array_equal(bp.gadgets[0]["ntt"][0].numpy(), bitrev)
    assert len(bp.gadgets[0]["ntt"][1]) == len(stages)
    for got, want in zip(bp.gadgets[0]["ntt"][1], stages):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    c = bp.circ
    assert (c.calls, c.P, c.glen, c.pad_len) == (jbp.circ.calls, jbp.circ.P, jbp.circ.glen, jbp.circ.pad_len)


def test_bits_above_one_raise():
    """SumVec(10, 3, 4), whose out share weighs 3 bits an element, served
    through CudaBackend on the row path (the planar path takes bits == 1
    only) as a leader/helper pair against the JAX package's oracle."""
    vdaf = instances.prio3_sum_vec(10, 3, 4)
    assert BatchedPrio3(vdaf, device="cpu").prep_route(1, 8) == "prep_init"
    served_pair_matches_jax_oracle(
        vdaf, jax_instances.prio3_sum_vec(10, 3, 4), lambda rng: [int(x) for x in rng.integers(0, 8, 10)],
        count=4, seed=3, tamper=(2,),
    )


@pytest.mark.parametrize(
    "length,ntt",
    [(40, False), (7, False), (200, True)],
    ids=["horner", "horner-p4", "bsgs-ntt"],
)
def test_row_helpers_match_oracle_integers(length, ntt):
    """_lagrange_coeffs against the Lagrange basis on the P-th roots,
    _gpoly_at and _gadget_outputs against direct evaluation, on integers.
    (7, 4) pads its last call; (200, 4) has P = 64 and takes the NTT and the
    baby-step/giant-step evaluation."""
    bp = BatchedPrio3(instances.prio3_sum_vec(length, 1, 4), device="cpu")
    assert (bp.gadgets[0]["ntt"] is not None) == ntt
    f, c = bp.f, bp.circ
    p = f.p
    field = bp.flp.field
    w = field.root(c.P)
    rng = np.random.default_rng(length)
    B = 3
    ints = lambda count: [int.from_bytes(rng.bytes(16), "little") % p for _ in range(count)]  # noqa: E731
    t, gp = ints(B), ints(B * c.glen)
    t_m = words(u32_to_tensor(f.to_limbs([f.mont_int(x) for x in t]), "cpu"))
    gpoly = words(u32_to_tensor(f.to_limbs(gp).reshape(B, c.glen, f.n), "cpu"))

    lag, t_ok = bp._lagrange_coeffs(t_m)
    assert t_ok.all()
    got = f.from_limbs(f.from_mont(lag).numpy().astype(np.uint32))
    roots = [pow(w, j, p) for j in range(c.P)]
    for b in range(B):
        for k in range(c.calls + 1):
            num = den = 1
            for j in range(c.P):
                if j != k:
                    num = num * (t[b] - roots[j]) % p
                    den = den * (roots[k] - roots[j]) % p
            assert got[b * (c.calls + 1) + k] == num * pow(den, p - 2, p) % p, (b, k)

    coeffs = [gp[b * c.glen : (b + 1) * c.glen] for b in range(B)]
    horner = lambda cs, x: sum(cj * pow(x, j, p) for j, cj in enumerate(cs)) % p  # noqa: E731
    got = f.from_limbs(bp._gpoly_at(gpoly, t_m).numpy().astype(np.uint32))
    assert got == [horner(coeffs[b], t[b]) for b in range(B)]
    got = f.from_limbs(bp._gadget_outputs(gpoly).numpy().astype(np.uint32))
    assert got == [horner(coeffs[b], pow(w, k, p)) for b in range(B) for k in range(1, c.calls + 1)]
