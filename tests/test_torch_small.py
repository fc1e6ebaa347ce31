"""The port's row-major prepare of Prio3Count, Prio3Sum and SumVec with
bits > 1, and the FLP query/decide halves, on the CPU against the JAX
package's BatchedPrio3 and oracle.

Reports are sharded by the JAX package's oracle from numpy seeds; both
packages read the same share objects' fields.  Every comparison is exact
(tolerance 0: integer arithmetic mod p)."""

import jax
import numpy as np
import pytest
import torch

from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu_torch.ops.field import tensor_to_u32, u32_to_tensor, words
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend

VK = bytes(range(32, 48))

#: (port constructor, JAX constructor, measurement from a numpy generator)
CIRCUITS = {
    "count": (instances.prio3_count, jax_instances.prio3_count, lambda rng: int(rng.integers(0, 2))),
    "sum8": (lambda: instances.prio3_sum(8), lambda: jax_instances.prio3_sum(8), lambda rng: int(rng.integers(0, 256))),
    "sumvec423": (
        lambda: instances.prio3_sum_vec(4, 2, 3),
        lambda: jax_instances.prio3_sum_vec(4, 2, 3),
        lambda rng: [int(x) for x in rng.integers(0, 4, 4)],
    ),
    "sumvec723": (
        lambda: instances.prio3_sum_vec(7, 2, 3),
        lambda: jax_instances.prio3_sum_vec(7, 2, 3),
        lambda rng: [int(x) for x in rng.integers(0, 4, 7)],
    ),
}


def shard(jvdaf, measure, count, seed, tamper=()):
    """(measurement, nonce, public share, input shares) per report; rows in
    ``tamper`` get a perturbed leader measurement share."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        m = measure(rng)
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


def staged_inputs(vdaf, reports, agg_id):
    """The backend's marshalled tensors of one side, padded to the
    power-of-two bucket, as (verify key, nonces, keyword arguments)."""
    backend = CudaBackend(vdaf, device="cpu")
    rows = [(nonce, public, shares[agg_id]) for _, nonce, public, shares in reports]
    kw = dict(backend.stage_prep_init_multi(agg_id, [(VK, rows)]).placed)
    return kw.pop("verify_key_u8"), kw.pop("nonces_u8"), kw


def assert_rows_equal_oracle(jvdaf, bp, out, reports, agg_id):
    """Every row of a port prepare against the JAX oracle's prep_init."""
    f = bp.f
    assert bool(out["ok"].all())
    for b, (_, nonce, public, shares) in enumerate(reports):
        st, ps = jvdaf.prep_init(VK, agg_id, nonce, public, shares[agg_id])
        assert f.from_limbs(tensor_to_u32(out["verifiers"][b])) == ps.verifiers_share, b
        assert f.from_limbs(tensor_to_u32(out["out_share"][b])) == st.out_share, b
        if bp.flp.JOINT_RAND_LEN:
            assert out["joint_rand_part"][b].numpy().tobytes() == ps.joint_rand_part
            assert out["corrected_seed"][b].numpy().tobytes() == st.corrected_joint_rand_seed
        else:
            assert "joint_rand_part" not in out and "corrected_seed" not in out


def against_jax_row_path(name, agg_id, B=8):
    """The port's prepare at B (the row path) against the JAX package's
    row-major BatchedPrio3.prep_init under jax.jit."""
    port_ctor, jax_ctor, measure = CIRCUITS[name]
    vdaf = port_ctor()
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = shard(jax_ctor(), measure, B, seed=B + agg_id)
    vk, nonces, kw = staged_inputs(vdaf, reports, agg_id)
    jkw = {k: v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy() for k, v in kw.items()}
    jbp = JaxBatchedPrio3(jax_ctor())
    jout = jax.jit(lambda v, n, kw: jbp.prep_init(agg_id, verify_key=v, nonces_u8=n, **kw))(vk.numpy(), nonces.numpy(), jkw)
    assert bp.prep_route(agg_id, B) == "prep_init"
    out = bp.prep_init(agg_id, vk, nonces, **kw)
    assert set(out) == set(jout)
    for k, want in jout.items():
        got = out[k].numpy()
        if got.dtype in (np.int32, np.int64):
            got = tensor_to_u32(out[k])
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)


@pytest.mark.parametrize("agg_id", [0, 1])
def test_count_matches_jax_row_path(agg_id):
    """Prio3Count (Field64) on the row path at B = 8."""
    against_jax_row_path("count", agg_id)


@pytest.mark.slow
@pytest.mark.parametrize("agg_id", [0, 1])
@pytest.mark.parametrize("name", ["sum8", "sumvec423"])
def test_matches_jax_row_path(name, agg_id):
    """Sum(8) and SumVec(4, 2, 3); the JAX row path compiles for tens of
    seconds a side on XLA:CPU."""
    against_jax_row_path(name, agg_id)


@pytest.mark.parametrize("agg_id", [0, 1])
@pytest.mark.parametrize("name", ["sum8", "sumvec423", "sumvec723"])
def test_prepares_match_jax_oracle(name, agg_id):
    """Sum(8), SumVec(4, 2, 3) and SumVec(7, 2, 3) (a zero-padded last
    call) on the row path, per row against the JAX package's oracle
    Prio3.prep_init."""
    port_ctor, jax_ctor, measure = CIRCUITS[name]
    vdaf, jvdaf = port_ctor(), jax_ctor()
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = shard(jvdaf, measure, 5, seed=20 + agg_id)
    vk, nonces, kw = staged_inputs(vdaf, reports, agg_id)
    assert bp.prep_route(agg_id, nonces.shape[0]) == "prep_init"
    assert_rows_equal_oracle(jvdaf, bp, bp.prep_init(agg_id, vk, nonces, **kw), reports, agg_id)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_query_and_decide_batch_match_oracle(name):
    """query_batch and decide_batch, the XOF-free halves, against the
    oracle's FlpGeneric.query and decide on the same shares and
    randomness; row 1 of each batch holds a perturbed measurement share."""
    port_ctor, jax_ctor, measure = CIRCUITS[name]
    vdaf, jvdaf = port_ctor(), jax_ctor()
    bp = BatchedPrio3(vdaf, device="cpu")
    flp, f = jvdaf.flp, bp.f
    p = flp.field.MODULUS
    rng = np.random.default_rng(len(name))
    B, S = 4, jvdaf.num_shares
    rand = lambda count: [int.from_bytes(rng.bytes(16), "little") % p for _ in range(count)]  # noqa: E731
    qr, jr = rand(B * flp.QUERY_RAND_LEN), rand(B * flp.JOINT_RAND_LEN)
    meas, proofs = [], []
    for b in range(B):
        m = flp.encode(measure(rng))
        proof = flp.prove(m, rand(flp.PROVE_RAND_LEN), jr[b * flp.JOINT_RAND_LEN : (b + 1) * flp.JOINT_RAND_LEN])
        if b == 1:
            m = [(m[0] + 1) % p] + m[1:]
        # additive shares: a random first share, the rest in the second
        ms, ps = rand(len(m)), rand(len(proof))
        meas.append([ms, [(x - y) % p for x, y in zip(m, ms)]])
        proofs.append([ps, [(x - y) % p for x, y in zip(proof, ps)]])

    def limbs(rows, width):
        return words(u32_to_tensor(f.to_limbs([x for r in rows for x in r]).reshape(B, width, f.n), "cpu"))

    verifiers = []
    for a in range(S):
        out = bp.query_batch(
            limbs([m[a] for m in meas], flp.MEAS_LEN), limbs([pr[a] for pr in proofs], flp.PROOF_LEN),
            limbs([jr[b * flp.JOINT_RAND_LEN : (b + 1) * flp.JOINT_RAND_LEN] for b in range(B)], flp.JOINT_RAND_LEN)
            if flp.JOINT_RAND_LEN else None,
            limbs([qr[b * flp.QUERY_RAND_LEN : (b + 1) * flp.QUERY_RAND_LEN] for b in range(B)], flp.QUERY_RAND_LEN),
        )
        assert bool(out["ok"].all())
        verifiers.append(out["verifiers"])
        for b in range(B):
            want = flp.query(
                meas[b][a], proofs[b][a], qr[b * flp.QUERY_RAND_LEN : (b + 1) * flp.QUERY_RAND_LEN],
                jr[b * flp.JOINT_RAND_LEN : (b + 1) * flp.JOINT_RAND_LEN], S,
            )
            assert f.from_limbs(tensor_to_u32(out["verifiers"][b])) == want, (a, b)
            assert f.from_limbs(tensor_to_u32(out["out_share"][b])) == flp.truncate(meas[b][a])
    combined = f.add(verifiers[0], verifiers[1])
    want = [flp.decide(f.from_limbs(tensor_to_u32(combined[b]))) for b in range(B)]
    assert bp.decide_batch(combined).tolist() == want
    assert want[1] is False and all(want[b] for b in (0, 2, 3))


@pytest.mark.parametrize(
    "port_ctor,jax_ctor",
    [
        (instances.prio3_count, jax_instances.prio3_count),
        (lambda: instances.prio3_sum(8), lambda: jax_instances.prio3_sum(8)),
        (lambda: instances.prio3_sum(32), lambda: jax_instances.prio3_sum(32)),
        (lambda: instances.prio3_sum_vec(4, 2, 3), lambda: jax_instances.prio3_sum_vec(4, 2, 3)),
    ],
    ids=["count", "sum8", "sum32", "sumvec423"],
)
def test_constants_equal_jax(port_ctor, jax_ctor):
    """The carried-across constants, pow2_m (the Montgomery bit weights 2^b)
    among them, and the circuit's shape, against the JAX package's."""
    port = BatchedPrio3(port_ctor(), device="cpu")
    jbp = JaxBatchedPrio3(jax_ctor())
    want = {
        "shares_inv_c": jbp.consts["shares_inv_c"],
        "alpha_pows_m": jbp.alpha_pows_m,
        "bary_c_m": jbp.bary_c_m,
        "roots_m": jbp.roots_m,
        "roots_all_m": jbp.roots_all_m,
        "r2": jbp.jf.r2_np,
    }
    if "alpha_mat_m" in port.consts_np:
        want["alpha_mat_m"] = jbp._alpha_mat_m()
    if "pow2_m" in port.consts_np:
        want["pow2_m"] = jbp.consts["pow2_m"]
    assert set(want) == set(port.consts_np)
    assert ("pow2_m" in want) == ("pow2_m" in jbp.consts)
    for k, v in want.items():
        np.testing.assert_array_equal(port.consts_np[k], np.asarray(v), err_msg=k)
    c, jc = port.circ, jbp.circ
    assert (c.calls, c.arity, c.P, c.glen) == (jc.calls, jc.arity, jc.P, jc.glen)
    assert (port.gadgets[0]["ntt"] is None) == (jbp._ntt is None)


def served_pair_matches_jax_oracle(vdaf, jvdaf, measure, count=5, seed=0, tamper=(1,)):
    """Leader and helper served through CudaBackend(device="cpu"),
    combined and aggregated, against the JAX package's OracleBackend; the
    ``tamper`` rows carry a perturbed leader share and must be rejected by
    both."""
    from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
    from janus_tpu.vdaf.prio3 import VdafError as JaxVdafError
    from janus_tpu_torch.vdaf.prio3 import VdafError

    backend = CudaBackend(vdaf, device="cpu")
    oracle = JaxOracleBackend(jvdaf)
    reports = shard(jvdaf, measure, count, seed=seed, tamper=tamper)
    got = {}
    for agg_id in (0, 1):
        rows = [(nonce, public, shares[agg_id]) for _, nonce, public, shares in reports]
        got[agg_id] = backend.prep_init_batch(VK, agg_id, rows)
        for (gs, gp), (ws, wp) in zip(got[agg_id], oracle.prep_init_batch(VK, agg_id, rows)):
            assert gp.verifiers_share == wp.verifiers_share
            assert gp.joint_rand_part == wp.joint_rand_part
            assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed
            assert gs.out_share == ws.out_share
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(count)]
    msgs = backend.prep_shares_to_prep_batch(pairs)
    want = oracle.prep_shares_to_prep_batch(pairs)
    mask = np.array([b not in tamper for b in range(count)])
    assert [isinstance(m, VdafError) for m in msgs] == list(~mask)
    assert [isinstance(m, JaxVdafError) for m in want] == list(~mask)
    assert [m for b, m in enumerate(msgs) if mask[b]] == [m for b, m in enumerate(want) if mask[b]]
    f = backend.bp.f
    aggs = [
        backend.aggregate_batch(
            f.to_limbs([x for st, _ in got[a] for x in st.out_share]).reshape(count, vdaf.flp.OUTPUT_LEN, f.n), mask
        )
        for a in (0, 1)
    ]
    valid = [r[0] for b, r in enumerate(reports) if mask[b]]
    expected = np.sum(valid, axis=0).tolist() if isinstance(valid[0], list) else sum(valid)
    assert jvdaf.unshard(aggs, len(valid)) == expected
    assert backend.oracle_recompute_rows == 0
