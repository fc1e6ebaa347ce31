"""Prio3FixedPointBoundedL2VecSum on the port's multi-gadget row path, on the
CPU against the JAX package's oracle.

Gadget 0 is the bit check over every MEAS_LEN position (the SumVec pattern),
gadget 1 the squares of the entries recomposed on the card; ``v_multi``
folds the norm identity into the circuit output.  Reports are sharded by the
JAX package's oracle from numpy seeds, with two adversarial kinds beside the
honest ones: a measurement element that is not a bit, and a claimed norm
that disagrees with the entries.  Every comparison is exact (tolerance 0:
integer arithmetic mod p)."""

import numpy as np
import pytest

from janus_tpu.flp import FixedPointBoundedL2VecSum as JaxFixedPoint
from janus_tpu.flp import FlpGeneric as JaxFlpGeneric
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu.vdaf.prio3 import ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM as JAX_ALG
from janus_tpu.vdaf.prio3 import Prio3 as JaxPrio3
from janus_tpu.vdaf.prio3 import VdafError as JaxVdafError
from janus_tpu_torch.flp import FixedPointBoundedL2VecSum, FlpGeneric
from janus_tpu_torch.ops import prepare
from janus_tpu_torch.vdaf.backend import CudaBackend
from janus_tpu_torch.vdaf.prio3 import ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM, Prio3, VdafError

VK = bytes(range(60, 76))


def fpvec(bits, entries, chunk):
    """(port, JAX) instances at any size (the registry takes only the
    reference's BitSize16 and BitSize32)."""
    port = Prio3(FlpGeneric(FixedPointBoundedL2VecSum(bits, entries, chunk)), ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM)
    jax = JaxPrio3(JaxFlpGeneric(JaxFixedPoint(bits, entries, chunk)), JAX_ALG)
    return port, jax


def honest(rng, bits, entries):
    """A vector of ``entries`` fixed-point values with at most two nonzero,
    each +-2^-(n-1): its squared norm, 2 at most in the encoding's units,
    fits the claim's 2n - 2 bits at any n >= 2."""
    m = [0.0] * entries
    step = 1.0 / (1 << (bits - 1))
    for i in rng.choice(entries, min(entries, 2), replace=False):
        m[int(i)] = float(rng.choice([-step, step]))
    return m


def shard_encoded(jvdaf, encoded, rng):
    """A report over a raw encoded measurement (the client lies)."""
    jvdaf.flp.encode = lambda m: list(encoded)  # shadows the method
    try:
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(None, nonce, rng.bytes(jvdaf.RAND_SIZE))
    finally:
        del jvdaf.flp.encode
    return nonce, public, shares


def reports(jvdaf, rng, count):
    """``count`` honest reports, then one whose first element is 2 (not a
    bit) and one whose claimed norm bits are 0 over entries of norm > 0.
    Returns (reports, honest measurements)."""
    valid = jvdaf.flp.valid
    meas = [honest(rng, valid.bits_per_entry, valid.entries) for _ in range(count)]
    out = []
    for m in meas:
        nonce = rng.bytes(16)
        out.append((nonce,) + tuple(jvdaf.shard(m, nonce, rng.bytes(jvdaf.RAND_SIZE))))
    broken = valid.encode(meas[0])
    broken[0] = 2
    out.append(shard_encoded(jvdaf, broken, rng))
    lie = valid.encode([0.5] + [0.0] * (valid.entries - 1))
    lie[valid.entries * valid.bits_per_entry :] = [0] * valid.bits_for_norm
    out.append(shard_encoded(jvdaf, lie, rng))
    return out, meas


#: (bits, entries, chunk, NTT_MIN_P): (2, 2, 2) the smallest (gadget 1 one
#: call, no padding); (3, 5, 3) pads gadget 1's last call (2 * 3 - 5 = 1),
#: Horner on both gadgets, and again with both on the NTT; (2, 40, 2) has
#: 41 bit calls (P = 64: gadget 0 on the NTT at the default bound) and 20
#: square calls (P = 32, Horner).
SIZES = {
    "2x2x2": (2, 2, 2, 64),
    "3x5x3": (3, 5, 3, 64),
    "3x5x3-ntt": (3, 5, 3, 4),
    "2x40x2": (2, 40, 2, 64),
}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_fpvec_backend_matches_jax_oracle(size, monkeypatch):
    """Both sides through ``CudaBackend`` (the row path) against the JAX
    oracle backend, row for row: out share, verifiers, joint-rand part,
    corrected seed; the device combine's decisions and prep-message seeds
    equal the oracle's, the two adversarial rows are rejected and the
    accepted rows' aggregate is the exact sum of the honest vectors."""
    bits, entries, chunk, ntt_min_p = SIZES[size]
    monkeypatch.setattr(prepare, "NTT_MIN_P", ntt_min_p)
    vdaf, jvdaf = fpvec(bits, entries, chunk)
    backend = CudaBackend(vdaf, device="cpu")
    circ = backend.bp.circ
    assert [p.calls for p in circ.plans] == vdaf.flp.valid.GADGET_CALLS
    assert [g["ntt"] is not None for g in backend.bp.gadgets] == [p.P >= ntt_min_p for p in circ.plans]
    assert circ.pad_len1 == circ.plans[1].calls * chunk - entries
    rng = np.random.default_rng(sum(SIZES[size]))
    rows, meas = reports(jvdaf, rng, 3)
    oracle = JaxOracleBackend(jvdaf)
    got = {}
    for agg_id in (0, 1):
        side = [(nonce, public, shares[agg_id]) for nonce, public, shares in rows]
        assert backend._prep_fn(agg_id, backend._pad_to(len(side))).__name__ == "prep_init"
        got[agg_id] = backend.prep_init_batch(VK, agg_id, side)
        want = oracle.prep_init_batch(VK, agg_id, side)
        for b, ((gs, gp), (ws, wp)) in enumerate(zip(got[agg_id], want)):
            assert gs.out_share == ws.out_share, (agg_id, b)
            assert gp.verifiers_share == wp.verifiers_share, (agg_id, b)
            assert gp.joint_rand_part == wp.joint_rand_part, (agg_id, b)
            assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed, (agg_id, b)
    assert backend.oracle_recompute_rows == 0
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(len(rows))]
    msgs = backend.prep_shares_to_prep_batch(pairs)
    want = oracle.prep_shares_to_prep_batch(pairs)
    assert [m if isinstance(m, bytes) else None for m in msgs] == [m if isinstance(m, bytes) else None for m in want]
    assert [isinstance(m, VdafError) for m in msgs] == [isinstance(m, JaxVdafError) for m in want]
    assert [isinstance(m, VdafError) for m in msgs] == [False] * 3 + [True] * 2
    aggs = [vdaf.aggregate([got[a][b][0].out_share for b in range(3)]) for a in (0, 1)]
    assert vdaf.unshard(aggs, 3) == [sum(m[i] for m in meas) for i in range(entries)]


@pytest.mark.parametrize("agg_id", [0, 1])
def test_fpvec_gadget_one_padding_and_truncate(agg_id):
    """``BatchedPrio3.prep_init`` at B = 8 (5 rows padded by repeating the
    last) on (3, 5, 3): the out share is the recomposed entries, the
    verifier is [v, gadget 0's 6 wires and gpoly(t), gadget 1's 6 wires and
    gpoly(t)], every row the oracle's."""
    from janus_tpu_torch.ops.field import tensor_to_u32
    from test_torch_small import VK as STAGED_VK
    from test_torch_small import staged_inputs

    vdaf, jvdaf = fpvec(3, 5, 3)
    rows, _ = reports(jvdaf, np.random.default_rng(9 + agg_id), 3)
    vk, nonces, kw = staged_inputs(vdaf, [(None, n, p, s) for n, p, s in rows], agg_id)
    bp = CudaBackend(vdaf, device="cpu").bp
    out = bp.prep_init(agg_id, vk, nonces, **kw)
    f = bp.f
    assert out["verifiers"].shape == (8, vdaf.flp.VERIFIER_LEN, f.n) == (8, 1 + 7 + 7, f.n)
    assert out["out_share"].shape == (8, 5, f.n)
    for b, (nonce, public, shares) in enumerate(rows):
        st, ps = jvdaf.prep_init(STAGED_VK, agg_id, nonce, public, shares[agg_id])
        assert f.from_limbs(tensor_to_u32(out["verifiers"][b])) == ps.verifiers_share, b
        assert f.from_limbs(tensor_to_u32(out["out_share"][b])) == st.out_share, b


@pytest.mark.slow
@pytest.mark.parametrize("agg_id", [0, 1])
def test_fpvec_matches_jax_row_path(agg_id):
    """The port's row path against the JAX ``BatchedPrio3.prep_init`` under
    ``jax.jit`` on (2, 2, 2): every output tensor equal.  A Field128 graph
    compiles for one to two minutes on XLA:CPU."""
    import jax
    import torch

    from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
    from janus_tpu_torch.ops.field import tensor_to_u32
    from test_torch_small import staged_inputs

    vdaf, jvdaf = fpvec(2, 2, 2)
    rows, _ = reports(jvdaf, np.random.default_rng(12 + agg_id), 6)
    vk, nonces, kw = staged_inputs(vdaf, [(None, n, p, s) for n, p, s in rows], agg_id)
    jkw = {k: v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy() for k, v in kw.items()}
    jbp = JaxBatchedPrio3(jvdaf)
    jout = jax.jit(lambda v, n, kw: jbp.prep_init(agg_id, verify_key=v, nonces_u8=n, **kw))(vk.numpy(), nonces.numpy(), jkw)
    out = CudaBackend(vdaf, device="cpu").bp.prep_init(agg_id, vk, nonces, **kw)
    assert set(out) == set(jout)
    for k, want in jout.items():
        got = out[k].numpy()
        if got.dtype in (np.int32, np.int64):
            got = tensor_to_u32(out[k])
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)
