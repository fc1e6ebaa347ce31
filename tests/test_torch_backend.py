"""The port's CudaBackend on the CPU against janus_tpu.vdaf.backend.OracleBackend.

Reports are sharded by the JAX package's oracle and fed to both backends;
the port backend only reads the share objects' fields, so the same objects
serve both."""

import numpy as np
import pytest

from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu.vdaf.prio3 import Prio3InputShare as JaxInputShare
from janus_tpu.vdaf.prio3 import VdafError as JaxVdafError
from janus_tpu_torch.flp import Count, FixedPointBoundedL2VecSum, FlpGeneric
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend, OracleBackend
from janus_tpu_torch.vdaf.prio3 import ALG_PRIO3_COUNT, ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM, Prio3, VdafError
from janus_tpu_torch.xof import XofTurboShake128
from test_torch_small import served_pair_matches_jax_oracle

L, C = 10, 3
VK = bytes(range(100, 116))


def _reports(count, seed, tamper=()):
    jvdaf = jax_instances.prio3_histogram(L, C)
    rng = np.random.default_rng(seed)
    meas, leader, helper = [], [], []
    for i in range(count):
        m = int(rng.integers(0, L))
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(m, nonce, rng.bytes(jvdaf.RAND_SIZE))
        lead = shares[0]
        if i in tamper:
            bad = list(lead.meas_share)
            bad[0] = (bad[0] + 1) % jvdaf.flp.field.MODULUS
            lead = JaxInputShare(bad, lead.proofs_share, None, lead.joint_rand_blind)
        meas.append(m)
        leader.append((nonce, public, lead))
        helper.append((nonce, public, shares[1]))
    return jvdaf, meas, leader, helper


@pytest.fixture
def backend():
    return CudaBackend(instances.prio3_histogram(L, C), device="cpu")


def _agg(backend, outcomes, mask):
    f = backend.bp.f
    limbs = f.to_limbs([x for st, _ in outcomes for x in st.out_share]).reshape(len(outcomes), L, f.n)
    return backend.aggregate_batch(limbs, mask)


def test_backend_pair_matches_jax_oracle_backend(backend):
    jvdaf, meas, leader, helper = _reports(6, seed=1)
    oracle = JaxOracleBackend(jvdaf)
    got, want = {}, {}
    for agg_id, rows in ((0, leader), (1, helper)):
        got[agg_id] = backend.prep_init_batch(VK, agg_id, rows)
        want[agg_id] = oracle.prep_init_batch(VK, agg_id, rows)
        for (gs, gp), (ws, wp) in zip(got[agg_id], want[agg_id]):
            assert gp.verifiers_share == wp.verifiers_share
            assert gp.joint_rand_part == wp.joint_rand_part
            assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed
            assert gs.out_share == ws.out_share
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(6)]
    msgs = backend.prep_shares_to_prep_batch(pairs)
    assert msgs == oracle.prep_shares_to_prep_batch(pairs)
    mask = np.ones(6, dtype=bool)
    aggs = [_agg(backend, got[a], mask) for a in (0, 1)]
    assert aggs == [jvdaf.aggregate([st.out_share for st, _ in want[a]]) for a in (0, 1)]
    assert jvdaf.unshard(aggs, 6) == np.bincount(meas, minlength=L).tolist()
    assert backend.outshare_readback_rows == 12 and backend.oracle_recompute_rows == 0


def test_tampered_report_rejected(backend):
    jvdaf, meas, leader, helper = _reports(5, seed=2, tamper={3})
    lead = backend.prep_init_batch(VK, 0, leader)
    help_ = backend.prep_init_batch(VK, 1, helper)
    msgs = backend.prep_shares_to_prep_batch([[lead[b][1], help_[b][1]] for b in range(5)])
    assert isinstance(msgs[3], VdafError)
    assert all(isinstance(m, bytes) for i, m in enumerate(msgs) if i != 3)
    want = JaxOracleBackend(jvdaf).prep_shares_to_prep_batch([[lead[b][1], help_[b][1]] for b in range(5)])
    assert isinstance(want[3], JaxVdafError)
    mask = np.array([not isinstance(m, VdafError) for m in msgs])
    aggs = [_agg(backend, side, mask) for side in (lead, help_)]
    assert jvdaf.unshard(aggs, 4) == np.bincount([m for i, m in enumerate(meas) if i != 3], minlength=L).tolist()


def test_multi_request_launch_slices_per_request(backend):
    _, _, leader, _ = _reports(5, seed=3)
    vk2 = bytes(16)
    multi = backend.prep_init_multi(0, [(VK, leader[:2]), (vk2, leader[2:])])
    assert [len(r) for r in multi] == [2, 3]
    single = backend.prep_init_batch(vk2, 0, leader[2:])
    assert [p.verifiers_share for _, p in multi[1]] == [p.verifiers_share for _, p in single]
    assert backend.prep_init_multi(0, []) == []
    assert backend.prep_init_multi(0, [(VK, [])]) == [[]]


def test_rows_flagged_not_ok_are_recomputed_by_the_oracle(backend, monkeypatch):
    """The rejection-sampling rule: a row the device flags is the oracle's."""
    jvdaf, _, _, helper = _reports(3, seed=4)
    real = backend.bp.prep_init_planar

    def flag_row_one(*args, **kw):
        out = real(*args, **kw)
        out["ok"] = out["ok"].clone()
        out["ok"][1] = False
        out["verifiers"] = out["verifiers"] * 0  # the recompute must not read these
        return out

    monkeypatch.setattr(backend.bp, "prep_init_planar", flag_row_one)
    got = backend.prep_init_batch(VK, 1, helper)
    want = JaxOracleBackend(jvdaf).prep_init_batch(VK, 1, helper)
    assert got[1][1].verifiers_share == want[1][1].verifiers_share
    assert got[1][0].out_share == want[1][0].out_share
    assert backend.oracle_recompute_rows == 1


def test_wrong_share_count_fails_like_the_oracle(backend):
    _, _, leader, helper = _reports(2, seed=5)
    lead = backend.prep_init_batch(VK, 0, leader)
    help_ = backend.prep_init_batch(VK, 1, helper)
    msgs = backend.prep_shares_to_prep_batch([[lead[0][1]], [lead[1][1], help_[1][1]]])
    assert isinstance(msgs[0], VdafError) and isinstance(msgs[1], bytes)
    assert backend.prep_shares_to_prep_batch([]) == []


def test_accumulate_rows_and_read_back(backend):
    import torch

    from janus_tpu_torch.ops.field import u32_to_tensor

    f = backend.bp.f
    p = backend.vdaf.flp.field.MODULUS
    rng = np.random.default_rng(6)
    rows = [[int.from_bytes(rng.bytes(16), "little") % p for _ in range(L)] for _ in range(4)]
    matrix = u32_to_tensor(f.to_limbs([x for r in rows for x in r]).reshape(4, L, f.n), "cpu")
    buf = backend.accumulate_rows(None, matrix, np.array([True, False, True, True]))
    buf = backend.accumulate_rows(buf, matrix, np.array([False, True, False, False]))
    assert isinstance(buf, torch.Tensor)
    assert backend.read_accum_buffer(buf) == [sum(r[i] for r in rows) % p for i in range(L)]


def test_oracle_backends_agree():
    jvdaf, _, leader, _ = _reports(2, seed=7)
    port = OracleBackend(instances.prio3_histogram(L, C)).prep_init_batch(VK, 0, leader)
    ref = JaxOracleBackend(jvdaf).prep_init_batch(VK, 0, leader)
    assert [p.verifiers_share for _, p in port] == [p.verifiers_share for _, p in ref]


class _OtherXof(XofTurboShake128):
    """An XOF that is not TurboSHAKE128 to the backend (a distinct class)."""


@pytest.mark.parametrize(
    "make,error",
    [
        (lambda: Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, num_proofs=2), NotImplementedError),
        (lambda: Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, xof=_OtherXof), VdafError),
        (lambda: Prio3(FlpGeneric(FixedPointBoundedL2VecSum(4, 3)), ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM),
         NotImplementedError),
    ],
    ids=["two-proofs", "other-xof", "fixedpoint"],
)
def test_unported_circuits_raise(make, error):
    """What the CUDA backend still refuses: more than one proof, an XOF
    other than TurboSHAKE128, FixedPointBoundedL2VecSum."""
    with pytest.raises(error):
        CudaBackend(make(), device="cpu")


def test_sumvec_backend_pair_matches_jax_oracle_backend():
    """Prio3SumVec(10, 1, 3) served leader and helper, combined and
    aggregated, against the JAX package's oracle backend; row 2 tampered."""
    served_pair_matches_jax_oracle(
        instances.prio3_sum_vec(10, 1, 3), jax_instances.prio3_sum_vec(10, 1, 3),
        lambda rng: [int(x) for x in rng.integers(0, 2, 10)], count=4, seed=8, tamper=(2,),
    )
