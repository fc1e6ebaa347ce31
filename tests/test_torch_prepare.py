"""The port's batched prepare (janus_tpu_torch.ops.prepare) on the CPU,
against the oracle and the JAX package's BatchedPrio3."""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu_torch import state
from janus_tpu_torch.ops import keccak
from janus_tpu_torch.ops.field import u32_to_tensor, words
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.prio3 import USAGE_JOINT_RAND_PART, Prio3InputShare
from test_torch_small import CIRCUITS, served_pair_matches_jax_oracle

L, C = 10, 3


def _shard(vdaf, count, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m = int(rng.integers(0, vdaf.flp.MEAS_LEN))
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(m, nonce, rng.bytes(vdaf.RAND_SIZE))
        out.append((m, nonce, public, shares))
    return out


def _inputs(bp, reports, agg_id):
    f, flp = bp.f, bp.flp
    B = len(reports)

    def u8(rows, width):
        return torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8).reshape(B, width).copy())

    kw = dict(
        nonces_u8=u8([r[1] for r in reports], 16),
        blinds_u8=u8([r[3][agg_id].joint_rand_blind for r in reports], 16),
        public_parts_u8=u8([b"".join(r[2]) for r in reports], 32).reshape(B, 2, 16),
    )
    if agg_id == 0:
        meas = f.to_limbs([x for r in reports for x in r[3][0].meas_share]).reshape(B, flp.MEAS_LEN, f.n)
        proofs = f.to_limbs([x for r in reports for x in r[3][0].proofs_share]).reshape(B, flp.PROOF_LEN, f.n)
        kw.update(meas_limbs=u32_to_tensor(meas, "cpu"), proofs_limbs=u32_to_tensor(proofs, "cpu"))
    else:
        kw["share_seeds_u8"] = u8([r[3][1].share_seed for r in reports], 16)
    return kw


@pytest.mark.parametrize("length,chunk", [(10, 3), (100, 10), (1024, 316)])
def test_constants_equal_jax(length, chunk):
    port = BatchedPrio3(instances.prio3_histogram(length, chunk), device="cpu")
    jax_bp = JaxBatchedPrio3(jax_instances.prio3_histogram(length, chunk))
    jax_consts = {
        "shares_inv_c": np.asarray(jax_bp.consts["shares_inv_c"]),
        "alpha_pows_m": np.asarray(jax_bp.alpha_pows_m),
        "bary_c_m": np.asarray(jax_bp.bary_c_m),
        "roots_m": np.asarray(jax_bp.roots_m),
        "roots_all_m": np.asarray(jax_bp.roots_all_m),
        "alpha_mat_m": np.asarray(jax_bp._alpha_mat_m()),
        "r2": jax_bp.jf.r2_np,
    }
    assert set(jax_consts) == set(port.consts_np)
    loaded = state.consts_from_numpy(jax_consts)
    for k, v in jax_consts.items():
        np.testing.assert_array_equal(port.consts_np[k], v, err_msg=k)
        assert torch.equal(loaded[k], port.consts[k]), k
    c = port.circ
    assert (c.calls, c.arity, c.P, c.glen) == (jax_bp.circ.calls, jax_bp.circ.arity, jax_bp.circ.P, jax_bp.circ.glen)


@pytest.mark.parametrize("agg_id", [0, 1])
def test_prep_init_planar_matches_oracle(agg_id):
    vdaf = instances.prio3_histogram(L, C)
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = _shard(vdaf, 5, seed=agg_id)
    vk = bytes(range(16))
    out = bp.prep_init_planar(agg_id, vk, **_inputs(bp, reports, agg_id))
    assert bool(out["ok"].all())
    f = bp.f
    for b, (_, nonce, public, shares) in enumerate(reports):
        st, ps = vdaf.prep_init(vk, agg_id, nonce, public, shares[agg_id])
        assert f.from_limbs(out["verifiers"][b].numpy().astype(np.uint32)) == ps.verifiers_share
        assert f.from_limbs(out["out_share"][b].numpy().view(np.uint32)) == st.out_share
        assert out["joint_rand_part"][b].numpy().tobytes() == ps.joint_rand_part
        assert out["corrected_seed"][b].numpy().tobytes() == st.corrected_joint_rand_seed


def test_jr_part_message_is_the_padded_oracle_message():
    """The funnel-shifted in-plane message equals the byte-level message."""
    vdaf = instances.prio3_histogram(L, C)
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = _shard(vdaf, 3, seed=5)
    kw = _inputs(bp, reports, 0)
    meas_st = kw["meas_limbs"].reshape(3, -1).transpose(0, 1).contiguous()
    msg = bp._jr_part_message(0, kw["blinds_u8"], kw["nonces_u8"], meas_st)
    dst = vdaf._dst(USAGE_JOINT_RAND_PART)
    for b, (_, nonce, _, shares) in enumerate(reports):
        raw = bytes([len(dst)]) + dst + shares[0].joint_rand_blind + b"\x00" + nonce
        raw += vdaf.flp.field.encode_vec(shares[0].meas_share)
        padded = keccak.pad_message(torch.from_numpy(np.frombuffer(raw, np.uint8).copy()), 0x01)
        assert keccak.words_to_bytes(words(msg[:, b])).numpy().tobytes() == padded.numpy().tobytes()


def test_combine_decides_like_oracle():
    vdaf = instances.prio3_histogram(L, C)
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = _shard(vdaf, 4, seed=7)
    # Tamper the leader's share of report 1: its proof no longer verifies.
    m, nonce, public, shares = reports[1]
    bad = list(shares[0].meas_share)
    bad[0] = (bad[0] + 1) % vdaf.flp.field.MODULUS
    reports[1] = (m, nonce, public, [Prio3InputShare(bad, shares[0].proofs_share, None, shares[0].joint_rand_blind), shares[1]])
    vk = bytes(16)
    outs = [bp.prep_init_planar(a, vk, **_inputs(bp, reports, a)) for a in (0, 1)]
    res = bp.prep_shares_to_prep([o["verifiers"] for o in outs], [o["joint_rand_part"] for o in outs])
    for b, (_, nonce, public, shares) in enumerate(reports):
        pss = [vdaf.prep_init(vk, a, nonce, public, shares[a])[1] for a in (0, 1)]
        try:
            want = vdaf.prep_shares_to_prep(pss)
        except Exception:
            want = None
        assert bool(res["decide"][b]) == (want is not None), b
        if want is not None:
            assert res["prep_msg_seed"][b].numpy().tobytes() == want
    assert not bool(res["decide"][1])


def test_aggregate_is_the_masked_field_sum():
    vdaf = instances.prio3_histogram(L, C)
    bp = BatchedPrio3(vdaf, device="cpu")
    p = vdaf.flp.field.MODULUS
    rng = np.random.default_rng(2)
    for B in (5, 40):  # add tree and lazy u16-half sum
        rows = [[int.from_bytes(rng.bytes(16), "little") % p for _ in range(L)] for _ in range(B)]
        mask = rng.integers(0, 2, B).astype(bool)
        limbs = bp.f.to_limbs([x for r in rows for x in r]).reshape(B, L, 4)
        got = bp.f.from_limbs(bp.aggregate(u32_to_tensor(limbs, "cpu"), torch.from_numpy(mask)).numpy().astype(np.uint32))
        assert got == [sum(r[i] for r, k in zip(rows, mask) if k) % p for i in range(L)]


@pytest.mark.parametrize("name", ["count", "sum8", "sumvec423"], ids=["count", "sum", "sumvec"])
def test_other_circuits_raise(name):
    """Count, Sum(8) and SumVec(4, 2, 3), which the planar path of the
    chunked circuits cannot take, served as leader/helper pairs through
    CudaBackend on the CPU (the row path) against the JAX package's oracle
    backend."""
    port_ctor, jax_ctor, measure = CIRCUITS[name]
    served_pair_matches_jax_oracle(port_ctor(), jax_ctor(), measure, seed=len(name))


def test_planar_layout_adapters_round_trip():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2**32, size=(2, 4, 7, 128), dtype=np.uint64).astype(np.uint32)
    port = state.from_jax_planar(x)
    assert port.shape == (7, 4, 256)
    np.testing.assert_array_equal(port[3, 2, 128 + 5], x[1, 2, 3, 5])
    np.testing.assert_array_equal(state.to_jax_planar(port), x)


@pytest.mark.slow
@pytest.mark.parametrize("agg_id", [0, 1])
def test_prep_init_matches_jax_row_path(agg_id):
    """The JAX package's row-major BatchedPrio3.prep_init (XLA compile of
    about a minute) against the port, same numpy-seeded reports."""
    vdaf = instances.prio3_histogram(L, C)
    jvdaf = jax_instances.prio3_histogram(L, C)
    bp = BatchedPrio3(vdaf, device="cpu")
    reports = _shard(vdaf, 8, seed=11)
    vk = bytes(range(16, 32))
    kw = _inputs(bp, reports, agg_id)
    port = bp.prep_init_planar(agg_id, vk, **kw)
    with mock.patch.dict(os.environ, {"JANUS_TPU_PALLAS": "off"}):
        jbp = JaxBatchedPrio3(jvdaf)
        jkw = {k: v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy() for k, v in kw.items()}
        jout = jbp.prep_init(agg_id, verify_key=np.frombuffer(vk, np.uint8), **jkw)
    np.testing.assert_array_equal(port["verifiers"].numpy().astype(np.uint32), np.asarray(jout["verifiers"]))
    np.testing.assert_array_equal(port["out_share"].numpy().view(np.uint32), np.asarray(jout["out_share"]))
    np.testing.assert_array_equal(port["joint_rand_part"].numpy(), np.asarray(jout["joint_rand_part"]))
    np.testing.assert_array_equal(port["corrected_seed"].numpy(), np.asarray(jout["corrected_seed"]))
    np.testing.assert_array_equal(port["ok"].numpy(), np.asarray(jout["ok"]))
