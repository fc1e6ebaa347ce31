"""More than one proof, and the HMAC-SHA256-AES128 multiproof SumVec, on the
CPU against the JAX package.

The port's ``XofHmacSha256Aes128`` against the JAX package's; the
``HybridXofBackend`` (host XOF, FLP query and decide through
``BatchedPrio3``) against the JAX oracle backend and the golden transcript;
TurboSHAKE Prio3 with 2 and 3 proofs on the row path against the JAX
oracle.  Reports are sharded by the JAX package's oracle from numpy seeds.
The HMAC cases stay at lengths of 4 or less: here AES runs in numpy.  Every
comparison is exact (tolerance 0)."""

import json
import os

import numpy as np
import pytest

from janus_tpu import xof as jax_xof
from janus_tpu.fields import Field64 as JaxField64
from janus_tpu.fields import Field128 as JaxField128
from janus_tpu.flp import Count as JaxCount
from janus_tpu.flp import FlpGeneric as JaxFlpGeneric
from janus_tpu.flp import Sum as JaxSum
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu.vdaf.prio3 import ALG_PRIO3_COUNT as JAX_ALG_COUNT
from janus_tpu.vdaf.prio3 import ALG_PRIO3_SUM as JAX_ALG_SUM
from janus_tpu.vdaf.prio3 import Prio3 as JaxPrio3
from janus_tpu.vdaf.prio3 import Prio3InputShare as JaxInputShare
from janus_tpu.vdaf.prio3 import VdafError as JaxVdafError
from janus_tpu_torch import xof
from janus_tpu_torch.fields import Field64, Field128
from janus_tpu_torch.flp import Count, FlpGeneric, Sum
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend, HybridXofBackend, make_backend
from janus_tpu_torch.vdaf.prio3 import ALG_PRIO3_COUNT, ALG_PRIO3_SUM, Prio3, VdafError

VK32 = bytes(range(100, 132))


@pytest.mark.parametrize(
    "seed,dst,binder,length",
    [
        (bytes(32), b"", b"", 0),
        (bytes(range(32)), b"dst", b"binder", 16),
        (bytes(range(1, 33)), bytes(range(255)), b"\x01" * 300, 100),
        (b"\xff" * 32, b"\x00", bytes(7), 4097),
    ],
    ids=["empty", "short", "long-dst", "many-blocks"],
)
def test_hmac_xof_matches_jax(seed, dst, binder, length):
    """The stream and its Field64/Field128 vectors equal the JAX
    package's, byte for byte."""
    assert xof.XofHmacSha256Aes128.SEED_SIZE == jax_xof.XofHmacSha256Aes128.SEED_SIZE == 32
    got = xof.XofHmacSha256Aes128(seed, dst, binder).next(length)
    assert got == jax_xof.XofHmacSha256Aes128(seed, dst, binder).next(length)
    assert len(got) == length
    for field, jfield in ((Field64, JaxField64), (Field128, JaxField128)):
        assert xof.XofHmacSha256Aes128.expand_into_vec(field, seed, dst, binder, 9) == (
            jax_xof.XofHmacSha256Aes128.expand_into_vec(jfield, seed, dst, binder, 9)
        )
    with pytest.raises(ValueError):
        xof.XofHmacSha256Aes128(bytes(16), dst, binder)


def shard(jvdaf, measure, count, seed, tamper=()):
    """(nonce, public share, input shares) per report; rows in ``tamper``
    get a perturbed leader measurement share.  Returns (reports,
    measurements)."""
    rng = np.random.default_rng(seed)
    out, meas = [], []
    for i in range(count):
        meas.append(measure(rng))
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(meas[-1], nonce, rng.bytes(jvdaf.RAND_SIZE))
        if i in tamper:
            lead = shares[0]
            bad = list(lead.meas_share)
            bad[0] = (bad[0] + 1) % jvdaf.flp.field.MODULUS
            shares = [JaxInputShare(bad, lead.proofs_share, None, lead.joint_rand_blind)] + list(shares[1:])
        out.append((nonce, public, shares))
    return out, meas


def served_matches_jax_oracle(backend, jvdaf, rows, vk, rejected):
    """Both sides through ``backend`` against the JAX oracle backend, row
    for row, then the combine: decisions and seeds equal, ``rejected`` rows
    refused.  Returns the prepare outcomes by side."""
    oracle = JaxOracleBackend(jvdaf)
    got = {}
    for agg_id in (0, 1):
        side = [(nonce, public, shares[agg_id]) for nonce, public, shares in rows]
        got[agg_id] = backend.prep_init_batch(vk, agg_id, side)
        want = oracle.prep_init_batch(vk, agg_id, side)
        for b, ((gs, gp), (ws, wp)) in enumerate(zip(got[agg_id], want)):
            assert gs.out_share == ws.out_share, (agg_id, b)
            assert gp.verifiers_share == wp.verifiers_share, (agg_id, b)
            assert gp.joint_rand_part == wp.joint_rand_part, (agg_id, b)
            assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed, (agg_id, b)
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(len(rows))]
    msgs = backend.prep_shares_to_prep_batch(pairs)
    want = oracle.prep_shares_to_prep_batch(pairs)
    assert [m if isinstance(m, bytes) else None for m in msgs] == [m if isinstance(m, bytes) else None for m in want]
    assert [isinstance(m, VdafError) for m in msgs] == [isinstance(m, JaxVdafError) for m in want]
    assert [b for b, m in enumerate(msgs) if isinstance(m, VdafError)] == list(rejected)
    assert backend.oracle_recompute_rows == 0
    return got


@pytest.mark.parametrize("proofs", [2, 3])
def test_hybrid_matches_jax_oracle(proofs):
    """The multiproof SumVec(4, 1, 2) over Field64 at 2 and 3 proofs:
    ``make_backend`` gives ``HybridXofBackend`` (its FLP tensors on the CPU
    here), whose rows, decisions and aggregate equal the JAX oracle's; row
    1 is tampered and rejected; the leader's shares that arrived as bytes
    are marshalled from them."""
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    vdaf = instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(proofs, 4, 1, 2)
    jvdaf = jax_instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(proofs, 4, 1, 2)
    backend = make_backend(vdaf, device="cpu")
    assert isinstance(backend, HybridXofBackend) and backend.bp.device.type == "cpu"
    assert not hasattr(backend, "stage_prep_init_multi")
    assert not getattr(backend, "supports_resident_out_shares", False)
    measure = lambda rng: [int(x) for x in rng.integers(0, 2, 4)]  # noqa: E731
    rows, meas = shard(jvdaf, measure, 5, seed=proofs, tamper={1})
    # the leader's shares as an upload delivers them: decoded from bytes
    rows = [(n, p, [Prio3InputShare.decode(vdaf, 0, s[0].encode(jvdaf)), s[1]]) for n, p, s in rows]
    got = served_matches_jax_oracle(backend, jvdaf, rows, VK32, rejected=[1])
    assert backend.leader_marshal_rows == {"bytes": 5, "values": 0}
    assert set(backend.host_seconds) == {"xof", "from_limbs", "device"}
    accepted = [0, 2, 3, 4]
    aggs = [vdaf.aggregate([got[a][b][0].out_share for b in accepted]) for a in (0, 1)]
    assert vdaf.unshard(aggs, 4) == [sum(meas[b][i] for b in accepted) for i in range(4)]


def test_hybrid_rejects_a_root_of_unity_row_through_the_oracle(monkeypatch):
    """A row whose device ``ok`` is False (a query point on a root of
    unity, here forced) is recomputed by the oracle and counted."""
    vdaf = instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 3, 1, 2)
    jvdaf = jax_instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 3, 1, 2)
    backend = HybridXofBackend(vdaf, device="cpu")
    real = backend.bp.query_batch

    def first_row_not_ok(*args):
        out = real(*args)
        out["ok"][0] = False
        return out

    monkeypatch.setattr(backend.bp, "query_batch", first_row_not_ok)
    rows, _ = shard(jvdaf, lambda rng: [1, 0, 1], 2, seed=4)
    side = [(n, p, s[1]) for n, p, s in rows]
    got = backend.prep_init_batch(VK32, 1, side)
    want = JaxOracleBackend(jvdaf).prep_init_batch(VK32, 1, side)
    assert [p.verifiers_share for _, p in got] == [p.verifiers_share for _, p in want]
    assert backend.oracle_recompute_rows == 1 and backend.oracle.rows["init"] == 1


def test_golden_multiproof_transcript_replays():
    """The multiproof entry of ``tests/data/golden-vdaf-vectors.json``
    through the port's oracle (every ping-pong artifact) and through
    ``HybridXofBackend`` (both prepare shares, the prep message and the out
    shares)."""
    from gen_golden_vectors import det_bytes
    from janus_tpu_torch.vdaf import pingpong as pp
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    with open(os.path.join(os.path.dirname(__file__), "data", "golden-vdaf-vectors.json")) as fh:
        vector = next(v for v in json.load(fh) if v["vdaf"]["type"] == "Prio3SumVecField64MultiproofHmacSha256Aes128")
    vdaf = vdaf_from_instance(vector["vdaf"])
    vk = bytes.fromhex(vector["verify_key"])
    assert vk == det_bytes("verify_key", vdaf.VERIFY_KEY_SIZE)
    backend = make_backend(vdaf, device="cpu")
    for row in vector["reports"]:
        nonce, rand = bytes.fromhex(row["nonce"]), bytes.fromhex(row["rand"])
        public, shares = vdaf.shard(row["measurement"], nonce, rand)
        assert vdaf.encode_public_share(public).hex() == row["public_share"]
        assert [s.encode(vdaf).hex() for s in shares] == [row["input_share_0"], row["input_share_1"]]
        l_state, l_msg = pp.leader_initialized(vdaf, vk, None, nonce, public, shares[0])
        assert l_msg.encode().hex() == row["leader_init_message"]
        trans = pp.helper_initialized(vdaf, vk, None, nonce, public, shares[1], l_msg)
        assert trans.encode(vdaf).hex() == row["helper_transition"]
        h_state, h_msg = trans.evaluate(vdaf)
        assert h_msg.encode().hex() == row["helper_finish_message"]
        finished = pp.leader_continued(vdaf, l_state, h_msg)
        assert vdaf.field.encode_vec(finished.out_share).hex() == row["out_share_0"]
        assert vdaf.field.encode_vec(h_state.out_share).hex() == row["out_share_1"]

        (lead_state, lead_share), = backend.prep_init_batch(vk, 0, [(nonce, public, shares[0])])
        (help_state, help_share), = backend.prep_init_batch(vk, 1, [(nonce, public, shares[1])])
        init = pp.PingPongMessage(pp.PingPongMessage.INITIALIZE, prep_share=vdaf.ping_pong_encode_prep_share(lead_share))
        assert init.encode().hex() == row["leader_init_message"]
        prep_msg, = backend.prep_shares_to_prep_batch([[lead_share, help_share]])
        assert pp.PingPongTransition(help_state, prep_msg, 0).encode(vdaf).hex() == row["helper_transition"]
        assert vdaf.field.encode_vec(lead_state.out_share).hex() == row["out_share_0"]
        assert vdaf.field.encode_vec(help_state.out_share).hex() == row["out_share_1"]


#: TurboSHAKE Prio3 with more than one proof: (port, JAX, measurement).
MULTIPROOF = {
    "count-2": (
        lambda: Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, num_proofs=2),
        lambda: JaxPrio3(JaxFlpGeneric(JaxCount()), JAX_ALG_COUNT, num_proofs=2),
        lambda rng: int(rng.integers(0, 2)),
    ),
    "sum8-3": (
        lambda: Prio3(FlpGeneric(Sum(8)), ALG_PRIO3_SUM, num_proofs=3),
        lambda: JaxPrio3(JaxFlpGeneric(JaxSum(8)), JAX_ALG_SUM, num_proofs=3),
        lambda rng: int(rng.integers(0, 256)),
    ),
}


@pytest.mark.parametrize("name", sorted(MULTIPROOF))
def test_turboshake_multiproof_row_path_matches_jax_oracle(name):
    """Count at 2 proofs and Sum(8) at 3 through ``CudaBackend``'s row path
    (the XOF of every proof's randomness on the Keccak wrappers), row 2
    tampered, against the JAX oracle."""
    port, jax, measure = MULTIPROOF[name]
    backend = make_backend(port(), device="cpu")
    assert isinstance(backend, CudaBackend)
    assert backend._prep_fn(0, 8).__name__ == backend._prep_fn(1, 8).__name__ == "prep_init"
    rows, _ = shard(jax(), measure, 4, seed=len(name), tamper={2})
    served_matches_jax_oracle(backend, jax(), rows, bytes(16), rejected=[2])


@pytest.mark.slow
def test_hybrid_matches_jax_hybrid():
    """The port's hybrid against the JAX package's ``HybridXofBackend``
    (its FLP under ``jax.jit`` over Field64) on SumVec(3, 1, 2) at 2
    proofs: prepare shares, out shares and decisions equal.  Its XLA
    compiles take about 10 s here."""
    from janus_tpu.vdaf.backend import HybridXofBackend as JaxHybrid

    vdaf = instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 3, 1, 2)
    jvdaf = jax_instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 3, 1, 2)
    port, ref = HybridXofBackend(vdaf, device="cpu"), JaxHybrid(jvdaf)
    rows, _ = shard(jvdaf, lambda rng: [int(x) for x in rng.integers(0, 2, 3)], 3, seed=11, tamper={0})
    got, want = {}, {}
    for agg_id in (0, 1):
        side = [(n, p, s[agg_id]) for n, p, s in rows]
        got[agg_id] = port.prep_init_batch(VK32, agg_id, side)
        want[agg_id] = ref.prep_init_batch(VK32, agg_id, side)
        assert [p.verifiers_share for _, p in got[agg_id]] == [p.verifiers_share for _, p in want[agg_id]]
        assert [s.out_share for s, _ in got[agg_id]] == [s.out_share for s, _ in want[agg_id]]
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(3)]
    msgs, ref_msgs = port.prep_shares_to_prep_batch(pairs), ref.prep_shares_to_prep_batch(pairs)
    assert [m if isinstance(m, bytes) else None for m in msgs] == [m if isinstance(m, bytes) else None for m in ref_msgs]
    assert isinstance(msgs[0], VdafError) and isinstance(ref_msgs[0], JaxVdafError)
