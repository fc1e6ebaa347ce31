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
        (lambda: Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, num_proofs=2), None),
        (lambda: Prio3(FlpGeneric(Count()), ALG_PRIO3_COUNT, xof=_OtherXof), VdafError),
        (lambda: Prio3(FlpGeneric(FixedPointBoundedL2VecSum(4, 3)), ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM), None),
    ],
    ids=["two-proofs", "other-xof", "fixedpoint"],
)
def test_unported_circuits_raise(make, error):
    """What the CUDA backend refuses: an XOF other than TurboSHAKE128
    (``make_backend`` gives such a VDAF ``HybridXofBackend``).  More than
    one proof and FixedPointBoundedL2VecSum build and take the row path."""
    if error is None:
        backend = CudaBackend(make(), device="cpu")
        assert all(backend._prep_fn(a, 8).__name__ == "prep_init" for a in (0, 1))
    else:
        with pytest.raises(error):
            CudaBackend(make(), device="cpu")


def test_sumvec_backend_pair_matches_jax_oracle_backend():
    """Prio3SumVec(10, 1, 3) served leader and helper, combined and
    aggregated, against the JAX package's oracle backend; row 2 tampered."""
    served_pair_matches_jax_oracle(
        instances.prio3_sum_vec(10, 1, 3), jax_instances.prio3_sum_vec(10, 1, 3),
        lambda rng: [int(x) for x in rng.integers(0, 2, 10)], count=4, seed=8, tamper=(2,),
    )


# -- the executor surface ----------------------------------------------------

SHAPES = {
    "count": (lambda m: m.prio3_count(), lambda r: int(r.integers(0, 2))),
    "sum8": (lambda m: m.prio3_sum(8), lambda r: int(r.integers(0, 256))),
    "sumvec": (lambda m: m.prio3_sum_vec(9, 1, 4), lambda r: [int(x) for x in r.integers(0, 2, 9)]),
    "histogram": (lambda m: m.prio3_histogram(17, 5), lambda r: int(r.integers(0, 17))),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_vdaf_shape_key_equals_the_jax_package(shape):
    from janus_tpu.vdaf.backend import vdaf_shape_key as jax_shape_key
    from janus_tpu_torch.vdaf.backend import vdaf_shape_key

    make, _ = SHAPES[shape]
    assert vdaf_shape_key(make(instances)) == jax_shape_key(make(jax_instances))
    keys = {vdaf_shape_key(m(instances)) for m, _ in SHAPES.values()}
    assert len(keys) == len(SHAPES)


@pytest.mark.parametrize(
    "shape,ok,label",
    [
        ("count", True, "cuda: batched device prepare"),
        ("sum8", True, "cuda: batched device prepare"),
        ("sumvec", True, "cuda: batched device prepare"),
        ("histogram", True, "cuda: batched device prepare"),
        ("fixedpoint", True, "cuda: multi-gadget batched device prepare"),
        ("hmac-multiproof", True, "cuda-hybrid: host XOF + card FLP"),
    ],
)
def test_device_supported_and_path_label(shape, ok, label):
    """Every Prio3 family of the port is served, each with the label of its
    route; FixedPointBoundedL2VecSum on the multi-gadget row path and the
    HMAC multiproof SumVec on the hybrid (host XOF, card FLP)."""
    from janus_tpu_torch.vdaf.backend import device_path_label, device_supported

    if shape == "fixedpoint":
        vdaf = instances.prio3_fixedpoint_bounded_l2_vec_sum("BitSize16", 3)
    elif shape == "hmac-multiproof":
        vdaf = instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 4, 1, 2)
    else:
        vdaf = SHAPES[shape][0](instances)
    assert device_supported(vdaf) == (ok, "")
    assert device_path_label(vdaf).startswith(label)


@pytest.mark.parametrize("shape", ["count", "histogram"])
def test_byte_marshal_equals_the_int_marshal(shape):
    """Leader shares decoded from their bytes (Field64 for Count, Field128
    for Histogram) marshal from the bytes they arrived in; shares built
    from field integers are encoded first; both give the same staged
    arrays, and the leader's limbs equal ``to_limbs`` of the values."""
    make, measure = SHAPES[shape]
    vdaf = make(instances)
    backend = CudaBackend(vdaf, device="cpu")
    rng = np.random.default_rng(len(shape))
    from_ints, from_bytes = [], []
    for _ in range(3):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(measure(rng), nonce, rng.bytes(vdaf.RAND_SIZE))
        decoded = type(shares[0]).decode(vdaf, 0, shares[0].encode(vdaf))
        assert decoded == shares[0] and decoded.encoded_vectors is not None and shares[0].encoded_vectors is None
        from_ints.append((nonce, public, shares[0]))
        from_bytes.append((nonce, public, decoded))
    a = backend._marshal(0, from_ints, 4)
    b = backend._marshal(0, from_bytes, 4)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    f, flp = backend.bp.f, vdaf.flp
    meas = f.to_limbs([x for _, _, s in from_ints for x in s.meas_share]).reshape(3, flp.MEAS_LEN, f.n)
    assert np.array_equal(b["meas_limbs"][:3], meas)


@pytest.mark.parametrize("change", ["replace", "assign", "in_place"])
def test_a_changed_leader_share_marshals_its_new_values(change):
    """A decoded share's bytes cannot go stale: ``dataclasses.replace``
    builds a share without them, assigning a vector drops them, and the
    decoded vectors refuse change in place."""
    import dataclasses

    vdaf = instances.prio3_histogram(L, C)
    backend = CudaBackend(vdaf, device="cpu")
    nonce = bytes(16)
    public, shares = vdaf.shard(3, nonce, bytes(vdaf.RAND_SIZE))
    decoded = type(shares[0]).decode(vdaf, 0, shares[0].encode(vdaf))
    bad = list(decoded.meas_share)
    bad[0] = (bad[0] + 1) % vdaf.flp.field.MODULUS
    if change == "in_place":
        with pytest.raises(TypeError, match="read-only"):
            decoded.meas_share[0] = bad[0]
        with pytest.raises(TypeError, match="read-only"):
            decoded.proofs_share.append(0)
        assert decoded.meas_share != bad and decoded.encoded_vectors is not None
        changed = type(decoded)(bad, decoded.proofs_share, None, decoded.joint_rand_blind)
    elif change == "replace":
        changed = dataclasses.replace(decoded, meas_share=bad)
    else:
        changed = decoded
        changed.meas_share = bad
    assert changed.encoded_vectors is None
    got = backend._marshal(0, [(nonce, public, changed)], 1)["meas_limbs"]
    assert np.array_equal(got[0], backend.bp.f.to_limbs(bad))


def test_launch_fault_opens_the_breaker_and_the_oracle_serves_the_same_bytes():
    """An injected ``backend.launch`` fault fails the flush; after the
    breaker's threshold the executor refuses the shape (CircuitOpenError),
    and the oracle the caller then takes serves the same prepare shares as
    the healthy backend does."""
    import asyncio

    from janus_tpu_torch.core import faults
    from janus_tpu_torch.core.faults import FaultInjectedError, FaultSpec
    from janus_tpu_torch.executor import KIND_PREP_INIT, CircuitOpenError, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.vdaf.backend import oracle_backend_for, vdaf_shape_key

    vdaf = instances.prio3_histogram(L, C)
    backend = CudaBackend(vdaf, device="cpu")
    _, _, leader, _ = _reports(2, seed=9)
    key = vdaf_shape_key(vdaf)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.001, breaker_failure_threshold=2))

    async def submit():
        return await ex.submit(key, KIND_PREP_INIT, (VK, leader), backend=backend)

    faults.configure([FaultSpec("backend.launch", "error", 1.0)], seed=1)
    try:
        for _ in range(2):
            with pytest.raises(FaultInjectedError):
                asyncio.run(submit())
        assert ex.circuit_open(key)
        with pytest.raises(CircuitOpenError):
            asyncio.run(submit())
    finally:
        faults.clear()
        ex.shutdown()
    (circuit,) = ex.circuit_stats().values()
    assert circuit["state"] == "open" and circuit["trips"] == 1
    served = oracle_backend_for(backend, vdaf).prep_init_batch(VK, 0, leader)
    healthy = backend.prep_init_batch(VK, 0, leader)
    assert [p.encode(vdaf) for _, p in served] == [p.encode(vdaf) for _, p in healthy]
    assert [s.out_share for s, _ in served] == [s.out_share for s, _ in healthy]


@pytest.mark.parametrize("name", ["tpu", "mesh", "oracle ", "cuda", None])
def test_make_backend_refuses_what_it_cannot_serve(name):
    """Unknown names raise VdafError; so do "cuda", "mesh" and the default,
    which is "cuda", with no card: no quiet fallback to the oracle or the
    CPU."""
    from janus_tpu_torch.vdaf.backend import make_backend

    if name in ("cuda", "mesh", None):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: make_backend('cuda') serves it")
    args = () if name is None else (name,)
    with pytest.raises(VdafError):
        make_backend(instances.prio3_count(), *args)


def test_make_backend_builds_what_it_names():
    """The default is the card's backend (on the device the caller names);
    the oracle only when named."""
    from janus_tpu_torch.vdaf.backend import make_backend

    vdaf = instances.prio3_count()
    assert type(make_backend(vdaf, "oracle")) is OracleBackend
    for backend in (make_backend(vdaf, device="cpu"), make_backend(vdaf, "cuda", device="cpu")):
        assert type(backend) is CudaBackend and backend.device.type == "cpu"
