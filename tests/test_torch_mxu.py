"""The limb-digit matmul field layout (``field_backend: mxu``) of the port on
the CPU.

``TField.mat_mul_mont``, ``dot_mont``, ``poly_eval_dot``, ``inv_mont`` and
``batch_inv_mont`` (``janus_tpu_torch/ops/field.py``) against the JAX
package's ``JField`` on Field64 and Field128: random operands with zeros
and p - 1 among them, a shared right operand, carry-saturating operands
(every element p - 1) and a contraction chunked by a small ``DOT_MAX_K``.
``BatchedPrio3(field_backend="mxu")`` prepares and combines Count, Sum(8),
Histogram(10, 3), SumVec(8, 2, 3) and FixedPointBoundedL2VecSum(BitSize16,
4), both sides, byte-equal to the port's vpu route and row for row to the
JAX package's oracle, and a canonical bucket's masked mixed flush of
Histogram(5, 2) and (6, 2) equal to each task's oracle; the setting reaches
``make_backend``, ``CudaBackend`` and ``HybridXofBackend``.  Every mxu
branch of Count's circuit is held against the JAX package's; with
``RUN_SLOW=1`` (``slow``: XLA:CPU compiles for seconds to a minute a case,
about 200 s in all) also those of the four Field128 circuits (a Field128
circuit's whole mxu prepare compiles for more than 20 minutes there),
Count's whole mxu prepare against the JAX package's under jax.jit, and the
Field128 inversions against ``JField``'s; the reduce kernel against its plain version on the card
is in ``tests/test_torch_cuda.py``.  Every comparison is exact (tolerance
0).

Run: ``python -m pytest tests/test_torch_mxu.py -q``.
"""

import jax
import numpy as np
import pytest
import torch

from janus_tpu import fields as jax_fields
from janus_tpu.ops.field_jax import JField
from janus_tpu.ops.prepare import BatchedPrio3 as JaxBatchedPrio3
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu_torch import fields
from janus_tpu_torch.ops import field as field_mod
from janus_tpu_torch.ops import field_kernels
from janus_tpu_torch.ops.field import TField, storage, tensor_to_u32, words
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import canonical, instances
from janus_tpu_torch.vdaf.backend import CudaBackend, HybridXofBackend, make_backend
from janus_tpu_torch.vdaf.prio3 import VdafError
from test_torch_canonical import pair
from test_torch_small import shard, staged_inputs

VK = bytes(range(32, 48))
FIELDS = ["Field64", "Field128"]


def fields_of(name):
    return TField(getattr(fields, name)), JField(getattr(jax_fields, name))


def operand(f, shape, seed, fill=None):
    """(..., n) canonical limbs as uint32, from a seeded numpy generator:
    random (top bit clear, below p) with 0 and p - 1 at the first two
    elements of more than two, or every element ``fill``."""
    if fill is not None:
        return np.broadcast_to(f._int_to_limbs_np(fill), shape + (f.n,)).copy()
    x = np.random.default_rng(seed).integers(0, 2**32, shape + (f.n,), dtype=np.uint64).astype(np.uint32)
    x[..., -1] >>= 1
    flat = x.reshape(-1, f.n)
    if len(flat) > 2:
        flat[0] = 0
        flat[1] = f._int_to_limbs_np(f.p - 1)
    return x


def port(x):
    return words(torch.from_numpy(x.view(np.int32)))


def assert_equal(got, want):
    np.testing.assert_array_equal(tensor_to_u32(got), np.asarray(want))


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("case", ["random", "shared", "saturated", "chunked"])
def test_mat_mul_mont_matches_jax(name, case, monkeypatch):
    """mat_mul_mont at (B, K, M) x (B, K, N) = (2, 5, 3) x (2, 5, 4).  The
    shared case gives the port its right operand once (K, N, n) and JAX the
    same matrix for every batch element; the chunked one splits K = 5 into
    chunks of 2 in the port, which JAX contracts in one pass."""
    f, jf = fields_of(name)
    fill = f.p - 1 if case == "saturated" else None
    a = operand(f, (2, 5, 3), 1, fill)
    b = operand(f, (2, 5, 4), 2, fill)
    if case == "shared":
        b = np.broadcast_to(b[0], b.shape).copy()
    if case == "chunked":
        monkeypatch.setattr(field_mod, "DOT_MAX_K", 2)
    got = f.mat_mul_mont(port(a), port(b[0]) if case == "shared" else port(b))
    assert_equal(got, jf.mat_mul_mont(a, b))


@pytest.mark.parametrize("name", FIELDS)
def test_dot_mont_matches_jax(name):
    f, jf = fields_of(name)
    a, b = operand(f, (3, 6, 2), 3), operand(f, (3, 6), 4)
    assert_equal(f.dot_mont(port(a), port(b)), jf.dot_mont(a, b))


@pytest.mark.parametrize("name", FIELDS)
def test_poly_eval_dot_matches_jax_horner(name):
    """10 coefficients (3 baby steps, 4 giant steps, 2 pad coefficients) at
    4 points, against the JAX package's Horner evaluation."""
    f, jf = fields_of(name)
    coeffs, x = operand(f, (4, 10), 5), operand(f, (4,), 6)
    assert_equal(f.poly_eval_dot(port(coeffs), port(x)), jf.horner_mont(coeffs, x))


def _inv_cases(name):
    return [
        pytest.param(name, batched, marks=pytest.mark.slow) if name == "Field128" else (name, batched)
        for batched in (True, False)
    ]


@pytest.mark.parametrize("name,batched", _inv_cases("Field64") + _inv_cases("Field128"))
def test_inv_mont_matches_jax(name, batched):
    """inv_mont on a (2, 3) batch holding a zero (Montgomery's batch trick)
    and on one element (the Fermat chain); inv(0) = 0.  Field128's JAX
    chains compile for seconds."""
    f, jf = fields_of(name)
    a = operand(f, (2, 3) if batched else (), 7)
    assert_equal(f.inv_mont(port(a)), jf.inv_mont(a))


@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n == "Field128" else n for n in FIELDS])
def test_batch_inv_mont_matches_jax(name):
    f, jf = fields_of(name)
    a = operand(f, (4, 3), 8)
    a[0, 0] = f._int_to_limbs_np(1)  # batch_inv takes nonzero entries
    assert_equal(f.batch_inv_mont(port(a), 0), jf.batch_inv_mont(a, 0))


@pytest.mark.parametrize("name", FIELDS)
def test_inversions_match_the_oracle(name):
    """Both inversions against Python integers: x * inv(x) is the
    Montgomery one for nonzero x, and inv(0) = 0."""
    f, _ = fields_of(name)
    a = operand(f, (5,), 9)
    r_inv = pow(1 << (32 * f.n), f.p - 2, f.p)
    for got in (f.inv_mont(port(a)), f.batch_inv_mont(port(a[1:]), 0)):
        xs = f.from_limbs(a[-len(got):])
        ys = f.from_limbs(tensor_to_u32(got))
        for x, y in zip(xs, ys):
            assert x * y * r_inv % f.p == (f.mont_int(1) if x else 0)


def test_reduce_wrapper_takes_the_plain_version_on_the_cpu():
    """The wrapper's CPU path is the plain version and counts no launch; a
    wrong shape raises."""
    f, _ = fields_of("Field128")
    P = torch.randint(0, 2**32, (2, 3, 16, 4, 16), dtype=torch.int64).to(torch.float64)
    before = field_kernels.lazy_reduce_digits.launches
    got = field_kernels.lazy_reduce_digits(f, P)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 4, 4)
    assert torch.equal(got, storage(f._lazy_reduce_digits(P)))
    assert field_kernels.lazy_reduce_digits.launches == before
    with pytest.raises(ValueError):
        field_kernels.lazy_reduce_digits(f, P[..., :8])


FP4 = {"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": "BitSize16", "length": 4}
#: (port constructor, JAX constructor, measurement from a numpy generator)
CIRCUITS = {
    "count": (instances.prio3_count, jax_instances.prio3_count, lambda r: int(r.integers(0, 2))),
    "sum8": (lambda: instances.prio3_sum(8), lambda: jax_instances.prio3_sum(8), lambda r: int(r.integers(0, 256))),
    "histogram10x3": (
        lambda: instances.prio3_histogram(10, 3),
        lambda: jax_instances.prio3_histogram(10, 3),
        lambda r: int(r.integers(0, 10)),
    ),
    "sumvec8x2x3": (
        lambda: instances.prio3_sum_vec(8, 2, 3),
        lambda: jax_instances.prio3_sum_vec(8, 2, 3),
        lambda r: [int(x) for x in r.integers(0, 4, 8)],
    ),
    "fixedpoint4": (
        lambda: instances.vdaf_from_instance(FP4),
        lambda: jax_instances.vdaf_from_instance(FP4),
        lambda r: [int(k) / (1 << 15) for k in r.integers(-100, 101, 4)],
    ),
}


def prepare_both(name, B=6, tamper=(2,)):
    """Both sides of B reports (row 2's leader share perturbed) through the
    mxu and the vpu prepare: (reports, {layout: [side 0, side 1]}, mxu bp)."""
    port_ctor, jax_ctor, measure = CIRCUITS[name]
    vdaf = port_ctor()
    reports = shard(jax_ctor(), measure, B, seed=60, tamper=set(tamper))
    bps = {fb: BatchedPrio3(vdaf, device="cpu", field_backend=fb) for fb in ("vpu", "mxu")}
    out = {fb: [] for fb in bps}
    for agg_id in (0, 1):
        vk, nonces, kw = staged_inputs(vdaf, reports, agg_id)
        assert bps["mxu"].prep_route(agg_id, nonces.shape[0]) == "prep_init"
        for fb, bp in bps.items():
            out[fb].append(bp.prep_init(agg_id, vk, nonces, **kw))
    return reports, out, bps["mxu"]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_mxu_prepare_and_combine_match_vpu_and_the_oracle(name):
    """Every output of both sides' mxu prepare equals the vpu route's; each
    row's prepare share, out share and joint-rand seed equal the JAX oracle's;
    the mxu combine decides as the oracle does (the tampered row rejected)
    and derives the same prep-message seed."""
    _, jax_ctor, _ = CIRCUITS[name]
    jvdaf = jax_ctor()
    reports, out, bp = prepare_both(name)
    oracle = []
    for agg_id in (0, 1):
        mxu, vpu = out["mxu"][agg_id], out["vpu"][agg_id]
        assert set(mxu) == set(vpu)
        for k in mxu:
            assert mxu[k].dtype == vpu[k].dtype and torch.equal(mxu[k], vpu[k]), (agg_id, k)
        rows = [(nonce, public, shares[agg_id]) for _, nonce, public, shares in reports]
        want = JaxOracleBackend(jvdaf).prep_init_batch(VK, agg_id, rows)
        for b, (st, ps) in enumerate(want):
            assert bp.f.from_limbs(tensor_to_u32(mxu["verifiers"][b])) == ps.verifiers_share, (agg_id, b)
            assert bp.f.from_limbs(tensor_to_u32(mxu["out_share"][b])) == st.out_share, (agg_id, b)
            if bp.flp.JOINT_RAND_LEN:
                assert mxu["corrected_seed"][b].numpy().tobytes() == st.corrected_joint_rand_seed
        oracle.append(want)
    parts = [out["mxu"][a]["joint_rand_part"] for a in (0, 1)] if bp.flp.JOINT_RAND_LEN else None
    B = len(reports)
    msg = bp.prep_shares_to_prep([out["mxu"][a]["verifiers"][:B] for a in (0, 1)], parts and [p[:B] for p in parts])
    vpu = BatchedPrio3(bp.prio3, device="cpu")
    vpu_msg = vpu.prep_shares_to_prep([out["vpu"][a]["verifiers"][:B] for a in (0, 1)], parts and [p[:B] for p in parts])
    want = JaxOracleBackend(jvdaf).prep_shares_to_prep_batch(
        [[oracle[0][b][1], oracle[1][b][1]] for b in range(B)]
    )
    assert msg["decide"].tolist() == [not isinstance(w, Exception) for w in want] == vpu_msg["decide"].tolist()
    assert not msg["decide"][2]
    if parts is not None:
        assert torch.equal(msg["prep_msg_seed"], vpu_msg["prep_msg_seed"])
        assert all(msg["prep_msg_seed"][b].numpy().tobytes() == w for b, w in enumerate(want) if msg["decide"][b])


@pytest.mark.parametrize("agg_id", [0, 1])
def test_canonical_masked_flush_under_mxu(agg_id):
    """A mixed flush of Histogram(5, 2) and (6, 2) on their bucket's twin
    under mxu runs the masked row path; each task's rows equal its own JAX
    oracle, and the flush's outputs equal the vpu twin's."""
    (h5, jh5), (h6, jh6) = pair("histogram", 5, 2), pair("histogram", 6, 2)
    twin = canonical.canonical_vdaf_for(h5)
    reqs = [(VK, [(n, p, s[agg_id]) for n, p, s in rows], v) for v, rows in (
        (h5, [(n, p, s) for _, n, p, s in shard(jh5, lambda r: int(r.integers(0, 5)), 2, 70)]),
        (h6, [(n, p, s) for _, n, p, s in shard(jh6, lambda r: int(r.integers(0, 6)), 3, 71)]),
    )]
    got = {}
    for fb in ("vpu", "mxu"):
        backend = CudaBackend(twin, device="cpu", canonical=True, field_backend=fb)
        staged = backend.stage_prep_init_multi(agg_id, reqs)
        assert staged.exact is None and backend._prep_fn(agg_id, staged.pad_to).__name__ == "prep_init"
        got[fb] = backend.launch_prep_init_multi(staged, reqs)
        assert backend.bp.field_backend == fb and backend.oracle_recompute_rows == 0
    for (_vk, side, _v), jvdaf, g, v in zip(reqs, (jh5, jh6), got["mxu"], got["vpu"]):
        want = JaxOracleBackend(jvdaf).prep_init_batch(VK, agg_id, side)
        for (gs, gp), (ws, wp), (vs, vp) in zip(g, want, v):
            assert gs.out_share == ws.out_share == vs.out_share
            assert gp.verifiers_share == wp.verifiers_share == vp.verifiers_share
            assert gp.joint_rand_part == wp.joint_rand_part
            assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed


def test_mxu_plumbing(monkeypatch):
    """mxu turns the planar path off; make_backend carries the setting into
    the backend's BatchedPrio3 (the hybrid's too) and the environment sets
    the default; an unknown value raises."""
    hist = instances.prio3_histogram(10, 3)
    assert BatchedPrio3(hist, device="cpu").planar_eligible(1, 8)
    bp = BatchedPrio3(hist, device="cpu", field_backend="mxu")
    assert not bp.planar_eligible(1, 8) and bp.prep_route(1, 8) == "prep_init"
    backend = make_backend(hist, "cuda", device="cpu", field_backend="mxu")
    assert isinstance(backend, CudaBackend) and backend.bp.field_backend == backend.field_backend == "mxu"
    assert backend._prep_fn(1, 8).__name__ == "prep_init"
    assert make_backend(hist, "cuda", device="cpu").bp.field_backend == "vpu"
    mp = instances.vdaf_from_instance(
        {"type": "Prio3SumVecField64MultiproofHmacSha256Aes128", "proofs": 2, "length": 4, "bits": 1, "chunk_length": 2}
    )
    hybrid = make_backend(mp, "cuda", device="cpu", field_backend="mxu")
    assert isinstance(hybrid, HybridXofBackend) and hybrid.bp.field_backend == "mxu"
    monkeypatch.setenv("JANUS_TPU_TORCH_FIELD_BACKEND", "mxu")
    assert make_backend(hist, "cuda", device="cpu").bp.field_backend == "mxu"
    with pytest.raises(VdafError, match="field_backend"):
        make_backend(hist, "cuda", device="cpu", field_backend="tpu")
    with pytest.raises(ValueError):
        BatchedPrio3(hist, device="cpu", field_backend="tpu")
    assert make_backend(hist, "oracle", field_backend="tpu").name == "oracle"


# -- the JAX package's own mxu code (slow: XLA:CPU compiles each case) -------


@pytest.mark.slow
@pytest.mark.parametrize("agg_id", [0, 1])
def test_count_mxu_prepare_matches_the_jax_mxu_prepare(agg_id):
    """Count's mxu prep_init at B = 4 against the JAX package's
    ``BatchedPrio3(field_backend="mxu").prep_init`` under jax.jit, every
    output, and the combine against its ``prep_shares_to_prep`` (about 15 s
    of XLA compile a side; a Field128 circuit's whole mxu prepare compiles
    for more than 20 minutes, so those are held branch by branch below)."""
    port_ctor, jax_ctor, measure = CIRCUITS["count"]
    vdaf = port_ctor()
    bp = BatchedPrio3(vdaf, device="cpu", field_backend="mxu")
    jbp = JaxBatchedPrio3(jax_ctor(), field_backend="mxu")
    reports = shard(jax_ctor(), measure, 4, seed=80, tamper={1})
    sides = []
    for a in (0, 1):
        vk, nonces, kw = staged_inputs(vdaf, reports, a)
        jkw = {k: v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy() for k, v in kw.items()}
        sides.append(bp.prep_init(a, vk, nonces, **kw))
        if a == agg_id:
            jout = jax.jit(lambda v, n, kw: jbp.prep_init(agg_id, verify_key=v, nonces_u8=n, **kw))(
                vk.numpy(), nonces.numpy(), jkw
            )
            assert set(sides[a]) == set(jout)
            for k, want in jout.items():
                got = sides[a][k]
                got = tensor_to_u32(got) if got.dtype in (torch.int32, torch.int64) else got.numpy()
                np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)
    msg = bp.prep_shares_to_prep([s["verifiers"] for s in sides])
    jmsg = jbp.prep_shares_to_prep([tensor_to_u32(s["verifiers"]) for s in sides])
    np.testing.assert_array_equal(msg["decide"].numpy(), np.asarray(jmsg["decide"]))


@pytest.mark.parametrize(
    "name", [n if n == "count" else pytest.param(n, marks=pytest.mark.slow) for n in sorted(CIRCUITS)]
)
def test_mxu_branches_match_the_jax_mxu_circuit(name):
    """Every mxu branch of the row path against the JAX package's, eagerly,
    on the same random canonical inputs at B = 2: each gadget's wire
    evaluations, the circuit output, the out share and the gadget outputs
    (one matmul against the w^(kj) table), and FixedPoint's again under
    per-row measurement lengths (one row a task of one entry fewer);
    gpoly(t) (``poly_eval_dot``) against the JAX package's Horner
    evaluation, whose mxu twin compiles for minutes.  Count (Field64, ~3 s)
    runs always; the Field128 circuits take 25-50 s each."""
    port_ctor, jax_ctor, _ = CIRCUITS[name]
    bp = BatchedPrio3(port_ctor(), device="cpu", field_backend="mxu")
    jbp = JaxBatchedPrio3(jax_ctor(), field_backend="mxu")
    f, jf, flp = bp.f, jbp.jf, bp.flp
    circ, jcirc = bp.circ, jbp.circ
    B = 2

    def rand(shape, seed):
        x = operand(f, (B,) + shape, seed)
        return port(x), x

    meas, jmeas = rand((flp.MEAS_LEN,), 1)
    if flp.JOINT_RAND_LEN:
        jr, jjr = rand((flp.JOINT_RAND_LEN,), 2)
    else:
        jr, jjr = None, np.zeros((B, 0, f.n), dtype=np.uint32)
    mls = [None]
    if name == "fixedpoint4":
        valid = flp.valid
        mls.append(np.array([flp.MEAS_LEN, flp.MEAS_LEN - valid.bits_per_entry], dtype=np.int32))
    for ml in mls:
        pml = None if ml is None else torch.from_numpy(ml.astype(np.int64))
        gks, jgks = [], []
        for gi, plan in enumerate(circ.plans):
            lag, jlag = rand((plan.calls + 1,), 10 + gi)
            seeds, jseeds = rand((plan.arity,), 20 + gi)
            assert_equal(
                circ.wire_evals_g(gi, f, meas, jr, lag, seeds, bp.consts, ml=pml),
                jcirc.wire_evals_g(gi, jf, jmeas, jjr, jlag, jseeds, jbp.consts, ml=ml),
            )
            gpoly, jgpoly = rand((plan.glen,), 30 + gi)
            gk = bp._gadget_outputs(gpoly, gi)
            assert_equal(gk, jbp._gadget_outputs(jgpoly, B, gi))
            gks.append(gk)
            jgks.append(tensor_to_u32(gk))
            t, jt = rand((), 40 + gi)
            assert_equal(bp._gpoly_at(gpoly, t), jf.horner_mont(jgpoly, jt))
        assert_equal(circ.v_multi(f, gks, meas, jr, bp.consts, ml=pml), jcirc.v_multi(jf, jgks, jmeas, jjr, jbp.consts, ml=ml))
        assert_equal(circ.truncate(f, meas, bp.consts, ml=pml), jcirc.truncate(jf, jmeas, jbp.consts, ml=ml))
