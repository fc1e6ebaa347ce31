"""Canonical shape buckets in the port, on the CPU against the JAX package.

``janus_tpu_torch/vdaf/canonical.py`` plans the same twins, keys and
exact-shape reasons as ``janus_tpu/vdaf/canonical.py`` over a sweep of
shapes.  The plain length-selected absorb (``ops/keccak.py``
``turboshake128_batch_select``, the K2 select kernel's plain version) equals
``keccak_jax.turboshake128_batch_select`` and the host XOF row for row.
``CudaBackend(twin, canonical=True, device="cpu")`` prepares reports of
every task of a bucket byte-identically to the task's own JAX oracle, both
sides, for Histogram, Sum, SumVec (Field128 and Field64) and
FixedPointBoundedL2VecSum, in mixed-task flushes and for tampered rows.
Reports are sharded by the JAX package's oracle from numpy seeds; every
comparison is exact (tolerance 0: integer arithmetic mod p).  The JAX
``TpuBackend`` comparison compiles for about 100 s on XLA:CPU and is
marked ``slow``.
"""

import numpy as np
import pytest
import torch

from janus_tpu.fields import Field64 as JaxField64
from janus_tpu.flp import FixedPointBoundedL2VecSum as JaxFixedPoint
from janus_tpu.flp import FlpGeneric as JaxFlpGeneric
from janus_tpu.flp import SumVec as JaxSumVec
from janus_tpu.vdaf import canonical as jax_canonical
from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf import prio3 as jax_prio3
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu.vdaf.backend import vdaf_shape_key as jax_shape_key
from janus_tpu_torch.fields import Field64
from janus_tpu_torch.flp import FixedPointBoundedL2VecSum, FlpGeneric, SumVec
from janus_tpu_torch.ops import keccak, keccak_kernels
from janus_tpu_torch.ops.prepare import BatchedPrio3
from janus_tpu_torch.vdaf import canonical, instances, prio3
from janus_tpu_torch.vdaf.backend import CudaBackend, vdaf_shape_key

VK = bytes(range(40, 56))


def pair(kind, *args):
    """(port, JAX) instances of one shape."""
    if kind == "fixedpoint":
        bits, entries, chunk = args
        alg = prio3.ALG_PRIO3_FIXEDPOINT_BOUNDED_L2_VEC_SUM
        return (
            prio3.Prio3(FlpGeneric(FixedPointBoundedL2VecSum(bits, entries, chunk)), alg),
            jax_prio3.Prio3(JaxFlpGeneric(JaxFixedPoint(bits, entries, chunk)), alg),
        )
    if kind == "sumvec64":  # single-proof TurboSHAKE SumVec over Field64
        alg = prio3.ALG_PRIO3_SUMVEC
        return (
            prio3.Prio3(FlpGeneric(SumVec(*args, field=Field64)), alg),
            jax_prio3.Prio3(JaxFlpGeneric(JaxSumVec(*args, field=JaxField64)), alg),
        )
    name = f"prio3_{kind}"
    return getattr(instances, name)(*args), getattr(jax_instances, name)(*args)


#: the plan sweep: every shape of each family
SWEEP = {
    "histogram": [("histogram", n, c) for c in range(1, 7) for n in range(1, 71)],
    "sum": [("sum", b) for b in list(range(1, 41)) + [63, 64, 100, 126, 127]],
    "sumvec": [("sum_vec", n, b, c) for n in range(1, 21) for b in (1, 2, 3, 4) for c in range(1, 6)]
    + [("sumvec64", 3, 3, 2), ("sumvec64", 9, 1, 4)],
    "fixedpoint": [("fixedpoint", b, e, c) for b in (2, 3, 4, 16) for e in range(1, 13) for c in range(1, 5)],
    "exact-and-flagship": [
        ("count",),
        ("sum_vec_field64_multiproof_hmacsha256_aes128", 2, 4, 1, 2),
        ("histogram", 1024, 316),
        ("histogram", 1000, 316),
        ("sum_vec", 100000, 1, 316),
        ("fixedpoint_bounded_l2_vec_sum", "BitSize16", 1000),
        ("fixedpoint_bounded_l2_vec_sum", "BitSize16", 1003),
    ],
}


@pytest.mark.parametrize("family", sorted(SWEEP))
def test_plans_match_the_jax_package(family):
    """Over every shape of the sweep: the same reason, the same twin (by its
    shape key), the same executor key, tagged or exact, and the exact key
    with canonicalization switched off."""
    for spec in SWEEP[family]:
        port, jax = pair(*spec)
        assert canonical.canonicalization_reason(port) == jax_canonical.canonicalization_reason(jax), spec
        twin, jtwin = canonical.canonical_vdaf_for(port), jax_canonical.canonical_vdaf_for(jax)
        assert (twin is None) == (jtwin is None), spec
        if twin is not None:
            assert vdaf_shape_key(twin) == jax_shape_key(jtwin), spec
            assert canonical.canonical_vdaf_for(twin) is None, spec  # a twin is its own ceiling
        key, ctwin = canonical.executor_shape(port)
        jkey, _ = jax_canonical.executor_shape(jax)
        assert key == jkey and ctwin is twin, spec
        assert key[0] == ("canon" if twin is not None else "Prio3"), spec
        assert canonical.executor_shape(port, enabled=False) == (vdaf_shape_key(port), None), spec
    stats = canonical.plan_stats()
    assert stats["planned"] >= 1 and stats["canonicalized"] + sum(stats["exact_reasons"].values()) == stats["planned"]


def test_flagship_buckets():
    """Histogram(1024, 316) and (1000, 316) share the twin Histogram(1264,
    316) (calls 4, P = 8); FixedPoint(BitSize16, 1000) and (1003) share 1006
    entries; SumVec(100000, 1, 316) pads its 317 calls to 511; a ceiling
    shape keeps its exact key, which never collides with the tagged one."""
    k1024, t1024 = canonical.executor_shape(instances.prio3_histogram(1024, 316))
    k1000, t1000 = canonical.executor_shape(instances.prio3_histogram(1000, 316))
    assert k1024 == k1000 and t1024.flp.valid.length == 1264 and t1024.flp.valid.GADGET_CALLS == [4]
    fp = [canonical.executor_shape(instances.prio3_fixedpoint_bounded_l2_vec_sum("BitSize16", e)) for e in (1000, 1003)]
    assert fp[0][0] == fp[1][0] and fp[0][1].flp.valid.entries == 1006
    sv = canonical.canonical_vdaf_for(instances.prio3_sum_vec(100000, 1, 316))
    assert sv.flp.valid.GADGET_CALLS == [511]
    k6, t6 = canonical.executor_shape(instances.prio3_histogram(6, 2))
    k5, _ = canonical.executor_shape(instances.prio3_histogram(5, 2))
    assert t6 is None and k6 == vdaf_shape_key(instances.prio3_histogram(6, 2)) and k6 != k5


def test_backend_shape_key_and_clips():
    """``backend_shape_key`` reads the backend's mode; a drained vector is
    clipped back to the task's length (no width: untouched), and a non-zero
    pad tail fails loudly."""
    h5, h6 = instances.prio3_histogram(5, 2), instances.prio3_histogram(6, 2)
    twin = canonical.canonical_vdaf_for(h5)
    assert canonical.backend_shape_key(CudaBackend(twin, device="cpu", canonical=True)) == canonical.executor_shape(h5)[0]
    assert canonical.backend_shape_key(CudaBackend(h6, device="cpu")) == vdaf_shape_key(h6)
    assert canonical.clip_agg_vector(h5, [1, 2, 3, 4, 5, 0]) == [1, 2, 3, 4, 5]
    assert canonical.clip_to_width([1, 2, 3, 4, 5, 0], 5) == [1, 2, 3, 4, 5]
    assert canonical.clip_to_width([1, 2, 3, 4, 5, 0], None) == [1, 2, 3, 4, 5, 0]
    assert canonical.clip_to_width(None, 5) is None
    with pytest.raises(prio3.VdafError):
        canonical.clip_agg_vector(h5, [1, 2, 3, 4, 5, 9])


# -- the length-selected absorb ----------------------------------------------

#: per-row message lengths around the 168-byte rate's edges
LENGTHS = [0, 1, 5, 166, 167, 168, 169, 200, 335, 336, 337, 400]


def _messages(rng, lengths, width):
    msg = np.zeros((len(lengths), width), dtype=np.uint8)
    for i, L in enumerate(lengths):
        msg[i, :L] = rng.integers(0, 256, L, dtype=np.uint8)
    return msg


@pytest.mark.parametrize("domain", [0x01, 0x1F])
def test_select_absorb_matches_jax_and_the_host_oracle(domain):
    """``turboshake128_batch_select`` equals the JAX function and, row for
    row, TurboSHAKE128 of the row's own message; over an XOF message with
    per-row binder lengths it equals the host XofTurboShake128."""
    from janus_tpu.ops.keccak_jax import turboshake128_batch_select as jax_select
    from janus_tpu_torch.xof import XofTurboShake128, turboshake128

    rng = np.random.default_rng(domain)
    msg = _messages(rng, LENGTHS, 400)
    lens = np.array(LENGTHS, dtype=np.int32)
    got = keccak.turboshake128_batch_select(torch.from_numpy(msg), domain, 16, torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_select(msg, domain, 16, lens)))
    for i, L in enumerate(LENGTHS):
        assert bytes(got[i]) == turboshake128(bytes(msg[i, :L]), domain, 16), L
    dst = b"\x01\x00\x00\x00\x00\x03\x00\x07"
    seed = rng.integers(0, 256, (len(LENGTHS), 16), dtype=np.uint8)
    head = 1 + len(dst) + 16
    xof_msg = keccak.xof_message(torch.from_numpy(seed), dst, torch.from_numpy(msg))
    xof = keccak.turboshake128_batch_select(xof_msg, 0x01, 16, torch.from_numpy(lens) + head).numpy()
    for i, L in enumerate(LENGTHS):
        assert bytes(xof[i]) == XofTurboShake128(bytes(seed[i]), dst, bytes(msg[i, :L])).next(16), L


def test_select_wrapper_plain_version_and_checks():
    """On a CPU tensor the K2 select wrapper takes its plain version, which
    keeps each row's state after its own final block (counting no launch);
    a final block outside the message and a wrong final-block tensor are
    refused."""
    rng = np.random.default_rng(3)
    msg = _messages(rng, LENGTHS, 400)
    lens = torch.tensor(LENGTHS)
    padded = keccak.select_pad(torch.from_numpy(msg), 0x01, lens)
    planes = keccak_kernels.rows_to_planes(keccak.bytes_to_words(padded).to(torch.int32))
    last = (lens // keccak.RATE).to(torch.int32)
    before = keccak_kernels.absorb_select.launches
    got = keccak_kernels.absorb_select(planes, last, 4)
    assert keccak_kernels.absorb_select.launches == before
    want = keccak.turboshake128_batch_select(torch.from_numpy(msg), 0x01, 16, lens)
    assert torch.equal(keccak.words_to_bytes(keccak_kernels.words(got).transpose(0, 1)), want)
    # a row of one block is the plain K2 absorb of that block
    one = keccak_kernels.absorb_plain(planes[: keccak.RATE_WORDS, :1].contiguous(), 4)
    assert torch.equal(one, got[:, :1])
    with pytest.raises(ValueError):
        keccak_kernels.absorb_select(planes, last.to(torch.int64), 4)
    with pytest.raises(ValueError):
        keccak_kernels.absorb_select(planes, torch.full_like(last, planes.shape[0] // keccak.RATE_WORDS), 4)


@pytest.mark.parametrize("agg_id", [0, 1])
def test_jr_part_message_pads_each_row_at_its_length(agg_id):
    """The in-plane joint-rand-part message with per-row measurement
    lengths zeroes the stream past each row's length (a helper's stream
    holds live data there), pads each row at its own length, and its select
    absorb equals the host XOF of the row's true message."""
    from janus_tpu_torch.ops.field import storage
    from janus_tpu_torch.vdaf.prio3 import USAGE_JOINT_RAND_PART
    from janus_tpu_torch.xof import XofTurboShake128

    twin = canonical.canonical_vdaf_for(instances.prio3_histogram(21, 4))  # 6 calls -> 7: 28 columns
    bp = BatchedPrio3(twin, device="cpu")
    n, B = bp.f.n, 6
    rng = np.random.default_rng(agg_id)
    meas_len = torch.tensor([21, 28, 1, 0, 11, 24])
    stream = torch.from_numpy(rng.integers(0, 2**32, (twin.flp.MEAS_LEN * n, B), dtype=np.int64))
    blinds = torch.from_numpy(rng.integers(0, 256, (B, 16), dtype=np.uint8))
    nonces = torch.from_numpy(rng.integers(0, 256, (B, 16), dtype=np.uint8))
    part = bp._jr_part_planes(agg_id, blinds, nonces, storage(stream), meas_len)
    dst = twin._dst(USAGE_JOINT_RAND_PART)
    for b in range(B):
        meas = stream[: int(meas_len[b]) * n, b].numpy().astype("<u4").tobytes()
        binder = bytes([agg_id]) + bytes(nonces[b].numpy()) + meas
        assert bytes(part[b].numpy()) == XofTurboShake128(bytes(blinds[b].numpy()), dst, binder).next(16), b


# -- the canonical backend against each task's JAX oracle ---------------------

def shard(jvdaf, measurements, seed):
    """(nonce, public share, input shares) per measurement, by the JAX oracle."""
    rng = np.random.default_rng(seed)
    out = []
    for m in measurements:
        nonce = rng.bytes(16)
        out.append((nonce,) + tuple(jvdaf.shard(m, nonce, rng.bytes(jvdaf.RAND_SIZE))))
    return out


def fp_meas(bits, entries, k):
    step = 1.0 / (1 << (bits - 1))
    return [[step if i == j % entries else 0.0 for i in range(entries)] for j in range(k)]


#: one task a family whose shape is below its bucket's ceiling (its calls
#: are masked), with its measurements
TASKS = {
    "histogram5x2": (("histogram", 5, 2), [0, 4, 2]),
    "histogram7x3": (("histogram", 7, 3), [6, 0, 3]),
    "sum5": (("sum", 5), [0, 31, 7]),
    "sumvec3x3x2": (("sum_vec", 3, 3, 2), [[0, 0, 0], [7, 1, 5], [3, 3, 3]]),
    "sumvec64": (("sumvec64", 3, 3, 2), [[0, 0, 0], [7, 1, 5], [3, 3, 3]]),
    "fixedpoint3x4x3": (("fixedpoint", 3, 4, 3), fp_meas(3, 4, 3)),
    "fixedpoint2x5x2": (("fixedpoint", 2, 5, 2), fp_meas(2, 5, 3)),
}


def canonical_backend(port, one_shape_exact=False):
    """The twin backend of ``port``'s bucket; by default every flush takes
    the twin's masked row path, even a flush of one task shape."""
    twin = canonical.canonical_vdaf_for(port)
    assert twin is not None
    backend = CudaBackend(twin, device="cpu", canonical=True)
    backend.one_shape_exact = one_shape_exact
    return backend


def prep(backend, agg_id, requests):
    return backend.launch_prep_init_multi(backend.stage_prep_init_multi(agg_id, requests), requests)


def assert_oracle_rows(got, jvdaf, agg_id, rows, vk=VK):
    """Every output of every row equals the task's JAX oracle, and out
    shares come back at the task's length."""
    want = JaxOracleBackend(jvdaf).prep_init_batch(vk, agg_id, rows)
    assert len(got) == len(want)
    for b, ((gs, gp), (ws, wp)) in enumerate(zip(got, want)):
        assert gs.out_share == ws.out_share and len(gs.out_share) == jvdaf.flp.OUTPUT_LEN, (agg_id, b)
        assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed, (agg_id, b)
        assert gp.verifiers_share == wp.verifiers_share, (agg_id, b)
        assert gp.joint_rand_part == wp.joint_rand_part, (agg_id, b)
    return want


@pytest.mark.parametrize("task", sorted(TASKS))
def test_canonical_backend_matches_the_task_oracle(task):
    """Both sides of a task prepared on its bucket's twin, on the masked row
    path, equal the task's JAX oracle; the device combine decides as the
    oracle does and the accepted aggregate is the plain sum."""
    spec, meas = TASKS[task]
    port, jax = pair(*spec)
    backend = canonical_backend(port)
    assert backend._prep_fn(0, 8).__name__ == "prep_init"  # masks: row path
    rows = shard(jax, meas, len(task))
    got = {}
    for agg_id in (0, 1):
        side = [(n, p, s[agg_id]) for n, p, s in rows]
        got[agg_id] = prep(backend, agg_id, [(VK, side, port)])[0]
        assert_oracle_rows(got[agg_id], jax, agg_id, side)
    assert backend.oracle_recompute_rows == 0 and not any(backend.oracle.rows.values())
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(len(rows))]
    msgs = backend.prep_shares_to_prep_batch(pairs)
    assert msgs == JaxOracleBackend(jax).prep_shares_to_prep_batch(pairs)
    aggs = [port.aggregate([got[a][b][0].out_share for b in range(len(rows))]) for a in (0, 1)]
    assert aggs == [jax.aggregate([got[a][b][0].out_share for b in range(len(rows))]) for a in (0, 1)]


@pytest.mark.parametrize("agg_id", [0, 1])
@pytest.mark.parametrize("bucket", ["histogram-chunk2", "histogram-chunk3"])
def test_two_tasks_share_one_flush(bucket, agg_id):
    """Two tasks of one bucket ride one staged flush: Histogram(5, 2) with
    the ceiling (6, 2) on its twin, and (7, 3) with (8, 3) on (9, 3); each
    task's rows equal its own oracle at its own length."""
    lengths = {"histogram-chunk2": ((5, 2), (6, 2)), "histogram-chunk3": ((7, 3), (8, 3))}[bucket]
    tasks = [pair("histogram", *lc) for lc in lengths]
    backend = canonical_backend(tasks[0][0])
    reqs = []
    for i, (port, jax) in enumerate(tasks):
        rows = shard(jax, [port.flp.valid.length - 1, 0, 1][: 2 + i], 10 * i + agg_id)
        reqs.append((bytes([i + 1]) * 16, [(n, p, s[agg_id]) for n, p, s in rows], port))
    got = prep(backend, agg_id, reqs)
    for (port, jax), (vk, side, _), g in zip(tasks, reqs, got):
        assert_oracle_rows(g, jax, agg_id, side, vk)


def test_tampered_rows_are_rejected_as_the_oracle_rejects():
    """Adversarial content: a histogram leader proof share bumped by one
    (the gadget-output mask keeps the padded evaluation points out of an
    attacker's reach), and FixedPoint reports whose element is not a bit
    or whose claimed norm lies (the norm bits gathered at the row's own
    offset): every verifier equals the oracle's and the combine rejects
    exactly the tampered rows."""
    from test_torch_fpvec import reports as fp_reports

    h5, jh5 = pair("histogram", 5, 2)
    rows = shard(jh5, [2, 3], 77)
    bad = rows[0][2][0]
    rows[0][2][0] = type(bad)(
        meas_share=list(bad.meas_share),
        proofs_share=[(x + 1) % jh5.flp.field.MODULUS for x in bad.proofs_share],
        joint_rand_blind=bad.joint_rand_blind,
        share_seed=None,
    )
    fp, jfp = pair("fixedpoint", 3, 4, 3)
    fp_rows, _ = fp_reports(jfp, np.random.default_rng(5), 2)
    for (port, jax, rows, rejected) in ((h5, jh5, rows, [True, False]), (fp, jfp, fp_rows, [False] * 2 + [True] * 2)):
        backend = canonical_backend(port)
        got = []
        for agg_id in (0, 1):
            side = [(n, p, s[agg_id]) for n, p, s in rows]
            got.append(prep(backend, agg_id, [(VK, side, port)])[0])
            assert_oracle_rows(got[-1], jax, agg_id, side)
        msgs = backend.prep_shares_to_prep_batch([[got[0][b][1], got[1][b][1]] for b in range(len(rows))])
        assert [isinstance(m, prio3.VdafError) for m in msgs] == rejected


def test_not_ok_row_is_recomputed_by_the_task_oracle(monkeypatch):
    """A row whose device ok flag is False is recomputed by the task's own
    oracle (the twin's would compute another circuit) and counted."""
    port, jax = pair("sum_vec", 3, 3, 2)
    backend = canonical_backend(port)
    real = backend.bp.prep_init

    def first_row_not_ok(*args, **kw):
        out = real(*args, **kw)
        out["ok"] = out["ok"].clone()
        out["ok"][0] = False
        return out

    monkeypatch.setattr(backend.bp, "prep_init", first_row_not_ok)
    rows = shard(jax, [[1, 2, 3], [4, 5, 6]], 12)
    side = [(n, p, s[1]) for n, p, s in rows]
    got = prep(backend, 1, [(VK, side, port)])[0]
    assert_oracle_rows(got, jax, 1, side)
    assert backend.oracle_recompute_rows == 1
    assert backend.oracle_for(port).rows["init"] == 1 and backend.oracle.rows["init"] == 0


@pytest.mark.parametrize("task", sorted(TASKS))
def test_one_shape_flush_runs_its_own_prepare(task):
    """By default a flush whose rows are all of one task shape runs that
    shape's own prepare, unpadded and unmasked (planar where the shape is
    eligible), and equals the task's JAX oracle on both sides; out shares
    that stay on the card name the task's width where the twin's is wider."""
    from janus_tpu_torch.executor.accumulator import DeviceAccumulatorStore

    spec, meas = TASKS[task]
    port, jax = pair(*spec)
    backend = canonical_backend(port, one_shape_exact=True)
    rows = shard(jax, meas, 3 + len(task))
    for agg_id in (0, 1):
        side = [(n, p, s[agg_id]) for n, p, s in rows]
        reqs = [(VK, side, port)]
        staged = backend.stage_prep_init_multi(agg_id, reqs)
        assert staged.exact is port and "meas_len" not in staged.placed
        want = BatchedPrio3(port, device="cpu").prep_route(agg_id, staged.pad_to)
        assert backend._prep_fn(agg_id, staged.pad_to, staged.exact).__name__ == want
        assert_oracle_rows(backend.launch_prep_init_multi(staged, reqs)[0], jax, agg_id, side)
        store = DeviceAccumulatorStore()
        resident = backend.launch_prep_init_multi(backend.stage_prep_init_multi(agg_id, reqs), reqs, retain_store=store)
        narrower = port.flp.OUTPUT_LEN < backend.vdaf.flp.OUTPUT_LEN
        assert {st.out_share.width for st, _ in resident[0]} == {port.flp.OUTPUT_LEN if narrower else None}
    assert backend.oracle_recompute_rows == 0 and not any(backend.oracle.rows.values())


@pytest.mark.parametrize("agg_id", [0, 1])
def test_mixed_flush_runs_the_masked_twin(agg_id):
    """By default a flush that mixes two shapes of one bucket runs the
    twin's masked row path, and each task's rows equal its own oracle."""
    (h7, jh7), (h8, jh8) = pair("histogram", 7, 3), pair("histogram", 8, 3)
    backend = canonical_backend(h7, one_shape_exact=True)
    reqs = [(VK, [(n, p, s[agg_id]) for n, p, s in shard(j, [0, 6], 40 + i)], v)
            for i, (v, j) in enumerate(((h7, jh7), (h8, jh8)))]
    staged = backend.stage_prep_init_multi(agg_id, reqs)
    assert staged.exact is None and staged.placed["meas_len"].tolist()[:4] == [7, 7, 8, 8]
    assert backend._prep_fn(agg_id, staged.pad_to).__name__ == "prep_init"
    got = backend.launch_prep_init_multi(staged, reqs)
    for (_vk, side, _v), jax, g in zip(reqs, (jh7, jh8), got):
        assert_oracle_rows(g, jax, agg_id, side)


def test_warmup_rows_take_the_twin_width():
    """A 2-tuple request (the executor warmup's synthetic rows) is shaped for
    the twin itself: its rows keep the full width."""
    from janus_tpu_torch.executor.service import _synthetic_report

    port, _ = pair("histogram", 5, 2)
    backend = canonical_backend(port)
    twin = backend.vdaf
    reports = [(b"\x00" * 16, *_synthetic_report(twin, 0))]
    staged = backend.stage_prep_init_multi(0, [(VK, reports)], pad_to=4)
    assert staged.placed["meas_len"].tolist() == [twin.flp.MEAS_LEN] * 4
    out = backend.launch_prep_init_multi(staged, [(VK, reports)])[0]
    assert len(out[0][0].out_share) == twin.flp.OUTPUT_LEN


@pytest.mark.slow
@pytest.mark.parametrize("agg_id", [0, 1])
def test_matches_the_jax_canonical_tpu_backend(agg_id):
    """The Histogram(·, 2) bucket against the JAX ``TpuBackend(twin,
    canonical=True)`` on the CPU: a mixed flush of Histogram(5, 2) and (6,
    2), every output equal (about 50 s of XLA compile a side)."""
    from janus_tpu.vdaf.backend import TpuBackend

    h5, jh5 = pair("histogram", 5, 2)
    h6, jh6 = pair("histogram", 6, 2)
    jbackend = TpuBackend(jax_canonical.canonical_vdaf_for(jh5), canonical=True)
    backend = canonical_backend(h5)
    r5 = [(n, p, s[agg_id]) for n, p, s in shard(jh5, [0, 4], 51)]
    r6 = [(n, p, s[agg_id]) for n, p, s in shard(jh6, [5, 1, 3], 61)]
    got = prep(backend, agg_id, [(VK, r5, h5), (VK, r6, h6)])
    jreqs = [(VK, r5, jh5), (VK, r6, jh6)]
    want = jbackend.launch_prep_init_multi(jbackend.stage_prep_init_multi(agg_id, jreqs), jreqs)
    for g_task, w_task in zip(got, want):
        for (gs, gp), (ws, wp) in zip(g_task, w_task):
            assert gs.out_share == ws.out_share and gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed
            assert gp.verifiers_share == wp.verifiers_share and gp.joint_rand_part == wp.joint_rand_part
