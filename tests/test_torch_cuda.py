"""The port's CUDA kernels on the card against their plain versions, and the
CUDA backend against the oracle.  Marked ``cuda``: each test skips where
there is no card (decided inside the ``card`` fixture, never at import).

Run on a machine with an NVIDIA Hopper card and nvcc:
``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

from janus_tpu_torch.fields import Field128
from janus_tpu_torch.ops import flp_kernels, keccak, keccak_kernels
from janus_tpu_torch.ops.field import TField, storage, words

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.int64))


def _message_planes(rng, rows, batch):
    return storage(_words(rng, (rows, batch))).contiguous()


# K1 and K2 at the edges of their layout: 6 reports a block (B = 1, 7, 33
# leave ragged last blocks), 42-word output blocks (43 and 4096 = 97 * 42 + 22
# end in a partial block), a 4-stage load ring (na = 7 wraps it).
@pytest.mark.parametrize("out_words", [4, 42, 43, 4096])
@pytest.mark.parametrize("batch", [1, 7, 33, 1000, 4096])
def test_squeeze_kernel_matches_plain(card, batch, out_words):
    msg = _message_planes(np.random.default_rng(batch), 42, batch)
    before = keccak_kernels.squeeze.launches
    got = keccak_kernels.squeeze(msg.to(card), out_words)
    torch.cuda.synchronize()
    assert keccak_kernels.squeeze.launches == before + 1
    assert torch.equal(got.cpu(), keccak_kernels.squeeze_plain(msg, out_words))


@pytest.mark.parametrize("out_words", [4, 42])
@pytest.mark.parametrize("blocks", [1, 2, 7])
@pytest.mark.parametrize("batch", [3, 8, 257, 1024])
def test_absorb_kernel_matches_plain(card, batch, blocks, out_words):
    rng = np.random.default_rng([batch, blocks])
    msgs = torch.from_numpy(rng.integers(0, 256, (batch, 168 * blocks - 3), dtype=np.uint8))
    planes = keccak_kernels.rows_to_planes(storage(keccak.bytes_to_words(keccak.pad_message(msgs, 1))))
    before = keccak_kernels.absorb.launches
    got = keccak_kernels.absorb(planes.to(card), out_words)
    torch.cuda.synchronize()
    assert keccak_kernels.absorb.launches == before + 1
    assert torch.equal(got.cpu(), keccak_kernels.absorb_plain(planes, out_words))


# K2's select variant: per-row message lengths over 1, 2 and 7 blocks (the
# ring wraps), rows ending in every block, at the rate's edges and at 0.
@pytest.mark.parametrize("blocks", [1, 2, 7])
@pytest.mark.parametrize("batch", [3, 8, 257, 1024])
def test_absorb_select_kernel_matches_plain(card, batch, blocks):
    rng = np.random.default_rng([batch, blocks, 1])
    width = 168 * blocks - 1
    lens = rng.integers(0, width + 1, batch)
    lens[: min(batch, 4)] = [0, width, 167, 168][: min(batch, 4)] if blocks > 1 else [0, width, 100, 1][: min(batch, 4)]
    msgs = torch.from_numpy(rng.integers(0, 256, (batch, width), dtype=np.uint8))
    msgs[torch.arange(width)[None, :] >= torch.from_numpy(lens)[:, None]] = 0
    lens_t = torch.from_numpy(lens)
    planes = keccak_kernels.rows_to_planes(storage(keccak.bytes_to_words(keccak.select_pad(msgs, 1, lens_t))))
    last = (lens_t // 168).to(torch.int32)
    before = keccak_kernels.absorb_select.launches
    got = keccak_kernels.absorb_select(planes.to(card), last.to(card), 4)
    torch.cuda.synchronize()
    assert keccak_kernels.absorb_select.launches == before + 1
    want = keccak_kernels.absorb_select_plain(planes, last, 4)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(
        keccak.words_to_bytes(want.long().transpose(0, 1) & 0xFFFFFFFF),
        keccak.turboshake128_batch_select(msgs, 1, 16, lens_t),
    )


# The SumVec100k chains at a small batch: 9,525 absorbed blocks (the ring
# wraps 2,381 times) and 400,000 squeezed words (9,523 * 42 + 34, so the
# last block is partial); the plain version runs on the host.
@pytest.mark.parametrize("kernel", ["absorb", "squeeze"])
def test_keccak_long_chain_matches_plain(card, kernel):
    rng = np.random.default_rng(9525)
    if kernel == "absorb":
        msg = _message_planes(rng, 9525 * 42, 5)
        got = keccak_kernels.absorb(msg.to(card), 4)
        want = keccak_kernels.absorb_plain(msg, 4)
    else:
        msg = _message_planes(rng, 42, 5)
        got = keccak_kernels.squeeze(msg.to(card), 400000)
        want = keccak_kernels.squeeze_plain(msg, 400000)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# K3 and K5 at the edges of their layouts (K3: a column a thread; K5: 5
# columns a thread, 64 tiles a block, the calls split over a cluster of
# blocks where the batch is small): chunk below, at and one past K5's tile,
# chunk 1, chunk 316 with a last call of 144 columns (meas_len 100000) or
# 76 (1024), chunk 400 over two blocks of tiles, ragged batches.
@pytest.mark.parametrize("meas_len,chunk,batch", [
    (10, 3, 5), (1024, 316, 300), (14, 4, 33), (17, 5, 130), (6, 1, 33), (1024, 316, 1), (100000, 316, 33),
])
def test_wire_kernel_matches_plain(card, meas_len, chunk, batch):
    rng = np.random.default_rng(chunk)
    f = TField(Field128)
    calls = -(-meas_len // chunk)
    plen = 2 * chunk + 1

    def planes(*shape):
        return storage(_words(rng, shape)).contiguous()

    args = (planes(meas_len * 4, batch), planes(plen * 4, batch), planes(chunk, 4, batch),
            planes(calls, 4, batch), planes(calls, 4, batch), planes(4, batch), planes(4, batch))
    before = flp_kernels.wire_evals.launches
    ev, od = flp_kernels.wire_evals(f, meas_len, chunk, *(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert flp_kernels.wire_evals.launches == before + 1
    pev, pod = flp_kernels.wire_evals_plain(f, meas_len, chunk, *args)
    assert torch.equal(ev.cpu(), pev) and torch.equal(od.cpu(), pod)


@pytest.mark.parametrize("meas_len,chunk,batch", [
    (10, 3, 5), (100000, 316, 130), (20, 4, 33), (30, 5, 1), (33, 6, 130), (7, 1, 33), (100000, 316, 1),
    (2000, 400, 33),
])
def test_sumvec_kernel_matches_plain(card, meas_len, chunk, batch):
    rng = np.random.default_rng(meas_len)
    f = TField(Field128)
    calls = -(-meas_len // chunk)

    def planes(elems):  # canonical elements (top bit clear), as (elems, 4, B)
        w = _words(rng, (elems, 4, batch))
        w[:, 3] >>= 1
        return storage(w).contiguous()

    args = (planes(meas_len).reshape(-1, batch), planes(2 * chunk).reshape(-1, batch), planes(calls),
            planes(calls), planes(1)[0], planes(1)[0])
    before = flp_kernels.sumvec_wires.launches
    ev, od = flp_kernels.sumvec_wires(f, meas_len, chunk, *(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert flp_kernels.sumvec_wires.launches == before + 1
    pev, pod = flp_kernels.sumvec_wires_plain(f, meas_len, chunk, *(a.to(card) for a in args))
    assert torch.equal(ev, pev) and torch.equal(od, pod)


# K4 at the edges of its layout: a lane a report, 32 reports a block, our
# wires read 16 bytes at a time and shared within a group of 4 lanes.
# B = 1, 5 and 33 are not multiples of 4 and take the word-at-a-time loads;
# 33 and 4100 leave a ragged block (4100 in the 16-byte path); chunk 316
# fills the 32 column slices of a block nearly ten times; the misaligned
# case covers peer rows that are not 16-byte aligned.
@pytest.mark.parametrize(
    "chunk,batch,misaligned",
    [(3, 1, False), (3, 5, False), (17, 33, False), (17, 128, False), (316, 128, False),
     (316, 4096, False), (316, 4100, False), (316, 4096, True)],
)
def test_combine_kernel_matches_plain(card, chunk, batch, misaligned):
    rng = np.random.default_rng([chunk, batch])
    f = TField(Field128)

    def canonical(*shape):
        w = _words(rng, shape)
        w[..., -1, :] >>= 1  # canonical wires
        return w

    he, ho = (storage(canonical(chunk, 4, batch)).contiguous().to(card) for _ in range(2))
    pv = canonical(batch, 4, 2 * chunk + 2).transpose(1, 2).contiguous()  # rows (B, VER, 4)
    if misaligned:
        flat = torch.zeros(pv.numel() + 1, dtype=torch.int64, device=card)
        flat[1:] = pv.reshape(-1).to(card)
        pv = flat[1:].view(pv.shape)
        assert pv.data_ptr() % 16 == 8
    pv = pv.to(card)
    before = flp_kernels.combine_decide.launches
    g = flp_kernels.combine_decide(f, chunk, he, ho, pv)
    torch.cuda.synchronize()
    assert flp_kernels.combine_decide.launches == before + 1
    assert torch.equal(g, flp_kernels.combine_decide_plain(f, chunk, he, ho, pv))


def test_wrappers_raise_for_card_tensors_without_the_library(card, monkeypatch):
    """No fallback: with the library failing to load, a tensor on the card
    raises and the plain version never runs."""
    from janus_tpu_torch import _build

    def no_library(name):
        raise _build.BuildError(f"no library for {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(flp_kernels, "combine_decide_plain", no_plain)
    monkeypatch.setattr(flp_kernels, "sumvec_wires_plain", no_plain)
    monkeypatch.setattr(keccak_kernels, "squeeze_plain", no_plain)
    monkeypatch.setattr(keccak_kernels, "absorb_plain", no_plain)
    monkeypatch.setattr(keccak_kernels, "absorb_select_plain", no_plain)
    f = TField(Field128)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=card)  # noqa: E731
    with pytest.raises(_build.BuildError):
        keccak_kernels.squeeze(z(42, 5), 4)
    with pytest.raises(_build.BuildError):
        keccak_kernels.absorb(z(84, 5), 4)
    with pytest.raises(_build.BuildError):
        keccak_kernels.absorb_select(z(84, 5), z(5), 4)
    with pytest.raises(_build.BuildError):
        flp_kernels.combine_decide(f, 3, z(3, 4, 5), z(3, 4, 5), z(5, 8, 4).long())
    with pytest.raises(_build.BuildError):
        flp_kernels.sumvec_wires(f, 10, 3, z(40, 5), z(24, 5), z(4, 4, 5), z(4, 4, 5), z(4, 5), z(4, 5))


def _served_pairs_match_oracle(vdaf, measure):
    from janus_tpu_torch.vdaf.backend import CudaBackend, OracleBackend

    rng = np.random.default_rng(0)
    reports = []
    for _ in range(6):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(measure(rng), nonce, rng.bytes(vdaf.RAND_SIZE))
        reports.append((nonce, public, shares))
    backend, oracle = CudaBackend(vdaf), OracleBackend(vdaf)
    vk = bytes(16)
    for agg_id in (0, 1):
        rows = [(n, p, s[agg_id]) for n, p, s in reports]
        got = backend.prep_init_batch(vk, agg_id, rows)
        want = oracle.prep_init_batch(vk, agg_id, rows)
        assert [p.verifiers_share for _, p in got] == [p.verifiers_share for _, p in want]
        assert [s.out_share for s, _ in got] == [s.out_share for s, _ in want]


def test_cuda_backend_matches_oracle(card):
    from janus_tpu_torch.vdaf.instances import prio3_histogram

    _served_pairs_match_oracle(prio3_histogram(10, 3), lambda rng: int(rng.integers(0, 10)))


def test_cuda_backend_sumvec_matches_oracle(card):
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    _served_pairs_match_oracle(prio3_sum_vec(10, 1, 3), lambda rng: [int(x) for x in rng.integers(0, 2, 10)])


def test_cuda_backend_count_matches_oracle(card):
    """Prio3Count (Field64) served on the row path on the card."""
    from janus_tpu_torch.vdaf.instances import prio3_count

    _served_pairs_match_oracle(prio3_count(), lambda rng: int(rng.integers(0, 2)))


@pytest.mark.parametrize("bits", [8, 32])
def test_cuda_backend_sum_matches_oracle(card, bits):
    """Prio3Sum on the row path on the card (Sum(32): P = 64, the NTT and
    baby-step/giant-step)."""
    from janus_tpu_torch.vdaf.instances import prio3_sum

    _served_pairs_match_oracle(prio3_sum(bits), lambda rng: int(rng.integers(0, 1 << bits)))


def test_cuda_backend_sumvec_bits_above_one_matches_oracle(card):
    """Prio3SumVec(10, 3, 4) on the row path on the card."""
    from janus_tpu_torch.vdaf.instances import prio3_sum_vec

    _served_pairs_match_oracle(prio3_sum_vec(10, 3, 4), lambda rng: [int(x) for x in rng.integers(0, 8, 10)])


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "sum16", "sum5", "sum70000"])
def test_field64_plain_ops_on_the_card_match_the_cpu(card, op):
    """Field64's plain ops as CUDA int64 tensors: a 32x32 product that wraps
    past 2^63 must keep the CPU's bit pattern.  Operands span every u32
    limb value, with the largest words and p - 1 among them."""
    from janus_tpu_torch.fields import Field64

    f = TField(Field64)
    rng = np.random.default_rng(64)
    count = 70000 if op == "sum70000" else 4096
    w = _words(rng, (2, count, 2))
    w[:, :8] = torch.tensor([[0, 0xFFFFFFFF]] * 8)  # p - 1 = 2^64 - 2^32
    w[:, 8:16] = torch.tensor([[0xFFFFFFFF, 0xFFFFFFFE]] * 8)  # p - 2
    a, b = (f.add(x, torch.zeros_like(x)) for x in w)  # canonical: one conditional subtraction of p
    if op.startswith("sum"):
        n = int(op[3:])
        x = a[: (count // n) * n].reshape(-1, n, 2)
        got, want = f.sum(x.to(card), axis=1), f.sum(x, axis=1)
    else:
        got, want = getattr(f, op)(a.to(card), b.to(card)), getattr(f, op)(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize(
    "desc,measure",
    [
        ({"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": "BitSize16", "length": 3},
         lambda r: [float(x) for x in r.choice([-0.25, 0.0, 0.5], 3)]),
        ({"type": "Prio3SumVecField64MultiproofHmacSha256Aes128", "proofs": 2, "length": 4, "bits": 1,
          "chunk_length": 2}, lambda r: [int(x) for x in r.integers(0, 2, 4)]),
    ],
    ids=["fixedpoint", "multiproof"],
)
def test_served_on_the_card_matches_the_cpu(card, desc, measure):
    """FixedPointBoundedL2VecSum(16, 3) (``CudaBackend``, the multi-gadget
    row path) and the HMAC multiproof SumVec(4, 1, 2) at 2 proofs
    (``HybridXofBackend``, its FLP on the card), each ``make_backend``'s
    choice on the card and on the CPU, at B = 64 with 2 tampered rows: every
    prepare share, out share and decision of the card equals the CPU's, and
    exactly the tampered rows are rejected."""
    from janus_tpu_torch.datastore.task import vdaf_verify_key_length
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    vdaf = vdaf_from_instance(desc)
    rng = np.random.default_rng(64)
    reports = []
    for i in range(64):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(measure(rng), nonce, rng.bytes(vdaf.RAND_SIZE))
        if i in (5, 40):
            lead = shares[0]
            bad = [(lead.meas_share[0] + 1) % vdaf.flp.field.MODULUS] + list(lead.meas_share[1:])
            shares = [Prio3InputShare(bad, lead.proofs_share, None, lead.joint_rand_blind), shares[1]]
        reports.append((nonce, public, shares))
    vk = bytes(range(vdaf_verify_key_length(desc)))
    on_card, on_cpu = make_backend(vdaf, device=card), make_backend(vdaf, device="cpu")
    assert type(on_card) is type(on_cpu) and on_card.bp.device.type == "cuda"
    got, want = {}, {}
    for agg_id in (0, 1):
        rows = [(nonce, public, shares[agg_id]) for nonce, public, shares in reports]
        got[agg_id] = on_card.prep_init_batch(vk, agg_id, rows)
        want[agg_id] = on_cpu.prep_init_batch(vk, agg_id, rows)
        assert [s.encode(vdaf) for _, s in got[agg_id]] == [s.encode(vdaf) for _, s in want[agg_id]]
        assert [st.out_share for st, _ in got[agg_id]] == [st.out_share for st, _ in want[agg_id]]
    pairs = [[got[0][b][1], got[1][b][1]] for b in range(64)]
    msgs, cpu_msgs = on_card.prep_shares_to_prep_batch(pairs), on_cpu.prep_shares_to_prep_batch(pairs)
    assert [m if isinstance(m, bytes) else type(m) for m in msgs] == [
        m if isinstance(m, bytes) else type(m) for m in cpu_msgs
    ]
    assert [b for b, m in enumerate(msgs) if not isinstance(m, bytes)] == [5, 40]
    assert on_card.oracle_recompute_rows == 0


@pytest.mark.parametrize("circuit", ["count", "sum32"])
def test_row_path_on_the_card_matches_the_cpu(card, circuit):
    """prep_init on the card against prep_init on the CPU at B = 1024
    (Count in Field64, Sum(32) with its NTT): 32 sharded reports staged by
    the backend and tiled, every output equal."""
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.instances import prio3_count, prio3_sum

    vdaf = prio3_count() if circuit == "count" else prio3_sum(32)
    rng = np.random.default_rng(1024)
    reports = []
    for _ in range(32):
        nonce = rng.bytes(16)
        m = int(rng.integers(0, 2 if circuit == "count" else 1 << 32))
        reports.append((nonce, *vdaf.shard(m, nonce, rng.bytes(vdaf.RAND_SIZE))))
    host = CudaBackend(vdaf, device="cpu")
    dev = CudaBackend(vdaf, device=card).bp
    for agg_id in (0, 1):
        rows = [(nonce, public, shares[agg_id]) for nonce, public, shares in reports]
        placed = host.stage_prep_init_multi(agg_id, [(bytes(16), rows)]).placed
        kw = {k: v.repeat((32,) + (1,) * (v.dim() - 1)) for k, v in placed.items()}
        vk, nonces = kw.pop("verify_key_u8"), kw.pop("nonces_u8")
        assert dev.prep_route(agg_id, 1024) == "prep_init"
        got = dev.prep_init(agg_id, vk.to(card), nonces.to(card), **{k: v.to(card) for k, v in kw.items()})
        want = host.bp.prep_init(agg_id, vk, nonces, **kw)
        torch.cuda.synchronize()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (agg_id, k)


def test_executor_resident_flush_on_the_card(card):
    """A 64-row Histogram(1024, 316) flush of both sides through the
    executor with the accumulator at its default budget (a quarter of the
    card's memory): no out-share row is read back, nothing is evicted, and
    each side's drained aggregate equals ``aggregate_batch`` over the same
    flush's out shares read back (the backend's non-resident launch)."""
    import asyncio

    from janus_tpu_torch.executor import KIND_PREP_INIT, AccumulatorConfig, DeviceExecutor, ExecutorConfig
    from janus_tpu_torch.vdaf.backend import make_backend, vdaf_shape_key
    from janus_tpu_torch.vdaf.instances import prio3_histogram
    from janus_tpu_torch.vdaf.prio3 import Prio3InputShare

    vdaf = prio3_histogram(1024, 316)
    rng = np.random.default_rng(64)
    reports = []
    for _ in range(4):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(int(rng.integers(0, 1024)), nonce, rng.bytes(vdaf.RAND_SIZE))
        shares[0] = Prio3InputShare.decode(vdaf, 0, shares[0].encode(vdaf))
        reports.append((nonce, public, shares))
    vk = bytes(16)
    ex = DeviceExecutor(ExecutorConfig(flush_max_rows=64, accumulator=AccumulatorConfig(enabled=True)))
    try:
        for agg_id in (0, 1):
            backend = make_backend(vdaf, "cuda")
            rows = [(n, p, s[agg_id]) for n, p, s in reports] * 16
            out = asyncio.run(
                ex.submit(vdaf_shape_key(vdaf), KIND_PREP_INIT, (vk, rows), backend=backend, agg_id=agg_id,
                          retain_out_shares=True)
            )
            ex.accumulator.commit_rows((agg_id,), backend, [st.out_share for st, _ in out], job_token=b"job",
                                       report_ids=[r[0] for r in rows])
            drained, _ = ex.accumulator.drain((agg_id,), vdaf.flp.field)
            assert backend.outshare_readback_rows == 0
            plain = backend.prep_init_batch(vk, agg_id, rows)
            f = backend.bp.f
            limbs = f.to_limbs([x for st, _ in plain for x in st.out_share]).reshape(64, 1024, f.n)
            assert drained == backend.aggregate_batch(limbs, np.ones(64, dtype=bool))
        store = ex.accumulator
        assert store.byte_budget == torch.cuda.get_device_properties(0).total_memory // 4
        assert store.evictions == 0
    finally:
        ex.shutdown()


@pytest.mark.parametrize(
    "family",
    [
        ("count", {"type": "Prio3Count"}, lambda r: int(r.integers(0, 2)), sum, ("keccak_squeeze",)),
        ("sum", {"type": "Prio3Sum", "bits": 8}, lambda r: int(r.integers(0, 256)), sum,
         ("keccak_squeeze", "keccak_absorb")),
        ("histogram", {"type": "Prio3Histogram", "length": 6, "chunk_length": 2}, lambda r: int(r.integers(0, 6)),
         lambda valid: np.bincount(valid, minlength=6).tolist(), ("keccak_squeeze", "keccak_absorb", "flp_wire_evals")),
        # SumVec(10, 1, 3) resolves to its bucket's twin, SumVec(12, 1, 3);
        # a flush of this one task runs its own planar prepare (K5)
        ("sumvec", {"type": "Prio3SumVec", "length": 10, "bits": 1, "chunk_length": 3},
         lambda r: [int(x) for x in r.integers(0, 2, 10)], lambda valid: np.sum(valid, axis=0).tolist(),
         ("keccak_squeeze", "keccak_absorb", "flp_sumvec_wires")),
    ],
    ids=lambda f: f[0],
)
def test_small_pair_on_the_card(card, family):
    """The leader/helper pair of ``chip_smoke.py`` phase 13 (in-process
    transport, each side its own executor and accumulator, ``CudaBackend``
    on the card) at small widths: 6 reports, one tampered; the aggregate is
    exact, no out share is read back or recomputed, no oracle serves a row,
    every leader row is marshalled from its bytes and the family's kernels
    launch (``pair_run`` raises otherwise)."""
    import chip_smoke
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    name, desc, measure, expect, needs = family
    rng = np.random.default_rng(6)
    reports, meas = chip_smoke.shard_reports(vdaf_from_instance(desc), rng, measure, 6)
    rec = chip_smoke.pair_run(name, desc, list(zip(meas, reports)), [False] * 5 + [True], expect, bytes(16), needs)
    assert rec["report_count"] == 5


def test_absorb_select_refuses_out_of_range_final_blocks(card):
    """A final block outside the message raises the plain version's
    ValueError on the card too (the kernel would leave such a row unwritten),
    and launches nothing."""
    msg = torch.zeros((84, 3), dtype=torch.int32)
    before = keccak_kernels.absorb_select.launches
    for bad in ([0, 2, 1], [0, -1, 1]):
        last = torch.tensor(bad, dtype=torch.int32)
        with pytest.raises(ValueError, match="final block") as plain:
            keccak_kernels.absorb_select(msg, last, 4)
        with pytest.raises(ValueError) as on_card:
            keccak_kernels.absorb_select(msg.to(card), last.to(card), 4)
        assert str(on_card.value) == str(plain.value)
    assert keccak_kernels.absorb_select.launches == before


@pytest.mark.parametrize("agg_id", [0, 1])
def test_canonical_one_shape_flush_runs_its_own_kernels(card, agg_id):
    """A flush of Histogram(7, 3) alone on its bucket's twin runs the task's
    own planar prepare on the card: K3 launches, K2's select variant does
    not, and every output equals the CPU's."""
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.canonical import canonical_vdaf_for
    from janus_tpu_torch.vdaf.instances import prio3_histogram

    vdaf = prio3_histogram(7, 3)
    rng = np.random.default_rng(10 + agg_id)
    rows = []
    for _ in range(40):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(int(rng.integers(0, 7)), nonce, rng.bytes(vdaf.RAND_SIZE))
        rows.append((nonce, public, shares[agg_id]))
    reqs = [(bytes(16), rows, vdaf)]
    on_card = CudaBackend(canonical_vdaf_for(vdaf), device=card, canonical=True)
    on_cpu = CudaBackend(canonical_vdaf_for(vdaf), device="cpu", canonical=True)
    wire, select = flp_kernels.wire_evals.launches, keccak_kernels.absorb_select.launches
    got = on_card.launch_prep_init_multi(on_card.stage_prep_init_multi(agg_id, reqs), reqs)[0]
    assert flp_kernels.wire_evals.launches > wire and keccak_kernels.absorb_select.launches == select
    want = on_cpu.launch_prep_init_multi(on_cpu.stage_prep_init_multi(agg_id, reqs), reqs)[0]
    assert [s.encode(vdaf) for _, s in got] == [s.encode(vdaf) for _, s in want]
    assert [st.out_share for st, _ in got] == [st.out_share for st, _ in want]


@pytest.mark.parametrize("agg_id", [0, 1])
def test_canonical_twin_on_the_card_matches_the_cpu(card, agg_id):
    """Histogram(7, 3) and (8, 3) in one flush on their twin Histogram(9,
    3), ``CudaBackend(canonical=True)`` on the card and on the CPU at B = 64:
    every prepare share and out share equal, each at its task's length; the
    masked row path launches the K2 select kernel, which equals its plain
    version at that flush's joint-rand-part shape."""
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.canonical import canonical_vdaf_for
    from janus_tpu_torch.vdaf.instances import prio3_histogram

    tasks = [prio3_histogram(7, 3), prio3_histogram(8, 3)]
    twin = canonical_vdaf_for(tasks[0])
    rng = np.random.default_rng(agg_id)
    reqs = []
    for i, vdaf in enumerate(tasks):
        rows = []
        for _ in range(32):
            nonce = rng.bytes(16)
            public, shares = vdaf.shard(int(rng.integers(0, vdaf.flp.valid.length)), nonce, rng.bytes(vdaf.RAND_SIZE))
            rows.append((nonce, public, shares[agg_id]))
        reqs.append((bytes([i]) * 16, rows, vdaf))
    on_card, on_cpu = CudaBackend(twin, device=card, canonical=True), CudaBackend(twin, device="cpu", canonical=True)
    before = keccak_kernels.absorb_select.launches
    got = on_card.launch_prep_init_multi(on_card.stage_prep_init_multi(agg_id, reqs), reqs)
    assert keccak_kernels.absorb_select.launches == before + 1
    want = on_cpu.launch_prep_init_multi(on_cpu.stage_prep_init_multi(agg_id, reqs), reqs)
    for vdaf, g_task, w_task in zip(tasks, got, want):
        assert [s.encode(vdaf) for _, s in g_task] == [s.encode(vdaf) for _, s in w_task]
        assert [st.out_share for st, _ in g_task] == [st.out_share for st, _ in w_task]
        assert all(len(st.out_share) == vdaf.flp.OUTPUT_LEN for st, _ in g_task)
    staged = on_cpu.stage_prep_init_multi(agg_id, reqs)
    kw = staged.placed
    bp = on_cpu.bp
    if agg_id == 0:
        meas = kw["meas_limbs"].reshape(64, -1)
    else:
        meas = storage(bp.helper_shares(agg_id, kw["share_seeds_u8"])[0].reshape(64, -1))
    ml = kw["meas_len"].long()
    msg = bp._jr_part_message(agg_id, kw["blinds_u8"], kw["nonces_u8"], keccak_kernels.rows_to_planes(meas), ml)
    last = ((bp._jr_part_head_len(kw["blinds_u8"], kw["nonces_u8"]) + 4 * bp.f.n * ml) // 168).to(torch.int32)
    assert torch.equal(
        keccak_kernels.absorb_select(msg.to(card), last.to(card), 4).cpu(), keccak_kernels.absorb_select_plain(msg, last, 4)
    )


def _poplar_rows(bits, count, seed):
    import random

    from janus_tpu_torch.vdaf.poplar1 import Poplar1

    vdaf = Poplar1(bits)
    rng = random.Random(seed)
    rows = []
    for _ in range(count):
        nonce = rng.randbytes(16)
        public, shares = vdaf.shard(rng.randrange(1 << bits), nonce, rng.randbytes(vdaf.RAND_SIZE))
        rows.append((nonce, public, shares))
    return vdaf, rows


@pytest.mark.parametrize("bits,level,prefixes", [(8, 4, 16), (8, 7, 32), (64, 63, 8)])
def test_poplar1_card_walk_matches_the_host_walk(card, bits, level, prefixes):
    """Poplar1's card walk (AES and sketch on the card) against the host
    walk on the CPU on every row of both sides, at Field64 levels and at
    the leaf (Field255), over ``prefixes`` distinct prefixes spread over
    the level, with no row sent to the oracle."""
    from janus_tpu_torch.ops.poplar1_batch import BatchedPoplar1
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

    vdaf, rows = _poplar_rows(bits, 64, seed=bits + level)
    step = (1 << (level + 1)) // prefixes
    ap = Poplar1AggregationParam(level, tuple(range(step // 2, 1 << (level + 1), step)))
    assert len(ap.prefixes) == prefixes
    on_card = make_backend(vdaf, "cuda", device=card)
    on_host = BatchedPoplar1(vdaf, device="cpu")
    for a in (0, 1):
        reports = [(n, p, s[a]) for n, p, s in rows]
        got = on_card.prep_init_batch_poplar(b"\x2a" * 16, a, ap, reports)
        want = on_host.prep_init_batch_host(b"\x2a" * 16, a, ap, reports)
        for (gs, gsh), (ws, wsh) in zip(got, want):
            assert gsh.encode() == wsh.encode() and gs.y_flat == ws.y_flat
    assert on_card.oracle_recompute_rows == 0 and on_card.oracle.rows["init"] == 0


def test_poplar1_resident_executor_flush_on_the_card(card):
    """One poplar_init flush of the card walk with the accumulator keeps
    its sketch vectors on the card (ResidentRefs, no readback), and the
    committed rows drain to the host walk's sum."""
    import asyncio

    from janus_tpu_torch.executor import (
        KIND_POPLAR_INIT,
        AccumulatorConfig,
        DeviceExecutor,
        ExecutorConfig,
        ResidentRef,
    )
    from janus_tpu_torch.vdaf.backend import make_backend, vdaf_shape_key
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

    vdaf, rows = _poplar_rows(16, 64, seed=3)
    ap = Poplar1AggregationParam(15, tuple(sorted({m for m in range(0, 1 << 16, 4096)})))
    backend = make_backend(vdaf, "cuda", device=card)
    reports = [(n, p, s[0]) for n, p, s in rows]
    ex = DeviceExecutor(ExecutorConfig(accumulator=AccumulatorConfig(enabled=True, drain_interval_s=3600.0)))

    async def go():
        return await asyncio.gather(*[
            ex.submit(vdaf_shape_key(vdaf), KIND_POPLAR_INIT, (b"\x2a" * 16, ap, reports[j::4]), backend=backend,
                      agg_id=0, retain_out_shares=True, agg_param_key=ap.level)
            for j in range(4)
        ])

    try:
        outs = [o for job in asyncio.run(go()) for o in job]
        refs = [st.y_flat for st, _sh in outs]
        assert all(isinstance(r, ResidentRef) for r in refs)
        store = ex.accumulator
        store.commit_rows(("t",), backend, refs, job_token=0, report_ids=[bytes([i]) for i in range(len(refs))])
        got = store.drain(("t",), vdaf.field_for_agg_param(ap))[0]
    finally:
        ex.shutdown()
    order = [r for j in range(4) for r in reports[j::4]]
    want = [0] * len(ap.prefixes)
    field = vdaf.field_for_agg_param(ap)
    for st, _sh in backend.bp.prep_init_batch_host(b"\x2a" * 16, 0, ap, order):
        want = field.vec_add(want, st.y_flat)
    assert got == want and backend.sketch_readback_rows == 0


def test_binaries_fleet_on_the_card(card, monkeypatch):
    """``chip_smoke.py`` phase 18 at a small width: five binaries of
    ``python -m janus_tpu_torch.binaries`` serve Histogram(8, 3) on the
    card over localhost HTTP; the aggregate is exact, every gate of the
    phase holds (no replay, no journal row left, cuda prepares, the kernels
    of the path launched after the warmup, SIGTERM exits 0).  Under the
    reference's default canonical shapes Histogram(8, 3) resolves to its
    twin Histogram(9, 3); its flushes hold this one task, so they run its
    own planar prepare: K3 launches, K2's select variant does not."""
    import chip_smoke

    small = {"LENGTH": 8, "CHUNK": 3, "FLEET_REPORTS": 48, "FLEET_TAMPERED": 2, "FLEET_SHARD_WORKERS": 2,
             "FLEET_WARMUP_ROWS": 64, "FLEET_JOB_SIZE": 16}
    for name, value in small.items():
        monkeypatch.setattr(chip_smoke, name, value)
    rec = chip_smoke.binaries_phase(1, b"\x2a" * 16, chip_smoke.histogram_shard_job(1, 0, 24, 8, 3), {})
    assert rec["journal_replays"] == 0 and rec["jobs"] >= 1
    assert rec["journal_drains"] == rec["journal_rows"] == rec["journaled_jobs"] >= 1
    for side in ("driver", "helper"):
        launches = rec["launches"][side]
        assert launches["flp_wire_evals"] > 0 and launches["keccak_absorb_select"] == 0, (side, launches)


def _field_operand(f, shape, seed, fill=None):
    """(..., n) canonical limbs (int64 words), random below p or all ``fill``."""
    if fill is not None:
        return torch.from_numpy(f._int_to_limbs_np(fill).astype(np.int64)).expand(shape + (f.n,)).contiguous()
    x = _words(np.random.default_rng(seed), shape + (f.n,))
    x[..., -1] >>= 1
    return x


@pytest.mark.parametrize("name", ["Field64", "Field128"])
@pytest.mark.parametrize("shape", [(3, 7, 5, 2), (8, 317, 316, 1), (4, 1023, 1, 317)])
def test_digit_reduce_kernel_matches_plain(card, name, shape):
    """The limb-digit matmul's reduce kernel (``csrc/field_dot.cu``) against
    its plain version on the digit products of random and of
    carry-saturating operands (every element p - 1), at a small shape, the
    SumVec100k wire fold's and its gadget outputs'; the whole contraction on
    the card against the CPU's."""
    from janus_tpu_torch import fields
    from janus_tpu_torch.ops import field_kernels

    f = TField(getattr(fields, name))
    B, K, M, N = shape
    D = 4 * f.n
    for fill in (None, f.p - 1):
        a, b = _field_operand(f, (B, K, M), 1, fill), _field_operand(f, (B, K, N), 2, fill)
        lhs, rhs = f.digit_operands(a.to(card), b.to(card))
        P = torch.matmul(lhs, rhs).reshape(B, M, D, N, D)
        before = field_kernels.lazy_reduce_digits.launches
        got = field_kernels.lazy_reduce_digits(f, P)
        torch.cuda.synchronize()
        assert field_kernels.lazy_reduce_digits.launches == before + 1
        assert torch.equal(got, field_kernels.lazy_reduce_digits_plain(f, P))
        assert torch.equal(f.mat_mul_mont(a.to(card), b.to(card)).cpu(), f.mat_mul_mont(a, b))


@pytest.mark.parametrize("which", ["count", "sum8", "histogram40x7", "sumvec20x3x4"])
def test_mxu_prepare_on_the_card_matches_the_cpu(card, which):
    """``BatchedPrio3(field_backend="mxu").prep_init`` of both sides on the
    card against the CPU's and the vpu route's, the reduce kernel launched."""
    from janus_tpu_torch.ops import field_kernels
    from janus_tpu_torch.ops.prepare import BatchedPrio3
    from janus_tpu_torch.vdaf.backend import CudaBackend
    from janus_tpu_torch.vdaf.instances import prio3_count, prio3_histogram, prio3_sum, prio3_sum_vec

    rng = np.random.default_rng(5)
    vdaf, measure = {
        "count": (prio3_count(), lambda: int(rng.integers(0, 2))),
        "sum8": (prio3_sum(8), lambda: int(rng.integers(0, 256))),
        "histogram40x7": (prio3_histogram(40, 7), lambda: int(rng.integers(0, 40))),
        "sumvec20x3x4": (prio3_sum_vec(20, 3, 4), lambda: [int(x) for x in rng.integers(0, 8, 20)]),
    }[which]
    reports = []
    for _ in range(8):
        nonce = rng.bytes(16)
        reports.append((nonce,) + tuple(vdaf.shard(measure(), nonce, rng.bytes(vdaf.RAND_SIZE))))
    for agg_id in (0, 1):
        rows = [(n, p, s[agg_id]) for n, p, s in reports]
        outs = {}
        for fb, dev in (("mxu", card), ("vpu", card), ("mxu", torch.device("cpu"))):
            backend = CudaBackend(vdaf, device=dev, field_backend=fb)
            kw = dict(backend.stage_prep_init_multi(agg_id, [(bytes(16), rows)]).placed)
            vk, nonces = kw.pop("verify_key_u8"), kw.pop("nonces_u8")
            before = field_kernels.lazy_reduce_digits.launches
            outs[fb, dev.type] = {k: v.cpu() for k, v in BatchedPrio3.prep_init(backend.bp, agg_id, vk, nonces, **kw).items()}
            launched = field_kernels.lazy_reduce_digits.launches - before
            assert launched > 0 if (fb, dev.type) == ("mxu", "cuda") else launched == 0
        for k, v in outs["mxu", "cuda"].items():
            assert torch.equal(v, outs["mxu", "cpu"][k]) and torch.equal(v, outs["vpu", "cuda"][k]), (agg_id, k)


def _mesh_reports(vdaf, count, measure, seed):
    rng = np.random.default_rng(seed)
    reports = []
    for _ in range(count):
        nonce = rng.bytes(16)
        public, shares = vdaf.shard(measure(rng), nonce, rng.bytes(vdaf.RAND_SIZE))
        reports.append((nonce, public, shares))
    return reports


def _mesh_matches_one_card(devices):
    """Histogram(10, 3) at 37 reports (padded to a multiple of the shard
    count; planar on every shard) on a mesh over ``devices``: both sides,
    the combine and the masked aggregate equal one ``CudaBackend``'s, and a
    resident flush drains the same aggregate with no out-share readback."""
    from janus_tpu_torch.executor import AccumulatorConfig, DeviceAccumulatorStore
    from janus_tpu_torch.vdaf.backend import CudaBackend, MeshBackend
    from janus_tpu_torch.vdaf.instances import prio3_histogram

    vdaf = prio3_histogram(10, 3)
    reports = _mesh_reports(vdaf, 37, lambda rng: int(rng.integers(0, 10)), 21)
    mesh, one = MeshBackend(vdaf, devices=devices), CudaBackend(vdaf)
    assert mesh._prep_fn(0, mesh._pad_to(37)).__name__ == "prep_init_planar"
    vk = bytes(range(16))
    sides = []
    for agg_id in (0, 1):
        rows = [(n, p, s[agg_id]) for n, p, s in reports]
        got, want = mesh.prep_init_batch(vk, agg_id, rows), one.prep_init_batch(vk, agg_id, rows)
        assert [p.encode(vdaf) for _, p in got] == [p.encode(vdaf) for _, p in want]
        assert [(s.out_share, s.corrected_joint_rand_seed) for s, _ in got] == [
            (s.out_share, s.corrected_joint_rand_seed) for s, _ in want]
        sides.append(got)
        store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
        staged = mesh.stage_prep_init_multi(agg_id, [(vk, rows)])
        assert [p["nonces_u8"].device for p in staged.placed] == [torch.device(d) for d in devices]
        read_back = mesh.outshare_readback_rows
        (out,) = mesh.launch_prep_init_multi(staged, [(vk, rows)], retain_store=store)
        store.commit_rows((agg_id,), mesh, [s.out_share for s, _ in out], job_token=1, report_ids=[r[0] for r in rows])
        assert mesh.outshare_readback_rows == read_back
        f = one.bp.f
        limbs = f.to_limbs([x for s, _ in want for x in s.out_share]).reshape(37, -1, f.n)
        assert store.drain((agg_id,), vdaf.flp.field)[0] == one.aggregate_batch(limbs, np.ones(37, dtype=bool))
        assert mesh.aggregate_batch(limbs, np.arange(37) % 2 == 0) == one.aggregate_batch(limbs, np.arange(37) % 2 == 0)
    pairs = [[sides[0][b][1], sides[1][b][1]] for b in range(37)]
    assert mesh.prep_shares_to_prep_batch(pairs) == one.prep_shares_to_prep_batch(pairs)


def test_mesh_of_two_logical_shards_on_one_card(card):
    _mesh_matches_one_card(["cuda:0", "cuda:0"])


def test_mesh_over_every_card(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards for a real mesh")
    _mesh_matches_one_card([f"cuda:{i}" for i in range(torch.cuda.device_count())])


def test_mesh_kernel_wrappers_launch_on_their_tensors_card(card):
    """Every kernel wrapper, given tensors on cuda:1 while cuda:0 is the
    current device, launches on cuda:1 (the C entry points launch on the
    runtime's current device) and equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from janus_tpu_torch import fields
    from janus_tpu_torch.ops import field_kernels

    other = torch.device("cuda:1")
    rng = np.random.default_rng(5)
    f = TField(Field128)

    def canonical(*shape):
        w = _words(rng, shape)
        w[..., -1, :] >>= 1
        return storage(w).contiguous()

    msg = _message_planes(rng, 42, 33)
    msgs2 = _message_planes(rng, 84, 33)
    last = torch.from_numpy(rng.integers(0, 2, 33).astype(np.int32))
    meas_len, chunk, B = 14, 4, 33
    calls = -(-meas_len // chunk)
    wire = (canonical(meas_len, 4, B).reshape(-1, B), canonical(2 * chunk + 1, 4, B).reshape(-1, B),
            canonical(chunk, 4, B), canonical(calls, 4, B), canonical(calls, 4, B), canonical(1, 4, B)[0],
            canonical(1, 4, B)[0])
    sumvec = (wire[0], wire[1][: 2 * chunk * 4], wire[3], wire[4], wire[5], wire[6])
    he, ho = canonical(chunk, 4, B), canonical(chunk, 4, B)
    pv = words(canonical(B, 4, 2 * chunk + 2)).transpose(1, 2).contiguous()
    f64 = TField(fields.Field64)
    a, b = _field_operand(f64, (2, 7, 5), 1), _field_operand(f64, (2, 7, 3), 2)
    lhs, rhs = f64.digit_operands(a, b)
    P = torch.matmul(lhs, rhs).reshape(2, 5, 8, 3, 8).contiguous()
    cases = [
        (keccak_kernels.squeeze, (msg, 50), keccak_kernels.squeeze_plain(msg, 50)),
        (keccak_kernels.absorb, (msgs2, 8), keccak_kernels.absorb_plain(msgs2, 8)),
        (keccak_kernels.absorb_select, (msgs2, last, 8), keccak_kernels.absorb_select_plain(msgs2, last, 8)),
        (lambda *x: flp_kernels.wire_evals(f, meas_len, chunk, *x), wire,
         flp_kernels.wire_evals_plain(f, meas_len, chunk, *wire)),
        (lambda *x: flp_kernels.sumvec_wires(f, meas_len, chunk, *x), sumvec,
         flp_kernels.sumvec_wires_plain(f, meas_len, chunk, *sumvec)),
        (lambda *x: flp_kernels.combine_decide(f, chunk, *x), (he, ho, pv),
         flp_kernels.combine_decide_plain(f, chunk, he, ho, pv)),
        (lambda x: field_kernels.lazy_reduce_digits(f64, x), (P,), field_kernels.lazy_reduce_digits_plain(f64, P)),
    ]
    with torch.cuda.device(0):
        for fn, args, want in cases:
            got = fn(*(x.to(other) if isinstance(x, torch.Tensor) else x for x in args))
            torch.cuda.synchronize(other)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(g.device == other for g in got)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        assert torch.cuda.current_device() == 0
