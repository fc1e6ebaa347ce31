"""The port's device-resident accumulator store
(janus_tpu_torch/executor/accumulator.py).

The store-level cases of tests/test_accumulator.py on the port's copy:
against a numpy stub backend (round trip, residency across flushes,
eviction under a tiny byte budget, a poisoned bucket, the spill and evict
faults, agg-param-keyed host buckets, the fair scheduler), then through
``CudaBackend(device="cpu")``: an executor flush keeps its out shares
resident (``outshare_readback_rows`` stays 0) and the drained aggregate
equals the JAX package's oracle.  The cases that need the driver or the
writer wait for the control-plane copy."""

import asyncio
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu_torch.core import faults
from janus_tpu_torch.core.faults import FaultSpec
from janus_tpu_torch.executor import (
    KIND_PREP_INIT,
    AccumulatorConfig,
    AccumulatorError,
    AccumulatorUnavailable,
    DeviceAccumulatorStore,
    DeviceExecutor,
    ExecutorConfig,
    ResidentRef,
)
from janus_tpu_torch.executor.accumulator import HOST_BYTE_BUDGET
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend, vdaf_shape_key


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


def _run(coro, timeout=120.0):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


class _Field:
    """Tiny exact field double: plain integer adds (values stay small)."""

    @staticmethod
    def vec_add(a, b):
        return [x + y for x, y in zip(a, b)]


class _AccumBackend:
    """Store seam double: numpy matrices, integer sums."""

    supports_resident_out_shares = True

    def __init__(self):
        self.vdaf = SimpleNamespace(flp=SimpleNamespace(OUTPUT_LEN=2, field=_Field))
        self.fail_accumulate = False

    def accumulate_rows(self, buffer, matrix, mask):
        if self.fail_accumulate:
            raise RuntimeError("device on fire")
        delta = np.asarray(matrix)[mask].sum(axis=0)
        return delta if buffer is None else buffer + delta

    def read_accum_buffer(self, buffer):
        return [int(x) for x in np.asarray(buffer)]


def _matrix(rows, base=1):
    """Row r holds [base*(r+1), base*(r+1)*10]: distinct, easy sums."""
    return np.array([[base * (r + 1), base * (r + 1) * 10] for r in range(rows)], dtype=np.int64)


# -- store semantics ---------------------------------------------------------


def test_commit_drain_round_trip_and_flush_lifecycle():
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    backend = _AccumBackend()
    m = _matrix(4)
    fid = store.retain_flush(backend, m, rows=4, nbytes=m.nbytes)
    store.commit_rows(
        ("bucket-a",), backend, [ResidentRef(fid, 0), ResidentRef(fid, 2)], job_token=b"job1", report_ids=[b"r0", b"r2"]
    )
    # rows 1 and 3 never finish: released, which frees the flush matrix
    store.release_refs([ResidentRef(fid, 1), ResidentRef(fid, 3)])
    assert store.stats()["flushes_resident"] == 0
    vector, rids = store.drain(("bucket-a",), _Field)
    assert vector == [1 + 3, 10 + 30] and rids == {b"r0", b"r2"}
    assert store.stats()["buckets"] == 0 and store.resident_bytes == 0
    assert store.drain(("bucket-a",), _Field) is None  # the delta never merges twice


@pytest.mark.parametrize("source", ["backend", "host", "config"])
def test_byte_budget_comes_from_the_minting_backend(source, caplog):
    """With no budget configured, the store takes the first minting
    backend's ``resident_byte_budget()`` (CudaBackend states a share of its
    card), else HOST_BYTE_BUDGET; a configured budget wins.  A flush
    larger than the budget in force is logged."""
    backend = _AccumBackend()
    if source == "backend":
        backend.resident_byte_budget = lambda: 48
    elif source == "host":
        backend.resident_byte_budget = lambda: None  # a backend off the card
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, byte_budget=40 if source == "config" else None))
    assert store.byte_budget == (40 if source == "config" else None)
    with caplog.at_level("WARNING", logger="janus_tpu_torch.accumulator"):
        store.retain_flush(backend, _matrix(4), rows=4, nbytes=64)
    want = {"backend": 48, "host": HOST_BYTE_BUDGET, "config": 40}[source]
    assert store.byte_budget == want and store.stats()["byte_budget"] == want
    assert ("exceeds the accumulator" in caplog.text) == (want < 64)


def test_cross_flush_residency_accumulates_across_commits():
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    backend = _AccumBackend()
    f1 = store.retain_flush(backend, _matrix(2), rows=2, nbytes=32)
    f2 = store.retain_flush(backend, _matrix(2, base=100), rows=2, nbytes=32)
    store.commit_rows(("b",), backend, [ResidentRef(f1, 0)], job_token=b"j1", report_ids=[b"a"])
    store.commit_rows(("b",), backend, [ResidentRef(f2, 1)], job_token=b"j2", report_ids=[b"b"])
    store.release_refs([ResidentRef(f1, 1), ResidentRef(f2, 0)])
    vector, rids = store.drain(("b",), _Field)
    assert vector == [1 + 200, 10 + 2000] and rids == {b"a", b"b"}


def test_eviction_under_tiny_byte_budget_stays_exact():
    """LRU eviction spills flush matrices and bucket buffers to host
    mirrors; sums stay exact and the eviction counter moves."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, byte_budget=40))
    backend = _AccumBackend()
    f1 = store.retain_flush(backend, _matrix(2), rows=2, nbytes=32)
    f2 = store.retain_flush(backend, _matrix(2, base=100), rows=2, nbytes=32)
    # the budget is blown: the next store op evicts LRU state first
    store.commit_rows(
        ("b",), backend, [ResidentRef(f1, 0), ResidentRef(f1, 1)], job_token=b"j1", report_ids=[b"a", b"b"]
    )
    assert store.evictions >= 1
    store.commit_rows(("b",), backend, [ResidentRef(f2, 0)], job_token=b"j2", report_ids=[b"c"])
    store.release_refs([ResidentRef(f2, 1)])
    vector, rids = store.drain(("b",), _Field)
    assert vector == [1 + 2 + 100, 10 + 20 + 1000] and rids == {b"a", b"b", b"c"}


def test_bucket_buffer_eviction_merges_host_and_device_state():
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, byte_budget=0))
    backend = _AccumBackend()
    f1 = store.retain_flush(backend, _matrix(1), rows=1, nbytes=8)
    store.commit_rows(("b",), backend, [ResidentRef(f1, 0)], job_token=b"j1", report_ids=[b"a"])
    bucket = store._buckets[("b",)]
    store._evict(bucket)  # force the buffer to its host mirror
    assert bucket.buffer is None and bucket.spilled_host == [1, 10]
    f2 = store.retain_flush(backend, _matrix(1, base=7), rows=1, nbytes=8)
    store.commit_rows(("b",), backend, [ResidentRef(f2, 0)], job_token=b"j2", report_ids=[b"b"])
    vector, rids = store.drain(("b",), _Field)
    assert vector == [1 + 7, 10 + 70] and rids == {b"a", b"b"}


def test_poisoned_bucket_discard_returns_journal_exactly_once():
    """A failed accumulate poisons the bucket; discard() hands back the
    journaled (job, rids) once and drops the device delta."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    backend = _AccumBackend()
    fid = store.retain_flush(backend, _matrix(2), rows=2, nbytes=32)
    store.commit_rows(("b",), backend, [ResidentRef(fid, 0)], job_token=b"j1", report_ids=[b"a"])
    backend.fail_accumulate = True
    with pytest.raises(AccumulatorUnavailable):
        store.commit_rows(("b",), backend, [ResidentRef(fid, 1)], job_token=b"j2", report_ids=[b"b"])
    with pytest.raises(AccumulatorUnavailable):
        store.drain(("b",), _Field)  # refuses rather than return a half sum
    journal = store.discard(("b",))
    assert [(tok, set(ids)) for tok, ids in journal] == [(b"j1", {b"a"})]
    assert store.discard(("b",)) == []
    assert store.stats()["buckets"] == 0


def test_injected_spill_fault_surfaces_as_unavailable():
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    backend = _AccumBackend()
    fid = store.retain_flush(backend, _matrix(1), rows=1, nbytes=8)
    store.commit_rows(("b",), backend, [ResidentRef(fid, 0)], job_token=b"j", report_ids=[b"a"])
    faults.configure([FaultSpec("accumulator.spill", "error", 1.0)], seed=7)
    with pytest.raises(AccumulatorUnavailable):
        store.drain(("b",), _Field)
    faults.clear()
    journal = store.discard(("b",))
    assert [set(ids) for _tok, ids in journal] == [{b"a"}]


def test_injected_evict_fault_fires_before_any_mutation():
    """An eviction fault leaves the commit cleanly un-applied: no journal
    entry, no half-updated buffer, the refs still live."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, byte_budget=8))
    backend = _AccumBackend()
    fid = store.retain_flush(backend, _matrix(2), rows=2, nbytes=32)
    faults.configure([FaultSpec("accumulator.evict", "error", 1.0)], seed=7)
    with pytest.raises(faults.FaultInjectedError):
        store.commit_rows(("b",), backend, [ResidentRef(fid, 0)], job_token=b"j", report_ids=[b"a"])
    faults.clear()
    assert ("b",) not in store._buckets
    assert store._flushes[fid].consumed == set()


def test_host_rows_level_keyed_buckets_never_merge_and_drain_all_spills():
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    base = ("leader", b"task", ("Poplar1", None), b"batch")
    k1, k2 = base + (b"\x00\x01prefixes",), base + (b"\x00\x02prefixes",)
    store.commit_host_rows(k1, _Field, [[1, 10], [2, 20]], job_token=b"j1", report_ids=[b"a", b"b"])
    store.commit_host_rows(k1, _Field, [[3, 30]], job_token=b"j2", report_ids=[b"c"])
    store.commit_host_rows(k2, _Field, [[100, 1]], job_token=b"j3", report_ids=[b"a"])
    assert store.stats()["buckets"] == 2
    spilled = {}
    store.drain_all(lambda key, vector, journal: spilled.update({key: (vector, journal)}))
    assert spilled[k1][0] == [6, 60] and [j for j, _ in spilled[k1][1]] == [b"j1", b"j2"]
    assert spilled[k2][0] == [100, 1] and [j for j, _ in spilled[k2][1]] == [b"j3"]
    assert store.stats()["buckets"] == 0


@pytest.mark.parametrize("case", ["poisoned", "mismatch"])
def test_host_rows_refusals(case):
    """A poisoned host bucket refuses commits and discard still returns its
    journal; one vector per report id is required."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    key = ("leader", b"t", ("Poplar1", None), b"b", b"\x00\x05p")
    if case == "mismatch":
        with pytest.raises(AccumulatorError):
            store.commit_host_rows(key, _Field, [[1]], job_token=b"j", report_ids=[b"a", b"b"])
        return
    store.commit_host_rows(key, _Field, [[5, 50]], job_token=b"j1", report_ids=[b"r"])
    with store._lock:
        store._buckets[key].poisoned = True
    with pytest.raises(AccumulatorUnavailable):
        store.commit_host_rows(key, _Field, [[7, 70]], job_token=b"j2", report_ids=[b"q"])
    assert [(j, set(r)) for j, r in store.discard(key)] == [(b"j1", {b"r"})]


# -- fair flush scheduling ---------------------------------------------------


class _GatedPrepBackend:
    """Stage/launch double with a launch gate and an order log."""

    def __init__(self, gate):
        self.vdaf = SimpleNamespace()
        self.gate = gate
        self.launch_order = []

    def stage_prep_init_multi(self, agg_id, requests, pad_to=None):
        rows = sum(len(r) for _, r in requests)
        return SimpleNamespace(agg_id=agg_id, placed=None, pad_to=rows, rows=rows) if rows else None

    def launch_prep_init_multi(self, staged, requests):
        assert self.gate.wait(10), "test launch gate never opened"
        self.launch_order.append(requests[0][0])
        return [[("prep", vk, i) for i in range(len(reports))] for vk, reports in requests]


@pytest.mark.parametrize("fair", [True, False])
def test_flush_scheduler(fair):
    """Four hot-bucket flushes are ready before the cold bucket's one: the
    deficit round-robin launches the cold flush ahead of the hot tail; the
    legacy FIFO mode launches in arrival order."""
    gate = threading.Event()
    backend = _GatedPrepBackend(gate)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=60.0, flush_max_rows=2, fair_quota_rows=4, fair_flush=fair))

    async def go():
        hot = [
            asyncio.ensure_future(ex.submit(("hot",), KIND_PREP_INIT, (b"h%d" % i, [0, 1]), backend=backend))
            for i in range(4)
        ]
        await asyncio.sleep(0.05)
        cold = asyncio.ensure_future(ex.submit(("cold",), KIND_PREP_INIT, (b"c0", [0, 1]), backend=backend))
        await asyncio.sleep(0.05)
        gate.set()
        await asyncio.gather(*hot, cold)

    _run(go())
    ex.shutdown()
    order = backend.launch_order
    assert len(order) == 5
    if fair:
        assert order.index(b"c0") < len(order) - 1, f"cold flush starved: {order}"
    else:
        assert order[-1] == b"c0", f"FIFO must keep arrival order: {order}"


# -- CudaBackend on the CPU: resident flushes --------------------------------


def _reports(jvdaf, measure, count, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(measure(rng), nonce, rng.bytes(jvdaf.RAND_SIZE))
        rows.append((nonce, public, shares))
    return rows


CIRCUITS = {
    "count": (instances.prio3_count, jax_instances.prio3_count, (), lambda r: int(r.integers(0, 2))),
    "histogram": (instances.prio3_histogram, jax_instances.prio3_histogram, (17, 5), lambda r: int(r.integers(0, 17))),
}


@pytest.mark.parametrize("budget", ["default", "tiny"])
@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_resident_flush_zero_readback_and_exact_drain(circuit, budget):
    """An executor flush with the store attached reads back no out-share
    row; each side's drain equals the JAX oracle's aggregate of its out
    shares.  Under a tiny byte budget the flush matrix and the bucket
    buffer are evicted to the host on the way, and the sums stay exact."""
    port, jax_ctor, params, measure = CIRCUITS[circuit]
    vdaf, jvdaf = port(*params), jax_ctor(*params)
    reports = _reports(jvdaf, measure, 5, len(circuit))
    config = AccumulatorConfig(enabled=True, byte_budget=1 if budget == "tiny" else None)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=1024, accumulator=config))
    store = ex.accumulator
    oracle = JaxOracleBackend(jvdaf)
    vk = b"\x2a" * 16
    for agg_id in (0, 1):
        backend = CudaBackend(vdaf, device="cpu")
        rows = [(n, p, s[agg_id]) for n, p, s in reports]
        out = _run(
            ex.submit(vdaf_shape_key(vdaf), KIND_PREP_INIT, (vk, rows), backend=backend, agg_id=agg_id,
                      retain_out_shares=True)
        )
        assert backend.outshare_readback_rows == 0
        refs = [st.out_share for st, _ in out]
        assert all(isinstance(r, ResidentRef) for r in refs)
        store.commit_rows(("bucket", agg_id), backend, refs, job_token=b"job", report_ids=[r[0] for r in rows])
        vector, rids = store.drain(("bucket", agg_id), vdaf.flp.field)
        want = jvdaf.aggregate([st.out_share for st, _ in oracle.prep_init_batch(vk, agg_id, rows)])
        assert vector == want and rids == {r[0] for r in rows}
    ex.shutdown()
    assert store.stats()["flushes_resident"] == 0 and store.resident_bytes == 0
    if budget == "tiny":
        assert store.evictions >= 2
    else:  # the config's default: a backend on the CPU states no budget
        assert store.byte_budget == HOST_BYTE_BUDGET and store.evictions == 0


def test_cuda_backend_buffer_counts_its_true_bytes():
    """A CudaBackend bucket's resident bytes are its buffer tensor's
    ``numel() * element_size()``, never 0, and the retained flush counts
    the out-share tensor's own bytes."""
    vdaf = instances.prio3_histogram(17, 5)
    backend = CudaBackend(vdaf, device="cpu")
    reports = _reports(jax_instances.prio3_histogram(17, 5), lambda r: int(r.integers(0, 17)), 3, 9)
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    staged = backend.stage_prep_init_multi(1, [(bytes(16), [(n, p, s[1]) for n, p, s in reports])])
    (out,) = backend.launch_prep_init_multi(staged, [(bytes(16), [(n, p, s[1]) for n, p, s in reports])],
                                            retain_store=store)
    matrix = store._flushes[0].matrix
    assert store.resident_bytes == matrix.numel() * matrix.element_size() == 4 * 17 * 4 * 4
    store.commit_rows(("b",), backend, [st.out_share for st, _ in out], job_token=b"j", report_ids=[b"a", b"b", b"c"])
    bucket = store._buckets[("b",)]
    assert bucket.buffer_nbytes > 0
    assert bucket.buffer_nbytes == bucket.buffer.numel() * bucket.buffer.element_size()
    assert store.resident_bytes == bucket.buffer_nbytes  # the flush freed once every row was consumed
