"""The port's device-resident accumulator store
(janus_tpu_torch/executor/accumulator.py).

The store-level cases of tests/test_accumulator.py on the port's copy:
against a numpy stub backend (round trip, residency across flushes,
eviction under a tiny byte budget, a poisoned bucket, the spill and evict
faults, agg-param-keyed host buckets, the fair scheduler), then through
``CudaBackend(device="cpu")``: an executor flush keeps its out shares
resident (``outshare_readback_rows`` stays 0) and the drained aggregate
equals the JAX package's oracle; then the cases that need the control
plane's copy: the writer's delta resolution and journal, the driver's
breaker replay, precheck and maintenance pass, the helper's prep routing,
the shutdown drain and concurrent deliveries to the helper."""

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


@pytest.mark.parametrize("budget", ["default", "tiny"])
def test_canonical_flush_drains_bucket_width_and_clips(budget):
    """A flush on a canonical twin (Histogram(17, 5) on Histogram(20, 5), the
    twin's masked row path) keeps its out shares resident at the twin's
    width; the refs name the task's width 17, and the bucket's drain clips
    the 20-wide sum back to the JAX oracle's 17-wide aggregate; under a tiny
    byte budget the same holds through the evictions."""
    from janus_tpu_torch.vdaf.canonical import executor_shape

    vdaf, jvdaf = instances.prio3_histogram(17, 5), jax_instances.prio3_histogram(17, 5)
    key, twin = executor_shape(vdaf)
    assert twin.flp.OUTPUT_LEN == 20
    reports = _reports(jvdaf, lambda r: int(r.integers(0, 17)), 5, 17)
    config = AccumulatorConfig(enabled=True, byte_budget=1 if budget == "tiny" else None)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=1024, accumulator=config))
    store = ex.accumulator
    backend = ex.backend_for(key, lambda: CudaBackend(twin, device="cpu", canonical=True))
    backend.one_shape_exact = False
    vk = b"\x2b" * 16
    for agg_id in (0, 1):
        rows = [(n, p, s[agg_id]) for n, p, s in reports]
        out = _run(ex.submit(key, KIND_PREP_INIT, (vk, rows, vdaf), backend=backend, agg_id=agg_id, retain_out_shares=True))
        refs = [st.out_share for st, _ in out]
        assert all(isinstance(r, ResidentRef) and r.width == 17 for r in refs)
        assert store._flushes[refs[0].flush_id].matrix.shape[1] == 20
        store.commit_rows(("canon", agg_id), backend, refs, job_token=b"job", report_ids=[r[0] for r in rows])
        vector, _rids = store.drain(("canon", agg_id), vdaf.flp.field)
        want = jvdaf.aggregate([st.out_share for st, _ in JaxOracleBackend(jvdaf).prep_init_batch(vk, agg_id, rows)])
        assert vector == want
    ex.shutdown()
    assert backend.outshare_readback_rows == 0 and store.resident_bytes == 0
    assert (store.evictions >= 2) == (budget == "tiny")


@pytest.mark.parametrize("agg_id", [0, 1])
def test_canonical_bucket_sums_one_shape_and_mixed_flushes(agg_id):
    """One task's bucket fed by a flush of its own shape (its own prepare,
    17 wide) and by a flush mixed with another task (the twin's, 20 wide)
    drains the JAX oracle's 17-wide aggregate of both; a ref naming a width
    short of the task's non-zero columns fails the drain loudly."""
    import dataclasses

    from janus_tpu_torch.executor.accumulator import AccumulatorUnavailable, DeviceAccumulatorStore
    from janus_tpu_torch.vdaf.canonical import executor_shape

    (v17, j17), (v18, j18) = ((instances.prio3_histogram(n, 5), jax_instances.prio3_histogram(n, 5)) for n in (17, 18))
    _key, twin = executor_shape(v17)
    backend = CudaBackend(twin, device="cpu", canonical=True)
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    vk = b"\x2c" * 16
    r17 = [(n, p, s[agg_id]) for n, p, s in _reports(j17, lambda r: int(r.integers(0, 17)), 6, 31)]
    r18 = [(n, p, s[agg_id]) for n, p, s in _reports(j18, lambda r: int(r.integers(0, 18)), 3, 32)]
    refs = []
    for reqs in ([(vk, r17[:3], v17)], [(vk, r17[3:], v17), (vk, r18, v18)]):
        staged = backend.stage_prep_init_multi(agg_id, reqs)
        assert (staged.exact is None) == (len(reqs) == 2)
        out = backend.launch_prep_init_multi(staged, reqs, retain_store=store)
        refs += [st.out_share for st, _ in out[0]]
    store.commit_rows(("one-task", agg_id), backend, refs, job_token=b"job", report_ids=[r[0] for r in r17])
    vector, _rids = store.drain(("one-task", agg_id), v17.flp.field)
    want = j17.aggregate([st.out_share for st, _ in JaxOracleBackend(j17).prep_init_batch(vk, agg_id, r17)])
    assert vector == want
    reqs = [(vk, r17, v17)]
    out = backend.launch_prep_init_multi(backend.stage_prep_init_multi(agg_id, reqs), reqs, retain_store=store)
    bad = [dataclasses.replace(st.out_share, width=1) for st, _ in out[0]]
    store.commit_rows(("short", agg_id), backend, bad, job_token=b"job", report_ids=[r[0] for r in r17])
    with pytest.raises(AccumulatorUnavailable):
        store.drain(("short", agg_id), v17.flp.field)


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


# -- the control plane's side of the store: the writer, the driver, the helper


def test_writer_resolves_delta_and_rejects_stale_sets():
    from janus_tpu_torch.aggregator.aggregation_job_writer import AggregationJobWriter
    from janus_tpu_torch.executor import StaleAccumulatorDelta

    writer = AggregationJobWriter(
        task=None, vdaf=None, accumulator_deltas={b"ident": ([5, 50], frozenset({b"r1", b"r2"}))}
    )
    refs = [ResidentRef(0, 0), ResidentRef(0, 1)]
    assert writer._resolve_shares(_Field, b"ident", refs, [b"r1", b"r2"]) == [5, 50]
    # mixed host + resident rows: delta and host vectors add
    assert writer._resolve_shares(_Field, b"ident", refs + [[1, 1]], [b"r1", b"r2", b"r3"]) == [6, 51]
    # a report failed in-tx after its row was drained -> abort the tx
    with pytest.raises(StaleAccumulatorDelta):
        writer._resolve_shares(_Field, b"ident", [refs[0]], [b"r1"])
    # unknown batch ident -> no delta at all
    with pytest.raises(StaleAccumulatorDelta):
        writer._resolve_shares(_Field, b"other", refs, [b"r1", b"r2"])


def test_writer_journal_entries_defer_shares_and_persist_rows():
    """Deferred mode at the writer: journaled rows contribute NO share in
    this tx (None when everything is deferred) and one journal row per
    (job, ident) is persisted; a journaled report failed in-tx aborts."""
    from janus_tpu_torch.aggregator.aggregation_job_writer import AggregationJobWriter
    from janus_tpu_torch.executor import StaleAccumulatorDelta

    writer = AggregationJobWriter(task=None, vdaf=None, journal_entries={b"ident": frozenset({b"r1", b"r2"})})
    refs = [ResidentRef(0, 0), ResidentRef(0, 1)]
    assert writer._resolve_shares(_Field, b"ident", refs, [b"r1", b"r2"]) is None
    assert writer._resolve_shares(_Field, b"ident", refs + [[1, 1]], [b"r1", b"r2", b"r3"]) == [1, 1]
    with pytest.raises(StaleAccumulatorDelta):
        writer._resolve_shares(_Field, b"other-ident", refs, [b"r1", b"r2"])
    calls = []
    tx = SimpleNamespace(put_accumulator_journal_entry=lambda *a: calls.append(a))
    writer.task = SimpleNamespace(task_id=b"task")
    job = SimpleNamespace(aggregation_parameter=b"", aggregation_job_id=b"job")
    writer._write_journal(tx, job, failures={})
    assert calls == [(b"task", b"ident", b"", b"job", [b"r1", b"r2"], None)]
    with pytest.raises(StaleAccumulatorDelta):
        writer._write_journal(tx, job, failures={b"r2": "collected"})


@pytest.fixture(scope="module")
def count_backend():
    return CudaBackend(instances.prio3_count(), device="cpu")


def _count_reports(vdaf, n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        nonce = rng.bytes(vdaf.NONCE_SIZE)
        ps, shares = vdaf.shard(i % 2, nonce, rng.bytes(vdaf.RAND_SIZE))
        rows.append((nonce, ps, shares[0]))
    return rows


def _driver(**executor):
    """A driver with a device executor of its own; the caller shuts the
    executor down (``driver._executor.shutdown(drain=False)``)."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig

    return AggregationJobDriver(
        datastore=None,
        session_factory=None,
        config=DriverConfig(
            vdaf_device="cpu", device_executor=DeviceExecutor(ExecutorConfig(**executor))
        ),
    )


def test_driver_breaker_replay_recovers_via_oracle(count_backend):
    """Launch-failure recovery at the DRIVER layer: commit_rows dies, the
    journal replays through the CPU oracle, out_shares become host
    vectors (equal to the JAX package's oracle), and nothing is left
    resident to double-count."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.datastore import AggregationJob, AggregationJobState, ReportAggregation, ReportAggregationState
    from janus_tpu_torch.datastore.task import AggregatorTask, TaskQueryType
    from janus_tpu_torch.messages import AggregationJobId, AggregationJobStep, Duration, Interval, ReportId, Role, TaskId, Time
    from janus_tpu_torch.vdaf import pingpong as pp

    vdaf = count_backend.vdaf
    driver = _driver(flush_window_s=0.02, flush_max_rows=1024, accumulator=AccumulatorConfig(enabled=True))
    store = driver._executor.accumulator
    assert store is not None
    driver._backends[AggregationJobDriver._vdaf_shape_key(vdaf)] = count_backend
    task = AggregatorTask(
        task_id=TaskId.random(), peer_aggregator_endpoint="inproc://helper/",
        query_type=TaskQueryType.time_interval(), vdaf={"type": "Prio3Count"}, role=Role.LEADER,
        vdaf_verify_key=b"\x2a" * 16, min_batch_size=1, time_precision=Duration(3600),
    )
    now = Time(1_600_000_000)
    job = AggregationJob(
        task_id=task.task_id, aggregation_job_id=AggregationJobId.random(), aggregation_parameter=b"",
        partial_batch_identifier=None, client_timestamp_interval=Interval(now, Duration(3600)),
        state=AggregationJobState.IN_PROGRESS, step=AggregationJobStep(1),
    )
    reports = _count_reports(vdaf, 3, 11)
    ras = [
        ReportAggregation(
            task_id=task.task_id, aggregation_job_id=job.aggregation_job_id, report_id=ReportId(nonce), time=now,
            ord=i, state=ReportAggregationState.START_LEADER, public_share=vdaf.encode_public_share(ps),
            leader_input_share=share.encode(vdaf),
        )
        for i, (nonce, ps, share) in enumerate(reports)
    ]

    async def go():
        prep_in = [(ra.report_id.data, ps, share) for ra, (_n, ps, share) in zip(ras, reports)]
        out = await driver._coalesced_prep_init(count_backend, task.vdaf_verify_key, prep_in)
        assert count_backend.outshare_readback_rows == 0
        states, out_shares = {}, {}
        for ra, (state, _share) in zip(ras, out):
            assert isinstance(state.out_share, ResidentRef)
            states[ra.report_id.data] = pp.PingPongContinued(state, 0)
            out_shares[ra.report_id.data] = state.out_share

        def dead(*a, **kw):  # the device dies between flush and commit
            raise RuntimeError("device on fire")

        orig, count_backend.accumulate_rows = count_backend.accumulate_rows, dead
        try:
            deltas, _journal, _touched = await driver._commit_resident_shares(task, vdaf, job, ras, states, out_shares)
        finally:
            count_backend.accumulate_rows = orig
        return deltas, out_shares

    count_backend.outshare_readback_rows = 0
    try:
        deltas, out_shares = _run(go())
    finally:
        driver._executor.shutdown(drain=False)
    assert deltas is None, "replay path yields host vectors, not deltas"
    jvdaf = jax_instances.prio3_count()
    want = {
        nonce: state.out_share
        for (nonce, _p, _s), (state, _) in zip(
            reports, JaxOracleBackend(jvdaf).prep_init_batch(task.vdaf_verify_key, 0, _jax_rows(jvdaf, vdaf, reports))
        )
    }
    assert out_shares == want, "oracle replay must be bit-exact"
    assert store.stats()["buckets"] == 0, "discarded delta must never drain"
    assert store.stats()["flushes_resident"] == 0


def _jax_rows(jvdaf, vdaf, reports):
    """The port's leader rows as the JAX package's objects (via the wire)."""
    return [
        (nonce, jvdaf.decode_public_share(vdaf.encode_public_share(ps)), jvdaf.decode_input_share(0, share.encode(vdaf)))
        for nonce, ps, share in reports
    ]


def _helper_decoded_rows(vdaf, n, seed):
    """(idx, (nonce, public, helper_share, leader INITIALIZE msg)) rows,
    exactly what handle_aggregate_init hands _helper_prepare_batch."""
    from janus_tpu_torch.vdaf import pingpong as pp

    vk = b"\x2a" * vdaf.VERIFY_KEY_SIZE
    rng = np.random.default_rng(seed)
    decoded = []
    for i in range(n):
        nonce = rng.bytes(vdaf.NONCE_SIZE)
        public, shares = vdaf.shard(i % 2, nonce, rng.bytes(vdaf.RAND_SIZE))
        _state, l_share = vdaf.prep_init(vk, 0, nonce, public, shares[0])
        msg = pp.PingPongMessage(pp.PingPongMessage.INITIALIZE, prep_share=vdaf.ping_pong_encode_prep_share(l_share))
        decoded.append((i, (nonce, public, shares[1], msg)))
    return vk, decoded


def _agg_stub(executor):
    """Just the Aggregator surface the helper prep path touches."""
    from janus_tpu_torch.aggregator.aggregator import Aggregator as A

    stub = SimpleNamespace(_executor=executor)
    for name in ("_helper_decode_leader_shares", "_helper_finish_prio3"):
        setattr(stub, name, getattr(A, name))
    for name in ("_helper_prepare_batch_prio3", "_helper_prepare_batch_prio3_executor",
                 "_executor_backend_for", "_release_helper_refs", "_release_unfinished_helper_refs"):
        setattr(stub, name, getattr(A, name).__get__(stub))
    return stub


def test_helper_prep_routes_through_executor_and_matches_oracle(count_backend):
    """aggregator.py's prep_init_batch / prep_shares_to_prep_batch calls
    submit through the executor (prep_init a1 + combine buckets) and the
    outcomes match the direct oracle path bit for bit."""
    from janus_tpu_torch.vdaf.backend import OracleBackend

    vdaf = count_backend.vdaf
    vk, decoded = _helper_decoded_rows(vdaf, 3, 21)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=1024))
    agg = _agg_stub(ex)
    ta = SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, vdaf=vdaf, backend=count_backend, task=SimpleNamespace(vdaf_verify_key=vk))
    got = _run(agg._helper_prepare_batch_prio3_executor(ta, decoded))
    ex.shutdown()
    want = agg._helper_prepare_batch_prio3(
        SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, vdaf=vdaf, backend=OracleBackend(vdaf), task=ta.task), decoded
    )
    assert set(got) == set(want)
    for idx in want:
        gk, g_out, g_msg = got[idx]
        wk, w_out, w_msg = want[idx]
        assert (gk, g_out) == (wk, w_out)
        assert (g_msg.variant, g_msg.prep_msg) == (w_msg.variant, w_msg.prep_msg)
    stats = ex.stats()
    assert any("/a1/prep_init" in k for k in stats), stats
    assert any("/a1/combine" in k for k in stats), stats


def test_helper_prep_degrades_to_oracle_when_circuit_open(count_backend):
    """Breaker-aware helper path: an open circuit skips the executor
    entirely (no submissions).  The reference serves the request on the
    CPU oracle; the port serves no circuit the card serves on the oracle,
    so the helper answers the DAP-retryable 503 and the leader's lease
    machinery redelivers once the circuit closes."""
    from janus_tpu_torch.aggregator.error import ServiceUnavailable

    vdaf = count_backend.vdaf
    vk, decoded = _helper_decoded_rows(vdaf, 2, 22)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=1024))
    ex.circuit_open = lambda shape_key: True  # breaker peek says: open
    agg = _agg_stub(ex)
    ta = SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, vdaf=vdaf, backend=count_backend, task=SimpleNamespace(vdaf_verify_key=vk))
    count_backend.oracle.rows = {"init": 0, "combine": 0}
    try:
        with pytest.raises(ServiceUnavailable) as exc_info:
            _run(agg._helper_prepare_batch_prio3_executor(ta, decoded))
    finally:
        ex.shutdown()
    assert exc_info.value.status == 503 and exc_info.value.retry_after is not None
    assert ex.stats() == {}, "open circuit must not submit to the device"
    assert count_backend.oracle.rows == {"init": 0, "combine": 0}, "a served circuit must not land on the oracle"


def test_driver_precheck_skips_submit_when_circuit_open():
    """Breaker-aware acquisition on the DRIVER side: circuit_open refuses
    the job before any submission, as a retryable JobStepError (the lease
    machinery redelivers it), and the oracle is never asked."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import JobStepError

    driver = _driver()
    driver._executor.circuit_open = lambda shape_key: True

    class _Oracle:
        def prep_init_batch(self, vk, agg_id, rows):  # pragma: no cover
            raise AssertionError("a served circuit reached the oracle")

    class _B:
        vdaf = SimpleNamespace()
        oracle = _Oracle()

        def stage_prep_init_multi(self, *a, **kw):  # pragma: no cover
            raise AssertionError("device path reached despite open circuit")

    try:
        with pytest.raises(JobStepError) as exc_info:
            _run(driver._coalesced_prep_init(_B(), b"vk", [0, 1]))
        assert exc_info.value.retryable
        assert driver._executor.stats() == {}
    finally:
        driver._executor.shutdown(drain=False)


def test_cold_shape_waits_for_its_warmup_and_never_reaches_the_oracle(count_backend):
    """A shape still WARMING (kernels building on the warmup thread): the
    driver and the helper wait on the compile future, then launch on the
    shape's own backend; the oracle serves no row."""
    import time as _time

    vdaf = count_backend.vdaf
    key = vdaf_shape_key(vdaf)
    driver = _driver(flush_window_s=0.01, flush_max_rows=1024, warmup_rows=4)
    ex = driver._executor
    built = threading.Event()
    orig_build = getattr(count_backend, "build_kernels", None)

    def slow_build():
        _time.sleep(0.2)
        built.set()
        if orig_build is not None:
            orig_build()

    count_backend.build_kernels = slow_build
    count_backend.oracle.rows = {"init": 0, "combine": 0}
    try:
        assert ex.backend_for(key, lambda: count_backend) is count_backend
        assert ex.warming(key)
        reports = _count_reports(vdaf, 3, 31)
        out = _run(driver._coalesced_prep_init(count_backend, b"\x2a" * 16, reports))
        assert built.is_set() and not ex.warming(key)
        assert len(out) == 3 and not any(isinstance(o, Exception) for o in out)
        vk, decoded = _helper_decoded_rows(vdaf, 2, 33)
        ta = SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, vdaf=vdaf, backend=count_backend, task=SimpleNamespace(vdaf_verify_key=vk))
        got = _run(_agg_stub(ex)._helper_prepare_batch_prio3_executor(ta, decoded))
        assert all(v[0] == "finished" for v in got.values())
    finally:
        del count_backend.build_kernels
        ex.shutdown(drain=False)
    assert count_backend.oracle.rows == {"init": 0, "combine": 0}


def test_accumulator_config_yaml_round_trip():
    """The executor block of a driver's YAML config builds the port's
    ``ExecutorConfig`` with its accumulator.  The port has no binaries
    yet (ROADMAP queue 1 item 11), so the mapping goes through the
    dataclasses directly, and back out unchanged."""
    import dataclasses

    import yaml

    doc = yaml.safe_load(
        """
device_executor:
  fair_quota_rows: 4096
  accumulator:
    enabled: true
    byte_budget: 1048576
"""
    )["device_executor"]
    ec = ExecutorConfig(**{**doc, "accumulator": AccumulatorConfig(**doc["accumulator"])})
    assert ec.fair_quota_rows == 4096
    assert ec.accumulator is not None and ec.accumulator.byte_budget == 1048576
    back = dataclasses.asdict(ec)
    assert back["fair_quota_rows"] == 4096
    assert {k: back["accumulator"][k] for k in doc["accumulator"]} == doc["accumulator"]


def test_maintenance_pass_drains_due_deferred_buckets_and_rebalances():
    """The dedicated maintenance pass: due deferred buckets drain WITHOUT
    waiting for a committing driver, and the occupancy rebalance runs off
    the hot path."""
    import time as _time

    driver = _driver(accumulator=AccumulatorConfig(enabled=True, drain_interval_s=0.01, maintenance_interval_s=0.01))
    store = driver._executor.accumulator
    backend = _AccumBackend()
    m = _matrix(2)
    fid = store.retain_flush(backend, m, rows=2, nbytes=m.nbytes)
    key = ("leader", b"task", ("shape",), b"ident", b"param")  # deferred key
    store.commit_rows(key, backend, [ResidentRef(fid, 0), ResidentRef(fid, 1)], job_token=b"job",
                      report_ids=[b"r0", b"r1"])
    drained_keys = []

    def fake_drain(k):  # consume the bucket like the real drain's journal tx
        drained_keys.append(k)
        store.discard(k)

    driver._drain_due_bucket = fake_drain
    _time.sleep(0.02)  # past drain_interval_s: the bucket is due
    try:
        assert _run(driver.run_accumulator_maintenance()) == 1 and drained_keys == [key]
        # nothing due -> a quiet pass; the loop must be safe to run forever
        assert _run(driver.run_accumulator_maintenance()) == 0
    finally:
        driver._executor.shutdown(drain=False)


def _committed(store, backend, job=b"jobA"):
    m = _matrix(2)
    fid = store.retain_flush(backend, m, rows=2, nbytes=m.nbytes)
    store.commit_rows(("bucket",), backend, [ResidentRef(fid, 0), ResidentRef(fid, 1)], job_token=job,
                      report_ids=[b"r0", b"r1"])


def test_shutdown_drain_spills_through_sink_exactly_once():
    """The SIGTERM path: shutdown(drain=True), the default, spills
    committed-but-unspilled deltas through the registered sink before
    discarding; the sink sees the vector AND the per-job journal."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, drain_interval_s=60))
    ex = DeviceExecutor(ExecutorConfig())
    ex.accumulator = store
    _committed(store, _AccumBackend())
    spilled = []
    ex.set_spill_sink(lambda key, vector, journal: spilled.append((key, vector, journal)))
    ex.shutdown()
    assert spilled == [(("bucket",), [1 + 2, 10 + 20], [(b"jobA", frozenset({b"r0", b"r1"}))])]
    assert store.stats()["buckets"] == 0
    spilled.clear()
    ex.shutdown()  # drained exactly once: nothing left for a second teardown
    assert spilled == []


def test_undrained_shutdown_discards_and_redelivery_rederives():
    """shutdown(drain=False), the crash shape, discards the delta WITHOUT
    spilling; recommitting the same rows into a fresh store (what lease
    redelivery does with real shares) yields the identical vector."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    ex = DeviceExecutor(ExecutorConfig())
    ex.accumulator = store
    backend = _AccumBackend()
    _committed(store, backend)
    spilled = []
    ex.set_spill_sink(lambda *a: spilled.append(a))
    ex.shutdown(drain=False)
    assert spilled == [] and store.stats()["buckets"] == 0
    store2 = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    _committed(store2, backend)
    vector, rids = store2.drain(("bucket",), _Field)
    assert vector == [3, 30] and rids == {b"r0", b"r1"}


def test_concurrent_same_job_deliveries_use_disjoint_buckets():
    """Two CONCURRENT deliveries of one aggregation job to the helper must
    never share a drain-at-commit bucket (both commits landing before
    either drain would double the vector with a matching report-id set);
    keys carry a per-delivery nonce, so each drains exactly its own rows."""
    from janus_tpu_torch.aggregator.aggregator import Aggregator
    from janus_tpu_torch.datastore import TaskQueryType
    from janus_tpu_torch.messages import AggregationJobId, Duration, TaskId, Time

    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    backend = _AccumBackend()
    commit_keys = []
    orig_commit = store.commit_rows

    def recording_commit(key, *a, **kw):
        commit_keys.append(key)
        return orig_commit(key, *a, **kw)

    store.commit_rows = recording_commit
    task = SimpleNamespace(task_id=TaskId.random(), query_type=TaskQueryType.time_interval(),
                           time_precision=Duration(3600))
    job = SimpleNamespace(aggregation_parameter=b"", aggregation_job_id=AggregationJobId.random(),
                          partial_batch_identifier=None)
    ta = SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, task=task, vdaf=instances.prio3_count(), backend=backend)
    agg = SimpleNamespace(_executor=SimpleNamespace(accumulator=store), datastore=None)

    def deliver():
        m = _matrix(2)
        fid = store.retain_flush(backend, m, rows=2, nbytes=m.nbytes)
        ras = [SimpleNamespace(report_id=SimpleNamespace(data=bytes([i]) * 16), time=Time(0)) for i in range(2)]
        out_shares = {ras[0].report_id.data: ResidentRef(fid, 0), ras[1].report_id.data: ResidentRef(fid, 1)}
        return _run(Aggregator._commit_helper_resident_shares(agg, ta, job, ras, out_shares, decoded_by_rid={}))

    (v1, _r1), = deliver().values()
    (v2, _r2), = deliver().values()
    assert v1 == [1 + 2, 10 + 20] and v2 == [1 + 2, 10 + 20]
    assert len(commit_keys) == 2 and commit_keys[0] != commit_keys[1]
