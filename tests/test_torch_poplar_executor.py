"""Poplar1 heavy hitters through the port's device executor, on CPU tensors
(the card walk's PyTorch code runs there as it runs on the card):

* the ``poplar_init`` bucket identity: the jobs of one tree level coalesce
  into one flush, two levels never share a bucket, and Poplar1 buckets
  never collide with Prio3's;
* failure domains: ``backend.device_lost`` opens the per-shape breaker;
  the driver refuses as a retryable JobStepError and the helper answers
  503 (an open circuit and backpressure alike), with no row on the oracle;
* the store's agg-param-keyed host buckets and their journals;
* the resident state codec, and a flush whose sketch vectors stay on the
  device as ResidentRefs and drain to the host walk's sum.

The multi-level leader/helper pair through both executors is
``tests/test_torch_pair.py::test_poplar1_pair_collects_prefix_counts``."""

import asyncio
import random
from types import SimpleNamespace

import pytest

from janus_tpu_torch.core import faults
from janus_tpu_torch.core.faults import FaultInjectedError, FaultSpec
from janus_tpu_torch.executor import (
    KIND_POPLAR_INIT,
    AccumulatorConfig,
    CircuitOpenError,
    DeviceAccumulatorStore,
    DeviceExecutor,
    ExecutorConfig,
)
from janus_tpu_torch.fields import Field64
from janus_tpu_torch.vdaf import pingpong as pp
from janus_tpu_torch.vdaf.backend import Poplar1Oracle, make_backend, vdaf_shape_key
from janus_tpu_torch.vdaf.poplar1 import Poplar1, Poplar1AggregationParam

VK = b"\x2a" * 16


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


def _run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _backend(vdaf):
    return make_backend(vdaf, "cuda", device="cpu")


def _shard_rows(vdaf, measurements, seed, agg_id):
    rng = random.Random(seed)
    rows = []
    for m in measurements:
        nonce = rng.randbytes(vdaf.NONCE_SIZE)
        public, shares = vdaf.shard(m, nonce, rng.randbytes(vdaf.RAND_SIZE))
        rows.append((nonce, public, shares[agg_id]))
    return rows


def _assert_outcomes_equal(got, want):
    assert len(got) == len(want)
    for (gs, gsh), (ws, wsh) in zip(got, want):
        assert gsh.encode() == wsh.encode()
        assert gs.y_flat == ws.y_flat
        assert (gs.a, gs.b, gs.c, gs.zs_share) == (ws.a, ws.b, ws.c, ws.zs_share)


def test_multi_request_walk_matches_per_request_batches_and_the_oracle():
    """Two verify keys sharing one agg param and a third request at another
    prefix set in one mega-batch: per request, byte-identical to separate
    ``prep_init_batch`` calls and to ``Poplar1Oracle``."""
    vdaf = Poplar1(bits=4)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    ap_sparse = Poplar1AggregationParam(1, (0, 2))
    backend = _backend(vdaf)
    assert isinstance(backend.oracle, Poplar1Oracle)
    vk1, vk2 = b"\x11" * 16, b"\x22" * 16
    for agg_id in (0, 1):
        rows = _shard_rows(vdaf, [0b1011, 0b0100, 0b1111], "multi", agg_id)
        reqs = [(vk1, ap, rows[:2]), (vk2, ap, rows[2:]), (vk1, ap_sparse, rows[:1])]
        multi = backend.prep_init_multi_poplar(agg_id, reqs)
        for got, (vk, param, sub) in zip(multi, reqs):
            _assert_outcomes_equal(got, backend.prep_init_batch_poplar(vk, agg_id, param, sub))
            _assert_outcomes_equal(got, backend.oracle.prep_init_batch_poplar(vk, agg_id, param, sub))


def test_same_level_jobs_coalesce_and_levels_never_share_a_bucket():
    vdaf = Poplar1(bits=4)
    ap1 = Poplar1AggregationParam(1, (0, 1, 2, 3))
    ap2 = Poplar1AggregationParam(2, (0, 3, 5))
    backend = _backend(vdaf)
    key = vdaf_shape_key(vdaf)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.05, flush_max_rows=4096))
    rows_a = _shard_rows(vdaf, [0b1011, 0b0100], "job-a", 0)
    rows_b = _shard_rows(vdaf, [0b1111], "job-b", 0)

    def submit(vk, ap, rows, task=None):
        return ex.submit(
            key, KIND_POPLAR_INIT, (vk, ap, rows), backend=backend, agg_id=0, agg_param_key=ap.level, task_ident=task
        )

    async def go():
        got_a, got_b = await asyncio.gather(submit(b"\x11" * 16, ap1, rows_a, b"a"), submit(b"\x22" * 16, ap1, rows_b, b"b"))
        return got_a, got_b, await submit(b"\x11" * 16, ap2, rows_a)

    try:
        got_a, got_b, got_c = _run(go())
    finally:
        ex.shutdown()
    _assert_outcomes_equal(got_a, backend.prep_init_batch_poplar(b"\x11" * 16, 0, ap1, rows_a))
    _assert_outcomes_equal(got_b, backend.prep_init_batch_poplar(b"\x22" * 16, 0, ap1, rows_b))
    _assert_outcomes_equal(got_c, backend.prep_init_batch_poplar(b"\x11" * 16, 0, ap2, rows_a))
    stats = ex.stats()
    assert len(stats) == 2, stats
    l1 = next(v for k, v in stats.items() if "/a0/poplar_init/L1#" in k)
    l2 = next(v for k, v in stats.items() if "/a0/poplar_init/L2#" in k)
    assert (l1["flushes"], l1["flushed_jobs"], l1["flushed_rows"]) == (1, 2, 3), l1
    assert (l2["flushes"], l2["flushed_jobs"]) == (1, 1), l2


def test_poplar_buckets_isolate_from_prio3_buckets():
    vdaf = Poplar1(bits=4)
    backend = _backend(vdaf)
    ap = Poplar1AggregationParam(0, (0, 1))
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02))
    rows = _shard_rows(vdaf, [1], "iso", 0)

    async def go():
        await ex.submit(
            vdaf_shape_key(vdaf), KIND_POPLAR_INIT, (VK, ap, rows), backend=backend, agg_id=0, agg_param_key=ap.level
        )

    try:
        _run(go())
    finally:
        ex.shutdown()
    (key,) = ex._buckets
    assert key == (vdaf_shape_key(vdaf), "poplar_init", 0, 0)


def test_device_lost_trips_breaker_then_circuit_open():
    vdaf = Poplar1(bits=4)
    backend = _backend(vdaf)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    key = vdaf_shape_key(vdaf)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.005, breaker_failure_threshold=2, breaker_reset_timeout_s=60.0))
    rows = _shard_rows(vdaf, [1], "lost", 0)
    faults.configure([FaultSpec("backend.device_lost", "error", 1.0)], seed=7)

    async def go():
        for _ in range(2):
            with pytest.raises(FaultInjectedError):
                await ex.submit(
                    key, KIND_POPLAR_INIT, (VK, ap, rows), backend=backend, agg_id=0, agg_param_key=ap.level
                )
        with pytest.raises(CircuitOpenError):
            await ex.submit(key, KIND_POPLAR_INIT, (VK, ap, rows), backend=backend, agg_id=0, agg_param_key=ap.level)

    try:
        _run(go())
        (st,) = ex.circuit_stats().values()
        assert st["state"] == "open" and st["trips"] == 1
        assert ex.circuit_open(key)
    finally:
        ex.shutdown()


def _driver(ex):
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig

    return AggregationJobDriver(
        datastore=None, session_factory=None, config=DriverConfig(vdaf_device="cpu", device_executor=ex)
    )


def test_driver_refuses_as_retryable_while_circuit_open():
    """The first delivery's launch failure is retryable (the breaker counts
    it); the redelivery finds the circuit open and is refused as
    retryable too — no row is served on the oracle."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import JobStepError

    vdaf = Poplar1(bits=4)
    backend = _backend(vdaf)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    rows = _shard_rows(vdaf, [0b1011, 0b0100], "drv", 0)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.005, breaker_failure_threshold=1, breaker_reset_timeout_s=60.0))
    driver = _driver(ex)
    faults.configure([FaultSpec("backend.device_lost", "error", 1.0)], seed=7)

    async def go():
        for _ in range(2):
            with pytest.raises(JobStepError) as exc_info:
                await driver._coalesced_poplar_init(backend, VK, ap, rows)
            assert exc_info.value.retryable
        assert ex.circuit_open(vdaf_shape_key(vdaf))

    try:
        _run(go())
    finally:
        ex.shutdown()
    assert backend.oracle.rows["init"] == 0


def test_driver_backpressure_is_retryable():
    from janus_tpu_torch.aggregator.aggregation_job_driver import JobStepError

    vdaf = Poplar1(bits=4)
    backend = _backend(vdaf)
    ap = Poplar1AggregationParam(0, (0, 1))
    rows = _shard_rows(vdaf, [1, 0, 1], "bp", 0)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=5.0, max_queue_rows=2))
    driver = _driver(ex)

    async def go():
        first = asyncio.ensure_future(driver._coalesced_poplar_init(backend, VK, ap, rows[:2]))
        await asyncio.sleep(0.01)  # rows queued, window still open
        with pytest.raises(JobStepError) as exc_info:
            await driver._coalesced_poplar_init(backend, VK, ap, rows)
        assert exc_info.value.retryable
        await ex.drain()
        await first

    try:
        _run(go())
    finally:
        ex.shutdown()


class _HelperStub:
    """Just the Aggregator surface the Poplar1 helper prep path touches."""

    from janus_tpu_torch.aggregator.aggregator import Aggregator as _A

    _helper_decode_poplar_rows = staticmethod(_A._helper_decode_poplar_rows)
    _helper_finish_poplar1 = staticmethod(_A._helper_finish_poplar1)
    _helper_prepare_batch_poplar1 = _A._helper_prepare_batch_poplar1
    _helper_prepare_batch_poplar1_executor = _A._helper_prepare_batch_poplar1_executor
    _executor_backend_for = _A._executor_backend_for

    def __init__(self, executor):
        self._executor = executor


def _helper_decoded_rows(vdaf, agg_param, measurements, seed):
    """(idx, (nonce, public, helper share, leader INITIALIZE msg)) rows, as
    handle_aggregate_init hands them to the prepare batch."""
    rng = random.Random(seed)
    decoded = []
    for i, m in enumerate(measurements):
        nonce = rng.randbytes(vdaf.NONCE_SIZE)
        public, shares = vdaf.shard(m, nonce, rng.randbytes(vdaf.RAND_SIZE))
        _state, l_share = vdaf.prep_init(VK, 0, agg_param, nonce, public, shares[0])
        msg = pp.PingPongMessage(pp.PingPongMessage.INITIALIZE, prep_share=vdaf.ping_pong_encode_prep_share(l_share))
        decoded.append((i, (nonce, public, shares[1], msg)))
    return decoded


def _helper(vdaf, ex):
    backend = _backend(vdaf)
    ta = SimpleNamespace(backend_name="cuda", device="cpu", field_backend=None, vdaf=vdaf, backend=backend, task=SimpleNamespace(vdaf_verify_key=VK))
    return _HelperStub(ex), ta


def test_helper_routes_through_executor_and_matches_the_direct_batch():
    vdaf = Poplar1(bits=4)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    decoded = _helper_decoded_rows(vdaf, ap, [0b1011, 0b0100, 0b1111], "h1")
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=4096))
    agg, ta = _helper(vdaf, ex)
    try:
        got = _run(agg._helper_prepare_batch_poplar1_executor(ta, decoded, ap))
    finally:
        ex.shutdown()
    want = agg._helper_prepare_batch_poplar1(ta, decoded, ap)
    assert set(got) == set(want) == {0, 1, 2}
    for idx in want:
        (gk, g_payload, g_msg), (wk, w_payload, w_msg) = got[idx], want[idx]
        assert (gk, g_payload) == (wk, w_payload) and gk == "continued"
        assert (g_msg.variant, g_msg.prep_msg, g_msg.prep_share) == (w_msg.variant, w_msg.prep_msg, w_msg.prep_share)
    assert any("/a1/poplar_init/L1#" in k for k in ex.stats())


def test_helper_answers_503_when_circuit_open():
    from janus_tpu_torch.aggregator.error import ServiceUnavailable

    vdaf = Poplar1(bits=4)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    decoded = _helper_decoded_rows(vdaf, ap, [0b1011, 0b0100], "h2")
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02))
    ex.circuit_open = lambda shape_key: True
    agg, ta = _helper(vdaf, ex)
    try:
        with pytest.raises(ServiceUnavailable):
            _run(agg._helper_prepare_batch_poplar1_executor(ta, decoded, ap))
    finally:
        ex.shutdown()
    assert ex.stats() == {}, "an open circuit submits nothing"
    assert ta.backend.oracle.rows["init"] == 0


def test_helper_backpressure_answers_503():
    from janus_tpu_torch.aggregator.error import ServiceUnavailable

    vdaf = Poplar1(bits=4)
    ap = Poplar1AggregationParam(0, (0, 1))
    decoded = _helper_decoded_rows(vdaf, ap, [1, 0, 1], "h3")
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=5.0, max_queue_rows=2))
    agg, ta = _helper(vdaf, ex)

    async def go():
        first = asyncio.ensure_future(agg._helper_prepare_batch_poplar1_executor(ta, decoded[:2], ap))
        await asyncio.sleep(0.01)
        with pytest.raises(ServiceUnavailable):
            await agg._helper_prepare_batch_poplar1_executor(ta, decoded, ap)
        await ex.drain()
        await first

    try:
        _run(go())
    finally:
        ex.shutdown()


def test_host_buckets_isolate_levels_and_journal_exactly_once():
    """Two levels of one task commit into distinct buckets (the key's
    agg-param element) with their own journals; drains never merge; a
    discarded bucket's later commits land in a fresh one."""
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True))
    base = ("leader", b"task", ("Poplar1",), b"batch")
    k1, k2 = base + (b"param-level-1",), base + (b"param-level-2",)
    store.commit_host_rows(k1, Field64, [[1, 2], [3, 4]], job_token=b"j1", report_ids=[b"r1", b"r2"])
    store.commit_host_rows(k2, Field64, [[10, 20]], job_token=b"j1", report_ids=[b"r1"])
    store.commit_host_rows(k1, Field64, [[5, 6]], job_token=b"j2", report_ids=[b"r3"])
    assert store.stats()["buckets"] == 2
    v1, journal1 = store.drain_with_journal(k1, Field64)
    assert v1 == [9, 12]
    assert [(j, set(r)) for j, r in journal1] == [(b"j1", {b"r1", b"r2"}), (b"j2", {b"r3"})]
    v2, journal2 = store.drain_with_journal(k2, Field64)
    assert v2 == [10, 20] and len(journal2) == 1
    assert store.drain_with_journal(k1, Field64) is None, "drained once"
    store.commit_host_rows(k1, Field64, [[7, 7]], job_token=b"j3", report_ids=[b"r4"])
    assert [(j, set(r)) for j, r in store.discard(k1)] == [(b"j3", {b"r4"})]
    store.commit_host_rows(k1, Field64, [[9, 9]], job_token=b"j4", report_ids=[b"r5"])
    assert store.drain_with_journal(k1, Field64)[0] == [9, 9]


def test_resident_state_codec_roundtrips_refs_and_legacy_states():
    """A ResidentRef crosses the WAITING_LEADER persistence hop in the
    state codec, the JAX package decodes the port's bytes, and the finish
    step passes the ref through; list states are unchanged."""
    import janus_tpu.vdaf.poplar1 as jax_poplar1
    from janus_tpu_torch.executor.accumulator import ResidentRef
    from janus_tpu_torch.vdaf.poplar1 import Poplar1PrepareState

    vdaf = Poplar1(bits=4)
    ref_state = Poplar1PrepareState(agg_id=0, level=1, round=1, y_flat=ResidentRef(7, 3), a=11, b=22, c=33, zs_share=44)
    enc = vdaf.ping_pong_encode_state(ref_state)
    dec = vdaf.ping_pong_decode_state(enc)
    assert dec.y_flat == ResidentRef(7, 3)
    assert (dec.a, dec.b, dec.c, dec.zs_share, dec.agg_id, dec.level, dec.round) == (11, 22, 33, 44, 0, 1, 1)
    jvdaf = jax_poplar1.Poplar1(4)
    assert jvdaf.ping_pong_encode_state(jvdaf.ping_pong_decode_state(enc)) == enc
    kind, out = vdaf.ping_pong_prep_next(dec, b"", 1)
    assert kind == "finish" and out == ResidentRef(7, 3)
    legacy = Poplar1PrepareState(agg_id=1, level=1, round=1, y_flat=[1, 2, 3], a=0, b=0, c=0, zs_share=0)
    assert vdaf.ping_pong_decode_state(vdaf.ping_pong_encode_state(legacy)).y_flat == [1, 2, 3]


def test_card_walk_resident_refs_through_executor_flush():
    """A poplar flush of the card walk with the retain opt-in mints
    ResidentRefs; committing them sums on the device and drains to the
    host walk's vector, with no sketch readback; a dead ref fails closed."""
    from janus_tpu_torch.executor.accumulator import AccumulatorUnavailable, ResidentRef

    vdaf = Poplar1(bits=4)
    backend = _backend(vdaf)
    ap = Poplar1AggregationParam(1, (0, 1, 2, 3))
    field = vdaf.field_for_agg_param(ap)
    key = vdaf_shape_key(vdaf)
    rows = _shard_rows(vdaf, [0b1011, 0b1011, 0b0100, 0b1111], "resident", 0)
    ex = DeviceExecutor(
        ExecutorConfig(flush_window_s=0.01, accumulator=AccumulatorConfig(enabled=True, drain_interval_s=3600.0))
    )

    async def go():
        return await ex.submit(
            key, KIND_POPLAR_INIT, (VK, ap, rows), backend=backend, agg_id=0, retain_out_shares=True,
            agg_param_key=ap.level,
        )

    try:
        outs = _run(go())
        refs = [st.y_flat for st, _sh in outs]
        assert all(isinstance(r, ResidentRef) for r in refs)
        store = ex.accumulator
        assert store.stats()["flushes_resident"] == 1
        want = backend.bp.prep_init_batch_host(VK, 0, ap, rows)
        assert [sh.encode() for _s, sh in outs] == [sh.encode() for _s, sh in want]
        bucket_key = ("leader", b"t", key, b"ident", vdaf.encode_agg_param(ap))
        store.commit_rows(bucket_key, backend, refs, job_token=b"j", report_ids=[b"%d" % i for i in range(len(refs))])
        vec, _journal = store.drain_with_journal(bucket_key, field)
        expect = [0] * 4
        for ws, _wsh in want:
            expect = field.vec_add(expect, ws.y_flat)
        assert vec == expect
        assert store.stats()["flushes_resident"] == 0
        assert backend.sketch_readback_rows == 0
        with pytest.raises(AccumulatorUnavailable):
            store.commit_rows(bucket_key, backend, [refs[0]], job_token=b"j2", report_ids=[b"x"])
    finally:
        ex.shutdown()
