"""The port's device executor (janus_tpu_torch/executor/service.py).

The cases of tests/test_executor.py that need no aggregator, on the port's
copy: scheduling (bucketing, flush triggers, backpressure, deadlines,
failure propagation) against a stub backend that touches no device, and
coalesced flushes through ``CudaBackend(device="cpu")`` held byte for byte
against the JAX package's ``OracleBackend``."""

import asyncio
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from janus_tpu.vdaf import instances as jax_instances
from janus_tpu.vdaf.backend import OracleBackend as JaxOracleBackend
from janus_tpu_torch.executor import (
    KIND_COMBINE,
    KIND_PREP_INIT,
    DeviceExecutor,
    ExecutorConfig,
    ExecutorOverloadedError,
    bucket_label,
)
from janus_tpu_torch.fields import next_power_of_2
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend, OracleBackend, vdaf_shape_key


def _run(coro, timeout=30.0):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


class _StubBackend:
    """Stage/launch seam double: records mega-batches, touches no device."""

    def __init__(self, launch_gate: threading.Event = None, fail: bool = False):
        self.vdaf = SimpleNamespace()
        self.launches = []  # rows per request of each mega-batch
        self.staged_pads = []
        self.combine_batches = []
        self._gate = launch_gate
        self._fail = fail

    def stage_prep_init_multi(self, agg_id, requests, pad_to=None):
        rows = sum(len(r) for _, r in requests)
        if rows == 0:
            return None
        self.staged_pads.append(max(pad_to or 0, next_power_of_2(rows)))
        return SimpleNamespace(agg_id=agg_id, placed=None, pad_to=self.staged_pads[-1], rows=rows)

    def launch_prep_init_multi(self, staged, requests):
        if self._fail:
            raise RuntimeError("device on fire")
        if self._gate is not None:
            assert self._gate.wait(10), "test launch gate never opened"
        self.launches.append([len(r) for _, r in requests])
        return [[("prep", vk, i) for i in range(len(reports))] for vk, reports in requests]

    def prep_shares_to_prep_batch(self, rows):
        self.combine_batches.append(len(rows))
        return [("combined", i) for i in range(len(rows))]


# -- bucketing / padding -----------------------------------------------------


def test_distinct_shape_kind_aggid_get_distinct_buckets():
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.005, flush_max_rows=1024))

    async def go():
        await asyncio.gather(
            ex.submit(("shapeA",), KIND_PREP_INIT, (b"k1", [1, 2]), backend=backend),
            ex.submit(("shapeA",), KIND_PREP_INIT, (b"k2", [3]), backend=backend),
            ex.submit(("shapeB",), KIND_PREP_INIT, (b"k3", [4]), backend=backend),
            ex.submit(("shapeA",), KIND_COMBINE, [[1], [2]], backend=backend),
            ex.submit(("shapeA",), KIND_PREP_INIT, (b"k4", [5]), backend=backend, agg_id=1),
        )

    _run(go())
    ex.shutdown()
    # same (shape, kind, agg_id) coalesce; anything else separates
    assert len(ex._buckets) == 4
    assert [sorted(x) for x in backend.launches].count([1, 2]) == 1
    assert 4 in backend.staged_pads  # the 4-row shapeA/a0 mega-batch, pow2-padded


def test_pow2_padding_and_warmup_override():
    """The port's backend pads a flush to the next power of two; an
    explicit ``pad_to`` (the warmup's target) wins, and the warmup launches
    one synthetic row per side at that size."""
    backend = CudaBackend(instances.prio3_count(), device="cpu")
    rows = [(n, p, s[1]) for n, p, s in _shard(backend.vdaf, lambda r: 1, 3, 0)]
    assert backend.stage_prep_init_multi(1, [(bytes(16), rows)]).pad_to == 4
    staged = backend.stage_prep_init_multi(1, [(bytes(16), rows)], pad_to=16)
    assert staged.pad_to == 16 and staged.rows == 3
    assert staged.placed["share_seeds_u8"].shape[0] == 16
    ex = DeviceExecutor(ExecutorConfig(warmup_rows=8))
    assert ex.warmup_backend(backend, agg_ids=(0, 1)) == 2
    ex.shutdown()
    assert backend.outshare_readback_rows == 2  # one real row a side, padded to 8


def test_warmup_through_backend_for_records_compile_stats():
    backend = CudaBackend(instances.prio3_count(), device="cpu")
    ex = DeviceExecutor(ExecutorConfig(warmup_rows=4, warmup_async=False))
    key = vdaf_shape_key(backend.vdaf)
    assert ex.backend_for(key, lambda: backend) is backend
    ex.shutdown()
    (stats,) = ex.compile_stats().values()
    assert stats["state"] == "warm" and stats["compile_s"] is not None and stats["error"] is None


def test_empty_submission_short_circuits():
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig())

    async def go():
        return await ex.submit(("s",), KIND_PREP_INIT, (b"k", []), backend=backend)

    assert _run(go()) == []
    ex.shutdown()
    assert backend.launches == []


def test_breakers_are_per_shape_and_retire_with_their_buckets():
    """A failing shape opens its own circuit only; once idle, a closed
    circuit retires with its bucket and an open one stays."""
    sick, healthy = _StubBackend(fail=True), _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.001, breaker_failure_threshold=1))

    async def go():
        return await asyncio.gather(
            ex.submit(("sick",), KIND_PREP_INIT, (b"k", [0]), backend=sick),
            ex.submit(("healthy",), KIND_PREP_INIT, (b"k", [0]), backend=healthy),
            return_exceptions=True,
        )

    failed, ok = _run(go())
    assert isinstance(failed, RuntimeError) and ok == [("prep", b"k", 0)]
    assert ex.circuit_open(("sick",)) and not ex.circuit_open(("healthy",))
    assert sorted(c["state"] for c in ex.circuit_stats().values()) == ["closed", "open"]
    assert ex.retire_idle_buckets(max_idle_s=0.0) == 2
    assert [c["state"] for c in ex.circuit_stats().values()] == ["open"]
    ex.shutdown()


def test_bucket_label_is_compact():
    assert bucket_label(OracleBackend(instances.prio3_count()), KIND_PREP_INIT, 0) == "Count/a0/prep_init"


# -- flush triggers ----------------------------------------------------------


@pytest.mark.parametrize("trigger", ["deadline", "size"])
def test_flush_coalesces_concurrent_jobs(trigger):
    """Two jobs ride ONE flush: the window's deadline fires it, or (with an
    absurdly long window) the size trigger does without waiting."""
    backend = _StubBackend()
    if trigger == "deadline":
        config = ExecutorConfig(flush_window_s=0.01, flush_max_rows=10_000)
    else:
        config = ExecutorConfig(flush_window_s=60.0, flush_max_rows=5)
    ex = DeviceExecutor(config)

    async def go():
        return await asyncio.gather(
            ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0, 1]), backend=backend),
            ex.submit(("s",), KIND_PREP_INIT, (b"k2", [0, 1, 2]), backend=backend),
        )

    t0 = time.monotonic()
    a, b = _run(go(), timeout=10.0)
    elapsed = time.monotonic() - t0
    ex.shutdown()
    assert backend.launches == [[2, 3]], "both jobs must ride ONE flush"
    assert len(a) == 2 and len(b) == 3
    assert elapsed < 5.0
    stats = next(iter(ex.stats().values()))
    assert stats["flushes"] == 1 and stats["flushed_jobs"] == 2


def test_combine_kind_coalesces_and_slices():
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.01, flush_max_rows=10_000))

    async def go():
        return await asyncio.gather(
            ex.submit(("s",), KIND_COMBINE, [[1], [2]], backend=backend),
            ex.submit(("s",), KIND_COMBINE, [[3]], backend=backend),
        )

    a, b = _run(go())
    ex.shutdown()
    assert backend.combine_batches == [3], "one concatenated combine launch"
    assert a == [("combined", 0), ("combined", 1)] and b == [("combined", 2)]


# -- backpressure ------------------------------------------------------------


def test_oversized_submission_admitted_on_empty_bucket():
    """A job larger than max_queue_rows still runs when nothing is queued
    ahead of it: a deterministic rejection would fail it on every retry."""
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.01, flush_max_rows=10_000, max_queue_rows=2))

    async def go():
        return await ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0, 1, 2, 3, 4]), backend=backend)

    assert len(_run(go())) == 5
    ex.shutdown()


@pytest.mark.parametrize("ahead", ["queued", "in_flight"])
def test_backpressure_rejects_past_the_queue_bound(ahead):
    """Rows queued, or already flushed and in flight, count against the
    bucket's bound; the submission that would pass it is rejected."""
    gate = threading.Event()
    backend = _StubBackend(launch_gate=gate)
    # in flight: 3 rows size-flush at once and park on the launch gate
    max_rows = 10_000 if ahead == "queued" else 3
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=60.0, flush_max_rows=max_rows, max_queue_rows=4))

    async def go():
        first = asyncio.ensure_future(ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0, 1, 2]), backend=backend))
        await asyncio.sleep(0.05)
        with pytest.raises(ExecutorOverloadedError):
            await ex.submit(("s",), KIND_PREP_INIT, (b"k2", [0, 1]), backend=backend)
        if ahead == "queued":
            first.cancel()
            return None
        gate.set()
        return await first

    out = _run(go())
    gate.set()
    ex.shutdown()
    stats = next(iter(ex.stats().values()))
    assert stats["rejections"] == 1
    if ahead == "in_flight":
        assert len(out) == 3


def test_deadline_expired_submission_rejected_at_flush():
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.05, flush_max_rows=10_000))

    async def go():
        # a deadline far shorter than the flush window: expires while queued
        with pytest.raises(ExecutorOverloadedError):
            await ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0]), backend=backend, deadline_s=1e-4)

    _run(go())
    ex.shutdown()
    stats = next(iter(ex.stats().values()))
    assert stats["rejections"] == 1 and stats["flushes"] == 0


def test_deadline_expiry_between_take_pending_and_flush_rejects_retryably():
    """A submission whose deadline passes after the size trigger detached it
    but before its flush runs is rejected retryably, never dropped with an
    unresolved future and never launched past its deadline."""
    backend = _StubBackend()
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=60.0, flush_max_rows=10_000))

    async def go():
        fut = asyncio.ensure_future(
            ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0]), backend=backend, deadline_s=0.02)
        )
        await asyncio.sleep(0)
        with ex._lock:
            bucket = next(iter(ex._buckets.values()))
            subs = ex._take_pending(bucket)
        assert subs
        await asyncio.sleep(0.05)
        await ex._run_flush(bucket, subs, trigger="size")
        with pytest.raises(ExecutorOverloadedError):
            await fut

    _run(go())
    ex.shutdown()
    stats = next(iter(ex.stats().values()))
    assert stats["rejections"] == 1 and stats["depth_rows"] == 0
    assert backend.launches == []


# -- error propagation -------------------------------------------------------


def test_launch_failure_propagates_to_every_job_in_the_flush():
    backend = _StubBackend(fail=True)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.01, flush_max_rows=10_000))

    async def go():
        return await asyncio.gather(
            ex.submit(("s",), KIND_PREP_INIT, (b"k1", [0]), backend=backend),
            ex.submit(("s",), KIND_PREP_INIT, (b"k2", [0]), backend=backend),
            return_exceptions=True,
        )

    a, b = _run(go())
    ex.shutdown()
    assert isinstance(a, RuntimeError) and isinstance(b, RuntimeError)


# -- CudaBackend on the CPU against the JAX package's oracle -----------------


def _shard(jvdaf, measure, count, seed):
    rng = np.random.default_rng(seed)
    reports = []
    for _ in range(count):
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(measure(rng), nonce, rng.bytes(jvdaf.RAND_SIZE))
        reports.append((nonce, public, shares))
    return reports


@pytest.mark.parametrize(
    "circuit",
    [
        ("count", lambda: instances.prio3_count(), lambda: jax_instances.prio3_count(), lambda r: int(r.integers(0, 2))),
        (
            "histogram",
            lambda: instances.prio3_histogram(17, 5),
            lambda: jax_instances.prio3_histogram(17, 5),
            lambda r: int(r.integers(0, 17)),
        ),
    ],
    ids=lambda c: c[0],
)
def test_coalesced_results_byte_identical_to_jax_oracle(circuit):
    """Two tasks' submissions coalesce into one flush a side and one combine
    flush; every prepare share, out share, seed and prep message equals the
    JAX package's OracleBackend byte for byte."""
    _, port_vdaf, jax_vdaf, measure = circuit
    vdaf, jvdaf = port_vdaf(), jax_vdaf()
    backend = CudaBackend(vdaf, device="cpu")
    oracle = JaxOracleBackend(jvdaf)
    key = vdaf_shape_key(vdaf)
    vks = (b"\x01" * 16, b"\x02" * 16)
    tasks = (_shard(jvdaf, measure, 3, 1), _shard(jvdaf, measure, 2, 2))
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, flush_max_rows=1024))

    async def go():
        outs = {}
        for agg_id in (0, 1):
            outs[agg_id] = await asyncio.gather(*[
                ex.submit(key, KIND_PREP_INIT, (vk, [(n, p, s[agg_id]) for n, p, s in rows]), backend=backend,
                          agg_id=agg_id)
                for vk, rows in zip(vks, tasks)
            ])
        msgs = await asyncio.gather(*[
            ex.submit(key, KIND_COMBINE, [[a[1], h[1]] for a, h in zip(outs[0][t], outs[1][t])], backend=backend)
            for t in range(2)
        ])
        return outs, msgs

    outs, msgs = _run(go(), timeout=120.0)
    ex.shutdown()
    stats = ex.stats()
    assert all(s["flushes"] == 1 and s["flushed_jobs"] == 2 for s in stats.values()), stats
    for t, (vk, rows) in enumerate(zip(vks, tasks)):
        want = {a: oracle.prep_init_batch(vk, a, [(n, p, s[a]) for n, p, s in rows]) for a in (0, 1)}
        for a in (0, 1):
            for (gs, gp), (ws, wp) in zip(outs[a][t], want[a]):
                assert gp.encode(vdaf) == wp.encode(jvdaf)
                assert gs.out_share == ws.out_share
                assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed
        assert msgs[t] == oracle.prep_shares_to_prep_batch([[w0[1], w1[1]] for w0, w1 in zip(want[0], want[1])])


@pytest.mark.parametrize(
    "point,rel",
    [
        ("executor.flush", "executor/service.py"),
        ("backend.launch", "vdaf/backend.py"),
        ("backend.device_lost", "vdaf/backend.py"),
        ("backend.combine", "vdaf/backend.py"),
        ("accumulator.spill", "executor/accumulator.py"),
        ("accumulator.evict", "executor/accumulator.py"),
    ],
)
def test_port_wires_its_fault_points(point, rel):
    """Each fault point of the executor slice is a KNOWN_POINTS name and is
    fired at its call site in the port (a renamed point fails here rather
    than silently stop injecting).  The control plane's points come with
    its copy."""
    from pathlib import Path

    import janus_tpu_torch
    from janus_tpu_torch.core import faults

    assert point in faults.KNOWN_POINTS
    assert f'"{point}"' in (Path(janus_tpu_torch.__file__).parent / rel).read_text()


def test_driver_surfaces_overload_as_retryable_jobsteperror():
    """The driver contract: executor backpressure -> JobStepError(retryable)
    so the lease machinery redelivers the job."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig, JobStepError

    ex = DeviceExecutor(ExecutorConfig(max_queue_rows=2, flush_window_s=60.0))
    try:
        driver = AggregationJobDriver(
            datastore=None,
            session_factory=None,
            config=DriverConfig(vdaf_device="cpu", device_executor=ex),
        )
        assert driver._executor is not None
        backend = _StubBackend()
        # pre-fill the bucket (oversized jobs on an EMPTY bucket are
        # admitted, so backpressure needs something queued ahead)
        key = AggregationJobDriver._vdaf_shape_key(backend.vdaf)

        async def go():
            filler = asyncio.ensure_future(
                driver._executor.submit(key, KIND_PREP_INIT, (b"vk0", [0, 1]), backend=backend)
            )
            await asyncio.sleep(0)
            with pytest.raises(JobStepError) as exc_info:
                await driver._coalesced_prep_init(backend, b"vk", [0, 1, 2])
            assert exc_info.value.retryable
            filler.cancel()

        _run(go())
    finally:
        ex.shutdown(drain=False)


# -- canonical shape buckets --------------------------------------------------


def test_two_lengths_share_one_cached_backend_and_one_flush():
    """Histogram(7, 3) and (8, 3), both below their bucket's ceiling, key to
    one canonical entry: one cached twin backend (Histogram(9, 3)), one
    bucket and one flush a side holding both tasks' jobs, and every row
    equal to its own task's JAX oracle."""
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.canonical import executor_shape

    tasks = [(instances.prio3_histogram(n, 3), jax_instances.prio3_histogram(n, 3)) for n in (7, 8)]
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.05, flush_max_rows=1024))
    assert ex.config.canonical_shapes
    (k7, c7), (k8, _c8) = (executor_shape(v) for v, _ in tasks)
    assert k7 == k8 and c7.flp.valid.length == 9
    backend = ex.backend_for(k7, lambda: make_backend(c7, "cuda", device="cpu", canonical=True))
    assert ex.backend_for(k8, lambda: pytest.fail("the second task must hit the cache")) is backend
    assert backend.canonical
    vks = (b"\x05" * 16, b"\x06" * 16)
    reports = [_shard(j, lambda r, n=v.flp.valid.length: int(r.integers(0, n)), 2 + i, 70 + i)
               for i, (v, j) in enumerate(tasks)]

    async def go():
        return {
            agg_id: await asyncio.gather(*[
                ex.submit(k7, KIND_PREP_INIT, (vk, [(n, p, s[agg_id]) for n, p, s in rows], v), backend=backend,
                          agg_id=agg_id)
                for vk, rows, (v, _j) in zip(vks, reports, tasks)
            ])
            for agg_id in (0, 1)
        }

    outs = _run(go(), timeout=120.0)
    ex.shutdown()
    stats = ex.stats()
    assert len(stats) == 2 and all(s["flushes"] == 1 and s["flushed_jobs"] == 2 for s in stats.values()), stats
    for t, ((vdaf, jvdaf), vk, rows) in enumerate(zip(tasks, vks, reports)):
        for agg_id in (0, 1):
            want = JaxOracleBackend(jvdaf).prep_init_batch(vk, agg_id, [(n, p, s[agg_id]) for n, p, s in rows])
            for (gs, gp), (ws, wp) in zip(outs[agg_id][t], want):
                assert gp.encode(vdaf) == wp.encode(jvdaf)
                assert gs.out_share == ws.out_share and len(gs.out_share) == vdaf.flp.OUTPUT_LEN
                assert gs.corrected_joint_rand_seed == ws.corrected_joint_rand_seed


def test_bisection_keeps_the_task_vdaf_of_each_request():
    """A failed canonical flush is sieved in halves with each request's
    third element (the task's VDAF) kept, so the retried rows still marshal
    at their task's length and equal its oracle."""
    from janus_tpu_torch.vdaf.canonical import executor_shape

    vdaf, jvdaf = instances.prio3_histogram(7, 3), jax_instances.prio3_histogram(7, 3)
    key, twin = executor_shape(vdaf)
    backend = CudaBackend(twin, device="cpu", canonical=True)
    real_launch = backend.launch_prep_init_multi
    seen = []

    def launch(staged, requests, retain_store=None):
        seen.append([len(r) for r in requests])
        if staged.rows > 1:  # the whole flush fails; singletons serve
            raise RuntimeError("device on fire")
        return real_launch(staged, requests, retain_store=retain_store)

    backend.launch_prep_init_multi = launch
    rows = [(n, p, s[0]) for n, p, s in _shard(jvdaf, lambda r: int(r.integers(0, 7)), 2, 9)]
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.01, breaker_failure_threshold=0))
    try:
        got = _run(ex.submit(key, KIND_PREP_INIT, (b"\x07" * 16, rows, vdaf), backend=backend), timeout=60.0)
    finally:
        ex.shutdown()
    assert seen and all(lens == [3] for lens in seen)
    want = JaxOracleBackend(jvdaf).prep_init_batch(b"\x07" * 16, 0, rows)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs.out_share == ws.out_share and gp.verifiers_share == wp.verifiers_share


def test_driver_resolves_the_twin_and_never_caches_an_oracle_under_its_key(monkeypatch):
    """With ``vdaf_backend: oracle`` a canonicalizable task resolves under its
    EXACT key (an oracle under the shared canonical key would serve every
    other bucket member a wrong-shaped circuit); on the card backend it gets
    the bucket's twin under the tagged key; a twin that fails to build is
    negative-cached and the task falls back to its exact-shape backend."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig
    from janus_tpu_torch.vdaf import backend as backend_mod
    from janus_tpu_torch.vdaf.canonical import backend_shape_key, executor_shape

    h5 = instances.prio3_histogram(5, 2)
    canon_key, canon = executor_shape(h5)
    task = SimpleNamespace(task_id="t-canonical")
    for name, device in (("oracle", None), ("cuda", "cpu")):
        ex = DeviceExecutor(ExecutorConfig())
        try:
            driver = AggregationJobDriver(None, None, DriverConfig(vdaf_backend=name, vdaf_device=device,
                                                                   device_executor=ex))
            b = driver._backend_for(task, h5)
            if name == "oracle":
                assert isinstance(b, OracleBackend) and b.vdaf is h5
                assert canon_key not in driver._backends and vdaf_shape_key(h5) in driver._backends
                assert ex.cached_backend(canon_key) is None
            else:
                assert isinstance(b, CudaBackend) and b.canonical and b.vdaf is canon
                assert ex.cached_backend(canon_key) is b and backend_shape_key(b) == canon_key
                assert driver._backend_for(task, instances.prio3_histogram(5, 2)) is b
        finally:
            ex.shutdown(drain=False)

    def refuse(vdaf, backend="cuda", device=None, canonical=False):
        if canonical:
            raise RuntimeError("twin build failed")
        return CudaBackend(vdaf, device=device)

    monkeypatch.setattr(backend_mod, "make_backend", refuse)
    ex = DeviceExecutor(ExecutorConfig())
    try:
        driver = AggregationJobDriver(None, None, DriverConfig(vdaf_device="cpu", device_executor=ex))
        b = driver._backend_for(task, h5)
        assert isinstance(b, CudaBackend) and not b.canonical and b.vdaf is h5
        assert canon_key in ex.canonical_build_failed and ex.cached_backend(canon_key) is None
        assert backend_shape_key(b) == vdaf_shape_key(h5)
    finally:
        ex.shutdown(drain=False)


def test_deferred_drain_merges_the_clipped_vector(monkeypatch):
    """A deferred canonical bucket drained at shutdown (``drain_all`` into the
    driver's ``_merge_drained``, the path every journaled drain takes) merges
    the vector clipped back to the task's OUTPUT_LEN: the store clips each
    readback to its rows' width, so the merge never sees the twin's tail."""
    from janus_tpu_torch.aggregator import aggregation_job_writer
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig
    from janus_tpu_torch.executor.accumulator import AccumulatorConfig, DeviceAccumulatorStore
    from janus_tpu_torch.vdaf.canonical import executor_shape

    merged = []
    monkeypatch.setattr(aggregation_job_writer, "merge_share_delta",
                        lambda tx, task, field, ident, param, vector, shard_count: merged.append(vector))
    tx = SimpleNamespace(delete_accumulator_journal_entry=lambda *a: True)
    datastore = SimpleNamespace(run_tx=lambda name, fn: fn(tx))
    driver = AggregationJobDriver(datastore, None, DriverConfig(vdaf_device="cpu"))
    h5, jh5 = instances.prio3_histogram(5, 2), jax_instances.prio3_histogram(5, 2)
    _key, twin = executor_shape(h5)
    backend = CudaBackend(twin, device="cpu", canonical=True)
    backend.one_shape_exact = False
    store = DeviceAccumulatorStore(AccumulatorConfig(enabled=True, drain_interval_s=60.0))
    rows = [(n, p, s[0]) for n, p, s in _shard(jh5, lambda r: int(r.integers(0, 5)), 3, 55)]
    reqs = [(b"\x08" * 16, rows, h5)]
    out = backend.launch_prep_init_multi(backend.stage_prep_init_multi(0, reqs), reqs, retain_store=store)
    key = ("leader", b"t", vdaf_shape_key(h5), b"ident", b"")
    store.commit_rows(key, backend, [st.out_share for st, _ in out[0]], job_token=b"j" * 16,
                      report_ids=[r[0] for r in rows])
    task = SimpleNamespace(task_id="t", vdaf_instance=lambda: h5)
    store.drain_all(lambda k, vector, journal: driver._merge_drained(task, h5.flp.field, k, vector, journal))
    want = jh5.aggregate([st.out_share for st, _ in JaxOracleBackend(jh5).prep_init_batch(b"\x08" * 16, 0, rows)])
    assert merged == [want] and len(want) == 5
