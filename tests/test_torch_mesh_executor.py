"""The port's executor on a mesh (janus_tpu_torch/executor/service.py).

The cases of ``tests/test_mesh_executor.py`` on the port's copy, with
``MeshBackend`` over logical CPU shards: ``ExecutorConfig(mesh=True)``
upgrades a cached ``CudaBackend`` (keeping its field layout and canonical
mode) and passes the oracle, the hybrid and Poplar1 through; flush tails
pad to a multiple of the shard count; a coalesced uneven flush and the
leader driver's coalesced prepare equal the JAX oracle; a resident flush's
masked accumulate is bit-exact with no out-share readback; one breaker a
mesh (a ``backend.device_lost`` trip refuses every shape on it, and it
retires only when every shape is idle); and the per-shape quarantine,
which refuses a failing shape's work as retryable while the rest of its
mesh launches, never through the oracle.  Then the binaries' config:
``vdaf_backend: mesh`` and ``device_executor.mesh: true`` load and serve
a Count job with ``vdaf_device: cpu``."""

import asyncio
import time
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
    CircuitOpenError,
    DeviceExecutor,
    ExecutorConfig,
    ResidentRef,
    breaker_domain,
)
from janus_tpu_torch.vdaf import instances
from janus_tpu_torch.vdaf.backend import CudaBackend, MeshBackend, OracleBackend, make_backend, vdaf_shape_key

SHARDS = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


def _run(coro, timeout=60.0):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def _count_rows(n, seed, agg_id=0):
    jvdaf = jax_instances.prio3_count()
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        nonce = rng.bytes(16)
        public, shares = jvdaf.shard(i % 2, nonce, rng.bytes(jvdaf.RAND_SIZE))
        rows.append((nonce, public, shares[agg_id]))
    return rows


def _assert_oracle(vdaf, got, vk, rows, agg_id=0):
    want = JaxOracleBackend(jax_instances.prio3_count()).prep_init_batch(vk, agg_id, rows)
    assert len(got) == len(want)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs.out_share == ws.out_share
        assert gp.verifiers_share == wp.verifiers_share


# -- the upgrade -----------------------------------------------------------------


def test_mesh_flag_upgrades_cached_cuda_backends():
    """``mesh=True``: backend_for wraps an exact-type CudaBackend into a
    MeshBackend over its process's devices before caching (the CPU device
    alone here), keeping the field layout and canonical mode; the cache
    returns the same upgraded instance to every later caller."""
    from janus_tpu_torch.vdaf.canonical import executor_shape

    ex = DeviceExecutor(ExecutorConfig(mesh=True))
    vdaf = instances.prio3_count()
    b = ex.backend_for(("shape",), lambda: CudaBackend(vdaf, device="cpu", field_backend="mxu"))
    assert type(b) is MeshBackend and b.field_backend == "mxu" and b.bp.field_backend == "mxu"
    assert [d.type for d in b.devices] == ["cpu"] and b.mesh_devices == ("cpu",)
    assert ex.backend_for(("shape",), lambda: pytest.fail("cached")) is b
    _key, twin = executor_shape(instances.prio3_histogram(7, 3))
    canon = ex.backend_for(("canon",), lambda: CudaBackend(twin, device="cpu", canonical=True))
    assert type(canon) is MeshBackend and canon.canonical and canon.vdaf is twin
    ex.shutdown()
    plain = DeviceExecutor(ExecutorConfig())
    assert type(plain.backend_for(("shape",), lambda: CudaBackend(vdaf, device="cpu"))) is CudaBackend
    plain.shutdown()


def test_meshify_passes_through_what_it_cannot_shard():
    """The oracle, the HMAC hybrid, Poplar1 and a mesh pass through."""
    hybrid = make_backend(instances.prio3_sum_vec_field64_multiproof_hmacsha256_aes128(2, 4, 1, 2), device="cpu")
    poplar = make_backend(instances.vdaf_from_instance({"type": "Poplar1", "bits": 4}), device="cpu")
    mesh = MeshBackend(instances.prio3_count(), devices=SHARDS)
    for backend in (OracleBackend(instances.prio3_count()), hybrid, poplar, mesh):
        assert DeviceExecutor._meshify(backend) is backend


def test_pad_alignment_multiple_of_the_shard_count():
    """Flush tails pad to a multiple of the shard count on top of the
    power-of-two bucket, and a requested pad (the warmup's) is aligned
    too: every shard gets the same rows."""
    vdaf = instances.prio3_count()
    for n in (3, 4, 8):
        mesh = MeshBackend(vdaf, devices=["cpu"] * n)
        for B in (1, 3, 8, 11, 100):
            pad = mesh._pad_to(B)
            assert pad % n == 0 and pad >= B and pad >= n
    mesh = MeshBackend(vdaf, devices=["cpu"] * 3)
    assert mesh._align_pad(9) == 9 and mesh._align_pad(16) == 18
    staged = mesh.stage_prep_init_multi(0, [(b"\x2a" * 16, _count_rows(3, 1))], pad_to=16)
    assert staged.pad_to == 18 and [p["nonces_u8"].shape[0] for p in staged.placed] == [6, 6, 6]


# -- sharded flushes ---------------------------------------------------------------


def test_uneven_tail_coalesced_flush_matches_the_oracle():
    """Two tasks coalesce into one sharded flush of 11 rows (padded to 16,
    four rows a shard, the last shard holding 3 real rows): each task's
    results equal the JAX oracle's."""
    vdaf = instances.prio3_count()
    mesh = MeshBackend(vdaf, devices=SHARDS)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.05, flush_max_rows=4096))
    vk_a, vk_b = b"\x0a" * 16, b"\x0b" * 16
    rows_a, rows_b = _count_rows(7, 10), _count_rows(4, 11)
    key = vdaf_shape_key(vdaf)

    async def go():
        return await asyncio.gather(
            ex.submit(key, KIND_PREP_INIT, (vk_a, rows_a), backend=mesh, task_ident=b"A"),
            ex.submit(key, KIND_PREP_INIT, (vk_b, rows_b), backend=mesh, task_ident=b"B"),
        )

    got_a, got_b = _run(go())
    stats = ex.stats()
    ex.shutdown()
    assert [s["flushes"] for s in stats.values()] == [1]
    _assert_oracle(vdaf, got_a, vk_a, rows_a)
    _assert_oracle(vdaf, got_b, vk_b, rows_b)


def test_resident_flush_masked_accumulate_bit_exact_zero_readback():
    """The accumulator contract on the mesh: the retained flush stays one
    piece a shard, a masked commit sums per shard, the one cross-shard sum
    happens at drain, bit-exact against the oracle, with no out-share row
    read back and the buffer counted at one partial row a shard."""
    vdaf = instances.prio3_count()
    mesh = MeshBackend(vdaf, devices=SHARDS)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.02, accumulator=AccumulatorConfig(enabled=True)))
    store = ex.accumulator
    vk = b"\x2a" * 16
    rows = _count_rows(11, 12)

    out = _run(ex.submit(vdaf_shape_key(vdaf), KIND_PREP_INIT, (vk, rows), backend=mesh, retain_out_shares=True))
    assert mesh.outshare_readback_rows == 0
    refs = [state.out_share for state, _ in out]
    assert all(isinstance(r, ResidentRef) for r in refs)
    keep = [i for i in range(len(refs)) if i % 2 == 0]
    store.commit_rows(("bucket",), mesh, [refs[i] for i in keep], job_token=b"job",
                      report_ids=[rows[i][0] for i in keep])
    assert mesh.accum_buffer_rows == len(SHARDS)
    assert store.stats()["resident_bytes"] >= len(SHARDS) * vdaf.flp.OUTPUT_LEN * mesh.bp.f.n * 8
    store.release_refs([refs[i] for i in range(len(refs)) if i % 2])
    vector, rids = store.drain(("bucket",), vdaf.flp.field)
    ex.shutdown()
    want = JaxOracleBackend(jax_instances.prio3_count()).prep_init_batch(vk, 0, rows)
    assert vector == jax_instances.prio3_count().aggregate([want[i][0].out_share for i in keep])
    assert rids == {rows[i][0] for i in keep}
    assert mesh.outshare_readback_rows == 0 and store.stats()["flushes_resident"] == 0


# -- one breaker a mesh -------------------------------------------------------------


class _MeshDouble:
    """Stage/launch double that looks mesh-backed (``mesh_devices``) and
    fires the real ``backend.device_lost`` point on launch; ``fail`` makes
    its launches fail on their own (a shape-local failure)."""

    def __init__(self, vdaf, devices, fail=False):
        self.vdaf = vdaf
        self.mesh_devices = tuple(devices)
        self.fail = fail
        self.launches = 0

    def stage_prep_init_multi(self, agg_id, requests, pad_to=None):
        rows = sum(len(r[1]) for r in requests)
        return SimpleNamespace(agg_id=agg_id, placed=None, pad_to=rows, rows=rows)

    def launch_prep_init_multi(self, staged, requests, retain_store=None):
        self.launches += 1
        faults.fire("backend.device_lost")
        if self.fail:
            raise RuntimeError("this shape's launch fails")
        return [[("ok", i) for i in range(len(r[1]))] for r in requests]


COUNT_KEY = vdaf_shape_key(instances.prio3_count())
HIST_KEY = vdaf_shape_key(instances.prio3_histogram(4, 2))


def test_device_lost_opens_one_breaker_for_every_shape_on_the_mesh():
    """Breaker scope is the MESH: after device-lost failures on shape A,
    shape B (same device set, never launched) is refused at once with
    CircuitOpenError, and exactly one mesh-labelled breaker exists."""
    devices = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    backend_a = _MeshDouble(instances.prio3_count(), devices)
    backend_b = _MeshDouble(instances.prio3_histogram(4, 2), devices)
    assert breaker_domain(COUNT_KEY, backend_a) == breaker_domain(HIST_KEY, backend_b)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.005, breaker_failure_threshold=2,
                                       breaker_reset_timeout_s=60.0))
    faults.configure([FaultSpec("backend.device_lost", "error", 1.0)], seed=7)

    async def go():
        for _ in range(2):
            with pytest.raises(Exception, match="device_lost"):
                await ex.submit(COUNT_KEY, KIND_PREP_INIT, (b"k", [0]), backend=backend_a)
        with pytest.raises(CircuitOpenError):
            await ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=backend_b)

    _run(go())
    assert backend_b.launches == 0, "shape B must be refused, not launched"
    assert ex.circuit_open(COUNT_KEY) and ex.circuit_open(HIST_KEY)
    (label,) = ex.circuit_stats()
    assert label.startswith("mesh[4]#"), label
    ex.shutdown()


def test_mesh_breaker_retires_only_when_every_shape_is_idle():
    backend = _MeshDouble(instances.prio3_count(), ["cuda:0", "cuda:1"])
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.005, breaker_failure_threshold=2))

    async def go():
        await ex.submit(COUNT_KEY, KIND_PREP_INIT, (b"k", [0]), backend=backend)
        await ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=backend)

    _run(go())
    assert len(ex.circuit_stats()) == 1
    ex._buckets[(COUNT_KEY, KIND_PREP_INIT, 0, None)].last_activity -= 1000
    ex.retire_idle_buckets(max_idle_s=600)
    assert len(ex.circuit_stats()) == 1, "the breaker retired while shape B is live"
    ex._buckets[(HIST_KEY, KIND_PREP_INIT, 0, None)].last_activity -= 1000
    ex.retire_idle_buckets(max_idle_s=600)
    assert ex.circuit_stats() == {} and not ex._breaker_by_shape
    ex.shutdown()


# -- per-shape quarantine ---------------------------------------------------------


def test_shape_quarantine_refuses_as_retryable_and_expires():
    """Shape B fails on its own twice while shape A on the same mesh keeps
    succeeding (the healthy-domain witness): B's bucket is quarantined and
    the mesh's breaker stays closed.  B's work is refused with
    CircuitOpenError (the driver's retryable JobStepError), never served
    elsewhere, while A keeps launching; /statusz shows it; after the dwell
    B launches again.  Without the witness the same failures count
    against the breaker."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig, JobStepError
    from janus_tpu_torch.core.statusz import runtime_status

    devices = ["cuda:0", "cuda:1"]
    healthy = _MeshDouble(instances.prio3_count(), devices)
    sick = _MeshDouble(instances.prio3_histogram(4, 2), devices, fail=True)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.002, breaker_failure_threshold=5,
                                       bucket_quarantine_threshold=2, bucket_quarantine_s=0.3))
    driver = AggregationJobDriver(datastore=None, session_factory=None,
                                  config=DriverConfig(vdaf_device="cpu", device_executor=ex))

    async def go():
        await ex.submit(COUNT_KEY, KIND_PREP_INIT, (b"k", [0]), backend=healthy)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                await ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=sick)
        with pytest.raises(CircuitOpenError, match="quarantined"):
            await ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=sick)
        with pytest.raises(JobStepError) as refused:
            await driver._coalesced_prep_init(sick, b"k", [0])
        assert refused.value.retryable
        assert await ex.submit(COUNT_KEY, KIND_PREP_INIT, (b"k", [1]), backend=healthy) == [("ok", 0)]

    _run(go())
    assert sick.launches == 2 and healthy.launches == 2
    assert ex.circuit_open(HIST_KEY) and not ex.circuit_open(COUNT_KEY)
    (circuit,) = ex.circuit_stats().values()
    assert circuit["state"] == "closed" and circuit["trips"] == 0
    stats = runtime_status(ex)["executor"]["bucket_quarantine"]
    assert stats["total"] == 1 and len(stats["quarantined"]) == 1
    time.sleep(0.35)
    assert not ex.circuit_open(HIST_KEY)
    sick.fail = False
    assert _run(ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=sick)) == [("ok", 0)]
    assert ex.bucket_quarantine_stats()["fail_streaks"] == {}
    ex.shutdown()

    # no witness: the same failures go to the (closed -> open) breaker
    lone = _MeshDouble(instances.prio3_histogram(4, 2), ["cuda:2"], fail=True)
    ex = DeviceExecutor(ExecutorConfig(flush_window_s=0.002, breaker_failure_threshold=2))

    async def fail_twice():
        for _ in range(2):
            with pytest.raises(RuntimeError):
                await ex.submit(HIST_KEY, KIND_PREP_INIT, (b"k", [0]), backend=lone)

    _run(fail_twice())
    assert ex.bucket_quarantine_stats()["total"] == 0
    assert [c["state"] for c in ex.circuit_stats().values()] == ["open"]
    ex.shutdown()


# -- the driver and the binaries' config ----------------------------------------------


def test_driver_coalesced_prep_on_a_mesh_matches_the_oracle():
    """The leader driver with ``mesh=True``: the factory's CudaBackend is
    upgraded before caching (a mesh on the CPU), a ready mesh passes
    through, and the coalesced prepare equals the JAX oracle."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, DriverConfig

    ex = DeviceExecutor(ExecutorConfig(mesh=True, flush_window_s=0.02))
    try:
        driver = AggregationJobDriver(datastore=None, session_factory=None,
                                      config=DriverConfig(vdaf_device="cpu", device_executor=ex))
        vdaf = instances.prio3_count()
        key = AggregationJobDriver._vdaf_shape_key(vdaf)
        assert type(ex.backend_for(key, lambda: CudaBackend(vdaf, device="cpu"))) is MeshBackend
        sharded = ex.backend_for(("four",), lambda: MeshBackend(vdaf, devices=SHARDS))
        vk = b"\x2a" * 16
        rows = _count_rows(6, 13)
        for backend in (ex.cached_backend(key), sharded):
            out = _run(driver._coalesced_prep_init(backend, vk, rows, task_ident=b"t"))
            _assert_oracle(vdaf, out, vk, rows)
    finally:
        ex.shutdown()


@pytest.mark.parametrize(
    "text",
    [
        "vdaf_backend: mesh\nvdaf_device: cpu\n",
        "vdaf_device: cpu\ndevice_executor: {enabled: true, mesh: true}\n",
    ],
    ids=["vdaf_backend_mesh", "device_executor_mesh"],
)
def test_binaries_config_serves_a_count_job_on_the_mesh(text):
    """``vdaf_backend: mesh`` and ``device_executor.mesh: true`` load, pass
    the startup device check with ``vdaf_device: cpu``, and reach the
    driver, whose Count job prepares on a MeshBackend equal to the oracle;
    the aggregator's config resolves the same backend."""
    from janus_tpu_torch.aggregator.aggregator import resolve_backend
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.binaries import main
    from janus_tpu_torch.binaries.config import AggregatorConfig, JobDriverBinaryConfig, load_config

    cfg = load_config(JobDriverBinaryConfig, text=text)
    main._check_vdaf_device(cfg.vdaf_backend, cfg.vdaf_device)
    ex = main._build_executor(cfg.device_executor)
    try:
        driver = AggregationJobDriver(datastore=None, session_factory=None,
                                      config=main.aggregation_driver_config(cfg, executor=ex))
        vdaf = instances.prio3_count()
        backend = driver._backend_for(SimpleNamespace(task_id=b"t" * 32), vdaf)
        assert type(backend) is MeshBackend
        vk, rows = b"\x2c" * 16, _count_rows(5, 14)
        _assert_oracle(vdaf, _run(driver._coalesced_prep_init(backend, vk, rows, task_ident=b"t")), vk, rows)
    finally:
        if ex is not None:
            ex.shutdown()
    agg = load_config(AggregatorConfig, text=text)
    assert agg.device_executor.to_executor_config().mesh is agg.device_executor.mesh
    config = main.aggregator_config(agg)
    if config.vdaf_backend == "mesh":
        assert type(resolve_backend(vdaf, config.vdaf_backend, config.vdaf_device)) is MeshBackend
