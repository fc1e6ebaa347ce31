"""The port's control plane end to end: a leader and a helper aggregator,
each with its own datastore, take uploads, aggregate through the device
executor and collect, on the port's ``CudaBackend`` (here on the CPU, where
every kernel wrapper takes its plain version).  The pair runs over aiohttp
and over the in-process transport (``aggregator/test_util.py``), and the
collected aggregate equals the JAX oracle's.  Two mixed pairs (the port's
leader with the JAX package's helper, and the reverse) show that the wire
formats and the prepare shares of the two packages are interchangeable."""

import asyncio
import importlib
import secrets

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from janus_tpu_torch.client import seal_report
from janus_tpu_torch.collector import Collector
from janus_tpu_torch.core.auth_tokens import AuthenticationToken
from janus_tpu_torch.core.hpke import HpkeKeypair
from janus_tpu_torch.datastore.task import vdaf_verify_key_length
from janus_tpu_torch.messages import Duration, Interval, Query, ReportId, Time
from janus_tpu_torch.vdaf.instances import vdaf_from_instance

TIME_PRECISION = 3600
NOW = 1_600_002_000
AGG_TOKEN = "agg-token-pair"
COL_TOKEN = "col-token-pair"

FAMILIES = {
    "count": ({"type": "Prio3Count"}, lambda r: int(r.integers(0, 2))),
    "sum": ({"type": "Prio3Sum", "bits": 8}, lambda r: int(r.integers(0, 256))),
    "histogram": ({"type": "Prio3Histogram", "length": 6, "chunk_length": 2}, lambda r: int(r.integers(0, 6))),
    "sumvec": (
        {"type": "Prio3SumVec", "length": 10, "bits": 1, "chunk_length": 3},
        lambda r: [int(x) for x in r.integers(0, 2, 10)],
    ),
    "fixedpoint": (
        {"type": "Prio3FixedPointBoundedL2VecSum", "bitsize": "BitSize16", "length": 3},
        lambda r: [float(x) for x in r.choice([-0.25, 0.0, 0.5], 3)],
    ),
    "multiproof": (
        {"type": "Prio3SumVecField64MultiproofHmacSha256Aes128", "proofs": 2, "length": 4, "bits": 1,
         "chunk_length": 2},
        lambda r: [int(x) for x in r.integers(0, 2, 4)],
    ),
}
VALID = 5

#: Poplar1 heavy hitters: ``VALID`` 4-bit values (and one report whose
#: leader IDPF key is flipped), collected at level 1 over every 2-bit
#: prefix and then at the leaf over the values whose prefix recurs
POPLAR_DESC = {"type": "Poplar1", "bits": 4}
POPLAR_VALUES = [0b1011, 0b0100, 0b1011, 0b1110, 0b1011]
POPLAR_LEVELS = [(1, (0b00, 0b01, 0b10, 0b11)), (3, (0b1011, 0b1110))]
#: the port leader's deferred-drain interval, seconds: longer than a
#: level's job steps, so that no bucket drains while a job still commits
POPLAR_DRAIN_S = 0.2


def poplar_counts(values, bits, level, prefixes):
    """The plain count of ``values`` under each ``level`` prefix."""
    return [sum(1 for m in values if m >> (bits - 1 - level) == p) for p in prefixes]


def jax_oracle_aggregate(desc, measurements):
    """The JAX package's CPU oracle over ``measurements``: shard, prepare
    both sides, combine, aggregate and unshard."""
    from janus_tpu.vdaf.instances import vdaf_from_instance as jax_vdaf_from_instance

    vdaf = jax_vdaf_from_instance(desc)
    vk = b"\x2a" * vdaf_verify_key_length(desc)
    out = [[], []]
    for m in measurements:
        nonce = secrets.token_bytes(vdaf.NONCE_SIZE)
        public, shares = vdaf.shard(m, nonce, secrets.token_bytes(vdaf.RAND_SIZE))
        inits = [vdaf.prep_init(vk, a, nonce, public, shares[a]) for a in (0, 1)]
        msg = vdaf.prep_shares_to_prep([s for _st, s in inits])
        for a in (0, 1):
            out[a].append(vdaf.prep_next(inits[a][0], msg))
    aggs = [vdaf.aggregate(out[a]) for a in (0, 1)]
    return vdaf.unshard(aggs, len(measurements))


def reports_for(vdaf, desc_rng, task, leader_cfg, helper_cfg, n_valid, measure, tamper=True):
    """``n_valid`` honest reports and, with ``tamper``, one whose leader
    measurement share is perturbed (the proof then fails); returns
    (reports, valid measurements)."""
    reports, meas = [], []
    t = Time(NOW - NOW % TIME_PRECISION)
    for i in range(n_valid + tamper):
        m = measure(desc_rng)
        rid = ReportId.random()
        public, shares = vdaf.shard(m, rid.data, secrets.token_bytes(vdaf.RAND_SIZE))
        if i == n_valid and hasattr(vdaf, "flp"):
            f = vdaf.flp.field
            shares[0].meas_share = [(shares[0].meas_share[0] + 1) % f.MODULUS] + list(shares[0].meas_share[1:])
        elif i == n_valid:  # Poplar1: the leader's IDPF key, flipped
            shares[0].idpf_key = bytes(b ^ 0x5A for b in shares[0].idpf_key)
        else:
            meas.append(m)
        reports.append(seal_report(vdaf, task, leader_cfg, helper_cfg, rid, t, public, shares))
    return reports, meas


class Pair:
    """A leader and a helper from packages ``leader_pkg`` / ``helper_pkg``
    ("janus_tpu_torch" or "janus_tpu") over ``transport`` ("aiohttp" or
    "inproc"); the port's sides run ``CudaBackend`` on the CPU behind their
    own executor with the accumulator on, or the oracle when ``oracle``."""

    def __init__(self, desc, leader_pkg, helper_pkg, transport, oracle=False, drain_s=None):
        self.desc = desc
        #: the port leader's deferred-drain interval (Poplar1: POPLAR_DRAIN_S)
        self.drain_s = POPLAR_DRAIN_S if desc["type"] == "Poplar1" else drain_s
        self.pkgs = {"leader": leader_pkg, "helper": helper_pkg}
        self.transport = transport
        self.oracle = oracle
        self.executors = {}
        #: accumulator-journal rows the leader's collection driver
        #: recomputed on the oracle (a drain that came too late)
        self.journal_replays = 0
        #: each port side's backend of the task after the run: the one its
        #: executor caches, else (a backend with no executor surface, which
        #: the helper calls directly) its task aggregator's
        self.backends = {}

    def _mod(self, side, name):
        return importlib.import_module(f"{self.pkgs[side]}.{name}")

    def _aggregator(self, side, clock):
        pkg = self.pkgs[side]
        agg_mod = self._mod(side, "aggregator")
        ds = self._mod(side, "datastore.test_util").EphemeralDatastore(clock)
        kw = {"max_upload_batch_write_delay": 0.01}
        if self.desc["type"] == "Poplar1":
            kw["max_agg_param_job_size"] = 2  # several jobs a level
        if pkg == "janus_tpu":
            kw["vdaf_backend"] = "oracle"
        elif self.oracle:
            kw["vdaf_backend"] = "oracle"
        else:
            ex = importlib.import_module("janus_tpu_torch.executor")
            acc = {"enabled": True}
            if side == "leader" and self.drain_s:
                # deferred drains (Poplar1: the leader keeps its sketch
                # vectors on the device across the WAITING_LEADER hop)
                acc["drain_interval_s"] = self.drain_s
            self.executors[side] = ex.DeviceExecutor(
                ex.ExecutorConfig(flush_window_s=0.001, accumulator=ex.AccumulatorConfig(**acc))
            )
            kw.update(vdaf_device="cpu", device_executor=self.executors[side])
        return ds, agg_mod.Aggregator(ds.datastore, clock, agg_mod.Config(**kw))

    def _task(self, side, peer_url, collector_config):
        M = self._mod(side, "messages")
        dsm = self._mod(side, "datastore")
        auth = self._mod(side, "core.auth_tokens").AuthenticationToken
        hpke = self._mod(side, "core.hpke").HpkeKeypair
        common = dict(
            task_id=M.TaskId(self.task_id.data),
            query_type=dsm.TaskQueryType.time_interval(),
            vdaf=self.desc,
            vdaf_verify_key=b"\x2a" * vdaf_verify_key_length(self.desc),
            min_batch_size=1,
            time_precision=M.Duration(TIME_PRECISION),
            collector_hpke_config=M.HpkeConfig.get_decoded(collector_config.get_encoded()),
            peer_aggregator_endpoint=peer_url,
            hpke_keys=[hpke.generate(1 if side == "leader" else 2)],
        )
        if side == "leader":
            return dsm.AggregatorTask(
                role=M.Role.LEADER,
                aggregator_auth_token=auth.new_bearer(AGG_TOKEN),
                collector_auth_token_hash=auth.new_bearer(COL_TOKEN).hash(),
                **common,
            )
        return dsm.AggregatorTask(
            role=M.Role.HELPER, aggregator_auth_token_hash=auth.new_bearer(AGG_TOKEN).hash(), **common
        )

    async def run(self, measure, seed, tamper=True, agg_params=None, scenario=None):
        """Upload, aggregate and collect once; or, with ``agg_params``
        (Poplar1), collect once a parameter, each collection creating its
        level's aggregation jobs; or, with ``scenario``, upload and hand
        ``scenario(lds, session_factory, clock, collect)`` the leader's
        datastore, the transport, the leader's clock and a coroutine
        function that collects.  Returns (result or results, valid
        measurements)."""
        from janus_tpu_torch.messages import TaskId

        clock_mod = self._mod("leader", "core.time")
        M = self._mod("leader", "messages")
        clock = clock_mod.MockClock(M.Time(NOW))
        hclock = self._mod("helper", "core.time").MockClock(self._mod("helper", "messages").Time(NOW))
        self.task_id = TaskId.random()
        collector_keys = HpkeKeypair.generate(9)
        lds, leader = self._aggregator("leader", clock)
        hds, helper = self._aggregator("helper", hclock)
        servers = []
        try:
            if self.transport == "inproc":
                from janus_tpu_torch.aggregator.test_util import InProcessNetwork

                net = InProcessNetwork()
                urls = {"leader": net.add("leader", leader), "helper": net.add("helper", helper)}
                session_factory = net.session
            else:
                for side, agg in (("leader", leader), ("helper", helper)):
                    server = TestServer(self._mod(side, "aggregator").aggregator_app(agg))
                    await server.start_server()
                    servers.append(server)
                urls = {"leader": str(servers[0].make_url("/")), "helper": str(servers[1].make_url("/"))}
                session_factory = aiohttp.ClientSession
            tasks = {
                "leader": self._task("leader", urls["helper"], collector_keys.config),
                "helper": self._task("helper", urls["leader"], collector_keys.config),
            }
            for ds, side in ((lds, "leader"), (hds, "helper")):
                ds.datastore.run_tx("put", lambda tx, t=tasks[side]: tx.put_aggregator_task(t))
            from janus_tpu_torch.messages import HpkeConfig

            cfg = {s: HpkeConfig.get_decoded(tasks[s].hpke_keys[0].config.get_encoded()) for s in tasks}
            vdaf = vdaf_from_instance(self.desc)
            reports, meas = reports_for(
                vdaf, np.random.default_rng(seed), self.task_id, cfg["leader"], cfg["helper"], VALID, measure, tamper
            )
            session = session_factory()
            try:
                for report in reports:
                    async with session.put(
                        f"{urls['leader'].rstrip('/')}/tasks/{self.task_id}/reports", data=report.get_encoded()
                    ) as resp:
                        assert resp.status == 201, await resp.text()
                if agg_params is None and scenario is None:
                    await self._aggregate(lds, session_factory)
                collector = Collector(
                    task_id=self.task_id,
                    leader_endpoint=urls["leader"],
                    vdaf=vdaf,
                    auth_token=AuthenticationToken.new_bearer(COL_TOKEN),
                    hpke_keypair=collector_keys,
                    poll_interval=0.02,
                    max_poll_time=20.0,
                )
                start = NOW - NOW % TIME_PRECISION
                query = Query.new_time_interval(Interval(Time(start), Duration(TIME_PRECISION)))
                if scenario is not None:
                    result = await scenario(lds, session_factory, clock, lambda: collector.collect(query, session=session))
                elif agg_params is None:
                    result, _ = await asyncio.gather(
                        collector.collect(query, session=session), self._collect_jobs(lds, session_factory)
                    )
                else:
                    result = []
                    for param in agg_params:
                        done = asyncio.Event()

                        async def collect(param=param, done=done):
                            try:
                                return await collector.collect(query, param, session=session)
                            finally:
                                done.set()

                        got, _ = await asyncio.gather(collect(), self._drive(lds, session_factory, clock, done))
                        result.append(got)
            finally:
                await session.close()
            from janus_tpu_torch.vdaf.canonical import executor_shape

            for side, agg in (("leader", leader), ("helper", helper)):
                if side in self.executors:
                    # the key the task's prepare was served under: its
                    # canonical bucket's where it has one
                    ex = self.executors[side]
                    key, _canon = executor_shape(vdaf, enabled=ex.config.canonical_shapes)
                    cached = ex.cached_backend(key)
                    self.backends[side] = cached or (await agg.task_aggregator_for(self.task_id)).backend
            return result, meas
        finally:
            await leader.shutdown()
            await helper.shutdown()
            for server in servers:
                await server.close()
            lds.cleanup()
            hds.cleanup()

    async def _aggregate(self, lds, session_factory):
        agg_mod = self._mod("leader", "aggregator")
        retries = self._mod("leader", "core.retries")
        Duration_ = self._mod("leader", "messages").Duration
        await asyncio.sleep(0.05)  # the upload batcher's write delay
        creator = agg_mod.AggregationJobCreator(
            lds.datastore, agg_mod.CreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=4)
        )
        await creator.run_once()
        kw = {"http_retry": retries.HttpRetryPolicy(0.01, 0.1, 2.0, 2.0, 3)}
        if self.pkgs["leader"] == "janus_tpu":
            kw["vdaf_backend"] = "oracle"
        elif self.oracle:
            kw["vdaf_backend"] = "oracle"
        else:
            kw.update(vdaf_device="cpu", device_executor=self.executors["leader"])
        driver = agg_mod.AggregationJobDriver(lds.datastore, session_factory, agg_mod.DriverConfig(**kw))
        try:
            for _ in range(10):
                leases = await lds.datastore.run_tx_async(
                    "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration_(600), 10)
                )
                if not leases:
                    break
                for lease in leases:
                    await driver.step_aggregation_job(lease)
        finally:
            await driver.close()

    async def _drive(self, lds, session_factory, clock, done):
        """Step the leader's aggregation jobs (concurrently, so that the
        jobs of one level coalesce in the executor) and its collection
        jobs until the collector has its result."""
        agg_mod = self._mod("leader", "aggregator")
        retries = self._mod("leader", "core.retries")
        Duration_ = self._mod("leader", "messages").Duration
        kw = {"http_retry": retries.HttpRetryPolicy(0.01, 0.1, 2.0, 2.0, 3)}
        if self.pkgs["leader"] == "janus_tpu" or self.oracle:
            kw["vdaf_backend"] = "oracle"
        else:
            kw.update(vdaf_device="cpu", device_executor=self.executors["leader"])
        driver = agg_mod.AggregationJobDriver(lds.datastore, session_factory, agg_mod.DriverConfig(**kw))
        coll = agg_mod.CollectionJobDriver(lds.datastore, session_factory)
        replay = coll._replay_journal_entry

        async def counted_replay(*args):
            self.journal_replays += 1
            return await replay(*args)

        coll._replay_journal_entry = counted_replay
        try:
            for _ in range(40):
                await asyncio.sleep(0.02)
                if done.is_set():
                    break
                leases = await lds.datastore.run_tx_async(
                    "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration_(600), 10)
                )
                await asyncio.gather(*(driver.step_aggregation_job(lease) for lease in leases))
                clock.advance(Duration_(30))
                if leases:
                    continue
                # the level's jobs have all finished: its deferred bucket
                # comes due and drains before the collection job runs
                await asyncio.sleep(POPLAR_DRAIN_S)
                await driver.run_accumulator_maintenance()
                leases = await lds.datastore.run_tx_async(
                    "acquire_coll", lambda tx: tx.acquire_incomplete_collection_jobs(Duration_(600), 10)
                )
                for lease in leases:
                    await coll.step_collection_job(lease)
        finally:
            await driver.close()
            await coll.close()

    async def _collect_jobs(self, lds, session_factory):
        agg_mod = self._mod("leader", "aggregator")
        Duration_ = self._mod("leader", "messages").Duration
        driver = agg_mod.CollectionJobDriver(lds.datastore, session_factory)
        await asyncio.sleep(0.05)
        for _ in range(10):
            leases = await lds.datastore.run_tx_async(
                "acquire", lambda tx: tx.acquire_incomplete_collection_jobs(Duration_(600), 10)
            )
            if not leases:
                break
            for lease in leases:
                await driver.step_collection_job(lease)
        await driver.close()

    def shutdown(self):
        for ex in self.executors.values():
            ex.shutdown()


def run_pair(pair, measure, seed, tamper=True, agg_params=None, scenario=None):
    try:
        return asyncio.run(pair.run(measure, seed, tamper, agg_params, scenario))
    finally:
        pair.shutdown()


@pytest.mark.parametrize("transport", ["inproc", "aiohttp"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_pair_collects_the_oracle_aggregate(family, transport):
    """Upload, aggregate through both sides' executors on ``CudaBackend``,
    collect: the aggregate is the JAX oracle's over the valid reports, the
    tampered report is rejected, and no out share is read back, recomputed
    on the oracle or marshalled from field values.  The HMAC multiproof
    SumVec takes ``HybridXofBackend``, which the driver and the helper call
    directly (no executor flush; its out shares come back to the host)."""
    desc, measure = FAMILIES[family]
    pair = Pair(desc, "janus_tpu_torch", "janus_tpu_torch", transport)
    result, meas = run_pair(pair, measure, seed=hash(family) % 1000)
    assert result.report_count == len(meas) == VALID
    assert result.aggregate_result == jax_oracle_aggregate(desc, meas)
    from janus_tpu_torch.vdaf.backend import CudaBackend, HybridXofBackend
    from janus_tpu_torch.vdaf.canonical import canonical_vdaf_for
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    hybrid = family == "multiproof"
    # the executors run the reference's default, canonical shapes: SumVec(10,
    # 1, 3) and FixedPoint(BitSize16, 3) serve through their bucket's twin
    canonical = canonical_vdaf_for(vdaf_from_instance(desc)) is not None
    for side, ex in pair.executors.items():
        backend = pair.backends[side]
        assert isinstance(backend, HybridXofBackend if hybrid else CudaBackend), side
        assert getattr(backend, "canonical", False) == canonical, side
        assert backend.bp.device.type == "cpu" and backend.oracle_recompute_rows == 0, side
        assert not any(backend.oracle.rows.values()), side
        flushes = {k: v for k, v in ex.stats().items() if "/prep_init#" in k}
        if hybrid:
            assert not flushes, (side, flushes)
        else:
            assert backend.outshare_readback_rows == 0, side
            assert flushes and all(v["flushes"] >= 1 for v in flushes.values()), (side, flushes)
    assert pair.backends["leader"].leader_marshal_rows == {"bytes": VALID + 1, "values": 0}


@pytest.mark.parametrize("leader_pkg,helper_pkg", [("janus_tpu_torch", "janus_tpu"), ("janus_tpu", "janus_tpu_torch")])
@pytest.mark.parametrize("family", ["sum", "histogram", "fixedpoint", "multiproof"])
def test_mixed_pair_collects_the_same_aggregate(family, leader_pkg, helper_pkg):
    """The port's leader with the JAX package's helper, and the reverse,
    over aiohttp on the oracle: the wire formats and prepare shares of the
    two packages interchange, and the aggregate is the JAX oracle's."""
    desc, measure = FAMILIES[family]
    pair = Pair(desc, leader_pkg, helper_pkg, "aiohttp", oracle=True)
    result, meas = run_pair(pair, measure, seed=7)
    assert result.report_count == len(meas) == VALID
    assert result.aggregate_result == jax_oracle_aggregate(desc, meas)


POPLAR_PAIRS = [
    ("janus_tpu_torch", "janus_tpu_torch", "inproc"),
    ("janus_tpu_torch", "janus_tpu_torch", "aiohttp"),
    ("janus_tpu_torch", "janus_tpu", "aiohttp"),
    ("janus_tpu", "janus_tpu_torch", "aiohttp"),
]


@pytest.mark.parametrize("leader_pkg,helper_pkg,transport", POPLAR_PAIRS)
def test_poplar1_pair_collects_prefix_counts(leader_pkg, helper_pkg, transport):
    """Poplar1 heavy hitters through the port's pair (in process and over
    aiohttp) and both mixed pairs: each collection creates its level's
    aggregation jobs (two reports a job), the port's sides prepare through
    ``Poplar1Backend`` behind their executor (the card walk on CPU
    tensors), the JAX package's sides on its oracle, and the prefix counts
    at level 1 and at the leaf are the plain counts of the honest values
    (the report with a flipped key is rejected at both levels).  The
    port's executors show the level-keyed ``poplar_init`` buckets with
    jobs coalesced and no row on the oracle; the port's leader keeps its
    sketch vectors on the device (no readback), and its deferred level
    buckets drain before each collection."""
    from janus_tpu_torch.vdaf.backend import Poplar1Backend
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

    vdaf = vdaf_from_instance(POPLAR_DESC)
    params = [vdaf.encode_agg_param(Poplar1AggregationParam(lvl, pre)) for lvl, pre in POPLAR_LEVELS]
    values = iter(POPLAR_VALUES + [0])
    pair = Pair(POPLAR_DESC, leader_pkg, helper_pkg, transport)
    results, meas = run_pair(pair, lambda r: next(values), seed=11, agg_params=params)
    assert meas == POPLAR_VALUES
    for (level, prefixes), result in zip(POPLAR_LEVELS, results):
        assert result.report_count == VALID
        assert result.aggregate_result == poplar_counts(meas, 4, level, prefixes)
    for side, ex in pair.executors.items():
        backend = pair.backends[side]
        assert isinstance(backend, Poplar1Backend) and backend.device.type == "cpu", side
        assert backend.oracle_recompute_rows == 0 and backend.oracle.rows["init"] == 0, side
        stats = ex.stats()
        for level, _p in POPLAR_LEVELS:
            label = [k for k in stats if f"/poplar_init/L{level}#" in k]
            assert len(label) == 1, (side, level, list(stats))
            assert stats[label[0]]["flushed_jobs"] >= stats[label[0]]["flushes"] >= 1, (side, stats[label[0]])
    if "leader" in pair.executors:
        assert pair.backends["leader"].sketch_readback_rows == 0
        store = pair.executors["leader"].accumulator
        assert store.spills >= len(POPLAR_LEVELS) and pair.journal_replays == 0
        assert store.drain_readback_rows >= len(POPLAR_LEVELS)


#: the deferred-drain interval of the port leader in the cases below,
#: seconds: longer than the whole case, so that no bucket comes due
#: unbidden (the case drains by running the maintenance pass with every
#: bucket due); a row's replay bound is 4 intervals of the leader's clock
DEFERRED_DRAIN_S = 30.0


@pytest.mark.parametrize("case", ["early_collection", "drain_race", "dead_owner"])
def test_deferred_rows_go_to_the_owners_drain(case):
    """The port leader keeps Sum out shares in a deferred accumulator (two
    jobs into one batch bucket).  ``early_collection``: the collection job
    is stepped as soon as the jobs are, before the bucket is due; it
    leaves the young journal rows to the owner and asks again, and after
    the cadence drain it collects.  ``drain_race``: a cadence drain runs
    while the second job's journal row is not yet written; it takes only
    the first job's rows, and the second job's rows stay resident for the
    next drain.  Neither recomputes a row on the oracle.  ``dead_owner``:
    the owner's resident sums are lost after the jobs commit; the rows are
    left alone while young, and replayed exactly once when past the bound.
    The aggregate is the JAX oracle's in every case."""
    from janus_tpu_torch.aggregator import AggregationJobCreator, AggregationJobDriver, CollectionJobDriver
    from janus_tpu_torch.aggregator import CreatorConfig, DriverConfig
    from janus_tpu_torch.core.retries import HttpRetryPolicy

    desc, measure = FAMILIES["sum"]
    pair = Pair(desc, "janus_tpu_torch", "janus_tpu_torch", "inproc", drain_s=DEFERRED_DRAIN_S)
    seen = {"replays": 0, "rows_after_early_step": None, "rows_in_race": None}

    async def scenario(lds, session_factory, clock, collect):
        ds, store = lds.datastore, pair.executors["leader"].accumulator
        task_id = pair.task_id
        rows = lambda: ds.run_tx("rows", lambda tx: tx.count_accumulator_journal_entries(task_id))  # noqa: E731
        await asyncio.sleep(0.05)  # the upload batcher's write delay
        await AggregationJobCreator(ds, CreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=4)).run_once()
        driver = AggregationJobDriver(ds, session_factory, DriverConfig(
            http_retry=HttpRetryPolicy(0.01, 0.1, 2.0, 2.0, 3), vdaf_device="cpu",
            device_executor=pair.executors["leader"]))
        coll = CollectionJobDriver(ds, session_factory)
        replay = coll._replay_journal_entry

        async def counted_replay(*args):
            seen["replays"] += 1
            return await replay(*args)

        coll._replay_journal_entry = counted_replay
        run_tx_async = ds.run_tx_async

        async def drain_now():
            """The cadence drain, with every bucket due."""
            store.due_buckets = lambda _max_age_s: store.bucket_keys()
            try:
                await driver.run_accumulator_maintenance()
            finally:
                del store.due_buckets

        async def racing_tx(name, fn, **kw):
            if name == "step_agg_job_2" and rows() == 1:
                # the second job's tx: the first job's bucket drains
                # before this job's journal row is written
                await drain_now()
                seen["rows_in_race"] = rows()
            return await run_tx_async(name, fn, **kw)

        async def step_collection():
            for lease in await ds.run_tx_async("acq_coll", lambda tx: tx.acquire_incomplete_collection_jobs(Duration(600), 10)):
                await coll.step_collection_job(lease)

        collecting = asyncio.ensure_future(collect())
        try:
            await asyncio.sleep(0.05)  # the collection job exists
            if case == "drain_race":
                ds.run_tx_async = racing_tx
            leases = await ds.run_tx_async("acq", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 10))
            assert len(leases) == 2
            for lease in leases:
                await driver.step_aggregation_job(lease)
            ds.run_tx_async = run_tx_async
            if case == "dead_owner":
                store.discard_all()
            await step_collection()  # before any bucket is due
            seen["rows_after_early_step"] = rows()
            if case != "dead_owner":
                await drain_now()
            clock.advance(Duration(int(5 * DEFERRED_DRAIN_S)))  # past the not-ready delay and the bound
            await step_collection()
            return await asyncio.wait_for(collecting, 20)
        finally:
            collecting.cancel()
            await driver.close()
            await coll.close()

    result, meas = run_pair(pair, measure, seed=5, scenario=scenario)
    assert result.report_count == len(meas) == VALID
    assert result.aggregate_result == jax_oracle_aggregate(desc, meas)
    assert seen["rows_after_early_step"] == (1 if case == "drain_race" else 2)
    assert seen["replays"] == (2 if case == "dead_owner" else 0)
    if case == "drain_race":
        assert seen["rows_in_race"] == 0


def test_multiround_fake_vdaf_pair():
    """The 2-round Fake VDAF (no device path: the oracle serves it) through
    the port's pair in process: init leaves the leader waiting with a
    stored transition, a continue round finishes every report, and the
    collected aggregate is the plain sum."""
    pair = Pair({"type": "Fake", "rounds": 2}, "janus_tpu_torch", "janus_tpu_torch", "inproc")
    result, meas = run_pair(pair, lambda r: int(r.integers(0, 10)), seed=3, tamper=False)
    assert result.report_count == len(meas) == VALID
    assert result.aggregate_result == sum(meas)


REFUSAL_STATUS = {
    ("PUT", "aggregation_jobs/{job}"): 403,
    ("POST", "aggregate_shares"): 403,
    ("PUT", "reports"): 400,
    ("DELETE", "reports"): 405,
    ("GET", "no_such_route"): 404,
}


@pytest.mark.parametrize(
    "method,path,body",
    [
        ("PUT", "aggregation_jobs/{job}", b"\x00"),  # wrong token: 403 problem document
        ("POST", "aggregate_shares", b""),  # wrong token: 403
        ("PUT", "reports", b"\x01\x02"),  # undecodable report: 400 invalidMessage
        ("DELETE", "reports", b""),  # a route without that method: 405
        ("GET", "no_such_route", b""),  # no route: 404
    ],
)
def test_refusals_match_over_both_transports(method, path, body):
    """A refused request reaches the caller with the same status, body and
    Retry-After over the in-process transport as over aiohttp: both answer
    through ``dispatch.dispatch``."""
    from janus_tpu_torch.aggregator import Aggregator, Config, aggregator_app
    from janus_tpu_torch.aggregator.test_util import InProcessNetwork
    from janus_tpu_torch.core.time import MockClock
    from janus_tpu_torch.datastore.test_util import EphemeralDatastore
    from janus_tpu_torch.messages import AggregationJobId, TaskId

    pair = Pair({"type": "Prio3Count"}, "janus_tpu_torch", "janus_tpu_torch", "inproc", oracle=True)
    pair.task_id = TaskId.random()
    headers = {"Authorization": "Bearer not-the-token"}
    url_path = f"tasks/{pair.task_id}/" + path.format(job=AggregationJobId.random())

    async def go():
        clock = MockClock(Time(NOW))
        ds = EphemeralDatastore(clock)
        helper = Aggregator(ds.datastore, clock, Config(vdaf_backend="oracle"))
        task = pair._task("helper", "inproc://leader/", HpkeKeypair.generate(9).config)
        ds.datastore.run_tx("put", lambda tx: tx.put_aggregator_task(task))
        server = TestServer(aggregator_app(helper))
        await server.start_server()
        try:
            got = []
            net = InProcessNetwork()
            for session, base in ((net.session(), net.add("helper", helper)), (aiohttp.ClientSession(), str(server.make_url("/")))):
                async with session.request(method, base + url_path, data=body, headers=headers) as resp:
                    got.append((resp.status, await resp.read(), resp.headers.get("Retry-After")))
                await session.close()
            return got
        finally:
            await server.close()
            await helper.shutdown()
            ds.cleanup()

    inproc, http = asyncio.run(go())
    assert inproc == http
    assert inproc[0] == REFUSAL_STATUS[method, path]
