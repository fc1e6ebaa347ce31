"""The Poplar1 helper's deferred host-share buckets in the port: with a
deferred accumulator on the helper's executor, each aggregation-job
continue request journals its finished vectors (one journal row a request
and batch) and sums them into a level-keyed host bucket once its tx has
committed; the aggregate-share barrier drains the buckets, or replays the
rows from the retained round-1 prepare states when the buckets are gone.
The pair runs in process on ``vdaf_device: cpu`` (``Poplar1Backend`` on CPU
tensors); the counts are the plain prefix counts, and the helper's stored
aggregate share equals the one it stores without deferral."""

import asyncio
import functools

import numpy as np
import pytest

from janus_tpu_torch.aggregator import (
    AggregationJobCreator,
    AggregationJobDriver,
    Aggregator,
    CollectionJobDriver,
    Config,
    CreatorConfig,
    DriverConfig,
)
from janus_tpu_torch.aggregator import aggregation_job_writer
from janus_tpu_torch.aggregator.test_util import InProcessNetwork
from janus_tpu_torch.client import seal_report
from janus_tpu_torch.collector import Collector
from janus_tpu_torch.core.auth_tokens import AuthenticationToken
from janus_tpu_torch.core.hpke import HpkeKeypair
from janus_tpu_torch.core.metrics import GLOBAL_METRICS
from janus_tpu_torch.core.retries import HttpRetryPolicy
from janus_tpu_torch.core.time import MockClock
from janus_tpu_torch.datastore import AggregatorTask, TaskQueryType
from janus_tpu_torch.datastore.test_util import EphemeralDatastore
from janus_tpu_torch.executor import AccumulatorConfig, DeviceExecutor, ExecutorConfig
from janus_tpu_torch.executor.accumulator import StaleAccumulatorDelta
from janus_tpu_torch.messages import CollectionJobId, Duration, Interval, Query, ReportId, Role, TaskId, Time
from janus_tpu_torch.vdaf.instances import vdaf_from_instance
from janus_tpu_torch.vdaf.poplar1 import Poplar1AggregationParam

DESC = {"type": "Poplar1", "bits": 4}
MEASUREMENTS = [0b1011, 0b1011, 0b0100, 0b1111]
PARAM = Poplar1AggregationParam(1, (0, 1, 2, 3))
NOW = 1_600_002_000
PRECISION = 3600
#: the helper's deferred-drain interval: longer than the case, so that no
#: request-completion drain fires and the aggregate-share barrier does the work
DRAIN_S = 3600.0


def _consumed(path):
    return GLOBAL_METRICS.get_sample_value("janus_accumulator_journal_consumed_total", {"path": path}) or 0.0


@functools.lru_cache(maxsize=None)
def _setup():
    """One task's keys and sealed reports, shared by every case: the same
    uploads go to each pair."""
    vdaf = vdaf_from_instance(DESC)
    rng = np.random.default_rng(16)
    keys = {"leader": HpkeKeypair.generate(1), "helper": HpkeKeypair.generate(2), "collector": HpkeKeypair.generate(9)}
    task_id = TaskId(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
    start = NOW - NOW % PRECISION
    reports = []
    for m in MEASUREMENTS:
        rid = ReportId(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
        public, shares = vdaf.shard(m, rid.data, rng.integers(0, 256, vdaf.RAND_SIZE, dtype=np.uint8).tobytes())
        reports.append(seal_report(vdaf, task_id, keys["leader"].config, keys["helper"].config, rid, Time(start),
                                   public, shares))
    return vdaf, keys, task_id, reports


async def _pair_run(case):
    vdaf, keys, task_id, reports = _setup()
    clock = MockClock(Time(NOW))
    ds = {side: EphemeralDatastore(clock) for side in ("leader", "helper")}
    helper_acc = AccumulatorConfig(enabled=True, drain_interval_s=0 if case == "direct" else DRAIN_S)
    ex = {"leader": DeviceExecutor(ExecutorConfig(flush_window_s=0.001, accumulator=AccumulatorConfig(enabled=True))),
          "helper": DeviceExecutor(ExecutorConfig(flush_window_s=0.001, accumulator=helper_acc))}
    aggs = {side: Aggregator(ds[side].datastore, clock, Config(
        vdaf_device="cpu", device_executor=ex[side], max_upload_batch_write_delay=0.01, max_agg_param_job_size=2))
        for side in ds}
    net = InProcessNetwork()
    urls = {side: net.add(side, agg) for side, agg in aggs.items()}
    agg_token, col_token = AuthenticationToken.new_bearer("hd-agg"), AuthenticationToken.new_bearer("hd-col")
    common = dict(task_id=task_id, query_type=TaskQueryType.time_interval(), vdaf=DESC, vdaf_verify_key=b"\x2a" * 16,
                  min_batch_size=1, time_precision=Duration(PRECISION),
                  collector_hpke_config=keys["collector"].config)
    tasks = {
        "leader": AggregatorTask(peer_aggregator_endpoint=urls["helper"], role=Role.LEADER,
                                 aggregator_auth_token=agg_token, collector_auth_token_hash=col_token.hash(),
                                 hpke_keys=[keys["leader"]], **common),
        "helper": AggregatorTask(peer_aggregator_endpoint=urls["leader"], role=Role.HELPER,
                                 aggregator_auth_token_hash=agg_token.hash(), hpke_keys=[keys["helper"]], **common),
    }
    for side in ds:
        ds[side].datastore.run_tx("put", lambda tx, t=tasks[side]: tx.put_aggregator_task(t))
    hds = ds["helper"].datastore
    helper_rows = lambda: hds.run_tx("rows", lambda tx: tx.count_accumulator_journal_entries(task_id))  # noqa: E731
    session = net.session()
    out = {}
    try:
        async def upload(report):
            async with session.put(f"{urls['leader']}tasks/{task_id}/reports", data=report.get_encoded()) as r:
                assert r.status == 201, await r.text()

        await asyncio.gather(*[upload(r) for r in reports])
        await asyncio.sleep(0.05)  # the upload batcher's write delay
        await AggregationJobCreator(ds["leader"].datastore, CreatorConfig()).run_once()
        collector = Collector(task_id=task_id, leader_endpoint=urls["leader"], vdaf=vdaf, auth_token=col_token,
                              hpke_keypair=keys["collector"], poll_interval=0.02, max_poll_time=20.0)
        interval = Interval(Time(NOW - NOW % PRECISION), Duration(PRECISION))
        query = Query.new_time_interval(interval)
        param = vdaf.encode_agg_param(PARAM)
        job_id = CollectionJobId.random()
        # phase 1: the collection creates the level's jobs; step them only
        await collector.create_job(query, job_id, param, session=session)
        driver = AggregationJobDriver(ds["leader"].datastore, net.session, DriverConfig(
            http_retry=HttpRetryPolicy(0.01, 0.1, 2.0, 2.0, 3), vdaf_device="cpu", device_executor=ex["leader"]))
        for _ in range(10):
            leases = await ds["leader"].datastore.run_tx_async(
                "acquire", lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 10))
            if not leases:
                break
            await asyncio.gather(*(driver.step_aggregation_job(lease) for lease in leases))
            clock.advance(Duration(30))
        await driver.close()
        out["rows_before"] = helper_rows()
        store = ex["helper"].accumulator
        out["buckets_before"] = len([k for k in store.bucket_keys() if len(k) == 5 and k[0] == "helper"])
        if case == "replay":
            store.discard_all()  # the buckets are lost: the barrier replays the rows
        # phase 2: the collection; the aggregate-share barrier drains
        drained, replayed = _consumed("drain"), _consumed("replay")
        coll = CollectionJobDriver(ds["leader"].datastore, net.session)
        result = None
        try:
            for _ in range(50):
                for lease in await ds["leader"].datastore.run_tx_async(
                        "acq", lambda tx: tx.acquire_incomplete_collection_jobs(Duration(600), 10)):
                    await coll.step_collection_job(lease)
                result, _retry = await collector.poll_once(query, job_id, param, session=session)
                if result is not None:
                    break
                clock.advance(Duration(30))
        finally:
            await coll.close()
        assert result is not None, "the collection never finished"
        out.update(result=result, rows_after=helper_rows(), drained=_consumed("drain") - drained,
                   replayed=_consumed("replay") - replayed)
        # the helper's stored aggregate share of the collected interval
        share_job = hds.run_tx("share", lambda tx: tx.get_aggregate_share_job(task_id, interval.get_encoded(), param))
        out["helper_share"] = share_job.helper_aggregate_share
    finally:
        await session.close()
        for side in ds:
            await aggs[side].shutdown()
            ex[side].shutdown()
            ds[side].cleanup()
    return out


@functools.lru_cache(maxsize=None)
def run_case(case):
    return asyncio.run(asyncio.wait_for(_pair_run(case), 60))


def _expect():
    return [sum(1 for m in MEASUREMENTS if m >> 2 == p) for p in PARAM.prefixes]


@pytest.mark.parametrize("case", ["alive", "replay"])
def test_helper_continue_routes_through_deferred_store(case):
    """With the deferred store on, each of the 2 continue requests (jobs
    of 2 reports) journals its vectors: 2 helper journal rows exist
    between the jobs and the collection, in a level bucket; the
    aggregate-share barrier consumes every row (by its drain, or by the
    replay from the retained states once the buckets were dropped) and
    the prefix counts are exact."""
    out = run_case(case)
    assert out["rows_before"] == 2 and out["buckets_before"] == 1, out
    assert out["result"].aggregate_result == _expect()
    assert out["result"].report_count == len(MEASUREMENTS)
    assert out["rows_after"] == 0
    if case == "alive":
        assert (out["drained"], out["replayed"]) == (2, 0)
    else:
        assert (out["drained"], out["replayed"]) == (0, 2)


def test_stale_delta_retries_with_direct_merges(monkeypatch):
    """A journaled report failed in-tx (StaleAccumulatorDelta from the
    writer's journal check): the first continue request retries once
    merging its vectors directly, writes no journal row and puts nothing
    in a bucket; the other request journals as usual and the counts stay
    exact."""
    write_journal = aggregation_job_writer.AggregationJobWriter._write_journal
    raised = []

    def stale_once(self, tx, job, failures):
        if not raised:
            raised.append(job.aggregation_job_id)
            raise StaleAccumulatorDelta("batch collected under the request")
        return write_journal(self, tx, job, failures)

    monkeypatch.setattr(aggregation_job_writer.AggregationJobWriter, "_write_journal", stale_once)
    out = asyncio.run(asyncio.wait_for(_pair_run("stale"), 60))
    assert len(raised) == 1
    assert out["rows_before"] == 1
    assert out["result"].aggregate_result == _expect()
    assert (out["rows_after"], out["drained"], out["replayed"]) == (0, 1, 0)


def test_deferred_helper_share_equals_the_direct_one():
    """The helper's stored aggregate share vector is the same with the
    deferred buckets (drained, or replayed) as without deferral."""
    direct = run_case("direct")
    assert direct["rows_before"] == 0 and direct["result"].aggregate_result == _expect()
    assert direct["helper_share"] is not None
    assert run_case("alive")["helper_share"] == direct["helper_share"]
    assert run_case("replay")["helper_share"] == direct["helper_share"]
