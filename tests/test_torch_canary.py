"""The port's canary plane (``janus_tpu_torch/core/canary.py``): the cases
of ``tests/test_canary.py`` on the port, and its parity with the JAX
package's plane.

The unit layer holds the registry, the verdict state machine and the
degradation-aware backoff.  The end-to-end layer runs the probe against a
leader and a helper of the port as aiohttp TestServers over ephemeral
datastores, preparing with the ``cuda`` backend on the CPU
(``vdaf_device="cpu"``, where every kernel wrapper takes its plain
version), with the creator, aggregation and collection loops driven
beside the probe.  The chaos case blacks out ``datastore.tx.begin``
through the port's ``core/faults.py``: the verdict flips to ``failing`` at
the upload stage, strict db-SUSPECT suppresses further probes with a
counted backoff, the fleet heals and real traffic uploaded before the
window collects exactly once.

Parity: the port's ``FAMILIES`` equal the JAX package's field for field;
both verdict state machines fed one seeded sequence of probe results give
the same verdict after each step and the same ``stats()``; and each
package's ``CanaryPlane`` probes the other package's fleet (the JAX side on
its oracle) to ``ok``.
"""

import asyncio
import importlib
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from janus_tpu_torch.core.canary import (
    FAMILIES,
    CanaryPlane,
    _matches,
    canary_stats,
    configure_canary,
)
from janus_tpu_torch.core.db_health import DB_SUSPECT, reset_db_health, tracker
from janus_tpu_torch.core.hpke import HpkeKeypair
from janus_tpu_torch.core.metrics import Metrics
from janus_tpu_torch.messages import Duration, TaskId, Time

PORT, JAX = "janus_tpu_torch", "janus_tpu"

TIME_PRECISION = Duration(3600)
NOW = Time(1_600_002_000)  # aligned to TIME_PRECISION

AGG_TOKEN = "agg-token-canary"
COL_TOKEN = "col-token-canary"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def bearer(pkg, token):
    return mod(pkg, "core.auth_tokens").AuthenticationToken.new_bearer(token)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _cfg(families=("prio3_sum",), **overrides):
    cfg = SimpleNamespace(
        leader_endpoint="http://leader.invalid",
        helper_endpoint="http://helper.invalid",
        leader_task_api="",
        helper_task_api="",
        task_api_auth_token="",
        families=list(families),
        probe_interval_s=30.0,
        poll_interval_s=0.05,
        collect_timeout_s=20.0,
        fail_threshold=2,
        time_precision_s=3600,
        trace_globs=[],
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _plane(families=("prio3_sum",), metrics=None, **overrides):
    return CanaryPlane(
        _cfg(families, **overrides),
        metrics=metrics or Metrics(force_fallback=True),
        wall_fn=lambda: NOW.seconds,
    )


def _adopt_sum(plane, key_id):
    """Adopt a prio3_sum task with made-up aggregator HPKE configs (no
    fetch), for the cases whose session is a stand-in."""
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    plane.adopt_task(
        "prio3_sum",
        TaskId.random(),
        vdaf_from_instance(FAMILIES["prio3_sum"].vdaf_instance),
        HpkeKeypair.generate(key_id),
        bearer(PORT, COL_TOKEN),
        leader_hpke_config=HpkeKeypair.generate(key_id + 1).config,
        helper_hpke_config=HpkeKeypair.generate(key_id + 2).config,
    )


# ---------------------------------------------------------------------------
# Unit layer: registry, verdict machine, backoff


def test_known_plaintext_families():
    """The probe's whole premise: expected sums are fixed constants."""
    assert FAMILIES["prio3_sum"].expected == sum(FAMILIES["prio3_sum"].measurements)
    hist = FAMILIES["prio3_histogram"]
    expect = [0] * hist.vdaf_instance["length"]
    for m in hist.measurements:
        expect[m] += 1
    assert hist.expected == expect
    assert _matches(62, 62) and _matches([1, 0], (1, 0))
    assert not _matches(61, 62) and not _matches([1], [1, 0])
    assert not _matches(None, 62) and not _matches("x", 62)


def test_unknown_family_rejected_at_construction():
    with pytest.raises(ValueError, match="unknown family"):
        _plane(families=("prio3_sum", "prio3_sumvec"))


def test_verdict_state_machine():
    m = Metrics(force_fallback=True)
    plane = _plane(metrics=m, fail_threshold=2)
    task = SimpleNamespace(family=FAMILIES["prio3_sum"])
    assert plane.fleet_verdict() == "healthy"

    plane._finish(task, "error", "upload", detail="boom")
    assert plane.fleet_verdict() == "degraded"
    st = plane.stats()["families"]["prio3_sum"]
    assert st["failing_stage"] == "upload" and st["consecutive_failures"] == 1

    plane._finish(task, "timeout", "collection")
    assert plane.fleet_verdict() == "failing"
    st = plane.stats()["families"]["prio3_sum"]
    assert st["failing_stage"] == "collection" and st["last_outcome"] == "timeout"
    assert st["last_good_unix"] is None

    plane._finish(task, "ok", None, stages_s={"upload_ack": 0.01, "e2e": 0.5})
    assert plane.fleet_verdict() == "healthy"
    st = plane.stats()["families"]["prio3_sum"]
    assert st["consecutive_failures"] == 0 and st["failing_stage"] is None
    assert st["last_good_unix"] == NOW.seconds

    # the outcome counter and the 0/2 success histogram both moved
    assert m.canary_verdicts._values[("prio3_sum", "error")] == 1.0
    assert m.canary_verdicts._values[("prio3_sum", "ok")] == 1.0
    count, total, _ = m.canary_probe_outcome._hist[()]
    assert (count, total) == (3, 4.0)  # 2 failures at 2.0 + 1 ok at 0.0
    # stage latency rollup renders in stats
    lat = plane.stats()["stage_latency_s"]
    assert lat["e2e"]["samples"] == 1 and lat["e2e"]["p50"] == 0.5


def test_fleet_verdict_is_worst_family():
    plane = _plane(families=("prio3_sum", "prio3_histogram"), fail_threshold=1)
    plane._finish(SimpleNamespace(family=FAMILIES["prio3_histogram"]), "corrupt", "verify")
    assert plane.stats()["families"]["prio3_sum"]["verdict"] == "healthy"
    assert plane.fleet_verdict() == "failing"


def test_db_suspect_backoff_counts_without_moving_state():
    """Strict-SUSPECT suppression: counted, never probed, verdict frozen."""
    m = Metrics(force_fallback=True)
    plane = _plane(metrics=m)
    plane.adopt_task("prio3_sum", TaskId.random(), None, HpkeKeypair.generate(50), bearer(PORT, COL_TOKEN))
    tracker().configure(failure_threshold=1, suspect_dwell_s=300.0)
    try:
        tracker().record_tx_failure()
        assert tracker().state() == DB_SUSPECT
        results = run(plane.probe_once(session=None))  # no session touched
        assert [r.outcome for r in results] == ["suppressed"]
        assert results[0].reason == "db_suspect"
        st = plane.stats()["families"]["prio3_sum"]
        assert st["probes"] == 0 and st["suppressed"] == 1
        assert plane.fleet_verdict() == "healthy"
        assert plane.stats()["backoffs"] == {"db_suspect": 1}
        assert m.canary_backoffs._values[("db_suspect",)] == 1.0
    finally:
        reset_db_health()


class _FakeResp:
    def __init__(self, status, body=""):
        self.status = status
        self._body = body

    async def text(self):
        return self._body


class _FakeCtx:
    def __init__(self, resp):
        self._resp = resp

    async def __aenter__(self):
        return self._resp

    async def __aexit__(self, *exc):
        return False


class _ShedSession:
    """Every PUT sheds with 503 — the overloaded front door."""

    def __init__(self, body="shed"):
        self.puts = 0
        self.body = body

    def put(self, url, data=None, headers=None):
        self.puts += 1
        return _FakeCtx(_FakeResp(503, self.body))


def test_upload_shed_backoff_counts_without_moving_state():
    m = Metrics(force_fallback=True)
    plane = _plane(metrics=m)
    _adopt_sum(plane, 51)
    session = _ShedSession()
    results = run(plane.probe_once(session=session))
    assert [r.outcome for r in results] == ["suppressed"]
    assert results[0].reason == "upload_shed"
    assert session.puts == 1  # stood down at the FIRST shed
    st = plane.stats()["families"]["prio3_sum"]
    assert st["probes"] == 0 and st["suppressed"] == 1
    assert plane.fleet_verdict() == "healthy"
    assert m.canary_backoffs._values[("upload_shed",)] == 1.0


def test_bucket_walk_survives_precision_boundary():
    """Deriving the bucket from the live wall clock each cycle collides
    whenever a precision boundary crosses between two probes; the
    allocator walks monotonically backward from first use, whatever the
    clock."""
    wall = {"now": NOW.seconds}
    plane = _plane()
    plane._wall = lambda: wall["now"]
    plane.adopt_task("prio3_sum", TaskId.random(), None, HpkeKeypair.generate(60), bearer(PORT, COL_TOKEN))
    task = plane._tasks["prio3_sum"]

    b1 = plane._alloc_bucket(task, 3600)
    assert b1 == NOW.seconds - 3600  # most recent CLOSED bucket
    wall["now"] += 3600  # the hour flips between probes
    b2 = plane._alloc_bucket(task, 3600)
    assert b2 == b1 - 3600  # the old math would have re-issued b1
    wall["now"] += 7200  # even a multi-hour stall never revisits
    b3 = plane._alloc_bucket(task, 3600)
    assert b3 == b1 - 7200
    assert len({b1, b2, b3}) == 3 and task.seq == 3


def test_consumed_bucket_suppresses_and_advances(monkeypatch):
    """A collect rejected with batchQueriedTooManyTimes is a counted
    bucket_collision backoff — verdict frozen — and the allocator has
    already moved past it."""
    from janus_tpu_torch.collector import CollectorError

    m = Metrics(force_fallback=True)
    plane = _plane(metrics=m)
    _adopt_sum(plane, 61)

    class _OkSession:
        def put(self, url, data=None, headers=None):
            return _FakeCtx(_FakeResp(201))

    async def _rejected(self, query, session=None):
        raise CollectorError(
            'collection create failed: 400 {"type": "urn:ietf:params:ppm:'
            'dap:error:batchQueriedTooManyTimes"}'
        )

    monkeypatch.setattr("janus_tpu_torch.collector.Collector.collect", _rejected)
    results = run(plane.probe_once(session=_OkSession()))
    assert [r.outcome for r in results] == ["suppressed"]
    assert results[0].reason == "bucket_collision"
    st = plane.stats()["families"]["prio3_sum"]
    assert st["probes"] == 0 and st["suppressed"] == 1
    assert plane.fleet_verdict() == "healthy"
    assert plane.stats()["backoffs"] == {"bucket_collision": 1}
    # the consumed bucket is behind us: the next cycle probes one older
    assert plane._tasks["prio3_sum"].next_bucket == NOW.seconds - 7200


def test_persistent_shed_escalates_to_error():
    """An unbroken 503-shed streak past ``shed_escalate_after`` stops
    counting as polite backoff: the verdict must move."""
    m = Metrics(force_fallback=True)
    plane = _plane(metrics=m, shed_escalate_after=2, fail_threshold=2)
    _adopt_sum(plane, 54)
    session = _ShedSession()
    for expect in ("suppressed", "suppressed", "error", "error"):
        (r,) = run(plane.probe_once(session=session))
        assert r.outcome == expect, (expect, r.outcome, r.detail)
    st = plane.stats()["families"]["prio3_sum"]
    assert st["suppressed"] == 2 and st["probes"] == 2
    assert st["failing_stage"] == "upload"
    assert plane.fleet_verdict() == "failing"
    # a datastore-unavailable 503 is loud IMMEDIATELY, no streak needed
    plane2 = _plane(metrics=m)
    _adopt_sum(plane2, 57)
    (r,) = run(plane2.probe_once(session=_ShedSession("datastore unavailable")))
    assert r.outcome == "error" and r.stage == "upload", (r.outcome, r.detail)


def test_timeout_stage_attribution(monkeypatch, tmp_path):
    import janus_tpu_torch.core.canary as canary_mod

    plane = _plane()
    # no trace globs configured: the only thing known is the poll timed out
    assert plane._attribute_timeout_stage(["aa" * 16]) == "collection"
    plane.cfg.trace_globs = [str(tmp_path / "nonexistent-*.json")]
    monkeypatch.setattr(
        canary_mod, "probe_stage_latencies", lambda globs, ids: {"commit": [0.01], "first_prepare": [0.02]}
    )
    # the reports DID reach device prepare: collection is what stalled
    assert plane._attribute_timeout_stage(["aa" * 16]) == "collection"
    monkeypatch.setattr(
        canary_mod, "probe_stage_latencies", lambda globs, ids: {"commit": [0.01], "first_prepare": []}
    )
    # committed but never prepared: the pipeline stalled before the device
    assert plane._attribute_timeout_stage(["aa" * 16]) == "prepare"
    # the merged-trace reader is the repo's tools/trace_merge.py
    assert canary_mod._trace_merge_module() is not None


def test_canary_statusz_section():
    import janus_tpu_torch.core.canary as canary_mod
    from janus_tpu_torch.core.statusz import runtime_status

    assert canary_stats() == {"enabled": False}
    assert runtime_status()["canary"] == {"enabled": False}
    canary_mod._PLANE = _plane()
    try:
        doc = runtime_status()["canary"]
        assert doc["enabled"] and doc["verdict"] == "healthy"
        assert doc["families"]["prio3_sum"]["provisioned"] is False
    finally:
        canary_mod._PLANE = None


def test_canary_statusz_loads_no_torch():
    """The canary binary's process holds no card: its /statusz answers
    without importing torch (which would load the CUDA libraries and, in
    the device section, initialise the driver on the event loop), and its
    upload section is None (no front door)."""
    import json
    import subprocess
    import sys

    code = (
        "import asyncio, json, sys\n"
        "from types import SimpleNamespace\n"
        "from janus_tpu_torch.core.canary import configure_canary\n"
        "from janus_tpu_torch.core.statusz import statusz_snapshot\n"
        "configure_canary(SimpleNamespace(families=['prio3_sum'], fail_threshold=2))\n"
        "doc = asyncio.run(statusz_snapshot(None))\n"
        "print(json.dumps({'torch': 'torch' in sys.modules, 'device': doc['device'], "
        "'upload': doc['upload'], 'canary': doc['canary']['verdict']}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"torch": False, "device": {"torch": None}, "upload": None, "canary": "healthy"}


def test_configure_canary_install_and_clear():
    cfg = SimpleNamespace(families=["prio3_sum"], fail_threshold=2)
    plane = configure_canary(cfg, metrics=Metrics(force_fallback=True))
    try:
        assert canary_stats()["enabled"] is True
    finally:
        configure_canary(None)
    assert plane is not None and canary_stats() == {"enabled": False}


# ---------------------------------------------------------------------------
# E2E layer: the probe against a real in-process pair


class CanaryHarness:
    """Leader+helper of ``fleet_pkg`` over TestServers, the canary task(s)
    pre-provisioned in both datastores and adopted by a CanaryPlane of
    ``plane_pkg``, plus an optional real Prio3Count task to prove batch
    isolation.  The port's aggregators prepare with the ``cuda`` backend on
    the CPU, the JAX package's on its oracle."""

    def __init__(self, families=("prio3_sum",), real_task=False, fleet_pkg=PORT, plane_pkg=PORT):
        self.families = list(families)
        self.with_real_task = real_task
        self.fleet, self.plane_pkg = fleet_pkg, plane_pkg
        self.clock = mod(fleet_pkg, "core.time").MockClock(mod(fleet_pkg, "messages").Time(NOW.seconds))
        test_util = mod(fleet_pkg, "datastore.test_util")
        self.leader_ds = test_util.EphemeralDatastore(self.clock)
        self.helper_ds = test_util.EphemeralDatastore(self.clock)
        agg = mod(fleet_pkg, "aggregator")
        device = {"vdaf_device": "cpu"} if fleet_pkg == PORT else {"vdaf_backend": "oracle"}
        cfg = agg.Config(max_upload_batch_write_delay=0.02, **device)
        self.driver_config = agg.DriverConfig(
            http_retry=mod(fleet_pkg, "core.retries").HttpRetryPolicy(0.01, 0.1, 2.0, 1.0, 3), **device
        )
        self.leader_agg = agg.Aggregator(self.leader_ds.datastore, self.clock, cfg)
        self.helper_agg = agg.Aggregator(self.helper_ds.datastore, self.clock, cfg)
        self.metrics = mod(plane_pkg, "core.metrics").Metrics(force_fallback=True)

    def _put_pair_task(self, task_id, vdaf_desc, min_batch_size, collector_config):
        ds = mod(self.fleet, "datastore")
        M = mod(self.fleet, "messages")
        keypair = mod(self.fleet, "core.hpke").HpkeKeypair
        common = dict(
            task_id=task_id,
            query_type=ds.TaskQueryType.time_interval(),
            vdaf=vdaf_desc,
            vdaf_verify_key=b"\x2a" * 16,
            min_batch_size=min_batch_size,
            time_precision=M.Duration(TIME_PRECISION.seconds),
            collector_hpke_config=collector_config,
        )
        leader = ds.AggregatorTask(
            peer_aggregator_endpoint=self.helper_url,
            role=M.Role.LEADER,
            aggregator_auth_token=bearer(self.fleet, AGG_TOKEN),
            collector_auth_token_hash=bearer(self.fleet, COL_TOKEN).hash(),
            hpke_keys=[keypair.generate(1)],
            **common,
        )
        helper = ds.AggregatorTask(
            peer_aggregator_endpoint=self.leader_url,
            role=M.Role.HELPER,
            aggregator_auth_token_hash=bearer(self.fleet, AGG_TOKEN).hash(),
            hpke_keys=[keypair.generate(2)],
            **common,
        )
        self.leader_ds.datastore.run_tx("put", lambda tx: tx.put_aggregator_task(leader))
        self.helper_ds.datastore.run_tx("put", lambda tx: tx.put_aggregator_task(helper))
        return leader, helper

    async def start(self):
        agg = mod(self.fleet, "aggregator")
        self.leader_client = TestClient(TestServer(agg.aggregator_app(self.leader_agg)))
        self.helper_client = TestClient(TestServer(agg.aggregator_app(self.helper_agg)))
        await self.leader_client.start_server()
        await self.helper_client.start_server()
        self.leader_url = str(self.leader_client.make_url("/")).rstrip("/")
        self.helper_url = str(self.helper_client.make_url("/")).rstrip("/")

        self.cfg = _cfg(
            self.families, leader_endpoint=self.leader_url, helper_endpoint=self.helper_url, collect_timeout_s=30.0
        )
        canary = mod(self.plane_pkg, "core.canary")
        self.plane = canary.CanaryPlane(self.cfg, metrics=self.metrics, wall_fn=lambda: NOW.seconds)
        self.canary_task_ids = {}
        fleet_hpke = mod(self.fleet, "messages").HpkeConfig
        for idx, name in enumerate(self.families):
            fam = canary.FAMILIES[name]
            task_id = TaskId.random().data
            collector_keys = mod(self.plane_pkg, "core.hpke").HpkeKeypair.generate(30 + idx)
            self._put_pair_task(
                mod(self.fleet, "messages").TaskId(task_id),
                fam.vdaf_instance,
                len(fam.measurements),
                fleet_hpke.get_decoded(collector_keys.config.get_encoded()),
            )
            self.plane.adopt_task(
                name,
                mod(self.plane_pkg, "messages").TaskId(task_id),
                mod(self.plane_pkg, "vdaf.instances").vdaf_from_instance(fam.vdaf_instance),
                collector_keys,
                bearer(self.plane_pkg, COL_TOKEN),
            )
            self.canary_task_ids[name] = task_id

        if self.with_real_task:
            self.real_task_id = mod(self.fleet, "messages").TaskId.random()
            self.real_collector_keys = mod(self.fleet, "core.hpke").HpkeKeypair.generate(40)
            self.real_leader_task, self.real_helper_task = self._put_pair_task(
                self.real_task_id, {"type": "Prio3Count"}, 3, self.real_collector_keys.config
            )

    async def stop(self):
        await self.leader_agg.shutdown()
        await self.helper_agg.shutdown()
        await self.leader_client.close()
        await self.helper_client.close()
        self.leader_ds.cleanup()
        self.helper_ds.cleanup()

    async def upload_real(self, measurement):
        report = mod(self.fleet, "client").prepare_report(
            self.real_leader_task.vdaf_instance(),
            self.real_task_id,
            self.real_leader_task.hpke_keys[0].config,
            self.real_helper_task.hpke_keys[0].config,
            mod(self.fleet, "messages").Duration(TIME_PRECISION.seconds),
            measurement,
            time=mod(self.fleet, "messages").Time(NOW.seconds),
        )
        resp = await self.leader_client.put(f"/tasks/{self.real_task_id}/reports", data=report.get_encoded())
        assert resp.status == 201, await resp.text()

    async def _drive(self, done):
        """Creator + aggregation + collection loops until ``done``; fault
        storms must not kill the loop (the chaos case blacks out txs)."""
        agg = mod(self.fleet, "aggregator")
        duration = mod(self.fleet, "messages").Duration
        creator = agg.AggregationJobCreator(
            self.leader_ds.datastore,
            agg.CreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=100),
        )
        driver = agg.AggregationJobDriver(self.leader_ds.datastore, aiohttp.ClientSession, self.driver_config)
        cdriver = agg.CollectionJobDriver(self.leader_ds.datastore, aiohttp.ClientSession)
        try:
            while not done.is_set():
                try:
                    await creator.run_once()
                    leases = await self.leader_ds.datastore.run_tx_async(
                        "acq_agg", lambda tx: tx.acquire_incomplete_aggregation_jobs(duration(600), 10)
                    )
                    for lease in leases:
                        await driver.step_aggregation_job(lease)
                    cleases = await self.leader_ds.datastore.run_tx_async(
                        "acq_coll", lambda tx: tx.acquire_incomplete_collection_jobs(duration(600), 10)
                    )
                    for lease in cleases:
                        await cdriver.step_collection_job(lease)
                except Exception:
                    pass  # chaos: keep driving, the probe judges the outcome
                # march past the stepped not-ready retry delays
                self.clock.advance(duration(30))
                try:
                    await asyncio.wait_for(done.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass
        finally:
            await driver.close()
            await cdriver.close()

    async def probe(self):
        """One probe cycle with the pipeline driven concurrently."""
        async with aiohttp.ClientSession() as session:
            done = asyncio.Event()

            async def run_probe():
                try:
                    return await self.plane.probe_once(session)
                finally:
                    done.set()

            results, _ = await asyncio.gather(run_probe(), self._drive(done))
            return results

    async def collect_real(self, expected_count, expected_sum):
        M = mod(self.fleet, "messages")
        collector = mod(self.fleet, "collector").Collector(
            task_id=self.real_task_id,
            leader_endpoint=self.leader_url,
            vdaf=self.real_leader_task.vdaf_instance(),
            auth_token=bearer(self.fleet, COL_TOKEN),
            hpke_keypair=self.real_collector_keys,
            poll_interval=0.05,
            max_poll_time=30.0,
        )
        done = asyncio.Event()

        async def run_collect():
            try:
                return await collector.collect(
                    M.Query.new_time_interval(M.Interval(M.Time(NOW.seconds), M.Duration(TIME_PRECISION.seconds))),
                    session=None,
                )
            finally:
                done.set()

        result, _ = await asyncio.gather(run_collect(), self._drive(done))
        assert result.report_count == expected_count, result.report_count
        assert result.aggregate_result == expected_sum, result.aggregate_result
        return result


def test_probe_ok_end_to_end():
    """Both families through the real path: upload -> aggregate ->
    collect -> verified known sum; a second cycle walks to the next
    (older) bucket rather than re-querying the first."""
    h = CanaryHarness(families=("prio3_sum", "prio3_histogram"))

    async def flow():
        await h.start()
        try:
            results = await h.probe()
            assert [r.outcome for r in results] == ["ok", "ok"], [(r.outcome, r.stage, r.detail) for r in results]
            assert results[0].actual == FAMILIES["prio3_sum"].expected
            assert list(results[1].actual) == FAMILIES["prio3_histogram"].expected
            for r in results:
                assert set(r.stages_s) >= {"upload_ack", "collection", "e2e"}
            assert h.plane.fleet_verdict() == "healthy"
            st = h.plane.stats()
            assert st["families"]["prio3_sum"]["last_good_unix"] == NOW.seconds
            assert st["stage_latency_s"]["e2e"]["samples"] == 2

            # cycle 2: a fresh batch interval, fresh reports, same verdict
            results = await h.probe()
            assert [r.outcome for r in results] == ["ok", "ok"], [(r.outcome, r.stage, r.detail) for r in results]
            assert h.plane.stats()["families"]["prio3_sum"]["probes"] == 2
            # e2e histogram moved for every ok probe
            count, _, _ = h.metrics.canary_e2e._hist[()]
            assert count == 4
        finally:
            await h.stop()

    run(flow())


def test_corrupt_aggregate_yields_corrupt_verdict_and_isolation():
    """A corrupt-mode fault on the leader's aggregate share makes the fleet
    answer wrongly — only the canary's known-plaintext verification catches
    it (outcome="corrupt").  The real task's collected count is exactly its
    own uploads: canary reports never leak into its batches."""
    from janus_tpu_torch.core import faults

    h = CanaryHarness(families=("prio3_sum",), real_task=True)

    async def flow():
        await h.start()
        try:
            for m in (1, 0, 1):
                await h.upload_real(m)
            faults.configure(
                [
                    faults.FaultSpec(
                        point="collection.aggregate_share",
                        mode="corrupt",
                        probability=1.0,
                        target=str(TaskId(h.canary_task_ids["prio3_sum"])),
                    )
                ],
                seed=7,
            )
            try:
                (r,) = await h.probe()
            finally:
                faults.clear()
            assert r.outcome == "corrupt", (r.outcome, r.stage, r.detail)
            assert r.stage == "verify"
            st = h.plane.stats()["families"]["prio3_sum"]
            assert st["last_outcome"] == "corrupt"
            assert h.plane.fleet_verdict() == "degraded"  # 1 < fail_threshold
            assert h.metrics.canary_verdicts._values[("prio3_sum", "corrupt")] == 1.0

            # the real task's batch carries exactly its own three reports
            await h.collect_real(expected_count=3, expected_sum=2)

            # heal: the next probe (fresh bucket) verifies clean
            (r,) = await h.probe()
            assert r.outcome == "ok", (r.outcome, r.stage, r.detail)
            assert h.plane.fleet_verdict() == "healthy"
        finally:
            await h.stop()

    run(flow())


def test_chaos_blackout_flips_verdict_then_suppresses_then_heals():
    """Mid-soak ``datastore.tx.begin`` blackout -> probes fail loudly at the
    upload stage and the verdict flips to failing; strict db-SUSPECT ->
    probes are suppressed with a counted backoff (no verdict movement, no
    canary pressure); heal -> the verdict returns to healthy and the real
    traffic uploaded before the window still collects exactly once."""
    from janus_tpu_torch.core import faults

    h = CanaryHarness(families=("prio3_sum",), real_task=True)

    async def flow():
        await h.start()
        try:
            # healthy baseline (also caches the task HPKE configs)
            (r,) = await h.probe()
            assert r.outcome == "ok", (r.outcome, r.stage, r.detail)

            # real traffic lands BEFORE the blackout
            for m in (1, 1, 0):
                await h.upload_real(m)

            # keep the tracker out of SUSPECT while the blackout rages so
            # the loud-failure phase is deterministic; the leader gives up
            # on a transaction after 5 attempts, not 30, so that each
            # blacked-out upload fails within a second
            tracker().configure(failure_threshold=10_000, suspect_dwell_s=300.0)
            h.leader_ds.datastore.max_transaction_retries = 5
            faults.configure([faults.FaultSpec(point="datastore.tx.begin", mode="error")], seed=3)
            try:
                async with aiohttp.ClientSession() as session:
                    for _ in range(h.cfg.fail_threshold):
                        (r,) = await h.plane.probe_once(session)
                        assert r.outcome == "error", (r.outcome, r.detail)
                        assert r.stage == "upload"
                assert h.plane.fleet_verdict() == "failing"
                st = h.plane.stats()["families"]["prio3_sum"]
                assert st["failing_stage"] == "upload"

                # brownout detected: strict SUSPECT suppresses the prober
                tracker().configure(failure_threshold=1)
                tracker().record_tx_failure()
                assert tracker().state() == DB_SUSPECT
                before = h.plane.stats()["families"]["prio3_sum"]["probes"]
                (r,) = await h.plane.probe_once(session=None)
                assert r.outcome == "suppressed" and r.reason == "db_suspect"
                after = h.plane.stats()["families"]["prio3_sum"]
                # counted, not probed: no state movement, no upload attempt
                assert after["probes"] == before
                assert after["suppressed"] == 1
                assert h.plane.stats()["backoffs"] == {"db_suspect": 1}
                assert h.plane.fleet_verdict() == "failing"  # frozen, not reset
            finally:
                faults.clear()
                reset_db_health()

            # heal: the next full probe goes back to healthy
            (r,) = await h.probe()
            assert r.outcome == "ok", (r.outcome, r.stage, r.detail)
            assert h.plane.fleet_verdict() == "healthy"
            assert h.plane.stats()["families"]["prio3_sum"]["last_good_unix"] == NOW.seconds

            # exactly-once: the pre-blackout real uploads collect with the
            # exact count and sum — nothing lost, nothing duplicated
            await h.collect_real(expected_count=3, expected_sum=2)
        finally:
            await h.stop()

    run(flow())


def test_ensure_provisioned_via_task_api_then_probe():
    """The production provisioning path: the prober creates its own task
    pair through both aggregators' management APIs (aggregator_api.py),
    then drives a verified probe through the task it provisioned."""
    from janus_tpu_torch.aggregator_api import aggregator_api_app
    from janus_tpu_torch.messages import Role

    h = CanaryHarness(families=())  # harness only for the DAP pair + drive

    async def flow():
        await h.start()
        leader_api = TestClient(TestServer(aggregator_api_app(h.leader_ds.datastore, ["api-tok"])))
        helper_api = TestClient(TestServer(aggregator_api_app(h.helper_ds.datastore, ["api-tok"])))
        await leader_api.start_server()
        await helper_api.start_server()
        try:
            cfg = _cfg(
                ["prio3_sum"],
                leader_endpoint=h.leader_url,
                helper_endpoint=h.helper_url,
                leader_task_api=str(leader_api.make_url("/")).rstrip("/"),
                helper_task_api=str(helper_api.make_url("/")).rstrip("/"),
                task_api_auth_token="api-tok",
                collect_timeout_s=30.0,
            )
            plane = CanaryPlane(cfg, metrics=h.metrics, wall_fn=lambda: NOW.seconds)
            async with aiohttp.ClientSession() as session:
                await plane.ensure_provisioned(session)
                # idempotent: a second call must not re-POST or re-key
                await plane.ensure_provisioned(session)
            task_id = plane._tasks["prio3_sum"].task_id
            for ds, role in ((h.leader_ds, Role.LEADER), (h.helper_ds, Role.HELPER)):
                task = ds.datastore.run_tx("get", lambda tx: tx.get_aggregator_task(task_id))
                assert task is not None and task.role == role
                assert task.min_batch_size == len(FAMILIES["prio3_sum"].measurements)

            h.plane = plane  # probe through the API-provisioned task
            (r,) = await h.probe()
            assert r.outcome == "ok", (r.outcome, r.stage, r.detail)
            assert r.actual == FAMILIES["prio3_sum"].expected
            assert plane.stats()["families"]["prio3_sum"]["provisioned"]
        finally:
            await leader_api.close()
            await helper_api.close()
            await h.stop()

    run(flow())


# ---------------------------------------------------------------------------
# Parity with the JAX package's plane


def test_families_equal_the_jax_packages():
    from janus_tpu.core.canary import FAMILIES as JAX_FAMILIES
    from janus_tpu.core.canary import STAGES as JAX_STAGES

    from janus_tpu_torch.core.canary import STAGES

    assert STAGES == JAX_STAGES
    assert sorted(FAMILIES) == sorted(JAX_FAMILIES)
    for name, fam in FAMILIES.items():
        other = JAX_FAMILIES[name]
        for field in ("name", "vdaf_instance", "measurements", "expected"):
            assert getattr(fam, field) == getattr(other, field), (name, field)


#: the probe results the seeded sequence draws from: (outcome, stage)
STEP_KINDS = (
    ("ok", None),
    ("error", "upload"),
    ("error", "collection"),
    ("timeout", "collection"),
    ("timeout", "prepare"),
    ("corrupt", "verify"),
    ("suppressed", "db_suspect"),
    ("suppressed", "upload_shed"),
    ("suppressed", "bucket_collision"),
)


def test_verdict_machines_agree_on_a_seeded_sequence():
    """Both planes fed one seeded sequence of probe results (outcomes,
    stages, stage latencies, counted backoffs over two families) give the
    same verdict after each step and the same ``stats()``."""
    from janus_tpu.core.canary import CanaryPlane as JaxPlane
    from janus_tpu.core.metrics import Metrics as JaxMetrics

    families = ("prio3_sum", "prio3_histogram")
    planes = [
        CanaryPlane(_cfg(families, fail_threshold=3), metrics=Metrics(force_fallback=True), wall_fn=lambda: NOW.seconds),
        JaxPlane(_cfg(families, fail_threshold=3), metrics=JaxMetrics(force_fallback=True), wall_fn=lambda: NOW.seconds),
    ]
    rng = np.random.default_rng(15)
    for step in range(200):
        family = families[int(rng.integers(0, 2))]
        outcome, stage = STEP_KINDS[int(rng.integers(0, len(STEP_KINDS)))]
        stages_s = {s: float(rng.random()) for s in ("upload_ack", "collection", "e2e") if rng.random() < 0.7}
        for plane in planes:
            if outcome == "suppressed":
                plane._count_backoff(family, stage)
            else:
                task = SimpleNamespace(family=SimpleNamespace(name=family))
                plane._finish(task, outcome, stage, stages_s=stages_s, detail=f"step {step}")
        assert planes[0].fleet_verdict() == planes[1].fleet_verdict(), step
        assert planes[0].stats() == planes[1].stats(), step
    assert {f["verdict"] for f in planes[0].stats()["families"].values()} <= {"healthy", "degraded", "failing"}


@pytest.mark.parametrize("plane_pkg, fleet_pkg", [(PORT, JAX), (JAX, PORT)], ids=["port_plane_jax_fleet", "jax_plane_port_fleet"])
def test_plane_probes_the_other_packages_fleet(plane_pkg, fleet_pkg):
    """The port's prober verifies a JAX fleet's known sums, and the JAX
    prober the port's: the probe's reports, HPKE configs, collection
    requests and aggregate shares cross the packages."""
    h = CanaryHarness(families=("prio3_sum", "prio3_histogram"), fleet_pkg=fleet_pkg, plane_pkg=plane_pkg)

    async def flow():
        await h.start()
        try:
            results = await h.probe()
            assert [r.outcome for r in results] == ["ok", "ok"], [(r.outcome, r.stage, r.detail) for r in results]
            assert results[0].actual == FAMILIES["prio3_sum"].expected
            assert list(results[1].actual) == FAMILIES["prio3_histogram"].expected
            assert h.plane.fleet_verdict() == "healthy"
        finally:
            await h.stop()

    run(flow())
