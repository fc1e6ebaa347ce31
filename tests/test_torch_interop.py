"""The port's interop test API (``janus_tpu_torch/interop.py``): the
``/internal/test/*`` apps of the client, the aggregators and the collector,
driven only through that API over aiohttp TestServers.

- The case of ``tests/test_interop.py`` on the port's apps, the aggregators
  preparing with the ``cuda`` backend on the CPU (``vdaf_device="cpu"``).
- ``_vdaf_to_instance`` gives the JAX package's dict for every interop VDAF
  object (numbers as JSON strings).
- Mixed implementations: leader, helper, client and collector drawn from
  the two packages (all port; the port's leader and client with the JAX
  package's helper and collector; the reverse), for Prio3Count and
  Prio3Histogram(8, 3) in time-interval mode and Prio3Count as a
  ``current_batch`` fixed-size query.  Each collects the exact aggregate
  the all-JAX flow collects for the same seeded measurements.  The JAX side
  runs its oracle.
- The aggregation-job writer sums a job's host out shares through the
  ``cuda`` backend (a helper with no device executor does).
- The client and collector roles import no torch.
- The ``janus_interop_aggregator`` binary as a process: with
  ``JANUS_TPU_TORCH_VDAF_DEVICE=cpu`` it answers ``ready`` and SIGTERM
  stops it with exit 0 after its launch line; without it, on a host with
  no card, it exits non-zero before it serves.
"""

import asyncio
import base64
import functools
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

PORT, JAX = "janus_tpu_torch", "janus_tpu"
REPO = Path(__file__).resolve().parent.parent
PRECISION = 3600


def _b64u(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def aggregator_side(pkg, ds, clock):
    """One package's Aggregator on ``ds`` and the driver config its leader
    steps jobs with: the port's on the ``cuda`` backend on the CPU, the JAX
    package's on its oracle."""
    agg = mod(pkg, "aggregator")
    backend = {"vdaf_device": "cpu"} if pkg == PORT else {"vdaf_backend": "oracle"}
    aggregator = agg.Aggregator(ds, clock, agg.Config(max_upload_batch_write_delay=0.02, **backend))
    return aggregator, agg.DriverConfig(**backend)


async def post_json(client, path, body=None):
    resp = await client.post(path, json=body if body is not None else {})
    assert resp.status == 200, await resp.text()
    return await resp.json()


async def interop_flow(vdaf, measurements, pkgs, query_type=1):
    """Drive one task through the four roles' interop apps: ``pkgs`` maps
    leader, helper, client and collector to a package.  The leader's
    creator, aggregation-job driver and collection-job driver are stepped
    here.  Returns the collector's ``collection_poll`` document."""
    clocks = {side: mod(pkgs[side], "core.time").RealClock() for side in ("leader", "helper")}
    eds = {side: mod(pkgs[side], "datastore.test_util").EphemeralDatastore(clocks[side]) for side in clocks}
    aggs, apps = {}, {}
    for side in ("leader", "helper"):
        interop = mod(pkgs[side], "interop")
        aggs[side], driver_config = aggregator_side(pkgs[side], eds[side].datastore, clocks[side])
        if side == "leader":
            leader_driver_config = driver_config
        apps[side] = interop.interop_aggregator_app(
            eds[side].datastore, aggs[side], mod(pkgs[side], "aggregator").aggregator_app(aggs[side])
        )
    apps["client"] = mod(pkgs["client"], "interop").interop_client_app()
    apps["collector"] = mod(pkgs["collector"], "interop").interop_collector_app()
    clients = {role: TestClient(TestServer(app)) for role, app in apps.items()}
    for c in clients.values():
        await c.start_server()
    lds = eds["leader"].datastore
    leader_agg = mod(pkgs["leader"], "aggregator")
    duration = mod(pkgs["leader"], "messages").Duration
    task_id = _b64u(os.urandom(32))
    now = int(time.time())
    start = now - now % PRECISION
    try:
        for c in clients.values():
            assert (await c.post("/internal/test/ready")).status == 200
        leader_url = str(clients["leader"].make_url("/dap/"))
        helper_url = str(clients["helper"].make_url("/dap/"))

        # the collector's task first: its HPKE config goes to both sides
        doc = await post_json(clients["collector"], "/internal/test/add_task", {
            "task_id": task_id, "leader": leader_url, "vdaf": vdaf,
            "collector_authentication_token": "col-tok", "query_type": query_type,
        })
        assert doc["status"] == "success", doc
        common = {
            "task_id": task_id, "leader": leader_url, "helper": helper_url, "vdaf": vdaf,
            "leader_authentication_token": "agg-tok", "vdaf_verify_key": _b64u(b"\x2a" * 16),
            "min_batch_size": len(measurements), "time_precision": PRECISION, "query_type": query_type,
            "collector_hpke_config": doc["collector_hpke_config"],
        }
        if query_type == 2:
            common["max_batch_size"] = len(measurements)
        for side, extra in (("leader", {"role": "Leader", "collector_authentication_token": "col-tok"}),
                            ("helper", {"role": "Helper"})):
            doc = await post_json(clients[side], "/internal/test/add_task", {**common, **extra})
            assert doc["status"] == "success", doc

        for m in measurements:
            doc = await post_json(clients["client"], "/internal/test/upload", {
                "task_id": task_id, "leader": leader_url, "helper": helper_url, "vdaf": vdaf,
                "measurement": str(m), "time_precision": PRECISION,
            })
            assert doc["status"] == "success", doc
        await asyncio.sleep(0.1)  # the leader's report writer flushes

        creator = leader_agg.AggregationJobCreator(lds, leader_agg.CreatorConfig(min_aggregation_job_size=1))
        await creator.run_once()
        driver = leader_agg.AggregationJobDriver(lds, aiohttp.ClientSession, leader_driver_config)
        while True:
            leases = await lds.run_tx_async(
                "a", lambda tx: tx.acquire_incomplete_aggregation_jobs(duration(600), 10)
            )
            if not leases:
                break
            for lease in leases:
                await driver.step_aggregation_job(lease)
        await driver.close()

        query = ({"type": 1, "batch_interval_start": start, "batch_interval_duration": 2 * PRECISION}
                 if query_type == 1 else {"type": 2, "subtype": 1})
        doc = await post_json(clients["collector"], "/internal/test/collection_start",
                              {"task_id": task_id, "agg_param": "", "query": query})
        assert doc["status"] == "success", doc
        handle = doc["handle"]
        coll_driver = leader_agg.CollectionJobDriver(lds, aiohttp.ClientSession)
        try:
            for _ in range(100):
                leases = await lds.run_tx_async(
                    "c", lambda tx: tx.acquire_incomplete_collection_jobs(duration(600), 10)
                )
                for lease in leases:
                    await coll_driver.step_collection_job(lease)
                doc = await post_json(clients["collector"], "/internal/test/collection_poll", {"handle": handle})
                if doc["status"] == "success":
                    return doc
                assert doc["status"] == "in progress", doc
                await asyncio.sleep(0.05)
        finally:
            await coll_driver.close()
        raise AssertionError("collection never completed")
    finally:
        for c in clients.values():
            await c.close()
        for side in ("leader", "helper"):
            await aggs[side].shutdown()
            eds[side].cleanup()


def run_flow(vdaf, measurements, pkgs, query_type=1):
    return asyncio.new_event_loop().run_until_complete(interop_flow(vdaf, measurements, pkgs, query_type))


def test_interop_end_to_end():
    """The JAX package's interop case on the port: Prio3Count, 4
    measurements, a time-interval query, everything through
    /internal/test/* with the port's aggregators on the cuda backend."""
    measurements = [1, 1, 0, 1]
    pkgs = dict.fromkeys(("leader", "helper", "client", "collector"), PORT)
    doc = run_flow({"type": "Prio3Count"}, measurements, pkgs)
    assert doc["report_count"] == len(measurements)
    assert doc["result"] == str(sum(measurements))


@pytest.mark.parametrize("vdaf", [
    {"type": "Prio3Count"},
    {"type": "Prio3Sum", "bits": "8"},
    {"type": "Prio3SumVec", "bits": "1", "length": "10", "chunk_length": "3"},
    {"type": "Prio3Histogram", "length": "1024", "chunk_length": "316"},
], ids=["count", "sum", "sumvec", "histogram"])
def test_vdaf_to_instance_matches_jax(vdaf):
    from janus_tpu.interop import _vdaf_to_instance as jax_vdaf_to_instance

    from janus_tpu_torch.interop import _vdaf_to_instance

    got = _vdaf_to_instance(vdaf)
    assert got == jax_vdaf_to_instance(vdaf)
    assert all(isinstance(v, int) for k, v in got.items() if k != "type")


#: the interop VDAF objects of the mixed cases and their seeded measurements
MIXED_VDAFS = {
    "count": ({"type": "Prio3Count"}, lambda rng: int(rng.integers(0, 2))),
    "histogram": ({"type": "Prio3Histogram", "length": "8", "chunk_length": "3"}, lambda rng: int(rng.integers(0, 8))),
}
LEGS = {
    "all_port": dict(leader=PORT, helper=PORT, client=PORT, collector=PORT),
    "port_leader_jax_helper": dict(leader=PORT, helper=JAX, client=PORT, collector=JAX),
    "jax_leader_port_helper": dict(leader=JAX, helper=PORT, client=JAX, collector=PORT),
}
MIXED_CASES = [(leg, name, 1) for name in MIXED_VDAFS for leg in LEGS]
MIXED_CASES += [("all_port", "count", 2), ("jax_leader_port_helper", "count", 2)]


def seeded_measurements(name):
    rng = np.random.default_rng([15, len(name)])
    return [MIXED_VDAFS[name][1](rng) for _ in range(6)]


@functools.lru_cache(maxsize=None)
def all_jax_result(name, query_type):
    """The all-JAX flow's (report_count, result) for ``name``'s seeded
    measurements."""
    doc = run_flow(MIXED_VDAFS[name][0], seeded_measurements(name),
                   dict.fromkeys(("leader", "helper", "client", "collector"), JAX), query_type)
    return doc["report_count"], doc["result"]


@pytest.mark.parametrize("leg, name, query_type", MIXED_CASES,
                         ids=[f"{leg}-{name}-{'time_interval' if q == 1 else 'current_batch'}"
                              for leg, name, q in MIXED_CASES])
def test_mixed_implementations_collect_the_all_jax_aggregate(leg, name, query_type):
    vdaf, _ = MIXED_VDAFS[name]
    measurements = seeded_measurements(name)
    doc = run_flow(vdaf, measurements, LEGS[leg], query_type)
    assert (doc["report_count"], doc["result"]) == all_jax_result(name, query_type)
    if name == "count":
        assert doc["result"] == str(sum(measurements))
    else:
        assert doc["result"] == [str(x) for x in np.bincount(measurements, minlength=8)]


def test_dap_app_answers_below_its_mount_point():
    """The interop aggregator serves the DAP app under /dap/: a request
    there reaches the route of the path below the mount point."""
    from janus_tpu_torch.aggregator import aggregator_app
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.time import RealClock
    from janus_tpu_torch.datastore.test_util import EphemeralDatastore
    from janus_tpu_torch.interop import interop_aggregator_app
    from janus_tpu_torch.messages import HpkeConfigList

    eds = EphemeralDatastore(RealClock())
    agg, _ = aggregator_side(PORT, eds.datastore, eds.clock)
    task_id = _b64u(b"\x07" * 32)

    async def flow():
        client = TestClient(TestServer(interop_aggregator_app(eds.datastore, agg, aggregator_app(agg))))
        await client.start_server()
        try:
            doc = await post_json(client, "/internal/test/add_task", {
                "task_id": task_id, "leader": "http://leader.invalid/", "helper": "http://helper.invalid/",
                "vdaf": {"type": "Prio3Count"}, "leader_authentication_token": "agg-tok", "role": "Helper",
                "vdaf_verify_key": _b64u(b"\x2a" * 16), "min_batch_size": 1, "time_precision": PRECISION,
                "collector_hpke_config": _b64u(HpkeKeypair.generate(3).config.get_encoded()),
            })
            assert doc["status"] == "success", doc
            resp = await client.get(f"/dap/hpke_config?task_id={task_id}")
            assert resp.status == 200, await resp.text()
            assert len(HpkeConfigList.get_decoded(await resp.read()).hpke_configs) == 1
            assert (await client.get(f"/dap/nowhere?task_id={task_id}")).status == 404
        finally:
            await client.close()
            await agg.shutdown()
            eds.cleanup()

    asyncio.new_event_loop().run_until_complete(flow())


@pytest.mark.parametrize("desc, values", [
    ({"type": "Prio3Count"}, [[1], [0], [1]]),
    ({"type": "Prio3Histogram", "length": 4, "chunk_length": 2}, [[0, 1, 0, 0], [0, 1, 0, 1]]),
], ids=["count", "histogram"])
def test_writer_sums_host_shares_on_the_cuda_backend(desc, values):
    """A helper with no device executor writes a job of several finished
    reports by summing their host out shares through its ``cuda`` backend
    (``aggregate_batch``), which reads them as the prepare's limbs."""
    from janus_tpu_torch.aggregator.aggregation_job_writer import AggregationJobWriter
    from janus_tpu_torch.vdaf.backend import make_backend
    from janus_tpu_torch.vdaf.instances import vdaf_from_instance

    vdaf = vdaf_from_instance(desc)
    field = vdaf.flp.field
    shares = [[(v * 3 + 1) % field.MODULUS for v in row] for row in values]
    writer = AggregationJobWriter(None, vdaf, backend=make_backend(vdaf, "cuda", device="cpu"))
    want = shares[0]
    for row in shares[1:]:
        want = field.vec_add(want, row)
    assert writer._sum_shares(field, shares) == want


# ---------------------------------------------------------------------------
# The binary as a process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_aggregator(tmp_path, **env_extra):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("JANUS_TPU_TORCH_VDAF_")}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp_path), **env_extra)
    log = tmp_path / "interop.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "janus_tpu_torch.binaries", "janus_interop_aggregator", "--port", str(port)],
            env=env, cwd=str(tmp_path), stdout=out, stderr=subprocess.STDOUT,
        )
    return proc, port, log


def test_client_and_collector_roles_load_no_torch():
    """The client and collector roles prepare nothing: building their apps
    imports no torch, so their processes start without the CUDA libraries."""
    code = (
        "import sys\n"
        "from janus_tpu_torch import interop\n"
        "interop.interop_client_app(); interop.interop_collector_app()\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_interop_aggregator_binary_on_the_cpu(tmp_path):
    proc, port, log = _spawn_aggregator(tmp_path, JANUS_TPU_TORCH_VDAF_DEVICE="cpu")
    try:
        deadline = time.monotonic() + 60  # a loaded host starts it slowly
        while True:
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/internal/test/ready", data=b"{}", method="POST")
                with urllib.request.urlopen(req, timeout=1) as resp:
                    assert resp.status == 200
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(x) for x in log.read_text().splitlines() if x.startswith('{"interop_aggregator"')]
    assert len(lines) == 1, log.read_text()
    line = lines[0]["interop_aggregator"]
    assert line["vdaf_backend"] == "cuda" and line["vdaf_device"] == "cpu"
    assert line["janus_vdaf_backend_fallback_total"] == 0
    assert isinstance(line["kernel_launches"], dict)
    assert not list(tmp_path.glob("janus-interop-*")), "the temporary datastore was left behind"


def test_interop_aggregator_binary_without_a_card_exits_before_ready(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc, port, log = _spawn_aggregator(tmp_path)
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "needs a CUDA card" in log.read_text()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/internal/test/ready", data=b"{}", timeout=1)
