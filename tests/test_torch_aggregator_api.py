"""The port's management API (``janus_tpu_torch/aggregator_api.py``): the
cases of ``tests/test_aggregator_api.py`` against the port's modules, and
the taskprov peer routes and the device-path label of a provisioned task
(reference: aggregator_api/src/tests.rs style)."""

import asyncio
import base64

import pytest
from aiohttp.test_utils import TestClient, TestServer

from janus_tpu_torch.aggregator_api import aggregator_api_app
from janus_tpu_torch.core.time import MockClock
from janus_tpu_torch.datastore.test_util import EphemeralDatastore
from janus_tpu_torch.messages import Time

TOKEN = "mgmt-token-123"


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_management_api_lifecycle():
    eds = EphemeralDatastore(MockClock(Time(1_600_002_000)))
    app = aggregator_api_app(eds.datastore, [TOKEN])

    async def flow():
        client = TestClient(TestServer(app))
        await client.start_server()
        headers = {"Authorization": "Bearer " + TOKEN}
        try:
            # unauthorized
            resp = await client.get("/task_ids")
            assert resp.status == 401
            resp = await client.get(
                "/task_ids", headers={"Authorization": "Bearer wrong"}
            )
            assert resp.status == 401

            # root + empty task list
            resp = await client.get("/", headers=headers)
            assert resp.status == 200
            resp = await client.get("/task_ids", headers=headers)
            assert (await resp.json())["task_ids"] == []

            # create a task (collector_hpke_config is mandatory: without it
            # collection responses could never be sealed)
            from janus_tpu_torch.core.hpke import HpkeKeypair

            collector_cfg = base64.urlsafe_b64encode(
                HpkeKeypair.generate(9).config.get_encoded()
            ).rstrip(b"=").decode()
            resp = await client.post(
                "/tasks",
                headers=headers,
                json={
                    "peer_aggregator_endpoint": "https://helper.example.com/",
                    "vdaf": {"type": "Prio3Count"},
                    "role": "Leader",
                    "min_batch_size": 10,
                    "time_precision": 3600,
                    "collector_auth_token": "col-tok",
                    "collector_hpke_config": collector_cfg,
                },
            )
            assert resp.status == 201, await resp.text()
            doc = await resp.json()
            task_id = doc["task_id"]
            assert doc["role"] == "Leader"
            assert doc["aggregator_auth_token"]  # generated
            assert len(base64.urlsafe_b64decode(doc["vdaf_verify_key"] + "==")) == 16
            assert doc["device_path"].startswith("cuda: batched device prepare")
            assert "warnings" not in doc

            # bad vdaf rejected
            resp = await client.post(
                "/tasks",
                headers=headers,
                json={
                    "peer_aggregator_endpoint": "x",
                    "vdaf": {"type": "NoSuchVdaf"},
                    "role": "Leader",
                    "min_batch_size": 1,
                    "time_precision": 3600,
                },
            )
            assert resp.status == 400

            # fetch + list + metrics
            resp = await client.get(f"/tasks/{task_id}", headers=headers)
            assert (await resp.json())["task_id"] == task_id
            resp = await client.get("/task_ids", headers=headers)
            assert (await resp.json())["task_ids"] == [task_id]
            resp = await client.get(
                f"/tasks/{task_id}/metrics/uploads", headers=headers
            )
            assert (await resp.json())["report_success"] == 0

            # patch expiration
            resp = await client.patch(
                f"/tasks/{task_id}",
                headers=headers,
                json={"task_expiration": 1_700_000_000},
            )
            assert (await resp.json())["task_expiration"] == 1_700_000_000

            # global HPKE config lifecycle
            resp = await client.put("/hpke_configs", headers=headers, json={})
            assert resp.status == 201
            config_id = (await resp.json())["id"]
            resp = await client.patch(
                f"/hpke_configs/{config_id}",
                headers=headers,
                json={"state": "Active"},
            )
            assert resp.status == 200
            resp = await client.get("/hpke_configs", headers=headers)
            configs = await resp.json()
            assert configs[0]["state"] == "Active"
            resp = await client.delete(
                f"/hpke_configs/{config_id}", headers=headers
            )
            assert resp.status == 204

            # delete task
            resp = await client.delete(f"/tasks/{task_id}", headers=headers)
            assert resp.status == 204
            resp = await client.get(f"/tasks/{task_id}", headers=headers)
            assert resp.status == 404
        finally:
            await client.close()

    run(flow())
    eds.cleanup()


def test_taskprov_peer_routes():
    """Insert, list and delete a taskprov peer aggregator; a second insert
    of the same (endpoint, role) conflicts."""
    from janus_tpu_torch.core.hpke import HpkeKeypair

    eds = EphemeralDatastore(MockClock(Time(1_600_002_000)))
    app = aggregator_api_app(eds.datastore, [TOKEN])
    b64 = lambda b: base64.urlsafe_b64encode(b).rstrip(b"=").decode()  # noqa: E731
    peer = {
        "endpoint": "https://peer.example.com/",
        "peer_role": "Helper",
        "verify_key_init": b64(b"\x07" * 32),
        "collector_hpke_config": b64(HpkeKeypair.generate(3).config.get_encoded()),
        "aggregator_auth_token": "peer-token",
    }

    async def flow():
        client = TestClient(TestServer(app))
        await client.start_server()
        headers = {"Authorization": "Bearer " + TOKEN}
        try:
            resp = await client.post("/taskprov/peer_aggregators", headers=headers, json=peer)
            assert resp.status == 201, await resp.text()
            resp = await client.post("/taskprov/peer_aggregators", headers=headers, json=peer)
            assert resp.status == 409
            resp = await client.get("/taskprov/peer_aggregators", headers=headers)
            listed = await resp.json()
            assert [p["endpoint"] for p in listed] == [peer["endpoint"]]
            resp = await client.delete(
                "/taskprov/peer_aggregators", headers=headers, json={"endpoint": peer["endpoint"], "peer_role": "Helper"}
            )
            assert resp.status == 204
            resp = await client.get("/taskprov/peer_aggregators", headers=headers)
            assert await resp.json() == []
        finally:
            await client.close()

    run(flow())
    eds.cleanup()
