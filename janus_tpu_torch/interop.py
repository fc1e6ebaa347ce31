"""Interop test API binaries.

Copy of ``janus_tpu/interop.py`` for the PyTorch port.  The analog of the
reference's ``interop_binaries`` crate (reference: interop_binaries/src/:
janus_interop_{client,aggregator,collector}.rs, implementing
draft-dcook-ppm-dap-interop-test-design): one multi-call app per role
exposing the ``/internal/test/*`` HTTP API so cross-implementation
harnesses can drive client, leader, helper, and collector uniformly.

    client:      ready, upload
    aggregator:  ready, endpoint_for_task, add_task
    collector:   ready, add_task, collection_start, collection_poll

Run: ``python -m janus_tpu_torch.binaries janus_interop_{client,aggregator,
collector} --port P`` — or build the apps in-process for tests.

Where the port differs: the interop aggregator prepares on the card.
``JANUS_TPU_TORCH_VDAF_BACKEND`` (``cuda``, the default, ``mesh`` or
``oracle``) and ``JANUS_TPU_TORCH_VDAF_DEVICE`` (the torch device of the
card backends; unset is the card, ``cpu`` only when asked) reach its
``Aggregator`` and its aggregation-job driver.  It checks the device before
it serves: with no card and no CPU asked for it exits with the backend's
``VdafError``, never serving on the oracle.  SIGTERM stops it with exit 0
after it prints one JSON line: its backend, its device, each kernel
wrapper's launches in the process and its backend fallbacks.
"""

from __future__ import annotations

import asyncio
import json
import os
import secrets
from typing import TYPE_CHECKING, Dict, Optional

from aiohttp import web

from .core.auth_tokens import AuthenticationToken
from .core.hpke import HpkeKeypair
from .core.time import RealClock
from .datastore import AggregatorTask, Crypter, Datastore, TaskQueryType, generate_key
from .messages import (
    Duration,
    FixedSizeQuery,
    HpkeConfig,
    Interval,
    Query,
    Role,
    TaskId,
    Time,
)
from .messages.dap import _b64url as _b64u, _unb64url as _unb64u

if TYPE_CHECKING:
    from .aggregator import Aggregator


def _vdaf_to_instance(vdaf: dict) -> dict:
    """Interop JSON VDAF object -> VdafInstance description.  The interop
    design carries numbers as JSON strings."""
    t = vdaf["type"]
    out = {"type": t}
    for key in ("bits", "length", "chunk_length", "proofs", "rounds"):
        if key in vdaf:
            out[key] = int(vdaf[key])
    return out


def _success(**kw) -> web.Response:
    return web.json_response({"status": "success", **kw})


def _error(detail: str) -> web.Response:
    return web.json_response({"status": "error", "error": detail})


# ---------------------------------------------------------------------------


def interop_client_app() -> web.Application:
    """reference: interop_binaries/src/commands/janus_interop_client.rs"""

    async def ready(_request):
        return web.Response(status=200)

    async def upload(request: web.Request):
        from .client import Client
        from .vdaf.instances import vdaf_from_instance

        body = await request.json()
        try:
            vdaf = vdaf_from_instance(_vdaf_to_instance(body["vdaf"]))
            measurement = body["measurement"]
            if isinstance(measurement, str):
                measurement = int(measurement)
            elif isinstance(measurement, list):
                measurement = [int(x) for x in measurement]
            client = Client(
                task_id=TaskId(_unb64u(body["task_id"])),
                leader_endpoint=body["leader"],
                helper_endpoint=body["helper"],
                vdaf=vdaf,
                time_precision=Duration(int(body["time_precision"])),
            )
            t = Time(int(body["time"])) if body.get("time") else None
            await client.upload(measurement, time=t)
            return _success()
        except Exception as e:
            return _error(str(e))

    app = web.Application()
    app.add_routes(
        [
            web.post("/internal/test/ready", ready),
            web.post("/internal/test/upload", upload),
        ]
    )
    return app


# ---------------------------------------------------------------------------


def interop_aggregator_app(
    datastore: Datastore, aggregator: Aggregator, dap_app: web.Application
) -> web.Application:
    """reference: interop_binaries janus_interop_aggregator.rs — wraps a DAP
    aggregator, adding the /internal/test/* control surface."""

    async def ready(_request):
        return web.Response(status=200)

    async def endpoint_for_task(_request):
        # DAP is served under /dap/ on the same server
        return _success(endpoint="/dap/")

    async def add_task(request: web.Request):
        body = await request.json()
        try:
            role = Role[body["role"].upper()]
            query_kind = int(body.get("query_type", 1))
            if query_kind == 1:
                query_type = TaskQueryType.time_interval()
            else:
                query_type = TaskQueryType.fixed_size(
                    max_batch_size=int(body["max_batch_size"])
                    if body.get("max_batch_size")
                    else None
                )
            leader_token = body["leader_authentication_token"]
            task = AggregatorTask(
                task_id=TaskId(_unb64u(body["task_id"])),
                peer_aggregator_endpoint=body["helper"]
                if role == Role.LEADER
                else body["leader"],
                query_type=query_type,
                vdaf=_vdaf_to_instance(body["vdaf"]),
                role=role,
                vdaf_verify_key=_unb64u(body["vdaf_verify_key"]),
                min_batch_size=int(body["min_batch_size"]),
                time_precision=Duration(int(body["time_precision"])),
                task_expiration=Time(int(body["task_expiration"]))
                if body.get("task_expiration")
                else None,
                aggregator_auth_token=AuthenticationToken.new_bearer(leader_token)
                if role == Role.LEADER
                else None,
                aggregator_auth_token_hash=AuthenticationToken.new_bearer(
                    leader_token
                ).hash()
                if role == Role.HELPER
                else None,
                collector_auth_token_hash=AuthenticationToken.new_bearer(
                    body["collector_authentication_token"]
                ).hash()
                if body.get("collector_authentication_token")
                else None,
                collector_hpke_config=HpkeConfig.get_decoded(
                    _unb64u(body["collector_hpke_config"])
                )
                if body.get("collector_hpke_config")
                else None,
                hpke_keys=[HpkeKeypair.generate(1)],
            )
            await datastore.run_tx_async(
                "interop_add_task", lambda tx: tx.put_aggregator_task(task)
            )
            return _success()
        except Exception as e:
            return _error(str(e))

    app = web.Application()
    app.add_routes(
        [
            web.post("/internal/test/ready", ready),
            web.post("/internal/test/endpoint_for_task", endpoint_for_task),
            web.post("/internal/test/add_task", add_task),
        ]
    )
    # serve the DAP API on the same server under /
    app.add_subapp("/dap/", dap_app)
    return app


# ---------------------------------------------------------------------------


def interop_collector_app() -> web.Application:
    """reference: interop_binaries janus_interop_collector.rs"""
    tasks: Dict[str, dict] = {}
    handles: Dict[str, asyncio.Task] = {}

    async def ready(_request):
        return web.Response(status=200)

    async def add_task(request: web.Request):
        body = await request.json()
        try:
            keypair = HpkeKeypair.generate(137)
            tasks[body["task_id"]] = {
                "config": body,
                "keypair": keypair,
            }
            return _success(
                collector_hpke_config=_b64u(keypair.config.get_encoded())
            )
        except Exception as e:
            return _error(str(e))

    async def collection_start(request: web.Request):
        from .collector import Collector
        from .vdaf.instances import vdaf_from_instance

        body = await request.json()
        try:
            entry = tasks[body["task_id"]]
            cfg = entry["config"]
            vdaf = vdaf_from_instance(_vdaf_to_instance(cfg["vdaf"]))
            collector = Collector(
                task_id=TaskId(_unb64u(body["task_id"])),
                leader_endpoint=cfg["leader"],
                vdaf=vdaf,
                auth_token=AuthenticationToken.new_bearer(
                    cfg["collector_authentication_token"]
                ),
                hpke_keypair=entry["keypair"],
            )
            q = body["query"]
            if int(q["type"]) == 1:
                query = Query.new_time_interval(
                    Interval(
                        Time(int(q["batch_interval_start"])),
                        Duration(int(q["batch_interval_duration"])),
                    )
                )
            else:
                if q.get("subtype") in (1, "1", None) and not q.get("batch_id"):
                    query = Query.new_fixed_size(FixedSizeQuery.current_batch())
                else:
                    from .messages import BatchId

                    query = Query.new_fixed_size(
                        FixedSizeQuery.by_batch_id(BatchId(_unb64u(q["batch_id"])))
                    )
            agg_param = _unb64u(body.get("agg_param", "") or "")
            handle = secrets.token_hex(16)
            handles[handle] = asyncio.ensure_future(
                collector.collect(query, agg_param)
            )
            return _success(handle=handle)
        except Exception as e:
            return _error(str(e))

    async def collection_poll(request: web.Request):
        body = await request.json()
        task = handles.get(body.get("handle", ""))
        if task is None:
            return _error("unknown handle")
        if not task.done():
            return web.json_response({"status": "in progress"})
        try:
            result = task.result()
        except Exception as e:
            return _error(str(e))
        agg = result.aggregate_result
        if isinstance(agg, list):
            agg_json = [str(x) for x in agg]
        else:
            agg_json = str(agg)
        return _success(
            report_count=result.report_count,
            interval_start=result.interval.start.seconds,
            interval_duration=result.interval.duration.seconds,
            result=agg_json,
        )

    app = web.Application()
    app.add_routes(
        [
            web.post("/internal/test/ready", ready),
            web.post("/internal/test/add_task", add_task),
            web.post("/internal/test/collection_start", collection_start),
            web.post("/internal/test/collection_poll", collection_poll),
        ]
    )
    return app


# ---------------------------------------------------------------------------


def launch_line(backend: str, device: Optional[str]) -> dict:
    """What the interop aggregator prints as it stops: its backend and
    device, each kernel wrapper's launches in this process (as ``/statusz``'s
    ``device`` section counts them), its backend fallbacks and its HPKE
    opens by stage and route."""
    from .core.hpke_batch import route_rows
    from .core.metrics import GLOBAL_METRICS
    from .core.statusz import device_status

    name = "janus_vdaf_backend_fallback_total"
    fallbacks = sum(
        float(line.rsplit(" ", 1)[1])
        for line in GLOBAL_METRICS.export().decode().splitlines()
        if line.startswith(name + "{") or line.startswith(name + " ")
    )
    return {
        "interop_aggregator": {
            "vdaf_backend": backend,
            "vdaf_device": device,
            "kernel_launches": device_status()["kernel_launches"],
            name: fallbacks,
            "hpke_open_rows": {stage: route_rows(stage) for stage in ("upload", "aggregate_init")},
        }
    }


def run_interop_binary(role: str, port: int = 8080) -> None:
    """Entry for ``python -m janus_tpu_torch.binaries janus_interop_<role>``:
    a temporary SQLite datastore + background drivers, the way the reference's
    containerized interop aggregator runs its own migrations + daemons."""
    if role == "client":
        web.run_app(interop_client_app(), port=port)
        return
    if role == "collector":
        web.run_app(interop_collector_app(), port=port)
        return

    import tempfile

    # the aggregator and its drivers load torch: only this role imports them
    from .aggregator import (
        Aggregator,
        AggregationJobCreator,
        AggregationJobDriver,
        CollectionJobDriver,
        Config,
        CreatorConfig,
        DriverConfig,
        aggregator_app,
    )
    from .binaries.main import _check_vdaf_device, _stop_event_on_signals
    from .vdaf import VdafError
    from .vdaf.backend import BACKENDS

    backend = os.environ.get("JANUS_TPU_TORCH_VDAF_BACKEND", "cuda")
    device = os.environ.get("JANUS_TPU_TORCH_VDAF_DEVICE") or None  # None: the card
    if backend not in BACKENDS:
        raise VdafError(f"JANUS_TPU_TORCH_VDAF_BACKEND: unknown backend {backend!r}")
    # the startup check of every binary that prepares: no card, no serving
    _check_vdaf_device(backend, device)
    clock = RealClock()
    path = tempfile.mkstemp(suffix=".sqlite3", prefix="janus-interop-")[1]
    datastore = Datastore(path, Crypter([generate_key()]), clock)
    aggregator = Aggregator(
        datastore,
        clock,
        Config(
            max_upload_batch_write_delay=0.05,
            vdaf_backend=backend,
            vdaf_device=device,
        ),
    )
    dap_app = aggregator_app(aggregator)

    async def main():
        import aiohttp

        stop = _stop_event_on_signals(asyncio.get_running_loop())
        creator = AggregationJobCreator(
            datastore, CreatorConfig(min_aggregation_job_size=1)
        )
        agg_driver = AggregationJobDriver(
            datastore,
            aiohttp.ClientSession,
            DriverConfig(vdaf_backend=backend, vdaf_device=device),
        )
        coll_driver = CollectionJobDriver(datastore, aiohttp.ClientSession)

        async def drive_loop():
            while True:
                try:
                    await creator.run_once()
                    leases = await datastore.run_tx_async(
                        "acq_a",
                        lambda tx: tx.acquire_incomplete_aggregation_jobs(
                            Duration(600), 10
                        ),
                    )
                    for lease in leases:
                        await agg_driver.step_aggregation_job(lease)
                    leases = await datastore.run_tx_async(
                        "acq_c",
                        lambda tx: tx.acquire_incomplete_collection_jobs(
                            Duration(600), 10
                        ),
                    )
                    for lease in leases:
                        await coll_driver.step_collection_job(lease)
                except Exception:
                    import logging

                    logging.getLogger("janus_tpu_torch.interop").exception(
                        "drive failed"
                    )
                await asyncio.sleep(0.5)

        app = interop_aggregator_app(datastore, aggregator, dap_app)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "0.0.0.0", port)
        await site.start()
        task = asyncio.ensure_future(drive_loop())
        try:
            await stop.wait()
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await aggregator.shutdown()
            await agg_driver.close()
            await coll_driver.close()
            await runner.cleanup()
        print(json.dumps(launch_line(backend, device)), flush=True)

    try:
        asyncio.run(main())
    finally:
        datastore.close()
        for suffix in ("", "-wal", "-shm"):
            if os.path.exists(path + suffix):
                os.unlink(path + suffix)
