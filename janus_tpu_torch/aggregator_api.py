"""Management REST API.

Copy of ``janus_tpu/aggregator_api.py`` for the PyTorch port.  The analog of the reference's ``aggregator_api`` crate (reference:
aggregator_api/src/lib.rs:71, routes.rs:32-420): task CRUD, per-task upload
metrics, global HPKE config management, and taskprov peer management, under
the versioned content type and bearer-token auth.

Routes (all JSON, content type ``application/vnd.janus.aggregator+json;
version=0.1``):

    GET    /                          — API root/version probe
    GET    /task_ids
    POST   /tasks
    GET    /tasks/:task_id
    DELETE /tasks/:task_id
    PATCH  /tasks/:task_id            — mutable fields (task_expiration)
    GET    /tasks/:task_id/metrics/uploads
    GET    /hpke_configs              — global HPKE keys
    PUT    /hpke_configs              — generate a new key
    PATCH  /hpke_configs/:config_id   — set state
    DELETE /hpke_configs/:config_id
    GET    /taskprov/peer_aggregators — configured taskprov peers
    POST   /taskprov/peer_aggregators — add a peer (insert-only)
    DELETE /taskprov/peer_aggregators — remove a peer (endpoint+role body)
"""

from __future__ import annotations

import json
import logging
import secrets
from typing import Optional

from aiohttp import web

from .core.auth_tokens import AuthenticationToken
from .core.hpke import HpkeKeypair
from .datastore import (
    AggregatorTask,
    Datastore,
    DatastoreError,
    HpkeKeyState,
    TaskNotFound,
    TaskQueryType,
    TxConflict,
    generate_vdaf_verify_key,
    validate_vdaf_instance,
)
from .messages import Duration, HpkeConfig, Role, TaskId, Time

CONTENT_TYPE = "application/vnd.janus.aggregator+json;version=0.1"


from .messages.dap import _b64url as _b64u, _unb64url as _unb64u


def _task_to_json(task: AggregatorTask) -> dict:
    return {
        "task_id": _b64u(task.task_id.data),
        "peer_aggregator_endpoint": task.peer_aggregator_endpoint,
        "query_type": json.loads(task.query_type.to_json()),
        "vdaf": task.vdaf,
        "role": task.role.name.capitalize(),
        "vdaf_verify_key": _b64u(task.vdaf_verify_key),
        "task_expiration": task.task_expiration.seconds
        if task.task_expiration
        else None,
        "report_expiry_age": task.report_expiry_age.seconds
        if task.report_expiry_age
        else None,
        "min_batch_size": task.min_batch_size,
        "time_precision": task.time_precision.seconds,
        "tolerable_clock_skew": task.tolerable_clock_skew.seconds,
        "collector_hpke_config": _b64u(task.collector_hpke_config.get_encoded())
        if task.collector_hpke_config
        else None,
        "aggregator_auth_token": task.aggregator_auth_token.token
        if task.aggregator_auth_token
        else None,
        "hpke_configs": [_b64u(kp.config.get_encoded()) for kp in task.hpke_keys],
    }


def aggregator_api_app(datastore: Datastore, auth_tokens: list) -> web.Application:
    """Build the management API (reference: aggregator_api/src/lib.rs:71
    aggregator_api_handler).  ``auth_tokens``: accepted bearer tokens."""
    hashes = [AuthenticationToken.new_bearer(t).hash() for t in auth_tokens]

    @web.middleware
    async def auth_middleware(request: web.Request, handler):
        auth = request.headers.get("Authorization", "")
        ok = False
        if auth.startswith("Bearer "):
            try:
                presented = AuthenticationToken.new_bearer(auth[len("Bearer ") :])
                ok = any(h.validate(presented) for h in hashes)
            except ValueError:
                ok = False
        if not ok:
            return web.json_response({"error": "unauthorized"}, status=401)
        try:
            return await handler(request)
        except TaskNotFound:
            return web.json_response({"error": "task not found"}, status=404)
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)

    def ok_json(payload, status=200):
        return web.Response(
            status=status, content_type="application/json", text=json.dumps(payload),
            headers={"X-Content-Type-Version": CONTENT_TYPE},
        )

    async def get_root(_request):
        return ok_json({"version": "0.1"})

    async def get_task_ids(_request):
        ids = await datastore.run_tx_async("api_task_ids", lambda tx: tx.get_task_ids())
        return ok_json({"task_ids": [_b64u(t.data) for t in ids]})

    async def post_task(request: web.Request):
        body = await request.json()
        validate_vdaf_instance(body["vdaf"])
        if not body.get("collector_hpke_config"):
            # without it, collection responses can never be sealed
            raise ValueError("collector_hpke_config is required")
        qt = body.get("query_type", {"kind": "TimeInterval"})
        btws = qt.get("batch_time_window_size")
        role = Role[body["role"].upper()]
        vk = (
            _unb64u(body["vdaf_verify_key"])
            if body.get("vdaf_verify_key")
            else generate_vdaf_verify_key(body["vdaf"])
        )
        agg_token = None
        agg_token_hash = None
        if role == Role.LEADER:
            agg_token = AuthenticationToken.new_bearer(
                body.get("aggregator_auth_token") or secrets.token_urlsafe(32)
            )
        else:
            if not body.get("aggregator_auth_token"):
                raise ValueError("helper task requires aggregator_auth_token")
            agg_token_hash = AuthenticationToken.new_bearer(
                body["aggregator_auth_token"]
            ).hash()
        task = AggregatorTask(
            task_id=TaskId(_unb64u(body["task_id"]))
            if body.get("task_id")
            else TaskId.random(),
            peer_aggregator_endpoint=body["peer_aggregator_endpoint"],
            query_type=TaskQueryType(
                qt["kind"],
                qt.get("max_batch_size"),
                Duration(btws) if btws is not None else None,
            ),
            vdaf=body["vdaf"],
            role=role,
            vdaf_verify_key=vk,
            min_batch_size=body["min_batch_size"],
            time_precision=Duration(body["time_precision"]),
            task_expiration=Time(body["task_expiration"])
            if body.get("task_expiration")
            else None,
            report_expiry_age=Duration(body["report_expiry_age"])
            if body.get("report_expiry_age")
            else None,
            aggregator_auth_token=agg_token,
            aggregator_auth_token_hash=agg_token_hash,
            collector_auth_token_hash=AuthenticationToken.new_bearer(
                body["collector_auth_token"]
            ).hash()
            if body.get("collector_auth_token")
            else None,
            collector_hpke_config=HpkeConfig.get_decoded(
                _unb64u(body["collector_hpke_config"])
            )
            if body.get("collector_hpke_config")
            else None,
            hpke_keys=[HpkeKeypair.generate(1)],
        )
        await datastore.run_tx_async(
            "api_post_task", lambda tx: tx.put_aggregator_task(task)
        )
        payload = _task_to_json(task)
        # Provisioning-time device-path check: surface (in the response AND
        # the log) when this VDAF will run on the CPU oracle regardless of a
        # device backend configuration.  Every task also gets an explicit
        # `device_path` routing label: no silent tier split, in either
        # direction.
        try:
            from .vdaf.backend import device_path_label, device_supported

            vdaf_instance = task.vdaf_instance()
            payload["device_path"] = device_path_label(vdaf_instance)
            ok, reason = device_supported(vdaf_instance)
            if not ok:
                warning = (
                    f"VDAF runs on the CPU oracle, not the device path: {reason}"
                )
                payload["warnings"] = [warning]
                logging.getLogger("janus_tpu_torch.aggregator_api").warning(
                    "task %s: %s", task.task_id, warning
                )
        except Exception:
            # The check must never block provisioning — but a broken check
            # must not be silent either (that would recreate the exact
            # silent tier-split this warning exists to prevent).
            logging.getLogger("janus_tpu_torch.aggregator_api").warning(
                "task %s: device-path capability check failed", task.task_id,
                exc_info=True,
            )
        return ok_json(payload, status=201)

    async def get_task(request: web.Request):
        task_id = TaskId(_unb64u(request.match_info["task_id"]))
        task = await datastore.run_tx_async(
            "api_get_task", lambda tx: tx.get_aggregator_task(task_id)
        )
        if task is None:
            return web.json_response({"error": "task not found"}, status=404)
        return ok_json(_task_to_json(task))

    async def delete_task(request: web.Request):
        task_id = TaskId(_unb64u(request.match_info["task_id"]))
        await datastore.run_tx_async(
            "api_delete_task", lambda tx: tx.delete_task(task_id)
        )
        return web.Response(status=204)

    async def patch_task(request: web.Request):
        task_id = TaskId(_unb64u(request.match_info["task_id"]))
        body = await request.json()
        existing = await datastore.run_tx_async(
            "api_get_task", lambda tx: tx.get_aggregator_task(task_id)
        )
        if existing is None:
            return web.json_response({"error": "task not found"}, status=404)
        if "task_expiration" in body:
            exp = body["task_expiration"]
            await datastore.run_tx_async(
                "api_patch_task",
                lambda tx: tx.update_task_expiration(
                    task_id, Time(exp) if exp is not None else None
                ),
            )
        task = await datastore.run_tx_async(
            "api_get_task", lambda tx: tx.get_aggregator_task(task_id)
        )
        return ok_json(_task_to_json(task))

    async def get_upload_metrics(request: web.Request):
        task_id = TaskId(_unb64u(request.match_info["task_id"]))
        counter = await datastore.run_tx_async(
            "api_metrics", lambda tx: tx.get_task_upload_counter(task_id)
        )
        return ok_json(
            {c: getattr(counter, c) for c in counter.COLUMNS}
        )

    async def get_hpke_configs(_request):
        keypairs = await datastore.run_tx_async(
            "api_hpke", lambda tx: tx.get_global_hpke_keypairs()
        )
        return ok_json(
            [
                {
                    "config": _b64u(kp.config.get_encoded()),
                    "id": kp.config.id,
                    "state": kp.state.value,
                }
                for kp in keypairs
            ]
        )

    async def put_hpke_config(request: web.Request):
        body = await request.json() if request.can_read_body else {}
        config_id = body.get("id")
        if config_id is not None and (
            not isinstance(config_id, int) or not 0 <= config_id <= 255
        ):
            raise ValueError("id must be an integer in [0, 255]")

        # pick-and-insert in ONE transaction so concurrent PUTs cannot race
        def tx_fn(tx):
            used = {kp.config.id for kp in tx.get_global_hpke_keypairs()}
            cid = config_id
            if cid is None:
                free = [i for i in range(256) if i not in used]
                if not free:
                    raise ValueError("all 256 HPKE config ids are in use")
                cid = free[0]
            elif cid in used:
                raise TxConflict(f"HPKE config id {cid} already exists")
            kp = HpkeKeypair.generate(cid)
            tx.put_global_hpke_keypair(kp)
            return kp, cid

        try:
            kp, cid = await datastore.run_tx_async("api_hpke_put", tx_fn)
        except TxConflict as e:
            return web.json_response({"error": str(e)}, status=409)
        return ok_json(
            {"config": _b64u(kp.config.get_encoded()), "id": cid}, status=201
        )

    async def patch_hpke_config(request: web.Request):
        config_id = int(request.match_info["config_id"])
        body = await request.json()
        state = HpkeKeyState(body["state"])
        await datastore.run_tx_async(
            "api_hpke_patch",
            lambda tx: tx.set_global_hpke_keypair_state(config_id, state),
        )
        return web.Response(status=200)

    async def delete_hpke_config(request: web.Request):
        config_id = int(request.match_info["config_id"])
        await datastore.run_tx_async(
            "api_hpke_delete", lambda tx: tx.delete_global_hpke_keypair(config_id)
        )
        return web.Response(status=204)

    # -- taskprov peer aggregators (reference: routes.rs:401-467) --------
    def _peer_to_json(peer) -> dict:
        # Secrets (verify_key_init, auth tokens) never leave the API —
        # matching the reference's PeerAggregator resource shape.
        return {
            "endpoint": peer.endpoint,
            "role": peer.role.name.capitalize(),
            "collector_hpke_config": _b64u(peer.collector_hpke_config.get_encoded()),
            "report_expiry_age": peer.report_expiry_age.seconds
            if peer.report_expiry_age
            else None,
            "tolerable_clock_skew": peer.tolerable_clock_skew.seconds,
        }

    async def get_taskprov_peers(_request):
        peers = await datastore.run_tx_async(
            "api_get_taskprov_peers", lambda tx: tx.get_taskprov_peer_aggregators()
        )
        return ok_json([_peer_to_json(p) for p in peers])

    async def post_taskprov_peer(request: web.Request):
        from .aggregator.taskprov import PeerAggregator

        try:
            body = await request.json()
            role = Role[body["peer_role"].upper()]
            if role not in (Role.LEADER, Role.HELPER):
                # Matching the reference routes: a peer AGGREGATOR is one of
                # the two aggregator roles; anything else would store an
                # unusable peer and silently drop its auth token.
                raise ValueError("peer_role must be Leader or Helper")
            vk_init = _unb64u(body["verify_key_init"])
            peer = _build_peer(PeerAggregator, body, role, vk_init)
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        try:
            await datastore.run_tx_async(
                "api_post_taskprov_peer", lambda tx: tx.put_taskprov_peer_aggregator(peer)
            )
        except TxConflict as e:
            # insert-only, as in the reference (routes.rs:416-421): delete
            # then re-create to change an existing peer.
            return web.json_response({"error": str(e)}, status=409)
        return ok_json(_peer_to_json(peer), status=201)

    def _build_peer(PeerAggregator, body, role, vk_init):
        return PeerAggregator(
            endpoint=body["endpoint"],
            role=role,
            verify_key_init=vk_init,
            collector_hpke_config=HpkeConfig.get_decoded(
                _unb64u(body["collector_hpke_config"])
            ),
            report_expiry_age=Duration(body["report_expiry_age"])
            if body.get("report_expiry_age")
            else None,
            tolerable_clock_skew=Duration(body.get("tolerable_clock_skew", 60)),
            # If WE are the leader for this peer we hold the token; as the
            # helper we hold its hash (reference: taskprov.rs:97).
            aggregator_auth_token=AuthenticationToken.new_bearer(
                body["aggregator_auth_token"]
            )
            if role == Role.HELPER and body.get("aggregator_auth_token")
            else None,
            aggregator_auth_token_hash=AuthenticationToken.new_bearer(
                body["aggregator_auth_token"]
            ).hash()
            if role == Role.LEADER and body.get("aggregator_auth_token")
            else None,
            collector_auth_token_hash=AuthenticationToken.new_bearer(
                body["collector_auth_token"]
            ).hash()
            if body.get("collector_auth_token")
            else None,
        )

    async def delete_taskprov_peer(request: web.Request):
        try:
            body = await request.json()
            role = Role[body["peer_role"].upper()]
            endpoint = body["endpoint"]
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)

        def tx_fn(tx):
            tx.delete_taskprov_peer_aggregator(endpoint, role)

        try:
            await datastore.run_tx_async("api_delete_taskprov_peer", tx_fn)
        except DatastoreError:
            return web.Response(status=404)
        return web.Response(status=204)

    app = web.Application(middlewares=[auth_middleware])
    app.add_routes(
        [
            web.get("/", get_root),
            web.get("/task_ids", get_task_ids),
            web.post("/tasks", post_task),
            web.get("/tasks/{task_id}", get_task),
            web.delete("/tasks/{task_id}", delete_task),
            web.patch("/tasks/{task_id}", patch_task),
            web.get("/tasks/{task_id}/metrics/uploads", get_upload_metrics),
            web.get("/hpke_configs", get_hpke_configs),
            web.put("/hpke_configs", put_hpke_config),
            web.patch("/hpke_configs/{config_id}", patch_hpke_config),
            web.delete("/hpke_configs/{config_id}", delete_hpke_config),
            web.get("/taskprov/peer_aggregators", get_taskprov_peers),
            web.post("/taskprov/peer_aggregators", post_taskprov_peer),
            web.delete("/taskprov/peer_aggregators", delete_taskprov_peer),
        ]
    )
    return app
