"""The DAP routes, free of any HTTP stack.

:func:`dispatch` takes one request as (method, path, query, headers, body)
and answers (status, body, headers).  It holds everything the service does
between the wire and the ``Aggregator.handle_*`` methods: the routing
table, task-id parsing, in-band task provisioning (the ``dap-taskprov``
header), bearer/DAP-Auth-Token extraction, trace-context adoption, the
``http_request`` span and per-route request metrics, and the mapping of
errors to responses (RFC 7807 problem documents, 503 + Retry-After for an
unreachable datastore, 500 for anything else).  ``http_handlers.
aggregator_app`` serves it over aiohttp and ``test_util.InProcessNetwork``
calls it directly, so both answer every request alike.  Routes (reference:
aggregator/src/aggregator/http_handlers.rs:283-357):

    GET     /hpke_config?task_id=...
    GET     /healthz
    GET     /metrics
    PUT     /tasks/:task_id/reports          (OPTIONS: CORS preflight)
    PUT     /tasks/:task_id/aggregation_jobs/:aggregation_job_id
    POST    /tasks/:task_id/aggregation_jobs/:aggregation_job_id
    DELETE  /tasks/:task_id/aggregation_jobs/:aggregation_job_id
    PUT     /tasks/:task_id/collection_jobs/:collection_job_id
    POST    /tasks/:task_id/collection_jobs/:collection_job_id
    DELETE  /tasks/:task_id/collection_jobs/:collection_job_id
    POST    /tasks/:task_id/aggregate_shares
"""

from __future__ import annotations

import logging
import re
import time
from typing import Dict, Mapping, Optional, Tuple

from ..core.auth_tokens import extract_bearer_token
from ..datastore.datastore import DatastoreUnavailable
from ..messages import (
    AggregateShare,
    AggregationJobId,
    AggregationJobResp,
    Collection,
    CollectionJobId,
    HpkeConfigList,
    Report,
    TaskId,
)
from ..messages.codec import CodecError
from .error import AggregatorError, DeletedCollectionJob, InvalidMessage, problem_response

logger = logging.getLogger("janus_tpu_torch.http")

Response = Tuple[int, bytes, Dict[str, str]]

_TEXT = "text/plain; charset=utf-8"
_TASK_ROUTE = re.compile(r"^/tasks/(?P<task_id>[^/]+)/(?P<rest>.+)$")
_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "PUT, POST, GET",
    "Access-Control-Allow-Headers": "content-type",
}


def _text(status: int, text: str, headers: Optional[Dict[str, str]] = None) -> Response:
    return status, text.encode(), {"Content-Type": _TEXT, **(headers or {})}


def _wire(body: bytes, media_type: str) -> Response:
    return 200, body, {"Content-Type": media_type}


def _parse_task_id(text: str) -> TaskId:
    try:
        return TaskId.from_str(text)
    except Exception:
        raise InvalidMessage("malformed task id")


def _route_name(path: str) -> Optional[str]:
    """The route template ``path`` matches, or None (404).  A template
    with no handler for the request's method answers 405."""
    if path in ("/hpke_config", "/healthz", "/metrics"):
        return path
    m = _TASK_ROUTE.match(path)
    if m is None:
        return None
    rest = m["rest"].split("/")
    if rest in (["reports"], ["aggregate_shares"]):
        return "/tasks/{task_id}/" + rest[0]
    if len(rest) == 2 and rest[0] in ("aggregation_jobs", "collection_jobs"):
        return f"/tasks/{{task_id}}/{rest[0]}/{{{rest[0][:-1]}_id}}"
    return None


async def dispatch(
    aggregator,
    method: str,
    path: str,
    query: Mapping[str, str],
    headers: Mapping[str, str],
    body: bytes,
) -> Response:
    """Answer one DAP request: (status, body, headers).  ``headers`` is any
    mapping (names in any case); ``query`` maps each name to one value."""
    route = _route_name(path)
    if route is None:
        return _text(404, "not found")
    from ..core.metrics import GLOBAL_METRICS
    from ..core.trace import parse_traceparent, trace_scope, trace_span

    if route in ("/healthz", "/metrics"):
        # the service's own probes: no span, no request metrics
        if method != "GET":
            return _text(405, "method not allowed")
        if route == "/healthz":
            return _text(200, "ok")
        return 200, GLOBAL_METRICS.export(), {"Content-Type": "text/plain"}

    hdrs = {k.lower(): v for k, v in headers.items()}
    t0 = time.monotonic()
    with trace_scope(trace_id=parse_traceparent(hdrs.get("traceparent"))), trace_span(
        "http_request", cat="http", method=method, route=route
    ):
        resp = await _answer(aggregator, method, path, route, query, hdrs, body)
    GLOBAL_METRICS.observe_http(route, resp[0], time.monotonic() - t0)
    return resp


async def _answer(aggregator, method, path, route, query, hdrs, body) -> Response:
    """The route's handler, with errors mapped to their responses."""
    task_id = None
    try:
        if route == "/hpke_config" and method == "GET":
            config_task = None
            if "task_id" in query:
                config_task = _parse_task_id(query["task_id"])
                await _maybe_taskprov(aggregator, path, hdrs, config_task)
            configs = await aggregator.handle_hpke_config(config_task)
            return _wire(configs.get_encoded(), HpkeConfigList.MEDIA_TYPE)
        m = _TASK_ROUTE.match(path)
        if m is not None:
            task_id = _parse_task_id(m["task_id"])
            from ..core.trace import bind_trace

            bind_trace(task_id=task_id)
            # in-band task provisioning (reference: aggregator.rs:722)
            await _maybe_taskprov(aggregator, path, hdrs, task_id)
            resp = await _task_route(aggregator, method, task_id, m["rest"].split("/"), hdrs, body)
            if resp is not None:
                return resp
        return _text(405, "method not allowed")
    except DeletedCollectionJob:
        return 204, b"", {}
    except AggregatorError as err:
        return problem_response(err, task_id)
    except CodecError as err:
        return problem_response(InvalidMessage(str(err)), task_id)
    except DatastoreUnavailable as err:
        # Datastore unreachable / retries exhausted is a TRANSIENT
        # infrastructure failure, not a protocol error: answer with the
        # DAP-retryable 503 (+ Retry-After) so the leader's lease machinery
        # redelivers — a split-brain window (helper HTTP up, helper
        # datastore down) must not 500 jobs into their failure budget.
        # Scoped to the retries-exhausted subclass: permanent
        # DatastoreErrors (missing rows, schema mismatch) would retry
        # forever under a 503.
        logger.warning("datastore unavailable in %s: %s", path, err)
        return _text(503, "datastore unavailable", {"Retry-After": "5"})
    except Exception:
        logger.exception("internal error in %s %s", method, path)
        return _text(500, "internal error")


async def _maybe_taskprov(aggregator, path: str, hdrs: Mapping[str, str], task_id: TaskId) -> None:
    """In-band task provisioning (reference: aggregator.rs:722).  Upload and
    hpke_config requests are client-originated and cannot carry the peer
    token; everything else must."""
    taskprov_header = hdrs.get("dap-taskprov")
    if not taskprov_header:
        return
    from ..messages.dap import _unb64url

    try:
        encoded = _unb64url(taskprov_header)
    except Exception:
        raise InvalidMessage("malformed dap-taskprov header")
    client_route = path.endswith("/reports") or path.endswith("/hpke_config")
    await aggregator.ensure_taskprov_task(
        task_id,
        encoded,
        extract_bearer_token(hdrs),
        require_peer_auth=not client_route,
    )


async def _task_route(aggregator, method: str, task_id: TaskId, rest, hdrs, body: bytes) -> Optional[Response]:
    """The task-scoped routes; None where the route has no ``method``."""
    auth = extract_bearer_token(hdrs)
    if rest == ["reports"]:
        if method == "PUT":
            await aggregator.handle_upload(task_id, Report.get_decoded(body))
            return 201, b"", {}
        if method == "OPTIONS":
            # reference: http_handlers.rs CORS preflight for browser uploads
            return 204, b"", dict(_CORS)
        return None
    if rest == ["aggregate_shares"]:
        if method != "POST":
            return None
        share = await aggregator.handle_aggregate_share(task_id, body, auth)
        return _wire(share.get_encoded(), AggregateShare.MEDIA_TYPE)
    if rest[0] == "aggregation_jobs":
        job_id = AggregationJobId.from_str(rest[1])
        if method == "PUT":
            resp = await aggregator.handle_aggregate_init(task_id, job_id, body, auth)
            return _wire(resp.get_encoded(), AggregationJobResp.MEDIA_TYPE)
        if method == "POST":
            resp = await aggregator.handle_aggregate_continue(task_id, job_id, body, auth)
            return _wire(resp.get_encoded(), AggregationJobResp.MEDIA_TYPE)
        if method == "DELETE":
            await aggregator.handle_aggregate_delete(task_id, job_id, auth)
            return 204, b"", {}
        return None
    job_id = CollectionJobId.from_str(rest[1])
    if method == "PUT":
        await aggregator.handle_create_collection_job(task_id, job_id, body, auth)
        return 201, b"", {}
    if method == "POST":
        collection = await aggregator.handle_get_collection_job(task_id, job_id, auth)
        if collection is None:
            return 202, b"", {"Retry-After": str(aggregator.config.collection_job_retry_after)}
        return _wire(collection.get_encoded(), Collection.MEDIA_TYPE)
    if method == "DELETE":
        await aggregator.handle_delete_collection_job(task_id, job_id, auth)
        return 204, b"", {}
    return None
