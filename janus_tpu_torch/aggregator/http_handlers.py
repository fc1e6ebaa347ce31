"""DAP HTTP API over aiohttp.

The analog of the trillium router (reference:
aggregator/src/aggregator/http_handlers.rs:283-357).  Every route, the
error mapping, the request span and the request metrics live in
:func:`dispatch.dispatch`, which has no HTTP stack of its own; this module
serves it through one aiohttp handler.
"""

from __future__ import annotations

from aiohttp import web

from .aggregator import Aggregator
from .dispatch import dispatch


def aggregator_app(aggregator: Aggregator) -> web.Application:
    """Build the DAP service (reference: http_handlers.rs:283
    aggregator_handler)."""

    async def handle(request: web.Request) -> web.Response:
        # the path below the app's mount point: the interop aggregator
        # serves this app under /dap/
        status, body, headers = await dispatch(
            aggregator,
            request.method,
            "/" + request.match_info["tail"],
            dict(request.query),
            request.headers,
            await request.read(),
        )
        return web.Response(status=status, body=body or None, headers=headers)

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.router.add_route("*", "/{tail:.*}", handle)
    return app
