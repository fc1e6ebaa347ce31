"""In-process DAP transport: aggregators joined without an HTTP stack.

The role ``datastore/test_util.py`` plays for the datastore: an
:class:`InProcessNetwork` maps endpoint URLs to :class:`Aggregator`
instances, and its sessions have the surface the drivers, the client and
the collector use of an ``aiohttp.ClientSession`` (``request``/``get``/
``put``/``post``/``delete`` as async context managers whose response has
``status``, ``read()``, ``text()`` and ``headers``; ``closed`` and
``close()``).  A request goes to the peer through ``dispatch.dispatch``,
the routes ``http_handlers.aggregator_app`` serves over aiohttp, so it
reaches the caller with the status, body and headers it would have over
HTTP.  Nothing here imports aiohttp.

    net = InProcessNetwork()
    leader_url = net.add("leader", leader_aggregator)
    helper_url = net.add("helper", helper_aggregator)
    driver = AggregationJobDriver(leader_ds, net.session, DriverConfig())
"""

from __future__ import annotations

from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from .aggregator import Aggregator
from .dispatch import dispatch


class InProcessResponse:
    def __init__(self, status: int, body: bytes = b"", headers: Optional[dict] = None):
        self.status = status
        self._body = body
        self.headers = dict(headers or {})

    async def read(self) -> bytes:
        return self._body

    async def text(self) -> str:
        return self._body.decode("utf-8", "replace")


class _Call:
    """``session.put(...)`` and friends: an async context manager, as
    aiohttp's request context is used."""

    def __init__(self, coro):
        self._coro = coro

    async def __aenter__(self) -> InProcessResponse:
        return await self._coro

    async def __aexit__(self, *exc) -> None:
        return None


class InProcessNetwork:
    """Endpoint URL -> Aggregator; ``session`` is a session factory."""

    def __init__(self):
        self._aggregators: Dict[str, Aggregator] = {}

    def add(self, name: str, aggregator: Aggregator) -> str:
        """Serve ``aggregator`` at ``inproc://<name>/``; returns that URL."""
        self._aggregators[name] = aggregator
        return f"inproc://{name}/"

    def session(self) -> "InProcessSession":
        return InProcessSession(self)

    def aggregator_at(self, url: str) -> Aggregator:
        parts = urlsplit(url)
        agg = self._aggregators.get(parts.netloc) if parts.scheme == "inproc" else None
        if agg is None:
            raise ConnectionRefusedError(f"no in-process aggregator at {url}")
        return agg


class InProcessSession:
    def __init__(self, network: InProcessNetwork):
        self._network = network
        self.closed = False

    async def close(self) -> None:
        self.closed = True

    def request(self, method: str, url: str, *, data: Optional[bytes] = None, headers=None) -> _Call:
        return _Call(self._dispatch(method.upper(), url, data or b"", dict(headers or {})))

    def get(self, url: str, **kw) -> _Call:
        return self.request("GET", url, **kw)

    def put(self, url: str, **kw) -> _Call:
        return self.request("PUT", url, **kw)

    def post(self, url: str, **kw) -> _Call:
        return self.request("POST", url, **kw)

    def delete(self, url: str, **kw) -> _Call:
        return self.request("DELETE", url, **kw)

    async def _dispatch(self, method: str, url: str, body: bytes, headers: dict) -> InProcessResponse:
        aggregator = self._network.aggregator_at(url)
        parts = urlsplit(url)
        query = {k: v[0] for k, v in parse_qs(parts.query).items()}
        return InProcessResponse(*await dispatch(aggregator, method, parts.path, query, headers, body))
