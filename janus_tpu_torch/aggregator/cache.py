"""Refreshed config caches: global HPKE keypairs and taskprov peers.

The reference keeps request-path config data out of the database hot path
with periodically-refreshed caches (reference: aggregator/src/cache.rs:24-208
— GlobalHpkeKeypairCache with a refresh task, PeerAggregatorCache).  Same
design here: a TTL snapshot served synchronously, plus an asyncio refresh
loop started lazily on first use so steady-state requests never wait on a
transaction.  A refresh failure keeps serving the previous snapshot (stale
config beats an outage, matching the reference's error-tolerant refresher).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Generic, List, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class RefreshingCache(Generic[T]):
    """TTL snapshot + lazy background refresh loop."""

    def __init__(
        self,
        fetch: Callable[[], Awaitable[T]],
        refresh_interval: float,
        name: str,
    ):
        self._fetch = fetch
        self._interval = refresh_interval
        self._name = name
        self._value: Optional[T] = None
        self._fetched_at: float = float("-inf")
        self._task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()

    async def get(self) -> T:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._refresh_loop())
        if self._fetched_at == float("-inf"):
            async with self._lock:
                if self._fetched_at == float("-inf"):  # double-checked
                    self._value = await self._fetch()
                    self._fetched_at = time.monotonic()
        return self._value

    async def _refresh_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self._interval)
                try:
                    self._value = await self._fetch()
                    self._fetched_at = time.monotonic()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.warning(
                        "%s cache refresh failed; serving stale snapshot",
                        self._name,
                        exc_info=True,
                    )
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def invalidate(self) -> None:
        """Force the next get() to fetch.  For in-process embedders and
        tests; the management API usually runs in a separate process, where
        the refresh interval is the propagation delay (as in the
        reference)."""
        self._fetched_at = float("-inf")


class GlobalHpkeKeypairCache(RefreshingCache[List[object]]):
    """Active global HPKE keypairs (reference: cache.rs:24-120)."""

    def __init__(self, datastore, refresh_interval: float = 60.0):
        super().__init__(
            lambda: datastore.run_tx_async(
                "cache_global_hpke", lambda tx: tx.get_global_hpke_keypairs()
            ),
            refresh_interval,
            "global-hpke-keypair",
        )

    async def active_keypairs(self):
        return [kp for kp in await self.get() if kp.state.value == "Active"]

    async def active_configs(self):
        return [kp.config for kp in await self.active_keypairs()]


class PeerAggregatorCache(RefreshingCache[List[object]]):
    """Taskprov peer aggregators (reference: cache.rs:150-208)."""

    def __init__(self, datastore, refresh_interval: float = 60.0):
        super().__init__(
            lambda: datastore.run_tx_async(
                "cache_taskprov_peers", lambda tx: tx.get_taskprov_peer_aggregators()
            ),
            refresh_interval,
            "peer-aggregator",
        )

    async def peers(self):
        return await self.get()
