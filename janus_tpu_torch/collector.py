"""DAP Collector SDK.

The analog of the reference's ``collector`` crate (reference:
collector/src/lib.rs:381-760): PUT a CollectionReq, poll the collection job
with Retry-After-aware backoff, HPKE-open both aggregate shares, and unshard
to the aggregate result.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from .core.auth_tokens import AuthenticationToken
from .core.hpke import HpkeApplicationInfo, HpkeKeypair, Label, open_
from .messages import (
    AggregateShareAad,
    BatchId,
    BatchSelector,
    Collection,
    CollectionJobId,
    CollectionReq,
    FixedSize,
    Query,
    TaskId,
    TimeInterval,
)


class CollectorError(Exception):
    pass


@dataclass
class CollectionResult:
    """Decrypted, unsharded collection (reference: collector/src/lib.rs
    Collection)."""

    partial_batch_selector: object
    report_count: int
    interval: object
    aggregate_result: object


@dataclass
class Collector:
    """reference: collector/src/lib.rs:381 Collector"""

    task_id: TaskId
    leader_endpoint: str
    vdaf: object
    auth_token: AuthenticationToken
    hpke_keypair: HpkeKeypair  # collector's own keypair
    poll_interval: float = 1.0
    max_poll_time: float = 120.0

    def _query_class(self, query: Query):
        return query.query_type

    async def collect(
        self,
        query: Query,
        aggregation_parameter: bytes = b"",
        *,
        session=None,
    ) -> CollectionResult:
        """PUT + poll until complete (reference: collector/src/lib.rs:439
        collect, :639 poll_until_complete)."""
        import aiohttp

        own_session = session is None
        if own_session:
            session = aiohttp.ClientSession()
        try:
            collection_job_id = CollectionJobId.random()
            await self.create_job(query, collection_job_id, aggregation_parameter, session=session)

            # poll (reference: :522 poll_once w/ Retry-After)
            deadline = asyncio.get_running_loop().time() + self.max_poll_time
            while True:
                out, retry_after = await self.poll_once(
                    query, collection_job_id, aggregation_parameter, session=session
                )
                if out is not None:
                    return out
                if asyncio.get_running_loop().time() > deadline:
                    raise CollectorError("collection timed out")
                await asyncio.sleep(
                    min(retry_after or self.poll_interval, self.poll_interval)
                )
        finally:
            if own_session:
                await session.close()

    def _job_url(self, collection_job_id: CollectionJobId) -> str:
        return (
            self.leader_endpoint.rstrip("/")
            + f"/tasks/{self.task_id}/collection_jobs/{collection_job_id}"
        )

    async def create_job(
        self,
        query: Query,
        collection_job_id: CollectionJobId,
        aggregation_parameter: bytes = b"",
        *,
        session,
    ) -> None:
        """PUT the collection job (reference: collector/src/lib.rs:439)."""
        name, value = self.auth_token.request_authentication()
        headers = {name: value, "Content-Type": CollectionReq.MEDIA_TYPE}
        req = CollectionReq(query, aggregation_parameter)
        url = self._job_url(collection_job_id)
        async with session.put(url, data=req.get_encoded(), headers=headers) as resp:
            if resp.status not in (200, 201):
                raise CollectorError(
                    f"collection create failed: {resp.status} {await resp.text()}"
                )

    async def poll_once(
        self,
        query: Query,
        collection_job_id: CollectionJobId,
        aggregation_parameter: bytes = b"",
        *,
        session,
    ) -> tuple:
        """One POST poll -> (result | None, server Retry-After seconds | None)
        (reference: collector/src/lib.rs:522 poll_once)."""
        name, value = self.auth_token.request_authentication()
        url = self._job_url(collection_job_id)
        async with session.post(url, headers={name: value}) as resp:
            if resp.status == 200:
                body = await resp.read()
                return (
                    self._decrypt(
                        Collection.get_decoded(body, self._query_class(query)),
                        query,
                        aggregation_parameter,
                    ),
                    None,
                )
            if resp.status != 202:
                raise CollectorError(
                    f"collection poll failed: {resp.status} {await resp.text()}"
                )
            retry_after = resp.headers.get("Retry-After")
            try:
                return None, float(retry_after) if retry_after is not None else None
            except ValueError:
                return None, None

    def _decrypt(
        self, collection: Collection, query: Query, aggregation_parameter: bytes
    ) -> CollectionResult:
        """HPKE-open both shares and unshard
        (reference: collector/src/lib.rs:560-636)."""
        if query.query_type is TimeInterval:
            batch_selector = BatchSelector.new_time_interval(query.query_body)
        else:
            batch_selector = BatchSelector.new_fixed_size(
                collection.partial_batch_selector.batch_identifier
            )
        aad = AggregateShareAad(
            self.task_id, aggregation_parameter, batch_selector
        ).get_encoded()
        from .messages import Role

        agg_param = self.vdaf.decode_agg_param(aggregation_parameter)
        field = self.vdaf.field_for_agg_param(agg_param)
        shares = []
        for role, ct in (
            (Role.LEADER, collection.leader_encrypted_agg_share),
            (Role.HELPER, collection.helper_encrypted_agg_share),
        ):
            info = HpkeApplicationInfo.new(Label.AGGREGATE_SHARE, role, Role.COLLECTOR)
            plaintext = open_(self.hpke_keypair, info, ct, aad)
            shares.append(field.decode_vec(plaintext))
        result = self.vdaf.unshard_with_param(
            agg_param, shares, collection.report_count
        )
        return CollectionResult(
            partial_batch_selector=collection.partial_batch_selector,
            report_count=collection.report_count,
            interval=collection.interval,
            aggregate_result=result,
        )
