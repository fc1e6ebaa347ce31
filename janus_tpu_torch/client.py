"""DAP Client SDK.

The analog of the reference's ``client`` crate (reference:
client/src/lib.rs:270-470): fetch + validate the aggregators' HPKE configs,
shard a measurement through the VDAF, HPKE-seal one input share to each
aggregator, and PUT the Report to the leader.

``prepare_report`` is pure (no I/O) so tests and batch producers can build
wire-exact reports without a network; ``Client.upload`` drives the HTTP flow
with aiohttp.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

from .core.hpke import HpkeApplicationInfo, Label, is_hpke_config_supported, seal
from .core.time import time_to_batch_interval_start
from .messages import (
    Duration,
    HpkeConfig,
    HpkeConfigList,
    InputShareAad,
    PlaintextInputShare,
    Report,
    ReportId,
    ReportMetadata,
    Role,
    TaskId,
    Time,
)


class ClientError(Exception):
    pass


def prepare_report(
    vdaf,
    task_id: TaskId,
    leader_hpke_config: HpkeConfig,
    helper_hpke_config: HpkeConfig,
    time_precision: Duration,
    measurement,
    *,
    time: Optional[Time] = None,
    now: Optional[Time] = None,
) -> Report:
    """Shard + seal one measurement into a wire Report
    (reference: client/src/lib.rs:390 upload's report construction)."""
    for config in (leader_hpke_config, helper_hpke_config):
        if not is_hpke_config_supported(config):
            raise ClientError(f"unsupported HPKE config {config.id}")
    if time is None:
        import time as _time

        time = now if now is not None else Time(int(_time.time()))
    # Report timestamps are rounded down to the task's time precision so the
    # exact upload time is not leaked (reference: client/src/lib.rs).
    t = time_to_batch_interval_start(time, time_precision)

    report_id = ReportId.random()
    rand = secrets.token_bytes(vdaf.RAND_SIZE)
    public_share, input_shares = vdaf.shard(measurement, report_id.data, rand)
    return seal_report(
        vdaf, task_id, leader_hpke_config, helper_hpke_config, report_id, t, public_share, input_shares
    )


def seal_report(
    vdaf,
    task_id: TaskId,
    leader_hpke_config: HpkeConfig,
    helper_hpke_config: HpkeConfig,
    report_id: ReportId,
    time: Time,
    public_share,
    input_shares,
) -> Report:
    """Seal an already sharded report: each input share to its
    aggregator.  The shards must have been made with ``report_id`` as the
    nonce, and ``time`` rounded to the task's time precision."""
    public_share_bytes = vdaf.encode_public_share(public_share)
    metadata = ReportMetadata(report_id, time)
    aad = InputShareAad(task_id, metadata, public_share_bytes).get_encoded()

    encrypted = []
    for role, config, share in (
        (Role.LEADER, leader_hpke_config, input_shares[0]),
        (Role.HELPER, helper_hpke_config, input_shares[1]),
    ):
        plaintext = PlaintextInputShare([], share.encode(vdaf)).get_encoded()
        info = HpkeApplicationInfo.new(Label.INPUT_SHARE, Role.CLIENT, role)
        encrypted.append(seal(config, info, plaintext, aad))

    return Report(metadata, public_share_bytes, encrypted[0], encrypted[1])


@dataclass
class Client:
    """HTTP client front-end (reference: client/src/lib.rs:270 Client)."""

    task_id: TaskId
    leader_endpoint: str
    helper_endpoint: str
    vdaf: object
    time_precision: Duration
    leader_hpke_config: Optional[HpkeConfig] = None
    helper_hpke_config: Optional[HpkeConfig] = None

    async def _fetch_hpke_config(self, session, endpoint: str) -> HpkeConfig:
        url = endpoint.rstrip("/") + "/hpke_config?task_id=" + str(self.task_id)
        async with session.get(url) as resp:
            if resp.status != 200:
                raise ClientError(f"hpke_config fetch failed: {resp.status}")
            body = await resp.read()
        configs = HpkeConfigList.get_decoded(body).hpke_configs
        for config in configs:
            if is_hpke_config_supported(config):
                return config
        raise ClientError("no supported HPKE config advertised")

    async def refresh_hpke_configs(self, session) -> None:
        self.leader_hpke_config = await self._fetch_hpke_config(
            session, self.leader_endpoint
        )
        self.helper_hpke_config = await self._fetch_hpke_config(
            session, self.helper_endpoint
        )

    async def upload(self, measurement, *, time: Optional[Time] = None) -> None:
        """Shard, seal, and PUT the report to the leader
        (reference: client/src/lib.rs:390 upload)."""
        import aiohttp

        async with aiohttp.ClientSession() as session:
            if self.leader_hpke_config is None or self.helper_hpke_config is None:
                await self.refresh_hpke_configs(session)
            report = prepare_report(
                self.vdaf,
                self.task_id,
                self.leader_hpke_config,
                self.helper_hpke_config,
                self.time_precision,
                measurement,
                time=time,
            )
            url = (
                self.leader_endpoint.rstrip("/")
                + f"/tasks/{self.task_id}/reports"
            )
            async with session.put(
                url,
                data=report.get_encoded(),
                headers={"Content-Type": Report.MEDIA_TYPE},
            ) as resp:
                if resp.status not in (200, 201):
                    detail = await resp.text()
                    raise ClientError(f"upload failed: {resp.status} {detail}")
