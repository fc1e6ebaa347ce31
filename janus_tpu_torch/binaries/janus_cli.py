"""Ops CLI.

Copy of ``janus_tpu/binaries/janus_cli.py`` for the PyTorch port.  The
analog of ``janus_cli`` plus the ``tools`` crate binaries (reference:
aggregator/src/binaries/janus_cli.rs:70-177, tools/src/bin/{dap_decode,
hpke_keygen}.rs, tools/src/bin/collect): task provisioning from YAML,
datastore/HPKE key generation, wire-message decoding, and a collector
front-end.
"""

from __future__ import annotations

import base64
import json
import secrets
import sys

import click


from ..messages.dap import _b64url as _b64u, _unb64url as _unb64u


@click.group()
def cli():
    """janus_tpu_torch operations CLI."""


@cli.command("create-datastore-key")
def create_datastore_key():
    """Generate a datastore column-encryption key (reference:
    janus_cli.rs create-datastore-key)."""
    click.echo(_b64u(secrets.token_bytes(16)))


@cli.command("generate-hpke-key")
@click.option("--id", "config_id", type=int, default=1, help="HPKE config id")
def generate_hpke_key(config_id: int):
    """Generate an HPKE keypair (reference: tools/src/bin/hpke_keygen.rs:13)."""
    from ..core.hpke import HpkeKeypair

    kp = HpkeKeypair.generate(config_id)
    click.echo(
        json.dumps(
            {
                "config": _b64u(kp.config.get_encoded()),
                "private_key": _b64u(kp.private_key),
                "id": config_id,
            }
        )
    )


@cli.command("provision-tasks")
@click.argument("tasks_file", type=click.Path(exists=True))
@click.option("--config-file", type=click.Path(exists=True), default=None)
def provision_tasks(tasks_file: str, config_file):
    """Provision tasks from a YAML file into the datastore (reference:
    janus_cli.rs provision-tasks).

    Each task entry: task_id (b64url, optional — generated if absent),
    peer_aggregator_endpoint, query_type ({kind, max_batch_size?}), vdaf
    ({type, ...params}), role (Leader|Helper), vdaf_verify_key (b64url),
    min_batch_size, time_precision_s, auth tokens, collector_hpke_config,
    hpke_keys.
    """
    import yaml

    from ..core.auth_tokens import AuthenticationToken
    from ..core.hpke import HpkeKeypair
    from ..core.time import RealClock
    from ..datastore import (
        AggregatorTask,
        Crypter,
        Datastore,
        TaskQueryType,
    )
    from ..messages import Duration, HpkeConfig, Role, TaskId, Time
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    with open(tasks_file) as f:
        entries = yaml.safe_load(f)
    for entry in entries:
        qt = entry.get("query_type", {"kind": "TimeInterval"})
        btws = qt.get("batch_time_window_size")
        task = AggregatorTask(
            task_id=TaskId(_unb64u(entry["task_id"]))
            if "task_id" in entry
            else TaskId.random(),
            peer_aggregator_endpoint=entry["peer_aggregator_endpoint"],
            query_type=TaskQueryType(
                qt["kind"],
                qt.get("max_batch_size"),
                Duration(btws) if btws is not None else None,
            ),
            vdaf=entry["vdaf"],
            role=Role[entry["role"].upper()],
            vdaf_verify_key=_unb64u(entry["vdaf_verify_key"]),
            min_batch_size=entry["min_batch_size"],
            time_precision=Duration(entry["time_precision_s"]),
            task_expiration=Time(entry["task_expiration"])
            if entry.get("task_expiration")
            else None,
            report_expiry_age=Duration(entry["report_expiry_age_s"])
            if entry.get("report_expiry_age_s")
            else None,
            aggregator_auth_token=AuthenticationToken.new_bearer(
                entry["aggregator_auth_token"]
            )
            if entry.get("aggregator_auth_token")
            else None,
            aggregator_auth_token_hash=AuthenticationToken.new_bearer(
                entry["aggregator_auth_token_for_hash"]
            ).hash()
            if entry.get("aggregator_auth_token_for_hash")
            else None,
            collector_auth_token_hash=AuthenticationToken.new_bearer(
                entry["collector_auth_token_for_hash"]
            ).hash()
            if entry.get("collector_auth_token_for_hash")
            else None,
            collector_hpke_config=HpkeConfig.get_decoded(
                _unb64u(entry["collector_hpke_config"])
            )
            if entry.get("collector_hpke_config")
            else None,
            hpke_keys=[
                HpkeKeypair(
                    HpkeConfig.get_decoded(_unb64u(k["config"])),
                    _unb64u(k["private_key"]),
                )
                for k in entry.get("hpke_keys", [])
            ],
        )
        ds.run_tx("provision_task", lambda tx, t=task: tx.put_aggregator_task(t))
        click.echo(f"provisioned task {task.task_id}")


@cli.command("generate-global-hpke-key")
@click.option("--id", "config_id", type=int, required=True)
@click.option("--config-file", type=click.Path(exists=True), default=None)
def generate_global_hpke_key(config_id: int, config_file):
    """Generate + store a global HPKE key (reference: janus_cli.rs
    generate-global-hpke-key)."""
    from ..core.hpke import HpkeKeypair
    from ..core.time import RealClock
    from ..datastore import Crypter, Datastore
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    kp = HpkeKeypair.generate(config_id)
    ds.run_tx("put_global_key", lambda tx: tx.put_global_hpke_keypair(kp))
    click.echo(f"generated global HPKE key {config_id}")


@cli.command("set-global-hpke-key-state")
@click.option("--id", "config_id", type=int, required=True)
@click.option(
    "--state", type=click.Choice(["Pending", "Active", "Expired"]), required=True
)
@click.option("--config-file", type=click.Path(exists=True), default=None)
def set_global_hpke_key_state(config_id: int, state: str, config_file):
    """reference: janus_cli.rs set-global-hpke-key-state"""
    from ..core.time import RealClock
    from ..datastore import Crypter, Datastore, HpkeKeyState
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    ds.run_tx(
        "set_key_state",
        lambda tx: tx.set_global_hpke_keypair_state(config_id, HpkeKeyState(state)),
    )
    click.echo("ok")


@cli.command("add-taskprov-peer-aggregator")
@click.option("--endpoint", required=True)
@click.option("--role", type=click.Choice(["Leader", "Helper"]), required=True)
@click.option("--verify-key-init", required=True, help="b64url 32 bytes")
@click.option("--collector-hpke-config", required=True, help="b64url HpkeConfig")
@click.option("--aggregator-auth-token", default=None)
@click.option("--aggregator-auth-token-for-hash", default=None)
@click.option("--config-file", type=click.Path(exists=True), default=None)
def add_taskprov_peer_aggregator(
    endpoint,
    role,
    verify_key_init,
    collector_hpke_config,
    aggregator_auth_token,
    aggregator_auth_token_for_hash,
    config_file,
):
    """reference: janus_cli.rs add-taskprov-peer-aggregator"""
    from ..aggregator.taskprov import PeerAggregator
    from ..core.auth_tokens import AuthenticationToken
    from ..core.time import RealClock
    from ..datastore import Crypter, Datastore
    from ..messages import HpkeConfig, Role
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    peer = PeerAggregator(
        endpoint=endpoint,
        role=Role[role.upper()],
        verify_key_init=_unb64u(verify_key_init),
        collector_hpke_config=HpkeConfig.get_decoded(_unb64u(collector_hpke_config)),
        aggregator_auth_token=AuthenticationToken.new_bearer(aggregator_auth_token)
        if aggregator_auth_token
        else None,
        aggregator_auth_token_hash=AuthenticationToken.new_bearer(
            aggregator_auth_token_for_hash
        ).hash()
        if aggregator_auth_token_for_hash
        else None,
    )
    ds.run_tx("add_peer", lambda tx: tx.put_taskprov_peer_aggregator(peer))
    click.echo("ok")


@cli.command("quarantine-list")
@click.option("--task", default=None, help="hex task id filter")
@click.option(
    "--stage",
    default=None,
    help="stage filter (upload_open|prep_init|combine|journal|accumulator_journal)",
)
@click.option("--limit", type=int, default=256)
@click.option("--config-file", type=click.Path(exists=True), default=None)
def quarantine_list(task, stage, limit, config_file):
    """List quarantined poison/corrupt rows: what the bisection
    sieve and the journal checksum fence pulled out of the pipeline."""
    from ..core.time import RealClock
    from ..datastore import Crypter, Datastore
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    rows = ds.run_tx(
        "quarantine_list",
        lambda tx: tx.get_quarantined_reports(task=task, stage=stage, limit=limit),
    )
    for row in rows:
        click.echo(json.dumps(row))
    click.echo(f"{len(rows)} quarantined row(s)", err=True)


@cli.command("quarantine-purge")
@click.option("--task", default=None, help="hex task id filter")
@click.option("--stage", default=None, help="stage filter")
@click.option("--config-file", type=click.Path(exists=True), default=None)
@click.confirmation_option(
    prompt="Purge matching quarantined rows? The offender record is the only "
    "trace of what was dropped."
)
def quarantine_purge(task, stage, config_file):
    """Purge quarantined rows after investigation."""
    from ..core.time import RealClock
    from ..datastore import Crypter, Datastore
    from .config import AggregatorConfig, datastore_keys_from_env, load_config

    cfg = load_config(AggregatorConfig, config_file)
    ds = Datastore(
        cfg.common.database.path, Crypter(datastore_keys_from_env()), RealClock()
    )
    purged = ds.run_tx(
        "quarantine_purge",
        lambda tx: tx.purge_quarantined_reports(task=task, stage=stage),
    )
    click.echo(f"purged {purged} quarantined row(s)")


def _fetch_statusz(replica: str, timeout_s: float) -> dict:
    """GET one replica's /statusz (stdlib only — the ops CLI must work on
    a box with nothing but the repo)."""
    import urllib.request

    url = replica.rstrip("/") + "/statusz"
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def _fmt_ms(seconds) -> str:
    return f"{seconds * 1e3:.1f}ms" if seconds is not None else "-"


@cli.command("canary-status")
@click.argument("replica", required=False, default=None)
@click.option(
    "--replicas",
    default=None,
    help="comma-separated health addresses (host:port) to query",
)
@click.option("--timeout", "timeout_s", type=float, default=5.0)
def canary_status(replica, replicas, timeout_s):
    """Fetch + pretty-print the /statusz canary section:
    verdict, per-stage p50/p99, last-good time per replica.  Exits
    non-zero when any replica's rolled-up verdict is "failing".  (The
    port's replicas run no prober yet and report "canary disabled".)"""
    import time as _time

    targets = []
    if replica:
        targets.append(replica)
    if replicas:
        targets.extend(r.strip() for r in replicas.split(",") if r.strip())
    if not targets:
        raise click.ClickException("give a replica address or --replicas")

    failing = False
    for target in targets:
        try:
            doc = _fetch_statusz(target, timeout_s)
        except Exception as e:
            click.echo(f"{target}: UNREACHABLE ({e})")
            failing = True
            continue
        canary = doc.get("canary") or {}
        if not canary.get("enabled"):
            click.echo(f"{target}: canary disabled")
            continue
        verdict = canary.get("verdict", "unknown")
        failing = failing or verdict == "failing"
        click.echo(f"{target}: verdict={verdict}")
        for name, fam in sorted((canary.get("families") or {}).items()):
            last_good = fam.get("last_good_unix")
            ago = (
                f"{max(0.0, _time.time() - last_good):.0f}s ago"
                if last_good
                else "never"
            )
            line = (
                f"  {name:<18} {fam.get('verdict', '?'):<9}"
                f" probes={fam.get('probes', 0)}"
                f" suppressed={fam.get('suppressed', 0)}"
                f" last_good={ago}"
            )
            if fam.get("failing_stage"):
                line += f" failing_stage={fam['failing_stage']}"
            if fam.get("last_outcome") and fam["last_outcome"] != "ok":
                line += f" last_outcome={fam['last_outcome']}"
            click.echo(line)
        for stage, pcts in sorted((canary.get("stage_latency_s") or {}).items()):
            if pcts.get("samples"):
                click.echo(
                    f"  stage {stage:<14} p50={_fmt_ms(pcts.get('p50'))}"
                    f" p99={_fmt_ms(pcts.get('p99'))}"
                    f" n={pcts['samples']}"
                )
    if failing:
        sys.exit(1)


@cli.command("dap-decode")
@click.argument("message_file", type=click.Path(exists=True))
@click.option(
    "--media-type",
    required=True,
    help="DAP media type, e.g. application/dap-report",
)
@click.option(
    "--query-type",
    type=click.Choice(["TimeInterval", "FixedSize"]),
    default="TimeInterval",
)
def dap_decode(message_file: str, media_type: str, query_type: str):
    """Decode a DAP wire message to a readable repr
    (reference: tools/src/bin/dap_decode.rs:15)."""
    from .. import messages as m

    by_media = {
        "application/dap-hpke-config": m.HpkeConfig,
        "application/dap-hpke-config-list": m.HpkeConfigList,
        "application/dap-report": m.Report,
        "application/dap-aggregation-job-init-req": m.AggregationJobInitializeReq,
        "application/dap-aggregation-job-continue-req": m.AggregationJobContinueReq,
        "application/dap-aggregation-job-resp": m.AggregationJobResp,
        "application/dap-collect-req": m.CollectionReq,
        "application/dap-collection": m.Collection,
        "application/dap-aggregate-share-req": m.AggregateShareReq,
        "application/dap-aggregate-share": m.AggregateShare,
    }
    cls = by_media.get(media_type)
    if cls is None:
        raise click.ClickException(f"unknown media type {media_type}")
    with open(message_file, "rb") as f:
        data = f.read()
    qt = m.TimeInterval if query_type == "TimeInterval" else m.FixedSize
    try:
        msg = cls.get_decoded(data, qt)
    except TypeError:
        msg = cls.get_decoded(data)
    click.echo(repr(msg))


@cli.command("collect")
@click.option("--task-id", required=True, help="b64url task id")
@click.option("--leader", required=True, help="leader endpoint URL")
@click.option("--vdaf", "vdaf_json", required=True, help="VDAF instance JSON")
@click.option("--auth-token", required=True, help="collector bearer token")
@click.option("--hpke-config", required=True, help="b64url collector HpkeConfig")
@click.option("--hpke-private-key", required=True, help="b64url private key")
@click.option("--batch-interval-start", type=int, default=None)
@click.option("--batch-interval-duration", type=int, default=None)
@click.option("--current-batch", is_flag=True, default=False)
def collect(
    task_id,
    leader,
    vdaf_json,
    auth_token,
    hpke_config,
    hpke_private_key,
    batch_interval_start,
    batch_interval_duration,
    current_batch,
):
    """Collector front-end (reference: tools collect CLI, 1,604 LoC)."""
    import asyncio

    from ..collector import Collector
    from ..core.auth_tokens import AuthenticationToken
    from ..core.hpke import HpkeKeypair
    from ..messages import (
        Duration,
        FixedSizeQuery,
        HpkeConfig,
        Interval,
        Query,
        TaskId,
        Time,
    )
    from ..vdaf.instances import vdaf_from_instance

    vdaf = vdaf_from_instance(json.loads(vdaf_json))
    collector = Collector(
        task_id=TaskId(_unb64u(task_id)),
        leader_endpoint=leader,
        vdaf=vdaf,
        auth_token=AuthenticationToken.new_bearer(auth_token),
        hpke_keypair=HpkeKeypair(
            HpkeConfig.get_decoded(_unb64u(hpke_config)), _unb64u(hpke_private_key)
        ),
    )
    if current_batch:
        query = Query.new_fixed_size(FixedSizeQuery.current_batch())
    else:
        if batch_interval_start is None or batch_interval_duration is None:
            raise click.ClickException(
                "either --current-batch or --batch-interval-start/duration required"
            )
        query = Query.new_time_interval(
            Interval(Time(batch_interval_start), Duration(batch_interval_duration))
        )
    result = asyncio.run(collector.collect(query))
    click.echo(
        json.dumps(
            {
                "report_count": result.report_count,
                "interval_start": result.interval.start.seconds,
                "interval_duration": result.interval.duration.seconds,
                "aggregate_result": result.aggregate_result,
            }
        )
    )


if __name__ == "__main__":
    cli()
