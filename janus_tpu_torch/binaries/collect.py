"""`collect` — command-line DAP collector front-end.

Copy of ``janus_tpu/binaries/collect.py`` for the PyTorch port.  The
analog of the reference's collect tool (reference:
tools/src/bin/collect.rs:295-720): given task parameters, VDAF parameters,
collector credentials, and a query, it creates a collection job against the
leader, polls it, HPKE-opens both aggregate shares, unshards, and prints the
aggregate.  Subcommands mirror the reference:

* (default / ``run``)  create a new collection job and poll to completion
* ``init``             create the job only; prints the collection job id
* ``poll``             poll an existing job once; exit 75 (EX_TEMPFAIL) if
                       it is not finished yet — the query options must match
                       the ones used at init so state can be reconstructed.
"""

from __future__ import annotations

import asyncio
import base64
import json
import sys

import click

EX_TEMPFAIL = 75


def _b64u_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def _build_vdaf(vdaf: str, length, bits, chunk_length):
    from ..vdaf.instances import vdaf_from_instance

    desc = {"type": {
        "count": "Prio3Count",
        "sum": "Prio3Sum",
        "sumvec": "Prio3SumVec",
        "histogram": "Prio3Histogram",
    }[vdaf]}
    if vdaf == "sum":
        if bits is None:
            raise click.UsageError("--bits is required for --vdaf=sum")
        desc["bits"] = bits
    elif vdaf == "sumvec":
        if length is None or bits is None:
            raise click.UsageError("--length and --bits are required for --vdaf=sumvec")
        desc.update(length=length, bits=bits, chunk_length=chunk_length or length)
    elif vdaf == "histogram":
        if length is None:
            raise click.UsageError("--length is required for --vdaf=histogram")
        desc.update(length=length, chunk_length=chunk_length or max(1, length // 2))
    return vdaf_from_instance(desc)


def _build_query(batch_interval_start, batch_interval_duration, batch_id, current_batch):
    from ..messages import BatchId, Duration, FixedSizeQuery, Interval, Query, Time

    given = [
        batch_interval_start is not None or batch_interval_duration is not None,
        batch_id is not None,
        current_batch,
    ]
    if sum(given) != 1:
        raise click.UsageError(
            "exactly one of (--batch-interval-start + --batch-interval-duration), "
            "--batch-id, or --current-batch must be given"
        )
    if batch_id is not None:
        return Query.new_fixed_size(FixedSizeQuery.by_batch_id(BatchId(_b64u_decode(batch_id))))
    if current_batch:
        return Query.new_fixed_size(FixedSizeQuery.current_batch())
    if batch_interval_start is None or batch_interval_duration is None:
        raise click.UsageError(
            "--batch-interval-start and --batch-interval-duration go together"
        )
    return Query.new_time_interval(
        Interval(Time(batch_interval_start), Duration(batch_interval_duration))
    )


def _collector(task_id, leader, auth, vdaf_obj, hpke_config, hpke_private_key):
    from ..collector import Collector
    from ..core.hpke import HpkeKeypair
    from ..messages import HpkeConfig, TaskId

    config = HpkeConfig.get_decoded(_b64u_decode(hpke_config))
    return Collector(
        task_id=TaskId(_b64u_decode(task_id)),
        leader_endpoint=leader,
        vdaf=vdaf_obj,
        auth_token=auth,
        hpke_keypair=HpkeKeypair(config, _b64u_decode(hpke_private_key)),
    )


def _print_result(result) -> None:
    payload = {
        "report_count": result.report_count,
        "aggregate_result": result.aggregate_result,
    }
    if result.interval is not None:
        payload["interval_start"] = result.interval.start.seconds
        payload["interval_duration"] = result.interval.duration.seconds
    pbs = getattr(result.partial_batch_selector, "batch_identifier", None)
    if pbs is not None:
        payload["batch_id"] = base64.urlsafe_b64encode(pbs.data).rstrip(b"=").decode()
    click.echo(json.dumps(payload))


_shared_options = [
    click.option("--task-id", required=True, help="DAP task id, unpadded base64url"),
    click.option("--leader", required=True, help="leader aggregator endpoint URL"),
    click.option(
        "--vdaf",
        type=click.Choice(["count", "sum", "sumvec", "histogram"]),
        required=True,
    ),
    click.option("--length", type=int, default=None, help="vector length / histogram buckets"),
    click.option("--bits", type=int, default=None, help="measurement bit width (sum/sumvec)"),
    click.option("--chunk-length", type=int, default=None),
    click.option("--dap-auth-token", default=None, help="DAP-Auth-Token header value"),
    click.option(
        "--authorization-bearer-token", default=None, help="Authorization: Bearer token"
    ),
    click.option("--batch-interval-start", type=int, default=None),
    click.option("--batch-interval-duration", type=int, default=None),
    click.option("--batch-id", default=None, help="fixed-size batch id, base64url"),
    click.option("--current-batch", is_flag=True, default=False),
    click.option("--hpke-config", required=True, help="HpkeConfig message, base64url"),
    click.option("--hpke-private-key", required=True, help="collector private key, base64url"),
]


def _with_shared(f):
    for opt in reversed(_shared_options):
        f = opt(f)
    return f


def _auth(dap_auth_token, authorization_bearer_token):
    from ..core.auth_tokens import AuthenticationToken

    if (dap_auth_token is None) == (authorization_bearer_token is None):
        raise click.UsageError(
            "exactly one of --dap-auth-token / --authorization-bearer-token required"
        )
    if dap_auth_token is not None:
        return AuthenticationToken.new_dap_auth(dap_auth_token)
    return AuthenticationToken.new_bearer(authorization_bearer_token)


@click.group(invoke_without_command=True)
@click.pass_context
@_with_shared
def collect(ctx, **kwargs):
    """Create a collection job and poll it to completion (default)."""
    ctx.ensure_object(dict)
    ctx.obj.update(kwargs)
    if ctx.invoked_subcommand is None:
        ctx.invoke(run)


def _setup(o):
    vdaf_obj = _build_vdaf(o["vdaf"], o["length"], o["bits"], o["chunk_length"])
    query = _build_query(
        o["batch_interval_start"],
        o["batch_interval_duration"],
        o["batch_id"],
        o["current_batch"],
    )
    auth = _auth(o["dap_auth_token"], o["authorization_bearer_token"])
    coll = _collector(
        o["task_id"], o["leader"], auth, vdaf_obj, o["hpke_config"], o["hpke_private_key"]
    )
    return coll, query


@collect.command()
@click.pass_context
def run(ctx):
    """Create a new collection job and poll it to completion."""
    coll, query = _setup(ctx.obj)
    result = asyncio.run(coll.collect(query))
    _print_result(result)


@collect.command()
@click.option("--collection-job-id", default=None, help="b64url 16 bytes; random if absent")
@click.pass_context
def init(ctx, collection_job_id):
    """Initialize a collection job; prints its id."""
    from ..messages import CollectionJobId

    coll, query = _setup(ctx.obj)
    job_id = (
        CollectionJobId(_b64u_decode(collection_job_id))
        if collection_job_id
        else CollectionJobId.random()
    )

    async def go():
        import aiohttp

        async with aiohttp.ClientSession() as session:
            await coll.create_job(query, job_id, session=session)

    asyncio.run(go())
    click.echo(base64.urlsafe_b64encode(job_id.data).rstrip(b"=").decode())


@collect.command()
@click.option("--collection-job-id", required=True, help="b64url 16 bytes")
@click.pass_context
def poll(ctx, collection_job_id):
    """Poll an existing collection job once; exit 75 while it runs."""
    from ..messages import CollectionJobId

    coll, query = _setup(ctx.obj)
    job_id = CollectionJobId(_b64u_decode(collection_job_id))

    async def go():
        import aiohttp

        async with aiohttp.ClientSession() as session:
            result, _retry = await coll.poll_once(query, job_id, session=session)
            return result

    result = asyncio.run(go())
    if result is None:
        sys.exit(EX_TEMPFAIL)
    _print_result(result)


if __name__ == "__main__":
    collect(obj={})
