"""Multi-call binary entry point.

Copy of ``janus_tpu/binaries/main.py`` for the PyTorch port.  The analog
of the reference's single multi-call binary (reference:
aggregator/src/main.rs:93, binary_utils.rs:249 janus_main): one entry
dispatches by subcommand to the four long-running daemons, the canary
prober, the interop test API binaries and the ops CLIs:

    python -m janus_tpu_torch.binaries aggregator --config-file cfg.yaml
    python -m janus_tpu_torch.binaries aggregation_job_creator ...
    python -m janus_tpu_torch.binaries aggregation_job_driver ...
    python -m janus_tpu_torch.binaries collection_job_driver ...
    python -m janus_tpu_torch.binaries canary --config-file canary.yaml
    python -m janus_tpu_torch.binaries janus_interop_{client,aggregator,collector} --port P
    python -m janus_tpu_torch.binaries janus_cli <subcommand> ...
    python -m janus_tpu_torch.binaries collect <subcommand> ...

Bootstrap per binary: config load → logging → datastore (keys from env) →
SIGTERM-driven graceful stop → healthz server → main loop
(reference: binary_utils.rs:249-518).  The port has no process-wide
executor: a binary whose ``device_executor`` is enabled builds one
``DeviceExecutor`` and hands it to every driver and aggregator config it
builds (and to ``/statusz``).  A binary that prepares with
``vdaf_backend: cuda`` (or ``mesh``: every card of the process) checks its
device at startup: with no card it fails with the backend's ``VdafError``
and never serves on the oracle (the interop aggregator reads its backend
and device from the environment: ``interop.py``).
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys
from typing import Optional

from ..core.time import RealClock
from ..datastore import Crypter, Datastore
from ..messages import Duration
from .config import (
    AggregatorConfig,
    CanaryBinaryConfig,
    ConfigError,
    JobCreatorConfig,
    JobDriverBinaryConfig,
    datastore_keys_from_env,
    load_config,
    parse_listen_address,
    redact_database_url,
)

logger = logging.getLogger("janus_tpu_torch.binaries")


def _bootstrap(config_common):
    from ..core.trace import (
        TraceConfiguration,
        configure_chrome_trace,
        install_trace_subscriber,
        start_profiler_server,
    )

    install_trace_subscriber(TraceConfiguration(level=config_common.log_level))
    # Per-task cost-attribution cardinality cap: applied once
    # here, like the peer-health thresholds — the model is process-wide.
    from ..core.costs import configure_cost_attribution

    configure_cost_attribution(
        getattr(config_common, "cost_task_cardinality", 64)
    )
    # Datastore health tracker thresholds: process-wide like
    # the peer tracker — every binary's run_tx feeds the same verdict.
    db_cfg = getattr(config_common, "db_health", None)
    if db_cfg is not None:
        from ..core.db_health import tracker as db_tracker

        db_tracker().configure(
            failure_threshold=db_cfg.failure_threshold,
            suspect_dwell_s=db_cfg.suspect_dwell_s,
        )
    fault_cfg = getattr(config_common, "fault_injection", None)
    if fault_cfg is not None and fault_cfg.enabled:
        # Chaos mode: arm the deterministic fault registry.  Loud on
        # purpose — a production replica must never run armed silently.
        fault_cfg.install()
        logger.warning(
            "FAULT INJECTION ARMED (seed=%d, points=%s) — this replica "
            "will deliberately fail",
            fault_cfg.seed,
            sorted(fault_cfg.points),
        )
    if getattr(config_common, "chrome_trace_path", ""):
        configure_chrome_trace(config_common.chrome_trace_path)
        logger.info("chrome trace -> %s", config_common.chrome_trace_path)
    if getattr(config_common, "otlp_endpoint", ""):
        # OTLP export: import-gated on the opentelemetry-sdk —
        # a config naming a collector must start cleanly on an SDK-less
        # host, with /statusz saying exactly why nothing is exported.
        from ..core.otlp import configure_otlp

        exporter = configure_otlp(config_common.otlp_endpoint)
        if exporter is not None and exporter.available:
            logger.info("otlp export -> %s", config_common.otlp_endpoint)
        else:
            logger.warning(
                "otlp export -> %s UNAVAILABLE (opentelemetry-sdk not "
                "installed); exporter is inert",
                config_common.otlp_endpoint,
            )
    if getattr(config_common, "slos", None):
        # SLO evaluation plane: declarative targets, evaluated
        # on the status-sampler tick.  Config typos fail startup loudly.
        from ..core.slo import configure_slos

        evaluator = configure_slos(config_common.slos)
        logger.info(
            "slo evaluator armed: %s",
            ", ".join(t.name for t in evaluator.targets),
        )
    if getattr(config_common, "profiler_port", 0):
        if start_profiler_server(config_common.profiler_port):
            logger.info("torch profiler server on :%d", config_common.profiler_port)
    if getattr(config_common, "compile_cache_dir", ""):
        # Fleet-wide shared build root: a restarted replica loads its
        # CUDA kernels and host XOF instead of re-running the compilers
        # (libraries are named by a hash of their source and renamed into
        # place, so replicas and versions can share the root).
        from .. import _build

        _build.set_build_dir(config_common.compile_cache_dir)
        logger.info("kernel build root -> %s", config_common.compile_cache_dir)
    clock = RealClock()
    if fault_cfg is not None and fault_cfg.enabled:
        # clock-skew failure domain: armed replicas see a drifting clock
        # wherever the registry's clock.skew point fires (no-op otherwise)
        from ..core.faults import SkewedClock

        clock = SkewedClock(clock)
    crypter = Crypter(datastore_keys_from_env())
    logger.info("datastore: %s", redact_database_url(config_common.database.path))
    datastore = Datastore(
        config_common.database.path,
        crypter,
        clock,
        max_transaction_retries=config_common.max_transaction_retries,
    )
    return clock, datastore


def _check_vdaf_device(vdaf_backend: str, vdaf_device: Optional[str]) -> None:
    """Startup check of a binary that prepares: the ``cuda`` backend's
    device, and every card of a ``mesh`` backend, must exist
    (``make_backend`` raises ``VdafError`` with no card; a mesh builds its
    prepare's constants on each of its cards), so a misplaced replica fails
    now instead of refusing every job."""
    if vdaf_backend not in ("cuda", "mesh"):
        return
    from ..vdaf.backend import make_backend
    from ..vdaf.instances import vdaf_from_instance

    make_backend(vdaf_from_instance({"type": "Prio3Count"}), vdaf_backend, device=vdaf_device)


def _build_executor(device_executor):
    """The binary's device executor (None when the block is disabled)."""
    if not device_executor.enabled:
        return None
    from ..executor import DeviceExecutor

    return DeviceExecutor(device_executor.to_executor_config())


def _registry_warmup(datastore, resolve, what: str) -> None:
    """Walk the task registry and resolve every task's backend through the
    executor, which queues each new shape's warmup (kernel build and one
    launch a side) on its warmup thread, so the first job at peak traffic
    pays neither.  Per-task containment: one bad VDAF logs and the other
    tasks still warm."""
    from ..core.fleet import fleet_router

    def _owned_tasks(tx):
        tasks = tx.get_aggregator_tasks()
        r = fleet_router()
        # cache affinity: only warm OWNED tasks' shapes, so each
        # replica's compile_stats stays scoped to its share of the fleet
        return tasks if r is None else r.filter_owned(tx, tasks)

    try:
        tasks = datastore.run_tx("warmup_tasks", _owned_tasks)
    except Exception:
        logger.exception("warmup task-registry walk failed (serving cold)")
        return
    resolved = 0
    for task in tasks:
        try:
            resolve(task)
            resolved += 1
        except Exception:
            logger.exception("executor warmup failed for task %s (it serves cold)", task.task_id)
    if tasks:
        logger.info("%s executor warmup resolved %d/%d task(s)", what, resolved, len(tasks))


def _stop_event_on_signals(loop) -> asyncio.Event:
    """SIGTERM/SIGINT → graceful stop (reference: binary_utils.rs:458)."""
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    return stop


async def _serve_health(listen_address: str, datastore: Optional[Datastore] = None, executor=None):
    """Health + zpages server: /healthz, /metrics, PUT /traceconfigz, and
    the GET /statusz introspection plane (reference: binary_utils.rs:398-456
    + the reference's zpages; core/statusz.py builds the snapshot)."""
    from aiohttp import web

    from ..core.metrics import GLOBAL_METRICS
    from ..core.statusz import statusz_snapshot
    from ..core.trace import reload_trace_filter

    async def healthz(_):
        return web.Response(text="ok")

    async def metrics(_):
        return web.Response(body=GLOBAL_METRICS.export(), content_type="text/plain")

    async def traceconfigz(request):
        level = (await request.text()).strip()
        reload_trace_filter(level)
        return web.Response(text=f"log level set to {level}\n")

    async def statusz(_):
        return web.json_response(await statusz_snapshot(datastore, executor=executor))

    app = web.Application()
    app.add_routes(
        [
            web.get("/healthz", healthz),
            web.get("/metrics", metrics),
            web.put("/traceconfigz", traceconfigz),
            web.get("/statusz", statusz),
        ]
    )
    runner = web.AppRunner(app)
    await runner.setup()
    host, port = parse_listen_address(listen_address)
    site = web.TCPSite(runner, host, port)
    await site.start()
    return runner


def _start_fleet_heartbeat(stop: asyncio.Event, datastore: Datastore, common):
    """Fleet heartbeat loop (core/fleet.py): refreshes this replica's
    member row on the configured cadence, republishing the peer-health
    tracker's current SUSPECT origins as the fleet-shared suspect set,
    and deregisters gracefully on shutdown so survivors re-route without
    waiting out the TTL.  Returns the task (or None when fleet is off)."""
    from ..core.fleet import fleet_router

    router = fleet_router()
    if router is None:
        return None
    interval = max(0.1, float(getattr(common.fleet, "heartbeat_interval_s", 2.0)))

    async def loop_():
        from ..core import peer_health

        consecutive_failures = 0
        while not stop.is_set():
            try:
                suspects = [
                    origin
                    for origin, s in peer_health.tracker().stats().items()
                    if s.get("state") == "suspect"
                ]
                # short per-beat deadline: a browned-out datastore must
                # not pin this beat through the full tx retry budget —
                # better to skip the beat and keep the loop's cadence
                await datastore.run_tx_async(
                    "fleet_heartbeat",
                    lambda tx: router.heartbeat(tx, suspects),
                    deadline_s=max(interval, 2.0),
                )
                consecutive_failures = 0
            except Exception:
                # A missed beat only ages our row (the TTL absorbs it) —
                # NEVER crash the binary over it.  Capped backoff: a
                # sustained brownout stretches the cadence instead of
                # hammering a struggling database with registration
                # writes; first failure logs the traceback, repeats stay
                # one line.
                consecutive_failures += 1
                if consecutive_failures == 1:
                    logger.exception("fleet heartbeat failed")
                else:
                    logger.warning(
                        "fleet heartbeat failed (%d consecutive; backing off)",
                        consecutive_failures,
                    )
            delay = min(interval * (2 ** min(consecutive_failures, 4)), 30.0)
            try:
                await asyncio.wait_for(stop.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass
        try:
            await datastore.run_tx_async("fleet_deregister", router.deregister)
        except Exception:
            logger.exception("fleet deregistration failed (TTL will expire us)")

    return asyncio.ensure_future(loop_())


def _start_status_sampler(stop: asyncio.Event, datastore: Datastore, common, executor=None):
    """The small sampler loop every binary runs beside its main loop:
    publishes acquirable-backlog and journal-freshness gauges and retires
    idle buckets of ``executor`` (the binary's, if any).  Returns the task
    (or None when disabled)."""
    interval = getattr(common, "status_sample_interval_s", 0)
    if not interval or interval <= 0:
        return None

    from ..core.otlp import export_tick, otlp_exporter
    from ..core.slo import evaluate_tick
    from ..core.statusz import retire_idle_executor_buckets, sample_status_metrics

    async def loop_():
        export_fut = None
        while not stop.is_set():
            # Self-evaluation rides the same tick but NOT the
            # same failure domain: the evaluator reads only in-memory
            # registry snapshots, so it runs FIRST and in its own try —
            # a wedged datastore (the sampling below raising every tick)
            # is exactly when burn rates must keep moving.
            try:
                evaluate_tick()
            except Exception:
                logger.exception("slo evaluation tick failed")
            # OTLP export is fired WITHOUT awaiting: a slow/blackholed
            # collector (up to the exporter's timeout per POST) must not
            # stretch the sampling cadence.  At most one export is in
            # flight; a tick that finds the previous one still running
            # skips (export_once drains the whole queue each pass, so
            # nothing is lost).  Unconfigured (the default) or inert
            # (SDK absent — already logged at bootstrap, visible in
            # /statusz): no dispatch at all.
            exporter = otlp_exporter()
            if (
                exporter is not None
                and exporter.available
                and (export_fut is None or export_fut.done())
            ):
                export_fut = asyncio.get_running_loop().run_in_executor(
                    None, export_tick
                )
                export_fut.add_done_callback(
                    lambda f: f.exception()  # surfaced in otlp health; never raises past export_tick
                )
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, lambda: sample_status_metrics(datastore)
                )
                retire_idle_executor_buckets(
                    getattr(common, "executor_bucket_idle_s", 0), executor
                )
            except Exception:
                logger.exception("status sample failed")
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval)
            except asyncio.TimeoutError:
                pass
        if export_fut is not None:
            await asyncio.gather(export_fut, return_exceptions=True)

    return asyncio.ensure_future(loop_())


def _start_accumulator_maintenance(stop: asyncio.Event, stepper_impl, cfg):
    """Dedicated accumulator maintenance loop beside the aggregation
    driver's main loop: drains due deferred buckets on cadence (an idle
    task's resident delta no longer waits for another job's commit) and
    rebalances resident occupancy.  Returns the task (None when the store
    or the cadence is disabled)."""
    acc = cfg.device_executor.accumulator
    interval = getattr(acc, "maintenance_interval_s", 0)
    if not acc.enabled or not interval or interval <= 0:
        return None

    async def loop_():
        while not stop.is_set():
            try:
                await stepper_impl.run_accumulator_maintenance()
            except Exception:
                logger.exception("accumulator maintenance pass failed")
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval)
            except asyncio.TimeoutError:
                pass

    logger.info("accumulator maintenance loop every %.1fs", interval)
    return asyncio.ensure_future(loop_())


def _close_tracing() -> None:
    """Graceful-shutdown hook shared by every binary: flush/close the
    chrome tracer so a SIGTERM never truncates the trace mid-event."""
    from ..core.trace import close_chrome_trace

    try:
        close_chrome_trace()
    except Exception:
        logger.exception("chrome-trace close failed during shutdown")


# ---------------------------------------------------------------------------


def aggregator_config(cfg: AggregatorConfig, executor=None):
    """The aggregator's ``Config`` from its binary's config file."""
    from ..aggregator import Config

    return Config(
        max_upload_batch_size=cfg.max_upload_batch_size,
        max_upload_batch_write_delay=cfg.max_upload_batch_write_delay_ms / 1000.0,
        upload_open_backend=cfg.upload_open_backend,
        upload_open_batch_size=cfg.upload_open_batch_size,
        upload_open_batch_delay=cfg.upload_open_batch_delay_ms / 1000.0,
        upload_queue_max=cfg.upload_queue_max,
        upload_shed_delay_s=cfg.upload_shed_delay_s,
        ingest_mode=cfg.ingest.mode,
        ingest_journal_batch_size=cfg.ingest.journal_batch_size,
        ingest_journal_write_delay=cfg.ingest.journal_write_delay_ms / 1000.0,
        ingest_journal_queue_max=cfg.ingest.journal_queue_max,
        ingest_stage_direct=cfg.ingest.stage_direct,
        ingest_stage_max_reports=cfg.ingest.stage_max_reports,
        batch_aggregation_shard_count=cfg.batch_aggregation_shard_count,
        task_counter_shard_count=cfg.task_counter_shard_count,
        vdaf_backend=cfg.vdaf_backend,
        vdaf_device=cfg.vdaf_device,
        field_backend=cfg.field_backend,
        max_agg_param_job_size=cfg.max_agg_param_job_size,
        device_executor=executor,
    )


def aggregation_driver_config(cfg: JobDriverBinaryConfig, executor=None):
    """The aggregation-job driver's ``DriverConfig`` from its binary's
    config file."""
    from ..aggregator import DriverConfig
    from ..core.retries import HttpRetryPolicy

    return DriverConfig(
        batch_aggregation_shard_count=cfg.batch_aggregation_shard_count,
        maximum_attempts_before_failure=cfg.job_driver.maximum_attempts_before_failure,
        max_step_attempts=cfg.job_driver.max_step_attempts,
        retry_initial_delay_s=cfg.job_driver.retry_initial_delay_s,
        retry_max_delay_s=cfg.job_driver.retry_max_delay_s,
        vdaf_backend=cfg.vdaf_backend,
        vdaf_device=cfg.vdaf_device,
        field_backend=cfg.field_backend,
        device_executor=executor,
        http_retry=HttpRetryPolicy(attempt_timeout=cfg.job_driver.http_attempt_timeout_s),
    )


def run_aggregator(config_path: Optional[str]) -> None:
    """DAP HTTP server + optional GC loop
    (reference: binaries/aggregator.rs:31-150)."""
    cfg = load_config(AggregatorConfig, config_path)
    clock, datastore = _bootstrap(cfg.common)
    _check_vdaf_device(cfg.vdaf_backend, cfg.vdaf_device)
    executor = _build_executor(cfg.device_executor)

    from aiohttp import web

    from ..aggregator import Aggregator, GarbageCollector, aggregator_app

    agg = Aggregator(datastore, clock, aggregator_config(cfg, executor))

    async def main():
        loop = asyncio.get_running_loop()
        stop = _stop_event_on_signals(loop)
        health = await _serve_health(
            cfg.common.health_check_listen_address, datastore=datastore, executor=executor
        )
        app = aggregator_app(agg)
        runner = web.AppRunner(app)
        await runner.setup()
        host, port = parse_listen_address(cfg.listen_address)
        site = web.TCPSite(runner, host, port)
        await site.start()
        logger.info("aggregator serving on %s", cfg.listen_address)

        # Management REST API: task CRUD on its OWN listener,
        # never the DAP port — the canary plane provisions through this.
        task_api_runner = None
        if cfg.task_api_listen_address:
            from ..aggregator_api import aggregator_api_app

            task_api_runner = web.AppRunner(
                aggregator_api_app(datastore, cfg.task_api_auth_tokens)
            )
            await task_api_runner.setup()
            api_host, api_port = parse_listen_address(cfg.task_api_listen_address)
            await web.TCPSite(task_api_runner, api_host, api_port).start()
            logger.info("task API serving on %s", cfg.task_api_listen_address)

        async def periodic(name: str, fn, interval_s: float):
            """Run ``fn`` every interval until stop; failures log, not kill
            (the maintenance-loop shape of reference binaries/aggregator.rs)."""
            while not stop.is_set():
                try:
                    await fn()
                except Exception:
                    logger.exception("%s pass failed", name)
                try:
                    await asyncio.wait_for(stop.wait(), timeout=interval_s)
                except asyncio.TimeoutError:
                    pass

        if executor is not None and cfg.device_executor.warmup_rows:
            # the helper's shapes warm like the driver's: resolve every
            # task's backend through the executor (its warmup thread
            # builds and launches; serving starts meanwhile)
            async def resolve_all():
                for task in await datastore.run_tx_async("warmup_tasks", lambda tx: tx.get_aggregator_tasks()):
                    try:
                        ta = await agg.task_aggregator_for(task.task_id)
                        if ta is not None and ta.backend is not None:
                            agg._executor_backend_for(ta)
                    except Exception:
                        logger.exception("executor warmup failed for task %s (it serves cold)", task.task_id)

            await resolve_all()

        tasks = []
        sampler = _start_status_sampler(stop, datastore, cfg.common, executor)
        if sampler is not None:
            tasks.append(sampler)
        if agg.ingest is not None:
            # Zero-copy ingest plane.  Startup replay FIRST: a
            # previous journaled incarnation's ACKed-but-unmaterialized
            # rows become client_reports rows before traffic lands, so a
            # crash between ACK and flush loses nothing.
            from ..core.ingest import replay_report_journal

            replayed = await replay_report_journal(datastore)
            if replayed:
                logger.info(
                    "report-journal replay materialized %d report(s)", replayed
                )
            # The embedded staged consumer: packs direct-staged cohorts
            # into aggregation jobs without the creator's read-back
            # round-trip.  Sizing mirrors the standalone creator's knobs.
            from ..aggregator import AggregationJobCreator, CreatorConfig

            staged_creator = AggregationJobCreator(
                datastore,
                CreatorConfig(
                    min_aggregation_job_size=cfg.ingest.staged_min_job_size,
                    max_aggregation_job_size=cfg.ingest.staged_max_job_size,
                    batch_aggregation_shard_count=cfg.batch_aggregation_shard_count,
                ),
            )

            async def staged_pass():
                await staged_creator.run_staged_once(agg.ingest)

            tasks.append(
                asyncio.ensure_future(
                    periodic(
                        "staged consumer",
                        staged_pass,
                        max(0.01, cfg.ingest.staged_consume_interval_ms / 1000.0),
                    )
                )
            )

            async def materialize_pass():
                await agg.ingest.materialize_once(cfg.ingest.materialize_batch_size)

            tasks.append(
                asyncio.ensure_future(
                    periodic(
                        "ingest materializer",
                        materialize_pass,
                        max(0.01, cfg.ingest.materialize_interval_ms / 1000.0),
                    )
                )
            )
        if cfg.garbage_collection_interval_s:
            gc = GarbageCollector(datastore)
            tasks.append(
                asyncio.ensure_future(
                    periodic("GC", gc.run_once, cfg.garbage_collection_interval_s)
                )
            )
        if cfg.key_rotator_interval_s:
            from ..aggregator.key_rotator import HpkeKeyRotator, KeyRotatorConfig

            rotator = HpkeKeyRotator(
                datastore,
                KeyRotatorConfig(
                    pending_duration=Duration(cfg.key_rotator_pending_duration_s),
                    active_duration=Duration(cfg.key_rotator_active_duration_s),
                    expired_duration=Duration(cfg.key_rotator_expired_duration_s),
                ),
            )
            tasks.append(
                asyncio.ensure_future(
                    periodic("key rotator", rotator.run, cfg.key_rotator_interval_s)
                )
            )
        await stop.wait()
        for t in tasks:
            t.cancel()
        await agg.shutdown()
        if agg.ingest is not None:
            # flush queued journal writes, then fold the journal backlog
            # into client_reports; anything left is crash-replay's job
            await agg.ingest.drain()
        if executor is not None:
            # This binary owns its executor: flush pending mega-batches,
            # then spill any resident accumulator state before teardown
            # (graceful path; crashes take discard+replay).
            try:
                await executor.drain()
            except Exception:
                logger.exception("executor drain failed during shutdown")
            executor.shutdown(drain=True)
        if task_api_runner is not None:
            await task_api_runner.cleanup()
        await runner.cleanup()
        await health.cleanup()
        _close_tracing()

    asyncio.run(main())


def run_canary(config_path: Optional[str]) -> None:
    """The canary plane's prober (core/canary.py): continuous
    black-box end-to-end probes against a live fleet.  Deliberately
    datastore-free — the canary judges the fleet exactly the way a
    client + collector pair would, through the front doors only."""
    cfg = load_config(CanaryBinaryConfig, config_path)

    from ..core.trace import TraceConfiguration, install_trace_subscriber

    install_trace_subscriber(TraceConfiguration(level=cfg.common.log_level))
    if getattr(cfg.common, "slos", None):
        from ..core.slo import configure_slos

        evaluator = configure_slos(cfg.common.slos)
        logger.info(
            "slo evaluator armed: %s",
            ", ".join(t.name for t in evaluator.targets),
        )
    from ..core.canary import configure_canary

    plane = configure_canary(cfg.canary)

    async def main():
        import aiohttp

        from ..core.slo import evaluate_tick

        loop = asyncio.get_running_loop()
        stop = _stop_event_on_signals(loop)
        health = await _serve_health(cfg.common.health_check_listen_address)
        logger.info(
            "canary probing %s every %.1fs (families: %s)",
            cfg.canary.leader_endpoint,
            cfg.canary.probe_interval_s,
            ", ".join(cfg.canary.families),
        )
        session = aiohttp.ClientSession()
        try:
            while not stop.is_set():
                # provisioning retries inside the cycle: a fleet that is
                # still coming up just delays the first verdict
                try:
                    await plane.ensure_provisioned(session)
                    await plane.probe_once(session)
                except Exception:
                    logger.exception("canary probe cycle failed")
                try:
                    evaluate_tick()
                except Exception:
                    logger.exception("slo evaluation tick failed")
                try:
                    await asyncio.wait_for(
                        stop.wait(), timeout=max(0.1, cfg.canary.probe_interval_s)
                    )
                except asyncio.TimeoutError:
                    pass
        finally:
            await session.close()
        await health.cleanup()
        _close_tracing()

    asyncio.run(main())


def run_aggregation_job_creator(config_path: Optional[str]) -> None:
    """reference: binaries/aggregation_job_creator.rs"""
    cfg = load_config(JobCreatorConfig, config_path)
    clock, datastore = _bootstrap(cfg.common)

    from ..aggregator import AggregationJobCreator, CreatorConfig

    creator = AggregationJobCreator(
        datastore,
        CreatorConfig(
            min_aggregation_job_size=cfg.min_aggregation_job_size,
            max_aggregation_job_size=cfg.max_aggregation_job_size,
            batch_aggregation_shard_count=cfg.batch_aggregation_shard_count,
            journal_replay_min_age_s=cfg.journal_replay_min_age_s,
        ),
    )

    async def main():
        loop = asyncio.get_running_loop()
        stop = _stop_event_on_signals(loop)
        health = await _serve_health(
            cfg.common.health_check_listen_address, datastore=datastore
        )
        sampler = _start_status_sampler(stop, datastore, cfg.common)
        while not stop.is_set():
            try:
                n = await creator.run_once()
                if n:
                    logger.info("created %d aggregation jobs", n)
            except Exception:
                logger.exception("creation pass failed")
            try:
                await asyncio.wait_for(
                    stop.wait(), timeout=cfg.aggregation_job_creation_interval_s
                )
            except asyncio.TimeoutError:
                pass
        if sampler is not None:
            await asyncio.gather(sampler, return_exceptions=True)
        await health.cleanup()
        _close_tracing()

    asyncio.run(main())


def _run_job_driver_binary(config_path: Optional[str], kind: str) -> None:
    """Shared wiring for the two lease-driven drivers
    (reference: binaries/aggregation_job_driver.rs:12-66)."""
    cfg = load_config(JobDriverBinaryConfig, config_path)
    clock, datastore = _bootstrap(cfg.common)
    executor = None
    if kind == "aggregation":
        _check_vdaf_device(cfg.vdaf_backend, cfg.vdaf_device)
        executor = _build_executor(cfg.device_executor)

    # Peer-health gating thresholds are applied ONCE here (the tracker
    # is process-wide; driver constructors deliberately don't touch it).
    from ..core import peer_health

    peer_health.tracker().configure(
        failure_threshold=cfg.job_driver.peer_failure_threshold,
        suspect_dwell_s=cfg.job_driver.peer_suspect_dwell_s,
    )

    # Fleet control plane (core/fleet.py): register this replica in the
    # per-role rendezvous domain BEFORE anything computes ownership — the
    # warmup walk below must already see this member, or it would warm
    # zero tasks (2-member view without self) on a cold fleet.
    if cfg.common.fleet.enabled:
        from ..core.fleet import configure_fleet, default_replica_id

        fc = cfg.common.fleet
        router = configure_fleet(
            fc.replica_id or default_replica_id(),
            kind,
            heartbeat_ttl_s=fc.heartbeat_ttl_s,
            takeover_grace_s=fc.takeover_grace_s,
            suspect_staleness_s=fc.suspect_staleness_s,
            mass_staleness_fraction=fc.mass_staleness_fraction,
        )
        datastore.run_tx("fleet_register", router.heartbeat)
        logger.info(
            "fleet member %s registered (role=%s, ttl=%.1fs)",
            router.replica_id,
            kind,
            fc.heartbeat_ttl_s,
        )

    import aiohttp

    from ..aggregator import (
        AggregationJobDriver,
        CollectionJobDriver,
        JobDriver,
    )

    if kind == "aggregation":
        stepper_impl = AggregationJobDriver(
            datastore, aiohttp.ClientSession, aggregation_driver_config(cfg, executor)
        )
        if executor is not None and cfg.device_executor.warmup_rows:
            # Registry-driven BACKGROUND warmup: resolving every task's
            # backend queues each shape's kernel build and warm launch on
            # the executor's warmup thread, so startup never blocks behind
            # nvcc; a submit for a still-warming shape waits for it.
            import threading

            def warm(task, driver=stepper_impl):
                driver._backend_for(task, task.vdaf_instance())

            threading.Thread(
                target=_registry_warmup,
                args=(datastore, warm, "aggregation job driver"),
                name="janus-warmup-registry",
                daemon=True,
            ).start()

        async def acquirer(duration, limit):
            from ..aggregator.job_driver import acquisition_exclusions

            return await datastore.run_tx_async(
                "acquire_agg",
                # suspect-peer and fleet-routed tasks filter at the query
                # (task -> peer index, same tx) instead of
                # acquire-then-release churn
                lambda tx: tx.acquire_incomplete_aggregation_jobs(
                    duration,
                    limit,
                    exclude_task_ids=acquisition_exclusions(tx, "aggregation"),
                ),
            )

        async def reaper():
            return await datastore.run_tx_async(
                "reap_agg_leases",
                lambda tx: tx.reap_expired_aggregation_job_leases(),
            )

        stepper = stepper_impl.step_aggregation_job
        job_type = "aggregation"
    else:
        from ..aggregator.collection_job_driver import CollectionDriverConfig
        from ..core.retries import HttpRetryPolicy

        stepper_impl = CollectionJobDriver(
            datastore,
            aiohttp.ClientSession,
            CollectionDriverConfig(
                maximum_attempts_before_failure=cfg.job_driver.maximum_attempts_before_failure,
                max_step_attempts=cfg.job_driver.max_step_attempts,
                batch_aggregation_shard_count=cfg.batch_aggregation_shard_count,
                # the shared retry knobs configure the FAILURE backoff; the
                # readiness-poll curve keeps its own (reference) defaults
                step_retry_initial_delay=Duration(
                    max(1, int(cfg.job_driver.retry_initial_delay_s))
                ),
                step_retry_max_delay=Duration(int(cfg.job_driver.retry_max_delay_s)),
                http_retry=HttpRetryPolicy(
                    attempt_timeout=cfg.job_driver.http_attempt_timeout_s
                ),
            ),
        )

        async def acquirer(duration, limit):
            from ..aggregator.job_driver import acquisition_exclusions

            return await datastore.run_tx_async(
                "acquire_coll",
                lambda tx: tx.acquire_incomplete_collection_jobs(
                    duration,
                    limit,
                    exclude_task_ids=acquisition_exclusions(tx, "collection"),
                ),
            )

        async def reaper():
            return await datastore.run_tx_async(
                "reap_coll_leases",
                lambda tx: tx.reap_expired_collection_job_leases(),
            )

        stepper = stepper_impl.step_collection_job
        job_type = "collection"

    driver = JobDriver(
        clock,
        acquirer,
        stepper,
        job_discovery_interval=cfg.job_driver.job_discovery_interval_s,
        max_concurrent_job_workers=cfg.job_driver.max_concurrent_job_workers,
        worker_lease_duration=Duration(cfg.job_driver.worker_lease_duration_s),
        worker_lease_clock_skew_allowance=Duration(
            cfg.job_driver.worker_lease_clock_skew_allowance_s
        ),
        reaper=reaper if cfg.job_driver.lease_reap_interval_s > 0 else None,
        lease_reap_interval=cfg.job_driver.lease_reap_interval_s,
        job_type=job_type,
    )

    async def main():
        loop = asyncio.get_running_loop()
        stop = _stop_event_on_signals(loop)
        health = await _serve_health(
            cfg.common.health_check_listen_address, datastore=datastore, executor=executor
        )
        sampler = _start_status_sampler(stop, datastore, cfg.common, executor)
        heartbeat = _start_fleet_heartbeat(stop, datastore, cfg.common)
        maintenance = (
            _start_accumulator_maintenance(stop, stepper_impl, cfg)
            if kind == "aggregation"
            else None
        )
        await driver.run(stop)
        # Graceful teardown (SIGTERM): in-flight steps have drained and
        # released their leases in-tx; now flush the executor's pending
        # mega-batches and spill committed-but-unspilled accumulator
        # deltas durably (the journal transaction), so ONLY a genuine
        # crash ever takes the discard-and-replay path.
        if maintenance is not None:
            await asyncio.gather(maintenance, return_exceptions=True)
        if kind == "aggregation":
            await stepper_impl.shutdown()
        else:
            await stepper_impl.close()
        if heartbeat is not None:
            await asyncio.gather(heartbeat, return_exceptions=True)
        if sampler is not None:
            await asyncio.gather(sampler, return_exceptions=True)
        await health.cleanup()
        _close_tracing()

    asyncio.run(main())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(
            "usage: python -m janus_tpu_torch.binaries "
            "{aggregator|aggregation_job_creator|aggregation_job_driver|"
            "collection_job_driver|canary|janus_interop_{client|aggregator|"
            "collector}|janus_cli|collect} [--config-file F] ...",
            file=sys.stderr,
        )
        return 2
    binary = argv.pop(0)
    config_path = None
    if argv[:1] == ["--config-file"]:
        config_path = argv[1]
        argv = argv[2:]
    if binary == "aggregator":
        run_aggregator(config_path)
    elif binary == "aggregation_job_creator":
        run_aggregation_job_creator(config_path)
    elif binary == "aggregation_job_driver":
        _run_job_driver_binary(config_path, "aggregation")
    elif binary == "collection_job_driver":
        _run_job_driver_binary(config_path, "collection")
    elif binary == "canary":
        run_canary(config_path)
    elif binary == "janus_cli":
        from .janus_cli import cli

        cli.main(args=argv, standalone_mode=True)
    elif binary == "collect":
        from .collect import collect

        collect.main(args=argv, standalone_mode=True, obj={})
    elif binary.startswith("janus_interop_"):
        from ..interop import run_interop_binary

        port = 8080
        for i, arg in enumerate(argv):
            if arg == "--port":
                if i + 1 >= len(argv):
                    print("--port requires a value", file=sys.stderr)
                    return 2
                port = int(argv[i + 1])
        run_interop_binary(binary[len("janus_interop_") :], port)
    else:
        print(f"unknown binary {binary!r}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
