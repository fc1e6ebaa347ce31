"""Layered configuration: YAML file + environment-variable secrets.

Copy of ``janus_tpu/binaries/config.py`` for the PyTorch port: the same
dataclasses, so a deployment's YAML loads unchanged.  The analog of the
reference's config system (reference: aggregator/src/config.rs:31-199,
binary_utils.rs:49,207-238): a ``CommonConfig`` shared by every binary
(database, health port, logging), per-binary sections with defaults, and
secrets (datastore keys, auth tokens) taken from the environment, never
the file.

What the port adds: ``vdaf_device`` (the torch device of the ``cuda``
backend; None is the card).  ``field_backend`` is ``vpu`` (the default)
or ``mxu``, the limb-digit matmul layout, as in the JAX package.
``vdaf_backend: mesh`` and ``device_executor.mesh: true`` shard each flush
over every card of the process (``MeshBackend``).  What it refuses: a key
it cannot honour raises :class:`ConfigError` with the reason, never
silently ignored — a ``distributed_coordinator`` (the multi-process mesh,
not ported yet: ROADMAP queue 1, the multi-device mesh across
processes), ``poplar_backend`` and a non-zero
``warmup_wait_s`` (options the port removed), and a ``vdaf_backend`` other
than ``cuda``, ``mesh`` or ``oracle``.  A config
file whose name ends in ``.json`` is read as JSON (a subset of YAML).
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


class ConfigError(Exception):
    pass


#: keys the port removed, with the reason a config that sets them fails
REMOVED_KEYS = {
    "poplar_backend": "poplar_backend was removed: the card walk of the IDPF tree always serves",
}

#: the port's VDAF backends (vdaf/backend.py BACKENDS)
VDAF_BACKENDS = ("cuda", "mesh", "oracle")
#: the card backends' field layouts (vdaf/backend.py FIELD_BACKENDS)
FIELD_BACKENDS = ("vpu", "mxu")


def _check_backends(vdaf_backend: str, field_backend: str) -> None:
    if vdaf_backend not in VDAF_BACKENDS:
        raise ConfigError(
            f"vdaf_backend {vdaf_backend!r} is not a backend of the port "
            f"(one of {', '.join(VDAF_BACKENDS)}; 'tpu' is the JAX package's)"
        )
    if field_backend not in FIELD_BACKENDS:
        raise ConfigError(f"unknown field_backend {field_backend!r} (one of {', '.join(FIELD_BACKENDS)})")


def redact_database_url(url: str) -> str:
    """DB location safe for logs: the DSN password is dropped
    (reference: config.rs:115-124 redacts the url in Debug output)."""
    if "://" not in url:
        return url  # SQLite file path: nothing secret
    scheme, _, rest = url.partition("://")
    authority, slash, tail = rest.partition("/")
    # Userinfo lives only in the authority (an '@' in path/query is data),
    # and only a userinfo WITH a password needs redacting.
    if "@" in authority:
        userinfo, _, host = authority.rpartition("@")
        if ":" in userinfo:
            user = userinfo.split(":", 1)[0]
            return f"{scheme}://{user}:REDACTED@{host}{slash}{tail}"
    return url


@dataclass
class DbConfig:
    """reference: config.rs:75 DbConfig"""

    path: str = "janus_tpu.sqlite3"

    def __repr__(self) -> str:
        return f"DbConfig(path={redact_database_url(self.path)!r})"


@dataclass
class FaultInjectionConfig:
    """Deterministic fault injection (core/faults.py).  DEFAULT FULLY
    OFF — when disabled nothing is sampled and every injection point is
    a single boolean check.  Enabling arms named points with per-point
    probability and mode, e.g.::

        fault_injection:
          enabled: true
          seed: 7
          points:
            datastore.tx.begin: {mode: error, probability: 0.05}
            http.request:
              - {mode: error, probability: 0.1}
              - {mode: delay, probability: 0.1, delay_s: 0.05}
            executor.flush: {mode: error, probability: 0.2}
            clock.skew: {mode: skew, probability: 0.2, skew_s: 30}

    Point names and modes are documented in core/faults.py
    (KNOWN_POINTS / MODES).
    """

    enabled: bool = False
    seed: int = 0
    #: point name -> FaultSpec kwargs (one mapping or a list of them)
    points: dict = field(default_factory=dict)

    def install(self) -> None:
        """Arm the process-wide registry (no-op when disabled)."""
        from ..core import faults

        if not self.enabled or not self.points:
            return
        specs = []
        for point, opts in self.points.items():
            for o in opts if isinstance(opts, list) else [opts]:
                specs.append(faults.FaultSpec(point=point, **dict(o)))
        faults.configure(specs, seed=self.seed)


@dataclass
class FleetConfig:
    """Fleet control plane (core/fleet.py).  DEFAULT OFF — when disabled
    no router is installed, no member row is written, and the drivers'
    acquisition filter is bit-for-bit the plain suspect filter.  Enabled,
    each driver binary registers ``replica_id`` with a heartbeat row and
    rendezvous-routes tasks across the live same-role members::

        fleet:
          enabled: true
          replica_id: agg-east-1     # empty -> hostname-pid-nonce
          heartbeat_interval_s: 2.0
          heartbeat_ttl_s: 10.0      # member liveness horizon
          takeover_grace_s: 5.0      # delay before acquiring absorbed tasks
          suspect_staleness_s: 30.0  # shared-suspect advertisement horizon

    TTL tuning: migration latency after a SIGKILL is bounded by
    ``heartbeat_ttl_s + takeover_grace_s``; the TTL must comfortably
    exceed ``heartbeat_interval_s`` (>= 3x) or routine scheduling jitter
    reads as death and causes migration storms.
    """

    enabled: bool = False
    #: Stable identity in the rendezvous domain.  Give restarts the SAME
    #: id (deployment slot name) so a bounced replica re-owns its tasks —
    #: and its built kernel libraries — instead of reshuffling the fleet.
    #: Empty = hostname-pid-nonce (unique per process start).
    replica_id: str = ""
    heartbeat_interval_s: float = 2.0
    heartbeat_ttl_s: float = 10.0
    takeover_grace_s: float = 5.0
    suspect_staleness_s: float = 30.0
    #: Migration-storm suppression: if MORE than this fraction
    #: of the previously-live same-role members (excluding self) go stale
    #: in one ownership refresh, the staleness is treated as correlated
    #: (datastore brownout) and the router freezes its last-known
    #: ownership view instead of migrating.  0.5 means "more than half
    #: vanished at once"; raise toward 1.0 to suppress only total
    #: blackouts, lower toward 0.0 to make any multi-member loss freeze.
    mass_staleness_fraction: float = 0.5


@dataclass
class DatastoreHealthConfig:
    """Datastore health tracker (core/db_health.py): the brownout
    detector fed by every run_tx retry.  Always on — the thresholds only
    shape when consecutive transient tx failures flip the process-wide
    verdict to SUSPECT (fleet freezes routing, upload front door sheds,
    janitors skip their sweeps)."""

    #: consecutive transient tx failures before SUSPECT
    failure_threshold: int = 3
    #: suspect dwell before transactions count as probes again
    suspect_dwell_s: float = 5.0


@dataclass
class CommonConfig:
    """reference: config.rs:31 CommonConfig"""

    database: DbConfig = field(default_factory=DbConfig)
    health_check_listen_address: str = "127.0.0.1:8000"
    max_transaction_retries: int = 30
    log_level: str = "INFO"
    #: Cluster membership for gang-scheduled SPMD deployments (the JAX
    #: package's jax.distributed fields).  The port's mesh spans the cards
    #: of one process; the multi-process mesh is not ported (ROADMAP queue
    #: 1, the multi-device mesh across processes): a non-empty
    #: coordinator is refused.  Cross-host scale-out is the
    #: N-stateless-replica shared-datastore model.
    distributed_coordinator: str = ""  # "host:port"; empty = no cluster
    distributed_num_processes: int = 0
    distributed_process_id: int = -1
    #: Chrome-trace (Trace Event Format) output path for job/launch spans —
    #: load in chrome://tracing or Perfetto (reference: trace.rs:145-156
    #: chrome tracing layer).  Off when empty.
    chrome_trace_path: str = ""
    #: torch.profiler capture listener (core/trace.py
    #: start_profiler_server): a GET captures N seconds of CPU and CUDA
    #: activity and returns the chrome trace (0 = off; reference analog:
    #: trace.rs:158-236 always-on tooling sockets).
    profiler_port: int = 0
    #: Deterministic fault injection across the failure domains
    #: (datastore tx, peer HTTP, executor/device launches, clock skew);
    #: fully off by default.
    fault_injection: FaultInjectionConfig = field(default_factory=FaultInjectionConfig)
    #: Status sampler cadence (core/statusz.py): publishes the sampled
    #: queue-depth/freshness gauges (acquirable jobs, outstanding journal
    #: rows + oldest age) and retires idle executor buckets.  <= 0 disables.
    status_sample_interval_s: float = 5.0
    #: Idle threshold for executor-bucket gauge retirement (cardinality
    #: cap); <= 0 keeps every bucket's series forever.
    #: The per-task cost series (janus_task_*) retire on the same tick
    #: and threshold.
    executor_bucket_idle_s: float = 600.0
    #: Per-task cost-attribution cardinality cap (core/costs.py): at most
    #: this many live ``task`` label values on the janus_task_* series;
    #: tasks beyond it attribute to task="other" until the sampler-tick
    #: retirement frees idle slots.
    cost_task_cardinality: int = 64
    #: OTLP collector endpoint (core/otlp.py), e.g.
    #: ``http://otel-collector:4318`` — when set, ChromeTracer spans and
    #: the metric registry are exported OTLP/HTTP on the status-sampler
    #: cadence.  Import-gated on the opentelemetry-sdk: without the lib
    #: the exporter is a first-class no-op and /statusz's "otlp" section
    #: says "unavailable".  Empty = no export.
    otlp_endpoint: str = ""
    #: Declarative SLO targets (core/slo.py), evaluated by the status
    #: sampler into janus_slo_burn_rate{slo,window} /
    #: janus_slo_breach_total{slo} and the /statusz "slo" section::
    #:
    #:     slos:
    #:       commit_age:     {objective: 0.99, threshold_s: 60}
    #:       collection_e2e: {objective: 0.95, threshold_s: 600}
    #:
    #: Signals: commit_age, upload_to_commit, job_age_at_acquire,
    #: collection_e2e, first_flush (or any raw janus_* histogram name via
    #: ``signal:``).  Empty = no SLO evaluation.
    slos: dict = field(default_factory=dict)
    #: Fleet-wide shared build ROOT for the port's compiled libraries (the
    #: CUDA kernels and the host XOF, _build.set_build_dir): a restarted
    #: replica loads them instead of re-running nvcc.  Every library is
    #: named by a hash of its source and flags and written by a
    #: per-process temporary name and renamed, so replicas and versions
    #: can share the root.  Empty = ``build/janus_tpu_torch`` in the
    #: checkout.
    compile_cache_dir: str = ""
    #: Fleet control plane (core/fleet.py): replica membership +
    #: rendezvous task routing for the job drivers; fully off by default.
    fleet: FleetConfig = field(default_factory=FleetConfig)
    #: Datastore health tracker thresholds (core/db_health.py); the
    #: tracker itself is always on.
    db_health: DatastoreHealthConfig = field(default_factory=DatastoreHealthConfig)

    def __post_init__(self):
        if self.distributed_coordinator:
            raise ConfigError(
                "distributed_coordinator is not supported by the port: its mesh "
                "spans the cards of one process, and the gang-scheduled "
                "multi-process mesh is not ported (ROADMAP queue 1, the "
                "multi-device mesh across processes)"
            )


@dataclass
class AccumulatorStoreConfig:
    """Device-resident accumulator store (``device_executor.accumulator.*``,
    janus_tpu_torch/executor/accumulator.py).  DEFAULT OFF — enabling keeps
    each flush's out shares resident on device and spills ONE field vector
    per batch bucket at job commit instead of reading every mega-batch
    back."""

    enabled: bool = False
    #: resident-byte cap (flush matrices + bucket buffers); LRU state
    #: spills to host mirrors beyond it.  None = the minting backend's (a
    #: quarter of the card's memory); <= 0 disables eviction.
    byte_budget: Optional[int] = None
    #: Deferred drains: 0 (default) drains every bucket at job commit;
    #: > 0 accumulates across jobs and drains buckets once they are this
    #: old.  Each contributing job persists an accumulator_journal row in
    #: its commit transaction, so a crashed replica's un-drained deltas
    #: are re-derived from the datastore by the collection-time oracle
    #: replay once a row is a few intervals old (guaranteed
    #: drain-before-collection); a younger row waits for this drain.
    drain_interval_s: float = 0.0
    #: Dedicated maintenance loop cadence (aggregation-job-driver binary):
    #: > 0 drains due deferred buckets and rebalances resident occupancy
    #: from a background loop instead of only at committing drivers'
    #: commits, so an idle task's bucket never waits for unrelated
    #: traffic.  <= 0 disables the loop (commit-driven drains only).
    maintenance_interval_s: float = 0.0

    def to_accumulator_config(self):
        from ..executor.accumulator import AccumulatorConfig

        return AccumulatorConfig(
            enabled=self.enabled,
            byte_budget=self.byte_budget,
            drain_interval_s=self.drain_interval_s,
            maintenance_interval_s=self.maintenance_interval_s,
        )


@dataclass
class DeviceExecutorConfig:
    """The binary's device executor (janus_tpu_torch/executor/):
    continuous cross-job batching of prepare.  Default OFF — the
    per-driver gather-window path stays the default; enabling builds one
    bucketed continuous batcher that owns the card, handed to every
    driver and aggregator config the binary builds."""

    enabled: bool = False
    #: Mesh-sharded mega-batches: every one-card backend the executor
    #: caches becomes a MeshBackend over the process's cards (the same as
    #: ``vdaf_backend: mesh`` on every producer)
    mesh: bool = False
    #: flush a bucket once it holds this many rows (pow2-padded launch)
    flush_max_rows: int = 16384
    #: deadline (ms) from a bucket's first pending submission to its flush
    flush_window_ms: float = 5.0
    #: per-bucket queued+in-flight row bound; beyond it submits are
    #: rejected retryably (lease redelivery provides the retry)
    max_queue_rows: int = 131072
    #: per-submission deadline; queued past it -> retryable rejection
    #: (<= 0 disables deadline rejection)
    submit_timeout_s: float = 30.0
    #: batch at which each backend builds its kernels and launches once
    #: at startup (0 = off)
    warmup_rows: int = 0
    #: run warmup on a background thread (default): backend resolution
    #: and binary startup never block behind a kernel build, and submits
    #: for a still-warming shape wait for it.  False = inline warmup.
    warmup_async: bool = True
    #: pow2 shape canonicalization (vdaf/canonical.py): key device
    #: backends by the canonical (bucket-padded) shape, so tasks of one
    #: circuit family whose lengths fall in one bucket share one backend
    #: and one flush; false keys every task by its exact shape
    canonical_shapes: bool = True
    #: consecutive launch failures per VDAF shape before its circuit
    #: opens (submits are then refused retryably; 0 disables)
    breaker_failure_threshold: int = 5
    #: open-circuit dwell before a half-open probe launch tests the device
    breaker_reset_timeout_s: float = 30.0
    #: starvation-free flush scheduling (deficit round-robin across
    #: buckets, deadline-earliest within one); False = legacy FIFO
    fair_flush: bool = True
    #: deficit-round-robin quantum in rows
    fair_quota_rows: int = 16384
    #: flight recorder ring size (per-flush black-box records kept in
    #: memory for /statusz "flights" + breaker-trip/slow-flush dumps)
    flight_recorder_size: int = 256
    #: slow-flush anomaly factor: a flush whose launch exceeds this ×
    #: its bucket's rolling p95 dumps the flight ring (rate-limited);
    #: <= 0 disables the detector
    slow_flush_p95_factor: float = 4.0
    #: device-resident accumulator store (default off)
    accumulator: AccumulatorStoreConfig = field(default_factory=AccumulatorStoreConfig)

    def to_executor_config(self):
        """Build the runtime ExecutorConfig (torch-free import path)."""
        from ..executor import ExecutorConfig

        return ExecutorConfig(
            mesh=self.mesh,
            flush_max_rows=self.flush_max_rows,
            flush_window_s=self.flush_window_ms / 1000.0,
            max_queue_rows=self.max_queue_rows,
            submit_timeout_s=self.submit_timeout_s,
            warmup_rows=self.warmup_rows,
            warmup_async=self.warmup_async,
            canonical_shapes=self.canonical_shapes,
            breaker_failure_threshold=self.breaker_failure_threshold,
            breaker_reset_timeout_s=self.breaker_reset_timeout_s,
            fair_flush=self.fair_flush,
            fair_quota_rows=self.fair_quota_rows,
            flight_recorder_size=self.flight_recorder_size,
            slow_flush_p95_factor=self.slow_flush_p95_factor,
            accumulator=self.accumulator.to_accumulator_config()
            if self.accumulator.enabled
            else None,
        )


@dataclass
class JobDriverConfig:
    """reference: config.rs:172 JobDriverConfig"""

    job_discovery_interval_s: float = 10.0
    max_concurrent_job_workers: int = 10
    worker_lease_duration_s: int = 600
    worker_lease_clock_skew_allowance_s: int = 60
    maximum_attempts_before_failure: int = 10
    #: retryable-failure budget: redeliveries (lease_attempts) a job gets
    #: before a retryable step failure abandons it
    max_step_attempts: int = 10
    #: exponential lease-backoff curve between retryable redeliveries
    retry_initial_delay_s: float = 1.0
    retry_max_delay_s: float = 300.0
    #: expired-lease reaper cadence (crash recovery): clears lease tokens
    #: whose holder died without releasing, counting each into
    #: janus_job_leases_expired_total; <= 0 disables the reaper
    lease_reap_interval_s: float = 10.0
    #: per-attempt HTTP timeout toward the peer aggregator: one hung or
    #: blackholed attempt is cut off here instead of riding aiohttp's
    #: defaults (core/retries.py attempt_timeout); <= 0 disables
    http_attempt_timeout_s: float = 30.0
    #: peer-health gating (core/peer_health.py): consecutive transport
    #: failures before the peer is SUSPECT and lease work stops being
    #: burned on it (jobs release with retryable jittered backoff that
    #: never consumes max_step_attempts); 0 disables gating
    peer_failure_threshold: int = 3
    #: suspect dwell before half-open probes flow toward the peer again
    peer_suspect_dwell_s: float = 10.0


@dataclass
class IngestConfig:
    """Zero-copy ingest plane (core/ingest.py).  Mode
    ``synchronous`` (the default) keeps the legacy write path bit-for-bit:
    every upload commits its client_reports row inline via the
    ReportWriteBatcher before the 200 is sent.  Mode ``journaled`` flips
    the front door to the write-behind report journal::

        ingest:
          mode: journaled
          journal_batch_size: 100
          journal_write_delay_ms: 50
          journal_queue_max: 2048
          stage_direct: true
          stage_max_reports: 4096
          staged_consume_interval_ms: 250
          materialize_interval_ms: 1000
          materialize_batch_size: 256

    Durability contract: an upload is ACKed only after its journal row is
    durable — write-behind defers the client_reports MATERIALIZATION (the
    aggregation-visible copy), never the ACK.  Freshly journaled reports
    are additionally staged in-process, pre-bucketed by (task, vdaf
    shape), and the embedded staged consumer packs them straight into
    aggregation jobs without the creator's read-back round-trip.
    """

    #: "synchronous" | "journaled"
    mode: str = "synchronous"
    #: journal-writer flush trigger: rows per flush tx / max delay a
    #: report waits for co-batching before its flush fires anyway
    journal_batch_size: int = 100
    journal_write_delay_ms: int = 50
    #: admission bound on queued+in-flight journal writes: past it the
    #: front door sheds 503s (janus_upload_shed_total{reason="journal"})
    #: instead of queueing unboundedly behind a slow journal writer
    journal_queue_max: int = 2048
    #: hand freshly journaled reports straight to the in-process staged
    #: consumer (false = journal only; the materializer read-back path
    #: carries everything)
    stage_direct: bool = True
    #: staged-buffer bound (reports across all cohorts); beyond it fresh
    #: reports fall back to the read-back path, never unbounded memory
    stage_max_reports: int = 4096
    #: embedded staged-consumer cadence (aggregator binary): how often
    #: staged cohorts are packed into aggregation jobs
    staged_consume_interval_ms: int = 250
    #: background materializer cadence + per-pass row bound: the
    #: write-behind half that folds journal rows into client_reports
    materialize_interval_ms: int = 1000
    materialize_batch_size: int = 256
    #: staged job sizing (mirrors JobCreatorConfig min/max): cohorts
    #: below min stay journaled for the periodic creator to fold in
    staged_min_job_size: int = 10
    staged_max_job_size: int = 256


@dataclass
class CanaryConfig:
    """The canary plane's prober (core/canary.py): black-box
    known-plaintext probes through the real upload -> aggregate ->
    collect path, one auto-provisioned task per VDAF family.

        canary:
          leader_endpoint: "http://127.0.0.1:8080"
          helper_endpoint: "http://127.0.0.1:8081"
          leader_task_api: "http://127.0.0.1:9080"
          helper_task_api: "http://127.0.0.1:9081"
          task_api_auth_token: "admin-token"
          families: [prio3_sum, prio3_histogram]
          probe_interval_s: 30
          trace_globs: ["/tmp/traces/*.trace"]
    """

    #: DAP endpoints the probes travel through (the real front doors)
    leader_endpoint: str = ""
    helper_endpoint: str = ""
    #: management APIs (aggregator task_api_listen_address) the prober
    #: provisions its canary tasks against
    leader_task_api: str = ""
    helper_task_api: str = ""
    task_api_auth_token: str = ""
    #: VDAF families to probe (each gets its own canary task); names
    #: resolve through core/canary.py FAMILIES
    families: List[str] = field(default_factory=lambda: ["prio3_sum", "prio3_histogram"])
    #: probe cadence and collection-poll budget
    probe_interval_s: float = 30.0
    poll_interval_s: float = 0.5
    collect_timeout_s: float = 60.0
    #: consecutive probe failures before a family's verdict is "failing"
    #: (one failure = "degraded")
    fail_threshold: int = 2
    #: consecutive 503-shed suppressions before the next shed counts as a
    #: loud upload failure — a front door that never reopens must page
    shed_escalate_after: int = 3
    #: canary-task time precision; each probe cycle aggregates its own
    #: already-closed bucket, walking backward so batches never overlap
    time_precision_s: int = 3600
    #: chrome-trace globs (the replicas' trace files) for per-stage
    #: commit/first-prepare attribution; empty = prober-clock stages only
    trace_globs: List[str] = field(default_factory=list)


@dataclass
class CanaryBinaryConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    canary: CanaryConfig = field(default_factory=CanaryConfig)


@dataclass
class AggregatorConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    listen_address: str = "0.0.0.0:8080"
    max_upload_batch_size: int = 100
    max_upload_batch_write_delay_ms: int = 250
    #: Upload HPKE-open backend: "batched" groups concurrent
    #: uploads' expensive opens into one vectorized AES-GCM pass on a
    #: worker thread (bit-exact vs inline, per-report fallback on any
    #: batch-level error); "inline" keeps the legacy per-report open.
    upload_open_backend: str = "batched"
    upload_open_batch_size: int = 64
    upload_open_batch_delay_ms: int = 5
    #: Front-door admission control: past this many pending opens — or
    #: once the oldest pending open has waited upload_shed_delay_s —
    #: uploads shed with the DAP-retryable 503 + Retry-After (counted in
    #: janus_upload_shed_total) instead of drowning the event loop.
    upload_queue_max: int = 1024
    upload_shed_delay_s: float = 2.0
    #: Zero-copy ingest plane: write-behind report journal +
    #: direct upload->staging handoff; mode "synchronous" is the
    #: bit-for-bit legacy default.
    ingest: IngestConfig = field(default_factory=IngestConfig)
    batch_aggregation_shard_count: int = 8
    task_counter_shard_count: int = 8
    #: "cuda" routes whole-job prepare through one batched launch on the
    #: card (vdaf/backend.py CudaBackend); "mesh" shards each flush over
    #: every card of the process (MeshBackend); "oracle" is the CPU
    #: oracle, only when named.  With "cuda" or "mesh" and no card the
    #: binary fails at startup.
    vdaf_backend: str = "cuda"
    #: torch device of the "cuda" backend; None = the card ("cpu" is how
    #: tests run the binaries)
    vdaf_device: Optional[str] = None
    #: Field-arithmetic layout of the card backends: "vpu", the limb core
    #: (the default), or "mxu", the limb-digit matmul layout (every flush on
    #: the row path, its contractions as matmuls); the same bytes either way.
    field_backend: str = "vpu"
    #: Aggregation-job size for agg-param VDAFs (Poplar1), whose jobs are
    #: created by the collection request rather than the periodic creator.
    #: Small values cost nothing at prepare time with the executor on —
    #: the jobs' rows re-coalesce in the level-keyed poplar_init bucket.
    max_agg_param_job_size: int = 256
    #: Helper-side executor routing (default off): the helper's Prio3
    #: prep_init/combine — and Poplar1's poplar_init — submit through the
    #: binary's device executor, with its continuous batching and circuit
    #: breaker.
    device_executor: DeviceExecutorConfig = field(default_factory=DeviceExecutorConfig)
    garbage_collection_interval_s: Optional[float] = None
    #: Management REST API (aggregator_api.py): task CRUD + HPKE key
    #: management, bearer-auth, served on its OWN address (never the DAP
    #: port — provisioning must not share the front door's shed/auth
    #: story).  Empty disables; the canary plane provisions its probe
    #: tasks through this.
    task_api_listen_address: str = ""
    task_api_auth_tokens: List[str] = field(default_factory=list)
    #: Global-HPKE key rotation loop (reference: binaries/aggregator.rs:31-150
    #: runs the maintenance loops beside the server); None disables.
    key_rotator_interval_s: Optional[float] = None
    key_rotator_pending_duration_s: int = 86400
    key_rotator_active_duration_s: int = 7 * 86400
    key_rotator_expired_duration_s: int = 86400

    def __post_init__(self):
        _check_backends(self.vdaf_backend, self.field_backend)


@dataclass
class JobCreatorConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    aggregation_job_creation_interval_s: float = 60.0
    min_aggregation_job_size: int = 10
    max_aggregation_job_size: int = 256
    batch_aggregation_shard_count: int = 8
    #: Report-journal replay grace: journal rows younger than
    #: this are left for the upload replica's direct staged consumer —
    #: replaying them here is safe (delete-linearized) but wastes the
    #: zero-copy handoff.  0 replays everything immediately.
    journal_replay_min_age_s: float = 5.0


@dataclass
class JobDriverBinaryConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    job_driver: JobDriverConfig = field(default_factory=JobDriverConfig)
    batch_aggregation_shard_count: int = 8
    #: "cuda" | "mesh" | "oracle" — see AggregatorConfig.vdaf_backend.
    vdaf_backend: str = "cuda"
    #: torch device of the "cuda" backend; None = the card
    vdaf_device: Optional[str] = None
    #: Device field-arithmetic layout — see AggregatorConfig.field_backend.
    field_backend: str = "vpu"
    #: Continuous cross-job batching for device prepare (default off).
    device_executor: DeviceExecutorConfig = field(default_factory=DeviceExecutorConfig)
    #: The JAX package's oracle wait while a shape compiled; the port
    #: removed it (a job waits for its shape's build, never the oracle):
    #: only 0 is accepted.
    warmup_wait_s: float = 0.0

    def __post_init__(self):
        _check_backends(self.vdaf_backend, self.field_backend)
        if self.warmup_wait_s:
            raise ConfigError(
                "warmup_wait_s was removed: a job waits for its shape's "
                "build and never falls to the oracle; leave it 0"
            )


def _merge_dataclass(cls, data: dict):
    """Build a (possibly nested) config dataclass from a YAML dict, applying
    defaults for absent keys and rejecting unknown ones."""
    import dataclasses

    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"expected mapping for {cls.__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key in sorted(set(data) & set(REMOVED_KEYS)):
        raise ConfigError(REMOVED_KEYS[key])
    unknown = set(data) - set(fields)
    if unknown:
        raise ConfigError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    # `from __future__ import annotations` makes f.type a string; resolve
    # nested config classes by name.
    nested = {
        c.__name__: c
        for c in (
            CommonConfig,
            DbConfig,
            JobDriverConfig,
            DeviceExecutorConfig,
            AccumulatorStoreConfig,
            FaultInjectionConfig,
            FleetConfig,
            DatastoreHealthConfig,
            IngestConfig,
            CanaryConfig,
        )
    }
    kwargs = {}
    for name, f in fields.items():
        if name not in data:
            continue
        type_name = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
        if type_name in nested:
            kwargs[name] = _merge_dataclass(nested[type_name], data[name])
        else:
            kwargs[name] = data[name]
    return cls(**kwargs)


def load_config(cls, path: Optional[str] = None, text: Optional[str] = None):
    """Load a binary's config from YAML (path or literal text); a path
    ending in ``.json`` is read as JSON."""
    if text is None:
        if path is None:
            return cls()
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return _merge_dataclass(cls, json.loads(text))
    import yaml

    return _merge_dataclass(cls, yaml.safe_load(text))


# -- secrets from the environment (reference: binary_utils.rs:207-238) ------


def datastore_keys_from_env() -> List[bytes]:
    """DATASTORE_KEYS: comma-separated base64url AES-128 keys; first one
    encrypts (reference: janus_cli create-datastore-key)."""
    raw = os.environ.get("DATASTORE_KEYS")
    if not raw:
        raise ConfigError("DATASTORE_KEYS environment variable is required")
    keys = []
    for part in raw.split(","):
        part = part.strip()
        pad = "=" * (-len(part) % 4)
        keys.append(base64.urlsafe_b64decode(part + pad))
    return keys


def parse_listen_address(addr: str):
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)
