"""Metrics: Prometheus registry + the reference's domain metrics.

The analog of the reference's OTel metrics stack (reference:
aggregator/src/metrics.rs:222-323): per-route HTTP request counts/latency,
upload outcome counters by rejection reason, aggregate step failures by
type, job acquire/step timing, and per-transaction status/duration.
Exported via a Prometheus scrape endpoint on the health server
(``/metrics``), matching the reference's prometheus exporter mode.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

try:
    from prometheus_client import (
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    HAVE_PROMETHEUS = True
except ImportError:  # pragma: no cover - baked into the image
    HAVE_PROMETHEUS = False

#: Latency buckets tuned like the reference's custom histogram views
#: (reference: metrics.rs:103-174).
_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Pipeline-freshness buckets: ages from sub-second commit latencies up to
#: a day-old report landing in an aggregate (SLO alerting range).
_AGE_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
    3600.0, 7200.0, 21600.0, 86400.0,
)


# -- pure-Python fallback metric implementation ------------------------------
# When prometheus_client is absent (dev containers without the baked
# image), Metrics used to no-op (registry=None) — which also silenced every
# metric-invariant ASSERTION the chaos suites want to make.  This fallback
# keeps the same Counter/Gauge/Histogram surface (labels/inc/set/observe/
# remove) in plain dicts, exports Prometheus text, and answers
# ``registry.get_sample_value`` exactly like CollectorRegistry does, so
# tests and /metrics behave identically either way.


class _FallbackChild:
    def __init__(self, metric: "_FallbackMetric", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            self._metric._values[self._key] = (
                self._metric._values.get(self._key, 0.0) + amount
            )

    def set(self, value: float) -> None:
        with self._metric._lock:
            self._metric._values[self._key] = float(value)

    def observe(self, value: float) -> None:
        with self._metric._lock:
            count, total, buckets = self._metric._hist.get(
                self._key, (0, 0.0, [0] * len(self._metric.buckets))
            )
            buckets = list(buckets)
            for i, le in enumerate(self._metric.buckets):
                if value <= le:
                    buckets[i] += 1
            self._metric._hist[self._key] = (count + 1, total + value, buckets)


class _FallbackMetric:
    """One metric family (all label sets) of the fallback registry."""

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Tuple[str, ...] = (),
        registry: Optional["FallbackRegistry"] = None,
        buckets: Tuple[float, ...] = (),
        kind: str = "counter",
    ):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.kind = kind
        self._lock = threading.Lock()
        #: label-value tuple -> scalar (counter/gauge)
        self._values: Dict[Tuple[str, ...], float] = {}
        #: label-value tuple -> (count, sum, per-bucket cumulative counts)
        self._hist: Dict[Tuple[str, ...], Tuple[int, float, List[int]]] = {}
        if registry is not None:
            registry.register(self)
        # an unlabeled metric is usable without .labels()
        if not self.labelnames:
            self._root = _FallbackChild(self, ())

    def labels(self, *values, **kwargs) -> _FallbackChild:
        if kwargs:
            values = tuple(str(kwargs[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}"
            )
        return _FallbackChild(self, values)

    def remove(self, *values) -> None:
        key = tuple(str(v) for v in values)
        with self._lock:
            self._values.pop(key, None)
            self._hist.pop(key, None)

    # unlabeled passthroughs
    def inc(self, amount: float = 1.0) -> None:
        self._root.inc(amount)

    def set(self, value: float) -> None:
        self._root.set(value)

    def observe(self, value: float) -> None:
        self._root.observe(value)


class FallbackRegistry:
    """Dict-of-families registry with CollectorRegistry's read surface."""

    def __init__(self):
        self._metrics: Dict[str, _FallbackMetric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _FallbackMetric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric

    def families(self) -> List[_FallbackMetric]:
        with self._lock:
            return list(self._metrics.values())

    @staticmethod
    def _label_str(labelnames, key) -> str:
        if not labelnames:
            return ""
        pairs = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))
        return "{" + pairs + "}"

    def get_sample_value(
        self, name: str, labels: Optional[dict] = None
    ) -> Optional[float]:
        """CollectorRegistry-compatible: ``name`` is the SAMPLE name
        (``..._total``, ``..._count``, ``..._sum``, ``..._bucket``)."""
        labels = dict(labels or {})
        for m in self.families():
            with m._lock:
                if m.kind == "counter" and name == m.name + "_total":
                    key = tuple(str(labels.get(n, "")) for n in m.labelnames)
                    return self._maybe(m._values, key, labels, m.labelnames)
                if m.kind == "gauge" and name == m.name:
                    key = tuple(str(labels.get(n, "")) for n in m.labelnames)
                    return self._maybe(m._values, key, labels, m.labelnames)
                if m.kind == "histogram" and name.startswith(m.name + "_"):
                    suffix = name[len(m.name) + 1 :]
                    le = labels.pop("le", None)
                    key = tuple(str(labels.get(n, "")) for n in m.labelnames)
                    entry = m._hist.get(key)
                    if entry is None:
                        return None
                    count, total, buckets = entry
                    if suffix == "count":
                        return float(count)
                    if suffix == "sum":
                        return total
                    if suffix == "bucket":
                        if le in ("+Inf", None):
                            return float(count)
                        for i, b in enumerate(m.buckets):
                            if _le_str(b) == le:
                                return float(buckets[i])
                        return None
        return None

    @staticmethod
    def _maybe(values, key, labels, labelnames) -> Optional[float]:
        if set(labels) - set(labelnames):
            return None
        return values.get(key)

    def generate_text(self) -> bytes:
        """Prometheus exposition text for /metrics scrapes."""
        out: List[str] = []
        for m in self.families():
            out.append(f"# HELP {m.name} {m.documentation}")
            out.append(f"# TYPE {m.name} {m.kind}")
            with m._lock:
                if m.kind == "histogram":
                    for key, (count, total, buckets) in sorted(m._hist.items()):
                        base = list(zip(m.labelnames, key))
                        for i, le in enumerate(m.buckets):
                            lbl = self._label_str(
                                [n for n, _ in base] + ["le"],
                                [v for _, v in base] + [_le_str(le)],
                            )
                            out.append(f"{m.name}_bucket{lbl} {buckets[i]}")
                        lbl = self._label_str(
                            [n for n, _ in base] + ["le"],
                            [v for _, v in base] + ["+Inf"],
                        )
                        out.append(f"{m.name}_bucket{lbl} {count}")
                        plain = self._label_str(m.labelnames, key)
                        out.append(f"{m.name}_count{plain} {count}")
                        out.append(f"{m.name}_sum{plain} {total}")
                else:
                    suffix = "_total" if m.kind == "counter" else ""
                    for key, value in sorted(m._values.items()):
                        lbl = self._label_str(m.labelnames, key)
                        out.append(f"{m.name}{suffix}{lbl} {value}")
        return ("\n".join(out) + "\n").encode()


def _le_str(bound: float) -> str:
    """Render a bucket bound exactly like prometheus_client's
    floatToGoString does for our finite bounds ('5.0', not '5'), so
    ``le`` label values — in scrapes and in get_sample_value lookups —
    agree between backends."""
    return repr(float(bound))


def _fallback_counter(name, doc, labelnames=(), registry=None):
    # prometheus_client strips a declared "_total" suffix from the family
    # name and re-appends it on the sample; mirror that so sample names
    # (and the golden catalog) agree between backends
    if name.endswith("_total"):
        name = name[: -len("_total")]
    return _FallbackMetric(name, doc, labelnames, registry, kind="counter")


def _fallback_gauge(name, doc, labelnames=(), registry=None):
    return _FallbackMetric(name, doc, labelnames, registry, kind="gauge")


def _fallback_histogram(name, doc, labelnames=(), registry=None, buckets=()):
    return _FallbackMetric(
        name, doc, labelnames, registry, buckets=buckets, kind="histogram"
    )


class Metrics:
    """Domain metrics bundle; one per process.

    With ``prometheus_client`` available the bundle is a real
    CollectorRegistry; without it (or with ``force_fallback=True``) the
    pure-Python fallback above keeps every series live so dev-container
    runs still scrape and assert on metrics.
    """

    def __init__(
        self,
        registry: Optional["CollectorRegistry"] = None,
        force_fallback: bool = False,
    ):
        self.fallback = force_fallback or not HAVE_PROMETHEUS
        if self.fallback:
            self.registry = FallbackRegistry()
            Counter = _fallback_counter  # noqa: N806 - mirror prometheus API
            Gauge = _fallback_gauge  # noqa: N806
            Histogram = _fallback_histogram  # noqa: N806
        else:
            self.registry = registry or CollectorRegistry()
            # local bindings: the fallback branch shadows these names, which
            # makes them function-local in BOTH branches
            from prometheus_client import Counter, Gauge, Histogram  # noqa: F811
        self.http_requests = Counter(
            "janus_http_requests_total",
            "DAP HTTP requests by route and status",
            ["route", "status"],
            registry=self.registry,
        )
        self.http_latency = Histogram(
            "janus_http_request_duration_seconds",
            "DAP HTTP request latency by route",
            ["route"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        # reference: report_writer.rs:324 upload counters by reason
        self.upload_outcomes = Counter(
            "janus_upload_decision_total",
            "Upload outcomes by decision",
            ["decision"],
            registry=self.registry,
        )
        # reference: metrics.rs:313 janus_aggregate_step_failure
        self.step_failures = Counter(
            "janus_aggregate_step_failure_total",
            "Aggregation step failures by type",
            ["type"],
            registry=self.registry,
        )
        # Oracle-fallback visibility: a device-configured deployment whose
        # task lands on the CPU oracle must say so.
        self.vdaf_backend_fallbacks = Counter(
            "janus_vdaf_backend_fallback_total",
            "Tasks served by the CPU oracle despite a device backend config",
            ["vdaf_type", "reason"],
            registry=self.registry,
        )
        # Per-outcome step counter at the JobDriver layer: a stuck fleet
        # (timeouts / retryable churn) and a healthy one look identical on
        # wall-time alone; this splits them.
        self.job_steps_total = Counter(
            "janus_job_steps_total",
            "Job driver step outcomes by job type",
            ["job_type", "outcome"],
            registry=self.registry,
        )
        # reference: job_driver.rs:102-113 acquire/step timing
        self.job_steps = Histogram(
            "janus_job_step_duration_seconds",
            "Job step wall time by job type and outcome",
            ["job_type", "outcome"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        # reference: datastore.rs:186-224 per-tx status
        self.tx_total = Counter(
            "janus_database_transactions_total",
            "Datastore transactions by name and status",
            ["name", "status"],
            registry=self.registry,
        )
        # Datastore brownout tolerance (core/db_health.py): the database
        # failure domain made observable.  The state-set gauge carries 1
        # on the tracker's current state so alerts can match on
        # janus_datastore_health{state="suspect"} == 1 directly; the
        # retry counter is the brownout's intensity (every transient
        # in-loop failure, before the attempt that eventually commits).
        self.datastore_health = Gauge(
            "janus_datastore_health",
            "Datastore health state-set (1 on the tracker's current "
            "state: healthy|suspect|probing)",
            ["state"],
            registry=self.registry,
        )
        self.datastore_tx_retries = Counter(
            "janus_datastore_tx_retries_total",
            "Transient datastore transaction failures retried by run_tx "
            "(lock contention, serialization failures, connection drops)",
            registry=self.registry,
        )
        # Janitor plane gating on datastore health: sweeps skipped while
        # the tracker is non-healthy, so GC never races a brownout-
        # recovering replay window.
        self.janitor_skips = Counter(
            "janus_janitor_skips_total",
            "Janitor sweeps skipped because the datastore tracker was "
            "non-healthy, by component (gc|key_rotator)",
            ["component"],
            registry=self.registry,
        )
        # batched device launches through the backend seam
        self.device_launches = Counter(
            "janus_device_prepare_launches_total",
            "Batched VDAF prepare launches by backend",
            ["backend"],
            registry=self.registry,
        )
        self.device_reports = Counter(
            "janus_device_prepare_reports_total",
            "Reports prepared through batched launches by backend",
            ["backend"],
            registry=self.registry,
        )
        # Steady-state backend visibility: reports/s
        # and wall time PER BACKEND on every prepare/combine batch — an
        # oracle-pinned task shows up on a dashboard as a continuously
        # rising oracle series, not just a one-time fallback warning.
        # (reference analog: per-step timing meters, metrics.rs:303-323)
        self.prepare_reports = Counter(
            "janus_vdaf_prepare_reports_total",
            "Reports through VDAF prepare phases by backend",
            ["backend", "phase"],
            registry=self.registry,
        )
        self.prepare_seconds = Histogram(
            "janus_vdaf_prepare_duration_seconds",
            "VDAF prepare batch wall time by backend and phase",
            ["backend", "phase"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )

        # Device executor (executor/): continuous cross-job
        # batching visibility per (circuit, aggregator-side, phase[,
        # agg-param level]) bucket.  The bucket label enumerates the
        # submission KINDS — prep_init / combine (Prio3) and poplar_init
        # (Poplar1 heavy hitters, whose label carries an L{level} segment:
        # one series per IDPF tree level, so a multi-round collection's
        # per-level batching is visible round by round).  flush_rows vs.
        # the per-job submission size is the direct measure of cross-job
        # coalescing; queue_rows + wait/launch seconds expose whether
        # backpressure or the chip is the bottleneck.
        self.executor_queue_rows = Gauge(
            "janus_executor_queue_rows",
            "Report rows queued or in flight per executor bucket "
            "(circuit/side/kind, Poplar1 buckets carry the tree level)",
            ["bucket"],
            registry=self.registry,
        )
        self.executor_flush_rows = Histogram(
            "janus_executor_flush_rows",
            "Mega-batch size (rows) per executor flush "
            "(all submission kinds: prep_init, combine, poplar_init)",
            ["bucket"],
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384, 65536),
            registry=self.registry,
        )
        self.executor_wait_seconds = Histogram(
            "janus_executor_wait_duration_seconds",
            "Submission wall time from enqueue to result by bucket",
            ["bucket"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        self.executor_launch_seconds = Histogram(
            "janus_executor_launch_duration_seconds",
            "Device launch wall time per executor flush by bucket "
            "(poplar_init flushes include the bulk-AES walk)",
            ["bucket"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        self.executor_rejections = Counter(
            "janus_executor_rejections_total",
            "Backpressure rejections by bucket and reason",
            ["bucket", "reason"],
            registry=self.registry,
        )
        # Shape-churn visibility: how long each VDAF shape's
        # executables took to compile, and whether the registry-driven
        # background warmup delivered them (outcome=ok) or the shape is
        # serving cold (outcome=error).  compile_s per shape is the number
        # the persistent compile cache should drive to ~0 across restarts.
        self.executor_compile_seconds = Histogram(
            "janus_executor_compile_duration_seconds",
            "Warmup compile wall time per VDAF shape",
            ["shape"],
            buckets=(0.5, 2, 5, 15, 30, 60, 120, 300, 600),
            registry=self.registry,
        )
        self.executor_warmups = Counter(
            "janus_executor_warmup_total",
            "Backend warmup attempts by outcome",
            ["outcome"],
            registry=self.registry,
        )
        # Per-shape circuit breaker (executor/service.py): a sick device
        # path must be visible the moment it trips, and again when the
        # half-open probe restores it.
        self.circuit_state = Gauge(
            "janus_executor_circuit_state",
            "Device circuit state per VDAF shape (0=closed 1=open 2=half-open)",
            ["circuit"],
            registry=self.registry,
        )
        self.circuit_transitions = Counter(
            "janus_executor_circuit_transitions_total",
            "Device circuit state transitions per VDAF shape",
            ["circuit", "state"],
            registry=self.registry,
        )
        # Device-resident accumulator store (executor/accumulator.py): a
        # budgeted cache — occupancy, spill and eviction rates are what an
        # operator tunes byte_budget against.
        self.accumulator_resident_bytes = Gauge(
            "janus_accumulator_resident_bytes",
            "Bytes of out-share state resident on device (flush matrices + bucket buffers)",
            registry=self.registry,
        )
        self.accumulator_buckets = Gauge(
            "janus_accumulator_buckets",
            "Live (task, shape, batch-bucket) resident accumulators",
            registry=self.registry,
        )
        self.accumulator_spills = Counter(
            "janus_accumulator_spills_total",
            "Accumulator drains by reason (commit, discard)",
            ["reason"],
            registry=self.registry,
        )
        self.accumulator_evictions = Counter(
            "janus_accumulator_evictions_total",
            "LRU/memory-pressure evictions of resident accumulator state",
            registry=self.registry,
        )
        # Device-resident IDPF (ops/poplar1_batch.py): the rows the card
        # walks through the Poplar1 AES tree (the label keeps the JAX
        # package's series shape; the port serves only "cuda"), and how
        # many card-walked rows had their sketch y vectors
        # materialized back to host — the device-resident path keeps the
        # readback at 0 (states carry ResidentRefs; drains read ONE vector
        # per level bucket).
        self.poplar_walk_rows = Counter(
            "janus_poplar_walk_rows_total",
            "Poplar1 IDPF tree-walk rows by AES backend (cuda)",
            ["backend"],
            registry=self.registry,
        )
        self.poplar_sketch_readback_rows = Counter(
            "janus_poplar_sketch_readback_rows_total",
            "Device-walked Poplar1 rows whose sketch y vectors were read "
            "back to host (0 on the device-resident path)",
            registry=self.registry,
        )
        # Peer-health-aware acquisition (job_driver.suspect_task_ids): jobs
        # of suspect-peer tasks are filtered at the acquire query instead
        # of acquired-then-released, sparing tx churn during partitions.
        self.job_acquisition_suspect_filtered = Counter(
            "janus_job_acquisition_suspect_filtered_total",
            "Job acquisition passes that excluded suspect-peer tasks at "
            "the query, by job type",
            ["job_type"],
            registry=self.registry,
        )
        # Crash recovery: leases that expired WITHOUT release are holders
        # that died or wedged — the reaper (job_driver.py) clears them so
        # redelivery is prompt and the death is visible on a dashboard.
        self.job_leases_expired = Counter(
            "janus_job_leases_expired_total",
            "Job leases that expired without release (holder died/wedged), by job type",
            ["job_type"],
            registry=self.registry,
        )
        # Deferred-drain journal (datastore accumulator_journal table):
        # persisted entries per outcome — 'drain' is the owner's cadence/
        # shutdown spill consuming its own rows, 'replay' is a survivor
        # re-deriving a dead replica's rows on the CPU oracle.
        self.accumulator_journal_entries = Counter(
            "janus_accumulator_journal_entries_total",
            "Accumulator journal rows written (deferred resident drains)",
            registry=self.registry,
        )
        self.accumulator_journal_consumed = Counter(
            "janus_accumulator_journal_consumed_total",
            "Accumulator journal rows consumed, by path (drain|replay)",
            ["path"],
            registry=self.registry,
        )
        # Peer transport health (core/peer_health.py): the partition
        # failure domain made observable — which peer, what state, how
        # many transport-level failures.  The state-set gauge carries 1
        # on the peer's current state so dashboards and alerts can match
        # on janus_peer_health{state="suspect"} == 1 directly.
        self.peer_health = Gauge(
            "janus_peer_health",
            "Peer transport health state-set (1 on the peer's current "
            "state: healthy|suspect|probing)",
            ["peer", "state"],
            registry=self.registry,
        )
        self.peer_transport_failures = Counter(
            "janus_peer_transport_failures_total",
            "Transport-level failures (connect/reset/timeout) per peer; "
            "HTTP responses of any status do not count",
            ["peer"],
            registry=self.registry,
        )
        # Backpressure cooperation: how often the peer's Retry-After hint
        # (503 overload responses) shaped our backoff instead of the
        # blind exponential curve.
        self.http_retry_after_honored = Counter(
            "janus_http_retry_after_honored_total",
            "Retryable HTTP responses whose Retry-After hint set the "
            "backoff sleep (capped at the policy max interval)",
            registry=self.registry,
        )
        # Fault injection (core/faults.py): every injected fault is counted
        # so a chaos run's pressure is itself observable.
        self.faults_injected = Counter(
            "janus_faults_injected_total",
            "Injected faults by point and mode",
            ["point", "mode"],
            registry=self.registry,
        )
        # Fleet control plane (core/fleet.py): membership and routing as
        # seen by THIS replica's router — members it counts live in its
        # own role's rendezvous domain, tasks it currently owns, and how
        # many tasks it has absorbed from dead peers.  A fleet-wide burst
        # of migrations (every replica's counter moving at once) is the
        # migration-storm signature; see README "Fleet routing".
        self.fleet_members = Gauge(
            "janus_fleet_members",
            "Live same-role fleet members in this replica's membership view",
            registry=self.registry,
        )
        self.fleet_tasks_owned = Gauge(
            "janus_fleet_tasks_owned",
            "Tasks the rendezvous router currently assigns to this replica",
            registry=self.registry,
        )
        self.fleet_migrations = Counter(
            "janus_fleet_migrations_total",
            "Tasks this replica took over from a member whose heartbeat "
            "expired (live task migration events)",
            registry=self.registry,
        )
        # Migration-storm suppression: ownership refreshes served from
        # the FROZEN view because mass staleness (or a suspect local
        # datastore) made the membership table untrustworthy.  A nonzero
        # rate here during a brownout is the system working; see README
        # "Datastore brownout tolerance" for the starter alert.
        self.fleet_migration_suppressed = Counter(
            "janus_fleet_migration_suppressed_total",
            "Ownership refreshes served from the frozen view because a "
            "migration storm was suppressed (mass staleness or suspect "
            "datastore)",
            registry=self.registry,
        )

        # -- pipeline freshness / SLO metrics ---------
        # The operator question that defines a DAP deployment's SLO: how
        # old is a report by the time it lands where it is going?
        # reference analog: per-step timing meters, metrics.rs:303-323.
        self.report_commit_age = Histogram(
            "janus_report_commit_age_seconds",
            "Report age at upload-batch commit (client timestamp -> writer commit)",
            registry=self.registry,
            buckets=_AGE_BUCKETS,
        )
        self.job_age_at_acquire = Histogram(
            "janus_job_age_at_acquire_seconds",
            "Job age (created_at -> lease acquire) by job type",
            ["job_type"],
            registry=self.registry,
            buckets=_AGE_BUCKETS,
        )
        self.collection_e2e = Histogram(
            "janus_collection_e2e_seconds",
            "Upload->collectable latency: collection finish minus the "
            "batch's earliest client timestamp",
            registry=self.registry,
            buckets=_AGE_BUCKETS,
        )
        # Sampled queue-depth gauges (binaries' status sampler loop):
        # acquirable backlog per job type, and the outstanding deferred-
        # drain journal (rows counted but not yet merged + oldest age —
        # a rising oldest-age is a dead replica whose rows nobody replayed).
        self.acquirable_jobs = Gauge(
            "janus_acquirable_jobs",
            "Jobs currently acquirable (active state, lease expired) by job type",
            ["job_type"],
            registry=self.registry,
        )
        self.journal_outstanding_rows = Gauge(
            "janus_accumulator_journal_outstanding_rows",
            "Outstanding accumulator-journal rows (counted reports whose "
            "shares are not yet merged)",
            registry=self.registry,
        )
        self.journal_oldest_age = Gauge(
            "janus_accumulator_journal_oldest_age_seconds",
            "Age of the oldest outstanding accumulator-journal row",
            registry=self.registry,
        )

        # -- client-ingress observability -------------
        # Upload acceptance latency as the CLIENT experiences it: from the
        # handler enqueueing the validated report into the write batcher to
        # the batch transaction committing it.  The front-door half of the
        # freshness story — report_commit_age measures how old the report
        # was, this measures how long WE held it before it was durable.
        self.upload_to_commit = Histogram(
            "janus_report_upload_to_commit_seconds",
            "Upload handler enqueue to batch-commit latency per accepted report",
            registry=self.registry,
            buckets=_LATENCY_BUCKETS,
        )
        # -- upload front door -----------------------
        # Load shedding: uploads refused at the bounded front-door queue
        # (503 + Retry-After, the DAP-retryable shape) by reason —
        # queue_full is depth pressure, queue_delay is the oldest pending
        # open blowing its latency budget.  Overload degrades into client
        # retry pressure instead of event-loop collapse; this counter is
        # the alertable signal that it is happening.
        self.upload_sheds = Counter(
            "janus_upload_shed_total",
            "Uploads shed at the front-door queue (503 + Retry-After) by "
            "reason (queue_full|queue_delay|datastore|journal)",
            ["reason"],
            registry=self.registry,
        )
        # Batched HPKE open (core/hpke_batch.py): how many opens each
        # vectorized pass carried (amortization is the whole point), how
        # long the open stage takes per backend, and the live front-door
        # queue depth the shed decision reads.
        self.upload_open_batch_rows = Histogram(
            "janus_upload_open_batch_rows",
            "HPKE opens per batched front-door open pass",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
            registry=self.registry,
        )
        self.upload_open_seconds = Histogram(
            "janus_upload_open_duration_seconds",
            "Upload HPKE-open stage wall time by backend "
            "(batched: per batch pass; inline: per report)",
            ["backend"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        self.upload_queue_depth = Gauge(
            "janus_upload_queue_depth",
            "Front-door uploads pending in the batched HPKE-open queue",
            registry=self.registry,
        )
        # HPKE opens by stage (upload|aggregate_init) and route: vector (an
        # AES-128-GCM body of core/hpke_batch.py's vector pass), aead (a
        # body opened per report with its batch-derived key), inline (a
        # whole per-report open); and the vector passes that failed as a
        # whole, each answered with a retryable 503
        self.hpke_open_rows = Counter(
            "janus_hpke_open_rows_total",
            "HPKE opens by stage (upload|aggregate_init) and route (vector|aead|inline)",
            ["stage", "route"],
            registry=self.registry,
        )
        self.hpke_vector_pass_failures = Counter(
            "janus_hpke_vector_pass_failures_total",
            "AES-128-GCM vector passes that failed as a whole, answered 503 (upload|aggregate_init)",
            ["stage"],
            registry=self.registry,
        )
        # -- zero-copy ingest plane (core/ingest.py) -----------
        # The write-behind report journal: reports waiting on their
        # durability-ACK journal flush (staged + in-flight — the bound the
        # reason="journal" shed reads), how long each flush transaction
        # takes, where staged reports went (direct = handed in-memory to
        # the job creator's staging side; readback = materialized into
        # client_reports and consumed through the classic read path), and
        # rows replayed into client_reports after a crash or migration.
        self.ingest_journal_depth = Gauge(
            "janus_ingest_journal_depth",
            "Reports pending their report-journal durability flush "
            "(staged + in-flight)",
            registry=self.registry,
        )
        self.ingest_journal_flush_seconds = Histogram(
            "janus_ingest_journal_flush_seconds",
            "Report-journal flush transaction wall time per batch",
            registry=self.registry,
            buckets=_LATENCY_BUCKETS,
        )
        self.ingest_staged_total = Counter(
            "janus_ingest_staged_reports_total",
            "Journaled-ingest reports by aggregation-visibility path "
            "(direct: staged cohort packed in-memory; readback: "
            "materialized into client_reports for the classic read path)",
            ["path"],
            registry=self.registry,
        )
        self.ingest_journal_replayed = Counter(
            "janus_ingest_journal_replayed_total",
            "Report-journal rows materialized into client_reports by "
            "replay (startup, creator pre-pass, or migration handoff)",
            registry=self.registry,
        )
        # -- poison/corruption failure domain (core/quarantine.py) -------
        # Vectorized passes fail at cohort granularity; the
        # bisection harness restores per-report failure semantics and
        # these families are its blast-radius ledger: rows pulled out of
        # a cohort (by stage), bisection sieves run, and durable journal
        # rows that failed their CRC32C check at materialize/replay.
        self.quarantined_reports = Counter(
            "janus_quarantined_reports_total",
            "Reports quarantined out of a vectorized cohort, by stage "
            "(upload_open|prep_init|combine|journal|accumulator_journal|"
            "bucket)",
            ["stage"],
            registry=self.registry,
        )
        self.batch_bisections = Counter(
            "janus_batch_bisections_total",
            "Batch-level failures routed through the bisection harness "
            "(each sieve isolates poison rows in O(log B) extra passes)",
            registry=self.registry,
        )
        self.journal_corrupt_rows = Counter(
            "janus_journal_corrupt_rows_total",
            "Durable journal rows (report_journal / accumulator_journal) "
            "that failed CRC32C verification and were quarantined+skipped",
            registry=self.registry,
        )
        # -- SLO evaluation plane (core/slo.py) --------------------------
        # Burn rate = window error rate / error budget: 1.0 means the SLO
        # spends its budget exactly at the sustainable pace, >1 means it
        # will exhaust early.  One sample per (slo, fast|slow) per
        # evaluator tick.
        self.slo_burn_rate = Gauge(
            "janus_slo_burn_rate",
            "Multi-window SLO burn rate (window error rate / error budget)",
            ["slo", "window"],
            registry=self.registry,
        )
        self.slo_breaches = Counter(
            "janus_slo_breach_total",
            "SLO breaches: transitions into fast AND slow burn above threshold",
            ["slo"],
            registry=self.registry,
        )
        # -- OTLP export health (core/otlp.py) ---------------------------
        # The exporter itself must be observable: spans queued vs dropped
        # (lib absent, queue overflow) and export attempts by outcome tell
        # an operator whether the collector is actually receiving data.
        self.otlp_spans = Counter(
            "janus_otlp_spans_total",
            "Spans through the OTLP exporter by outcome (queued|exported|dropped)",
            ["outcome"],
            registry=self.registry,
        )
        self.otlp_exports = Counter(
            "janus_otlp_exports_total",
            "OTLP export attempts by outcome (ok|error|noop)",
            ["outcome"],
            registry=self.registry,
        )
        self.otlp_last_export_age = Gauge(
            "janus_otlp_last_export_age_seconds",
            "Seconds since the last successful OTLP export (-1 when never)",
            registry=self.registry,
        )
        # -- per-task device-plane cost attribution (core/costs.py) ------
        # Which task is burning the chip: each executor flush's measured
        # stage/launch durations split across its submissions by rows, and
        # oracle-path batches attributed whole (phase init|combine).  The
        # path label (device|oracle) makes breaker-driven cost shifts to
        # the CPU oracle visible on the SAME task series.  Cardinality is
        # capped (common.cost_task_cardinality) with a task="other"
        # overflow label; idle task series retire on the sampler tick.
        self.task_device_seconds = Counter(
            "janus_task_device_seconds_total",
            "Attributed device-plane seconds per task by phase "
            "(stage|launch: executor flush shares; init|combine: direct "
            "backend batches; drain: accumulator spill readbacks) and "
            "path (device|oracle)",
            ["task", "phase", "path"],
            registry=self.registry,
        )
        self.task_rows = Counter(
            "janus_task_rows_total",
            "Report rows through the device plane per task by outcome "
            "(ok|rejected|error)",
            ["task", "outcome"],
            registry=self.registry,
        )
        self.task_queue_delay = Histogram(
            "janus_task_queue_delay_seconds",
            "Per-submission executor queue delay (enqueue -> flush "
            "dispatch) by task",
            ["task"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        # Pad waste per flush: mesh-tail + pow2-canonicalization padding
        # rows the chip computes and throws away — the direct measure of
        # how much throughput shape canonicalization costs a bucket.
        self.executor_pad_rows = Counter(
            "janus_executor_pad_rows_total",
            "Mask-padded rows launched per executor bucket (pow2 + "
            "mesh-tail padding waste; real rows ride "
            "janus_executor_flush_rows)",
            ["bucket"],
            registry=self.registry,
        )
        # -- canary plane (core/canary.py) ---------------------
        # Black-box known-plaintext probes through the real upload ->
        # aggregate -> collect path.  The verdict counter is the only
        # family that can say "the fleet aggregated WRONG" (outcome=
        # corrupt: collected aggregate != the exact expected sum, or the
        # share failed to decrypt/decode); per-stage attribution rides
        # the probe_seconds histogram and the SLO plane reads the e2e +
        # outcome histograms (canary_e2e_latency / canary_success).
        self.canary_verdicts = Counter(
            "janus_canary_verdict_total",
            "Canary probe verdicts by canary task and outcome "
            "(ok|error|timeout|corrupt)",
            ["task", "outcome"],
            registry=self.registry,
        )
        self.canary_probe_seconds = Histogram(
            "janus_canary_probe_seconds",
            "Canary per-stage latency attribution (upload_ack|commit|"
            "first_prepare|collection|e2e)",
            ["stage"],
            buckets=_AGE_BUCKETS,
            registry=self.registry,
        )
        self.canary_e2e = Histogram(
            "janus_canary_e2e_seconds",
            "Canary probe end-to-end latency (first upload to verified "
            "collection)",
            buckets=_AGE_BUCKETS,
            registry=self.registry,
        )
        self.canary_probe_outcome = Histogram(
            "janus_canary_probe_outcome",
            "Canary probe outcomes as an SLO-shaped histogram (observes "
            "0.0 on success, 2.0 on failure; good = samples <= 0.5)",
            buckets=(0.5, 1.0),
            registry=self.registry,
        )
        self.canary_backoffs = Counter(
            "janus_canary_backoffs_total",
            "Canary probes suppressed by degradation-aware backoff, by "
            "reason (db_suspect|upload_shed) — counted, never alerting",
            ["reason"],
            registry=self.registry,
        )
        self.canary_verdict_state = Gauge(
            "janus_canary_verdict_state",
            "Canary rolled-up verdict per task (0 healthy, 1 degraded, "
            "2 failing)",
            ["task"],
            registry=self.registry,
        )

    # -- introspection ---------------------------------------------------
    def get_sample_value(self, name: str, labels: Optional[dict] = None):
        """Read one sample (Prometheus sample naming: ``..._total``,
        ``..._count``, ...) from whichever registry backs this bundle —
        the accessor metric-invariant assertions use."""
        if self.registry is None:
            return None
        return self.registry.get_sample_value(name, labels or {})

    def catalog(self) -> List[str]:
        """``name|type|label,label`` per metric family, sorted — compared
        against tests/metric_manifest.txt so a silent rename/label change
        fails CI.  Built from the metric objects themselves (not scrape
        samples), so zero-traffic families are still listed."""
        out = []
        for obj in vars(self).values():
            if isinstance(obj, _FallbackMetric):
                out.append(f"{obj.name}|{obj.kind}|{','.join(obj.labelnames)}")
            elif hasattr(obj, "_name") and hasattr(obj, "_labelnames"):
                out.append(
                    f"{obj._name}|{obj._type}|{','.join(obj._labelnames)}"
                )
        return sorted(out)

    @staticmethod
    def remove_series(metric, *labelvalues) -> None:
        """Drop one label set from a metric (both backends); quiet when the
        series never existed — bucket retirement calls this to cap gauge
        cardinality."""
        try:
            metric.remove(*labelvalues)
        except Exception:
            pass

    def observe_prepare(self, backend: str, phase: str, reports: int, seconds: float) -> None:
        if self.registry is None:
            return
        self.prepare_reports.labels(backend=backend, phase=phase).inc(reports)
        self.prepare_seconds.labels(backend=backend, phase=phase).observe(seconds)

    # -- helpers --------------------------------------------------------
    def observe_http(self, route: str, status: int, seconds: float) -> None:
        if self.registry is None:
            return
        self.http_requests.labels(route=route, status=str(status)).inc()
        self.http_latency.labels(route=route).observe(seconds)

    def export(self) -> bytes:
        if self.registry is None:
            return b""
        if isinstance(self.registry, FallbackRegistry):
            return self.registry.generate_text()
        return generate_latest(self.registry)


#: Process-wide default bundle (the analog of the reference's global meters).
GLOBAL_METRICS = Metrics()


class Timer:
    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.seconds = time.monotonic() - self.start
