"""Process-wide device execution service: continuous cross-job batching.

Copy of ``janus_tpu/executor/service.py`` for the PyTorch port.  What
differs: the warmup builds the CUDA kernels (nvcc) and runs one launch at
the warmup batch in place of an XLA compile; the mesh upgrade
(``ExecutorConfig.mesh``) makes a ``MeshBackend`` over the process's cards
(``vdaf/backend.py``), one circuit breaker a mesh; and where the JAX
package serves a quarantined shape bucket on the CPU oracle, the port
refuses its work as retryable, as it does for an open circuit.  The
Poplar1 ``poplar_init`` kind and its aggregation-parameter buckets are
here, and so are canonical shapes (``canonical_shapes``,
``vdaf/canonical.py``): the producers key a bucket's tasks by their padded
twin, and a prepare request carries the task's VDAF as its third element.

The chip is one wide pipeline; N concurrent aggregation jobs must not
carve it into N narrow, contending ones.  Today each driver step
coalesces only the jobs that happen to land inside its own gather window
(aggregation_job_driver._coalesced_prep_init), so 16 concurrent tasks
still issue many small launches and re-pay dispatch overhead per driver.
This module is the scheduling layer between the protocol logic and the
kernel pool — shaped like an inference-serving continuous batcher:

* ``submit(shape_key, kind, payload) -> result``: every driver (and any
  other producer of prepare work) enqueues into a process-wide service
  that owns the device.
* **Bucketed continuous batching**: submissions are grouped per
  ``(vdaf_shape_key, kind, agg_id, agg_param_key)`` bucket and flushed as ONE
  pow2-padded mega-batch when the bucket reaches ``flush_max_rows`` or
  its ``flush_window_s`` deadline expires — whichever comes first.
* **Backend cache + warmup**: backends are shape-keyed and shared by
  every submitter, so one backend serves all tasks; ``warmup_backend``
  builds the kernels and launches the configured mega-batch shape once
  before traffic arrives (startup, not first-request, pays nvcc and the
  first launch).
* **Double-buffered host->device staging**: marshal/device_put runs on a
  dedicated staging thread while the previous mega-batch's launch
  occupies the chip (stage k+1 overlaps launch k).
* **Backpressure**: per-bucket queue depth is bounded; a submission that
  would exceed it — or whose deadline expires while queued — is rejected
  with ExecutorOverloadedError, which callers surface as a retryable
  JobStepError (the lease machinery redelivers the job).

Results are byte-identical to per-job launches: the mega-batch is the
same concatenation ``CudaBackend.prep_init_multi`` already performs, with
per-row verify keys (tests/test_multitask.py asserts oracle parity under
concurrent submission).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import costs, faults
from ..core.trace import current_trace, emit_span
from .flight_recorder import FlightRecorder

logger = logging.getLogger("janus_tpu_torch.executor")

#: Submission kinds (the "phase" of the bucket key).
KIND_PREP_INIT = "prep_init"
KIND_COMBINE = "combine"
#: Poplar1 heavy-hitters round-0 prepare: payload is (verify_key,
#: agg_param, reports) and the flush runs ONE IDPF walk + sketch pass per
#: aggregation parameter (Poplar1Backend.prep_init_multi_poplar).  Buckets
#: of this kind carry the tree level as their agg-param discriminant.
KIND_POPLAR_INIT = "poplar_init"


class ExecutorOverloadedError(Exception):
    """Bounded-queue or deadline rejection.

    Retryable by construction: the report rows are still leased in the
    datastore, so the caller maps this to JobStepError(retryable=True)
    and the job is redelivered when the device catches up.
    """


class CircuitOpenError(Exception):
    """The shape's device circuit is open: K consecutive launches failed
    and the breaker has not yet half-open-probed its way back (or the
    shape's bucket is quarantined: its own launches keep failing while
    other shapes on its breaker domain succeed).

    The device is sick, not busy.  The caller refuses the work as
    retryable (the driver's JobStepError, the helper's 503) and the lease
    machinery redelivers it while the breaker probes for recovery; a
    circuit the card serves never lands on the CPU oracle.
    """


#: Circuit states (exported via the janus_executor_circuit_state gauge).
CIRCUIT_CLOSED, CIRCUIT_OPEN, CIRCUIT_HALF_OPEN = 0, 1, 2
_CIRCUIT_STATE_NAMES = {0: "closed", 1: "open", 2: "half_open"}


@dataclass
class ExecutorConfig:
    """Tuning knobs; defaults favor throughput at ~5 ms added latency."""

    #: Mesh-sharded mega-batches: upgrade every exact-type CudaBackend
    #: this executor caches to a MeshBackend over the process's cards
    #: (vdaf/backend.py ``local_mesh``), so staging lands each
    #: mega-batch's shards directly on their cards.  Equivalent to
    #: ``vdaf_backend: mesh`` on every producer; oracle, hybrid and
    #: Poplar1 backends pass through untouched.
    mesh: bool = False
    #: flush a bucket as soon as it holds this many rows
    flush_max_rows: int = 16384
    #: deadline from a bucket's first pending submission to its flush
    flush_window_s: float = 0.005
    #: per-bucket bound on queued + in-flight rows; beyond it, submit rejects
    max_queue_rows: int = 131072
    #: default per-submission deadline (queued past it -> rejected);
    #: <= 0 disables deadline rejection
    submit_timeout_s: float = 30.0
    #: pow2 mega-batch size warmup compiles per (backend, agg_id); 0 = off
    warmup_rows: int = 0
    #: run warmup compiles on a dedicated background thread (default) so
    #: backend_for — and therefore the submit path and binary startup —
    #: never blocks behind nvcc; while a shape is WARMING, producers wait
    #: on the warm future, and the breaker never sees the compile.  False = legacy inline
    #: warmup (the first resolver pays the compile synchronously).
    warmup_async: bool = True
    #: pow2 shape canonicalization (vdaf/canonical.py): producers key
    #: device backends by the CANONICAL shape so tasks of one circuit
    #: family whose lengths fall in one bucket share one backend and one
    #: flush; shapes whose bit-exactness preconditions fail keep their
    #: exact shape.  Read by the job drivers and the helper aggregator at
    #: backend resolution.
    canonical_shapes: bool = True
    #: consecutive launch failures per VDAF shape before its circuit
    #: opens (submits raise CircuitOpenError -> retryable refusal); 0 = off
    breaker_failure_threshold: int = 5
    #: how long an open circuit waits before letting one half-open probe
    #: launch through to test the device
    breaker_reset_timeout_s: float = 30.0
    #: starvation-free flush scheduling: ready flushes dispatch in deficit
    #: round-robin across buckets (deadline-earliest within a bucket)
    #: instead of arrival order, so one hot bucket cannot monopolize the
    #: chip while others hold pending work.  False = legacy FIFO.
    fair_flush: bool = True
    #: deficit-round-robin quantum (rows a bucket may flush per scheduling
    #: round before yielding); a flush larger than the quantum still
    #: dispatches, paying the overshoot out of future rounds
    fair_quota_rows: int = 16384
    #: flight recorder ring size (per-flush records kept in memory for
    #: /statusz "flights" + breaker-trip/slow-flush dumps); >= 1
    flight_recorder_size: int = 256
    #: slow-flush anomaly threshold: a flush whose launch exceeds this
    #: factor × its bucket's rolling p95 dumps the flight ring (rate
    #: limited); <= 0 disables the detector (ring + breaker dumps stay on)
    slow_flush_p95_factor: float = 4.0
    #: device-resident accumulator store (accumulator.AccumulatorConfig);
    #: None or .enabled=False = out shares read back per flush (legacy)
    accumulator: Optional[object] = None
    #: batch bisection quarantine: a NON-injected batch-level
    #: launch failure retries the cohort in halves (core/quarantine.py) to
    #: isolate poison rows — healthy rows resolve normally, offenders get
    #: in-band VdafError outcomes and land in the quarantine ledger.  A
    #: poison report costs O(log B) extra passes once, never a wedged
    #: pipeline or a permanently-tripped breaker.  False = legacy fail-all.
    bisection_enabled: bool = True
    #: per-report retry-charge cap during a bisection sieve; a range whose
    #: most-charged row hits the budget is quarantined wholesale
    bisection_per_item_budget: int = 16
    #: repeated NON-injected device failures confined to ONE shape while
    #: another shape on the same breaker domain stays healthy quarantine
    #: that shape bucket (its work is refused as retryable) instead of
    #: opening the shared (mesh-wide) breaker; 0 = off
    bucket_quarantine_threshold: int = 2
    #: how long a quarantined shape bucket refuses its work before device
    #: submissions flow again
    bucket_quarantine_s: float = 60.0
    #: a failing shape only quarantines (vs counting against the breaker)
    #: when ANOTHER shape on its breaker domain succeeded within this
    #: window — the proof the mesh itself is healthy
    bucket_quarantine_success_window_s: float = 30.0


class CircuitBreaker:
    """Per-shape-key device health: closed -> (K consecutive launch
    failures) -> open -> (reset timeout) -> half-open, one probe in
    flight -> closed on success, straight back to open on failure.

    Thread-safe: allow() runs on submitter event loops, record_*() on
    flush tasks / the launch thread.
    """

    def __init__(
        self, label: str, failure_threshold: int, reset_timeout_s: float, on_trip=None
    ):
        self.label = label
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.state = CIRCUIT_CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()
        #: called as on_trip(breaker) AFTER the lock is released, once per
        #: closed/half-open -> open transition (the executor hangs the
        #: flight-recorder dump here); exceptions are swallowed — a broken
        #: observer must never keep a sick circuit from opening
        self.on_trip = on_trip

    def allow(self) -> bool:
        """May a new submission enter the device path right now?"""
        if self.failure_threshold <= 0:
            return True
        with self._lock:
            if self.state == CIRCUIT_CLOSED:
                return True
            if self.state == CIRCUIT_OPEN:
                if time.monotonic() - self._opened_at < self.reset_timeout_s:
                    return False
                self._set_state(CIRCUIT_HALF_OPEN)
                self._probing = True
                return True
            # HALF_OPEN: exactly one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def probe_aborted(self) -> None:
        """A flush resolved without touching the device (every submission
        expired in queue): no health signal either way, but the probe slot
        must free up or a half-open breaker wedges."""
        with self._lock:
            self._probing = False

    def is_open_peek(self) -> bool:
        """Side-effect-free open check: True while the circuit is open and
        still inside its reset dwell.  Returns False once the dwell has
        elapsed so the next real submission runs the half-open probe (the
        dwell test mirrors allow(); keep them together)."""
        with self._lock:
            return self.state == CIRCUIT_OPEN and (
                time.monotonic() - self._opened_at < self.reset_timeout_s
            )

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._probing = False
            if self.state != CIRCUIT_CLOSED:
                logger.info("device circuit %s closed (probe succeeded)", self.label)
                self._set_state(CIRCUIT_CLOSED)

    def record_failure(self) -> None:
        if self.failure_threshold <= 0:
            return
        with self._lock:
            self.consecutive_failures += 1
            self._probing = False
            should_open = self.state == CIRCUIT_HALF_OPEN or (
                self.state == CIRCUIT_CLOSED
                and self.consecutive_failures >= self.failure_threshold
            )
            if should_open or self.state == CIRCUIT_OPEN:
                self._opened_at = time.monotonic()
            if should_open:
                self.trips += 1
                logger.warning(
                    "device circuit %s OPEN after %d consecutive launch "
                    "failure(s); refusing its work for %.1fs",
                    self.label,
                    self.consecutive_failures,
                    self.reset_timeout_s,
                )
                self._set_state(CIRCUIT_OPEN)
        if should_open and self.on_trip is not None:
            try:
                self.on_trip(self)
            except Exception:
                logger.exception("circuit on_trip observer failed")

    def _set_state(self, state: int) -> None:
        """Lock held.  Metrics are best-effort (no registry -> no-op)."""
        self.state = state
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.circuit_state.labels(circuit=self.label).set(state)
            GLOBAL_METRICS.circuit_transitions.labels(
                circuit=self.label, state=_CIRCUIT_STATE_NAMES[state]
            ).inc()


@dataclass
class _Submission:
    payload: object
    rows: int
    future: asyncio.Future
    loop: asyncio.AbstractEventLoop
    enqueued: float
    deadline: Optional[float]
    #: set by _finish (under the executor lock) so depth accounting is
    #: idempotent across the flush's normal/reject/exception paths
    finished: bool = False
    #: caller opted into device-resident out shares (accumulator store):
    #: the flush keeps the out-share matrix on device and hands back
    #: ResidentRefs instead of limb vectors
    retain: bool = False
    #: task identity (drivers pass the DAP task id): the per-task DRR
    #: accounting domain WITHIN a bucket — tasks sharing one VDAF shape
    #: share its bucket but not its quantum, so one hot task cannot
    #: starve its shape-mates.  None = unattributed (legacy callers).
    task: Optional[object] = None
    #: submitter's trace context (trace_id/task_id/job_id), captured at
    #: submit time so the flush can emit per-submission child spans — a
    #: job's merged timeline shows its share of each mega-batch flush
    trace_ctx: Optional[dict] = None


class _Bucket:
    """Pending submissions for one (shape_key, kind, agg_id)."""

    def __init__(
        self, key: tuple, backend, kind: str, agg_id: int, label: str, breaker=None
    ):
        self.key = key
        self.backend = backend
        self.kind = kind
        self.agg_id = agg_id
        self.label = label
        #: shared per-shape CircuitBreaker (None when breakers are off)
        self.breaker = breaker
        self.pending: List[_Submission] = []
        self.queued_rows = 0
        self.inflight_rows = 0
        self.timer: Optional[asyncio.TimerHandle] = None
        # plain-Python stats (usable without prometheus; bench reads these)
        self.flushes = 0
        self.flushed_rows = 0
        self.flushed_jobs = 0
        self.rejections = 0
        #: last submit/flush touch — retire_idle_buckets() reaps buckets
        #: idle past the threshold and removes their gauge label sets
        self.last_activity = time.monotonic()

    @property
    def depth_rows(self) -> int:
        return self.queued_rows + self.inflight_rows

    def mean_flush_rows(self) -> float:
        return self.flushed_rows / self.flushes if self.flushes else 0.0


def bucket_label(backend, kind: str, agg_id: int, shape_key: tuple = None, agg_param_key=None) -> str:
    """Compact metric label: circuit/aggregator-side/phase[/level].

    ``shape_key`` appends a stable digest so two parameterizations of the
    same circuit (e.g. Histogram length=4 vs length=1024) never share a
    label — stats() and the per-bucket gauges key on it.  ``agg_param_key``
    (Poplar1 passes its tree level) renders as an ``L{k}`` segment, so
    /statusz and the ``janus_executor_*`` series tell which level of a
    heavy-hitters run a bucket serves."""
    vdaf = getattr(backend, "vdaf", None)
    valid = getattr(getattr(vdaf, "flp", None), "valid", None)
    circuit = type(valid).__name__ if valid is not None else type(vdaf).__name__
    label = f"{circuit}/a{agg_id}/{kind}"
    if agg_param_key is not None:
        label += f"/L{agg_param_key}"
    if shape_key is not None:
        label += "#" + _shape_digest(shape_key)
    return label


def _shape_digest(shape_key: tuple) -> str:
    import zlib

    return "%06x" % (zlib.crc32(repr(shape_key).encode()) & 0xFFFFFF)


def shape_label(backend, shape_key: tuple) -> str:
    """Per-shape label (no kind/agg_id): the circuit breaker's identity."""
    vdaf = getattr(backend, "vdaf", None)
    valid = getattr(getattr(vdaf, "flp", None), "valid", None)
    circuit = type(valid).__name__ if valid is not None else type(vdaf).__name__
    return f"{circuit}#{_shape_digest(shape_key)}"


def breaker_domain(shape_key: tuple, backend):
    """The breaker's failure unit: the MESH for mesh backends (its device
    set, ``mesh_devices`` — one circuit a mesh, shared by every shape
    launching on it), the VDAF shape otherwise."""
    devices = getattr(backend, "mesh_devices", None)
    if devices is not None:
        return ("mesh", tuple(devices))
    return shape_key


def mesh_label(backend) -> str:
    """Per-mesh breaker label: the shard count and a stable digest of the
    device set."""
    devices = tuple(backend.mesh_devices)
    return "mesh[%d]#%s" % (len(devices), _shape_digest(devices))


class DeviceExecutor:
    """The continuous batcher.  One per process: its owner hands it to every
    driver and aggregator there (their configs' ``device_executor``)."""

    def __init__(self, config: Optional[ExecutorConfig] = None):
        self.config = config or ExecutorConfig()
        self._buckets: Dict[tuple, _Bucket] = {}
        self._backends: Dict[tuple, object] = {}
        #: canonical keys whose twin backend failed to build (negative
        #: cache: a job step or a request must not re-pay a doomed build)
        self.canonical_build_failed: set = set()
        #: breaker DOMAIN -> breaker.  The domain is the failure unit: the
        #: VDAF shape for one-card backends, the MESH for mesh backends
        #: (losing a card sickens every shape launching on that mesh, so
        #: they share one circuit)
        self._breakers: Dict[object, CircuitBreaker] = {}
        #: shape_key -> its domain's breaker (the circuit_open peek index)
        self._breaker_by_shape: Dict[tuple, CircuitBreaker] = {}
        #: domain -> shape_keys referencing it (retirement bookkeeping)
        self._breaker_shapes: Dict[object, set] = {}
        #: shape-bucket quarantine: shape_key -> quarantine expiry
        #: (monotonic).  While set, circuit_open() peeks True and submit()
        #: raises CircuitOpenError for the shape — callers refuse the work
        #: as retryable — WITHOUT the shared breaker tripping.
        self._quarantined_shapes: Dict[tuple, float] = {}
        #: shape_key -> consecutive non-injected launch-failure streak
        self._shape_fail_streak: Dict[tuple, int] = {}
        #: breaker domain -> (monotonic time, shape_key) of last success:
        #: the mesh-health witness the quarantine gate consults
        self._domain_last_success: Dict[object, tuple] = {}
        self._bucket_quarantines = 0
        self._lock = threading.Lock()
        self._stage_pool: Optional[ThreadPoolExecutor] = None
        self._launch_pool: Optional[ThreadPoolExecutor] = None
        #: one dedicated compile thread: warmups serialize (nvcc builds
        #: are CPU-heavy; two at once just slow each other down) and never
        #: touch the stage/launch pools that serve live traffic
        self._warmup_pool: Optional[ThreadPoolExecutor] = None
        #: shape_key -> {state: cold|warming|warm|failed, compile_s,
        #: error, future} — the per-shape compile ledger behind
        #: warming()/wait_warm()/compile_stats() (/statusz surfaces it)
        self._warmup_state: Dict[tuple, dict] = {}
        # Strong refs to in-flight flush tasks: the event loop holds tasks
        # weakly, and a GC'd flush would strand its detached submissions.
        self._flush_tasks: set = set()
        self._closed = False
        # Fair flush scheduler state: per-loop ready queues of detached
        # flushes, dispatched deficit-round-robin across buckets.
        self._ready: Dict[object, Dict[tuple, list]] = {}
        self._ready_seq = 0
        self._rr_cursor: Dict[object, int] = {}
        self._deficit: Dict[tuple, float] = {}
        #: per-(bucket, task) deficit tabs: fairness WITHIN a bucket, so
        #: tasks sharing one VDAF shape cannot starve each other (the
        #: bucket-level tab above keeps fairness ACROSS buckets)
        self._task_deficit: Dict[tuple, float] = {}
        self._dispatchers: Dict[object, object] = {}
        self._slots: Dict[object, asyncio.Semaphore] = {}
        #: dispatched-but-unfinished flushes per loop: the loop's slot
        #: semaphore may only be pruned when this reaches zero, or a new
        #: dispatcher generation would mint fresh permits and break the
        #: two-in-flight double-buffering bound
        self._slot_inflight: Dict[object, int] = {}
        #: per-flush black box (flight_recorder.py): /statusz "flights",
        #: breaker-trip dumps, slow-flush anomaly dumps
        self.flight_recorder = FlightRecorder(
            size=self.config.flight_recorder_size,
            slow_flush_p95_factor=self.config.slow_flush_p95_factor,
        )
        # Device-resident accumulator store (out-share residency).
        acc_cfg = self.config.accumulator
        self.accumulator = None
        #: durable spill target for shutdown(drain=True): called as
        #: sink(bucket_key, vector, journal_entries); registered by the
        #: component that can write the datastore (the job driver).  None
        #: means there is nowhere durable to spill — shutdown falls back
        #: to the logged discard (redelivery / journal replay re-derives).
        self._spill_sink = None
        if acc_cfg is not None and getattr(acc_cfg, "enabled", False):
            from .accumulator import DeviceAccumulatorStore

            self.accumulator = DeviceAccumulatorStore(acc_cfg)

    def set_spill_sink(self, sink) -> None:
        """Register the durable drain target used by shutdown(drain=True)
        (and any explicit drain_accumulator() call)."""
        self._spill_sink = sink

    # -- shape-keyed backend cache --------------------------------------
    def backend_for(self, shape_key: tuple, factory):
        """One backend instance (and its compiled graphs) per VDAF shape,
        shared across every driver in the process.  Newly created backends
        are warmed up (kernels built, one launch at the warmup batch) when
        configured.  With ``config.mesh`` set, one-card backends are
        upgraded to a MeshBackend over the process's cards before caching,
        so every producer's mega-batches shard across the cards."""
        created = False
        with self._lock:
            b = self._backends.get(shape_key)
            if b is None:
                b = factory()
                if self.config.mesh:
                    b = self._meshify(b)
                self._backends[shape_key] = b
                created = True
                if shape_key not in self._warmup_state:
                    self._warmup_state[shape_key] = {
                        "state": "cold",
                        "compile_s": None,
                        "error": None,
                        "future": None,
                        "since": time.monotonic(),
                    }
        if created and self.config.warmup_rows and hasattr(b, "stage_prep_init_multi"):
            self._schedule_warmup(shape_key, b)
        return b

    @staticmethod
    def _meshify(backend):
        """``device_executor.mesh: true`` — upgrade an exact-type
        CudaBackend to a MeshBackend over the cards of its process
        (``local_mesh(backend.device)``: every visible card, or the CPU
        device alone); mesh, oracle, hybrid and Poplar1 backends pass
        through.  The field layout, canonical mode and the one-shape rule
        carry over: the mesh runs the same per-shard prepares."""
        from ..vdaf.backend import CudaBackend, MeshBackend, local_mesh

        if type(backend) is not CudaBackend:
            return backend
        mesh = MeshBackend(
            backend.vdaf,
            devices=local_mesh(backend.device),
            canonical=backend.canonical,
            field_backend=backend.field_backend,
        )
        mesh.one_shape_exact = backend.one_shape_exact
        return mesh

    def prep_backend_for(self, vdaf, backend_name: str, device, exact_factory, field_backend=None):
        """(key, backend) a prepare of ``vdaf`` submits under, for the job
        drivers and the helper alike.  With ``canonical_shapes`` on, a card
        backend named and a task that canonicalizes (vdaf/canonical.py):
        its bucket's twin, ``make_backend(twin, backend_name,
        canonical=True, field_backend=)``, under the tagged key that every
        task of the bucket shares (the caller's ``field_backend``, as its
        ``exact_factory`` has).  Otherwise ``exact_factory()`` under the task's exact
        key.  The tagged key only ever holds a canonical card backend: a
        twin that fails to build is logged and remembered, and its tasks
        take their exact keys."""
        from ..vdaf.backend import device_supported, make_backend, vdaf_shape_key
        from ..vdaf.canonical import executor_shape

        key, twin = executor_shape(vdaf, enabled=self.config.canonical_shapes)
        if (
            twin is not None
            and backend_name != "oracle"
            and key not in self.canonical_build_failed
            and device_supported(vdaf)[0]
        ):
            try:
                return key, self.backend_for(
                    key,
                    lambda: make_backend(
                        twin, backend_name, device=device, canonical=True, field_backend=field_backend
                    ),
                )
            except Exception:
                self.canonical_build_failed.add(key)
                logger.exception("canonical twin %r failed to build; its tasks take their exact shapes", key)
        key = vdaf_shape_key(vdaf)
        return key, self.backend_for(key, exact_factory)

    def cached_backend(self, shape_key: tuple):
        """Peek the shape-keyed backend cache WITHOUT creating (commit
        paths must reuse exactly the backend whose launches minted their
        resident refs — buffer widths must match the retained matrices)."""
        with self._lock:
            return self._backends.get(shape_key)

    # -- background warmup ------------------------------------------------
    def _schedule_warmup(self, shape_key: tuple, backend) -> None:
        """Queue a warmup compile for a freshly created backend.  With
        ``warmup_async`` (the default) the compile runs on the dedicated
        warmup thread and backend_for returns immediately — producers see
        warming() True and wait_warm() until the executable lands.  A FAILED warmup only
        clears the warming flag: the bucket keeps working (the first live
        flush pays the compile, exactly the pre-warmup world) and the
        breaker is untouched — compile trouble is not device sickness."""
        state = self._warmup_state[shape_key]
        if not self.config.warmup_async:
            state.update(state="warming", since=time.monotonic())
            self._do_warmup(shape_key, backend)
            return
        with self._lock:
            if self._warmup_pool is None:
                if self._closed:
                    return
                self._warmup_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="janus-exec-warmup"
                )
            state.update(state="warming", since=time.monotonic())
            state["future"] = self._warmup_pool.submit(
                self._do_warmup, shape_key, backend
            )

    def _do_warmup(self, shape_key: tuple, backend) -> bool:
        from ..core.metrics import GLOBAL_METRICS
        from ..core.trace import trace_span

        state = self._warmup_state[shape_key]
        label = shape_label(backend, shape_key)
        t0 = time.monotonic()
        try:
            with trace_span(
                "compile",
                cat="executor",
                shape=label,
                rows=self.config.warmup_rows,
            ):
                n = self.warmup_backend(backend)
            dt = time.monotonic() - t0
            state.update(
                state="warm", compile_s=round(dt, 3), error=None,
                since=time.monotonic(),
            )
            outcome = "ok"
            if n:
                logger.info(
                    "warmed %d executable(s) for %s (%s) at %d rows in %.1fs",
                    n,
                    type(backend).__name__,
                    label,
                    self.config.warmup_rows,
                    dt,
                )
        except Exception as e:
            dt = time.monotonic() - t0
            state.update(
                state="failed", compile_s=round(dt, 3), error=str(e)[:200],
                since=time.monotonic(),
            )
            outcome = "error"
            logger.exception("executor warmup failed for %s (serving cold)", label)
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_warmups.labels(outcome=outcome).inc()
            if outcome == "ok":
                GLOBAL_METRICS.executor_compile_seconds.labels(shape=label).observe(dt)
        return outcome == "ok"

    def warming(self, shape_key: tuple) -> bool:
        """True while the shape's warmup compile is still in flight —
        producers wait_warm() before submitting (the breaker must never
        count compile-wait as a launch failure, and with this peek it
        never sees one)."""
        st = self._warmup_state.get(shape_key)
        return st is not None and st["state"] == "warming"

    def wait_warm(self, shape_key: tuple, timeout: Optional[float] = None) -> bool:
        """Block until the shape's warmup settles; True iff it is WARM.
        The compile-future face of the cold-task contract."""
        st = self._warmup_state.get(shape_key)
        if st is None:
            return False
        fut = st.get("future")
        if fut is not None:
            try:
                fut.result(timeout=timeout)
            except Exception:
                pass
        return st["state"] == "warm"

    def compile_stats(self) -> Dict[str, dict]:
        """Per-shape compile ledger for /statusz: cold (resolved, never
        warmed), warming, warm (last compile_s), or failed (error) — each
        with ``age_s``, the time the shape has sat in its current state
        (a warming age of minutes is a compile an operator should be
        watching; a warm age across a restart window proves the
        persistent cache paid off)."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for shape_key, st in self._warmup_state.items():
                b = self._backends.get(shape_key)
                label = (
                    shape_label(b, shape_key) if b is not None else repr(shape_key)
                )
                out[label] = {
                    "state": st["state"],
                    "compile_s": st["compile_s"],
                    "error": st["error"],
                    "age_s": round(now - st.get("since", now), 1),
                }
            return out

    # -- thread pools ----------------------------------------------------
    def _pools(self) -> Tuple[ThreadPoolExecutor, ThreadPoolExecutor]:
        # One staging + one launch thread: launches serialize on the chip
        # by design; staging of the next mega-batch overlaps the current
        # launch (double buffering).
        with self._lock:
            if self._stage_pool is None:
                self._stage_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="janus-exec-stage"
                )
                self._launch_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="janus-exec-launch"
                )
            return self._stage_pool, self._launch_pool

    # -- submission ------------------------------------------------------
    async def submit(
        self,
        shape_key: tuple,
        kind: str,
        payload,
        *,
        backend,
        agg_id: int = 0,
        deadline_s: Optional[float] = None,
        retain_out_shares: bool = False,
        task_ident: Optional[object] = None,
        agg_param_key: Optional[object] = None,
    ):
        """Enqueue prepare work; resolves when its mega-batch lands.

        kind=KIND_PREP_INIT: payload is (verify_key, report_rows) and the
        result is the per-row List[PrepOutcome].  kind=KIND_COMBINE:
        payload is the prep-share rows and the result is the per-row
        combine outcomes.  kind=KIND_POPLAR_INIT: payload is (verify_key,
        agg_param, report_rows) and the result is the per-row Poplar1
        (state, share) outcomes.  Raises ExecutorOverloadedError on
        backpressure.  ``task_ident`` attributes the rows to a task for
        the per-task fairness quota within the bucket (None =
        unattributed).  ``agg_param_key`` is the opaque agg-param bucket
        discriminant (None for parameter-less VDAFs; Poplar1 passes the
        tree level): submissions coalesce only within one value, so two
        rounds of one task never share a mega-batch, while different jobs
        at one level do.
        """
        if kind == KIND_PREP_INIT:
            rows = len(payload[1])
        elif kind == KIND_COMBINE:
            rows = len(payload)
        elif kind == KIND_POPLAR_INIT:
            rows = len(payload[2])
        else:
            raise ValueError(f"unknown submission kind {kind!r}")
        if rows == 0:
            return []
        if self._closed:
            raise ExecutorOverloadedError("executor is shut down")
        breaker = self._breaker_for(shape_key, backend)
        if breaker is not None and not breaker.allow():
            raise CircuitOpenError(
                f"device circuit {breaker.label} is open after "
                f"{breaker.consecutive_failures} consecutive launch failure(s)"
            )
        if self._bucket_quarantined(shape_key):
            # the same caller-visible contract as an open circuit (a
            # retryable refusal), scoped to this one shape: the rest of
            # the mesh keeps launching
            raise CircuitOpenError(
                f"shape bucket #{_shape_digest(shape_key)} is quarantined after "
                f"repeated launch failures of its own"
            )
        loop = asyncio.get_running_loop()
        now = time.monotonic()
        timeout = self.config.submit_timeout_s if deadline_s is None else deadline_s
        key = (shape_key, kind, agg_id, agg_param_key)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = _Bucket(
                    key,
                    backend,
                    kind,
                    agg_id,
                    bucket_label(backend, kind, agg_id, shape_key, agg_param_key),
                    breaker=breaker,
                )
                self._buckets[key] = bucket
            # Backpressure bounds the QUEUE, not the job: a submission
            # larger than the bound is still admitted when nothing is
            # ahead of it (the legacy per-job path handled any size, so
            # rejecting it here would fail the job on every retry).
            if bucket.depth_rows and bucket.depth_rows + rows > self.config.max_queue_rows:
                bucket.rejections += 1
                self._observe_rejection(bucket, "queue_full")
                costs.cost_model().observe_rows(task_ident, "rejected", rows)
                raise ExecutorOverloadedError(
                    f"bucket {bucket.label}: {bucket.depth_rows} rows queued/"
                    f"in flight, +{rows} exceeds max_queue_rows="
                    f"{self.config.max_queue_rows}"
                )
            sub = _Submission(
                payload=payload,
                rows=rows,
                future=loop.create_future(),
                loop=loop,
                enqueued=now,
                # <= 0 disables the deadline (documented in config.py)
                deadline=now + timeout if timeout and timeout > 0 else None,
                retain=retain_out_shares and self.accumulator is not None,
                task=task_ident,
                trace_ctx=current_trace() or None,
            )
            bucket.last_activity = now
            bucket.pending.append(sub)
            bucket.queued_rows += rows
            self._observe_depth(bucket)
            if bucket.queued_rows >= self.config.flush_max_rows:
                subs = self._take_pending(bucket)
            else:
                subs = None
                if bucket.timer is None:
                    bucket.timer = loop.call_later(
                        self.config.flush_window_s,
                        lambda: self._spawn(self._deadline_flush(bucket)),
                    )
        if subs:
            self._enqueue_ready(bucket, subs, trigger="size")
        return await sub.future

    def _breaker_for(self, shape_key: tuple, backend) -> Optional[CircuitBreaker]:
        """One CircuitBreaker per failure DOMAIN (None when disabled).  A
        one-card backend fails per VDAF shape (a bad build or an OOM is
        shape-local), so its domain is the shape: every bucket of it —
        both aggregator sides, both kinds — shares the verdict.  A mesh
        backend fails per MESH (a lost card sickens every shape launching
        on it), so every shape on one mesh shares one breaker: a
        ``backend.device_lost`` trip opens the circuit for all of them at
        once, and their work is refused as retryable until the probe heals
        the mesh."""
        if self.config.breaker_failure_threshold <= 0:
            return None
        domain = breaker_domain(shape_key, backend)
        with self._lock:
            br = self._breakers.get(domain)
            if br is None:
                br = CircuitBreaker(
                    (
                        mesh_label(backend)
                        if getattr(backend, "mesh_devices", None) is not None
                        else shape_label(backend, shape_key)
                    ),
                    self.config.breaker_failure_threshold,
                    self.config.breaker_reset_timeout_s,
                    # black box on trip: the ring of recent flushes ships
                    # with the failure as one structured log event
                    on_trip=lambda b: self.flight_recorder.dump(
                        "breaker_trip",
                        detail={
                            "circuit": b.label,
                            "consecutive_failures": b.consecutive_failures,
                            "trips": b.trips,
                        },
                    ),
                )
                self._breakers[domain] = br
            self._breaker_by_shape[shape_key] = br
            self._breaker_shapes.setdefault(domain, set()).add(shape_key)
            return br

    def _spawn(self, coro) -> None:
        """Schedule a flush coroutine, keeping a strong reference until done."""
        task = asyncio.ensure_future(coro)
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    def _take_pending(self, bucket: _Bucket) -> List[_Submission]:
        """Detach the bucket's pending set for a flush.  Lock held."""
        subs, bucket.pending = bucket.pending, []
        bucket.queued_rows = 0
        for s in subs:
            bucket.inflight_rows += s.rows
        if bucket.timer is not None:
            bucket.timer.cancel()
            bucket.timer = None
        return subs

    async def _deadline_flush(self, bucket: _Bucket) -> None:
        with self._lock:
            bucket.timer = None
            subs = self._take_pending(bucket)
        if subs:
            self._enqueue_ready(bucket, subs, trigger="deadline")

    # -- fair flush scheduling -------------------------------------------
    def _enqueue_ready(self, bucket: _Bucket, subs: List[_Submission], trigger: str):
        """Queue a detached flush for dispatch.  The dispatcher serves
        ready flushes deficit-round-robin ACROSS buckets (one hot bucket
        cannot monopolize the chip) and deadline-earliest WITHIN a bucket;
        a per-loop two-slot semaphore keeps stage k+1 overlapping launch k
        (the double buffering the FIFO path had)."""
        loop = asyncio.get_running_loop()
        min_deadline = min(
            (s.deadline for s in subs if s.deadline is not None), default=float("inf")
        )
        with self._lock:
            ready = self._ready.setdefault(loop, {})
            self._ready_seq += 1
            ready.setdefault(bucket.key, []).append(
                (min_deadline, self._ready_seq, bucket, subs, trigger)
            )
            if loop in self._dispatchers:
                return
            task = asyncio.ensure_future(self._dispatch_loop())
            self._dispatchers[loop] = task
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    def _pick_next_locked(self, loop):
        """Next ready flush for this loop.  Lock held."""
        ready = self._ready.get(loop)
        if not ready:
            return None
        if not self.config.fair_flush:
            # true legacy FIFO: globally arrival-ordered across buckets
            # (serving dict-first would let a busy first bucket starve the
            # rest, which arrival order never did)
            key = min(ready, key=lambda k: min(e[1] for e in ready[k]))
            entries = ready[key]
            entries.sort(key=lambda e: e[1])
            entry = entries.pop(0)
            if not entries:
                del ready[key]
            if not ready:
                del self._ready[loop]
            return entry[2], entry[3], entry[4]
        quota = max(1, self.config.fair_quota_rows)
        keys = list(ready.keys())
        cursor = self._rr_cursor.get(loop, 0) % len(keys)
        for final_pass in (False, True):
            for i in range(len(keys)):
                key = keys[(cursor + i) % len(keys)]
                entries = ready.get(key)
                if not entries:
                    continue
                entries.sort(key=lambda e: (e[0], e[1]))  # deadline-earliest
                j, task_refill = self._pick_entry_locked(key, entries, quota)
                rows = sum(s.rows for s in entries[j][3])
                # a bucket in deficit debt yields its turn — unless every
                # bucket is in debt, in which case the round refills below
                # and the earliest-cursor bucket proceeds (progress
                # guarantee; the overshoot stays on its tab)
                if final_pass or self._deficit.get(key, quota) >= min(rows, quota):
                    if task_refill:
                        # every entry's tasks are in per-task debt: refill
                        # the bucket's task tabs — only here, at DISPATCH
                        # (a refill on a merely CONSIDERED bucket that the
                        # bucket-level gate then skips would erase a hot
                        # task's debt without any cold task progressing)
                        for e in entries:
                            for s in e[3]:
                                tk = (key, s.task)
                                self._task_deficit[tk] = min(
                                    quota, self._task_deficit.get(tk, 0) + quota
                                )
                    entry = entries.pop(j)
                    if not entries:
                        del ready[key]
                    if not ready:
                        del self._ready[loop]
                    self._deficit[key] = self._deficit.get(key, quota) - rows
                    for s in entry[3]:  # per-task tabs within the bucket
                        tk = (key, s.task)
                        self._task_deficit[tk] = (
                            self._task_deficit.get(tk, quota) - s.rows
                        )
                    self._rr_cursor[loop] = (cursor + i + 1) % len(keys)
                    return entry[2], entry[3], entry[4]
            for k in keys:  # full round found only debtors: refill
                self._deficit[k] = min(quota, self._deficit.get(k, 0) + quota)
        return None

    def _pick_entry_locked(self, key, entries, quota):
        """WITHIN one bucket: deadline-earliest, except that an entry whose
        tasks are all in per-task deficit debt yields to the first entry of
        a task still holding quota — tasks sharing one VDAF shape share its
        bucket but not its quantum, so a task flooding the bucket with
        ready flushes cannot starve its shape-mates.  ``entries`` is
        pre-sorted (deadline, seq); returns ``(chosen index,
        task_refill)``.  PURE — when every entry's tasks are in debt it
        picks the earliest entry (progress guarantee) and signals
        ``task_refill=True`` so the caller refills the bucket's
        task tabs at dispatch time, never on a bucket the bucket-level
        deficit gate then skips."""
        if len(entries) == 1:
            return 0, False
        for j, e in enumerate(entries):
            subs = e[3]
            rows = sum(s.rows for s in subs)
            credit = min(
                self._task_deficit.get((key, s.task), quota) for s in subs
            )
            if credit >= min(rows, quota):
                return j, False
        return 0, True

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        me = asyncio.current_task()
        with self._lock:
            sem = self._slots.get(loop)
            if sem is None:
                # two slots: one flush staging while the previous launches
                sem = self._slots[loop] = asyncio.Semaphore(2)
        try:
            while True:
                # slot FIRST, then pick: choosing a flush before a slot is
                # free would pin the scheduling decision while later (and
                # possibly more urgent) buckets become ready
                await sem.acquire()
                with self._lock:
                    item = self._pick_next_locked(loop)
                    if item is None:
                        # exit + deregister atomically: an enqueue that saw
                        # this dispatcher alive must not strand its entry
                        if self._dispatchers.get(loop) is me:
                            del self._dispatchers[loop]
                            self._rr_cursor.pop(loop, None)
                            # the semaphore may only be pruned once no
                            # dispatched flush still holds a permit — a
                            # successor generation must inherit it, not
                            # mint two fresh slots on top of in-flight work
                            if not self._slot_inflight.get(loop):
                                self._slots.pop(loop, None)
                                self._slot_inflight.pop(loop, None)
                        sem.release()
                        return
                    self._slot_inflight[loop] = (
                        self._slot_inflight.get(loop, 0) + 1
                    )
                bucket, subs, trigger = item
                task = asyncio.ensure_future(self._run_flush(bucket, subs, trigger))
                self._flush_tasks.add(task)

                def _done(t, sem=sem, loop=loop):
                    self._flush_tasks.discard(t)
                    with self._lock:
                        left = self._slot_inflight.get(loop, 1) - 1
                        self._slot_inflight[loop] = left
                        if left <= 0 and loop not in self._dispatchers:
                            self._slots.pop(loop, None)
                            self._slot_inflight.pop(loop, None)
                    sem.release()

                task.add_done_callback(_done)
        finally:
            with self._lock:
                # identity check: never unseat a successor dispatcher that
                # registered after this one deregistered itself
                if self._dispatchers.get(loop) is me:
                    del self._dispatchers[loop]

    async def drain(self) -> None:
        """Flush every pending bucket now and wait for results to settle
        (shutdown / end-of-bench barrier) — including flush tasks that
        were already in flight when drain was called."""
        flushes = []
        loop = asyncio.get_running_loop()
        with self._lock:
            # ready-but-undispatched flushes for THIS loop drain directly
            for entries in self._ready.pop(loop, {}).values():
                for _dl, _seq, bucket, subs, _trigger in entries:
                    flushes.append((bucket, subs))
            for bucket in self._buckets.values():
                subs = self._take_pending(bucket)
                if subs:
                    flushes.append((bucket, subs))
        inflight = [t for t in self._flush_tasks if t.get_loop() is loop]
        # cross-loop submissions resolve via call_soon_threadsafe on their
        # own loop; gather here only what belongs to this one
        waiters = [
            s.future for _, subs in flushes for s in subs if s.loop is loop
        ]
        for bucket, subs in flushes:
            await self._run_flush(bucket, subs, trigger="drain")
        if inflight:
            await asyncio.gather(*inflight, return_exceptions=True)
        if waiters:
            await asyncio.gather(*waiters, return_exceptions=True)

    # -- the flush -------------------------------------------------------
    async def _run_flush(
        self, bucket: _Bucket, subs: List[_Submission], trigger: str
    ) -> None:
        from ..core.trace import trace_span

        loop = asyncio.get_running_loop()
        live = self._reject_expired(bucket, subs)
        if not live:
            if bucket.breaker is not None:
                bucket.breaker.probe_aborted()
            return
        rows = sum(s.rows for s in live)
        # Per-submission queue delay (enqueue -> flush dispatch): the
        # ReportWriteBatcher 3-tuple pattern — _Submission carries its
        # enqueue stamp, so the delay is measured here where dispatch
        # actually happens, per submission, not once per flush.
        t_dispatch = time.monotonic()
        queue_delay_max = 0.0
        model = costs.cost_model()
        for s in live:
            delay = max(0.0, t_dispatch - s.enqueued)
            queue_delay_max = max(queue_delay_max, delay)
            model.observe_queue_delay(s.task, delay)
        stage_s = 0.0
        padded_rows = 0
        t_launch = t_dispatch
        #: set the moment the launch is known-good (record_success):
        #: an exception AFTER it (resolve bookkeeping, ref release) must
        #: not re-attribute the measured durations, re-record the flight,
        #: or count a launch failure against a healthy device
        launch_ok = False
        stage_pool, launch_pool = self._pools()
        retain = None
        try:
            # Failure-domain boundary: an injected flush fault is a launch
            # failure to every job in the mega-batch — and to the breaker.
            await faults.fire_async("executor.flush")
            with trace_span(
                "executor_flush",
                cat="executor",
                bucket=bucket.label,
                rows=rows,
                jobs=len(live),
                trigger=trigger,
            ):
                if bucket.kind == KIND_PREP_INIT:
                    requests = [s.payload for s in live]
                    # Device-resident out shares: engaged only when EVERY
                    # submission in the mega-batch opted in (a mixed batch
                    # must not hand ResidentRefs to a caller expecting limb
                    # vectors) and the backend supports retention.
                    if (
                        self.accumulator is not None
                        and all(s.retain for s in live)
                        and getattr(
                            bucket.backend, "supports_resident_out_shares", False
                        )
                    ):
                        retain = self.accumulator
                    t_stage = time.monotonic()
                    staged = await loop.run_in_executor(
                        stage_pool,
                        lambda: bucket.backend.stage_prep_init_multi(
                            bucket.agg_id, requests
                        ),
                    )
                    t_launch = time.monotonic()
                    stage_s = t_launch - t_stage
                    # pad waste: rows the launch computes and masks away
                    # (pow2 padding) — invisible on flush_rows, counted here
                    pad_to = getattr(staged, "pad_to", None)
                    if pad_to is not None:
                        padded_rows = max(0, pad_to - rows)

                    def launch():
                        # Deadline re-check AFTER the launch-queue wait —
                        # that queue (one flush at a time on the chip) is
                        # where overload actually parks submissions.  If
                        # every submission expired, skip the device work
                        # entirely; a mixed batch launches as staged
                        # (padding already covers the expired rows).
                        if staged is None:
                            return [[] for _ in live], live
                        still = self._reject_expired(bucket, live)
                        if not still:
                            return None, []
                        if retain is not None:
                            return (
                                bucket.backend.launch_prep_init_multi(
                                    staged, requests, retain_store=retain
                                ),
                                still,
                            )
                        return (
                            bucket.backend.launch_prep_init_multi(
                                staged, requests
                            ),
                            still,
                        )

                    outs, still = await loop.run_in_executor(launch_pool, launch)
                elif bucket.kind == KIND_POPLAR_INIT:
                    # Poplar1 mega-batch: every submission's (verify_key,
                    # agg_param, reports) payload IS a request row for the
                    # multi-request walk — submissions sharing an agg param
                    # (different jobs, one level) run as ONE walk + ONE
                    # sketch pass with per-row verify keys.  The walk is the
                    # STAGE half and the sketch the LAUNCH half, on the same
                    # stage/launch threads as prep_init, so flush k+1's walk
                    # overlaps flush k's sketch (expired-at-launch rows pay
                    # the walk, the price of the overlap; their refs release
                    # in the resolution loop).  Sketch vectors kept on the
                    # device: when every submission opted in, the
                    # accumulator store adopts the flush's y matrices and
                    # states carry ResidentRefs.
                    if self.accumulator is not None and all(s.retain for s in live):
                        retain = self.accumulator
                    t_stage = time.monotonic()
                    staged = await loop.run_in_executor(
                        stage_pool,
                        lambda: bucket.backend.stage_poplar_init_multi(bucket.agg_id, [s.payload for s in live]),
                    )
                    t_launch = time.monotonic()
                    stage_s = t_launch - t_stage

                    def launch():
                        still = self._reject_expired(bucket, live)
                        if not still:
                            return None, []
                        if retain is not None:
                            return bucket.backend.launch_poplar_init_multi(staged, retain_store=retain), still
                        return bucket.backend.launch_poplar_init_multi(staged), still

                    outs, still = await loop.run_in_executor(launch_pool, launch)
                else:  # KIND_COMBINE: concatenate rows, launch once, slice
                    concat = [row for s in live for row in s.payload]
                    t_launch = time.monotonic()

                    def launch():
                        still = self._reject_expired(bucket, live)
                        if not still:
                            return None, []
                        flat = bucket.backend.prep_shares_to_prep_batch(concat)
                        outs, start = [], 0
                        for s in live:
                            outs.append(flat[start : start + s.rows])
                            start += s.rows
                        return outs, still

                    outs, still = await loop.run_in_executor(launch_pool, launch)
            if outs is None:
                if bucket.breaker is not None:
                    bucket.breaker.probe_aborted()
                # every submission expired at the launch dequeue: nothing
                # touched the device, but the black box still records it
                self.flight_recorder.record(
                    bucket=bucket.label,
                    trigger=trigger,
                    rows=rows,
                    padded_rows=padded_rows,
                    tasks=[model.label_for(s.task) for s in live],
                    queue_delay_max_s=queue_delay_max,
                    stage_s=stage_s,
                    launch_s=0.0,
                    outcome="expired",
                    breaker_state=self._breaker_state_name(bucket),
                    fault=False,
                )
                return
            if bucket.breaker is not None:
                bucket.breaker.record_success()
            self._note_launch_success(bucket)
            launch_ok = True
            done = time.monotonic()
            launch_s = done - t_launch
            bucket.flushes += 1
            bucket.flushed_rows += rows
            bucket.flushed_jobs += len(live)
            self._observe_flush(bucket, rows, launch_s)
            self._observe_pad(bucket, padded_rows)
            # Per-task cost attribution: split the measured
            # stage/launch durations across the flush's submissions
            # proportionally by rows.  Conservation: the per-task shares
            # sum to the measured totals; padding overhead rides with the
            # rows that caused it.
            model.attribute_flush(
                [(s.task, s.rows) for s in live],
                {"stage": stage_s, "launch": launch_s},
                path="device",
            )
            still_set = set(id(s) for s in still)
            for s, out in zip(live, outs):
                if id(s) not in still_set:
                    # rejected at launch dequeue: its result is dropped, so
                    # any ResidentRefs minted for its rows must be released
                    # or the retained flush matrix never frees
                    if retain is not None and out:
                        self._release_dropped_refs(retain, out)
                    continue
                self._finish(bucket, s, done)
                self._observe_wait(bucket, done - s.enqueued)
                model.observe_rows(s.task, "ok", s.rows)
                # Per-submission CHILD span, stamped with the SUBMITTER's
                # trace context: one job's merged Perfetto timeline shows
                # its share of each mega-batch flush (rows of flush_rows),
                # not just an anonymous executor_flush it cannot claim.
                emit_span(
                    "flush_share",
                    "executor",
                    t_launch,
                    launch_s,
                    bucket=bucket.label,
                    rows=s.rows,
                    flush_rows=rows,
                    trigger=trigger,
                    **(s.trace_ctx or {}),
                )
                self._resolve(s, result=out)
            self.flight_recorder.record(
                bucket=bucket.label,
                trigger=trigger,
                rows=rows,
                padded_rows=padded_rows,
                tasks=[model.label_for(s.task) for s in live],
                queue_delay_max_s=queue_delay_max,
                stage_s=stage_s,
                launch_s=launch_s,
                outcome="ok",
                breaker_state=self._breaker_state_name(bucket),
                fault=False,
            )
        except Exception as e:  # surface the launch failure to every job
            done = time.monotonic()
            if (
                not launch_ok
                and self.config.bisection_enabled
                and not isinstance(e, faults.FaultInjectedError)
                and bucket.kind in (KIND_PREP_INIT, KIND_COMBINE)
                and rows >= 2
            ):
                # Batch-level failure that is NOT an injected transient:
                # sieve the cohort for poison rows before condemning the
                # whole flush (and the device) for one bad report.  An
                # injected fault takes the legacy path — chaos soaks
                # assert transient faults heal via retry/breaker, and
                # bisecting them would quarantine healthy reports.
                if await self._bisect_failed_flush(
                    bucket,
                    live,
                    e,
                    trigger,
                    rows,
                    padded_rows,
                    queue_delay_max,
                    model,
                    stage_s,
                    t_launch,
                ):
                    return
                done = time.monotonic()
            if not launch_ok:
                launch_s = max(0.0, done - t_launch)
                # attribute whatever the chip DID spend before failing,
                # then record the flight BEFORE the breaker verdict so a
                # trip's ring dump includes this failing flush.  Error
                # rows count only submissions not already accounted (a
                # launch-dequeue rejection was counted "rejected"; the
                # success loop counted resolved rows "ok").
                model.attribute_flush(
                    [(s.task, s.rows) for s in live],
                    {"stage": stage_s, "launch": launch_s},
                    path="device",
                )
                for s in live:
                    if not s.finished:
                        model.observe_rows(s.task, "error", s.rows)
                self.flight_recorder.record(
                    bucket=bucket.label,
                    trigger=trigger,
                    rows=rows,
                    padded_rows=padded_rows,
                    tasks=[model.label_for(s.task) for s in live],
                    queue_delay_max_s=queue_delay_max,
                    stage_s=stage_s,
                    launch_s=launch_s,
                    outcome="error",
                    breaker_state=self._breaker_state_name(bucket),
                    fault=isinstance(e, faults.FaultInjectedError),
                    error=e,
                )
                self._record_flush_failure(bucket, e)
            else:
                logger.exception(
                    "flush bookkeeping failed after a successful launch "
                    "(bucket %s); unresolved submissions get the error",
                    bucket.label,
                )
            for s in live:
                self._finish(bucket, s, done)
                self._resolve(s, exc=e)

    async def _bisect_failed_flush(
        self,
        bucket: _Bucket,
        live: List[_Submission],
        exc: Exception,
        trigger: str,
        rows: int,
        padded_rows: int,
        queue_delay_max: float,
        model,
        stage_s: float,
        t_launch: float,
    ) -> bool:
        """Sieve a failed mega-batch for poison rows.

        Runs the cohort through ``quarantine.bisect_batch`` on the launch
        pool: the full cohort is retried once (an absorbed transient costs
        one extra pass and quarantines nothing), then failing halves split
        until the poison row(s) are isolated within the per-report budget.
        Healthy rows resolve with their real results and the breaker
        records a SUCCESS (the device demonstrably works); offenders get
        in-band VdafError outcomes — the exact value drivers already map
        to PrepareError.VDAF_PREP_ERROR — and land in the quarantine
        ledger under their report identity.

        Returns False (caller runs the legacy fail-all path) when every
        singleton failed — that is the PASS failing, not a poison row —
        or when the sieve itself errored.  Bisection retries never pass
        ``retain_store``: retried rows return host vectors, which every
        caller already handles (mixed batches fall back the same way).
        """
        from ..core import quarantine

        items: List[tuple] = []
        if bucket.kind == KIND_PREP_INIT:
            for si, s in enumerate(live):
                for row in s.payload[1]:
                    items.append((si, row))

            def attempt(subset):
                by_sub: Dict[int, list] = {}
                for si, row in subset:
                    by_sub.setdefault(si, []).append(row)
                # keep the payload's tail (a canonical backend's request
                # carries the task's VDAF as its third element)
                reqs = [(live[si].payload[0], by_sub[si]) + tuple(live[si].payload[2:]) for si in sorted(by_sub)]
                staged = bucket.backend.stage_prep_init_multi(bucket.agg_id, reqs)
                outs = bucket.backend.launch_prep_init_multi(staged, reqs)
                return [o for per_req in outs for o in per_req]

        else:  # KIND_COMBINE
            for si, s in enumerate(live):
                for row in s.payload:
                    items.append((si, row))

            def attempt(subset):
                return bucket.backend.prep_shares_to_prep_batch(
                    [row for _si, row in subset]
                )

        loop = asyncio.get_running_loop()
        _, launch_pool = self._pools()
        try:
            outcome = await loop.run_in_executor(
                launch_pool,
                lambda: quarantine.bisect_batch(
                    items, attempt, self.config.bisection_per_item_budget
                ),
            )
        except Exception:
            logger.exception("bisection sieve failed (bucket %s)", bucket.label)
            return False
        quarantine.note_bisection()
        if outcome.offenders and not outcome.attributable:
            # every singleton failed: the pass is broken (device lost, bad
            # build) — not poison.  Legacy path: fail-all + breaker (or
            # bucket quarantine when the rest of the domain is healthy).
            return False

        from ..vdaf.prio3 import VdafError

        stage = "prep_init" if bucket.kind == KIND_PREP_INIT else "combine"
        poisoned: Dict[int, VdafError] = {}
        for idx, err in outcome.offenders:
            si, row = items[idx]
            report_id = None
            if (
                bucket.kind == KIND_PREP_INIT
                and isinstance(row, tuple)
                and row
                and isinstance(row[0], (bytes, bytearray))
            ):
                report_id = bytes(row[0])
            task = live[si].task
            quarantine.record(
                stage,
                task=(
                    task.hex()
                    if isinstance(task, (bytes, bytearray))
                    else (str(task) if task is not None else None)
                ),
                report_id=report_id,
                error=err,
                payload=row,
            )
            poisoned[idx] = VdafError(
                f"row quarantined by batch bisection: {type(err).__name__}"
            )

        per_sub: List[list] = [[] for _ in live]
        for idx, (si, _row) in enumerate(items):
            if idx in poisoned:
                per_sub[si].append(poisoned[idx])
            else:
                per_sub[si].append(outcome.results[idx])

        done = time.monotonic()
        launch_s = max(0.0, done - t_launch)
        if bucket.breaker is not None:
            # the sieve proved the device healthy — a poison row must
            # never trip the circuit
            bucket.breaker.record_success()
        self._note_launch_success(bucket)
        bucket.flushes += 1
        bucket.flushed_rows += rows
        bucket.flushed_jobs += len(live)
        self._observe_flush(bucket, rows, launch_s)
        self._observe_pad(bucket, padded_rows)
        model.attribute_flush(
            [(s.task, s.rows) for s in live],
            {"stage": stage_s, "launch": launch_s},
            path="device",
        )
        offender_rows: Dict[int, int] = {}
        for idx in poisoned:
            si = items[idx][0]
            offender_rows[si] = offender_rows.get(si, 0) + 1
        for si, s in enumerate(live):
            bad = offender_rows.get(si, 0)
            if s.rows - bad:
                model.observe_rows(s.task, "ok", s.rows - bad)
            if bad:
                model.observe_rows(s.task, "error", bad)
            self._finish(bucket, s, done)
            self._observe_wait(bucket, done - s.enqueued)
            self._resolve(s, result=per_sub[si])
        self.flight_recorder.record(
            bucket=bucket.label,
            trigger=trigger,
            rows=rows,
            padded_rows=padded_rows,
            tasks=[model.label_for(s.task) for s in live],
            queue_delay_max_s=queue_delay_max,
            stage_s=stage_s,
            launch_s=launch_s,
            outcome="bisected",
            breaker_state=self._breaker_state_name(bucket),
            fault=False,
            error=exc,
        )
        logger.warning(
            "bisected failed flush (bucket %s): %d/%d row(s) quarantined "
            "in %d attempt(s)%s",
            bucket.label,
            len(outcome.offenders),
            len(items),
            outcome.attempts,
            " [budget exhausted]" if outcome.exhausted else "",
        )
        return True

    def _note_launch_success(self, bucket: _Bucket) -> None:
        """A launch landed: clear the shape's failure streak and stamp its
        breaker domain's health witness (the quarantine gate's evidence
        that the mesh itself works)."""
        shape_key = bucket.key[0]
        with self._lock:
            self._shape_fail_streak.pop(shape_key, None)
            self._quarantined_shapes.pop(shape_key, None)
            domain = breaker_domain(shape_key, bucket.backend)
            self._domain_last_success[domain] = (time.monotonic(), shape_key)

    def _record_flush_failure(self, bucket: _Bucket, exc: Exception) -> None:
        """Count a launch failure.  Usually against the breaker — but
        repeated NON-injected failures confined to ONE shape while another
        shape on the same breaker domain stays demonstrably healthy
        quarantine that shape bucket instead: a shape-local failure (a bad
        build, a pathological input shape) must not open the mesh-wide
        circuit and refuse every healthy shape's work with it."""
        shape_key = bucket.key[0]
        if self.config.bucket_quarantine_threshold > 0 and not isinstance(exc, faults.FaultInjectedError):
            now = time.monotonic()
            quarantined = False
            with self._lock:
                streak = self._shape_fail_streak.get(shape_key, 0) + 1
                self._shape_fail_streak[shape_key] = streak
                last = self._domain_last_success.get(breaker_domain(shape_key, bucket.backend))
                domain_healthy = (
                    last is not None
                    and last[1] != shape_key
                    and now - last[0] <= self.config.bucket_quarantine_success_window_s
                )
                if streak >= self.config.bucket_quarantine_threshold and domain_healthy:
                    self._quarantined_shapes[shape_key] = now + self.config.bucket_quarantine_s
                    self._bucket_quarantines += 1
                    quarantined = True
            if quarantined:
                from ..core import quarantine

                quarantine.record("bucket", task=bucket.label, error=exc, durable=False)
                logger.warning(
                    "quarantined shape bucket %s for %.0fs after %d shape-local failure(s): "
                    "its work is refused as retryable; breaker %s stays closed",
                    bucket.label,
                    self.config.bucket_quarantine_s,
                    streak,
                    bucket.breaker.label if bucket.breaker else "<none>",
                )
                return
        if bucket.breaker is not None:
            bucket.breaker.record_failure()

    def _bucket_quarantined(self, shape_key: tuple) -> bool:
        """Is the shape bucket inside its quarantine dwell?  Expired
        entries are reaped on the way out (the next submission runs on the
        device and a success clears the streak)."""
        now = time.monotonic()
        with self._lock:
            exp = self._quarantined_shapes.get(shape_key)
            if exp is None:
                return False
            if now >= exp:
                del self._quarantined_shapes[shape_key]
                return False
            return True

    def bucket_quarantine_stats(self) -> dict:
        """The /statusz face of the shape-bucket quarantine: the total
        quarantines, each quarantined shape's seconds left, and the
        failure streaks feeding the gate."""
        now = time.monotonic()
        with self._lock:
            return {
                "total": self._bucket_quarantines,
                "quarantined": {
                    f"#{_shape_digest(k)}": round(max(0.0, exp - now), 2) for k, exp in self._quarantined_shapes.items()
                },
                "fail_streaks": {f"#{_shape_digest(k)}": v for k, v in self._shape_fail_streak.items()},
            }

    @staticmethod
    def _release_dropped_refs(store, outcomes) -> None:
        """Release the ResidentRefs inside a dropped submission's prepare
        outcomes (each is (state, share) or a VdafError).  Prio3 states
        carry the ref as ``out_share``; Poplar1 states as ``y_flat``."""
        from .accumulator import ResidentRef

        refs = []
        for o in outcomes:
            if not isinstance(o, tuple) or not o:
                continue
            ref = getattr(o[0], "out_share", None)
            if not isinstance(ref, ResidentRef):
                ref = getattr(o[0], "y_flat", None)
            if isinstance(ref, ResidentRef):
                refs.append(ref)
        if refs:
            store.release_refs(refs)

    @staticmethod
    def _breaker_state_name(bucket: _Bucket) -> Optional[str]:
        """The bucket's breaker state at record time (flight recorder
        field); None when breakers are disabled."""
        if bucket.breaker is None:
            return None
        return _CIRCUIT_STATE_NAMES.get(bucket.breaker.state)

    def _reject_expired(self, bucket: _Bucket, subs: List[_Submission]):
        """Reject (retryably) every submission whose deadline has passed;
        returns the still-live remainder.  Called when a flush starts and
        again when it reaches the launch thread — the launch queue is
        where submissions wait under chip overload."""
        now = time.monotonic()
        live: List[_Submission] = []
        for s in subs:
            if s.deadline is None or now <= s.deadline:
                live.append(s)
                continue
            self._finish(bucket, s, now)
            bucket.rejections += 1
            self._observe_rejection(bucket, "deadline")
            costs.cost_model().observe_rows(s.task, "rejected", s.rows)
            self._resolve(
                s,
                exc=ExecutorOverloadedError(
                    f"bucket {bucket.label}: queued past its "
                    f"{s.deadline - s.enqueued:.3f}s deadline"
                ),
            )
        return live

    def _finish(self, bucket: _Bucket, s: _Submission, now: float) -> None:
        with self._lock:
            if s.finished:
                return
            s.finished = True
            bucket.last_activity = now
            bucket.inflight_rows -= s.rows
            self._observe_depth(bucket)

    @staticmethod
    def _resolve(s: _Submission, result=None, exc: Optional[Exception] = None):
        """Complete a submission future on ITS loop (cross-loop safe)."""

        def do():
            if s.future.done():
                return
            if exc is not None:
                s.future.set_exception(exc)
            else:
                s.future.set_result(result)

        try:
            if s.loop is asyncio.get_running_loop():
                do()
                return
        except RuntimeError:
            pass
        try:
            s.loop.call_soon_threadsafe(do)
        except RuntimeError:  # submitter's loop already closed
            pass

    # -- warmup ----------------------------------------------------------
    def warmup_backend(self, backend, agg_ids=(0, 1), pad_to: Optional[int] = None) -> int:
        """Build the kernels and run one launch per side at the mega-batch.

        Builds the backend's CUDA kernels (``build_kernels``: one nvcc per
        source), then stages a synthetic report (``_synthetic_report``)
        padded to ``pad_to``
        (default config.warmup_rows) and launches it, so the first real
        flush pays neither nvcc nor the first launch at that size at peak
        traffic.  Returns the number of launches (0 when warmup is off or
        the backend has no device launch path); ``compile_stats`` reports
        the seconds of the build and the launches as ``compile_s``.
        """
        pad_to = pad_to if pad_to is not None else self.config.warmup_rows
        if not pad_to or not hasattr(backend, "stage_prep_init_multi"):
            return 0
        build = getattr(backend, "build_kernels", None)
        if build is not None:
            build()
        vdaf = backend.vdaf
        nonce = b"\x00" * vdaf.NONCE_SIZE
        vk = b"\x00" * vdaf.VERIFY_KEY_SIZE
        compiled = 0
        for agg_id in agg_ids:
            reports = [(nonce, *_synthetic_report(vdaf, agg_id))]
            staged = backend.stage_prep_init_multi(
                agg_id, [(vk, reports)], pad_to=pad_to
            )
            backend.launch_prep_init_multi(staged, [(vk, reports)])
            compiled += 1
        return compiled

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, dict]:
        """Per-bucket counters (plain Python; bench + tests read these)."""
        with self._lock:
            return {
                b.label: {
                    "flushes": b.flushes,
                    "flushed_rows": b.flushed_rows,
                    "flushed_jobs": b.flushed_jobs,
                    "mean_flush_rows": round(b.mean_flush_rows(), 2),
                    "rejections": b.rejections,
                    "depth_rows": b.depth_rows,
                }
                for b in self._buckets.values()
            }

    def circuit_open(self, shape_key: tuple) -> bool:
        """PEEK at a shape's circuit without the allow() side effects:
        True while the circuit is open and still inside its reset dwell.
        Job drivers consult this at step entry (alongside circuit_stats())
        to refuse the job as retryable without paying a
        submit-then-CircuitOpenError round trip.  Returns False
        once the dwell has elapsed so the next real submission runs the
        half-open probe that can close the circuit.  Mesh-backed shapes
        share their mesh's breaker, so after a card loss this returns True
        for EVERY shape on that mesh.  A quarantined shape bucket also
        peeks True, scoped to the one shape, until its dwell expires."""
        if self._bucket_quarantined(shape_key):
            return True
        with self._lock:
            br = self._breaker_by_shape.get(shape_key) or self._breakers.get(shape_key)
        return br is not None and br.is_open_peek()

    def retire_idle_buckets(self, max_idle_s: float = 600.0) -> int:
        """Reap buckets with no pending/in-flight work that have been idle
        past ``max_idle_s``, removing their ``janus_executor_queue_rows``
        label sets; breakers whose shape no longer has any bucket and whose
        circuit is closed retire with them (their ``janus_executor_
        circuit_state`` series too).  Without this, a retired task's bucket
        gauges report stale values forever and series cardinality only ever
        grows.  Returns the number of buckets retired.
        """
        now = time.monotonic()
        retired: List[str] = []
        retired_circuits: List[str] = []
        with self._lock:
            for key, bucket in list(self._buckets.items()):
                if (
                    not bucket.pending
                    and bucket.depth_rows == 0
                    and bucket.timer is None
                    and now - bucket.last_activity >= max_idle_s
                ):
                    del self._buckets[key]
                    # the scheduler tabs go with the bucket — _deficit and
                    # the per-task _task_deficit entries are keyed by task
                    # cardinality and would otherwise grow for the process
                    # lifetime under task churn
                    self._deficit.pop(key, None)
                    for tk in [t for t in self._task_deficit if t[0] == key]:
                        del self._task_deficit[tk]
                    retired.append(bucket.label)
            live_shapes = {key[0] for key in self._buckets}
            for domain, breaker in list(self._breakers.items()):
                # a breaker retires only when NONE of the shapes in its
                # domain (one for a per-shape breaker, many for a mesh's)
                # still has a live bucket, and its circuit is closed
                shapes = self._breaker_shapes.get(domain, {domain})
                if not (shapes & live_shapes) and breaker.state == CIRCUIT_CLOSED:
                    del self._breakers[domain]
                    for sk in self._breaker_shapes.pop(domain, set()):
                        if self._breaker_by_shape.get(sk) is breaker:
                            del self._breaker_by_shape[sk]
                    retired_circuits.append(breaker.label)
        if retired or retired_circuits:
            from ..core.metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                for label in retired:
                    # EVERY per-bucket series goes with the bucket —
                    # cardinality must be capped by live traffic, not
                    # history (rejection reasons are a closed set)
                    for metric in (
                        GLOBAL_METRICS.executor_queue_rows,
                        GLOBAL_METRICS.executor_flush_rows,
                        GLOBAL_METRICS.executor_wait_seconds,
                        GLOBAL_METRICS.executor_launch_seconds,
                        GLOBAL_METRICS.executor_pad_rows,
                    ):
                        GLOBAL_METRICS.remove_series(metric, label)
                    for reason in ("queue_full", "deadline"):
                        GLOBAL_METRICS.remove_series(
                            GLOBAL_METRICS.executor_rejections, label, reason
                        )
                for label in retired_circuits:
                    GLOBAL_METRICS.remove_series(
                        GLOBAL_METRICS.circuit_state, label
                    )
            logger.info(
                "retired %d idle executor bucket(s) and %d closed circuit(s)",
                len(retired),
                len(retired_circuits),
            )
        return len(retired)

    def flight_stats(self, n: int = 32) -> dict:
        """The flight recorder's /statusz face: ring stats + the newest
        ``n`` per-flush records, newest first."""
        out = self.flight_recorder.stats()
        out["records"] = self.flight_recorder.snapshot(n)
        return out

    def circuit_stats(self) -> Dict[str, dict]:
        """Per-shape breaker state (plain Python; chaos tests read this)."""
        with self._lock:
            return {
                br.label: {
                    "state": _CIRCUIT_STATE_NAMES[br.state],
                    "trips": br.trips,
                    "consecutive_failures": br.consecutive_failures,
                }
                for br in self._breakers.values()
            }

    def shutdown(self, drain: bool = True) -> None:
        """Stop intake and tear down.  ``drain=True`` (the default — the
        graceful path) first spills every healthy bucket's committed-but-
        unspilled delta through the registered spill sink, so a SIGTERM
        loses nothing; ``drain=False`` is the crash-shaped teardown —
        deltas are dropped loudly and redelivery (un-committed jobs) or
        the persisted journal's oracle replay (committed, deferred-drain
        jobs) re-derives them."""
        self._closed = True
        if self.accumulator is not None:
            if drain and self._spill_sink is not None:
                try:
                    self.accumulator.drain_all(self._spill_sink)
                except Exception:
                    logger.exception("accumulator shutdown drain failed")
            # whatever remains (poisoned buckets, failed sink writes, or
            # drain=False): un-spilled deltas either belong to jobs whose
            # tx never committed (redelivery re-derives them) or carry
            # persisted journal rows (survivors replay them), so drop
            # them loudly without paying a readback per bucket
            try:
                self.accumulator.discard_all()
            except Exception:
                logger.exception("accumulator shutdown teardown failed")
        with self._lock:
            pools = [self._stage_pool, self._launch_pool, self._warmup_pool]
            self._stage_pool = self._launch_pool = self._warmup_pool = None
        for p in pools:
            if p is not None:
                p.shutdown(wait=False)

    # -- metrics ---------------------------------------------------------
    def _observe_depth(self, bucket: _Bucket) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_queue_rows.labels(bucket=bucket.label).set(
                bucket.depth_rows
            )

    def _observe_flush(self, bucket: _Bucket, rows: int, launch_s: float) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_flush_rows.labels(bucket=bucket.label).observe(rows)
            GLOBAL_METRICS.executor_launch_seconds.labels(
                bucket=bucket.label
            ).observe(launch_s)

    def _observe_pad(self, bucket: _Bucket, padded_rows: int) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if padded_rows > 0 and GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_pad_rows.labels(bucket=bucket.label).inc(
                padded_rows
            )

    def _observe_wait(self, bucket: _Bucket, wait_s: float) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_wait_seconds.labels(bucket=bucket.label).observe(
                wait_s
            )

    def _observe_rejection(self, bucket: _Bucket, reason: str) -> None:
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.executor_rejections.labels(
                bucket=bucket.label, reason=reason
            ).inc()


def _synthetic_report(vdaf, agg_id: int):
    """(public share, ``agg_id``'s input share) of the VDAF's shape for a
    warmup launch: all-zero bytes decoded as the wire would be, so the
    leader's share also carries its encoded bytes.  The report fails
    verification, which no warmup reads; sharding a real measurement
    instead proves it on the host, tens of seconds for SumVec(100000)."""
    flp, seed = vdaf.flp, vdaf.xof.SEED_SIZE
    joint = flp.JOINT_RAND_LEN > 0
    if agg_id == 0:
        size = (flp.MEAS_LEN + flp.PROOF_LEN * vdaf.num_proofs) * flp.field.ENCODED_SIZE
    else:
        size = seed
    share = vdaf.decode_input_share(agg_id, bytes(size + (seed if joint else 0)))
    public = vdaf.decode_public_share(bytes(vdaf.num_shares * seed if joint else 0))
    return public, share
