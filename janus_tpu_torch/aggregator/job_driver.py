"""Generic lease-based job driver loop.

The analog of ``JobDriver`` (reference:
aggregator/src/binary_utils/job_driver.rs:26-266): periodically acquires
leases on incomplete jobs (with jitter on the discovery interval),
steps them concurrently under a semaphore bound, applies a per-job timeout
derived from the lease expiry minus a clock-skew allowance, and drains
gracefully on stop.  Crash recovery is inherent: an expired lease makes the
job re-acquirable by any replica (SURVEY.md §5 failure detection).
"""

from __future__ import annotations

import asyncio
import logging
import random
import zlib
from typing import Awaitable, Callable, List, Optional

from ..core.time import Clock
from ..datastore.models import Lease
from ..messages import Duration

logger = logging.getLogger("janus_tpu.job_driver")


def step_retry_delay(
    attempts: int,
    initial_s: float,
    max_s: float,
    multiplier: float = 2.0,
    jitter_key: Optional[bytes] = None,
) -> Duration:
    """Exponential lease-backoff for a retryable step failure: attempt 1
    waits ``initial_s``, doubling up to ``max_s``.  Shared by both job
    drivers so every retryable failure redelivers on the same curve
    (reference analog: collection_job_driver.rs RetryStrategy :723-792,
    generalized to aggregation).  Clamped to >= 1s: Duration is integral
    seconds, and truncating a sub-second delay to 0 would mean immediate
    redelivery — the hot loop this backoff exists to prevent.

    ``jitter_key`` (the job id) spreads the base delay over [base, 2x
    base) with a seed stable per (job, attempt): every job released
    during a partition would otherwise sit on the SAME backoff schedule
    and re-acquire in one wave the moment the link heals — a thundering
    herd aimed at a helper that just recovered.  Stable seeding keeps
    redelivery times reproducible for a given chaos seed while distinct
    jobs land at distinct offsets; the jittered delay may exceed
    ``max_s`` by up to 2x, which is the point at the cap (every job AT
    the cap must still spread)."""
    # exponent clamped: peer-unhealthy releases can push attempts into
    # the thousands during a long partition, and float ** overflows past
    # ~2**1024 — 2**64 already exceeds any real max_s
    base = min(initial_s * multiplier ** min(max(0, attempts - 1), 64), max_s)
    if jitter_key:
        rng = random.Random((zlib.crc32(jitter_key) << 8) ^ attempts)
        base = base * (1.0 + rng.random())
    return Duration(max(1, round(base)))


def heal_grace_s(retry_max_delay_s: float) -> float:
    """Heal-grace window for the ceiling guards, shared by both drivers:
    long enough for every job released during the partition to cycle
    back through acquisition at least once — step_retry_delay's max
    jittered backoff is 2x the max delay, and the extra 1x is headroom
    for discovery-poll and worker-queue latency (a boundary job must
    not miss the window by one poll interval and abandon)."""
    return 3.0 * retry_max_delay_s


async def peer_partition_state(datastore, task_id, grace_s: float) -> str:
    """Ceiling-time partition classification shared by BOTH job drivers:
    is the task's peer ``suspect`` (inside its dwell — release, don't
    abandon), ``healed`` (probing, or back healthy within ``grace_s`` —
    the inflated delivery count is partition debris, let the job take
    its delivery: a PROBING peer's delivery IS the half-open probe, and
    without it a fleet whose every job is past-ceiling could never heal),
    or ``healthy`` (the ceiling's normal verdict applies)?  Lookup
    failures report ``healthy`` — fall through to the normal verdict
    rather than wedge the ceiling on a sick datastore.  The common
    no-partition case short-circuits on the in-memory tracker without
    touching the datastore."""
    from ..core import peer_health
    from ..core.peer_health import PEER_SUSPECT, PEER_PROBING

    tracker = peer_health.tracker()
    if not tracker.partition_signal(grace_s):
        return "healthy"
    try:
        task = await datastore.run_tx_async(
            "ceiling_peer_check", lambda tx: tx.get_aggregator_task(task_id)
        )
    except Exception:
        # the lookup only maps task_id -> peer URL, and partition_signal
        # already confirmed SOME peer is partitioned: fail toward the
        # cheap, reversible verdict (release) — failing "healthy" here
        # would abandon exactly the jobs this guard protects whenever
        # the datastore is contended by the same redelivery churn
        return "suspect"
    if task is None:
        return "healthy"
    url = task.peer_aggregator_endpoint
    state = tracker.state(url)
    if state == PEER_SUSPECT:
        return "suspect"
    if state == PEER_PROBING or tracker.recently_healed(url, grace_s):
        return "healed"
    return "healthy"


async def partition_excused(datastore, task_id, retry_max_delay_s: float) -> bool:
    """Budget-exhaustion excuse shared by both drivers: is the task's
    peer partitioned (suspect/probing) or healed within the grace?  A
    job whose lease_attempts were inflated by clean partition releases
    must not be abandoned by the max_step_attempts comparison on its
    first post-heal hiccup — the count is partition debris, not failure
    history.  Cheap in the common case (peer_partition_state
    short-circuits on the in-memory tracker)."""
    return (
        await peer_partition_state(
            datastore, task_id, heal_grace_s(retry_max_delay_s)
        )
        != "healthy"
    )


def suspect_task_ids(tx, job_type: str = "job") -> Optional[List[bytes]]:
    """Task ids whose peer is currently SUSPECT — the peer-health-aware
    acquisition filter (runs INSIDE the acquirer's transaction, sharing
    it).  During a partition, a suspect peer's jobs used to be acquired
    and immediately released by the step's peer gate, burning one lease
    tx round trip per job per discovery poll; filtering them at the
    acquire query spares that churn while the dwell lasts.  PROBING peers
    are deliberately NOT filtered: a probing peer's job delivery IS the
    half-open probe that can heal the partition.  The no-partition common
    case pays one in-memory check and touches nothing.

    Fleet extension: suspects advertised by OTHER
    fleet members' heartbeat rows are honored beside the in-memory
    tracker, so a replica that never talked to a partitioned peer also
    skips its tasks.  Empty set when fleet mode is off."""
    from ..core import peer_health
    from ..core.fleet import fleet_shared_suspects
    from ..core.peer_health import PEER_SUSPECT, origin_of

    tracker = peer_health.tracker()
    shared = fleet_shared_suspects(tx)
    if not shared and not tracker.partition_signal(0.0):
        return None
    ids = [
        task_id
        for task_id, url in tx.get_task_peer_index()
        # strictly SUSPECT (tracker.is_suspect would also match probing)
        if url
        and (tracker.state(url) == PEER_SUSPECT or origin_of(url) in shared)
    ]
    if not ids:
        return None
    from ..core.metrics import GLOBAL_METRICS

    if GLOBAL_METRICS.registry is not None:
        GLOBAL_METRICS.job_acquisition_suspect_filtered.labels(
            job_type=job_type
        ).inc()
    return ids


def acquisition_exclusions(tx, job_type: str = "job") -> Optional[List[bytes]]:
    """The full acquisition filter both driver binaries thread into
    ``acquire_incomplete_*_jobs(exclude_task_ids=...)``: suspect-peer
    tasks (above) unioned with tasks the fleet router routes to another
    replica.  Fleet off -> reduces to suspect_task_ids exactly."""
    from ..core.fleet import fleet_router

    ids = suspect_task_ids(tx, job_type) or []
    router = fleet_router()
    if router is not None:
        seen = set(ids)
        for task_id in router.not_owned_task_ids(tx) or []:
            if task_id not in seen:
                seen.add(task_id)
                ids.append(task_id)
    return ids or None


def helper_request_deadline(lease, datastore):
    """Monotonic deadline for one peer exchange, shared by BOTH job
    drivers: 80% of the remaining lease (floor 1s), so a blackholed peer
    ALWAYS hands the step back in time to RELEASE the lease in-band —
    never leaving it to expire into the reaper (the partition soak
    asserts ``janus_job_leases_expired_total`` stays zero).  None when
    there is no lease/datastore context (unit tests, best-effort
    cleanup calls)."""
    if lease is None or datastore is None:
        return None
    import time as _time

    remaining = lease.lease_expiry.seconds - datastore.clock.now().seconds
    return _time.monotonic() + max(1.0, 0.8 * remaining)


class JobDriver:
    def __init__(
        self,
        clock: Clock,
        acquirer: Callable[[Duration, int], Awaitable[List[Lease]]],
        stepper: Callable[[Lease], Awaitable[None]],
        *,
        job_discovery_interval: float = 1.0,
        max_concurrent_job_workers: int = 10,
        worker_lease_duration: Duration = Duration(600),
        worker_lease_clock_skew_allowance: Duration = Duration(60),
        reaper: Optional[Callable[[], Awaitable[int]]] = None,
        lease_reap_interval: float = 10.0,
        job_type: str = "job",
    ):
        self.clock = clock
        self.acquirer = acquirer
        self.stepper = stepper
        self.job_discovery_interval = job_discovery_interval
        self.max_concurrent_job_workers = max_concurrent_job_workers
        self.worker_lease_duration = worker_lease_duration
        self.worker_lease_clock_skew_allowance = worker_lease_clock_skew_allowance
        #: Expired-lease reaper (crash recovery): an async callable that
        #: clears the lease tokens of jobs whose lease expired WITHOUT
        #: release (their holder died or wedged) and returns the count —
        #: each one is counted into janus_job_leases_expired_total.  The
        #: jobs were already re-acquirable (acquisition scans on expiry);
        #: reaping makes the death visible and the redelivery prompt.
        self.reaper = reaper
        self.lease_reap_interval = lease_reap_interval
        self.job_type = job_type
        self._last_reap = 0.0
        self._inflight: set = set()

    async def _maybe_reap(self) -> None:
        import time as _time

        if self.reaper is None:
            return
        now = _time.monotonic()
        if now - self._last_reap < self.lease_reap_interval:
            return
        self._last_reap = now
        try:
            count = await self.reaper()
        except Exception:
            logger.exception("lease reaper pass failed")
            return
        if not count:
            return
        logger.warning(
            "reaped %d expired %s lease(s) (holder died or wedged); "
            "redelivering",
            count,
            self.job_type,
        )
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.job_leases_expired.labels(job_type=self.job_type).inc(
                count
            )

    async def run(self, stop: asyncio.Event) -> None:
        """Run until ``stop`` is set, then drain in-flight steppers
        (reference: job_driver.rs:100-149)."""
        from ..datastore.datastore import DatastoreUnavailable

        sem = asyncio.Semaphore(self.max_concurrent_job_workers)
        acquire_failures = 0
        while not stop.is_set():
            await self._maybe_reap()
            free = self.max_concurrent_job_workers - len(self._inflight)
            leases: List[Lease] = []
            if free > 0:
                try:
                    leases = await self.acquirer(self.worker_lease_duration, free)
                    acquire_failures = 0
                except DatastoreUnavailable as e:
                    # Brownout idle-backoff: consecutive
                    # acquisition failures stretch the discovery sleep
                    # multiplicatively (capped) instead of polling a
                    # struggling database on the normal cadence.  One
                    # line per miss — the health tracker and metrics
                    # carry the detail.
                    acquire_failures += 1
                    logger.warning(
                        "job acquisition failed, datastore unavailable "
                        "(%d consecutive; backing off): %s",
                        acquire_failures,
                        e,
                    )
                except Exception:
                    acquire_failures += 1
                    logger.exception("job acquisition failed")
            for lease in leases:
                task = asyncio.ensure_future(self._step(sem, lease))
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
            # jittered discovery sleep (reference: job_driver.rs discovery
            # interval w/ jitter); cut short if stop is requested.
            delay = self.job_discovery_interval * (0.5 + random.random())
            if acquire_failures:
                delay = min(
                    delay * (2 ** min(acquire_failures, 5)),
                    max(self.job_discovery_interval, 60.0),
                )
            try:
                await asyncio.wait_for(stop.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass
        if self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)

    async def _step(self, sem: asyncio.Semaphore, lease: Lease) -> None:
        from ..core.metrics import GLOBAL_METRICS
        from ..core.trace import trace_scope, trace_span

        async with sem:
            # per-job timeout: remaining lease minus skew allowance
            # (reference: job_driver.rs:222-247)
            timeout = max(
                1.0,
                lease.lease_expiry.seconds
                - self.clock.now().seconds
                - self.worker_lease_clock_skew_allowance.seconds,
            )
            leased = lease.leased
            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.job_age_at_acquire.labels(
                    job_type=self.job_type
                ).observe(getattr(leased, "age_seconds", 0.0))
            job_id = getattr(leased, "aggregation_job_id", None) or getattr(
                leased, "collection_job_id", None
            )
            # Per-outcome accounting: on wall time alone, a fleet spinning
            # on timeouts/retries is indistinguishable from a healthy one.
            outcome = "ok"
            # Bind the job's persisted trace context for the whole step:
            # every log line, chrome-trace span, and outbound traceparent
            # from this replica joins the job's cross-process timeline.
            with trace_scope(
                trace_id=getattr(leased, "trace_id", None),
                task_id=leased.task_id,
                job_id=job_id,
            ), trace_span(
                "job_step",
                job_type=type(leased).__name__,
                attempts=lease.lease_attempts,
            ):
                try:
                    await asyncio.wait_for(self.stepper(lease), timeout=timeout)
                except asyncio.TimeoutError:
                    outcome = "timeout"
                    logger.warning("job step timed out; lease will expire naturally")
                except Exception as e:
                    # steppers normally classify internally; anything that
                    # reaches here is either an escaped JobStepError (duck-
                    # typed on .retryable) or an unclassified failure
                    outcome = (
                        "retryable" if getattr(e, "retryable", False) else "fatal"
                    )
                    logger.exception("job step failed")
            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.job_steps_total.labels(
                    job_type=type(lease.leased).__name__, outcome=outcome
                ).inc()
