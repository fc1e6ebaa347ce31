"""Process-wide deterministic fault injection.

Janus inherits crash-tolerance from its lease machinery — an expired
lease makes any job re-acquirable by any replica (SURVEY.md §5) — but
the device port adds failure domains the reference never had: device
launches can fail or hang, the executor can backpressure, and the
datastore/HTTP seams sit under far more concurrent traffic.  This module
makes failure a first-class, *testable* input: named injection points at
every failure-domain boundary, driven by one seeded registry so a chaos
run replays bit-for-bit.

Injection points wired into the tree (the names are a public contract;
tests/test_chaos.py cross-checks them):

    ``datastore.tx.begin``   before BEGIN in ``Datastore.run_tx``
    ``datastore.tx.commit``  after the tx body, before COMMIT
    ``http.request``         before each attempt in ``retry_http_request``
    ``executor.flush``       at the head of a DeviceExecutor flush
    ``backend.launch``       in ``CudaBackend.launch_prep_init_multi``
    ``backend.device_lost``  same site, impersonating a lost mesh device
    ``backend.combine``      in ``CudaBackend.prep_shares_to_prep_batch``
    ``clock.skew``           sampled by ``SkewedClock.now``
    ``upload.open``          head of each batched HPKE-open pass
                             (UploadOpenBatcher worker thread)
    ``report_writer.flush``  before a ReportWriteBatcher batch commit
    ``gc.run``               per-task GC pass (GarbageCollector._gc_task)
    ``key_rotator.run``      at the head of an HpkeKeyRotator tick
    ``accumulator.spill``    before an accumulator bucket's drain readback
    ``accumulator.evict``    before an LRU eviction spills state to host
    ``accumulator.replay``   before a collection-time journal replay

Modes: ``error`` raises :class:`FaultInjectedError`, ``delay`` sleeps
``delay_s``, ``hang`` sleeps ``hang_s`` (long enough to trip whatever
timeout guards the call site), ``skew`` offsets a clock by up to
``skew_s`` seconds in either direction, ``corrupt`` bit-flips or
truncates a durable payload at a ``corrupt_bytes()`` call site (the
data failure domain).  Each point draws from its own
``random.Random`` seeded by ``(seed, point)``, so per-point decision
sequences are reproducible regardless of how threads interleave across
points.

Connectivity modes (the network failure domain):

``blackhole``
    The peer never answers: the hook parks until the CALL SITE's own
    deadline cancels it (async contexts — ``asyncio.wait_for`` around
    the attempt cancels the sleep), with ``hang_s`` as a backstop after
    which a :class:`FaultInjectedTransportError` fires (the OS
    eventually giving up on the socket).  Distinct from ``hang``, which
    sleeps a FIXED duration and then lets the call proceed.
``reset``
    Transport failure mid-exchange: raises
    :class:`FaultInjectedTransportError` (a ``ConnectionResetError``
    subclass), so call sites — and the peer-health tracker — classify
    it exactly like a real socket reset.
``flap``
    Seeded on/off connectivity schedule: the link alternates healthy /
    partitioned phases whose durations are drawn deterministically from
    ``(seed, point)`` around ``flap_period_s`` (see
    :class:`FlapSchedule`); while "up" (partitioned) the spec behaves
    like ``reset``, while "down" traffic flows.  Two registries with
    one seed flap identically.

Target scoping: a spec may carry ``target`` — a substring matched
against the context string the call site passes to ``fire()`` (for
``http.request`` that is the request URL, so a partition can be scoped
to ONE direction of the leader<->helper pair by the peer's host:port).
A scoped spec is consulted — and its RNG rolled — only for matching
calls, so per-point decision sequences stay deterministic per traffic
direction.  Specs without a target match every call, scoped or not.

Activation is config-only (``binaries/config.py`` ``fault_injection:``,
default fully off) or programmatic (:func:`configure`, used by tests).
When off, every hook is a module-call + one attribute check — nothing is
sampled, nothing is allocated.
"""

from __future__ import annotations

import asyncio
import bisect
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: The points wired into the tree today.  configure() accepts unknown
#: names (new points must not require a lockstep edit here), but the
#: chaos suite asserts this list stays in sync with the call sites.
KNOWN_POINTS = (
    "datastore.tx.begin",
    "datastore.tx.commit",
    "http.request",
    "executor.flush",
    "backend.launch",
    "backend.combine",
    # mesh failure domain (vdaf/backend.py launch path): impersonates a
    # chip dropping out of the mesh mid-launch (ICI link loss, plugin
    # eviction).  Distinct from backend.launch so chaos runs can target
    # "device lost" specifically; the executor's per-MESH breaker (every
    # mesh-backed shape shares one circuit) is what this point exercises.
    "backend.device_lost",
    "clock.skew",
    # upload front door: head of each batched HPKE-open pass
    # (UploadOpenBatcher's worker thread) — delay mode backs the bounded
    # queue up into load sheds, error mode exercises the per-report
    # inline fallback
    "upload.open",
    # maintenance loops
    "report_writer.flush",
    "gc.run",
    "key_rotator.run",
    # device-resident accumulator store (executor/accumulator.py): fired
    # at the commit-time/eviction spill boundaries so ./ci.sh chaos
    # exercises mid-spill failures (oracle replay, no double count)
    "accumulator.spill",
    "accumulator.evict",
    # collection-time journal replay (collection_job_driver.py): a
    # survivor re-deriving a dead replica's un-drained shares must itself
    # be crash-safe (the replay tx is the exactly-once point)
    "accumulator.replay",
    # write-behind report journal (core/ingest.py): head of each
    # journal-flush transaction — delay mode wedges the writer so the
    # bounded queue backs up into reason="journal" sheds, error mode
    # impersonates a commit failure fanned to every waiting ACK
    "ingest.journal",
    # leader aggregate-share corruption (collection_job_driver.py): a
    # corrupt-mode spec here bit-flips or truncates the encoded
    # leader aggregate share as the collection job finishes — the WRONG-
    # ANSWER fault only the canary plane's known-plaintext verification
    # can catch (outcome="corrupt"); every other signal stays green
    "collection.aggregate_share",
    # durable-row corruption (datastore journal writes): a
    # corrupt-mode spec here bit-flips or truncates journal payload bytes
    # AFTER the row CRC is computed — impersonating a torn write / media
    # bit rot that the materialize/replay checksum pass must catch
    "journal.corrupt",
)

MODES = ("error", "delay", "hang", "skew", "blackhole", "reset", "flap", "corrupt")


class FaultInjectedError(Exception):
    """An ``error``-mode injection fired.

    Call sites treat it like the transient infrastructure failure it
    impersonates: the datastore retry loop classifies it retryable, the
    HTTP retry loop retries it, and the executor surfaces it as a launch
    failure (counted by the circuit breaker).
    """

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


class FaultInjectedTransportError(FaultInjectedError, ConnectionResetError):
    """A ``reset``/``flap`` injection (or a ``blackhole`` backstop)
    fired: impersonates a TRANSPORT-layer failure — connection reset by
    peer — so call sites that classify socket errors (the HTTP retry
    loop, the peer-health tracker) treat it exactly like the real thing,
    while chaos harnesses can still catch it as a FaultInjectedError."""


@dataclass
class FaultSpec:
    """One armed fault: fire at ``point`` with ``probability`` per call."""

    point: str
    mode: str = "error"
    probability: float = 1.0
    #: delay-mode sleep
    delay_s: float = 0.01
    #: hang-mode sleep — size it against the call site's timeout guard.
    #: For blackhole mode this is the BACKSTOP: the hook parks until the
    #: call site's deadline cancels it, and only a site with no deadline
    #: at all waits this long before the transport error fires.
    hang_s: float = 3600.0
    #: skew-mode magnitude: offsets sampled uniformly in [-skew_s, +skew_s]
    skew_s: int = 0
    #: target scope: when set, the spec is consulted only for calls whose
    #: target context (e.g. the http.request URL) CONTAINS this substring
    #: — the asymmetric-partition primitive (scope one direction of the
    #: leader<->helper pair by the peer's host:port).  None = every call.
    target: Optional[str] = None
    #: flap-mode mean phase duration: each healthy/partitioned phase
    #: lasts uniform(0.5, 1.5) x this, drawn from the seeded schedule.
    flap_period_s: float = 1.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} (one of {MODES})")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability {self.probability} outside [0, 1]")
        if self.mode == "flap" and self.flap_period_s <= 0:
            raise ValueError("flap_period_s must be positive")


class FlapSchedule:
    """Deterministic alternating connectivity schedule for ``flap``
    specs: phase 0 is DOWN (healthy — arming a flap must not partition
    the link at t=0), then UP (partitioned), alternating; each phase
    lasts ``uniform(0.5, 1.5) * period_s`` drawn from a Random seeded by
    ``(seed, point)``.  Same seed => identical schedule, which is what
    lets a chaos run replay a flapping link bit-for-bit."""

    def __init__(self, seed: int, point: str, period_s: float, salt: int = 0):
        import random

        # ``salt`` (the spec's index within its point) gives each armed
        # flap spec an INDEPENDENT schedule: two target-scoped flap
        # specs modeling separately flapping directions must not
        # partition/heal in lockstep
        self._r = random.Random(
            (((seed << 32) ^ zlib.crc32(point.encode())) ^ 0x464C4150)  # "FLAP"
            + salt * 0x9E3779B1
        )
        self.period_s = period_s
        #: cumulative phase-end times; index 0 ends the first DOWN phase
        self._toggles: List[float] = [self._next_phase()]
        #: phases pruned off the front (parity bookkeeping): ``up()`` is
        #: called under the registry lock on every fire, so a multi-hour
        #: soak must not grow (or bisect) an unbounded toggle list
        self._dropped = 0

    def _next_phase(self) -> float:
        return self._r.uniform(0.5, 1.5) * self.period_s

    def up(self, elapsed_s: float) -> bool:
        """Is the link partitioned at ``elapsed_s`` since arming?
        Registry call sites pass monotonically nondecreasing elapsed
        times; probes older than the pruned window are not supported."""
        while self._toggles[-1] <= elapsed_s:
            self._toggles.append(self._toggles[-1] + self._next_phase())
        i = bisect.bisect_right(self._toggles, elapsed_s)
        up = (self._dropped + i) % 2 == 1
        if i > 64:
            self._dropped += i - 1
            del self._toggles[: i - 1]
        return up


class FaultRegistry:
    """Seeded spec store + the fire() sampling loop.  One per process."""

    def __init__(self):
        self.active = False
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._rngs: Dict[str, "_PointRng"] = {}
        self._seed = 0
        self._lock = threading.Lock()
        #: point -> number of faults actually injected (not calls checked)
        self.hits: Dict[str, int] = {}
        #: (point, spec index) -> FlapSchedule; epoch anchors elapsed time
        self._flaps: Dict[Tuple[str, int], FlapSchedule] = {}
        self._epoch = 0.0

    # -- arming ---------------------------------------------------------
    def configure(self, specs: Sequence[FaultSpec], seed: int = 0) -> None:
        """Arm ``specs``; replaces any previous configuration."""
        with self._lock:
            self._specs = {}
            for spec in specs:
                self._specs.setdefault(spec.point, []).append(spec)
            self._seed = seed
            self._rngs = {}
            self.hits = {}
            self._flaps = {}
            self._epoch = time.monotonic()
            self.active = bool(self._specs)

    def clear(self) -> None:
        with self._lock:
            self._specs = {}
            self._rngs = {}
            self._flaps = {}
            self.active = False

    def snapshot(self) -> dict:
        """Arm-state introspection for /statusz: armed flag, seed, the
        per-point spec modes, and injection hit counts so an operator can
        see at a glance whether a wedged soak is chaos pressure or a bug."""
        with self._lock:
            return {
                "armed": self.active,
                "seed": self._seed,
                "points": {
                    point: [
                        {
                            "mode": s.mode,
                            "probability": s.probability,
                            # target scope rendered so an operator can see
                            # WHICH direction of a partition is armed
                            **({"target": s.target} if s.target else {}),
                            **(
                                {"flap_period_s": s.flap_period_s}
                                if s.mode == "flap"
                                else {}
                            ),
                        }
                        for s in specs
                    ]
                    for point, specs in sorted(self._specs.items())
                },
                "hits": dict(self.hits),
            }

    # -- sampling -------------------------------------------------------
    def _decide(
        self, point: str, target: Optional[str] = None
    ) -> Optional[FaultSpec]:
        """Roll each of the point's specs in order; first hit wins.
        Per-point RNGs keyed by (seed, point) keep decision sequences
        deterministic even when threads interleave across points.
        Target-scoped specs are skipped — WITHOUT consuming a roll — for
        calls whose target context does not contain their substring, and
        a flap spec whose schedule is in a healthy phase hits nothing."""
        with self._lock:
            specs = self._specs.get(point)
            if not specs:
                return None
            rng = self._rngs.get(point)
            if rng is None:
                rng = _PointRng(self._seed, point)
                self._rngs[point] = rng
            for idx, spec in enumerate(specs):
                if spec.target is not None and (
                    target is None or spec.target not in target
                ):
                    continue
                if rng.roll() >= spec.probability:
                    continue
                if spec.mode == "flap":
                    flap = self._flaps.get((point, idx))
                    if flap is None:
                        flap = FlapSchedule(
                            self._seed, point, spec.flap_period_s, salt=idx
                        )
                        self._flaps[(point, idx)] = flap
                    if not flap.up(time.monotonic() - self._epoch):
                        continue  # healthy phase: the link carries traffic
                self.hits[point] = self.hits.get(point, 0) + 1
                return spec
            return None

    def _record(self, spec: FaultSpec) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.faults_injected.labels(
                point=spec.point, mode=spec.mode
            ).inc()

    def fire(self, point: str, target: Optional[str] = None) -> None:
        """Synchronous hook (thread contexts: datastore, launch pools)."""
        spec = self._decide(point, target)
        if spec is None:
            return
        self._record(spec)
        if spec.mode == "error":
            raise FaultInjectedError(point)
        if spec.mode in ("reset", "flap"):
            raise FaultInjectedTransportError(point)
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
        elif spec.mode == "hang":
            time.sleep(spec.hang_s)
        elif spec.mode == "blackhole":
            # sync contexts have no cancellable deadline: park for the
            # backstop, then surface the never-answered socket
            time.sleep(spec.hang_s)
            raise FaultInjectedTransportError(point)
        # skew-mode specs only apply through skew(); firing one here is a no-op

    async def fire_async(self, point: str, target: Optional[str] = None) -> None:
        """Event-loop hook: delay/hang must not block the loop's peers."""
        spec = self._decide(point, target)
        if spec is None:
            return
        self._record(spec)
        if spec.mode == "error":
            raise FaultInjectedError(point)
        if spec.mode in ("reset", "flap"):
            raise FaultInjectedTransportError(point)
        if spec.mode == "delay":
            await asyncio.sleep(spec.delay_s)
        elif spec.mode == "hang":
            await asyncio.sleep(spec.hang_s)
        elif spec.mode == "blackhole":
            # parked until the CALL SITE's deadline cancels this sleep
            # (asyncio.wait_for around the attempt — the per-attempt
            # timeout retry_http_request applies); hang_s is only the
            # backstop for sites with no deadline at all
            await asyncio.sleep(spec.hang_s)
            raise FaultInjectedTransportError(point)

    def skew(self, point: str = "clock.skew") -> int:
        """Sample a clock offset in seconds (0 when the point is quiet)."""
        spec = self._decide(point)
        if spec is None or spec.mode != "skew" or spec.skew_s <= 0:
            return 0
        self._record(spec)
        with self._lock:
            rng = self._rngs.get(point)  # None if reconfigured mid-call
            return rng.offset(spec.skew_s) if rng is not None else 0

    def corrupt(
        self, point: str, data: bytes, target: Optional[str] = None
    ) -> bytes:
        """Maybe mangle ``data`` (corrupt-mode specs only).

        Returns ``data`` unchanged when the point is quiet.  When a
        corrupt-mode spec fires, the payload is either bit-flipped at a
        deterministically drawn position or truncated (torn write) — both
        drawn from the point's seeded RNG so a corruption soak replays
        bit-for-bit.  Empty payloads pass through untouched.
        """
        if not data:
            return data
        spec = self._decide(point, target)
        if spec is None or spec.mode != "corrupt":
            return data
        self._record(spec)
        with self._lock:
            rng = self._rngs.get(point)  # None if reconfigured mid-call
            if rng is None:
                return data
            flip = rng.roll() < 0.5
            pos_roll = rng.roll()
        if flip or len(data) == 1:
            pos = min(int(pos_roll * len(data) * 8), len(data) * 8 - 1)
            mangled = bytearray(data)
            mangled[pos // 8] ^= 1 << (pos % 8)
            return bytes(mangled)
        # torn write: keep a strict prefix (possibly empty)
        return data[: int(pos_roll * (len(data) - 1))]


class _PointRng:
    """random.Random seeded stably from (seed, point-name)."""

    def __init__(self, seed: int, point: str):
        import random

        self._r = random.Random((seed << 32) ^ zlib.crc32(point.encode()))

    def roll(self) -> float:
        return self._r.random()

    def offset(self, magnitude: int) -> int:
        return self._r.randint(-magnitude, magnitude)


# -- process-wide instance ---------------------------------------------------

_REGISTRY = FaultRegistry()


class SkewedClock:
    """Clock wrapper applying registry-driven skew (the clock-skew
    failure domain): each ``now()`` is offset by whatever the
    ``clock.skew`` point samples.  Wrap exactly the replica whose clock
    should drift; everything else keeps the base clock."""

    def __init__(self, base, point: str = "clock.skew"):
        self.base = base
        self.point = point

    def now(self):
        from ..messages import Time

        t = self.base.now()
        offset = skew(self.point)
        if offset == 0:
            return t
        return Time(max(0, t.seconds + offset))

    def __getattr__(self, item):
        # advance()/set() on a wrapped MockClock keep working
        return getattr(self.base, item)


# -- process-wide instance ---------------------------------------------------

_REGISTRY = FaultRegistry()


def registry() -> FaultRegistry:
    return _REGISTRY


def configure(specs: Sequence[FaultSpec], seed: int = 0) -> None:
    _REGISTRY.configure(specs, seed=seed)


def clear() -> None:
    _REGISTRY.clear()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def active() -> bool:
    return _REGISTRY.active


def fire(point: str, target: Optional[str] = None) -> None:
    """Sync injection hook; no-op (one bool check) when faults are off.
    ``target`` is the call's scope context (e.g. the peer URL) matched
    against target-scoped specs."""
    if _REGISTRY.active:
        _REGISTRY.fire(point, target)


async def fire_async(point: str, target: Optional[str] = None) -> None:
    """Async injection hook; no-op when faults are off."""
    if _REGISTRY.active:
        await _REGISTRY.fire_async(point, target)


def skew(point: str = "clock.skew") -> int:
    return _REGISTRY.skew(point) if _REGISTRY.active else 0


def corrupt_bytes(point: str, data: bytes, target: Optional[str] = None) -> bytes:
    """Corruption hook: passthrough when faults are off, else maybe-mangle.
    Call sites apply this to durable payloads AFTER computing the row CRC,
    so the stored checksum witnesses the original bytes."""
    if _REGISTRY.active:
        return _REGISTRY.corrupt(point, data, target)
    return data
