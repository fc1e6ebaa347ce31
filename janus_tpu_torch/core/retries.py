"""HTTP retry policy: exponential backoff over retryable failures.

The analog of ``retry_http_request`` (reference: core/src/retries.rs:102-205):
network errors and retryable status codes (server overload / transient
upstream failures) are retried with capped exponential backoff + jitter;
everything else returns immediately.

Partition hardening: every attempt runs under a PER-ATTEMPT
timeout (``policy.attempt_timeout``) so a blackholed peer costs one
timeout, not an open-ended aiohttp default; the whole exchange runs
under an optional monotonic ``deadline`` the job drivers derive from
their lease expiry (a hung peer must release the lease, never pin it
past reap); a retryable response carrying ``Retry-After`` — the
helper's 503 backpressure hint — shapes the next sleep (capped at
``policy.max_interval``) instead of blind exponential backoff; and each
attempt's transport outcome feeds the per-peer health tracker
(core/peer_health.py) that gates future lease work.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional, Tuple

from . import faults, peer_health


def is_retryable_http_status(status: int) -> bool:
    """reference: core/src/retries.rs:205"""
    return status in (408, 429, 500, 502, 503, 504)


def is_transport_error(e: BaseException) -> bool:
    """Transport-layer classification shared by the retry loop, the
    peer-health tracker, and the job drivers' partition-pressure check:
    the failure happened below HTTP (connect/reset/timeout), so it says
    nothing about the peer's application health — only its reachability.
    Injected faults count only in their transport-shaped form
    (FaultInjectedTransportError — reset/flap/blackhole-backstop); a
    plain error-mode fault impersonates an APPLICATION failure and must
    not drive a peer suspect.  Likewise only aiohttp's CONNECTION-level
    errors count: InvalidURL (a misconfigured endpoint is an operator
    error, not a partition — suspecting it would mask the misconfig as
    network weather and release its jobs forever) and response/payload
    errors (the peer answered) do not."""
    if isinstance(
        e,
        (
            asyncio.TimeoutError,
            ConnectionError,
            faults.FaultInjectedTransportError,
        ),
    ):
        return True
    aiohttp = _aiohttp()
    return aiohttp is not None and isinstance(e, aiohttp.ClientConnectionError)


def _aiohttp():
    """The aiohttp module where it is installed, else None: an in-process
    session (aggregator/test_util.py) needs no HTTP stack."""
    try:
        import aiohttp
    except ImportError:
        return None
    return aiohttp


def _parse_retry_after(headers: dict) -> Optional[float]:
    """Seconds form only (the helper emits integers); HTTP-date and junk
    are ignored rather than guessed at."""
    for key, value in headers.items():
        if key.lower() == "retry-after":
            try:
                seconds = float(value)
            except (TypeError, ValueError):
                return None
            return seconds if seconds >= 0 else None
    return None


@dataclass
class HttpRetryPolicy:
    """reference: core/src/retries.rs:33 backoff parameters"""

    initial_interval: float = 0.1
    max_interval: float = 5.0
    multiplier: float = 2.0
    max_elapsed: float = 30.0
    max_attempts: int = 10
    #: per-attempt wall clamp: a single hung/blackholed attempt is cut
    #: off here instead of riding aiohttp's defaults.  <= 0 disables
    #: (the total deadline/max_elapsed still bound the exchange).
    attempt_timeout: float = 0.0

    def for_tests(self) -> "HttpRetryPolicy":
        return HttpRetryPolicy(0.001, 0.01, 2.0, 0.5, 3)


async def retry_http_request(
    session,
    method: str,
    url: str,
    *,
    data: Optional[bytes] = None,
    headers: Optional[dict] = None,
    policy: Optional[HttpRetryPolicy] = None,
    deadline: Optional[float] = None,
) -> Tuple[int, bytes, dict]:
    """Issue a request, retrying retryable outcomes.

    Returns (status, body, headers) — on exhaustion, the last retryable
    response.  Raises the last transport-layer error if the final attempt
    failed before producing a response; never returns ``None``.
    ``max_elapsed`` bounds TOTAL wall time — request duration included,
    not just the backoff sleeps (a peer that burns 29s per hung attempt
    must not get ten of them).  ``deadline`` (``time.monotonic()``
    terms) bounds the exchange harder still: job drivers derive it from
    their lease expiry so a blackholed peer releases the lease instead
    of pinning it past reap.  Each attempt's transport outcome is
    recorded into the process-wide peer-health tracker; ANY response —
    retryable statuses included — counts as transport success.
    """
    aiohttp = _aiohttp()
    transport_errors = (
        asyncio.TimeoutError,
        ConnectionError,
        faults.FaultInjectedError,
    ) + ((aiohttp.ClientError,) if aiohttp is not None else ())

    policy = policy or HttpRetryPolicy()
    interval = policy.initial_interval
    start = time.monotonic()
    tracker = peer_health.tracker()
    peer = peer_health.origin_of(url)
    last: Optional[Tuple[int, bytes, dict]] = None
    last_exc: Optional[BaseException] = None

    async def one_attempt():
        # the injection hook sits INSIDE the per-attempt timeout scope:
        # a blackhole-mode fault parks exactly like a blackholed peer
        # and the same wait_for cancels it; the URL is the target
        # context that lets specs scope a partition to one direction
        await faults.fire_async("http.request", target=url)
        async with session.request(method, url, data=data, headers=headers) as resp:
            body = await resp.read()
            return resp.status, body, dict(resp.headers)

    for attempt in range(max(1, policy.max_attempts)):
        now = time.monotonic()
        if attempt > 0 and (
            now - start >= policy.max_elapsed
            or (deadline is not None and now >= deadline)
        ):
            break
        # the attempt clamp comes from the explicit knobs only — with
        # attempt_timeout off and no deadline, behavior (and the
        # exception surfaced on exhaustion) is exactly the legacy shape
        per_attempt = float("inf")
        if policy.attempt_timeout > 0:
            per_attempt = policy.attempt_timeout
        # An attempt is "unfairly" clamped when the caller's deadline
        # starves it of any real chance — less than 1s (or less than a
        # sub-second attempt_timeout).  A timeout then says nothing
        # about the peer.  Any attempt that got >= 1s and still timed
        # out DOES feed the tracker: a blackholed peer must register
        # even when the lease budget sits below attempt_timeout (e.g. a
        # 20s lease against the 30s default — discounting those would
        # disable partition gating for the whole deployment).
        fair_floor = min(
            per_attempt if per_attempt != float("inf") else 1.0, 1.0
        )
        deadline_clamped = False
        if deadline is not None and deadline - now < per_attempt:
            per_attempt = deadline - now
            deadline_clamped = per_attempt < fair_floor
        retry_after_s: Optional[float] = None
        try:
            if per_attempt != float("inf"):
                status, body, resp_headers = await asyncio.wait_for(
                    one_attempt(), timeout=max(per_attempt, 0.001)
                )
            else:
                status, body, resp_headers = await one_attempt()
        except transport_errors as e:
            last_exc = e
            # only transport-SHAPED failures feed peer health: an
            # error-mode injected fault (application-shaped) is retried
            # like before but says nothing about reachability — and a
            # timeout fired by OUR OWN lease-derived deadline (the
            # attempt got less than its fair attempt_timeout) says
            # nothing about the peer either: a step that spent its lease
            # on local work must not drive a healthy-but-not-instant
            # helper suspect process-wide
            if is_transport_error(e) and not (
                deadline_clamped and isinstance(e, asyncio.TimeoutError)
            ):
                tracker.record_transport_failure(peer)
        else:
            tracker.record_success(peer)
            if not is_retryable_http_status(status):
                return status, body, resp_headers
            last_exc = None
            last = (status, body, resp_headers)
            retry_after_s = _parse_retry_after(resp_headers)
        now = time.monotonic()
        if now - start >= policy.max_elapsed or attempt == policy.max_attempts - 1:
            break
        if deadline is not None and now >= deadline:
            break
        if retry_after_s is not None:
            # the peer told us when to come back (503 backpressure):
            # honor it, capped so a hostile/buggy hint cannot park us,
            # with UPWARD jitter — every exchange the helper shed got the
            # same hint, and re-arriving in one synchronized wave would
            # recreate the overload the hint exists to relieve (never
            # jitter below the hint: that violates it)
            sleep = min(retry_after_s, policy.max_interval) * (
                1.0 + 0.25 * random.random()
            )
            from .metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.http_retry_after_honored.inc()
        else:
            sleep = interval * (0.5 + random.random())
        if deadline is not None:
            sleep = min(sleep, max(0.0, deadline - time.monotonic()))
        await asyncio.sleep(sleep)
        interval = min(interval * policy.multiplier, policy.max_interval)
    if last_exc is not None:
        raise last_exc
    if last is None:
        # the deadline was exhausted before any attempt produced an
        # outcome (driver handed us an already-spent lease budget)
        raise asyncio.TimeoutError(
            f"deadline exhausted before any attempt to {url}"
        )
    return last
