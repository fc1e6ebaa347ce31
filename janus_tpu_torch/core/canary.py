"""The canary plane: continuous black-box end-to-end probing.

Copy of ``janus_tpu/core/canary.py`` for the PyTorch port.  The probes
travel the port's own upload, aggregate and collect path, so a fleet of
the port's binaries prepares them on the card like any other report.

Every degradation mode the fleet has grown — brownout suppression,
journal replay, quarantine bisection, breaker-driven oracle fallback —
is observable only by interpreting a dozen metric families after the
fact.  This module closes the loop from the OUTSIDE: a prober drives
known-plaintext synthetic reports through dedicated, auto-provisioned
canary tasks (one per VDAF family) against the real upload → aggregate
→ collect path of a live fleet, then verifies the collected aggregate
against the exact expected sum.  A replica can hold leases, heartbeat,
and serve 200s while producing garbage; only a known answer catches it.

Outcome taxonomy (the ``janus_canary_verdict_total{task,outcome}``
counter):

    ok       upload + collection succeeded AND the aggregate matched
    error    a stage failed loudly (HTTP error, collection rejected)
    timeout  the collection poll never completed within the budget
    corrupt  the fleet ANSWERED, but wrongly — the collected aggregate
             failed HPKE open / field decode, or decoded to a value
             different from the known plaintext sum.  No other signal
             in the system can express this.

Per-stage latency attribution reuses the trace plane: each probe report
carries a minted traceparent, and ``probe_stage_latencies`` extracts
upload→commit and upload→first-prepare deltas from the replicas' merged
chrome traces (tools/trace_merge.py), the same way
``loadgen.first_prepare_percentiles`` does.  Stages the prober can time
from its own clock (upload-ack, collection, e2e) are always recorded.

Degradation-aware backoff: the canary must never add pressure to a
browning-out fleet.  When the process-wide datastore tracker is in
strict SUSPECT, or an upload is shed with 503, the probe cycle is
SUPPRESSED — counted (``janus_canary_backoffs_total{reason}``), never
alerting, and the verdict state machine does not move.  Two fences keep
suppression from masking a hard outage: a 503 whose body names the
datastore-unavailable path (retries exhausted — infrastructure down,
not admission control) is a LOUD upload error, and an unbroken streak
of shed suppressions past ``shed_escalate_after`` escalates to one —
the fleet refusing work forever is indistinguishable from the fleet
being down, and a black-box prober must page on it.

Batch strategy: each probe cycle aggregates its own already-closed time
bucket, allocated monotonically backward per task (``_alloc_bucket``) so
no two cycles ever share or re-query a batch interval — and a collect
rejected with ``batchQueriedTooManyTimes`` (a restarted prober
re-walking ground covered before its crash) is a suppressed
``bucket_collision`` backoff, not a failure.

The rolled-up fleet verdict (healthy / degraded / failing + last-good
timestamp + failing stage) renders in the ``/statusz`` ``canary``
section and the ``janus_canary_verdict_state{task}`` gauge.
"""

from __future__ import annotations

import asyncio
import logging
import os
import secrets
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger("janus_tpu_torch.canary")

VERDICT_HEALTHY = "healthy"
VERDICT_DEGRADED = "degraded"
VERDICT_FAILING = "failing"
_VERDICT_LEVEL = {VERDICT_HEALTHY: 0, VERDICT_DEGRADED: 1, VERDICT_FAILING: 2}

#: Stage labels on janus_canary_probe_seconds.  upload_ack / collection /
#: e2e come from the prober's own clock; commit / first_prepare are
#: trace-attributed (present only when a trace glob is configured).
STAGES = ("upload_ack", "commit", "first_prepare", "collection", "e2e")


# ---------------------------------------------------------------------------
# Known-plaintext probe families


@dataclass(frozen=True)
class CanaryFamily:
    """One VDAF family's fixed probe: measurements and their exact sum."""

    name: str
    vdaf_instance: dict
    measurements: tuple
    expected: object


#: The registry ``canary.families`` names resolve through.  Measurements
#: are FIXED so the expected aggregate is a compile-time constant — the
#: whole point is that the verifier knows the answer before asking.
FAMILIES: Dict[str, CanaryFamily] = {
    "prio3_sum": CanaryFamily(
        name="prio3_sum",
        vdaf_instance={"type": "Prio3Sum", "bits": 8},
        measurements=(13, 42, 7),
        expected=62,
    ),
    "prio3_histogram": CanaryFamily(
        name="prio3_histogram",
        vdaf_instance={"type": "Prio3Histogram", "length": 4, "chunk_length": 2},
        measurements=(0, 2, 2),
        expected=[1, 0, 2, 0],
    ),
}


def _matches(actual, expected) -> bool:
    """Exact-sum comparison, tolerant of list/tuple/np-array shapes."""
    try:
        if isinstance(expected, (list, tuple)):
            return list(actual) == list(expected)
        return int(actual) == int(expected)
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Trace-plane stage attribution


def _trace_merge_module():
    """Import tools/trace_merge.py (the repo's merged-trace reader); None
    when the tools tree is absent — attribution then degrades to the
    prober's own clock, never fails a probe."""
    try:
        tools_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "tools",
        )
        if tools_dir not in sys.path:
            sys.path.insert(0, tools_dir)
        import trace_merge

        return trace_merge
    except Exception:
        return None


def probe_stage_latencies(
    trace_paths: Sequence[str], sampled_ids: Sequence[str]
) -> Dict[str, List[float]]:
    """Per-stage latency samples (seconds) for the sampled probe uploads,
    read from merged chrome traces — the ``first_prepare_percentiles``
    extraction generalized to every stage boundary trace_stats exposes:
    ``commit`` = upload span start → upload_commit end, ``first_prepare``
    = upload span start → first flush-family span.  ``trace_paths`` may
    contain globs.  Empty lists when nothing resolves (tracing off,
    offsetless pids dropped, ids not found)."""
    import glob as globmod

    out: Dict[str, List[float]] = {"commit": [], "first_prepare": []}
    tm = _trace_merge_module()
    if tm is None:
        return out
    paths: List[str] = []
    for pat in trace_paths:
        hits = sorted(globmod.glob(pat))
        paths.extend(hits if hits else ([pat] if os.path.exists(pat) else []))
    sampled = set(sampled_ids)
    if not paths or not sampled:
        return out
    try:
        events = tm.merge_events(paths)
        # each sampled id's OWN earliest upload-span start (a merged group
        # may carry many probes; the group minimum would skew them all)
        upload_ts: Dict[str, float] = {}
        for ev in events:
            if ev.get("ph") == "X" and ev.get("name") == "upload":
                tid = ev.get("args", {}).get("trace_id")
                if tid in sampled:
                    ts = ev.get("ts", 0)
                    if tid not in upload_ts or ts < upload_ts[tid]:
                        upload_ts[tid] = ts
        for g in tm.trace_stats(events)["merged_traces"]:
            stage_ts = g["stages_ts_us"]
            ids = set(g["trace_ids"]) & sampled
            if not ids:
                continue
            for stage, key in (("commit", "commit"), ("first_prepare", "first_flush")):
                ts = stage_ts.get(key)
                if ts is None:
                    continue
                for tid in ids:
                    t0 = upload_ts.get(tid)
                    if t0 is not None and ts >= t0:
                        out[stage].append((ts - t0) / 1e6)
    except Exception:
        logger.exception("trace stage attribution failed (probe still counted)")
    return out


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# Probe results and per-family verdict state


@dataclass
class ProbeResult:
    """One family's probe cycle outcome."""

    family: str
    outcome: str  # ok | error | timeout | corrupt | suppressed
    stage: Optional[str] = None  # failing stage (non-ok outcomes)
    reason: Optional[str] = None  # backoff reason (suppressed only)
    stages_s: Dict[str, float] = field(default_factory=dict)
    expected: object = None
    actual: object = None
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.outcome == "ok"

    @property
    def suppressed(self) -> bool:
        return self.outcome == "suppressed"


class _FamilyState:
    """Consecutive-failure verdict machine for one canary task.
    Suppressed probes deliberately do not move it — a browning-out fleet
    is degraded, not WRONG, and db_health already tells that story."""

    def __init__(self):
        self.probes = 0
        self.suppressed = 0
        #: consecutive upload-shed suppressions with no completed probe in
        #: between — the escalation fence against a permanent 503 wall
        self.shed_streak = 0
        self.consecutive_failures = 0
        self.last_outcome: Optional[str] = None
        self.failing_stage: Optional[str] = None
        self.last_good_unix: Optional[float] = None
        self.last_detail = ""

    def verdict(self, fail_threshold: int) -> str:
        if self.consecutive_failures >= max(1, fail_threshold):
            return VERDICT_FAILING
        if self.consecutive_failures > 0:
            return VERDICT_DEGRADED
        return VERDICT_HEALTHY


class _CanaryTask:
    """One provisioned canary task: the identity + keys the prober holds."""

    def __init__(self, family: CanaryFamily, task_id, vdaf, collector_keypair,
                 collector_token, leader_hpke_config=None, helper_hpke_config=None):
        self.family = family
        self.task_id = task_id
        self.vdaf = vdaf
        self.collector_keypair = collector_keypair
        self.collector_token = collector_token
        self.leader_hpke_config = leader_hpke_config
        self.helper_hpke_config = helper_hpke_config
        #: completed-probe counter (stats only)
        self.seq = 0
        #: next time bucket to probe — allocated monotonically BACKWARD
        #: from the most recent closed bucket at first use, so no two
        #: probes ever share (or re-query) a batch interval even when a
        #: precision boundary crosses between cycles (deriving the walk
        #: from the live wall clock instead collides exactly then: "now"
        #: advances one precision while the sequence advances one step)
        self.next_bucket: Optional[int] = None


# ---------------------------------------------------------------------------
# The prober


class CanaryPlane:
    """Black-box prober over the real DAP path.

    ``cfg`` is duck-typed (binaries.config.CanaryConfig in production,
    any namespace in tests): leader_endpoint, helper_endpoint,
    leader_task_api, helper_task_api, task_api_auth_token, families,
    probe_interval_s, collect_timeout_s, poll_interval_s,
    fail_threshold, time_precision_s, trace_globs."""

    def __init__(self, cfg, *, metrics=None, wall_fn=time.time, mono_fn=time.monotonic):
        self.cfg = cfg
        self._metrics = metrics
        self._wall = wall_fn
        self._mono = mono_fn
        self._lock = threading.Lock()
        self._tasks: Dict[str, _CanaryTask] = {}
        self._states: Dict[str, _FamilyState] = {}
        self._backoffs: Dict[str, int] = {}
        #: recent per-stage samples for the /statusz p50/p99 rollup
        self._stage_samples: Dict[str, deque] = {s: deque(maxlen=256) for s in STAGES}
        for name in cfg.families:
            if name not in FAMILIES:
                raise ValueError(
                    f"canary: unknown family {name!r} (known: {sorted(FAMILIES)})"
                )
            self._states[name] = _FamilyState()

    @property
    def metrics(self):
        if self._metrics is not None:
            return self._metrics
        from .metrics import GLOBAL_METRICS

        return GLOBAL_METRICS

    # -- provisioning ----------------------------------------------------
    def adopt_task(self, family_name: str, task_id, vdaf, collector_keypair,
                   collector_token, leader_hpke_config=None, helper_hpke_config=None):
        """Directly install an already-provisioned canary task (in-process
        harnesses; production goes through ensure_provisioned)."""
        fam = FAMILIES[family_name]
        with self._lock:
            self._tasks[family_name] = _CanaryTask(
                fam, task_id, vdaf, collector_keypair, collector_token,
                leader_hpke_config, helper_hpke_config,
            )

    async def ensure_provisioned(self, session) -> None:
        """Create the canary tasks through both aggregators' management
        APIs (aggregator_api.py POST /tasks): the same task_id, verify
        key, and aggregator auth token land as role Leader on the leader
        and role Helper on the helper; the prober keeps the collector
        keypair and token.  Idempotent per family; raises on API failure
        so the caller can retry next cycle."""
        from ..core.auth_tokens import AuthenticationToken
        from ..core.hpke import HpkeKeypair
        from ..messages import TaskId
        from ..messages.dap import _b64url

        for idx, name in enumerate(self.cfg.families):
            with self._lock:
                if name in self._tasks:
                    continue
            fam = FAMILIES[name]
            from ..vdaf.instances import vdaf_from_instance

            vdaf = vdaf_from_instance(fam.vdaf_instance)
            task_id = TaskId.random()
            vk = secrets.token_bytes(16)
            collector_kp = HpkeKeypair.generate(200 + idx)
            agg_token = secrets.token_urlsafe(24)
            col_token = secrets.token_urlsafe(24)
            common = {
                "task_id": _b64url(task_id.data),
                "query_type": {"kind": "TimeInterval"},
                "vdaf": fam.vdaf_instance,
                "vdaf_verify_key": _b64url(vk),
                # the whole probe must be collectable: one cycle's reports
                # exactly fill a batch
                "min_batch_size": len(fam.measurements),
                "time_precision": int(self.cfg.time_precision_s),
                "aggregator_auth_token": agg_token,
                "collector_hpke_config": _b64url(collector_kp.config.get_encoded()),
            }
            for api, body in (
                (
                    self.cfg.leader_task_api,
                    dict(
                        common,
                        role="Leader",
                        peer_aggregator_endpoint=self.cfg.helper_endpoint,
                        collector_auth_token=col_token,
                    ),
                ),
                (
                    self.cfg.helper_task_api,
                    dict(
                        common,
                        role="Helper",
                        peer_aggregator_endpoint=self.cfg.leader_endpoint,
                    ),
                ),
            ):
                url = api.rstrip("/") + "/tasks"
                headers = {
                    "Authorization": f"Bearer {self.cfg.task_api_auth_token}",
                    "Content-Type": "application/json",
                }
                async with session.post(url, json=body, headers=headers) as resp:
                    if resp.status != 201:
                        raise RuntimeError(
                            f"canary task provisioning failed at {url}: "
                            f"{resp.status} {await resp.text()}"
                        )
            self.adopt_task(
                name,
                task_id,
                vdaf,
                collector_kp,
                AuthenticationToken.new_bearer(col_token),
            )
            logger.info(
                "canary task provisioned: family=%s task=%s batch=%d",
                name,
                task_id,
                len(fam.measurements),
            )

    # -- degradation-aware backoff ---------------------------------------
    def _backoff_reason(self) -> Optional[str]:
        """Strict-SUSPECT gate: the SAME predicate the upload shed uses
        (db_health strict state), so the canary stands down exactly when
        the fleet starts refusing work."""
        try:
            from .db_health import DB_SUSPECT, tracker

            if tracker().state() == DB_SUSPECT:
                return "db_suspect"
        except Exception:
            pass
        return None

    def _count_backoff(self, family: str, reason: str) -> None:
        metrics = self.metrics
        with self._lock:
            self._backoffs[reason] = self._backoffs.get(reason, 0) + 1
            self._states[family].suppressed += 1
        if metrics.registry is not None:
            metrics.canary_backoffs.labels(reason=reason).inc()

    # -- the probe cycle -------------------------------------------------
    async def probe_once(self, session) -> List[ProbeResult]:
        """One full cycle: every provisioned family probed in turn."""
        results = []
        for name in list(self.cfg.families):
            task = self._tasks.get(name)
            if task is None:
                continue
            results.append(await self._probe_task(task, session))
        return results

    def _alloc_bucket(self, task: _CanaryTask, precision: int) -> int:
        """Allocate the probe's time bucket: distinct, already closed, and
        never re-queried.  The walk starts at the most recent closed
        bucket and steps monotonically backward PER TASK — it must not be
        re-derived from the live wall clock each cycle, because when a
        precision boundary crosses between two probes "now" advances one
        precision while the sequence advances one step and the two cancel
        into the SAME bucket (the leader then rejects the second collect
        with batchQueriedTooManyTimes)."""
        with self._lock:
            task.seq += 1
            nb = task.next_bucket
            if nb is None:
                nb = (int(self._wall()) // precision) * precision - precision
            task.next_bucket = nb - precision
        return nb

    async def _probe_task(self, task: _CanaryTask, session) -> ProbeResult:
        from ..client import prepare_report
        from ..messages import Duration, Interval, Report, Time

        name = task.family.name
        reason = self._backoff_reason()
        if reason is not None:
            self._count_backoff(name, reason)
            return ProbeResult(family=name, outcome="suppressed", reason=reason)

        precision = int(self.cfg.time_precision_s)
        bucket_start = self._alloc_bucket(task, precision)
        report_time = Time(bucket_start)

        if task.leader_hpke_config is None or task.helper_hpke_config is None:
            try:
                task.leader_hpke_config = await self._fetch_hpke_config(
                    session, self.cfg.leader_endpoint, task.task_id
                )
                task.helper_hpke_config = await self._fetch_hpke_config(
                    session, self.cfg.helper_endpoint, task.task_id
                )
            except Exception as e:
                return self._finish(
                    task, "error", "upload", detail=f"hpke_config fetch: {e}"
                )

        # -- upload stage ------------------------------------------------
        t0 = self._mono()
        sampled_ids: List[str] = []
        upload_url = (
            self.cfg.leader_endpoint.rstrip("/") + f"/tasks/{task.task_id}/reports"
        )
        for m in task.family.measurements:
            report = prepare_report(
                task.vdaf,
                task.task_id,
                task.leader_hpke_config,
                task.helper_hpke_config,
                Duration(precision),
                m,
                time=report_time,
            )
            tid = secrets.token_hex(16)
            headers = {
                "Content-Type": Report.MEDIA_TYPE,
                "traceparent": f"00-{tid}-{secrets.token_hex(8)}-01",
            }
            try:
                async with session.put(
                    upload_url, data=report.get_encoded(), headers=headers
                ) as resp:
                    if resp.status == 503:
                        return self._classify_503(task, (await resp.text())[:200])
                    if resp.status not in (200, 201):
                        return self._finish(
                            task,
                            "error",
                            "upload",
                            detail=f"upload {resp.status}: {(await resp.text())[:200]}",
                        )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                return self._finish(task, "error", "upload", detail=f"upload: {e}")
            sampled_ids.append(tid)
        upload_ack_s = self._mono() - t0

        # -- collection stage --------------------------------------------
        from ..collector import Collector, CollectorError
        from ..messages import Query

        collector = Collector(
            task_id=task.task_id,
            leader_endpoint=self.cfg.leader_endpoint,
            vdaf=task.vdaf,
            auth_token=task.collector_token,
            hpke_keypair=task.collector_keypair,
            poll_interval=float(getattr(self.cfg, "poll_interval_s", 0.5)),
            max_poll_time=float(getattr(self.cfg, "collect_timeout_s", 60.0)),
        )
        query = Query.new_time_interval(
            Interval(Time(bucket_start), Duration(precision))
        )
        t1 = self._mono()
        try:
            result = await collector.collect(query, session=session)
        except asyncio.CancelledError:
            raise
        except CollectorError as e:
            if "batchQueriedTooManyTimes" in str(e):
                # This bucket was already collected — a restarted prober
                # re-walking ground it covered before its crash.  The
                # allocator has already moved past it; stand down this
                # cycle instead of paging on our own bookkeeping.
                self._count_backoff(name, "bucket_collision")
                return ProbeResult(
                    family=name, outcome="suppressed", reason="bucket_collision"
                )
            timed_out = "timed out" in str(e)
            stage = (
                self._attribute_timeout_stage(sampled_ids)
                if timed_out
                else "collection"
            )
            return self._finish(
                task,
                "timeout" if timed_out else "error",
                stage,
                stages_s={"upload_ack": upload_ack_s},
                sampled_ids=sampled_ids,
                detail=str(e)[:200],
            )
        except Exception as e:
            # The fleet RETURNED an aggregate, but it would not open or
            # decode — a wrong answer, not an outage.
            return self._finish(
                task,
                "corrupt",
                "verify",
                stages_s={"upload_ack": upload_ack_s},
                sampled_ids=sampled_ids,
                detail=f"decrypt/decode: {e}"[:200],
            )
        collection_s = self._mono() - t1
        e2e_s = self._mono() - t0

        # -- verify stage ------------------------------------------------
        if not _matches(result.aggregate_result, task.family.expected):
            return self._finish(
                task,
                "corrupt",
                "verify",
                stages_s={"upload_ack": upload_ack_s, "collection": collection_s},
                sampled_ids=sampled_ids,
                expected=task.family.expected,
                actual=result.aggregate_result,
                detail="aggregate mismatch",
            )
        return self._finish(
            task,
            "ok",
            None,
            stages_s={
                "upload_ack": upload_ack_s,
                "collection": collection_s,
                "e2e": e2e_s,
            },
            sampled_ids=sampled_ids,
            expected=task.family.expected,
            actual=result.aggregate_result,
        )

    def _classify_503(self, task: _CanaryTask, body: str) -> ProbeResult:
        """503 taxonomy: an intentional shed (admission control, brownout
        suppression) means STAND DOWN — the fleet is refusing work on
        purpose and canary pressure would make it worse.  But the
        datastore-unavailable 503 (tx retries exhausted behind the
        handler) is infrastructure failure wearing a retryable status,
        and an unbroken shed streak past ``shed_escalate_after`` is a
        front door that never reopened — both are LOUD upload failures."""
        name = task.family.name
        if "datastore unavailable" in body:
            return self._finish(
                task, "error", "upload", detail=f"upload 503: {body}"
            )
        limit = int(getattr(self.cfg, "shed_escalate_after", 3))
        with self._lock:
            streak = self._states[name].shed_streak
        if streak >= limit:
            # once declared an outage the wall STAYS loud — only a probe
            # that actually gets past upload resets the streak
            return self._finish(
                task,
                "error",
                "upload",
                detail=f"upload shed {streak + 1} cycles running: {body}",
                keep_shed_streak=True,
            )
        self._count_backoff(name, "upload_shed")
        with self._lock:
            self._states[name].shed_streak += 1
        return ProbeResult(family=name, outcome="suppressed", reason="upload_shed")

    async def _fetch_hpke_config(self, session, endpoint: str, task_id):
        from ..core.hpke import is_hpke_config_supported
        from ..messages import HpkeConfigList

        url = endpoint.rstrip("/") + "/hpke_config?task_id=" + str(task_id)
        async with session.get(url) as resp:
            if resp.status != 200:
                raise RuntimeError(f"hpke_config fetch failed: {resp.status}")
            body = await resp.read()
        for config in HpkeConfigList.get_decoded(body).hpke_configs:
            if is_hpke_config_supported(config):
                return config
        raise RuntimeError("no supported HPKE config advertised")

    def _attribute_timeout_stage(self, sampled_ids: List[str]) -> str:
        """Attribute a poll timeout from traces: a first-prepare span for
        our reports means the pipeline prepared but never collected;
        their absence means they never reached prepare."""
        globs = list(getattr(self.cfg, "trace_globs", ()) or ())
        if not globs:
            return "collection"
        stages = probe_stage_latencies(globs, sampled_ids)
        if stages.get("first_prepare"):
            return "collection"
        return "prepare"

    # -- outcome recording -----------------------------------------------
    def _finish(
        self,
        task: _CanaryTask,
        outcome: str,
        stage: Optional[str],
        stages_s: Optional[Dict[str, float]] = None,
        sampled_ids: Optional[List[str]] = None,
        expected=None,
        actual=None,
        detail: str = "",
        keep_shed_streak: bool = False,
    ) -> ProbeResult:
        name = task.family.name
        stages_s = dict(stages_s or {})
        # trace-plane attribution: commit + first-prepare deltas for this
        # probe's reports (best-effort; off when no trace glob configured)
        globs = list(getattr(self.cfg, "trace_globs", ()) or ())
        if globs and sampled_ids:
            for stage_name, samples in probe_stage_latencies(globs, sampled_ids).items():
                if samples:
                    stages_s[stage_name] = max(samples)
        metrics = self.metrics
        have = metrics.registry is not None
        ok = outcome == "ok"
        with self._lock:
            st = self._states[name]
            st.probes += 1
            if not keep_shed_streak:
                st.shed_streak = 0  # a probe got past upload: wall is open
            st.last_outcome = outcome
            st.last_detail = detail
            if ok:
                st.consecutive_failures = 0
                st.failing_stage = None
                st.last_good_unix = self._wall()
            else:
                st.consecutive_failures += 1
                st.failing_stage = stage
            verdict = st.verdict(int(getattr(self.cfg, "fail_threshold", 2)))
            for stage_name, seconds in stages_s.items():
                if stage_name in self._stage_samples:
                    self._stage_samples[stage_name].append(seconds)
        if have:
            metrics.canary_verdicts.labels(task=name, outcome=outcome).inc()
            metrics.canary_probe_outcome.observe(0.0 if ok else 2.0)
            metrics.canary_verdict_state.labels(task=name).set(_VERDICT_LEVEL[verdict])
            for stage_name, seconds in stages_s.items():
                metrics.canary_probe_seconds.labels(stage=stage_name).observe(seconds)
            if ok and "e2e" in stages_s:
                metrics.canary_e2e.observe(stages_s["e2e"])
        if not ok:
            logger.warning(
                "canary probe %s: outcome=%s stage=%s %s", name, outcome, stage, detail
            )
        return ProbeResult(
            family=name,
            outcome=outcome,
            stage=stage,
            stages_s=stages_s,
            expected=expected,
            actual=actual,
            detail=detail,
        )

    # -- rollup ----------------------------------------------------------
    def fleet_verdict(self) -> str:
        """Worst family verdict — the one pageable signal."""
        threshold = int(getattr(self.cfg, "fail_threshold", 2))
        with self._lock:
            verdicts = [st.verdict(threshold) for st in self._states.values()]
        if not verdicts:
            return VERDICT_HEALTHY
        return max(verdicts, key=lambda v: _VERDICT_LEVEL[v])

    def stats(self) -> dict:
        """The /statusz ``canary`` section."""
        threshold = int(getattr(self.cfg, "fail_threshold", 2))
        with self._lock:
            families = {
                name: {
                    "verdict": st.verdict(threshold),
                    "probes": st.probes,
                    "suppressed": st.suppressed,
                    "shed_streak": st.shed_streak,
                    "consecutive_failures": st.consecutive_failures,
                    "last_outcome": st.last_outcome,
                    "failing_stage": st.failing_stage,
                    "last_good_unix": st.last_good_unix,
                    "last_detail": st.last_detail,
                    "provisioned": name in self._tasks,
                }
                for name, st in self._states.items()
            }
            stage_latency = {}
            for stage, samples in self._stage_samples.items():
                vals = sorted(samples)
                stage_latency[stage] = {
                    "samples": len(vals),
                    "p50": _percentile(vals, 0.50),
                    "p99": _percentile(vals, 0.99),
                }
            backoffs = dict(self._backoffs)
        return {
            "enabled": True,
            "verdict": self.fleet_verdict(),
            "fail_threshold": threshold,
            "families": families,
            "stage_latency_s": stage_latency,
            "backoffs": backoffs,
        }


# ---------------------------------------------------------------------------
# Process-wide plane (the /statusz + binaries seam)

_PLANE: Optional[CanaryPlane] = None


def configure_canary(cfg, metrics=None, **kwargs) -> Optional[CanaryPlane]:
    """Install (or clear, with a falsy config) the process-wide prober."""
    global _PLANE
    if not cfg:
        _PLANE = None
        return None
    _PLANE = CanaryPlane(cfg, metrics=metrics, **kwargs)
    return _PLANE


def canary_plane() -> Optional[CanaryPlane]:
    return _PLANE


def canary_stats() -> dict:
    """The /statusz ``canary`` section (explicit disabled marker when no
    prober runs in this process)."""
    if _PLANE is None:
        return {"enabled": False}
    return _PLANE.stats()
