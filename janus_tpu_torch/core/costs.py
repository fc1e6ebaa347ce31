"""Per-task device-plane cost attribution.

The executor coalesces many tasks' reports into one mega-batch flush, so
chip-level metrics (``janus_executor_launch_duration_seconds``) can say
the device is saturated without saying WHICH task is burning it — exactly
the per-tenant accelerator-utilization accounting framework-level proof
accelerators name as the scalability bottleneck (ZK-Flex, PAPERS.md).
This module is the attribution ledger:

* :meth:`TaskCostModel.attribute_flush` splits a flush's measured
  stage/launch durations across its submissions **proportionally by
  rows** into ``janus_task_device_seconds_total{task,phase,path}``; the
  split is conservative by construction — the per-task shares sum to the
  measured total (tests/test_cost_attribution.py proves it to 1e-6 for
  multi-task, oracle-fallback and padded-tail flushes).
* The ``path`` label (``device`` | ``oracle``) makes failure-domain cost
  shifts visible: when a breaker opens and jobs degrade to the CPU
  oracle, their seconds MOVE from ``path="device"`` to ``path="oracle"``
  on the same task series.  Oracle-side attribution rides the existing
  ``_observe_prepare`` seam in vdaf/backend.py via a thread-local task
  scope (:func:`run_in_task_scope`) because oracle batches run on worker
  threads where contextvars set on the event loop are invisible.
* ``janus_task_rows_total{task,outcome}`` (ok | rejected | error) and the
  ``janus_task_queue_delay_seconds{task}`` histogram complete the
  per-task picture: throughput, backpressure pain, and scheduling delay.

Cardinality is BOUNDED: at most ``max_tasks`` live task labels; beyond
the cap new tasks attribute to the ``task="other"`` overflow label until
retirement (riding the binaries' status-sampler tick, the same pattern as
``DeviceExecutor.retire_idle_buckets``) frees idle slots and removes
their series.  The model is process-wide — drivers, the helper, and the
executor all feed one ledger, like GLOBAL_METRICS itself.
"""

from __future__ import annotations

import base64
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

#: Overflow label: tasks beyond the cardinality cap attribute here until
#: retirement frees slots.  A rising "other" share on a dashboard is the
#: signal to raise ``common.cost_task_cardinality``.
OVERFLOW_LABEL = "other"
#: Label for rows submitted without a task identity (legacy callers).
UNATTRIBUTED_LABEL = "unattributed"

#: The closed label sets every series of a retired task must be swept
#: from (remove_series is quiet when a combination never fired).
#: stage/launch: executor flush shares; init/combine: direct backend
#: batches (oracle or device); drain: accumulator spill readbacks.
PHASES = ("stage", "launch", "init", "combine", "drain")
PATHS = ("device", "oracle")
ROW_OUTCOMES = ("ok", "rejected", "error")


def task_label(ident) -> str:
    """Render a task identity (the DAP task id bytes the drivers thread as
    ``task_ident``) as a bounded metric label — unpadded base64url, the
    same rendering TaskId.__str__ uses, so /metrics series line up with
    task ids in logs and the task API."""
    if ident is None:
        return UNATTRIBUTED_LABEL
    if isinstance(ident, bytes):
        return base64.urlsafe_b64encode(ident).rstrip(b"=").decode()
    return str(ident)


class _Entry:
    __slots__ = ("label", "last_used")

    def __init__(self, label: str):
        self.label = label
        self.last_used = time.monotonic()


class TaskCostModel:
    """Bounded per-task attribution ledger (one per process)."""

    def __init__(self, max_tasks: int = 64):
        self.max_tasks = max_tasks
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        #: attributions that landed on the overflow label (statusz + the
        #: operator's cue to raise the cap)
        self.overflowed = 0

    def configure(self, max_tasks: int) -> None:
        """Applied once at binary bootstrap; a lower cap takes effect on
        the next retirement pass (live entries are never evicted mid-use)."""
        with self._lock:
            self.max_tasks = max_tasks

    # -- label admission -------------------------------------------------
    def label_for(self, ident) -> str:
        """The task's metric label, admitting it into the tracked set
        (LRU-ordered).  Beyond the cap new tasks get the ``other``
        overflow label — cardinality is capped at ``max_tasks + 2``
        (overflow + unattributed) no matter how many tasks churn through."""
        if ident is None:
            return UNATTRIBUTED_LABEL
        key = ident if isinstance(ident, (bytes, str, int)) else repr(ident)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.last_used = time.monotonic()
                self._entries.move_to_end(key)
                return e.label
            if len(self._entries) >= max(1, self.max_tasks):
                self.overflowed += 1
                return OVERFLOW_LABEL
            e = _Entry(task_label(ident))
            self._entries[key] = e
            return e.label

    # -- attribution -----------------------------------------------------
    def attribute_flush(
        self,
        parts: Sequence[Tuple[object, int]],
        phase_seconds: Dict[str, float],
        path: str = "device",
    ) -> None:
        """Split each measured phase duration across ``parts`` —
        ``(task_ident, rows)`` per submission — proportionally by rows.
        Conservation invariant: sum over parts of attributed seconds ==
        the measured phase total (floating error only; padding rows are
        the flush's overhead and are attributed WITH the rows that caused
        them, so no time is orphaned on a phantom "padding task")."""
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None or not parts:
            return
        total_rows = sum(max(0, r) for _, r in parts)
        if total_rows <= 0:
            return
        # coalesce one submission-set's shares per label first: N
        # submissions of one task in one flush inc its series once
        shares: Dict[str, Dict[str, float]] = {}
        for ident, rows in parts:
            if rows <= 0:
                continue
            label = self.label_for(ident)
            frac = rows / total_rows
            tab = shares.setdefault(label, {})
            for phase, seconds in phase_seconds.items():
                if seconds and seconds > 0:
                    tab[phase] = tab.get(phase, 0.0) + seconds * frac
        for label, tab in shares.items():
            for phase, seconds in tab.items():
                GLOBAL_METRICS.task_device_seconds.labels(
                    task=label, phase=phase, path=path
                ).inc(seconds)

    def attribute_direct(
        self, ident, phase: str, path: str, seconds: float
    ) -> None:
        """Whole-batch attribution to ONE task (the oracle hook: an oracle
        batch serves exactly one task, so the measured duration attributes
        without a proportional split)."""
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None or seconds <= 0:
            return
        GLOBAL_METRICS.task_device_seconds.labels(
            task=self.label_for(ident), phase=phase, path=path
        ).inc(seconds)

    def observe_rows(self, ident, outcome: str, rows: int) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None or rows <= 0:
            return
        GLOBAL_METRICS.task_rows.labels(
            task=self.label_for(ident), outcome=outcome
        ).inc(rows)

    def observe_queue_delay(self, ident, delay_s: float) -> None:
        from .metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None:
            return
        GLOBAL_METRICS.task_queue_delay.labels(
            task=self.label_for(ident)
        ).observe(max(0.0, delay_s))

    # -- retirement ------------------------------------------------------
    def retire_idle(self, max_idle_s: float) -> int:
        """Drop task labels idle past ``max_idle_s`` and remove EVERY
        series they own (all phase/path/outcome combinations + the
        queue-delay histogram) — the sampler-tick cardinality cap, same
        contract as executor bucket retirement.  Returns labels retired."""
        if max_idle_s <= 0:
            return 0
        now = time.monotonic()
        retired: List[str] = []
        with self._lock:
            for key, e in list(self._entries.items()):
                if now - e.last_used >= max_idle_s:
                    del self._entries[key]
                    retired.append(e.label)
        if retired:
            from .metrics import GLOBAL_METRICS

            if GLOBAL_METRICS.registry is not None:
                for label in retired:
                    for phase in PHASES:
                        for path in PATHS:
                            GLOBAL_METRICS.remove_series(
                                GLOBAL_METRICS.task_device_seconds,
                                label,
                                phase,
                                path,
                            )
                    for outcome in ROW_OUTCOMES:
                        GLOBAL_METRICS.remove_series(
                            GLOBAL_METRICS.task_rows, label, outcome
                        )
                    GLOBAL_METRICS.remove_series(
                        GLOBAL_METRICS.task_queue_delay, label
                    )
        return len(retired)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tracked": len(self._entries),
                "cap": self.max_tasks,
                "overflowed": self.overflowed,
            }


# -- process-wide instance ---------------------------------------------------

_MODEL = TaskCostModel()


def cost_model() -> TaskCostModel:
    return _MODEL


def configure_cost_attribution(max_tasks: int) -> None:
    """Binary bootstrap hook (``common.cost_task_cardinality``)."""
    _MODEL.configure(max_tasks)


def reset_cost_model() -> None:
    """Tests only: drop tracked labels and overflow accounting (metric
    series persist in the registry as every counter does)."""
    with _MODEL._lock:
        _MODEL._entries.clear()
        _MODEL.overflowed = 0


def retire_idle_task_series(max_idle_s: float) -> int:
    """Sampler-tick companion (binaries/main.py) beside
    ``retire_idle_executor_buckets``."""
    return _MODEL.retire_idle(max_idle_s)


# -- thread-local task scope (the oracle-path hook) --------------------------
# Oracle batches run on run_in_executor worker threads, where contextvars
# bound on the event loop are invisible; a plain
# thread-local set INSIDE the worker callable is the reliable carrier.

_SCOPE = threading.local()


def current_task():
    """The task identity bound on THIS thread (None outside a scope)."""
    return getattr(_SCOPE, "ident", None)


def run_in_task_scope(ident, fn):
    """Run ``fn()`` with the task identity bound for cost attribution —
    wrap the CALLABLE handed to run_in_executor, so the scope is set on
    the worker thread that actually executes the oracle batch."""
    prev = getattr(_SCOPE, "ident", None)
    _SCOPE.ident = ident
    try:
        return fn()
    finally:
        _SCOPE.ident = prev


def attribute_prepare(backend_name: str, phase: str, seconds: float) -> None:
    """The vdaf/backend.py ``_observe_prepare`` hook: attribute a measured
    prepare/combine batch to the thread's bound task.  ``path`` derives
    from the backend name — the oracle is the CPU fallback, everything
    else is a device layout — so a breaker-open window shows as the same
    task's seconds shifting from ``device`` to ``oracle``.  No-op outside
    a task scope (unattributed producers stay invisible rather than
    polluting a catch-all series with double counts: executor flushes
    attribute via attribute_flush, not here)."""
    ident = current_task()
    if ident is None:
        return
    # substring, not equality: the CPU fallbacks are "oracle" (Prio3)
    # AND "poplar1-oracle" — both must land on path="oracle" or the
    # breaker cost shift is invisible for heavy hitters
    path = "oracle" if "oracle" in backend_name else "device"
    _MODEL.attribute_direct(ident, phase, path, seconds)
