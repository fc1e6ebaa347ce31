"""Declarative SLO evaluation plane: the fleet judges its own freshness.

Copy of ``janus_tpu/core/slo.py`` for the PyTorch port.  The fleet's
freshness histograms (report commit age, job age at
acquire, collection end-to-end) are judged here: ``common.slos`` declares
objectives over those histograms and a burn-rate evaluator — driven by
the same status-sampler tick that publishes the backlog gauges — computes
multi-window burn rates from histogram snapshots, emits
``janus_slo_burn_rate{slo,window}`` / ``janus_slo_breach_total{slo}``,
and renders its verdicts in ``/statusz``.

The math is the standard multi-window, multi-burn-rate SLO alert (SRE
workbook shape): an SLO is "P of events complete within T seconds".
From a latency histogram, good = samples <= T (rounded DOWN to the
nearest bucket bound — the effective threshold is reported), bad = the
rest.  Over a trailing window W the error rate is bad_delta/total_delta
between snapshots, and the burn rate is error_rate / (1 - objective):
1.0 spends the error budget exactly at the sustainable pace.  A BREACH
is the transition into (fast-window burn >= fast threshold AND
slow-window burn >= slow threshold) — the fast window catches the page,
the slow window keeps a blip from paging.

Declarative config (``common.slos``; signal defaults to the SLO name)::

    slos:
      commit_age:        {objective: 0.99, threshold_s: 60}
      collection_e2e:    {objective: 0.95, threshold_s: 600, fast_burn: 10}
      job_age_at_acquire: {objective: 0.99, threshold_s: 30}
      first_flush:       {objective: 0.9,  threshold_s: 1.0}
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

#: SLO signal name -> histogram metric family.  The freshness histograms
#: plus the upload-to-commit latency and the executor's submission
#: wait (the "warm first-flush latency" an operator actually feels).
SIGNALS = {
    "commit_age": "janus_report_commit_age_seconds",
    "upload_to_commit": "janus_report_upload_to_commit_seconds",
    "job_age_at_acquire": "janus_job_age_at_acquire_seconds",
    "collection_e2e": "janus_collection_e2e_seconds",
    "first_flush": "janus_executor_wait_duration_seconds",
    # Canary plane (core/canary.py): black-box probe end-to-end latency
    # and probe success rate (the outcome histogram observes 0.0 on
    # success / 2.0 on failure, so any threshold_s in [0.5, 2) makes
    # good == successes under the standard histogram_totals math).
    "canary_e2e_latency": "janus_canary_e2e_seconds",
    "canary_success": "janus_canary_probe_outcome",
}


def _known_histogram_families() -> set:
    """Histogram family names from the live metric catalog — the set a
    raw ``janus_*`` SLO signal must resolve into.  A signal naming a
    family that does not exist (or is not a histogram) would silently
    evaluate over zero events forever; better to fail startup."""
    from .metrics import GLOBAL_METRICS

    out = set()
    for line in GLOBAL_METRICS.catalog():
        name, kind, _labels = line.split("|", 2)
        if kind == "histogram":
            out.add(name)
    return out


@dataclass
class SloTarget:
    """One declarative objective over a latency histogram."""

    name: str
    threshold_s: float
    objective: float = 0.99
    signal: str = ""  # defaults to name; raw janus_* family names allowed
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    #: burn-rate thresholds per window (GCP/SRE-workbook defaults for a
    #: 2%-budget fast page and a sustained slow leak)
    fast_burn: float = 14.0
    slow_burn: float = 2.0

    def __post_init__(self):
        if not self.signal:
            self.signal = self.name
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"slo {self.name}: objective must be in (0, 1)")
        if self.threshold_s <= 0:
            raise ValueError(f"slo {self.name}: threshold_s must be positive")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"slo {self.name}: fast_window_s must be < slow_window_s"
            )

    @property
    def family(self) -> str:
        fam = SIGNALS.get(self.signal)
        if fam is not None:
            return fam
        if self.signal.startswith("janus_"):
            if self.signal in _known_histogram_families():
                return self.signal
            raise ValueError(
                f"slo {self.name}: raw signal {self.signal!r} is not a "
                f"histogram family in the metric catalog — a typo'd SLO "
                f"must fail startup, not silently evaluate zero events"
            )
        raise ValueError(
            f"slo {self.name}: unknown signal {self.signal!r} "
            f"(known: {sorted(SIGNALS)} or a raw janus_* histogram name)"
        )


def targets_from_config(cfg: dict) -> List[SloTarget]:
    """``common.slos`` (name -> spec mapping) -> validated targets.
    Strict on unknown keys: a typo'd burn threshold must fail startup,
    not silently evaluate defaults."""
    targets = []
    known = {
        "signal",
        "objective",
        "threshold_s",
        "fast_window_s",
        "slow_window_s",
        "fast_burn",
        "slow_burn",
    }
    for name, spec in (cfg or {}).items():
        if not isinstance(spec, dict):
            raise ValueError(f"slo {name}: expected a mapping, got {spec!r}")
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"slo {name}: unknown keys {sorted(unknown)}")
        if "threshold_s" not in spec:
            raise ValueError(f"slo {name}: threshold_s is required")
        tgt = SloTarget(name=name, **{k: spec[k] for k in spec})
        tgt.family  # validate the signal eagerly
        targets.append(tgt)
    return targets


def histogram_totals(families: dict, family: str, threshold_s: float):
    """(total, good, effective_threshold) summed across every label set of
    ``family`` in a snapshot_metric_families() view.  ``good`` counts
    samples <= the largest bucket bound <= threshold_s (None when the
    threshold undercuts every bound — everything is then "bad")."""
    fam = families.get(family)
    if fam is None or fam["kind"] != "histogram":
        return 0, 0, None
    total = good = 0
    effective = None
    for _labels, h in fam["series"]:
        total += h["count"]
        bounds = h["bounds"]
        idx = None
        for i, b in enumerate(bounds):
            if b <= threshold_s:
                idx = i
            else:
                break
        if idx is not None:
            effective = bounds[idx]
            good += sum(h["bucket_counts"][: idx + 1])
    return total, good, effective


class SloEvaluator:
    """Multi-window burn-rate evaluator over the process's histograms.

    ``tick()`` is driven by the binaries' status-sampler loop; everything
    it reads is an in-memory registry snapshot, so a tick is cheap and a
    wedged datastore cannot stall SLO evaluation."""

    def __init__(self, targets: List[SloTarget], metrics=None, time_fn=time.monotonic):
        self.targets = list(targets)
        self._metrics = metrics
        self._time = time_fn
        self._lock = threading.Lock()
        #: per-slo deque of (t, total, good) snapshots
        self._history: Dict[str, deque] = {t.name: deque() for t in self.targets}
        self._breaching: Dict[str, bool] = {t.name: False for t in self.targets}
        self._breaches: Dict[str, int] = {t.name: 0 for t in self.targets}
        self._last: Dict[str, dict] = {}
        self._ticks = 0

    @property
    def metrics(self):
        if self._metrics is not None:
            return self._metrics
        from .metrics import GLOBAL_METRICS

        return GLOBAL_METRICS

    # -- the tick --------------------------------------------------------
    def tick(self) -> Dict[str, dict]:
        from .otlp import snapshot_metric_families

        metrics = self.metrics
        now = self._time()
        families = {f["name"]: f for f in snapshot_metric_families(metrics)}
        have = metrics.registry is not None
        with self._lock:
            self._ticks += 1
            for tgt in self.targets:
                total, good, effective = histogram_totals(
                    families, tgt.family, tgt.threshold_s
                )
                hist = self._history[tgt.name]
                hist.append((now, total, good))
                # keep exactly one snapshot at/behind the slow window edge
                # (the slow baseline); everything older is dead weight
                while len(hist) >= 2 and hist[1][0] <= now - tgt.slow_window_s:
                    hist.popleft()
                fast = self._burn_rate(hist, now, tgt.fast_window_s, tgt.objective)
                slow = self._burn_rate(hist, now, tgt.slow_window_s, tgt.objective)
                breaching = (
                    fast > 0
                    and fast >= tgt.fast_burn
                    and slow >= tgt.slow_burn
                )
                if breaching and not self._breaching[tgt.name]:
                    self._breaches[tgt.name] += 1
                    if have:
                        metrics.slo_breaches.labels(slo=tgt.name).inc()
                self._breaching[tgt.name] = breaching
                if have:
                    metrics.slo_burn_rate.labels(slo=tgt.name, window="fast").set(fast)
                    metrics.slo_burn_rate.labels(slo=tgt.name, window="slow").set(slow)
                self._last[tgt.name] = {
                    "signal": tgt.signal,
                    "family": tgt.family,
                    "objective": tgt.objective,
                    "threshold_s": tgt.threshold_s,
                    "effective_threshold_s": effective,
                    "events_total": total,
                    "good_total": good,
                    "burn_rate": {"fast": round(fast, 4), "slow": round(slow, 4)},
                    "windows_s": {"fast": tgt.fast_window_s, "slow": tgt.slow_window_s},
                    "burn_thresholds": {"fast": tgt.fast_burn, "slow": tgt.slow_burn},
                    "breaching": breaching,
                    "breaches": self._breaches[tgt.name],
                }
            return dict(self._last)

    @staticmethod
    def _burn_rate(hist, now: float, window_s: float, objective: float) -> float:
        """Burn rate over the trailing window: deltas between the current
        snapshot and the newest snapshot at/behind the window edge (the
        oldest available when history is younger than the window)."""
        cutoff = now - window_s
        base = hist[0]
        for snap in hist:
            if snap[0] <= cutoff:
                base = snap
            else:
                break
        _t0, base_total, base_good = base
        _t1, cur_total, cur_good = hist[-1]
        d_total = cur_total - base_total
        if d_total <= 0:
            return 0.0
        d_bad = (cur_total - cur_good) - (base_total - base_good)
        error_rate = min(1.0, max(0.0, d_bad / d_total))
        return error_rate / max(1e-9, 1.0 - objective)

    # -- introspection ---------------------------------------------------
    def status(self) -> dict:
        """The /statusz "slo" section."""
        with self._lock:
            return {
                "targets": len(self.targets),
                "ticks": self._ticks,
                "slos": dict(self._last)
                or {t.name: {"signal": t.signal} for t in self.targets},
            }


# -- process-wide evaluator ---------------------------------------------------

_EVALUATOR: Optional[SloEvaluator] = None


def configure_slos(cfg, metrics=None) -> Optional[SloEvaluator]:
    """Install (or clear, with a falsy config) the process-wide evaluator.
    ``cfg`` is either the ``common.slos`` mapping or a prebuilt target
    list."""
    global _EVALUATOR
    if not cfg:
        _EVALUATOR = None
        return None
    targets = (
        list(cfg)
        if cfg and isinstance(next(iter(cfg), None), SloTarget)
        else targets_from_config(cfg)
    )
    _EVALUATOR = SloEvaluator(targets, metrics=metrics)
    return _EVALUATOR


def slo_evaluator() -> Optional[SloEvaluator]:
    return _EVALUATOR


def evaluate_tick() -> None:
    """One status-sampler-driven evaluation pass; no-op when unconfigured."""
    if _EVALUATOR is not None:
        _EVALUATOR.tick()


def slo_status() -> dict:
    """The /statusz "slo" section (an explicit disabled marker when no
    targets are configured)."""
    if _EVALUATOR is None:
        return {"targets": 0, "ticks": 0, "slos": {}}
    return _EVALUATOR.status()
