"""OTLP export: plug the fleet's spans and metrics into real collectors.

Copy of ``janus_tpu/core/otlp.py`` for the PyTorch port.  The analog of the reference's ``otlp`` trace/metrics features (reference:
aggregator/src/trace.rs OpenTelemetryConfiguration + metrics.rs otlp
exporter): when ``common.otlp_endpoint`` is set, ChromeTracer spans (via
the span-sink hook in core/trace.py) and the process's metric registry
(prometheus_client or the pure-Python FallbackRegistry — both) are pushed
to an OTLP collector.

IMPORT-GATED on the **opentelemetry-sdk**'s presence.  The bare
``opentelemetry`` API package is not enough (a host may ship the API
without the SDK), so the gate probes ``opentelemetry.sdk`` specifically.
Without the SDK the exporter is a FIRST-CLASS no-op: configuring it never
raises, spans offered to it are counted as dropped, export ticks are
no-ops, and ``/statusz`` reports the ``otlp`` section as ``unavailable``
— a binary whose config names a collector starts cleanly anywhere and
says exactly why nothing is arriving.

Span path (SDK present): spans are queued by the trace sink and flushed
on the status-sampler tick through an SDK tracer backed by the OTLP/HTTP
span exporter; the original 32-hex trace id is preserved by parenting
each span under a remote SpanContext carrying it, so the collector's view
joins the same cross-process timeline the chrome-trace merge does.

Metric path (SDK present): each export tick snapshots the registry and
POSTs one OTLP/HTTP JSON resourceMetrics document to
``<endpoint>/v1/metrics`` — counters as monotonic sums, gauges as gauges,
histograms as OTLP histograms with the registry's bucket bounds.
"""

from __future__ import annotations

import json
import logging
import secrets
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger("janus_tpu_torch.otlp")

try:  # the gate: SDK, not just the API shim
    from opentelemetry.sdk.resources import Resource  # noqa: F401

    HAVE_OTEL_SDK = True
except ImportError:  # pragma: no cover - exercised where the SDK is absent
    HAVE_OTEL_SDK = False

OTEL_UNAVAILABLE_REASON = "opentelemetry-sdk not installed"


@dataclass
class OtlpConfig:
    """``common.otlp_endpoint`` plus the exporter's local knobs."""

    endpoint: str
    service_name: str = "janus_tpu_torch"
    #: spans buffered between export ticks; beyond it the OLDEST are
    #: dropped (and counted) — export trouble must never grow memory
    max_queue_spans: int = 4096
    timeout_s: float = 5.0


class OtlpExporter:
    """Span queue + metric snapshot pusher with self-reporting health.

    All public methods are safe to call whether or not the SDK is
    installed; ``available`` says which world we are in.
    """

    def __init__(self, config: OtlpConfig):
        self.config = config
        self.available = HAVE_OTEL_SDK
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._queued_total = 0
        self._dropped_total = 0
        self._exported_total = 0
        self._exports_ok = 0
        self._exports_err = 0
        self._last_export_t: Optional[float] = None
        self._last_error: Optional[str] = None
        self._sdk_tracer = None
        if self.available:
            try:
                self._sdk_tracer = self._build_sdk_tracer()
            except Exception as e:  # SDK present but exporter wiring failed
                self.available = False
                self._last_error = f"otlp sdk setup failed: {e}"
                logger.exception("OTLP exporter setup failed; exporting disabled")

    # -- SDK wiring (never runs on SDK-less hosts) ----------------------
    def _build_sdk_tracer(self):  # pragma: no cover - needs the SDK
        from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        resource = Resource.create({"service.name": self.config.service_name})
        provider = TracerProvider(resource=resource)
        provider.add_span_processor(
            BatchSpanProcessor(
                OTLPSpanExporter(
                    endpoint=self.config.endpoint.rstrip("/") + "/v1/traces",
                    timeout=self.config.timeout_s,
                ),
                # the processor's queue must not undercut our own drain
                # size, or a burst silently drops inside the SDK
                max_queue_size=max(2048, self.config.max_queue_spans),
            )
        )
        self._sdk_provider = provider
        return provider.get_tracer("janus_tpu_torch")

    def shutdown(self) -> None:
        """Tear down the SDK pipeline (flush + stop its export thread).
        configure_otlp calls this on replace/disable so spans never keep
        flowing to an endpoint the operator disconnected; safe to call on
        an unavailable exporter."""
        provider = getattr(self, "_sdk_provider", None)
        if provider is not None:  # pragma: no cover - needs the SDK
            try:
                provider.shutdown()
            except Exception:
                logger.exception("OTLP provider shutdown failed")
            self._sdk_provider = None
            self._sdk_tracer = None
            self.available = False

    # -- span intake (the core/trace.py sink) ---------------------------
    def record_span(
        self, name: str, cat: str, epoch_start_s: float, dur_s: float, args: dict
    ) -> None:
        """Queue one closed span.  Inert (drop + count) without the SDK."""
        from .metrics import GLOBAL_METRICS

        if not self.available:
            with self._lock:
                self._dropped_total += 1
            if GLOBAL_METRICS.registry is not None:
                GLOBAL_METRICS.otlp_spans.labels(outcome="dropped").inc()
            return
        dropped = 0
        with self._lock:
            self._queue.append((name, cat, epoch_start_s, dur_s, dict(args or {})))
            self._queued_total += 1
            while len(self._queue) > self.config.max_queue_spans:
                self._queue.popleft()
                self._dropped_total += 1
                dropped += 1
        if GLOBAL_METRICS.registry is not None:
            GLOBAL_METRICS.otlp_spans.labels(outcome="queued").inc()
            if dropped:
                GLOBAL_METRICS.otlp_spans.labels(outcome="dropped").inc(dropped)

    # -- export tick (status-sampler cadence) ---------------------------
    def export_once(self, metrics=None) -> bool:
        """Flush queued spans and push one metric snapshot.  Never raises;
        returns True on a fully successful export.  A no-op (and counted
        as such) when the SDK is absent."""
        from .metrics import GLOBAL_METRICS

        metrics = metrics if metrics is not None else GLOBAL_METRICS
        have = metrics.registry is not None
        if not self.available:
            if have:
                metrics.otlp_exports.labels(outcome="noop").inc()
            return False
        with self._lock:
            spans, self._queue = list(self._queue), deque()
        ok = True
        try:  # pragma: no cover - needs the SDK
            self._export_spans_sdk(spans)
            # BatchSpanProcessor delivers asynchronously: force the flush
            # and only count spans "exported" when it reports success —
            # a broken /v1/traces pipeline must not read as healthy
            if spans and not self._sdk_provider.force_flush(
                int(self.config.timeout_s * 1000)
            ):
                raise RuntimeError("span flush timed out / dropped")
            self._post_metrics_json(metrics)
            with self._lock:
                self._exported_total += len(spans)
                self._exports_ok += 1
                self._last_export_t = time.monotonic()
                self._last_error = None
        except Exception as e:  # pragma: no cover - needs the SDK
            ok = False
            with self._lock:
                self._exports_err += 1
                self._dropped_total += len(spans)
                self._last_error = str(e)[:200]
            logger.warning("OTLP export failed: %s", e)
        if have:
            metrics.otlp_exports.labels(outcome="ok" if ok else "error").inc()
            if ok and spans:
                metrics.otlp_spans.labels(outcome="exported").inc(len(spans))
        return ok

    def _export_spans_sdk(self, spans) -> None:  # pragma: no cover - needs SDK
        import opentelemetry.trace as ot

        for name, cat, epoch_start_s, dur_s, args in spans:
            start_ns = int(epoch_start_s * 1e9)
            end_ns = start_ns + max(0, int(dur_s * 1e9))
            context = None
            trace_id = args.get("trace_id")
            if isinstance(trace_id, str) and len(trace_id) == 32:
                try:
                    # parent the span under a remote context carrying the
                    # fleet's minted trace id, so the collector's trace
                    # view joins the chrome-trace/W3C one
                    parent = ot.NonRecordingSpan(
                        ot.SpanContext(
                            trace_id=int(trace_id, 16),
                            span_id=int(secrets.token_hex(8), 16),
                            is_remote=True,
                            trace_flags=ot.TraceFlags(ot.TraceFlags.SAMPLED),
                        )
                    )
                    context = ot.set_span_in_context(parent)
                except Exception:
                    context = None
            attrs = {"janus.cat": cat}
            for k, v in args.items():
                if isinstance(v, (str, bool, int, float)):
                    attrs[f"janus.{k}"] = v
            span = self._sdk_tracer.start_span(
                name, context=context, start_time=start_ns, attributes=attrs
            )
            span.end(end_time=end_ns)

    # -- metrics as OTLP/HTTP JSON --------------------------------------
    def _post_metrics_json(self, metrics) -> None:  # pragma: no cover - needs SDK
        doc = self._metrics_document(metrics)
        if doc is None:
            return
        req = urllib.request.Request(
            self.config.endpoint.rstrip("/") + "/v1/metrics",
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.config.timeout_s):
            pass

    def _metrics_document(self, metrics) -> Optional[dict]:
        """One OTLP/HTTP JSON resourceMetrics doc from the registry
        snapshot (either backend).  Pure and SDK-free, so the mapping is
        unit-testable without the SDK."""
        now_ns = int(time.time() * 1e9)
        otlp_metrics = []
        for fam in snapshot_metric_families(metrics):
            dps = []
            if fam["kind"] == "histogram":
                for labels, h in fam["series"]:
                    dps.append(
                        {
                            "attributes": _otlp_attrs(labels),
                            "timeUnixNano": now_ns,
                            "count": h["count"],
                            "sum": h["sum"],
                            "bucketCounts": h["bucket_counts"],
                            "explicitBounds": h["bounds"],
                        }
                    )
                body = {"dataPoints": dps, "aggregationTemporality": 2}
                key = "histogram"
            else:
                for labels, value in fam["series"]:
                    dps.append(
                        {
                            "attributes": _otlp_attrs(labels),
                            "timeUnixNano": now_ns,
                            "asDouble": value,
                        }
                    )
                if fam["kind"] == "counter":
                    body = {
                        "dataPoints": dps,
                        "aggregationTemporality": 2,
                        "isMonotonic": True,
                    }
                    key = "sum"
                else:
                    body = {"dataPoints": dps}
                    key = "gauge"
            if dps:
                otlp_metrics.append(
                    {"name": fam["name"], "description": fam["help"], key: body}
                )
        if not otlp_metrics:
            return None
        return {
            "resourceMetrics": [
                {
                    "resource": {
                        "attributes": _otlp_attrs(
                            {"service.name": self.config.service_name}
                        )
                    },
                    "scopeMetrics": [
                        {
                            "scope": {"name": "janus_tpu_torch"},
                            "metrics": otlp_metrics,
                        }
                    ],
                }
            ]
        }

    # -- health ----------------------------------------------------------
    def health(self) -> dict:
        """The /statusz "otlp" section (and the soak's probe)."""
        with self._lock:
            last_age = (
                round(time.monotonic() - self._last_export_t, 1)
                if self._last_export_t is not None
                else None
            )
            # the SDK may be present but mis-wired (__init__ caught a
            # setup error): report THAT, not a missing-SDK message the
            # operator cannot act on
            reason = None
            if not self.available:
                reason = self._last_error or OTEL_UNAVAILABLE_REASON
            return {
                "state": "active" if self.available else "unavailable",
                "reason": reason,
                "endpoint": self.config.endpoint,
                "queued": len(self._queue),
                "queued_total": self._queued_total,
                "exported_total": self._exported_total,
                "dropped_total": self._dropped_total,
                "exports_ok": self._exports_ok,
                "exports_err": self._exports_err,
                "last_export_age_s": last_age,
                "last_error": self._last_error,
            }


def _otlp_attrs(labels: dict) -> list:
    return [{"key": k, "value": {"stringValue": str(v)}} for k, v in labels.items()]


def snapshot_metric_families(metrics) -> list:
    """Uniform registry snapshot: [{name, help, kind, series}] where
    ``series`` is [(labels_dict, value_or_histogram_dict)] — one reader for
    prometheus_client and FallbackRegistry so the OTLP mapping (and the
    SLO evaluator's histogram reads) cannot drift between backends."""
    from .metrics import FallbackRegistry

    registry = metrics.registry
    if registry is None:
        return []
    out = []
    if isinstance(registry, FallbackRegistry):
        for m in registry.families():
            with m._lock:
                if m.kind == "histogram":
                    series = []
                    for key, (count, total, buckets) in m._hist.items():
                        series.append(
                            (
                                dict(zip(m.labelnames, key)),
                                {
                                    "count": count,
                                    "sum": total,
                                    "bounds": list(m.buckets),
                                    # OTLP wants per-bucket (not cumulative)
                                    # counts plus the +Inf overflow bucket
                                    "bucket_counts": _decumulate(buckets, count),
                                },
                            )
                        )
                else:
                    series = [
                        (dict(zip(m.labelnames, key)), value)
                        for key, value in m._values.items()
                    ]
            out.append(
                {
                    "name": m.name,
                    "help": m.documentation,
                    "kind": m.kind,
                    "series": series,
                }
            )
        return out
    # prometheus_client CollectorRegistry
    for fam in registry.collect():
        kind = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}.get(
            fam.type
        )
        if kind is None:
            continue
        if kind == "histogram":
            # regroup flat samples back into per-labelset histograms
            hists: dict = {}
            for s in fam.samples:
                labels = dict(s.labels)
                le = labels.pop("le", None)
                key = tuple(sorted(labels.items()))
                h = hists.setdefault(
                    key, {"labels": labels, "buckets": [], "count": 0, "sum": 0.0}
                )
                if s.name.endswith("_bucket"):
                    h["buckets"].append((float(le), s.value))
                elif s.name.endswith("_count"):
                    h["count"] = int(s.value)
                elif s.name.endswith("_sum"):
                    h["sum"] = s.value
            series = []
            for h in hists.values():
                buckets = sorted(h["buckets"])
                bounds = [b for b, _ in buckets if b != float("inf")]
                cumulative = [int(v) for b, v in buckets if b != float("inf")]
                series.append(
                    (
                        h["labels"],
                        {
                            "count": h["count"],
                            "sum": h["sum"],
                            "bounds": bounds,
                            "bucket_counts": _decumulate(cumulative, h["count"]),
                        },
                    )
                )
        else:
            series = [
                (dict(s.labels), s.value)
                for s in fam.samples
                if not s.name.endswith(("_created", "_gsum", "_gcount"))
            ]
        out.append(
            {"name": fam.name, "help": fam.documentation, "kind": kind, "series": series}
        )
    return out


def _decumulate(cumulative, total) -> list:
    """Cumulative bucket counts -> per-bucket counts + +Inf overflow."""
    out, prev = [], 0
    for c in cumulative:
        out.append(int(c - prev))
        prev = c
    out.append(int(total - prev))
    return out


# -- process-wide exporter ----------------------------------------------------

_EXPORTER: Optional[OtlpExporter] = None


def configure_otlp(
    endpoint: Optional[str], service_name: str = "janus_tpu_torch"
) -> Optional[OtlpExporter]:
    """Enable (or disable with a falsy endpoint) process-wide OTLP export.
    Registers the span sink with core/trace.py only when the SDK is
    actually present — the unavailable exporter costs the traced paths
    nothing."""
    global _EXPORTER
    from .trace import register_span_sink, unregister_span_sink

    if _EXPORTER is not None:
        unregister_span_sink(_EXPORTER.record_span)
        _EXPORTER.shutdown()
        _EXPORTER = None
    if not endpoint:
        return None
    _EXPORTER = OtlpExporter(OtlpConfig(endpoint=endpoint, service_name=service_name))
    if _EXPORTER.available:
        register_span_sink(_EXPORTER.record_span)
    return _EXPORTER


def otlp_exporter() -> Optional[OtlpExporter]:
    return _EXPORTER


def export_tick() -> None:
    """One status-sampler-driven export pass; no-op when unconfigured."""
    from .metrics import GLOBAL_METRICS

    if _EXPORTER is None:
        return
    _EXPORTER.export_once()
    if GLOBAL_METRICS.registry is not None:
        h = _EXPORTER.health()
        GLOBAL_METRICS.otlp_last_export_age.set(
            h["last_export_age_s"] if h["last_export_age_s"] is not None else -1
        )


def otlp_health() -> dict:
    """The /statusz "otlp" section: exporter health when configured, and
    an explicit disabled/unavailable marker when not."""
    if _EXPORTER is not None:
        return _EXPORTER.health()
    return {
        "state": "disabled" if HAVE_OTEL_SDK else "unavailable",
        "reason": None if HAVE_OTEL_SDK else OTEL_UNAVAILABLE_REASON,
        "endpoint": None,
    }
