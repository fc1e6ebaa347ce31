"""Tracing/logging configuration.

The analog of the reference's ``TraceConfiguration`` (reference:
aggregator/src/trace.rs:36-236): pretty or JSON structured stdout logging
with a runtime-reloadable level filter (the reference exposes this as PUT
``/traceconfigz`` on the health port; our health server does the same).
Copy of ``janus_tpu/core/trace.py``; its ``start_profiler_server`` (the
JAX profiler socket) becomes a small aiohttp listener that captures a
``torch.profiler`` window on request.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import secrets
import sys
import time
from dataclasses import dataclass
from typing import Optional


# -- cross-process trace context ---------------------------------------------
# The fleet-wide correlation layer (reference: trace.rs OTel trace layer +
# the W3C traceparent the OTLP exporter propagates): a trace id is minted
# once per pipeline entity (upload batch / aggregation job / collection
# job), persisted on the job row, carried leader->helper in DAP HTTP
# headers, and bound here — a contextvar, so it follows the asyncio task —
# for every log line and ChromeTracer span to pick up.  That is what makes
# one aggregation job's timeline joinable across replica processes.

#: fields: trace_id (32 hex chars), task_id, job_id — all optional strings
_TRACE_CTX: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "janus_trace_ctx", default={}
)

#: ctx keys stamped onto log records and chrome-trace span args
TRACE_CTX_KEYS = ("trace_id", "task_id", "job_id")


def new_trace_id() -> str:
    """A W3C-traceparent-style 16-byte random trace id (32 hex chars)."""
    return secrets.token_hex(16)


def current_trace() -> dict:
    """The bound trace context ({} when none)."""
    return _TRACE_CTX.get()


def bind_trace(**fields) -> contextvars.Token:
    """Merge ``fields`` (trace_id/task_id/job_id) into the bound context;
    returns a token for :func:`unbind_trace`.  None values are dropped so
    an unset field inherits the enclosing scope's."""
    merged = dict(_TRACE_CTX.get())
    for k, v in fields.items():
        if v is not None:
            merged[k] = str(v)
    return _TRACE_CTX.set(merged)


def unbind_trace(token: contextvars.Token) -> None:
    _TRACE_CTX.reset(token)


@contextlib.contextmanager
def trace_scope(**fields):
    """``with trace_scope(trace_id=..., task_id=..., job_id=...):`` — the
    scoped form of bind/unbind used by job steppers and HTTP handlers."""
    token = bind_trace(**fields)
    try:
        yield
    finally:
        unbind_trace(token)


def current_traceparent() -> Optional[str]:
    """The bound context as a W3C ``traceparent`` header value
    (``00-<trace-id>-<span-id>-01``), or None when no trace id is bound.
    The span id is minted per call: each outbound hop is its own span."""
    trace_id = _TRACE_CTX.get().get("trace_id")
    if not trace_id:
        return None
    return f"00-{trace_id}-{secrets.token_hex(8)}-01"


def inject_traceparent(headers: dict) -> None:
    """Stamp the bound context's ``traceparent`` onto outbound request
    ``headers`` (no-op when no trace id is bound) — the one place every
    peer-HTTP path calls so cross-process correlation cannot be forgotten
    by a new client."""
    traceparent = current_traceparent()
    if traceparent:
        headers["traceparent"] = traceparent


def parse_traceparent(value: Optional[str]) -> Optional[str]:
    """Extract the trace id from a ``traceparent`` header (None on any
    malformation — a bad peer header must never break request handling)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32:
        return None
    trace_id = parts[1].lower()
    # strict per-char hex: int(x, 16) would accept '+'/'-'/'_' and
    # whitespace, adopting ids W3C-strict peers will drop downstream
    if any(c not in "0123456789abcdef" for c in trace_id):
        return None
    if trace_id == "0" * 32:
        return None
    return trace_id


@dataclass
class TraceConfiguration:
    """reference: trace.rs:36"""

    use_json: bool = False
    level: str = "INFO"


class TraceContextFilter(logging.Filter):
    """Stamps the bound trace context onto every log record, so formatters
    (and ad-hoc ``%(trace_id)s`` format strings) can render it."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _TRACE_CTX.get()
        for key in TRACE_CTX_KEYS:
            setattr(record, key, ctx.get(key))
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line (reference: trace.rs json/stackdriver
    stdout modes), carrying the bound trace context when present."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for key in TRACE_CTX_KEYS:
            value = getattr(record, key, None)
            if value is not None:
                doc[key] = value
        if record.exc_info:
            doc["exception"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def install_trace_subscriber(config: Optional[TraceConfiguration] = None) -> None:
    """reference: trace.rs:119 install_trace_subscriber"""
    config = config or TraceConfiguration()
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stdout)
    handler.addFilter(TraceContextFilter())
    if config.use_json:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
    root.addHandler(handler)
    root.setLevel(getattr(logging, config.level.upper(), logging.INFO))


def reload_trace_filter(level: str) -> None:
    """Runtime log-level reload (reference: binary_utils.rs:422-456
    /traceconfigz)."""
    logging.getLogger().setLevel(getattr(logging, level.upper(), logging.INFO))


# -- span sinks --------------------------------------------------------------
# Secondary consumers of closed spans (the OTLP exporter, core/otlp.py):
# callables ``sink(name, cat, epoch_start_s, dur_s, args)``.  Spans reach
# sinks whether or not chrome tracing is configured — the ChromeTracer
# forwards from emit(), and the module-level span helpers forward directly
# when no tracer exists.  Sink errors are swallowed: an export problem must
# never break the traced code path.

_SPAN_SINKS: list = []


def register_span_sink(sink) -> None:
    if sink not in _SPAN_SINKS:
        _SPAN_SINKS.append(sink)


def unregister_span_sink(sink) -> None:
    try:
        _SPAN_SINKS.remove(sink)
    except ValueError:
        pass


def _forward_span(name: str, cat: str, epoch_start_s: float, dur_s: float, args: dict) -> None:
    for sink in list(_SPAN_SINKS):
        try:
            sink(name, cat, epoch_start_s, dur_s, args)
        except Exception:
            pass


# -- chrome-trace export -----------------------------------------------------
# The analog of the reference's chrome tracing layer (trace.rs:145-156
# ChromeLayer): spans around job steps / device launches, written in the
# Trace Event Format chrome://tracing and Perfetto load directly.


class ChromeTracer:
    """Incremental Trace-Event-Format writer (JSON array of "X" events).

    Thread-safe; events are appended as they close, so a crash loses at most
    the open spans (the format tolerates a missing closing bracket).

    Cross-process merging (tools/trace_merge.py): events carry the real OS
    pid, every span inherits the bound trace context (trace_id/task_id/
    job_id) into its args, and a ``clock_sync`` metadata event records the
    wall-clock epoch of this process's monotonic t0 so per-replica files
    can be rebased onto one shared timeline.  A restarted replica pointed
    at the same path APPENDS (its new pid gets its own clock_sync) instead
    of truncating the dead incarnation's events.
    """

    def __init__(self, path: str):
        import threading

        self.path = path
        self._lock = threading.Lock()
        self._closed = False
        append = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "a" if append else "w")
        if not append:
            self._f.write("[\n")
        else:
            # the dead incarnation may have been SIGKILLed mid-write: start
            # on a fresh line so its partial trailing line cannot swallow
            # our clock_sync event (trace_merge needs it to rebase us)
            self._f.write("\n")
        self.pid = os.getpid()
        self._t0 = time.monotonic()
        self._epoch_t0 = time.time()
        self._write_event(
            {
                "name": "clock_sync",
                "ph": "M",
                "pid": self.pid,
                "tid": 0,
                "args": {"epoch_t0": self._epoch_t0},
            }
        )
        self._write_event(
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": f"{os.path.basename(sys.argv[0] or 'python')}:{self.pid}"},
            }
        )

    def _write_event(self, ev: dict) -> None:
        line = json.dumps(ev) + ",\n"
        with self._lock:
            if self._closed:
                return
            self._f.write(line)
            self._f.flush()

    def emit(self, name: str, cat: str, start_s: float, dur_s: float, **args) -> None:
        import threading

        # Concurrent spans must land on distinct tracks: same-track
        # overlapping "X" events render as bogus nesting in trace viewers.
        # Thread identity separates executor/launch spans; same-thread
        # asyncio concurrency (job steps) additionally keys on the running
        # task so parallel steps get their own rows.
        tid = threading.get_ident() % 100000
        try:
            import asyncio

            task = asyncio.current_task()
            if task is not None:
                tid = 100000 + id(task) % 100000
        except RuntimeError:
            pass
        ctx = _TRACE_CTX.get()
        for key in TRACE_CTX_KEYS:
            if key not in args and ctx.get(key) is not None:
                args[key] = ctx[key]
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "pid": self.pid,
            "tid": tid,
            "ts": round((start_s - self._t0) * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
        }
        if args:
            ev["args"] = args
        self._write_event(ev)
        if _SPAN_SINKS:
            _forward_span(
                name, cat, self._epoch_t0 + (start_s - self._t0), dur_s, dict(args)
            )

    def span(self, name: str, cat: str = "job", **args):
        return _Span(self, name, cat, args)

    def close(self) -> None:
        """Flush and close; idempotent (the graceful-shutdown path and an
        atexit/teardown race may both call it)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._f.write("{}]\n")  # sentinel keeps the array valid JSON
            self._f.close()


class _Span:
    def __init__(self, tracer: ChromeTracer, name: str, cat: str, args):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, *_):
        self.tracer.emit(
            self.name,
            self.cat,
            self.start,
            time.monotonic() - self.start,
            ok=exc_type is None,
            **self.args,
        )
        return False


_GLOBAL_TRACER: Optional[ChromeTracer] = None


def configure_chrome_trace(path: Optional[str]) -> Optional[ChromeTracer]:
    """Enable (or disable with None) process-wide chrome-trace output."""
    global _GLOBAL_TRACER
    if _GLOBAL_TRACER is not None:
        _GLOBAL_TRACER.close()
        _GLOBAL_TRACER = None
    if path:
        _GLOBAL_TRACER = ChromeTracer(path)
    return _GLOBAL_TRACER


def close_chrome_trace() -> None:
    """Flush/close the global tracer WITHOUT dropping the configuration
    handle — the binaries' graceful-shutdown (SIGTERM) hook, so soak traces
    are never truncated mid-event.  Safe to call when tracing is off."""
    if _GLOBAL_TRACER is not None:
        _GLOBAL_TRACER.close()


def chrome_trace_path() -> Optional[str]:
    """The active chrome-trace output path (None when tracing is off) —
    surfaced by /statusz."""
    return _GLOBAL_TRACER.path if _GLOBAL_TRACER is not None else None


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SinkSpan:
    """Span measured for the registered sinks only (OTLP configured while
    chrome tracing is off) — mirrors _Span's context inheritance."""

    def __init__(self, name: str, cat: str, args: dict):
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, *_):
        _sink_emit(
            self.name,
            self.cat,
            self.start,
            time.monotonic() - self.start,
            dict(self.args, ok=exc_type is None),
        )
        return False


def _sink_emit(name: str, cat: str, start_mono_s: float, dur_s: float, args: dict) -> None:
    """Forward a monotonic-timed span to the sinks with the bound trace
    context merged in (the ChromeTracer-less twin of ChromeTracer.emit)."""
    ctx = _TRACE_CTX.get()
    for key in TRACE_CTX_KEYS:
        if key not in args and ctx.get(key) is not None:
            args[key] = ctx[key]
    epoch_start = time.time() - (time.monotonic() - start_mono_s)
    _forward_span(name, cat, epoch_start, dur_s, args)


def tracing_active() -> bool:
    """True when SOME span consumer exists (chrome tracer or a sink) —
    the cheap guard for span producers whose data gathering is itself
    expensive (e.g. a datastore query feeding a link span)."""
    return _GLOBAL_TRACER is not None or bool(_SPAN_SINKS)


def trace_span(name: str, cat: str = "job", **args):
    """Span against the global tracer (and any registered span sinks);
    free no-op when both are off."""
    t = _GLOBAL_TRACER
    if t is not None:
        return t.span(name, cat, **args)
    if _SPAN_SINKS:
        return _SinkSpan(name, cat, args)
    return _NULL_SPAN


def emit_span(name: str, cat: str, start_s: float, dur_s: float, **args) -> None:
    """Emit an already-measured span directly (no context manager) —
    retroactive CHILD spans whose interval is known only after the parent
    closed, e.g. the per-submission shares of one executor mega-batch
    flush.  Explicit trace_id/task_id/job_id args override the calling
    context's, so a flush running on the executor's loop can stamp each
    child with ITS submitter's identity.  Free no-op when tracing is off."""
    t = _GLOBAL_TRACER
    if t is not None:
        t.emit(name, cat, start_s, dur_s, **args)
    elif _SPAN_SINKS:
        _sink_emit(name, cat, start_s, dur_s, dict(args))



def start_profiler_server(port: int, host: str = "127.0.0.1") -> bool:
    """Opt-in on-device profiling: an aiohttp listener on ``port`` (its own
    thread and event loop) an operator can capture from at any time (the
    analog of the reference's always-on observability sockets,
    trace.rs:158-236).  ``GET /profile?seconds=N`` runs a
    ``torch.profiler`` window of N seconds (default 2, at most 60) with CPU
    and, where there is a card, CUDA activities, and answers with its
    chrome trace (JSON).  Returns False, logged, when torch or aiohttp is
    unavailable or the listener cannot bind: a dead profiler socket never
    takes a replica down."""
    import tempfile
    import threading

    log = logging.getLogger("janus_tpu_torch.trace")
    try:
        import torch
        from aiohttp import web
    except Exception:
        log.exception("torch or aiohttp unavailable; profiler server not started")
        return False
    lock = threading.Lock()  # one capture at a time

    def capture(seconds: float) -> bytes:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with lock, tempfile.TemporaryDirectory() as tmp:
            with torch.profiler.profile(activities=activities) as prof:
                time.sleep(seconds)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path, "rb") as f:
                return f.read()

    async def profile(request):
        try:
            seconds = min(60.0, max(0.0, float(request.query.get("seconds", "2"))))
        except ValueError:
            return web.Response(status=400, text="seconds must be a number\n")
        import asyncio

        body = await asyncio.get_running_loop().run_in_executor(None, capture, seconds)
        return web.Response(body=body, content_type="application/json")

    started = threading.Event()
    ok = []

    def serve():
        import asyncio

        async def main():
            app = web.Application()
            app.add_routes([web.get("/profile", profile)])
            runner = web.AppRunner(app)
            await runner.setup()
            try:
                await web.TCPSite(runner, host, port).start()
            except Exception:
                log.exception("could not start the profiler server on %s:%d", host, port)
                started.set()
                return
            ok.append(True)
            started.set()
            await asyncio.Event().wait()  # serves until the process exits

        asyncio.run(main())

    threading.Thread(target=serve, name="janus-profiler-server", daemon=True).start()
    started.wait(10.0)
    return bool(ok)
