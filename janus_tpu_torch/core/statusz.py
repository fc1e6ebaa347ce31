"""/statusz snapshot: one JSON document of live fleet state.

Copy of ``janus_tpu/core/statusz.py`` for the PyTorch port.  The thing an
operator curls when a soak wedges: served by every binary's health server
(binaries/main.py), it assembles the
process-local runtime state (executor buckets, accumulator occupancy,
circuit breakers, fault-registry arm state, trace configuration) plus the
datastore's shared view (outstanding accumulator-journal rows, lease
occupancy, acquirable backlog) into one consistent snapshot.  Everything
here is read-only and cheap — indexed COUNTs and in-memory stats — so
hitting it against a wedged replica never makes things worse.

The port has no process-wide executor: a binary passes the one it built
(``executor``) to the snapshot and to the sampler's bucket retirement.  Where the JAX snapshot names its platform, the port
reports the torch device (``device``: the CUDA runtime, whether this
process holds a CUDA context, the cards' names and the memory it has
allocated there, and each kernel wrapper's launches in this process).  The
executor's ``canonicalization`` section counts the shape plans of
``vdaf/canonical.py``, and its ``bucket_quarantine`` section the shape
buckets whose work is refused while they are quarantined; a mesh's circuit
is labelled ``mesh[n]#digest``.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

logger = logging.getLogger("janus_tpu_torch.statusz")

_PROCESS_START = time.monotonic()

#: the kernel wrappers whose launch counts the device section reports
KERNEL_WRAPPERS = (
    ("janus_tpu_torch.ops.keccak_kernels", ("squeeze", "absorb", "absorb_select")),
    ("janus_tpu_torch.ops.flp_kernels", ("wire_evals", "combine_decide", "sumvec_wires")),
    ("janus_tpu_torch.ops.field_kernels", ("lazy_reduce_digits",)),
)

def device_status() -> dict:
    """The torch device this process computes on: the CUDA runtime and
    every card's name, or the CPU.  torch is only read where the process
    has already imported it (a control-plane binary never loads it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {"torch": None}
    doc = {"torch": torch.__version__, "cuda_runtime": torch.version.cuda}
    try:
        # names and memory only where this process already holds a CUDA
        # context: the query must not create one
        doc["cuda_initialized"] = torch.cuda.is_initialized()
        if doc["cuda_initialized"]:
            count = torch.cuda.device_count()
            doc["devices"] = [torch.cuda.get_device_name(i) for i in range(count)]
            doc["memory_allocated_bytes"] = sum(torch.cuda.memory_allocated(i) for i in range(count))
        elif torch.cuda.is_available():
            doc["devices"] = []
        else:
            doc["devices"] = ["cpu"]
    except Exception:
        logger.exception("torch device query failed")
        doc["devices"] = {"error": "unavailable"}
    # each kernel wrapper's launch count in this process (a wrapper adds
    # one where it launches its CUDA kernel), once the module is loaded
    launches = {}
    for mod_name, names in KERNEL_WRAPPERS:
        mod = sys.modules.get(mod_name)
        for name in names if mod is not None else ():
            launches[f"{mod_name.rsplit('.', 1)[1]}.{name}"] = getattr(mod, name).launches
    doc["kernel_launches"] = launches
    return doc


def runtime_status(executor=None) -> dict:
    """Process-local sections (no datastore): safe to call anywhere.
    ``executor``: the binary's device executor (None: it runs none)."""
    from . import faults
    from .otlp import otlp_health
    from .slo import slo_status
    from .trace import chrome_trace_path, current_trace

    doc: dict = {
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _PROCESS_START, 1),
        "log_level": logging.getLevelName(logging.getLogger().level),
        "trace": {
            "chrome_trace_path": chrome_trace_path(),
            "context": current_trace() or None,
        },
        # OTLP export health: queued/dropped/last-export-age, or
        # the explicit unavailable marker when the SDK is absent
        "otlp": otlp_health(),
        # SLO evaluation plane: per-objective burn rates and
        # breach state from the sampler-driven evaluator
        "slo": slo_status(),
        "faults": faults.snapshot(),
        # Peer transport health: per-peer suspect/probing
        # state + failure counts — the first thing to check when a soak
        # quiesces (partition pressure vs a bug)
        "peers": _peer_stats(),
        # Datastore health: the process-wide brownout tracker
        # — state, consecutive/total transient tx failures, suspect
        # transitions — what separates "the fleet froze on purpose" from
        # "the fleet wedged"
        "datastore": _datastore_stats(),
        # Fleet control plane: this replica's membership view,
        # owned-task count, and migration total — disabled marker when no
        # router is installed
        "fleet": _fleet_stats(),
        # Upload front door: batched-open queue depth, shed
        # counts per reason, and batch/open totals — the overload story
        # at a glance (None on binaries that serve no uploads)
        "upload": _upload_stats(),
        # Zero-copy ingest plane: journal-writer depth/sheds,
        # staged-cohort occupancy, and materializer totals — None in
        # synchronous mode or on binaries that serve no uploads
        "ingest": _ingest_stats(),
        # Blast-radius isolation: per-stage quarantine counts,
        # bisection sieves run, checksum-failed journal rows, and the most
        # recent offenders — what the operator reads when the quarantine
        # alert fires
        "quarantine": _quarantine_stats(),
        # Canary plane: rolled-up fleet verdict, per-family
        # probe state + failing stage, stage-latency percentiles, and
        # counted backoffs — the one pageable signal; disabled marker on
        # binaries that run no prober
        "canary": _canary_stats(),
        "device": device_status(),
    }

    ex = executor
    if ex is None:
        doc["executor"] = {"enabled": False}
        doc["accumulator"] = None
    else:
        doc["executor"] = {
            "enabled": True,
            "buckets": ex.stats(),
            "circuits": ex.circuit_stats(),
            # per-shape build ledger: cold / warming / warm (+ last
            # compile_s) / failed, each with the age of its state — the
            # first thing to curl when a fresh task's flushes look slow
            "compile": ex.compile_stats(),
            # why shapes kept their exact shape: the pow2
            # canonicalization plan outcomes, counted per reason
            "canonicalization": _canonicalization_stats(),
            # flight recorder: the last flushes' black-box
            # records + dump counters — what the operator reads when a
            # breaker tripped or a flush went anomalously slow
            "flights": ex.flight_stats(),
            # per-task cost-attribution ledger occupancy: tracked labels
            # vs the cardinality cap, and how much landed on "other"
            "cost_attribution": _cost_stats(),
            # quarantined shape buckets (their work refused as retryable)
            # and the per-shape failure streaks feeding the gate
            "bucket_quarantine": ex.bucket_quarantine_stats(),
        }
        doc["accumulator"] = (
            ex.accumulator.stats() if ex.accumulator is not None else None
        )
    return doc


def _peer_stats() -> dict:
    """Per-peer transport health (core/peer_health.py); failure-tolerant
    like every other section — introspection must never take /statusz
    down."""
    try:
        from .peer_health import tracker

        return tracker().stats()
    except Exception:
        logger.exception("peer-health stats unavailable")
        return {"error": "unavailable"}


def _datastore_stats() -> dict:
    """Process-wide datastore brownout tracker (core/db_health.py);
    failure-tolerant like every other section — and deliberately
    process-local, so it renders even while the datastore itself is the
    thing that's down."""
    try:
        from .db_health import tracker

        return tracker().stats()
    except Exception:
        logger.exception("datastore-health stats unavailable")
        return {"error": "unavailable"}


def _fleet_stats() -> dict:
    """Fleet router view (core/fleet.py); failure-tolerant like every
    other section."""
    try:
        from .fleet import fleet_router

        router = fleet_router()
        if router is None:
            return {"enabled": False}
        return router.stats()
    except Exception:
        logger.exception("fleet stats unavailable")
        return {"error": "unavailable"}


def _upload_stats():
    """Front-door open-batcher stats (aggregator/report_writer.py);
    failure-tolerant like every other section.  None where the process
    never loaded the report writer (a driver, the creator, the canary): it
    has no front door, and importing the writer would load torch."""
    try:
        writer = sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.aggregator.report_writer")
        return None if writer is None else writer.frontdoor_stats()
    except Exception:
        logger.exception("upload front-door stats unavailable")
        return {"error": "unavailable"}


def _ingest_stats():
    """Ingest-plane stats (core/ingest.py); failure-tolerant like every
    other section."""
    try:
        from .ingest import ingest_stats

        return ingest_stats()
    except Exception:
        logger.exception("ingest stats unavailable")
        return {"error": "unavailable"}


def _quarantine_stats() -> dict:
    """Poison/corruption quarantine stats (core/quarantine.py);
    failure-tolerant like every other section."""
    try:
        from .quarantine import quarantine_stats

        return quarantine_stats()
    except Exception:
        logger.exception("quarantine stats unavailable")
        return {"error": "unavailable"}


def _canary_stats() -> dict:
    """Canary-plane verdict rollup (core/canary.py); failure-tolerant
    like every other section."""
    try:
        from .canary import canary_stats

        return canary_stats()
    except Exception:
        logger.exception("canary stats unavailable")
        return {"error": "unavailable"}


def _cost_stats() -> dict:
    """Per-task cost-attribution occupancy (core/costs.py); failure-
    tolerant like every other section."""
    try:
        from .costs import cost_model

        return cost_model().stats()
    except Exception:
        logger.exception("cost-attribution stats unavailable")
        return {"error": "unavailable"}


def _canonicalization_stats() -> dict:
    """Counted canonicalization-plan outcomes (vdaf/canonical.py); lazy
    and failure-tolerant — control-plane binaries may never import the
    vdaf layer, and /statusz must not force (or break on) it."""
    try:
        from ..vdaf.canonical import plan_stats

        return plan_stats()
    except Exception:
        logger.exception("canonicalization stats unavailable")
        return {"error": "unavailable"}


async def statusz_snapshot(datastore=None, clock=None, executor=None) -> dict:
    """The full document; ``datastore`` adds the shared-state sections
    (journal, leases, acquirable backlog), ``executor`` the executor's."""
    doc = runtime_status(executor)
    if datastore is None:
        doc["journal"] = None
        doc["leases"] = None
        return doc

    def q(tx):
        count, oldest = tx.accumulator_journal_stats()
        r_count, r_oldest = tx.report_journal_stats()
        # lease_summary carries the per-type 'acquirable' counts — it is
        # the single read-side source for the acquisition predicate
        return {
            "journal_rows": count,
            "journal_oldest": oldest,
            "report_journal_rows": r_count,
            "report_journal_oldest": r_oldest,
            "quarantined_rows": tx.count_quarantined_reports(),
            "leases": tx.lease_summary(),
        }

    try:
        shared = await datastore.run_tx_async("statusz", q)
    except Exception:
        # a wedged datastore must not take /statusz down with it — the
        # process-local sections are exactly what the operator needs then
        logger.exception("statusz datastore sections unavailable")
        doc["journal"] = {"error": "datastore unavailable"}
        doc["report_journal"] = {"error": "datastore unavailable"}
        doc["leases"] = {"error": "datastore unavailable"}
        return doc
    now_s = (clock or datastore.clock).now().seconds
    oldest = shared["journal_oldest"]
    doc["journal"] = {
        "outstanding_rows": shared["journal_rows"],
        "oldest_age_s": max(0, now_s - oldest) if oldest is not None else None,
    }
    # report journal: ACKed-but-unmaterialized reports.  A
    # rising oldest-age means the materializer stopped (or a journaled
    # replica died and nothing has replayed its rows yet).
    r_oldest = shared["report_journal_oldest"]
    doc["report_journal"] = {
        "outstanding_rows": shared["report_journal_rows"],
        "oldest_age_s": (
            max(0, now_s - r_oldest) if r_oldest is not None else None
        ),
    }
    # durable offender ledger row count rides on the process-local
    # quarantine section (the in-memory stats cover this process only)
    if isinstance(doc.get("quarantine"), dict):
        doc["quarantine"]["durable_rows"] = shared["quarantined_rows"]
    doc["leases"] = shared["leases"]
    return doc


def sample_status_metrics(datastore, clock=None) -> None:
    """One status-sampler tick (synchronous; run from an executor thread):
    publish the sampled queue-depth/freshness gauges and retire idle
    executor buckets.  Driven by the binaries' main loops on
    ``common.status_sample_interval_s``."""
    from .metrics import GLOBAL_METRICS

    # BEFORE the datastore query: peer-health gauges must refresh (the
    # time-driven suspect->probing transition has no traffic to publish
    # it) even while the datastore is wedged
    try:
        from .peer_health import tracker

        tracker().republish_metrics()
    except Exception:
        logger.exception("peer-health republish failed")
    # same story for the datastore tracker: suspect->probing is purely
    # time-driven, and during a brownout there may be no committing
    # transaction to republish the gauge
    try:
        from .db_health import tracker as db_tracker

        db_tracker().republish_metrics()
    except Exception:
        logger.exception("datastore-health republish failed")

    def q(tx):
        count, oldest = tx.accumulator_journal_stats()
        return count, oldest, tx.lease_summary()

    count, oldest, leases = datastore.run_tx("status_sample", q)
    if GLOBAL_METRICS.registry is not None:
        now_s = (clock or datastore.clock).now().seconds
        GLOBAL_METRICS.journal_outstanding_rows.set(count)
        GLOBAL_METRICS.journal_oldest_age.set(
            max(0, now_s - oldest) if oldest is not None else 0
        )
        for job_type, summary in leases.items():
            GLOBAL_METRICS.acquirable_jobs.labels(job_type=job_type).set(
                summary["acquirable"]
            )


def retire_idle_executor_buckets(max_idle_s: float, executor=None) -> int:
    """Sampler-tick companion: cap bucket-gauge cardinality.  No-op when
    no executor exists in this process.  The per-task cost series retire
    on the same tick and the same idle threshold — their cardinality cap
    depends on it."""
    from .costs import retire_idle_task_series

    try:
        retire_idle_task_series(max_idle_s)
    except Exception:
        logger.exception("cost-series retirement failed")
    if executor is None or max_idle_s <= 0:
        return 0
    return executor.retire_idle_buckets(max_idle_s)
