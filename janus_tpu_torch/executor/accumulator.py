"""Device-resident accumulator store: on-chip out-share accumulation.

The steady-state hot path used to read every mega-batch's out shares back
to the host (``launch_prep_init_multi`` materialized a (B, OUTPUT_LEN, n)
limb matrix per flush) and re-merge them through the sharded
``batch_aggregations`` rows.  Accelerator proof-system frameworks (ZK-Flex,
arXiv:2606.03046; Hermes, arXiv:2603.01556) get their throughput by keeping
reduction state resident in accelerator memory and spilling only at epoch
boundaries — the same shape as a KV-cache/optimizer-state manager in a
serving stack.  This module is that manager for Janus out shares:

* **Flush-resident matrices**: with the store attached, a prepare flush
  retains its ``out_share`` mega-batch ON DEVICE and hands each report a
  lightweight :class:`ResidentRef` (flush id + row) instead of the limb
  vector.  The host sees only per-report prepare verdicts; the flush pays
  ZERO device->host out-share readback (``CudaBackend.outshare_readback_rows``
  stays 0 — the acceptance counter).
* **Per-bucket persistent accumulators**: verified rows are psummed into a
  per-``(task, VDAF shape, batch bucket)`` resident buffer
  (:meth:`DeviceAccumulatorStore.commit_rows` — one tiny device launch per
  bucket, no readback).
* **Commit-time spill**: the driver requests :meth:`drain` at job commit; the
  readback is ONE (OUTPUT_LEN,) field vector per bucket — O(OUT) instead of
  O(B*OUT) per flush — handed to ``AggregationJobWriter`` for the existing
  sharded merge.
* **LRU / memory-pressure eviction**: resident bytes are bounded by a
  budget, by default the minting backend's (``CudaBackend``: a quarter of
  the card's memory); beyond it the least-recently-used state spills to
  host mirrors (flush matrices to host limb arrays, bucket buffers to host
  field vectors) — correctness is unaffected, only the residency win.
* **Mirror-delta journal**: every ``commit_rows`` appends ``(job, report
  ids)`` to the bucket's journal; the journal is cleared by a successful
  drain.  On a launch failure / CircuitOpenError the bucket is poisoned and
  :meth:`discard` returns the journaled identities so the caller replays
  exactly those reports through the bit-exact CPU oracle path — accumulation
  never double-counts (the poisoned device delta is dropped, never drained)
  and never drops (the journal names every un-spilled report).

The store is torch-free at import: all device arithmetic goes through the
backend seam (``accumulate_rows`` / ``read_accum_buffer`` on CudaBackend),
so control-plane processes and fake-backend tests never pull in the device
stack.  Byte accounting reads the tensors themselves (``numel() *
element_size()``), whatever dtype the backend keeps its limbs in.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import faults

logger = logging.getLogger("janus_tpu_torch.accumulator")


class AccumulatorError(Exception):
    """Base for accumulator-store failures."""


class AccumulatorUnavailable(AccumulatorError):
    """A device accumulate/drain launch failed (or the bucket is poisoned
    from an earlier failure).  The caller's contract is the CPU-oracle
    replay: re-derive the journaled reports' out shares on the oracle and
    hand host vectors to the writer; then :meth:`DeviceAccumulatorStore.discard`
    the bucket so the dead device delta can never double-count."""


class StaleAccumulatorDelta(AccumulatorError):
    """The drained delta no longer matches the reports surviving the
    transactional write (a report was failed in-tx, e.g. BatchCollected,
    after its row was already accumulated).  Raised INSIDE the tx so the
    commit aborts cleanly; the caller surfaces it as a retryable step
    failure — redelivery re-prepares the job and the in-tx check fails the
    report properly, with nothing merged (no double count, no drop)."""


@dataclass(frozen=True)
class ResidentRef:
    """A device-resident out share: row ``row`` of flush ``flush_id``.

    Travels inside ``Prio3PrepareState.out_share`` through the ping-pong
    layer untouched (``prep_next`` returns it verbatim); only the
    store can resolve it back to field elements.
    """

    flush_id: int
    row: int
    #: the task's OUTPUT_LEN where the flush is wider (a canonical twin's
    #: bucket width): the bucket's drained sum is clipped back to it
    width: Optional[int] = None


def _clip(vector: List[int], width: Optional[int]) -> List[int]:
    """A device buffer's readback, clipped to its rows' width where the
    buffer is a canonical twin's (vdaf/canonical.py ``clip_to_width``: a
    non-zero pad tail raises)."""
    if width is None:
        return vector
    from ..vdaf.canonical import clip_to_width

    return clip_to_width(vector, width)


@dataclass
class AccumulatorConfig:
    """Tuning knobs for the store (``device_executor.accumulator.*``)."""

    enabled: bool = False
    #: resident-byte cap across flush matrices + bucket buffers; beyond it
    #: LRU state spills to host mirrors.  None (the default): the first
    #: minting backend's ``resident_byte_budget()`` (a quarter of the
    #: card's memory for CudaBackend), else HOST_BYTE_BUDGET.  <= 0
    #: disables eviction.
    byte_budget: Optional[int] = None
    #: Deferred drains: 0 (default) drains every bucket at its job's
    #: commit (residency window = one step, nothing survives the tx).
    #: > 0 lets a bucket accumulate across jobs and drains it once it is
    #: this old — each contributing job persists an accumulator-journal
    #: row in its commit tx (datastore ``accumulator_journal``), so a
    #: crash between commit and drain is recoverable: survivors replay
    #: the journaled reports through the CPU oracle from the datastore.
    drain_interval_s: float = 0.0
    #: Dedicated maintenance cadence (binaries background loop): > 0 runs
    #: ``AggregationJobDriver.run_accumulator_maintenance`` every this
    #: many seconds, draining deferred buckets that came due while no
    #: driver commit was around to drain them (an idle task's bucket no
    #: longer waits for the NEXT commit) and rebalancing resident
    #: occupancy.  <= 0 = commit-driven drains only (pre-maintenance
    #: behavior).
    maintenance_interval_s: float = 0.0

    @property
    def deferred(self) -> bool:
        return self.drain_interval_s > 0


#: The budget when neither the config nor the minting backend states one.
HOST_BYTE_BUDGET = 256 << 20


class _Flush:
    """One retained prepare mega-batch: the (pad, OUT, n) out-share matrix.

    ``matrix`` is a device tensor until evicted, then a host copy; the
    accumulate launch consumes either (the backend moves host inputs to its
    device).  A mesh backend's matrix is its per-shard pieces
    (``ShardedRows``), with the same ``shape``, ``numel``, ``element_size``
    and ``cpu``.
    """

    def __init__(self, flush_id: int, backend, matrix, rows: int, nbytes: int):
        self.flush_id = flush_id
        self.backend = backend
        self.matrix = matrix
        self.rows = rows
        self.nbytes = nbytes
        self.consumed: Set[int] = set()
        self.on_host = False
        self.last_used = time.monotonic()


class _Bucket:
    """Persistent accumulator for one (task, shape, batch-bucket,
    agg-param) — the aggregation parameter (Poplar1's encoded level +
    prefixes; b"" for Prio3) is part of the caller's key tuple, so two
    rounds of one heavy-hitters task can never share a bucket."""

    def __init__(self, key: tuple, backend):
        self.key = key
        #: minting device backend; None for host-vector buckets
        #: (commit_host_rows — Poplar1 sketch deltas), whose only state is
        #: the spilled_host mirror
        self.backend = backend
        #: drain-time field for host-vector buckets (backend is None there)
        self.field = None
        #: device (OUT, n) limb buffer; None until the first commit
        self.buffer = None
        #: the task's width where the buffer is a canonical twin's (its
        #: rows' ``ResidentRef.width``): every readback is clipped to it
        self.width: Optional[int] = None
        self.buffer_nbytes = 0
        #: host mirror of evicted device state (field ints)
        self.spilled_host: Optional[List[int]] = None
        #: mirror-delta journal: (job_token, frozenset of report ids)
        self.journal: List[Tuple[object, frozenset]] = []
        self.row_count = 0
        self.poisoned = False
        #: set (under oplock) when a drain/discard detaches the bucket: a
        #: commit racing the detach must fail cleanly and replay, never
        #: land rows in a buffer that has already been read
        self.closed = False
        self.last_used = time.monotonic()
        #: first-commit time: deferred drains fire once the bucket is
        #: drain_interval_s old (age of the OLDEST un-drained delta, so no
        #: journal row waits longer than one interval under steady traffic)
        self.created_at = time.monotonic()
        #: serializes device ops against this bucket's buffer (a commit
        #: racing an eviction or drain must never double- or under-count)
        self.oplock = threading.Lock()


class DeviceAccumulatorStore:
    """Process-wide resident out-share state, owned by the DeviceExecutor."""

    def __init__(self, config: Optional[AccumulatorConfig] = None):
        self.config = config or AccumulatorConfig()
        self._flushes: Dict[int, _Flush] = {}
        self._buckets: Dict[tuple, _Bucket] = {}
        self._next_flush_id = 0
        self._lock = threading.Lock()
        # plain-Python counters (bench + tests read these; metrics mirror them)
        self.resident_bytes = 0
        self.retained_rows = 0
        self.spills = 0
        self.evictions = 0
        self.drain_readback_rows = 0
        #: the budget in force: the config's, else set by the first
        #: retain_flush from its backend (None until then: nothing resident)
        self.byte_budget: Optional[int] = self.config.byte_budget

    # -- flush retention -------------------------------------------------
    def retain_flush(self, backend, matrix, rows: int, nbytes: int) -> int:
        """Adopt a flush's device out-share matrix; returns its flush id.

        Eviction runs BEFORE adoption: an eviction failure (injected or
        real) must never fire after state was mutated, or the caller could
        not tell a clean failure from a half-applied one."""
        if self.byte_budget is None:
            stated = getattr(backend, "resident_byte_budget", None)
            self.byte_budget = (stated and stated()) or HOST_BYTE_BUDGET
        if 0 < self.byte_budget < nbytes:
            logger.warning(
                "a flush of %d bytes exceeds the accumulator's %d-byte budget: "
                "every commit will copy it back from the host",
                nbytes,
                self.byte_budget,
            )
        self._evict_if_needed()
        with self._lock:
            fid = self._next_flush_id
            self._next_flush_id += 1
            self._flushes[fid] = _Flush(fid, backend, matrix, rows, nbytes)
            self.resident_bytes += nbytes
            self.retained_rows += rows
        self._observe()
        return fid

    def release_refs(self, refs: Sequence[ResidentRef]) -> None:
        """Mark rows consumed without accumulating (failed / dropped
        reports); frees a flush matrix once every row is accounted for."""
        with self._lock:
            for ref in refs:
                self._consume_row_locked(ref)
        self._observe()

    def _consume_row_locked(self, ref: ResidentRef) -> None:
        fl = self._flushes.get(ref.flush_id)
        if fl is None:
            return
        fl.consumed.add(ref.row)  # idempotent: replay may re-release rows
        if len(fl.consumed) >= fl.rows:
            del self._flushes[ref.flush_id]
            self.resident_bytes -= fl.nbytes

    # -- accumulation ----------------------------------------------------
    def commit_rows(
        self,
        bucket_key: tuple,
        backend,
        refs: Sequence[ResidentRef],
        *,
        job_token,
        report_ids: Sequence[bytes],
    ) -> None:
        """Psum the referenced rows into the bucket's resident buffer (one
        device launch per source flush, no readback) and journal the delta.

        Raises :class:`AccumulatorUnavailable` on any device failure; the
        bucket is then poisoned and the caller must oracle-replay +
        :meth:`discard`.
        """
        if not refs:
            return
        # evict BEFORE mutating: a mid-eviction failure must leave this
        # commit cleanly un-applied (exactly-once recovery depends on it)
        self._evict_if_needed()
        with self._lock:
            by_flush: Dict[int, List[int]] = {}
            for ref in refs:
                by_flush.setdefault(ref.flush_id, []).append(ref.row)
            sources = []
            for fid, rows in by_flush.items():
                fl = self._flushes.get(fid)
                if fl is None:
                    raise AccumulatorUnavailable(
                        f"flush {fid} no longer resident (evicted past recall)"
                    )
                fl.last_used = time.monotonic()
                sources.append((fl, rows))
            # The MINTING backend (recorded on the flush at retain time) is
            # the accumulation authority: its buffer widths match the
            # retained matrix by construction (a canonical twin's flush is
            # bucket-width), while the caller's backend can diverge after a
            # canonical-twin build failure (an exact-shape flush committed
            # through the bucket twin — or vice versa — would mismatch
            # widths).  The caller's backend is only the last resort for
            # flushes without one.  Every readback of a bucket-width buffer
            # is clipped back to its rows' width, the task's OUTPUT_LEN.
            mint = sources[0][0].backend or backend
            bucket = self._buckets.get(bucket_key)
            if bucket is None:
                bucket = _Bucket(bucket_key, mint)
                self._buckets[bucket_key] = bucket
            elif bucket.backend is None:
                # the bucket was opened by a host-vector commit
                # (commit_host_rows — e.g. an oracle-recomputed row of
                # the same job); adopt the minting backend so the drain
                # can read the device buffer this commit is about to create
                bucket.backend = mint
            # one task's rows: a canonical task's refs name its width
            bucket.width = bucket.width or refs[0].width
            if bucket.poisoned:
                raise AccumulatorUnavailable(
                    f"bucket {bucket_key!r} poisoned by an earlier launch failure"
                )
        with bucket.oplock:
            # re-validate under the op lock: a concurrent drain/discard may
            # have detached this bucket after we looked it up — landing
            # rows in a buffer that was already read would merge them into
            # another job's delta without their journal entry
            if bucket.closed or bucket.poisoned:
                raise AccumulatorUnavailable(
                    f"bucket {bucket_key!r} was drained/poisoned concurrently"
                )
            try:
                for fl, rows in sources:
                    pad = fl.matrix.shape[0]
                    mask = np.zeros(pad, dtype=bool)
                    mask[rows] = True
                    bucket.buffer = (fl.backend or backend).accumulate_rows(
                        bucket.buffer, fl.matrix, mask
                    )
            except Exception as e:
                bucket.poisoned = True
                raise AccumulatorUnavailable(
                    f"accumulate launch failed: {e}"
                ) from e
            # journal under the SAME lock as the buffer update, so a
            # drain's snapshot can never see the delta without its entry
            # agg-param planes (Poplar1 sketch matrices) carry their drain
            # field explicitly — the eviction/drain_all field resolution
            # for minting faces with no vdaf.flp
            if bucket.field is None:
                bucket.field = getattr(mint, "accum_field", None)
            with self._lock:
                if bucket.buffer_nbytes == 0:
                    bucket.buffer_nbytes = self._buffer_nbytes(bucket.buffer)
                    self.resident_bytes += bucket.buffer_nbytes
                bucket.journal.append((job_token, frozenset(report_ids)))
                bucket.row_count += len(refs)
                bucket.last_used = time.monotonic()
                for ref in refs:
                    self._consume_row_locked(ref)
        self._observe()

    def commit_host_rows(
        self,
        bucket_key: tuple,
        field,
        vectors: Sequence[Sequence[int]],
        *,
        job_token,
        report_ids: Sequence[bytes],
    ) -> None:
        """Host-vector twin of :meth:`commit_rows` for VDAFs whose out
        shares are materialized on the host (Poplar1's sketch ``y``
        vectors finish in the ping-pong layer as field ints): sum
        ``vectors`` into the bucket's host mirror and journal the delta
        under the SAME exactly-once fence — deferred drains, cadence
        scans, poisoning, and the datastore journal/replay machinery all
        behave identically to device buckets.  What the store adds for
        these buckets is not PCIe savings but the cross-job level-keyed
        accumulation window: N jobs at one tree level merge as ONE
        datastore vector write, with the persisted journal rows making a
        crash before the drain recoverable.  Host mirrors are off the
        resident-byte budget (same posture as evicted device state)."""
        if not vectors:
            return
        if len(vectors) != len(report_ids):
            raise AccumulatorError("one vector per report id required")
        with self._lock:
            bucket = self._buckets.get(bucket_key)
            if bucket is None:
                bucket = _Bucket(bucket_key, None)
                self._buckets[bucket_key] = bucket
            if bucket.poisoned:
                raise AccumulatorUnavailable(
                    f"bucket {bucket_key!r} poisoned by an earlier failure"
                )
        with bucket.oplock:
            # same re-validation as commit_rows: a concurrent drain/discard
            # may have detached the bucket after the lookup
            if bucket.closed or bucket.poisoned:
                raise AccumulatorUnavailable(
                    f"bucket {bucket_key!r} was drained/poisoned concurrently"
                )
            bucket.field = field
            acc = bucket.spilled_host
            for v in vectors:
                acc = list(v) if acc is None else field.vec_add(acc, v)
            bucket.spilled_host = acc
            with self._lock:
                bucket.journal.append((job_token, frozenset(report_ids)))
                bucket.row_count += len(vectors)
                bucket.last_used = time.monotonic()
        self._observe()

    @staticmethod
    def _buffer_nbytes(buffer) -> int:
        """Resident bytes of a bucket's accumulator buffer: its own size (a
        tensor's ``numel() * element_size()``, an array's ``nbytes``), so
        any limb dtype is counted as it is, and a mesh backend's buffer
        (``vdaf/backend.py`` ``ShardedRows``: one (OUT, n) partial row on
        each shard's card) counts all of its ``accum_buffer_rows`` rows.
        No failure is read as 0 bytes: a silent 0 would keep the byte
        budget and eviction from ever engaging."""
        if hasattr(buffer, "element_size"):
            return int(buffer.numel() * buffer.element_size())
        return int(np.asarray(buffer).nbytes)

    # -- spill -----------------------------------------------------------
    def drain(self, bucket_key: tuple, field) -> Optional[Tuple[List[int], Set[bytes]]]:
        """Commit-time spill: read back the bucket's resident sum as ONE
        field vector, clear the bucket + journal, and return
        ``(vector, journaled report ids)``.  Returns None when the bucket
        holds nothing."""
        out = self.drain_with_journal(bucket_key, field)
        if out is None:
            return None
        vector, journal = out
        rids: Set[bytes] = set()
        for _job, ids in journal:
            rids |= ids
        return vector, rids

    def drain_with_journal(
        self, bucket_key: tuple, field
    ) -> Optional[Tuple[List[int], List[Tuple[object, frozenset]]]]:
        """Like :meth:`drain`, but returns the per-job journal entries
        ``[(job_token, frozenset(report_ids)), ...]`` instead of the flat
        id set — the deferred-drain transaction consumes the persisted
        ``accumulator_journal`` rows at job granularity, and may only
        merge the vector if EVERY entry's row is still present (a missing
        row means a crash-recovery replay already merged that job's
        shares; merging the vector then would double-count them).
        The named fault point ``accumulator.spill`` fires here so chaos
        runs exercise mid-spill failures."""
        with self._lock:
            bucket = self._buckets.pop(bucket_key, None)
            if bucket is not None:
                self.resident_bytes -= bucket.buffer_nbytes
        if bucket is None:
            return None
        with bucket.oplock:
            # closed stops any concurrent commit that resolved this bucket
            # before the pop: its rows must go to a FRESH bucket (or the
            # caller's replay), never into a buffer we are about to read
            bucket.closed = True
            if bucket.poisoned:
                with self._lock:  # restore for discard()/replay bookkeeping
                    self._buckets[bucket_key] = bucket
                    self.resident_bytes += bucket.buffer_nbytes
                raise AccumulatorUnavailable(f"bucket {bucket_key!r} is poisoned")
            try:
                faults.fire("accumulator.spill")
                vector = bucket.spilled_host
                if bucket.buffer is not None:
                    t0 = time.monotonic()
                    drained = _clip(bucket.backend.read_accum_buffer(bucket.buffer), bucket.width)
                    self._attribute_drain(bucket_key, time.monotonic() - t0)
                    with self._lock:
                        self.drain_readback_rows += 1
                    vector = (
                        drained if vector is None else field.vec_add(vector, drained)
                    )
            except Exception as e:
                with self._lock:
                    bucket.poisoned = True
                    self._buckets[bucket_key] = bucket
                    self.resident_bytes += bucket.buffer_nbytes
                raise AccumulatorUnavailable(f"spill readback failed: {e}") from e
            journal = list(bucket.journal)
        with self._lock:
            self.spills += 1
        self._observe(spill_reason="commit")
        if vector is None:
            return None
        return vector, journal

    @staticmethod
    def _attribute_drain(bucket_key: tuple, seconds: float) -> None:
        """Spill/drain cost rows: the per-bucket readback is
        device time spent FOR one task — bucket keys are
        ``(role, task, shape, ident, param)``, so the task ident rides in
        slot 1 — attributed under phase="drain" beside the flush-split
        stage/launch seconds.  Best-effort: a malformed legacy key
        attributes to "unattributed" rather than failing the drain."""
        try:
            from ..core import costs

            ident = bucket_key[1] if len(bucket_key) > 1 else None
            costs.cost_model().attribute_direct(
                ident, "drain", "device", seconds
            )
        except Exception:  # pragma: no cover - attribution is never fatal
            logger.debug("drain cost attribution failed", exc_info=True)

    def discard(self, bucket_key: tuple) -> List[Tuple[object, frozenset]]:
        """Drop a (typically poisoned) bucket's device state WITHOUT
        spilling and return its journal so the caller can oracle-replay the
        un-spilled reports.  Dropping before replay is what makes recovery
        exactly-once: the device delta can never be drained later."""
        with self._lock:
            bucket = self._buckets.pop(bucket_key, None)
            if bucket is None:
                return []
            self.resident_bytes -= bucket.buffer_nbytes
        with bucket.oplock:
            # stop any in-flight commit racing the discard: its rows must
            # not land in a buffer nobody will ever drain
            bucket.closed = True
            journal = list(bucket.journal)
        self._observe(spill_reason="discard")
        return journal

    # -- eviction --------------------------------------------------------
    def _evict_if_needed(self) -> None:
        budget = self.byte_budget
        if budget is None or budget <= 0:
            return
        while True:
            with self._lock:
                if self.resident_bytes <= budget:
                    return
                victim = self._pick_victim_locked()
                if victim is None:
                    return
            self._evict(victim)

    def _pick_victim_locked(self):
        """LRU across flush matrices and bucket buffers still on device."""
        candidates: List[Tuple[float, object]] = []
        for fl in self._flushes.values():
            if not fl.on_host:
                candidates.append((fl.last_used, fl))
        for b in self._buckets.values():
            if b.buffer is not None and not b.poisoned:
                candidates.append((b.last_used, b))
        if not candidates:
            return None
        return min(candidates, key=lambda c: c[0])[1]

    def _evict(self, victim) -> None:
        """Spill one LRU item to its host mirror (fault point
        ``accumulator.evict``); device failures poison buckets (flush
        eviction failures poison every bucket lazily via commit_rows)."""
        faults.fire("accumulator.evict")
        if isinstance(victim, _Flush):
            m = victim.matrix
            host = m.cpu() if hasattr(m, "cpu") else np.asarray(m)
            with self._lock:
                if self._flushes.get(victim.flush_id) is not victim or victim.on_host:
                    return  # freed or already evicted since the LRU pick
                victim.matrix = host
                victim.on_host = True
                self.resident_bytes -= victim.nbytes
                # the host mirror is off-budget; zero the tab so the
                # final consume-and-free doesn't subtract a second time
                victim.nbytes = 0
                self.evictions += 1
            logger.info(
                "evicted flush %d (%d rows) to host under memory pressure",
                victim.flush_id,
                victim.rows,
            )
        else:  # _Bucket
            with victim.oplock:
                if victim.buffer is None or victim.closed:
                    return  # drained/discarded since the LRU pick
                t0 = time.monotonic()
                drained = _clip(victim.backend.read_accum_buffer(victim.buffer), victim.width)
                self._attribute_drain(victim.key, time.monotonic() - t0)
                field = (
                    victim.field
                    or getattr(victim.backend, "accum_field", None)
                    or victim.backend.vdaf.flp.field
                )
                victim.spilled_host = (
                    drained
                    if victim.spilled_host is None
                    else field.vec_add(victim.spilled_host, drained)
                )
                victim.buffer = None
                with self._lock:
                    # account only while still registered: a concurrent
                    # drain pop already took buffer_nbytes off the books
                    if self._buckets.get(victim.key) is victim:
                        self.resident_bytes -= victim.buffer_nbytes
                    victim.buffer_nbytes = 0
                    self.evictions += 1
            logger.info("evicted bucket %r accumulator to host", victim.key)
        self._observe(evicted=True)

    # -- lifecycle / introspection --------------------------------------
    def rebalance(self) -> dict:
        """Occupancy housekeeping for the maintenance loop: run the LRU
        eviction pass (normally paid inline by the next commit) so memory
        pressure is relieved on cadence instead of on the hot path, and
        return the occupancy snapshot the loop logs."""
        self._evict_if_needed()
        return self.stats()

    def due_buckets(self, max_age_s: float) -> List[tuple]:
        """Keys of buckets whose oldest un-drained delta is older than
        ``max_age_s`` — the deferred-drain cadence scan."""
        now = time.monotonic()
        with self._lock:
            return [
                b.key
                for b in self._buckets.values()
                if now - b.created_at >= max_age_s
            ]

    def bucket_keys(self) -> List[tuple]:
        with self._lock:
            return list(self._buckets)

    def drain_all(self, sink) -> None:
        """Drain every bucket into ``sink(key, vector, journal_entries)``
        (callers that can merge the vectors somewhere durable — the
        graceful-shutdown spill); buckets whose drain OR sink fails are
        discarded with a warning — their persisted journal rows, if any,
        make the loss recoverable via the collection-time replay."""
        with self._lock:
            keys = list(self._buckets)
        for key in keys:
            try:
                with self._lock:
                    b = self._buckets.get(key)
                    # host-vector buckets carry their drain field directly;
                    # device buckets derive it from the minting backend
                    field = (
                        None
                        if b is None
                        else (b.field or getattr(
                            getattr(getattr(b.backend, "vdaf", None), "flp", None),
                            "field",
                            None,
                        ))
                    )
                if field is None:
                    continue
                out = self.drain_with_journal(key, field)
                if out is not None:
                    sink(key, out[0], out[1])
            except Exception:
                logger.warning(
                    "drain_all failed for bucket %r; discarding", key, exc_info=True
                )
                self.discard(key)

    def discard_all(self) -> None:
        """Shutdown teardown: drop every resident delta WITHOUT the
        per-bucket readback (there is nowhere durable to put a vector at
        shutdown), logging what is dropped — any delta still resident
        belongs to a job whose tx never committed, so lease redelivery
        re-derives it; nothing is lost, and nothing dies silently."""
        with self._lock:
            keys = list(self._buckets)
        for key in keys:
            journal = self.discard(key)
            if journal:
                rids = set()
                for _job, ids in journal:
                    rids |= ids
                logger.warning(
                    "dropping un-spilled resident delta for bucket %r "
                    "(%d report(s)); the owning job never committed its tx "
                    "and will redeliver",
                    key,
                    len(rids),
                )
        with self._lock:
            self._flushes.clear()
            self._buckets.clear()
            self.resident_bytes = 0
        self._observe()

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident_bytes": self.resident_bytes,
                "byte_budget": self.byte_budget,
                "flushes_resident": len(self._flushes),
                "buckets": len(self._buckets),
                "retained_rows": self.retained_rows,
                "spills": self.spills,
                "evictions": self.evictions,
                "drain_readback_rows": self.drain_readback_rows,
            }

    def _observe(self, spill_reason: Optional[str] = None, evicted: bool = False):
        from ..core.metrics import GLOBAL_METRICS

        if GLOBAL_METRICS.registry is None:
            return
        GLOBAL_METRICS.accumulator_resident_bytes.set(self.resident_bytes)
        GLOBAL_METRICS.accumulator_buckets.set(len(self._buckets))
        if spill_reason is not None:
            GLOBAL_METRICS.accumulator_spills.labels(reason=spill_reason).inc()
        if evicted:
            GLOBAL_METRICS.accumulator_evictions.inc()
