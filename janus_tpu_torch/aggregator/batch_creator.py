"""Incremental fixed-size batch filling with headroom-priority ordering.

The analog of the reference's ``BatchCreator`` (reference:
aggregator/src/aggregator/batch_creator.rs:32-517): reports are routed into
the *most-full* unfilled outstanding batch first (a max-heap on the batch's
potential size), so batches complete as early as possible; new batches are
opened only when every open batch is saturated and enough reports remain.
Two passes share one engine:

* assignment (``greedy=False``): jobs are cut only at full
  ``max_aggregation_job_size`` (or the batch's remaining headroom).
* finish (``greedy=True``): remaining reports form smaller jobs down to
  ``min_aggregation_job_size`` — or even below it when that is exactly what
  completes a batch's ``min_batch_size`` (batch_creator.rs:207-249).

Batches whose CONFIRMED size already meets ``min_batch_size`` at load time
are marked filled and never reconsidered (batch_creator.rs:128-143); the
fixed-size collection path selects by confirmed size independently.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..messages import BatchId, ReportMetadata, Time


@dataclass
class _OpenBatch:
    batch_id: BatchId
    new_max_size: int  # potential size incl. reports assigned this pass
    stale: bool = False


@dataclass
class _Bucket:
    heap: List[Tuple[int, int, _OpenBatch]] = field(default_factory=list)
    reports: List[ReportMetadata] = field(default_factory=list)


class BatchCreator:
    """One task's fixed-size batch filling for a single creation pass."""

    def __init__(
        self,
        tx,
        task,
        min_aggregation_job_size: int,
        max_aggregation_job_size: int,
    ):
        self.tx = tx
        self.task = task
        self.min_job = min_aggregation_job_size
        self.max_job = max_aggregation_job_size
        self.min_batch = task.min_batch_size
        # Without an explicit max, aim for batches of exactly min_batch_size
        # (reference: batch_creator.rs:88-94 / draft-ietf-ppm-dap-09 §4.1.2).
        self.effective_max = task.query_type.max_batch_size or task.min_batch_size
        self.btws = task.query_type.batch_time_window_size
        self.buckets: Dict[Optional[int], _Bucket] = {}
        self.jobs: List[Tuple[BatchId, List[ReportMetadata]]] = []
        self._tiebreak = itertools.count()

    # -- bucket plumbing -------------------------------------------------
    def _bucket_key(self, m: ReportMetadata) -> Optional[int]:
        if self.btws is None:
            return None
        return m.time.seconds - m.time.seconds % self.btws.seconds

    def _load_bucket(self, key: Optional[int]) -> _Bucket:
        bucket = self.buckets.get(key)
        if bucket is not None:
            return bucket
        bucket = _Bucket()
        bucket_time = Time(key) if key is not None else None
        for ob in self.tx.get_unfilled_outstanding_batches(self.task.task_id, bucket_time):
            if ob.size_min >= self.min_batch:
                # Enough confirmed aggregations: retire it from filling.
                self.tx.mark_outstanding_batch_filled(self.task.task_id, ob.batch_id)
                continue
            self._push(bucket, _OpenBatch(ob.batch_id, ob.size_max))
        self.buckets[key] = bucket
        return bucket

    def _push(self, bucket: _Bucket, ob: _OpenBatch) -> None:
        heapq.heappush(bucket.heap, (-ob.new_max_size, next(self._tiebreak), ob))

    def _pop_largest(self, bucket: _Bucket) -> Optional[_OpenBatch]:
        while bucket.heap:
            _, _, ob = heapq.heappop(bucket.heap)
            if not ob.stale:
                return ob
        return None

    # -- the engine ------------------------------------------------------
    def add_report(self, meta: ReportMetadata) -> None:
        key = self._bucket_key(meta)
        bucket = self._load_bucket(key)
        bucket.reports.append(meta)
        self._process(key, bucket, greedy=False)

    def _cut_job(self, batch: _OpenBatch, bucket: _Bucket, size: int) -> None:
        take, bucket.reports = bucket.reports[:size], bucket.reports[size:]
        self.jobs.append((batch.batch_id, take))
        batch.stale = True
        updated = _OpenBatch(batch.batch_id, batch.new_max_size + size)
        self._push(bucket, updated)

    def _process(self, key: Optional[int], bucket: _Bucket, greedy: bool) -> None:
        while True:
            while True:
                if not bucket.reports:
                    return
                largest = self._pop_largest(bucket)
                if largest is None:
                    break
                if largest.new_max_size >= self.effective_max:
                    continue  # saturated: discard from consideration
                if greedy:
                    desired = min(
                        len(bucket.reports),
                        self.max_job,
                        self.effective_max - largest.new_max_size,
                    )
                    completes_batch = (
                        largest.new_max_size < self.min_batch
                        and largest.new_max_size + desired >= self.min_batch
                    )
                    if desired >= self.min_job or completes_batch:
                        self._cut_job(largest, bucket, desired)
                        continue
                    self._push(bucket, largest)
                    return
                else:
                    desired = min(
                        self.max_job, self.effective_max - largest.new_max_size
                    )
                    if len(bucket.reports) >= desired:
                        self._cut_job(largest, bucket, desired)
                        continue
                    self._push(bucket, largest)
                    return

            # Every open batch is saturated (or none exist): open a new one
            # if enough reports remain for the pass's job-size threshold.
            threshold = self.min_job if greedy else self.max_job
            desired = min(len(bucket.reports), self.max_job, self.effective_max)
            if desired >= threshold and desired > 0:
                batch_id = BatchId.random()
                bucket_time = Time(key) if key is not None else None
                self.tx.put_outstanding_batch(self.task.task_id, batch_id, bucket_time)
                nb = _OpenBatch(batch_id, 0)
                self._cut_job(nb, bucket, desired)
                continue
            return

    def finish(self) -> Tuple[List[Tuple[BatchId, List[ReportMetadata]]], List[ReportMetadata]]:
        """Greedy pass over every bucket; returns (jobs, leftover reports)."""
        leftover: List[ReportMetadata] = []
        for key, bucket in self.buckets.items():
            self._process(key, bucket, greedy=True)
            leftover.extend(bucket.reports)
            bucket.reports = []
        return self.jobs, leftover
