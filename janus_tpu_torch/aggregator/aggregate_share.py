"""Aggregate-share computation from sharded batch aggregations.

The analog of ``compute_aggregate_share`` (reference:
aggregator/src/aggregator/aggregate_share.rs:21-118): merge every shard
accumulator covering the batch, cross-checking report count and checksum.
This host-side merge is the small tail of the sharded accumulation whose bulk
runs on device (`BatchedPrio3.aggregate` / psum over the mesh).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.report_id import checksum_combined
from ..core.time import interval_merge
from ..datastore import BatchAggregation, Transaction
from ..datastore.query_type import strategy_for
from ..datastore.task import AggregatorTask
from ..messages import Interval, ReportIdChecksum


def compute_aggregate_share(
    task: AggregatorTask,
    vdaf,
    tx: Transaction,
    collection_identifier: bytes,
    aggregation_parameter: bytes,
) -> Tuple[Optional[List[int]], int, ReportIdChecksum, Interval]:
    """Merge all batch-aggregation shards covered by the collection
    identifier.  Returns (aggregate_share_vec | None, report_count,
    checksum, client_timestamp_interval)."""
    strategy = strategy_for(task)
    field = vdaf.field_for_agg_param(vdaf.decode_agg_param(aggregation_parameter))
    share: Optional[List[int]] = None
    count = 0
    checksum = ReportIdChecksum.zero()
    interval = Interval.EMPTY
    for ident in strategy.batch_identifiers_for_collection_identifier(
        task, collection_identifier
    ):
        for ba in tx.get_batch_aggregations_for_batch(
            task.task_id, ident, aggregation_parameter
        ):
            if ba.aggregate_share is not None:
                vec = field.decode_vec(ba.aggregate_share)
                share = vec if share is None else field.vec_add(share, vec)
            count += ba.report_count
            checksum = checksum_combined(checksum, ba.checksum)
            interval = interval_merge(interval, ba.client_timestamp_interval)
    return share, count, checksum, interval
