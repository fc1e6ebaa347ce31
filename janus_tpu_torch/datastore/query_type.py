"""Query-type strategy traits.

The analog of ``AccumulableQueryType`` / ``CollectableQueryType``
(reference: aggregator_core/src/query_type.rs:20,178): per-query-type policy
for mapping a report to its batch, validating collection identifiers, and
enumerating the batches a collection covers.  Batch identifiers are handled
in their encoded form (``bytes``) at the datastore boundary.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.time import (
    interval_contains_interval,
    time_to_batch_interval,
)
from ..messages import BatchId, Duration, Interval, Query, Time
from .task import AggregatorTask


def encode_interval_identifier(interval: Interval) -> bytes:
    return interval.get_encoded()


def decode_interval_identifier(data: bytes) -> Interval:
    return Interval.get_decoded(data)


class TimeIntervalStrategy:
    """reference: query_type.rs impl for TimeInterval"""

    kind = "TimeInterval"

    @staticmethod
    def to_batch_identifier(task: AggregatorTask, client_timestamp: Time) -> bytes:
        """A report belongs to the batch interval containing its timestamp
        (reference: query_type.rs:20 AccumulableQueryType)."""
        return time_to_batch_interval(client_timestamp, task.time_precision).get_encoded()

    @staticmethod
    def validate_query(task: AggregatorTask, query: Query) -> Optional[str]:
        """Returns an error string, or None if acceptable
        (reference: aggregator.rs validate_batch_interval)."""
        interval: Interval = query.query_body
        tp = task.time_precision.seconds
        if interval.start.seconds % tp != 0 or interval.duration.seconds % tp != 0:
            return "batch interval must be aligned to the time precision"
        if interval.duration.seconds < tp:
            return "batch interval must be at least the time precision"
        return None

    @staticmethod
    def collection_identifier(task: AggregatorTask, query: Query) -> bytes:
        return query.query_body.get_encoded()

    @staticmethod
    def batch_identifiers_for_collection_identifier(
        task: AggregatorTask, collection_identifier: bytes
    ) -> List[bytes]:
        """Every time-precision-aligned batch interval inside the collection
        interval (reference: query_type.rs CollectableQueryType)."""
        interval = decode_interval_identifier(collection_identifier)
        tp = task.time_precision.seconds
        out = []
        start = interval.start.seconds
        while start < interval.end().seconds:
            out.append(Interval(Time(start), Duration(tp)).get_encoded())
            start += tp
        return out

    @staticmethod
    def contains(collection_identifier: bytes, batch_identifier: bytes) -> bool:
        return interval_contains_interval(
            decode_interval_identifier(collection_identifier),
            decode_interval_identifier(batch_identifier),
        )


class FixedSizeStrategy:
    """reference: query_type.rs impl for FixedSize"""

    kind = "FixedSize"

    @staticmethod
    def to_batch_identifier(task: AggregatorTask, batch_id: BatchId) -> bytes:
        return batch_id.get_encoded()

    @staticmethod
    def validate_query(task: AggregatorTask, query: Query) -> Optional[str]:
        return None

    @staticmethod
    def batch_identifiers_for_collection_identifier(
        task: AggregatorTask, collection_identifier: bytes
    ) -> List[bytes]:
        return [collection_identifier]

    @staticmethod
    def contains(collection_identifier: bytes, batch_identifier: bytes) -> bool:
        return collection_identifier == batch_identifier


STRATEGIES = {
    "TimeInterval": TimeIntervalStrategy,
    "FixedSize": FixedSizeStrategy,
}


def strategy_for(task: AggregatorTask):
    return STRATEGIES[task.query_type.kind]
