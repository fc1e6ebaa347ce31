"""Aggregator service: role logic, write combiners, job machinery.

The analog of the reference's ``aggregator`` crate (reference:
aggregator/src/aggregator.rs and friends).  Importing it does not import
aiohttp: :func:`aggregator_app` loads the HTTP layer when it is called,
and ``test_util.InProcessNetwork`` joins aggregators without it.
"""

from .aggregate_share import compute_aggregate_share
from .aggregation_job_creator import AggregationJobCreator, CreatorConfig
from .aggregation_job_driver import AggregationJobDriver, DriverConfig
from .aggregation_job_writer import AggregationJobWriter, merge_batch_aggregations
from .aggregator import Aggregator, Config, TaskAggregator
from .collection_job_driver import (
    CollectionDriverConfig,
    CollectionJobDriver,
    NoDifferentialPrivacy,
)
from .error import AggregatorError, ReportRejection
from .garbage_collector import GarbageCollector, GcConfig
from .job_driver import JobDriver
from .report_writer import ReportWriteBatcher



def aggregator_app(aggregator):
    """The DAP service over aiohttp (http_handlers.py), loaded on call."""
    from .http_handlers import aggregator_app as app

    return app(aggregator)


__all__ = [n for n in dir() if not n.startswith("_")]
